from verticut_tpu_torch.index.mih import (MIHIndex, MIHTable,  # noqa: F401
                                          build_index, index_from_arrays,
                                          load_index, save_index)
