"""Binary-code encoders (port of ``verticut_tpu/models``)."""

from verticut_tpu_torch.models.lsh import ITQEncoder, RandomProjectionLSH  # noqa: F401
