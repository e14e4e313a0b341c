from verticut_tpu_torch.search.linear import linear_search  # noqa: F401
from verticut_tpu_torch.search.single import (  # noqa: F401
    FusedHandle, SearchResult, mih_search, mih_search_dispatch,
    mih_search_finalize)


def __getattr__(name):  # lazy: the sharded modules pull in torch.distributed
    if name in ("build_sharded_index", "sharded_mih_search",
                "sharded_linear_search", "ShardedMIHIndex"):
        from verticut_tpu_torch.search import sharded
        return getattr(sharded, name)
    if name in ("build_sharded_compact", "sharded_compact_search",
                "ShardedCompactIndex"):
        from verticut_tpu_torch.search import sharded_compact
        return getattr(sharded_compact, name)
    raise AttributeError(name)
