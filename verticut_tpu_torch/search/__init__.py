from verticut_tpu_torch.search.linear import linear_search  # noqa: F401
from verticut_tpu_torch.search.single import (  # noqa: F401
    FusedHandle, SearchResult, mih_search, mih_search_dispatch,
    mih_search_finalize)
