"""verticut_tpu_torch: the PyTorch / CUDA port of verticut_tpu for one
NVIDIA H100.

Exact K-nearest-neighbour search in Hamming space over packed binary codes
with multi-index hashing (MIH). The package mirrors ``verticut_tpu``
module for module (``codes``, ``config``, ``ops``, ``index``, ``search``),
and holds codes as int32 tensors with the reference's uint32 bit patterns
(``bits``). The blockmin scan kernel (``kernels``, ``csrc``) is imported
only where a scan runs, so importing the package needs no CUDA toolkit.

Public API: codes, config, index.build_index, index.save_index,
index.load_index, search.mih_search (and its halves
search.mih_search_dispatch / search.mih_search_finalize),
search.linear_search. ``python -m verticut_tpu_torch.bench`` and
``python -m verticut_tpu_torch.oracle_drive`` run the benchmark and the
oracle drive on a CUDA card.
"""

__version__ = "0.1.0"

from verticut_tpu_torch import codes  # noqa: F401
from verticut_tpu_torch.config import MIHConfig, SearchConfig  # noqa: F401
