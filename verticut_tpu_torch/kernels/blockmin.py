"""Block-min Hamming scan: the CUDA kernel's wrapper and its plain twin.

``blockmin(queries, db, n, block)`` returns ``int32[Q, ceil(N / block)]``:
the minimum Hamming distance from each query to the rows of each
``block``-row block of ``db``, counting only rows ``< n``; a block with no
such row reports ``bits + 1``.

A CPU tensor takes :func:`blockmin_reference`, the plain PyTorch version.
A CUDA tensor launches ``csrc/blockmin.cu`` or raises: there is no
fallback. The kernel is built and loaded by :mod:`._build`. It has two
instances, chosen by :func:`instance` from the code width and the block
alone: a tensor-core one (an int8 ±1 GEMM on ``wgmma``) for 32- to
256-bit codes and power-of-two blocks of 32 to 2048 rows, every shape the
search paths use, and a generic one on the CUDA cores (XOR + popcount)
for every other width and block. The CPU mirrors of the tensor-core
instance's operands are on the CPU: :func:`expand_queries`,
:func:`expand_codes`.

This is the counterpart of three TPU kernels
(``verticut_tpu/ops/pallas/linear_scan.py``): K1 ``pallas_blockmin_t2``
and K2 ``pallas_blockmin_t``, which read a transposed corpus copy, and K3
``pallas_blockmin``, which reads the row-major corpus and excludes rows
``>= n`` as this function does. The kernel masks rows ``>= n`` itself, so
no caller fixes up the tail.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from verticut_tpu_torch.codes import pairwise_hamming
from verticut_tpu_torch.kernels import _build

NAME = "blockmin"
SOURCE = _build.source(NAME)
#: the kernel's instances, as :func:`instance` names them
INSTANCES: Tuple[str, ...] = ("tensor", "generic")

#: kernel launches made by :func:`blockmin`, either instance (never by the
#: twin), and the same launches by instance
launches = 0
launches_by_instance: Dict[str, int] = dict.fromkeys(INSTANCES, 0)

#: elements of the twin's [Q, rows, W] temporaries per corpus chunk
_TWIN_CHUNK_ELEMS = 1 << 25


def instance(w: int, block: int) -> str:
    """The kernel instance that runs for ``w``-word codes and ``block``-row
    blocks: ``"tensor"`` for 1 <= w <= 8 and a power-of-two block from 32
    to 2048, else ``"generic"``. :func:`blockmin` passes the choice to
    ``vt_blockmin``, which refuses the tensor-core instance for a shape it
    does not take."""
    if 1 <= w <= 8 and 32 <= block <= 2048 and block & (block - 1) == 0:
        return "tensor"
    return "generic"


def _expand(codes: torch.Tensor, query: bool) -> torch.Tensor:
    t = torch.arange(8, device=codes.device).repeat_interleave(4)
    bit = (t + 8 * torch.arange(4, device=codes.device).repeat(8))
    b = (codes[..., None] >> bit.to(torch.int32)) & 1   # [..., W, 32]
    if query:
        v = (2 * b - 1) * torch.where(t < 7, 2 ** (6 - t), 1)
    else:
        v = b * torch.where(t < 7, 2 ** t, 64)
    return v.reshape(*codes.shape[:-1], codes.shape[-1] * 32).to(torch.int8)


def expand_queries(codes: torch.Tensor) -> torch.Tensor:
    """``int32[..., W]`` query codes -> ``int8[..., 32W]``, the tensor-core
    instance's A operand (``query_group`` in ``csrc/blockmin.cu``; the two
    must stay in step): byte ``32w + 4t + j`` is ``+-2^(6-t)`` (``+-1`` for
    t = 7), + where bit ``t + 8j`` of word ``w`` is set."""
    return _expand(codes, True)


def expand_codes(codes: torch.Tensor) -> torch.Tensor:
    """``int32[..., W]`` corpus codes -> ``int8[..., 32W]``, the B operand
    (``code_group`` in ``csrc/blockmin.cu``): byte ``32w + 4t + j`` is bit
    ``t + 8j`` of word ``w`` times ``2^t`` (64 for t = 7). Every product
    with :func:`expand_queries` is ``+-64 * bit``, so ``hamming(q, c) =
    popcount(q) - (q8 . c8) / 64``."""
    return _expand(codes, False)


def build() -> None:
    """Compile the kernel library if it is missing or older than its
    source."""
    _build.build(NAME)


def _load():
    vp = ctypes.c_void_p
    return _build.load(NAME, {
        "vt_blockmin": (vp, vp, vp, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_int, vp)})


def _check(queries: torch.Tensor, db: torch.Tensor, n: int, block: int):
    _build.check_codes(NAME, queries, db)
    if not 0 <= n <= db.shape[0]:
        raise ValueError(f"n={n} outside [0, {db.shape[0]}]")
    if block <= 0:
        raise ValueError(f"block={block}")


def blockmin_reference(queries: torch.Tensor, db: torch.Tensor, n: int,
                       block: int) -> torch.Tensor:
    """Plain PyTorch block-min: chunked SWAR distance matrices, then the
    minimum per block; rows >= n and empty blocks count as ``bits + 1``."""
    _check(queries, db, n, block)
    nq, w = queries.shape
    n_rows = db.shape[0]
    bits = 32 * w
    nb = -(-n_rows // block)
    out = torch.empty((nq, nb), dtype=torch.int32, device=queries.device)
    if nq == 0 or nb == 0:
        return out
    rows = max(block, (_TWIN_CHUNK_ELEMS // max(nq * w, 1)) // block * block)
    for r0 in range(0, nb * block, rows):
        r1 = min(r0 + rows, nb * block)
        d = torch.full((nq, r1 - r0), bits + 1, dtype=torch.int32,
                       device=queries.device)
        hi = min(r1, n)
        if hi > r0:
            d[:, :hi - r0] = pairwise_hamming(queries, db[r0:hi])
        out[:, r0 // block:r1 // block] = d.reshape(
            nq, (r1 - r0) // block, block).amin(dim=-1)
    return out


def blockmin(queries: torch.Tensor, db: torch.Tensor, n: int,
             block: int) -> torch.Tensor:
    """Per-block minimum distances ``int32[Q, ceil(N / block)]``. CPU
    tensors take the plain twin; CUDA tensors launch the kernel."""
    _check(queries, db, n, block)
    if queries.device.type == "cpu":
        return blockmin_reference(queries, db, n, block)
    _build.check_kernel_operands(NAME, queries, db)
    global launches
    lib = _load()
    nq, w = queries.shape
    which = instance(w, block)
    out = torch.empty((nq, -(-db.shape[0] // block)), dtype=torch.int32,
                      device=queries.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vt_blockmin(queries.data_ptr(), db.data_ptr(),
                              out.data_ptr(), nq, n, db.shape[0], w, block,
                              which == "tensor", stream)
    _build.check_launch(lib, err, "blockmin")
    launches += 1
    launches_by_instance[which] += 1
    return out
