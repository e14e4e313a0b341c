"""Exact brute-force top-k scans.

Port of the scans of ``verticut_tpu/ops/hamming.py`` (all but the
transposed-copy ``scan_blockmin_t``, a TPU layout workaround):

* :func:`scan_blockmin` — block-min pre-selection. Pass 1 computes each
  query's minimum distance over every ``block`` consecutive codes (the
  blockmin kernel on CUDA, its plain twin on the CPU); the ``k`` blocks
  with the smallest ``(min, block)`` keys provably hold the exact
  ``(dist, id)`` top-k; only those are gathered and rescored.
* :func:`scan_pallas` — full distance matrices from the pairwise kernel
  (K4's counterpart), selected chunk by chunk.
* :func:`scan_matmul` — full distance matrices as a ±1 GEMM.
* :func:`scan_popcount` — chunked full distance matrices and sorts: the
  independent oracle, sharing no selection code with the others.

All bound their temporaries by cutting the corpus into chunks whose
``[Q, chunk]`` slab stays under :data:`SLICE_ELEMS` elements: the block-min
scan folds its block selection over chunks of whole blocks (the ``[Q, nb]``
block-min matrix alone would be 15 GB at 1B codes, Q = 8192, block 512),
the others their top-k selection.
"""

from __future__ import annotations

import torch

from verticut_tpu_torch.codes import (hamming_distance, pairwise_hamming,
                                      unpack_bits_pm1)
from verticut_tpu_torch.ops import topk
from verticut_tpu_torch.ops.topk import (INF_DIST, INVALID_ID, SCAN_SENTINEL,
                                         select_asc)

#: cap on elements per slab: block-min keys of a query slice in pass 1,
#: gathered code words in the rescore, a [Q, chunk] distance slab
SLICE_ELEMS = 1 << 27
#: scan_blockmin's engines, as the reference names them
ENGINES = ("auto", "xla", "pallas")


def _decode(top: torch.Tensor, k: int):
    """``dist << 32 | id`` keys ``[Q, kk]`` -> ``(dist, id)`` padded to k."""
    invalid = top == SCAN_SENTINEL
    d = torch.where(invalid, INF_DIST, top >> 32).to(torch.int32)
    i = torch.where(invalid, INVALID_ID, top & 0xFFFFFFFF).to(torch.int32)
    kk = top.shape[-1]
    if kk < k:
        d = torch.cat([d, d.new_full((d.shape[0], k - kk), INF_DIST)], -1)
        i = torch.cat([i, i.new_full((i.shape[0], k - kk), INVALID_ID)], -1)
    return d, i


def _rescore_blocks(queries: torch.Tensor, db: torch.Tensor, n: int,
                    bidx: torch.Tensor, k: int, block: int):
    """Gather the selected blocks of the row-major corpus, rescore them
    exactly, and select the ``(dist, id)`` top-k of the narrow strip.
    Keys carry the global row, so the strip needs no particular order."""
    q = queries.shape[0]
    kb = bidx.shape[1]
    pos = (bidx.to(torch.int64)[:, :, None] * block
           + torch.arange(block, device=db.device))           # [Q, kb, blk]
    g = db[pos.clamp(max=n - 1)]                            # [Q, kb, blk, W]
    d = hamming_distance(g, queries[:, None, None, :])
    keys = torch.where(pos < n, (d.to(torch.int64) << 32) | pos,
                       SCAN_SENTINEL).reshape(q, kb * block)
    return _decode(select_asc(keys, min(k, kb * block)), k)


def _fold_blocks(q: int, block: int) -> int:
    """Blocks per corpus chunk of the block-min fold: ``Q * chunk`` keys at
    most :data:`SLICE_ELEMS`, and whole 2048-row tiles of the kernel where
    the block divides them (at least one tile)."""
    unit = max(1, 2048 // block)
    return max(unit, SLICE_ELEMS // max(q, 1) // unit * unit)


def scan_blockmin(queries: torch.Tensor, db: torch.Tensor, k: int,
                  chunk: int = 65536, block: int = 512,
                  engine: str = "auto"):
    """Exact top-k ``([Q, k], [Q, k])`` ascending by ``(dist, id)`` over
    the row-major ``int32[N, W]`` corpus, by block-min pre-selection.

    Selection proof (as in the reference): if a top-k winner lay in an
    unselected block, each of the k selected blocks would hold an element
    with a smaller distance, or an equal one at a smaller id, so k
    elements would order before it.

    Block selection is folded over corpus chunks of whole blocks, as the
    reference's XLA engine and ``scan_blockmin_t`` fold it
    (``hamming.py:181-204, 366-385``): each chunk is one call of
    :func:`kernels.blockmin.blockmin` on the whole query batch over a view
    of the corpus (the last chunk's ragged block masked by the kernel's
    rows-past-``n`` rule), and its ``min << idx_bits | block`` keys merge
    into a running ``[Q, kb]`` carry. The keys are unique, so the carry
    ends as the selection over the whole ``[Q, nb]`` matrix would. The
    rescore of the selected blocks slices the query batch instead, which
    bounds its ``[Q, kb, block, W]`` gather.

    ``chunk`` and ``engine`` are the reference's arguments, kept so its
    callers move over unchanged; neither changes the path or the result.
    The reference pads the corpus to ``chunk`` rows and picks its pass 1
    by ``engine``: the Pallas kernel K3 or an XLA GEMM, because Mosaic
    copies a row-major ``[N, 4]`` operand into a 32x lane-padded layout
    that does not fit beyond ~24M codes (``hamming.py:136-146``). The port
    has one pass 1 for every engine, which reads the row-major corpus in
    place and pads nothing, so ``chunk`` only has to be a multiple of
    ``block``, as the reference requires. An unknown engine raises."""
    from verticut_tpu_torch.kernels.blockmin import blockmin
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (one of {ENGINES})")
    if chunk % block:
        raise ValueError(f"chunk {chunk} not a multiple of block {block}")
    q, w = queries.shape
    n = db.shape[0]
    nb = -(-n // block)
    if nb == 0 or q == 0:
        return _decode(torch.empty((q, 0), dtype=torch.int64,
                                   device=queries.device), k)
    kb = min(k, nb)
    idx_bits = max(1, (nb - 1).bit_length())
    cb = _fold_blocks(q, block)
    top = None
    for c0 in range(0, nb, cb):
        c1 = min(c0 + cb, nb)
        rows = db[c0 * block:min(c1 * block, n)]
        bm = blockmin(queries, rows, rows.shape[0], block)     # [Q, c1 - c0]
        keys = (bm.to(torch.int64) << idx_bits) | torch.arange(
            c0, c1, dtype=torch.int64, device=db.device)
        del bm
        top = select_asc(keys if top is None else torch.cat([top, keys], -1),
                         kb)
        del keys
    bidx = top & ((1 << idx_bits) - 1)
    del top
    qs = max(1, SLICE_ELEMS // (kb * block * w))
    parts = [_rescore_blocks(queries[q0:q0 + qs], db, n, bidx[q0:q0 + qs],
                             k, block) for q0 in range(0, q, qs)]
    return (torch.cat([d for d, _ in parts]),
            torch.cat([i for _, i in parts]))


def _scan_chunks(queries: torch.Tensor, db: torch.Tensor, k: int,
                 chunk: int, dist_fn):
    """Exact top-k over corpus chunks of at most ``chunk`` rows, fewer
    where the ``[Q, chunk]`` slab would pass :data:`SLICE_ELEMS` elements.
    ``dist_fn(queries, rows) -> int32[Q, len(rows)]``. Each chunk's top-k
    keys merge into a running ``[Q, k]`` pool; the last chunk is shorter,
    so no row is padded or masked."""
    q = queries.shape[0]
    ch = max(1, min(chunk, SLICE_ELEMS // max(q, 1)))
    pool = torch.empty((q, 0), dtype=torch.int64, device=queries.device)
    for c0 in range(0, db.shape[0], ch):
        keys = topk.chunk_topk_affine(dist_fn(queries, db[c0:c0 + ch]), c0, k)
        pool = topk.merge_topk(pool, keys, k)
    return _decode(pool, k)


def scan_pallas(queries: torch.Tensor, db: torch.Tensor, k: int,
                chunk: int = 131072):
    """Exact top-k from full distance matrices computed by
    :func:`kernels.pairwise.pairwise`: the CUDA kernel that stands for
    K4 ``pallas_pairwise_hamming`` on a GPU, its twin on the CPU. The
    name is the reference's. The reference pads queries and the corpus
    to the kernel's tiles; the port pads nothing."""
    from verticut_tpu_torch.kernels.pairwise import pairwise
    return _scan_chunks(queries.contiguous(), db.contiguous(), k, chunk,
                        pairwise)


def scan_matmul(queries: torch.Tensor, db: torch.Tensor, k: int,
                chunk: int = 32768):
    """Exact top-k via the ±1 GEMM, ``dist = (B - q_pm1 . d_pm1) / 2``,
    one ``torch.matmul`` per corpus chunk; the reference computes it in
    plain XLA as well, outside any Pallas kernel.

    The dtypes keep every product and sum exact. The operands are ±1 and
    the dot is an even integer with ``|dot| <= B``: bfloat16 holds every
    such value up to B = 256 and the GEMM accumulates in float32, so
    CUDA tensors of codes up to 256 bits take bfloat16 (the tensor
    cores); wider codes and CPU tensors take float32 (on the card with
    TF32 off, PyTorch's default)."""
    bits = 32 * queries.shape[1]
    dt = (torch.bfloat16 if queries.is_cuda and bits <= 256
          else torch.float32)
    qpm = unpack_bits_pm1(queries, dt)

    def dist(_q, rows):
        dot = (qpm @ unpack_bits_pm1(rows, dt).T).to(torch.int32)
        return (bits - dot) >> 1

    return _scan_chunks(queries, db, k, chunk, dist)


def scan_popcount(queries: torch.Tensor, db: torch.Tensor, k: int,
                  chunk: int = 65536):
    """Exact top-k by full distance matrices over corpus chunks, each
    chunk's keys sorted in full and merged into a running pool."""
    q, w = queries.shape
    n = db.shape[0]
    ch = max(1, min(chunk, SLICE_ELEMS // 4 // max(q * w, 1)))
    pool = torch.empty((q, 0), dtype=torch.int64, device=queries.device)
    for c0 in range(0, n, ch):
        c1 = min(c0 + ch, n)
        d = pairwise_hamming(queries, db[c0:c1])
        keys = ((d.to(torch.int64) << 32)
                | torch.arange(c0, c1, device=db.device))
        keys = torch.sort(keys, dim=-1).values[:, :k]
        pool = torch.sort(torch.cat([pool, keys], -1), dim=-1).values[:, :k]
    return _decode(pool, k)
