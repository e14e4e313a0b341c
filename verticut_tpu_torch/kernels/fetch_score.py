"""Fetch + score of the radius step's candidate blocks: the CUDA kernel's
wrapper and its plain twins.

Both layouts return ``(dist int32[Q, CHB*blk], id int32[Q, CHB*blk])``:
for chunk slot ``c`` of query ``q`` and row ``r`` of block ``blk_id[q,
c]``, the Hamming distance of the entry to the query and its id where
``lo[q, c] <= r < hi[q, c]`` and the id is not negative (a pad entry),
``(INF_DIST, INVALID_ID)`` elsewhere:

* :func:`fetch_score_blocks`, the inline rows ``int32[NB, blk*(W+1)]``
  (lane ``w*blk + r`` = word ``w`` of entry ``r``, word 0 the id);
* :func:`fetch_score_idrows`, the compact layout's id rows ``int32[NBc,
  blk]`` and the id-ordered ``codes`` ``int32[N, W]``.

A CPU tensor takes the plain twin (:func:`fetch_score_blocks_reference`,
:func:`fetch_score_idrows_reference`). A CUDA tensor launches
``csrc/fetch_score.cu``, one entry per layout, or raises: there is no
fallback. The kernel is built and loaded by :mod:`._build` and takes
W = 1 to 8. It replaces no TPU kernel: the reference computes this in
plain ``jnp`` that XLA fuses (``verticut_tpu/ops/chunks.py``), where
eager PyTorch ran it as ~95 launches a table.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from verticut_tpu_torch.bits import popcount32
from verticut_tpu_torch.kernels import _build
from verticut_tpu_torch.ops.topk import INF_DIST, INVALID_ID
from verticut_tpu_torch.utils import timer

NAME = "fetch_score"
SOURCE = _build.source(NAME)
#: the widest codes the kernel takes, in 32-bit words
MAX_WORDS = 8

#: kernel launches made by either entry (never by a twin)
launches = 0
# the count is bumped from dispatch worker threads
_count_lock = threading.Lock()


def build() -> None:
    """Compile the kernel library if it is missing or older than its
    source."""
    _build.build(NAME)


def _load():
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return _build.load(NAME, {
        "vt_fetch_score_rows": (vp, ll, i, vp, vp, vp, vp, vp, vp, i, i, i,
                                vp),
        "vt_fetch_score_idrows": (vp, ll, i, vp, ll, vp, vp, vp, vp, vp, vp,
                                  i, i, i, vp)})


def _check(rows: torch.Tensor, blk: int, lanes: int, blk_id: torch.Tensor,
           lo: torch.Tensor, hi: torch.Tensor, queries: torch.Tensor,
           codes: Optional[torch.Tensor] = None) -> bool:
    """Check the operands of either layout; True when they take the
    kernel (a CUDA device), False for the twin (the CPU)."""
    ops = (rows, blk_id, lo, hi, queries) + (() if codes is None
                                             else (codes,))
    if any(t.dtype != torch.int32 for t in ops):
        raise TypeError(f"{NAME} takes int32 tensors, got "
                        f"{[str(t.dtype) for t in ops]}")
    dev = queries.device
    if any(t.device != dev for t in ops):
        raise ValueError(f"{NAME}: operands on {[str(t.device) for t in ops]}"
                         ", not one device")
    if queries.ndim != 2 or blk_id.ndim != 2:
        raise ValueError(f"{NAME}: queries {tuple(queries.shape)} and "
                         f"blk_id {tuple(blk_id.shape)} are not [Q, W] and "
                         "[Q, CHB]")
    w = queries.shape[1]
    if (lo.shape != blk_id.shape or hi.shape != blk_id.shape
            or blk_id.shape[0] != queries.shape[0]):
        raise ValueError(f"{NAME}: blk_id / lo / hi {tuple(blk_id.shape)} / "
                         f"{tuple(lo.shape)} / {tuple(hi.shape)} are not "
                         f"[{queries.shape[0]}, CHB]")
    if rows.ndim != 2 or blk <= 0 or rows.shape[1] != lanes:
        raise ValueError(f"{NAME}: rows {tuple(rows.shape)} are not "
                         f"[NB, {lanes}] (blk {blk}, W {w})")
    if codes is not None and (codes.ndim != 2 or codes.shape[1] != w):
        raise ValueError(f"{NAME}: codes {tuple(codes.shape)} are not "
                         f"[N, {w}]")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{NAME} has no kernel for {dev}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{NAME} takes contiguous tensors")
    if not 1 <= w <= MAX_WORDS:
        raise ValueError(f"{NAME} has no kernel for W={w} (1 to "
                         f"{MAX_WORDS})")
    if rows.shape[0] == 0 or (codes is not None and codes.shape[0] == 0):
        raise ValueError(f"{NAME}: an empty table has no block to fetch")
    return True


def fetch_score_blocks_reference(entry_rows: torch.Tensor,
                                 blk_id: torch.Tensor, lo: torch.Tensor,
                                 hi: torch.Tensor, queries: torch.Tensor, *,
                                 blk: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch fetch + score of inline rows: gather the descriptor
    blocks, then per code word an XOR and the SWAR popcount, then the
    window and pad masks."""
    w = queries.shape[-1]
    nq, chb = blk_id.shape
    g = entry_rows[blk_id.long()]                            # [Q,CHB,blk*RW]
    ids = g[..., 0:blk]
    dist = torch.zeros_like(ids)
    for j in range(w):
        x = g[..., (1 + j) * blk:(2 + j) * blk] ^ queries[:, None, j:j + 1]
        dist += popcount32(x)
    pos = torch.arange(blk, dtype=torch.int32, device=blk_id.device)
    valid = (pos >= lo[..., None]) & (pos < hi[..., None]) & (ids >= 0)
    dist = torch.where(valid, dist, INF_DIST)
    ids = torch.where(valid, ids, INVALID_ID)
    return dist.reshape(nq, chb * blk), ids.reshape(nq, chb * blk)


def fetch_score_idrows_reference(entry_idrows: torch.Tensor,
                                 codes: torch.Tensor, blk_id: torch.Tensor,
                                 lo: torch.Tensor, hi: torch.Tensor,
                                 queries: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch fetch + score of the compact layout: gather the
    descriptor blocks of id rows, then each candidate's code from
    ``codes`` at its id (clamped to the array), and score them. The chunk
    axis is cut into slices so the gathered ``[Q, slice, blk, W]`` codes
    stay under 2^23 words, as the reference slices it."""
    nq, chb = blk_id.shape
    blk = entry_idrows.shape[1]
    n, w = codes.shape
    pos = torch.arange(blk, dtype=torch.int32, device=blk_id.device)
    sl = max(8, (1 << 23) // max(nq * blk * w, 1))
    d_parts, i_parts = [], []
    for c0 in range(0, chb, sl):
        cid = entry_idrows[blk_id[:, c0:c0 + sl].long()]      # [Q, s, blk]
        g = codes[cid.clamp(0, n - 1).long()]                  # [Q,s,blk,W]
        dist = popcount32(g ^ queries[:, None, None, :]).sum(
            dim=-1, dtype=torch.int32)
        ok = ((pos >= lo[:, c0:c0 + sl, None])
              & (pos < hi[:, c0:c0 + sl, None]) & (cid >= 0))
        d_parts.append(torch.where(ok, dist, INF_DIST).reshape(nq, -1))
        i_parts.append(torch.where(ok, cid, INVALID_ID).reshape(nq, -1))
    return torch.cat(d_parts, dim=-1), torch.cat(i_parts, dim=-1)


def fetch_score_blocks(entry_rows: torch.Tensor, blk_id: torch.Tensor,
                       lo: torch.Tensor, hi: torch.Tensor,
                       queries: torch.Tensor, *, blk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fetch + score of inline rows. CPU tensors take the plain twin; CUDA
    tensors launch the kernel."""
    w = queries.shape[-1]
    if not _check(entry_rows, blk, blk * (w + 1), blk_id, lo, hi, queries):
        return fetch_score_blocks_reference(entry_rows, blk_id, lo, hi,
                                            queries, blk=blk)
    nq, chb = blk_id.shape
    dist, ids = _outputs(blk_id, blk)
    return _launch("vt_fetch_score_rows", queries.device, (
        entry_rows.data_ptr(), entry_rows.shape[0], blk, blk_id.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), queries.data_ptr(), dist.data_ptr(),
        ids.data_ptr(), nq, chb, w), dist, ids)


def fetch_score_idrows(entry_idrows: torch.Tensor, codes: torch.Tensor,
                       blk_id: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, queries: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fetch + score of the compact layout, ``blk`` = the id rows' width.
    CPU tensors take the plain twin; CUDA tensors launch the kernel, once
    for every chunk slot."""
    blk = entry_idrows.shape[-1] if entry_idrows.ndim == 2 else 0
    if not _check(entry_idrows, blk, blk, blk_id, lo, hi, queries, codes):
        return fetch_score_idrows_reference(entry_idrows, codes, blk_id, lo,
                                            hi, queries)
    nq, chb = blk_id.shape
    dist, ids = _outputs(blk_id, blk)
    return _launch("vt_fetch_score_idrows", queries.device, (
        entry_idrows.data_ptr(), entry_idrows.shape[0], blk,
        codes.data_ptr(), codes.shape[0], blk_id.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), queries.data_ptr(), dist.data_ptr(), ids.data_ptr(),
        nq, chb, queries.shape[1]), dist, ids)


def _outputs(blk_id: torch.Tensor, blk: int):
    shape = (blk_id.shape[0], blk_id.shape[1] * blk)
    return blk_id.new_empty(shape), blk_id.new_empty(shape)


def _launch(entry: str, device: torch.device, args: tuple,
            dist: torch.Tensor, ids: torch.Tensor):
    """Launch ``entry`` on the current stream of ``device``, raise on a
    launch error, and count the launch."""
    global launches
    if dist.numel() == 0:
        return dist, ids
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*args, stream)
    _build.check_launch(lib, err, NAME)
    with _count_lock:
        launches += 1
    timer.count("mih.fetch_score_launches")
    return dist, ids
