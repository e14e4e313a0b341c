"""Bucket directories: substring value -> (start, count) in the
substring-sorted entry arrays, and the prefix-range directory of the range
engine.

Port of ``verticut_tpu/index/directory.py``. Every directory is a device
tensor beside the entries it describes, and a lookup is a batch of gathers
or binary searches over all probes at once:

* :class:`DenseDirectory` — offsets over all 2^s values; one gather per
  probe. Feasible up to ``s_bits`` 26.
* :class:`SortedDirectory` — the sorted substring column; two binary
  searches per probe.
* :class:`PrefixDirectory` — dense offsets over the top ``pbits`` bits
  narrow a bisection of the sorted column.
* :class:`HashDirectory` — 2-way cuckoo rows ``[key, start, count, 0]``
  built on the host (``csrc/hashdir.cc``); two row gathers per probe.
* :class:`RangeDirectory` — ``(start, end)`` per top-``pbits`` prefix: one
  probe fetches every key sharing the prefix, a superset of the bucket,
  scored with the true distance (the range engine).

Substrings are ``int32`` tensors holding uint32 bit patterns
(:mod:`verticut_tpu_torch.bits`). Up to 31 bits their signed order is the
unsigned one; at ``s_bits`` 32 it is not, so the sorted and prefix
directories keep their key column with the sign bit flipped
(``okeys``), whose signed order is the unsigned order of the keys, and
flip the probes alike before every search or comparison.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from verticut_tpu_torch import bits as bits_lib

#: XOR with this flips the sign bit: signed order of the result is the
#: unsigned order of the int32 bit pattern
SIGN = torch.iinfo(torch.int32).min


def _unsigned(subs: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return subs.to(torch.int64) & 0xFFFFFFFF


def _offsets(prefixes: torch.Tensor, width: int) -> torch.Tensor:
    """``int32[2^width + 1]``: the first row of each value of the ascending
    non-negative ``prefixes`` (CSR offsets)."""
    grid = torch.arange((1 << width) + 1, dtype=prefixes.dtype,
                        device=prefixes.device)
    return torch.searchsorted(prefixes.contiguous(), grid,
                              right=False).to(torch.int32)


def _prefixes(sorted_subs: torch.Tensor, shift: int) -> torch.Tensor:
    """The top bits of int32 substring patterns, ``shift`` bits dropped:
    non-negative int32 where a bit was dropped (ascending with the
    substrings), else the unsigned values as int64."""
    if shift == 0:
        return _unsigned(sorted_subs)
    return bits_lib.shr(sorted_subs, shift)


class DenseDirectory:
    """CSR offsets over the full 2^s_bits value space:
    ``offsets int32[2^s_bits + 1]``."""

    def __init__(self, offsets: torch.Tensor):
        self.offsets = offsets

    @property
    def s_bits(self) -> int:
        return (self.offsets.shape[0] - 1).bit_length() - 1

    def lookup(self, vals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``int32[...]`` values (< 2^s_bits) -> ``(start, count)``."""
        v = vals.long()
        start = self.offsets[v]
        return start, self.offsets[v + 1] - start


class SortedDirectory:
    """Binary-search directory over the sorted substring column."""

    def __init__(self, keys: torch.Tensor):
        self.okeys = keys ^ SIGN   # sign-flipped: ascending as signed

    @property
    def keys(self) -> torch.Tensor:
        """The sorted substring column, int32 bit patterns."""
        return self.okeys ^ SIGN

    def lookup(self, vals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        v = (vals ^ SIGN).contiguous()
        lo = torch.searchsorted(self.okeys, v, right=False)
        hi = torch.searchsorted(self.okeys, v, right=True)
        return lo.to(torch.int32), (hi - lo).to(torch.int32)


def prefix_range_search(keys: torch.Tensor, vals: torch.Tensor,
                        lo0: torch.Tensor, hi0: torch.Tensor, iters: int,
                        run_end: Optional[torch.Tensor] = None):
    """Batched ``(left, right)`` boundaries of ``vals`` within the candidate
    ranges ``[lo0, hi0)`` of the ascending ``keys`` column: ``iters``
    rounds of bisection by gathers. ``keys`` and ``vals`` compare as
    signed integers (the sign-flipped substrings of the callers).

    With ``run_end`` (``run_end[i]`` = one past the last key equal to
    ``keys[i]``) the right boundary costs two gathers instead of a second
    bisection."""
    n = keys.shape[0]

    def bound(leq: bool):
        lo, hi = lo0, hi0
        for _ in range(iters):
            active = lo < hi
            mid = (lo + hi) >> 1
            km = keys[mid.clamp(0, n - 1).long()]
            pred = (km <= vals) if leq else (km < vals)
            lo = torch.where(active & pred, mid + 1, lo)
            hi = torch.where(active & ~pred, mid, hi)
        return lo

    left = bound(False)
    if run_end is None:
        return left, bound(True)
    lc = left.clamp(0, n - 1).long()
    hit = (left < hi0) & (keys[lc] == vals)
    return left, torch.where(hit, run_end[lc], left)


class PrefixDirectory:
    """Two-level directory: dense offsets over the top ``pbits`` bits of the
    substring narrow the binary search to a short range of the sorted key
    column. ``prefix_offsets int32[2^pbits + 1]``, the keys (sign-flipped,
    see the module), ``run_end int32[N]`` (one past each key's run),
    ``shift = s_bits - pbits`` and ``iters``, the bisection rounds that
    cover the longest prefix range."""

    def __init__(self, prefix_offsets: torch.Tensor, keys: torch.Tensor,
                 run_end: torch.Tensor, shift: int, iters: int):
        self.prefix_offsets = prefix_offsets
        self.okeys = keys ^ SIGN
        self.run_end = run_end
        self.shift = shift
        self.iters = iters

    @property
    def keys(self) -> torch.Tensor:
        return self.okeys ^ SIGN

    def lookup(self, vals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        pref = bits_lib.shr(vals, self.shift).long()
        lo0 = self.prefix_offsets[pref]
        hi0 = self.prefix_offsets[pref + 1]
        left, right = prefix_range_search(self.okeys, vals ^ SIGN, lo0, hi0,
                                          self.iters, self.run_end)
        return left.to(torch.int32), (right - left).to(torch.int32)


#: the cuckoo hashes' avalanche mixer constants; they MUST match
#: ``csrc/hashdir.cc``
HASH_CONSTS = ((0x85EBCA6B, 0xC2B2AE35), (0x7FEB352D, 0x846CA68B))

_M32 = 0xFFFFFFFF


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """``v * c mod 2^32`` for int64 ``v`` in [0, 2^32), without leaving the
    int64 range: the constant in 16-bit halves."""
    lo = v * (c & 0xFFFF)
    hi = ((v * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(v: torch.Tensor, ca: int, cb: int) -> torch.Tensor:
    """The uint32 mixer of ``csrc/hashdir.cc`` on int64 values in
    [0, 2^32): multiplies wrap at 2^32, shifts are logical."""
    v = v ^ (v >> 16)
    v = _mul32(v, ca)
    v = v ^ (v >> 13)
    v = _mul32(v, cb)
    return v ^ (v >> 16)


class HashDirectory:
    """2-way cuckoo directory: ``rows int32[S, 4]`` of ``[key, start, count,
    0]`` (uint32 bit patterns), S a power of two, an empty slot count 0.
    A miss returns ``(0, 0)``."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows

    def lookup(self, vals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        mask = self.rows.shape[0] - 1
        u = _unsigned(vals)
        r1 = self.rows[_mix(u, *HASH_CONSTS[0]) & mask]
        r2 = self.rows[_mix(u, *HASH_CONSTS[1]) & mask]
        hit1 = (r1[..., 0] == vals) & (r1[..., 2] > 0)
        hit2 = (r2[..., 0] == vals) & (r2[..., 2] > 0)
        start = torch.where(hit1, r1[..., 1],
                            torch.where(hit2, r2[..., 1], 0))
        count = torch.where(hit1, r1[..., 2],
                            torch.where(hit2, r2[..., 2], 0))
        return start, count


def _load_hashdir():
    import ctypes
    from verticut_tpu_torch.kernels import _build
    vp = ctypes.c_void_p
    return _build.load("hashdir", {
        "vt_build_hashdir": (vp, ctypes.c_uint64, ctypes.c_uint64, vp)})


def build_hashdir(sorted_keys: np.ndarray, n_slots: int = 0) -> np.ndarray:
    """Cuckoo rows ``uint32[n_slots, 4]`` from the sorted (duplicated) key
    column ``uint32[N]``, on the host: the table at a 0.4 load factor
    unless ``n_slots`` is given, doubled until the insertion succeeds (the
    JAX package's ``native.build_hashdir``)."""
    import ctypes
    keys = np.ascontiguousarray(sorted_keys, np.uint32)
    n = keys.shape[0]
    if n_slots <= 0:
        n_uniq = 1 if n == 0 else int((keys[1:] != keys[:-1]).sum()) + 1
        n_slots = 1 << max(3, int(np.ceil(np.log2(max(n_uniq, 1) / 0.4))))
    lib = _load_hashdir()
    while True:
        table = np.empty((n_slots, 4), np.uint32)
        rc = lib.vt_build_hashdir(keys.ctypes.data_as(ctypes.c_void_p), n,
                                  n_slots,
                                  table.ctypes.data_as(ctypes.c_void_p))
        if rc == 0:
            return table
        if rc == -2:
            raise ValueError(f"bad n_slots {n_slots}")
        n_slots *= 2


def build_hash(sorted_subs: torch.Tensor, n_slots: int = 0) -> HashDirectory:
    """Host cuckoo build of the sorted substring column; the rows go to the
    column's device."""
    rows = build_hashdir(bits_lib.to_u32(sorted_subs), n_slots)
    return HashDirectory(bits_lib.as_codes(rows, sorted_subs.device))


class RangeDirectory:
    """``se int32[2^pbits, 2]``: (start, end) entry rows per prefix of a
    ``s_bits``-wide substring."""

    def __init__(self, se: torch.Tensor, s_bits: int):
        self.se = se
        self.s_bits = s_bits

    @property
    def pbits(self) -> int:
        return self.se.shape[0].bit_length() - 1

    def range_lookup(self, prefixes: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``int32[...]`` prefixes (< 2^pbits) -> ``(start, count)``."""
        p = self.se[prefixes.long()]
        return p[..., 0], p[..., 1] - p[..., 0]


Directory = Union[DenseDirectory, SortedDirectory, PrefixDirectory,
                  HashDirectory, RangeDirectory]


def pick_range_pbits(n: int, s_bits: int, blk: int = 16) -> int:
    """Prefix width targeting ~8 expected rows per range, clamped to keep
    ``se`` at most 128 MB (same rule as the reference)."""
    target = max(1, min(blk, 16) // 2)
    p = max(1, (max(n, 2) - 1).bit_length() - (target - 1).bit_length())
    return max(4, min(24, s_bits, p))


def build_range(sorted_subs: torch.Tensor, s_bits: int,
                pbits: Optional[int] = None, blk: int = 16
                ) -> RangeDirectory:
    """Range directory over the substring column (``int32`` bit patterns
    in unsigned order)."""
    pbits = pbits or pick_range_pbits(sorted_subs.shape[0], s_bits, blk)
    offs = _offsets(_prefixes(sorted_subs, s_bits - pbits), pbits)
    return RangeDirectory(se=torch.stack([offs[:-1], offs[1:]], dim=-1),
                          s_bits=s_bits)


def build_dense(sorted_subs: torch.Tensor, s_bits: int) -> DenseDirectory:
    """Offsets of all 2^s values, by one batched searchsorted."""
    if s_bits > 26:
        raise ValueError(
            f"dense directory infeasible at s_bits={s_bits} "
            f"(2^{s_bits}+1 offsets); use SortedDirectory")
    return DenseDirectory(_offsets(_unsigned(sorted_subs), s_bits))


def build_sorted(sorted_subs: torch.Tensor) -> SortedDirectory:
    return SortedDirectory(sorted_subs)


def pick_pbits(n: int, s_bits: int) -> int:
    """Prefix width: ~1 expected key per prefix slot, capped for memory
    (2^22+1 offsets = 16 MB) and by the substring width."""
    return max(1, min(22, s_bits - 1, (max(n, 2) - 1).bit_length()))


def compute_run_end(sorted_subs: torch.Tensor) -> torch.Tensor:
    """``run_end[i]`` = one past the last index whose key equals
    ``keys[i]``: a reverse cumulative minimum of run-terminator
    positions."""
    n = sorted_subs.shape[0]
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=sorted_subs.device)
    is_last = torch.ones(n, dtype=torch.bool, device=sorted_subs.device)
    is_last[:-1] = sorted_subs[1:] != sorted_subs[:-1]
    end_val = torch.where(is_last, idx, 0x7FFFFFFF)
    return torch.cummin(end_val.flip(0), dim=0).values.flip(0)


def build_prefix(sorted_subs: torch.Tensor, s_bits: int,
                 pbits: Optional[int] = None) -> PrefixDirectory:
    n = sorted_subs.shape[0]
    pbits = pbits or pick_pbits(n, s_bits)
    shift = s_bits - pbits
    offs = _offsets(_prefixes(sorted_subs, shift), pbits)
    max_range = int((offs[1:] - offs[:-1]).max()) if n else 1
    return PrefixDirectory(prefix_offsets=offs, keys=sorted_subs,
                           run_end=compute_run_end(sorted_subs),
                           shift=shift, iters=max(1, max_range.bit_length()))
