"""Packed binary codes: generation and device bit manipulation.

A B-bit code is ``B // 32`` words, word ``w`` holding bytes ``4w..4w+3``
little-endian, exactly as in ``verticut_tpu/codes.py``. Host arrays are
numpy ``uint32`` (byte-identical to the JAX package's generators); device
code is torch ``int32`` tensors holding the same bit patterns
(:mod:`verticut_tpu_torch.bits`). :func:`clustered_codes_device` makes a
corpus on the device itself, as the reference does at 100M codes.
"""

from __future__ import annotations

import numpy as np
import torch

from verticut_tpu_torch.bits import entry_device, popcount32, shr


# --------------------------------------------------------------------------
# Host-side packing and generation (numpy; same bytes as the reference)
# --------------------------------------------------------------------------

def pack_bytes(raw: np.ndarray) -> np.ndarray:
    """Pack ``uint8[N, nbytes]`` code bytes into ``uint32[N, nbytes//4]``
    (byte ``4w+j`` -> bits ``8j..8j+7`` of word ``w``)."""
    raw = np.asarray(raw, dtype=np.uint8)
    if raw.ndim == 1:
        raw = raw[None]
    n, nbytes = raw.shape
    if nbytes % 4:
        raise ValueError(f"code byte length {nbytes} not a multiple of 4")
    b = raw.reshape(n, nbytes // 4, 4).astype(np.uint32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def unpack_to_bytes(words: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_bytes`: ``uint32[N, W]`` -> ``uint8[N, 4W]``."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = np.array([0, 8, 16, 24], dtype=np.uint32)
    b = (words[..., None] >> shifts) & np.uint32(0xFF)
    return b.reshape(*words.shape[:-1], words.shape[-1] * 4).astype(np.uint8)


def random_codes(seed: int, n: int, bits: int = 128) -> np.ndarray:
    """Uniform random packed codes ``uint32[n, bits//32]``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n, bits // 32), dtype=np.uint32)


def clustered_codes(seed: int, n: int, bits: int = 128,
                    n_clusters: int = 64, flip_p: float = 0.05) -> np.ndarray:
    """Codes clustered around random centers: each row is a random center
    with a Binomial(bits, flip_p) count of random bit positions XOR-ed in
    (duplicate positions cancel)."""
    rng = np.random.default_rng(seed)
    nbytes = bits // 8
    w = nbytes // 4
    centers = pack_bytes(
        rng.integers(0, 256, size=(n_clusters, nbytes), dtype=np.uint8))
    assign = rng.integers(0, n_clusters, size=n)
    out = centers[assign].copy()
    counts = rng.binomial(bits, flip_p, size=n)
    total = int(counts.sum())
    row = np.repeat(np.arange(n, dtype=np.int64), counts)
    pos = rng.integers(0, bits, size=total)
    flat = out.reshape(-1)
    idx = row * w + (pos >> 5)
    vals = (np.uint32(1) << (pos & 31)).astype(np.uint32)
    # grouped XOR via sort + reduceat (ufunc.at is ~100x slower)
    order = np.argsort(idx, kind="stable")
    sidx, svals = idx[order], vals[order]
    starts = np.flatnonzero(np.concatenate(
        [[True], sidx[1:] != sidx[:-1]]))
    if len(sidx):
        flat[sidx[starts]] ^= np.bitwise_xor.reduceat(svals, starts)
    return out


#: rows generated at a time on the device: bounds the [rows, bits] random
#: bytes at 512 MB for 128-bit codes
DEVICE_GEN_CHUNK = 4 * 1024 * 1024


def clustered_codes_device(seed: int, n: int, bits: int = 128,
                           n_clusters: int = 64, flip_p: float = 0.05, *,
                           device=None) -> torch.Tensor:
    """Clustered codes generated on ``device`` (by default the card, raising
    where there is none): ``int32[n, bits // 32]``.

    The distribution family of the reference's device generator
    (``verticut_tpu/codes.py:95-143``): ``n_clusters`` uniform random
    centers, each row a uniformly drawn center with every bit flipped with
    probability ``round(flip_p * 256) / 256`` (at least 1/256), decided by
    one random byte per bit; rows are made in chunks of at most
    :data:`DEVICE_GEN_CHUNK`. The bits come from a ``torch.Generator`` on
    ``device`` seeded with ``seed``: the same seed on the same kind of
    device gives the same codes, but not the reference's (``jax.random``
    draws other numbers)."""
    device = entry_device(device)
    w = bits // 32
    thresh = max(1, round(flip_p * 256))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    centers = torch.randint(0, 1 << 32, (n_clusters, w), dtype=torch.int64,
                            generator=gen, device=device)
    centers = torch.where(centers >= 1 << 31, centers - (1 << 32),
                          centers).to(torch.int32)
    # bit b of a word as an int32 bit pattern: -2^31 for the sign bit, and
    # a sum of distinct ones never leaves the int32 range
    pow2 = torch.tensor([1 << b for b in range(31)] + [-(1 << 31)],
                        dtype=torch.int32, device=device)
    out = torch.empty((n, w), dtype=torch.int32, device=device)
    for r0 in range(0, n, DEVICE_GEN_CHUNK):
        rows = min(DEVICE_GEN_CHUNK, n - r0)
        assign = torch.randint(0, n_clusters, (rows,), generator=gen,
                               device=device)
        rb = torch.randint(0, 256, (rows, w, 32), dtype=torch.uint8,
                           generator=gen, device=device)
        mask = ((rb < thresh) * pow2).sum(dim=-1, dtype=torch.int32)
        del rb
        out[r0:r0 + rows] = centers[assign] ^ mask
    return out


# --------------------------------------------------------------------------
# Substrings (the hash-table bucket index)
# --------------------------------------------------------------------------

def substring(codes: torch.Tensor, table_id: int, s_bits: int) -> torch.Tensor:
    """Substring ``table_id`` of width ``s_bits`` of ``int32[..., W]``
    codes: ``s_bits // 8`` bytes from byte ``table_id * s_bits // 8``,
    composed little-endian (``binaryToInt``). Returns ``int32[...]`` bit
    patterns; ``s_bits`` must be a multiple of 8 and <= 32."""
    if s_bits % 8 or s_bits > 32:
        raise ValueError(f"s_bits must be a multiple of 8 and <= 32: {s_bits}")
    if s_bits == 32:
        return codes[..., table_id]
    start = table_id * (s_bits // 8)
    val = torch.zeros(codes.shape[:-1], dtype=torch.int32, device=codes.device)
    for j in range(s_bits // 8):
        byte_idx = start + j
        word = codes[..., byte_idx // 4]
        byte = shr(word, (byte_idx % 4) * 8) & 0xFF
        val = val | (byte << (8 * j))
    return val


def all_substrings(codes: torch.Tensor, n_tables: int) -> torch.Tensor:
    """``int32[..., W] -> int32[..., n_tables]``: every table's substring."""
    s_bits = codes.shape[-1] * 32 // n_tables
    return torch.stack(
        [substring(codes, t, s_bits) for t in range(n_tables)], dim=-1)


# --------------------------------------------------------------------------
# Hamming distance (XOR + popcount)
# --------------------------------------------------------------------------

def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance, broadcasting over leading dims and
    reducing the word dim: ``int32[..., W] x int32[..., W] -> int32[...]``."""
    return popcount32(a ^ b).sum(dim=-1, dtype=torch.int32)


def pairwise_hamming(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """All-pairs distances ``[Q, W] x [N, W] -> int32[Q, N]``. Materializes
    ``[Q, N, W]``; callers chunk N."""
    return hamming_distance(queries[:, None, :], db[None, :, :])


# --------------------------------------------------------------------------
# The GEMM formulation: dist = (B - <+-1 bits, +-1 bits>) / 2
# --------------------------------------------------------------------------

def unpack_bits_pm1(codes: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``int32[..., W]`` codes -> ``+-1`` vectors ``[..., 32W]`` of
    ``dtype``: bit k of word w (LSB first) at position ``32w + k``, set
    bits +1. A dot product of two such vectors is ``B - 2 * hamming``."""
    shifts = torch.arange(32, dtype=torch.int32, device=codes.device)
    b = (codes[..., None] >> shifts) & 1     # the mask drops sign fill
    b = b.reshape(*codes.shape[:-1], codes.shape[-1] * 32)
    return (2 * b - 1).to(dtype)
