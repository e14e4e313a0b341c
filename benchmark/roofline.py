"""Roofline arithmetic: the card's published peaks and the least time a
kernel's work could take on it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
full 700 W power limit): 1,979 TOP/s of int8, 989 TFLOP/s of bf16, and
3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops": 1979e12, "bf16_flops": 989e12,
                              "hbm_bytes": 3.35e12},
}


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}")
    return PEAKS[kind]


def hamming_blockmin(q: int, n: int, bits: int, block: int) -> dict:
    """The work of the per-block minima of ``q`` x ``n`` Hamming distances
    of ``bits``-bit codes: ``2 * q * n * bits`` int8 operations (one
    multiply-add per bit pair), the codes read once and one int32 minimum
    per query and block written once. Counts what any implementation of
    the same answer needs."""
    nb = -(-n // block)
    return {"int8_ops": 2 * q * n * bits,
            "bytes": (q + n) * bits // 8 + 4 * q * nb}


def bound_s(work: dict, kind: str) -> tuple:
    """``(seconds, what bounds it)``: the larger of the operations at the
    peak of their type and the bytes at the memory's peak."""
    p = peaks(kind)
    by = {"int8_ops": work["int8_ops"] / p["int8_ops"],
          "bytes": work["bytes"] / p["hbm_bytes"]}
    which = max(by, key=by.get)
    return by[which], which
