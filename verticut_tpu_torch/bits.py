"""Integer helpers that stand in for torch's missing uint32 support.

torch's ``uint32`` dtype raises for ``>>``, ``<<``, ``~``, comparisons,
``max`` and ``topk``, and torch has no popcount op. So the port carries
every 32-bit word (codes, substrings, pad ids) as an ``int32`` tensor that
holds the same bit pattern, and:

* masks after every right shift (``>>`` on int32 is arithmetic);
* counts bits with a SWAR popcount whose intermediates stay non-negative.

Selection keys are ascending ``int64`` values (``ops/topk.pack_keys``).

A pad id ``0xFFFFFFFF`` reads as ``-1`` in this representation, so the
reference's validity test ``ids >= 0`` holds as written.
"""

from __future__ import annotations

import numpy as np
import torch


def to_u32(t: torch.Tensor) -> np.ndarray:
    """``int32`` tensor -> ``uint32`` numpy array with the same bits."""
    return t.detach().cpu().numpy().astype(np.int32, copy=False).view(
        np.uint32)


def entry_device(device=None, *data) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else that of
    the first tensor among ``data``, else the card. It never takes the CPU
    unasked: with no card and no device named it raises."""
    if device is not None:
        return torch.device(device)
    for x in data:
        if isinstance(x, torch.Tensor):
            return x.device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: verticut_tpu_torch runs on the "
                           "card by default; pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda")


def as_codes(x, device=None) -> torch.Tensor:
    """Packed codes as an ``int32`` tensor: numpy uint32/int32 arrays are
    reinterpreted, tensors pass through (moved to ``device`` if given).
    A conversion helper, not an entry point: ``device=None`` leaves the
    data where it is (numpy arrays on the CPU)."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise TypeError(f"code tensors must be int32, got {x.dtype}")
        return x if device is None else x.to(device)
    a = np.asarray(x)
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"code arrays must be uint32, got {a.dtype}")
    t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    return t if device is None else t.to(device)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 word (SWAR). The sign bit is counted apart,
    so every intermediate of the 31-bit SWAR stays non-negative."""
    sign = (x < 0).to(torch.int32)
    v = x & 0x7FFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F) + sign
