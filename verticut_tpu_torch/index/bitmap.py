"""Bucket-occupancy bitmap: one bit per possible substring value per table.

Port of ``verticut_tpu/index/bitmap.py``. Bit layout as in the reference's
``ImageBitmap`` (``src/bitmap.cc:22-26``): value ``v`` -> word ``v >> 5``,
bit ``v & 31``. Words are int32 tensors holding uint32 bit patterns
(:mod:`verticut_tpu_torch.bits`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from verticut_tpu_torch.bits import popcount32, shr


class Bitmap(NamedTuple):
    words: torch.Tensor  # int32[2^s_bits / 32]

    def get(self, vals: torch.Tensor) -> torch.Tensor:
        """``int32[...] -> bool[...]``: is bucket ``v`` non-empty?"""
        word = self.words[shr(vals, 5).long()]
        # an arithmetic shift fills the top bits only; bit 0 is bit v & 31
        return ((word >> (vals & 31)) & 1) != 0

    def count(self) -> torch.Tensor:
        """Number of occupied buckets."""
        return popcount32(self.words).sum(dtype=torch.int64)

    def union(self, other: "Bitmap") -> "Bitmap":
        """Bitwise OR (the reference's ``mpi_coordinator::bitwise_or``)."""
        return Bitmap(words=self.words | other.words)


def build_bitmap(sorted_subs: torch.Tensor, s_bits: int) -> Bitmap:
    """Build from a table's sorted substring column (int32 bit patterns).

    A value's first occurrence contributes its bit, so a scatter-add of the
    bits (in int64, which holds bit 31 without overflow) is a scatter-OR:
    distinct values in one word touch distinct bits."""
    first = torch.ones(sorted_subs.shape, dtype=torch.bool,
                       device=sorted_subs.device)
    first[1:] = sorted_subs[1:] != sorted_subs[:-1]
    contrib = torch.where(first, 1 << (sorted_subs & 31).to(torch.int64), 0)
    n_words = (1 << s_bits) // 32 if s_bits >= 5 else 1
    words = torch.zeros(n_words, dtype=torch.int64, device=sorted_subs.device)
    words.index_add_(0, shr(sorted_subs, 5).long(), contrib)
    return Bitmap(words=torch.where(words >= 1 << 31, words - (1 << 32),
                                    words).to(torch.int32))
