"""The prefix-range directory of the range engine.

Port of ``RangeDirectory``, ``pick_range_pbits`` and ``build_range`` from
``verticut_tpu/index/directory.py``. A range directory holds, for every
value of the top ``pbits`` bits of a substring, the ``(start, end)`` row
range of the substring-sorted entries that share that prefix. One probe per
flipped prefix fetches the whole range: a superset of the bucket-exact
candidates, scored with their true distance, which keeps MIH exact.

Only the range directory is ported. The dense, sorted, prefix and hash
directories serve the legacy bucket engines (ROADMAP.md, Queue 1 item 8).
"""

from __future__ import annotations

from typing import Tuple

import torch


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


def pick_range_pbits(n: int, s_bits: int, blk: int = 16) -> int:
    """Prefix width targeting ~8 expected rows per range, clamped to keep
    ``se`` at most 128 MB (same rule as the reference)."""
    target = max(1, min(blk, 16) // 2)
    p = max(1, (max(n, 2) - 1).bit_length() - (target - 1).bit_length())
    return max(4, min(24, s_bits, p))


def build_range(sorted_subs: torch.Tensor, s_bits: int,
                pbits: int) -> RangeDirectory:
    """Range directory over an ascending substring column (``int64``
    unsigned values, or ``int32`` bit patterns)."""
    subs = sorted_subs.to(torch.int64) & 0xFFFFFFFF
    prefixes = (subs >> (s_bits - pbits)).contiguous()
    grid = torch.arange((1 << pbits) + 1, dtype=torch.int64,
                        device=sorted_subs.device)
    offs = torch.searchsorted(prefixes, grid, right=False).to(torch.int32)
    return RangeDirectory(se=torch.stack([offs[:-1], offs[1:]], dim=-1),
                          s_bits=s_bits)
