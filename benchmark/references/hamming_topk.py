"""The plain reference: exact brute-force Hamming top-k in plain PyTorch.

Each corpus chunk is unpacked to ``±1`` bfloat16 vectors and scored by one
GEMM: ``dot = bits - 2 * hamming``. Every product is ``±1`` and every
partial sum an integer of magnitude at most ``bits``, which bfloat16 and
its float32 accumulator hold exactly up to 256 bits. The answer is the
``k`` smallest ``(distance, id)`` pairs: ties at one distance go to the
smaller id. Imports nothing of the program.
"""

from __future__ import annotations

import torch


def unpack_pm1(codes: torch.Tensor) -> torch.Tensor:
    """``int32[n, W]`` -> ``bfloat16[n, 32W]``: bit ``b`` of word ``w`` at
    ``32w + b``, set bits ``+1``, clear ``-1``."""
    shifts = torch.arange(32, dtype=torch.int32, device=codes.device)
    b = (codes[..., None] >> shifts) & 1
    return (2 * b - 1).reshape(codes.shape[0], -1).to(torch.bfloat16)


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distances of ``int32[..., W]`` codes, broadcasting:
    ``int32[...]``."""
    shifts = torch.arange(32, dtype=torch.int32, device=a.device)
    return ((a ^ b)[..., None] >> shifts & 1).sum((-1, -2),
                                                 dtype=torch.int32)


def topk(queries: torch.Tensor, corpus: torch.Tensor, k: int):
    """``(dists, ids)``, ``int32[S, k]`` each, ascending by ``(distance,
    id)``, of ``queries`` (``int32[S, W]``) over ``corpus``
    (``int32[N, W]``, N >= k), on the corpus's device; the result on the
    host."""
    n, w = corpus.shape
    bits = 32 * w
    if n < k:
        raise ValueError(f"{n} codes hold no top {k}")
    # key = local id + 2 * distance << s stays inside int32
    s = 31 - (2 * bits).bit_length()
    chunk = 1 << s
    q = unpack_pm1(queries.to(corpus.device))
    best = None
    for c0 in range(0, n, chunk):
        rows = corpus[c0:c0 + chunk]
        dot = (q @ unpack_pm1(rows).T).to(torch.int32)       # [S, rows]
        local = torch.arange(rows.shape[0], dtype=torch.int32,
                             device=corpus.device)
        keys = dot.mul_(-(1 << s)).add_(local + (bits << s))
        del dot
        top = torch.topk(keys, min(k, rows.shape[0]), dim=1,
                         largest=False).values.to(torch.int64)
        del keys
        dist = top >> (s + 1)
        cand = (dist << 32) | ((top & (chunk - 1)) + c0)
        best = cand if best is None else torch.cat([best, cand], dim=1)
        best = torch.topk(best, min(k, best.shape[1]), dim=1,
                          largest=False).values
    best = torch.sort(best, dim=1).values.cpu()
    return ((best >> 32).to(torch.int32),
            (best & 0xFFFFFFFF).to(torch.int32))
