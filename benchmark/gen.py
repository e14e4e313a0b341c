"""The benchmark's inputs, made on the device from the seed: the corpus
(clustered codes) and the query batches of a traffic mix.

Codes are ``int32[n, bits // 32]`` tensors holding the uint32 bit patterns
of packed binary codes (word ``w`` holds bits ``32w .. 32w + 31``), the
form the program takes. Every draw comes from a ``torch.Generator`` on the
device seeded by :func:`derive`, so the same seed on the same kind of
device gives the same inputs, and each batch of queries can be made again
on its own after the window.
"""

from __future__ import annotations

import numpy as np
import torch

#: streams of :func:`derive`
CORPUS, QUERIES, WARMUP, SAMPLE, PROBE, DRAW = range(6)

#: rows made at a time by :func:`clustered`: bounds its temporaries at
#: ~2.5 GB for 128-bit codes
CHUNK_ROWS = 1 << 22


def derive(seed: int, *path: int) -> int:
    """A 63-bit seed for the draw at ``path`` (non-negative integers)
    under the run's ``seed`` (any integer, taken modulo 2^64)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *map(int, path)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _pow2(device) -> torch.Tensor:
    """Bit ``b`` of a word as an int32 bit pattern (``-2^31`` for b = 31);
    a sum of distinct ones never leaves the int32 range."""
    return torch.tensor([1 << b for b in range(31)] + [-(1 << 31)],
                        dtype=torch.int32, device=device)


def random_words(g: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform random 32-bit words as int32 bit patterns."""
    x = torch.randint(0, 1 << 32, shape, dtype=torch.int64, generator=g,
                      device=device)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def clustered(seed: int, n: int, bits: int, codes_per_cluster: int,
              flip_p: float, device) -> torch.Tensor:
    """``n`` codes around ``max(1, n // codes_per_cluster)`` uniform random
    centres: each row a uniformly drawn centre with every bit flipped with
    probability ``round(flip_p * 256) / 256`` (at least 1/256), one random
    byte per bit. The distribution of the reference bench's corpus
    (``clustered_codes(n, n_clusters=n // 200, flip_p=0.02)``)."""
    w = bits // 32
    g = generator(seed, device)
    centres = random_words(g, (max(1, n // codes_per_cluster), w), device)
    thresh = max(1, round(flip_p * 256))
    pow2 = _pow2(device)
    out = torch.empty((n, w), dtype=torch.int32, device=device)
    for r0 in range(0, n, CHUNK_ROWS):
        rows = min(CHUNK_ROWS, n - r0)
        assign = torch.randint(0, centres.shape[0], (rows,), generator=g,
                               device=device)
        rb = torch.randint(0, 256, (rows, w, 32), dtype=torch.uint8,
                           generator=g, device=device)
        mask = ((rb < thresh) * pow2).sum(dim=-1, dtype=torch.int32)
        del rb
        out[r0:r0 + rows] = centres[assign] ^ mask
    return out


def corpus(config: dict, seed: int, device) -> torch.Tensor:
    """The corpus of a configuration file (``n_codes``, ``bits``,
    ``corpus``) under the run's ``seed``."""
    c = config["corpus"]
    if c["kind"] != "clustered":
        raise ValueError(f"unknown corpus kind {c['kind']!r}")
    return clustered(derive(seed, CORPUS), int(config["n_codes"]),
                     int(config["bits"]), int(c["codes_per_cluster"]),
                     float(c["flip_p"]), device)


def perturbed(g: torch.Generator, corpus: torch.Tensor, n: int,
              n_flips: int) -> torch.Tensor:
    """``n`` uniformly drawn corpus rows, each with ``n_flips`` uniformly
    drawn bit positions flipped (a position drawn twice cancels): the
    reference bench's near-duplicate queries."""
    dev = corpus.device
    w = corpus.shape[1]
    rows = torch.randint(0, corpus.shape[0], (n,), generator=g, device=dev)
    pos = torch.randint(0, 32 * w, (n, n_flips), generator=g, device=dev)
    out = corpus[rows]
    ar = torch.arange(n, device=dev)
    pow2 = _pow2(dev)
    for j in range(n_flips):
        out[ar, pos[:, j] // 32] ^= pow2[pos[:, j] % 32]
    return out


def batch(traffic: dict, seed: int, i: int, corpus: torch.Tensor,
          n: int, stream: int = QUERIES) -> torch.Tensor:
    """Batch ``i`` of ``n`` queries of the mix ``traffic`` under ``seed``,
    on the corpus's device: ``kind`` ``perturbed`` (``n_flips`` flips of
    corpus rows) or ``uniform`` (uniform random codes)."""
    dev = corpus.device
    g = generator(derive(seed, stream, i), dev)
    kind = traffic["kind"]
    if kind == "perturbed":
        return perturbed(g, corpus, n, int(traffic["n_flips"]))
    if kind == "uniform":
        return random_words(g, (n, corpus.shape[1]), dev)
    raise ValueError(f"unknown traffic kind {kind!r}")
