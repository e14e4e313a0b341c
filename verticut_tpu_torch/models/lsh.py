"""Binary-code encoders: the models that produce the codes the MIH engine
indexes.

Port of ``verticut_tpu/models/lsh.py``. Encoding is one ``[B, D] x [D,
bits]`` product (two for ITQ), a sign and a little-endian bit-pack, as
``codes.pack_bytes`` packs bytes:

* :class:`RandomProjectionLSH` — signed random projections (SimHash), no
  training.
* :class:`ITQEncoder` — PCA then Iterative Quantization: a learned
  rotation that lowers the quantization error.

The products run in true fp32 on every device: :func:`_fp32` raises
PyTorch's fp32 matmul precision to ``"highest"`` around them (so TF32 is
off on the card whatever the caller set) and restores it after. The
random draws come from a ``torch.Generator`` seeded with ``seed``; they
are not the reference's ``jax.random`` streams, so a fitted encoder equals
the reference's in its properties, not in its arrays. Given the
reference's arrays, :meth:`encode` gives its bits wherever a projection
is not within float rounding of 0.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Union

import numpy as np
import torch

from verticut_tpu_torch import bits as bits_lib
from verticut_tpu_torch import codes as codes_lib

_precision_lock = threading.Lock()


@contextlib.contextmanager
def _fp32():
    """fp32 matmuls in full precision (no TF32) inside the block."""
    with _precision_lock:
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev)


def _pack_bits(b: torch.Tensor) -> torch.Tensor:
    """``bool[..., n_bits]`` -> ``int32[..., n_bits // 32]`` bit patterns,
    bit ``j`` of word ``w`` = element ``32w + j``."""
    *lead, nb = b.shape
    if nb % 32:
        raise ValueError(f"bit count {nb} not a multiple of 32")
    shifts = torch.arange(32, dtype=torch.int64, device=b.device)
    w = (b.reshape(*lead, nb // 32, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _features(x, device) -> torch.Tensor:
    """Features as an fp32 tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=torch.float32)


class RandomProjectionLSH(NamedTuple):
    """codes = pack(sign(X @ P)) with a fixed seeded projection."""

    projection: torch.Tensor  # f32[D, bits]

    @staticmethod
    def create(dim: int, bits: int = 128, seed: int = 0, *,
               device=None) -> "RandomProjectionLSH":
        """A ``[dim, bits]`` standard-normal projection on ``device`` (by
        default the card, raising where there is none)."""
        if bits % 32:
            raise ValueError("bits must be a multiple of 32")
        device = bits_lib.entry_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return RandomProjectionLSH(projection=torch.randn(
            (dim, bits), generator=gen, dtype=torch.float32, device=device))

    @property
    def device(self) -> torch.device:
        return self.projection.device

    def encode(self, features) -> torch.Tensor:
        """``f32[B, D]`` -> packed ``int32[B, bits // 32]`` codes (uint32
        bit patterns), on the encoder's device."""
        with _fp32():
            proj = _features(features, self.device) @ self.projection
        return _pack_bits(proj >= 0)


class ITQEncoder(NamedTuple):
    """codes = pack(sign((X - mean) @ W @ R))."""

    mean: torch.Tensor  # f32[D]
    w: torch.Tensor     # f32[D, bits]: the top PCA directions
    r: torch.Tensor     # f32[bits, bits]: the learned rotation

    @staticmethod
    def fit(features, bits: int = 128, n_iters: int = 50, seed: int = 0, *,
            device=None) -> "ITQEncoder":
        """Train on a feature sample (a few 10k rows is plenty), on
        ``device``: by default that of a feature tensor, else the card."""
        if bits % 32:
            raise ValueError("bits must be a multiple of 32")
        device = bits_lib.entry_device(device, features)
        x = _features(features, device)
        n, d = x.shape
        if d < bits:
            raise ValueError(f"need feature dim >= bits ({d} < {bits})")
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        with _fp32():
            mean = x.mean(dim=0)
            xc = x - mean
            cov = (xc.T @ xc) / max(n - 1, 1)
            _, eigvec = torch.linalg.eigh(cov)             # ascending
            w = eigvec[:, -bits:].flip(-1).contiguous()    # top-bits PCs
            v = xc @ w                                     # [n, bits]
            r = torch.linalg.qr(torch.randn(
                (bits, bits), generator=gen, dtype=torch.float32,
                device=device))[0]
            for _ in range(n_iters):
                z = v @ r
                b = torch.sign(z) + (z == 0).to(z.dtype)   # +-1
                # Procrustes: R = S @ S_hat^T from the SVD of B^T V
                u, _s, vt = torch.linalg.svd(b.T @ v, full_matrices=False)
                r = (u @ vt).T.contiguous()
        return ITQEncoder(mean=mean, w=w, r=r)

    @property
    def device(self) -> torch.device:
        return self.mean.device

    def encode(self, features) -> torch.Tensor:
        """``f32[B, D]`` -> packed ``int32[B, bits // 32]`` codes (uint32
        bit patterns), on the encoder's device."""
        with _fp32():
            z = (_features(features, self.device) - self.mean) @ self.w @ self.r
        return _pack_bits(z >= 0)


Encoder = Union[RandomProjectionLSH, ITQEncoder]


def encode_corpus(encoder: Encoder, features, batch: int = 65536):
    """Stream a big feature matrix through the encoder, ``batch`` rows at a
    time. A numpy matrix gives numpy ``uint32`` codes, as the reference's
    does; a tensor gives an ``int32`` code tensor on the encoder's
    device."""
    as_numpy = not isinstance(features, torch.Tensor)
    n = features.shape[0]
    # an empty matrix still encodes to ``bits // 32`` columns
    parts = [encoder.encode(features[lo:lo + batch])
             for lo in range(0, max(n, 1), batch)]
    out = torch.cat(parts)
    return bits_lib.to_u32(out) if as_numpy else out


def write_code_file(path: str, packed) -> None:
    """Write codes (numpy uint32 or an int32 tensor) in the reference's raw
    ``lsh.code`` layout: little-endian rows of ``4 * W`` bytes
    (``build_hash_tables.cc:42``'s fread contract). Read back with
    :func:`verticut_tpu_torch.codes.read_code_file`."""
    if isinstance(packed, torch.Tensor):
        packed = bits_lib.to_u32(packed)
    codes_lib.unpack_to_bytes(np.asarray(packed)).tofile(path)
