"""Dataset file formats: the port's numpy copy of
``verticut_tpu/utils/io.py``.

* raw code files — the reference's ``lsh.code`` contract (fixed-width rows
  of ``binary_bits/8`` bytes, ``src/build_hash_tables.cc:42``); reader
  ``codes.read_code_file``, writer ``models.lsh.write_code_file``.
* TexMex/BIGANN vector formats (``.bvecs``/``.fvecs``/``.ivecs``): each row
  is ``int32 dim`` followed by ``dim`` values (uint8/float32/int32). The
  BIGANN corpora ship as bvecs; ground truth as ivecs.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_ITEM = {"bvecs": (np.uint8, 1), "fvecs": (np.float32, 4),
         "ivecs": (np.int32, 4)}


def _kind(path: str, kind: Optional[str]) -> str:
    k = kind or os.path.splitext(path)[1].lstrip(".")
    if k not in _ITEM:
        raise ValueError(f"unknown vector format {k!r} for {path}")
    return k


def read_vecs(path: str, kind: Optional[str] = None, max_rows: int = 0,
              offset_rows: int = 0) -> np.ndarray:
    """Read a .bvecs/.fvecs/.ivecs file (optionally a row range) -> [N, D]."""
    k = _kind(path, kind)
    dtype, isize = _ITEM[k]
    with open(path, "rb") as f:
        dim_raw = f.read(4)
        if len(dim_raw) < 4:
            return np.empty((0, 0), dtype)
        dim = int(np.frombuffer(dim_raw, np.int32)[0])
        row_bytes = 4 + dim * isize
        total = os.path.getsize(path) // row_bytes
        start = min(offset_rows, total)
        n = total - start if max_rows <= 0 else min(max_rows, total - start)
        f.seek(start * row_bytes)
        buf = np.frombuffer(f.read(n * row_bytes), np.uint8)
    rows = buf.reshape(n, row_bytes)
    dims = rows[:, :4].copy().view(np.int32).ravel()
    if not (dims == dim).all():
        raise ValueError(f"ragged rows in {path}")
    return rows[:, 4:].copy().view(dtype).reshape(n, dim)


def write_vecs(path: str, arr: np.ndarray, kind: Optional[str] = None
               ) -> None:
    """Write ``[N, D]`` rows in the format of ``path``'s extension (or
    ``kind``)."""
    k = _kind(path, kind)
    dtype, _ = _ITEM[k]
    arr = np.ascontiguousarray(arr, dtype)
    n, d = arr.shape
    dims = np.full((n, 1), d, np.int32)
    out = np.concatenate(
        [dims.view(np.uint8).reshape(n, 4),
         arr.view(np.uint8).reshape(n, -1)], axis=1)
    out.tofile(path)
