"""ctypes bindings of the host key-value store (``csrc/kv.cc``): the
cuckoo-hash DHT (the Pilaf store-server/DHT analog) and the integrity
primitives, CRC64 and Murmur64A under the reference's seeds.

The port's copy of the store half of the JAX package's
``verticut_tpu/native`` (``NativeDHT``, ``crc64``, ``murmur64``,
``hash_n``), with the same names. ``csrc/dht.h`` and ``csrc/integrity.h``
are verbatim copies of the JAX package's sources, so placement, stats and
hashes are the same bit for bit. The library is compiled with the host
C++ compiler by :mod:`verticut_tpu_torch.kernels._build` at first use, and
a build that fails raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

NAME = "kv"

_u64, _i64, _u32, _i32 = (ctypes.c_uint64, ctypes.c_int64, ctypes.c_uint32,
                          ctypes.c_int32)
_vp = ctypes.c_void_p

#: entry -> ctypes argument types
ENTRIES = {
    "vt_dht_create": (_u64, _u64),
    "vt_dht_destroy": (_vp,),
    "vt_dht_put": (_vp, _vp, _u32, _vp, _u32),
    "vt_dht_get": (_vp, _vp, _u32, _vp, _u64),
    "vt_dht_contains": (_vp, _vp, _u32),
    "vt_dht_remove": (_vp, _vp, _u32),
    "vt_dht_count": (_vp,),
    "vt_dht_capacity": (_vp,),
    "vt_dht_stats": (_vp, _vp),
    "vt_crc64": (_vp, _u64),
    "vt_murmur64": (_vp, _u64, _u64),
    "vt_hash_n": (_vp, _u64, _i32),
}
#: entry -> return type, where it is not ``int``: a pointer cut to 32 bits
#: would crash the first put
RESTYPES = {
    "vt_dht_create": _vp,
    "vt_dht_destroy": None,
    "vt_dht_get": _i64,
    "vt_dht_count": _u64,
    "vt_dht_capacity": _u64,
    "vt_dht_stats": None,
    "vt_crc64": _u64,
    "vt_murmur64": _u64,
    "vt_hash_n": _u64,
}
STATS = ("puts", "gets", "removes", "probes", "kicks", "resizes",
         "crc_failures")
#: a get's first buffer; a longer value is read again at its length (the
#: store counts both gets)
GET_CAP = 1 << 16


def lib() -> ctypes.CDLL:
    """The store's library, built if needed and loaded once per process."""
    from verticut_tpu_torch.kernels import _build
    return _build.load(NAME, ENTRIES, RESTYPES)


def crc64(data: bytes) -> int:
    return int(lib().vt_crc64(ctypes.c_char_p(data), len(data)))


def murmur64(data: bytes, seed: int) -> int:
    return int(lib().vt_murmur64(ctypes.c_char_p(data), len(data),
                                 ctypes.c_uint64(seed)))


def hash_n(data: bytes, n: int) -> int:
    """Murmur64A under the reference's seed ``n``: 0-2 place a key in the
    cuckoo table, 3 picks its server shard."""
    return int(lib().vt_hash_n(ctypes.c_char_p(data), len(data), n))


class NativeDHT:
    """Host cuckoo-hash KV store (the Pilaf store-server/DHT analog).
    Single writer; readers on other threads see a whole value or none
    (the CRC protocol of ``csrc/dht.h``)."""

    def __init__(self, n_slots: int = 1024, arena_bytes: int = 1 << 20):
        self._L = lib()
        self._h = self._L.vt_dht_create(n_slots, arena_bytes)
        # one get buffer per reading thread, reused across its gets
        self._bufs = threading.local()

    def put(self, key: bytes, value: bytes) -> None:
        rc = self._L.vt_dht_put(self._h, ctypes.c_char_p(key), len(key),
                                ctypes.c_char_p(value), len(value))
        if rc != 0:
            raise RuntimeError(f"dht put failed: {rc}")

    def get(self, key: bytes):
        buf = getattr(self._bufs, "buf", None)
        if buf is None:
            buf = self._bufs.buf = ctypes.create_string_buffer(GET_CAP)
        while True:
            n = self._L.vt_dht_get(self._h, ctypes.c_char_p(key), len(key),
                                   buf, len(buf))
            if n < 0:
                return None
            if n <= len(buf):
                return ctypes.string_at(buf, n)
            buf = ctypes.create_string_buffer(int(n))

    def contains(self, key: bytes) -> bool:
        return bool(self._L.vt_dht_contains(self._h, ctypes.c_char_p(key),
                                            len(key)))

    def remove(self, key: bytes) -> bool:
        return self._L.vt_dht_remove(self._h, ctypes.c_char_p(key),
                                     len(key)) == 0

    def __len__(self) -> int:
        return int(self._L.vt_dht_count(self._h))

    @property
    def capacity(self) -> int:
        return int(self._L.vt_dht_capacity(self._h))

    def stats(self) -> dict:
        out = np.zeros(len(STATS), np.uint64)
        self._L.vt_dht_stats(self._h, out.ctypes.data_as(ctypes.c_void_p))
        return dict(zip(STATS, out.tolist()))

    def close(self) -> None:
        if self._h:
            self._L.vt_dht_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
