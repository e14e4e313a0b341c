"""The port's key-value store (``verticut_tpu_torch.kv``, the native store
of ``csrc/kv.cc``) against the JAX package's (``verticut_tpu.kv``,
``verticut_tpu.native``) on the CPU, on the same inputs.

Held with tolerance 0: the integrity hashes (and the Python models of
``tests/test_native.py``), the DHT's ``stats()`` after the same operation
sequence, ``ShardedKV``'s placement, the bytes of ``BucketStore`` values
and of ``OpLogKV`` logs (each package's log replays into the other's
store), the streaming bucket build against the port's hash-directory
build, and either package's RESP client against the other's server.
"""

import ctypes
import os
import socketserver
import threading
import time

import numpy as np
import pytest
import torch

from verticut_tpu import kv as jkv
from verticut_tpu import native as jnative
from test_native import _crc64_py, _murmur64_py

from verticut_tpu_torch import codes
from verticut_tpu_torch.bits import as_codes
from verticut_tpu_torch.config import MIHConfig
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.kernels import _build
from verticut_tpu_torch import kv
from verticut_tpu_torch.kv import native

SEEDS = (0x199999999999997F, 0x1999999999999990, 0x01000193, 0x0100019D)


# --------------------------------------------------------------------------
# the native layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("payload", [b"", b"a", b"hello world",
                                     bytes(range(256)), b"x" * 1000])
def test_crc64_matches_jax_and_model(payload):
    assert native.crc64(payload) == jnative.crc64(payload) == \
        _crc64_py(payload)


@pytest.mark.parametrize("payload", [b"", b"k", b"0123456", b"01234567",
                                     b"012345678", bytes(range(100))])
def test_murmur64_matches_jax_and_model(payload):
    for seed in (0, 0x199999999999997F, 0x01000193):
        assert native.murmur64(payload, seed) == \
            jnative.murmur64(payload, seed) == _murmur64_py(payload, seed)


@pytest.mark.parametrize("key", [b"bucket-key", b"", b"key-12345",
                                 bytes(range(40))])
def test_hash_n_uses_reference_seeds(key):
    for n, s in enumerate(SEEDS):
        assert native.hash_n(key, n) == jnative.hash_n(key, n) == \
            native.murmur64(key, s)


def test_dht_basic_roundtrip():
    d = native.NativeDHT(n_slots=16)
    d.put(b"k1", b"v1")
    d.put(b"k2", b"value-two")
    assert d.get(b"k1") == b"v1"
    assert d.get(b"k2") == b"value-two"
    assert d.get(b"nope") is None
    assert d.contains(b"k1") and not d.contains(b"k3")
    d.put(b"k1", b"replaced-with-a-longer-value")
    assert d.get(b"k1") == b"replaced-with-a-longer-value"
    assert len(d) == 2
    assert d.remove(b"k1")
    assert not d.contains(b"k1") and len(d) == 1
    assert not d.remove(b"k1")
    d.close()


def test_dht_value_past_the_get_buffer():
    """A value longer than a get's first buffer is read at its length
    (both packages count the second get)."""
    big = bytes(range(256)) * 300
    stats = []
    for mod in (native, jnative):
        d = mod.NativeDHT(n_slots=16, arena_bytes=1 << 18)
        d.put(b"big", big)
        assert d.get(b"big") == big and d.get(b"small") is None
        stats.append(d.stats())
        d.close()
    assert stats[0] == stats[1] and stats[0]["gets"] == 3


def _stress(mod):
    rng = np.random.default_rng(0)
    d = mod.NativeDHT(n_slots=8, arena_bytes=4096)  # force many resizes
    model, trace = {}, []
    for _ in range(3000):
        k = rng.integers(0, 800)
        key = f"key-{k}".encode()
        op = rng.random()
        if op < 0.6:
            val = rng.bytes(int(rng.integers(1, 200)))
            d.put(key, val)
            model[key] = val
        elif op < 0.8 and model:
            got = d.get(key)
            assert got == model.get(key)
            trace.append(got)
        else:
            removed = d.remove(key)
            assert removed == (key in model)
            model.pop(key, None)
            trace.append(removed)
    assert len(d) == len(model)
    for key, val in model.items():
        assert d.get(key) == val
    out = (d.stats(), d.capacity, len(d), trace)
    d.close()
    return out


def test_dht_stress_with_resize_matches_jax():
    """The resize stress of ``tests/test_native.py``: the same sequence
    gives the same answers, capacity and ``stats()`` in both packages."""
    port, jax = _stress(native), _stress(jnative)
    assert port[0]["resizes"] >= 1 and port[0]["crc_failures"] == 0
    assert port == jax


def test_dht_concurrent_readers_see_no_torn_values():
    """A writer mutating values while reader threads get(): a racing read
    returns a whole (old or new) value or fails its CRC check, never bytes
    of two values (``Pilaf/dht.h:637-674``). Update-only churn of
    fixed-size values, so the table never resizes (the single-writer
    contract)."""
    lib = native.lib()
    n_keys, vlen = 64, 96
    h = lib.vt_dht_create(1024, 1 << 22)
    keys = [f"key-{i:04d}".encode() for i in range(n_keys)]

    def val(i, gen):
        return bytes([(gen * 31 + i) % 251]) * vlen

    for i, k in enumerate(keys):
        assert lib.vt_dht_put(h, k, len(k), val(i, 0), vlen) == 0
    stop = threading.Event()
    torn, ok_reads = [], [0]

    def reader():
        buf = ctypes.create_string_buffer(vlen)
        while not stop.is_set():
            for i, k in enumerate(keys):
                if lib.vt_dht_get(h, k, len(k), buf, vlen) < 0:
                    continue               # the CRC protocol fired
                v = buf.raw[:vlen]
                if len(set(v)) != 1:
                    torn.append((i, v[:8]))
                else:
                    ok_reads[0] += 1

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    for gen in range(1, 400):
        for i, k in enumerate(keys):
            assert lib.vt_dht_put(h, k, len(k), val(i, gen), vlen) == 0
    stop.set()
    for t in threads:
        t.join()
    lib.vt_dht_destroy(h)
    assert not torn, torn[:5]
    assert ok_reads[0] > 1000


def test_build_rebuilds_when_an_included_header_is_newer(tmp_path,
                                                         monkeypatch):
    """``_build.build`` compares the library with the source and every
    ``csrc`` header it includes (``dht.h``, and ``integrity.h`` directly
    and through ``dht.h``): touching a header rebuilds, and a fresh
    library is left alone."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("kv.cc", "dht.h", "integrity.h"):
        (csrc / name).write_bytes(open(os.path.join(_build.CSRC, name),
                                       "rb").read())
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(out))
    assert sorted(os.path.basename(p) for p in _build.dependencies(
        _build.source("kv"))) == ["dht.h", "integrity.h", "kv.cc"]
    lib = _build.lib_path("kv")
    _build.build("kv")
    past = time.time() - 100
    os.utime(lib, (past, past))
    for name in ("kv.cc", "dht.h", "integrity.h"):
        os.utime(csrc / name, (past - 10, past - 10))
    _build.build("kv")
    assert os.path.getmtime(lib) == past           # up to date: kept
    os.utime(csrc / "integrity.h", (past + 10, past + 10))
    _build.build("kv")
    assert os.path.getmtime(lib) > past + 10       # rebuilt


# --------------------------------------------------------------------------
# the kv layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend,n_shards", [("memory", 1), ("dht", 1),
                                              ("memory", 4), ("dht", 3)])
def test_make_store_roundtrip(backend, n_shards):
    s = kv.make_store(backend, n_shards=n_shards)
    for i in range(200):
        s.put(f"k{i}".encode(), f"value-{i}".encode() * (i % 5 + 1))
    for i in range(200):
        assert s.get(f"k{i}".encode()) == f"value-{i}".encode() * (i % 5 + 1)
    assert s.contains(b"k7") and not s.contains(b"nope")
    assert s.remove(b"k7") and not s.contains(b"k7")
    if n_shards > 1:
        assert isinstance(s, kv.ShardedKV) and len(s.shards) == n_shards
    s.close()


def test_dht_store_stats_match_jax():
    """``make_store("dht")`` in both packages: the same puts, gets and
    removes give the same ``stats()``."""
    out = []
    for mod in (kv, jkv):
        s = mod.make_store("dht")
        for i in range(3000):
            s.put(f"key-{i % 1700}".encode(), b"v" * (i % 97 + 1))
            s.get(f"key-{(i * 7) % 2000}".encode())
            if i % 5 == 0:
                s.remove(f"key-{(i * 3) % 1700}".encode())
        out.append((s.stats(), len(s)))
        s.close()
    assert out[0] == out[1]


def test_sharded_kv_placement_matches_jax():
    keys = [f"key-{i}".encode() for i in range(400)] + [bytes(range(9))]
    port = kv.ShardedKV([kv.MemoryKV() for _ in range(4)])
    jax = jkv.ShardedKV([jkv.MemoryKV() for _ in range(4)])
    for k in keys:
        port.put(k, b"v")
        jax.put(k, b"v")
        assert port.shard_for(k) == jax.shard_for(k) == \
            native.hash_n(k, 3) % 4
    sizes = [len(m) for m in port.shards]
    assert sizes == [len(m) for m in jax.shards]
    assert sum(sizes) == len(keys) and min(sizes) > 40


def test_bucket_store_bytes_match_jax():
    rng = np.random.default_rng(3)
    port = kv.BucketStore(kv.MemoryKV(), code_bytes=16)
    jax = jkv.BucketStore(jkv.MemoryKV(), code_bytes=16)
    for _ in range(300):
        t, idx = int(rng.integers(0, 4)), int(rng.integers(0, 40))
        img, code = int(rng.integers(0, 1 << 32)), rng.bytes(16)
        port.append(t, idx, img, code)
        jax.append(t, idx, img, code)
    assert port.store._d == jax.store._d
    assert port.key(2, 12345) == jax.key(2, 12345)
    # either package reads the other's buckets
    cross = jkv.BucketStore(port.store, code_bytes=16)
    for t in range(4):
        for idx in range(40):
            assert port.bucket(t, idx) == cross.bucket(t, idx)
    assert port.bucket(9, 9) == []
    img, code = port.bucket(t, idx)[-1]
    assert port.contains_pair(t, idx, img, code)
    assert not port.contains_pair(t, idx, img ^ 1, code)


def _oplog_ops(store):
    for i in range(600):
        store.put(f"k{i % 250}".encode(), bytes([i % 256]) * (i % 37 + 1))
        if i % 7 == 0:
            store.remove(f"k{(i * 3) % 250}".encode())


def test_oplog_bytes_match_jax_and_replay_across(tmp_path):
    assert kv.OpLogKV.FLUSH_HIGH_WATER == jkv.OpLogKV.FLUSH_HIGH_WATER
    paths = {}
    for name, mod in (("port", kv), ("jax", jkv)):
        paths[name] = str(tmp_path / f"{name}.log")
        log = mod.OpLogKV(mod.MemoryKV(), paths[name])
        _oplog_ops(log)
        log.close()
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    want = kv.MemoryKV()
    _oplog_ops(want)
    into_jax, into_port = jkv.MemoryKV(), kv.MemoryKV()
    n1 = jkv.OpLogKV.replay(paths["port"], into_jax)
    n2 = kv.OpLogKV.replay(paths["jax"], into_port)
    assert n1 == n2 == 600 + 86
    assert into_jax._d == into_port._d == want._d


def test_oplog_flushes_at_the_high_water_mark(tmp_path):
    path = str(tmp_path / "hw.log")
    log = kv.OpLogKV(kv.MemoryKV(), path)
    val = b"x" * 1000
    i = 0
    while os.path.getsize(path) == 0:
        log.put(b"k%d" % i, val)
        i += 1
    assert os.path.getsize(path) >= kv.OpLogKV.FLUSH_HIGH_WATER
    log.close()
    assert kv.OpLogKV.replay(path, kv.MemoryKV()) == i


def _stream(bs, packed, raw, n_tables):
    """Append every (table, substring) -> (id, code) of the corpus in id
    order; returns the substrings (int32 bit patterns)."""
    subs = codes.all_substrings(as_codes(packed), n_tables).numpy()
    for img_id in range(packed.shape[0]):
        for t in range(n_tables):
            bs.append(t, int(subs[img_id, t]) & 0xFFFFFFFF, img_id,
                      raw[img_id].tobytes())
    return subs


def _check_buckets(bs, packed, subs, n):
    idx = build_index(packed, MIHConfig(), directory="hash", device="cpu")
    for t in range(4):
        starts, counts = idx.tables[t].directory.lookup(
            torch.from_numpy(np.ascontiguousarray(subs[:, t])))
        eids = idx.tables[t].entry_ids.numpy()
        for i in range(n):
            got = [p[0] for p in bs.bucket(t, int(subs[i, t]) & 0xFFFFFFFF)]
            s, c = int(starts[i]), int(counts[i])
            assert got == eids[s:s + c].tolist(), (t, i)


def test_streaming_kv_build_matches_hash_build():
    """The reference's streaming build (``build_hash_tables.cc``): every
    (table, substring) -> (id, code) appended through the port's bucket
    store over its DHT equals the port's hash-directory build, bucket by
    bucket in CSR order."""
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, size=(150, 16), dtype=np.uint8)
    packed = codes.pack_bytes(raw)
    bs = kv.BucketStore(kv.make_store("dht"), code_bytes=16)
    subs = _stream(bs, packed, raw, 4)
    # the JAX package's stream over its own DHT: the same store work
    jbs = jkv.BucketStore(jkv.make_store("dht"), code_bytes=16)
    for i in range(150):
        for t in range(4):
            jbs.append(t, int(subs[i, t]) & 0xFFFFFFFF, i, raw[i].tobytes())
    assert bs.store.stats() == jbs.store.stats()
    _check_buckets(bs, packed, subs, 150)
    for i in range(150):
        for t in range(4):
            k = bs.key(t, int(subs[i, t]) & 0xFFFFFFFF)
            assert bs.store.get(k) == jbs.store.get(k)


@pytest.mark.parametrize("server,client", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_kvserver_redis_roundtrip_across_packages(server, client):
    smod = kv if server == "port" else jkv
    cmod = kv if client == "port" else jkv
    srv = smod.KVServer(store=smod.make_store("dht")).start()
    try:
        cli = cmod.make_store("redis", port=srv.port)
        assert cli.ping()
        assert cli.get(b"missing") is None
        cli.put(b"k1", b"v1")
        cli.put(b"\x00bin\xff", bytes(range(256)))
        assert cli.get(b"k1") == b"v1"
        assert cli.get(b"\x00bin\xff") == bytes(range(256))
        assert cli.contains(b"k1")
        assert cli.remove(b"k1")
        assert not cli.contains(b"k1") and not cli.remove(b"k1")
        cli2 = cmod.RedisKV(port=srv.port)
        assert cli2.get(b"\x00bin\xff") == bytes(range(256))
        cli.close()
        cli2.close()
    finally:
        srv.stop()


def test_kvserver_listen_backlog():
    srv = kv.KVServer(store=kv.MemoryKV())
    try:
        assert srv._srv.request_queue_size == 128
    finally:
        srv._srv.server_close()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_kvserver_streaming_bucket_build(server):
    """The streaming build through a network store: the port's bucket
    store over its RESP client over either package's DHT server."""
    smod = kv if server == "port" else jkv
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, size=(80, 16), dtype=np.uint8)
    packed = codes.pack_bytes(raw)
    srv = smod.KVServer(store=smod.make_store("dht")).start()
    try:
        bs = kv.BucketStore(kv.RedisKV(port=srv.port), code_bytes=16)
        subs = _stream(bs, packed, raw, 4)
        _check_buckets(bs, packed, subs, 80)
        bs.store.close()
    finally:
        srv.stop()


class _FakeMemcachedHandler(socketserver.StreamRequestHandler):
    """Text-protocol-faithful in-test memcached (the port's copy of the
    one in ``tests/test_kv_remote.py``)."""

    def handle(self):
        d = self.server.data  # type: ignore[attr-defined]
        while True:
            line = self.rfile.readline()
            if not line:
                return
            parts = line.split()
            if parts[0] == b"set":
                n = int(parts[4])
                val = self.rfile.read(n + 2)[:n]
                d[parts[1]] = val
                self.wfile.write(b"STORED\r\n")
            elif parts[0] == b"get":
                v = d.get(parts[1])
                if v is not None:
                    self.wfile.write(b"VALUE %s 0 %d\r\n%s\r\n"
                                     % (parts[1], len(v), v))
                self.wfile.write(b"END\r\n")
            elif parts[0] == b"delete":
                ok = d.pop(parts[1], None) is not None
                self.wfile.write(b"DELETED\r\n" if ok
                                 else b"NOT_FOUND\r\n")
            else:
                self.wfile.write(b"ERROR\r\n")
            self.wfile.flush()


def test_memcached_connector():
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0),
                                          _FakeMemcachedHandler)
    srv.data = {}  # type: ignore[attr-defined]
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        cli = kv.make_store("memcached", port=srv.server_address[1])
        assert cli.get(b"nope") is None
        cli.put(b"\x01raw", b"hello\r\nworld")
        assert cli.get(b"\x01raw") == b"hello\r\nworld"
        assert cli.contains(b"\x01raw")
        assert cli.remove(b"\x01raw")
        assert cli.get(b"\x01raw") is None
        # the JAX client writes the same keys (hex) and reads the port's
        cli.put(b"shared", b"v")
        jcli = jkv.make_store("memcached", port=srv.server_address[1])
        assert jcli.get(b"shared") == b"v"
        assert set(srv.data) == {b"shared".hex().encode()}
        cli.close()
        jcli.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_make_store_redis_requires_server():
    """No silent dict fallback: connecting nowhere must raise."""
    with pytest.raises(OSError):
        kv.make_store("redis", port=1, timeout=0.2)
    with pytest.raises(ValueError, match="unknown backend"):
        kv.make_store("nope")
