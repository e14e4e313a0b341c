"""The port's RPC service (verticut_tpu_torch.service) on a CPU index: the
server cases of tests/test_kv_service.py, each answer held to the port's
mih_search on the same rows; the JAX server and the port's server give
equal answers, list for list, to the same sequential requests; and the
two command-line twins (tools.image_server, tools.image_search_test) run.
Every client has a 30 s timeout and every join a limit, so a hang fails
one test."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from verticut_tpu import codes as jcodes
from verticut_tpu.config import MIHConfig as JMIHConfig
from verticut_tpu.index import build_index as jax_build_index
from verticut_tpu_torch.config import MIHConfig, SearchConfig
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.search import mih_search
from verticut_tpu_torch.service import (ImageSearchClient, ImageSearchServer,
                                        ReplicatedSearchClient)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 30


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n, 16), dtype=np.uint8)
    packed = jcodes.pack_bytes(raw)
    return raw, packed, build_index(packed, MIHConfig(), device="cpu")


def _want(index, q, k):
    """The port's mih_search on rows ``q``, as the RPC returns it."""
    r = mih_search(index, q, SearchConfig(knn=k))
    return [[[i, d] for i, d in zip(ids, ds) if i >= 0]
            for ids, ds in zip(r.ids.tolist(), r.dists.tolist())]


def _join(ts):
    for t in ts:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in ts), "a client hung"


def test_rpc_service_roundtrip():
    raw, packed, idx = _corpus(5, 300)
    srv = ImageSearchServer(idx, port=0).start()
    try:
        cli = ImageSearchClient(port=srv.port, pool=4, timeout=TIMEOUT)
        assert cli.ping() == "pong"

        res = cli.search_image_by_id(5, 3)
        assert res[0] == [5, 0] and res == _want(idx, packed[5:6], 3)[0]

        res2 = cli.search_by_code(raw[7].tobytes(), 3)
        assert res2[0] == [7, 0] and res2 == _want(idx, packed[7:8], 3)[0]

        batch = cli.search_batch(raw[:4].tobytes(), 2)
        assert batch == _want(idx, packed[:4], 2)
        assert [b[0] for b in batch] == [[qi, 0] for qi in range(4)]

        # concurrent clients (image_search_test.cc pthread mode)
        errs, got = [], {}

        def worker(i):
            try:
                got[i] = cli.search_image_by_id(i, 2)
            except Exception as e:  # noqa: BLE001
                errs.append(e)
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        [t.start() for t in ts]
        _join(ts)
        assert not errs
        assert [got[i] for i in range(8)] == _want(idx, packed[:8], 2)

        with pytest.raises(RuntimeError, match="outside"):
            cli.search_image_by_id(300, 2)
        st = cli.stats()
        assert st["n_codes"] == 300 and st["n_requests"] >= 14
        assert st["timings"]["rpc.search_image_by_id"]["count"] >= 10
        cli.close()
    finally:
        srv.stop()


def test_client_reconnects_after_server_restart():
    _, packed, idx = _corpus(8, 100)
    srv = ImageSearchServer(idx, port=0).start()
    port = srv.port
    cli = ImageSearchClient(port=port, pool=1, timeout=TIMEOUT)
    assert cli.ping() == "pong"
    assert cli.stats()["epoch"] == 1
    srv.stop()
    srv2 = ImageSearchServer(idx, port=port)
    srv2.epoch = srv.epoch  # same logical server instance, bounced
    srv2.start()
    try:
        # pooled socket is dead; call() must reconnect and retry
        assert cli.ping() == "pong"
        assert cli.stats()["epoch"] == 2
        assert cli.search_image_by_id(3, 2) == _want(idx, packed[3:4], 2)[0]
    finally:
        cli.close()
        srv2.stop()


def test_replicated_client_failover():
    _, packed, idx = _corpus(2, 100)
    s1 = ImageSearchServer(idx, port=0).start()
    s2 = ImageSearchServer(idx, port=0).start()
    cli = ReplicatedSearchClient([("127.0.0.1", s1.port),
                                  ("127.0.0.1", s2.port)], pool=1,
                                 timeout=TIMEOUT)
    try:
        assert cli.ping() == "pong"
        s1.stop()  # one replica dies; calls must fail over to s2
        want = _want(idx, packed[:4], 2)
        for i in range(4):
            assert cli.search_image_by_id(i, 2) == want[i]
        assert s2.n_requests >= 1
    finally:
        cli.close()
        s2.stop()


def test_server_microbatching_coalesces():
    """Concurrent same-(k, approx) requests share device launches."""
    _, packed, idx = _corpus(9, 400)
    srv = ImageSearchServer(idx, port=0).start()
    try:
        cli = ImageSearchClient(port=srv.port, pool=16, timeout=TIMEOUT)
        cli.search_image_by_id(0, 3)
        errs, results = [], {}

        def worker(i):
            try:
                results[i] = cli.search_image_by_id(i, 3)
            except Exception as e:  # noqa: BLE001
                errs.append(e)
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        [t.start() for t in ts]
        _join(ts)
        assert not errs
        assert [results[i] for i in range(16)] == _want(idx, packed[:16], 3)
        st = cli.stats()
        assert st["n_requests"] == 17
        assert st["n_batches"] < 17, st  # at least some coalescing happened
        cli.close()
    finally:
        srv.stop()


def test_service_soak_throughput_scales_with_depth():
    """Threaded load (the reference's mocks: a constant 20 ms device batch
    through _dispatch_device / _finalize): aggregate QPS with 16 in-flight
    clients beats sequential QPS, and p50 stays bounded."""
    _, _, idx = _corpus(21, 600)
    srv = ImageSearchServer(idx, port=0).start()

    class _Res:
        def __init__(self, n, k=3):
            self.ids = np.tile(np.arange(k, dtype=np.int64), (n, 1))
            self.dists = np.zeros((n, k), np.int64)

    def fake_dispatch(key, batch):
        queries, sizes = srv._pad_batch(batch)
        return (("fake", queries), None, sizes)

    def fake_finalize(key, batch, handle, _qn, sizes):
        time.sleep(0.02)                      # constant device batch time
        srv._distribute(batch, sizes, _Res(sum(sizes)))

    srv._dispatch_device = fake_dispatch
    srv._finalize = fake_finalize
    try:
        cli = ImageSearchClient(port=srv.port, pool=20, timeout=TIMEOUT)
        n_seq, n_con = 24, 96

        t0 = time.time()
        for i in range(n_seq):
            cli.search_image_by_id(i % 500, 3)
        seq_qps = n_seq / (time.time() - t0)

        lat, errs = [], []
        lock = threading.Lock()

        def worker(base):
            try:
                for i in range(6):
                    t1 = time.time()
                    r = cli.search_image_by_id((base * 6 + i) % 500, 3)
                    dt = time.time() - t1
                    assert r[0][1] == 0
                    with lock:
                        lat.append(dt)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        t0 = time.time()
        ts = [threading.Thread(target=worker, args=(b,)) for b in range(16)]
        [t.start() for t in ts]
        _join(ts)
        con_qps = n_con / (time.time() - t0)
        assert not errs
        assert len(lat) == n_con
        lat.sort()
        assert con_qps > 1.5 * seq_qps, (con_qps, seq_qps)
        assert lat[len(lat) // 2] < 0.5, lat[len(lat) // 2]
        st = cli.stats()
        assert st["n_batches"] < st["n_requests"]
        cli.close()
    finally:
        srv.stop()


def test_service_leader_error_unblocks_waiters():
    """A failing device batch surfaces as an RPC error on every affected
    request, never a hung waiter."""
    _, _, idx = _corpus(23, 200)
    srv = ImageSearchServer(idx, port=0).start()
    try:
        cli = ImageSearchClient(port=srv.port, pool=8, timeout=TIMEOUT)
        cli.search_image_by_id(0, 3)

        def boom(*a, **k):
            raise RuntimeError("injected device failure")
        srv._dispatch_device = boom

        results = []

        def worker(i):
            try:
                cli.search_image_by_id(i, 3)
                results.append("ok")
            except Exception:  # noqa: BLE001
                results.append("err")
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        [t.start() for t in ts]
        _join(ts)
        assert results == ["err"] * 6
    finally:
        srv.stop()


def test_server_prewarm_compiles_buckets():
    """prewarm runs every power-of-two bucket through the worker and
    leaves the server serving correctly."""
    _, packed, idx = _corpus(11, 400)
    srv = ImageSearchServer(idx, port=0).start()
    try:
        srv.prewarm(max_rows=32)
        assert srv.n_batches >= 3  # buckets 8, 16, 32
        cli = ImageSearchClient(port=srv.port, pool=2, timeout=TIMEOUT)
        res = cli.search_image_by_id(9, 3)
        assert res[0] == [9, 0] and res == _want(idx, packed[9:10], 3)[0]
        cli.close()
    finally:
        srv.stop()


def test_pad_batch_mixes_id_rows_and_code_rows():
    """A batch of id rows is gathered on the index's device; a batch that
    mixes id rows and code rows reads the id rows' codes; both pad to a
    power of two of at least 8 with copies of the first row. A sharded
    server declines the dispatch (its batches take the sync path) and
    carries a mixed batch as codes and ids, for its followers, padded
    alike."""
    _, packed, idx = _corpus(3, 100)
    srv = ImageSearchServer(idx, port=0)
    try:
        ev = threading.Event()
        ids = [([np.array([4, 9]), None], ev), ([np.array([1]), None], ev)]
        q, sizes = srv._pad_batch(ids)
        assert sizes == [2, 1]
        assert np.array_equal(q.numpy().view(np.uint32),
                              packed[[4, 9, 1] + [4] * 5])
        mixed = [([packed[7:8], None], ev), ([np.array([2, 3]), None], ev)]
        q, sizes = srv._pad_batch(mixed)
        assert sizes == [1, 2]
        assert np.array_equal(q, packed[[7, 2, 3] + [7] * 5])
        sharded = SimpleNamespace(cfg=idx.cfg, n=idx.n, codes=idx.codes,
                                  mesh=SimpleNamespace(
                                      device=idx.device,
                                      shape={"table": 1, "shard": 1,
                                             "query": 1}))
        ssrv = ImageSearchServer(sharded, port=0, sharded=True)
        try:
            assert ssrv._dispatch_device((10, False), mixed) is None
            codes, ids, sizes = ssrv._sharded_batch(mixed)
            assert sizes == [1, 2]
            want = np.zeros((8, 4), np.uint32)
            want[[0] + list(range(3, 8))] = packed[7]
            assert np.array_equal(codes.numpy().view(np.uint32), want)
            assert ids.tolist() == [-1, 2, 3] + [-1] * 5
        finally:
            ssrv._srv.server_close()
    finally:
        srv._srv.server_close()


def test_sequential_answers_equal_the_jax_server():
    """The same sequential requests (each its own batch, so the batch
    composition is the same on both sides) to the JAX server and to the
    port's server on the same codes: equal answers, list for list."""
    from verticut_tpu.service import ImageSearchServer as JaxServer
    raw, packed, idx = _corpus(31, 500)
    jsrv = JaxServer(jax_build_index(packed, JMIHConfig()), port=0).start()
    srv = ImageSearchServer(idx, port=0).start()
    clis = [ImageSearchClient(port=s.port, pool=1, timeout=TIMEOUT)
            for s in (jsrv, srv)]
    try:
        def ask(cli):
            return ([cli.search_image_by_id(i, 5) for i in (0, 17, 499)]
                    + [cli.search_by_code(raw[i].tobytes(), 10)
                       for i in (3, 250)]
                    + [cli.search_by_code(bytes(16), 4),
                       cli.search_batch(raw[40:52].tobytes(), 7),
                       cli.search_batch(raw[:3].tobytes(), 1)])
        got, want = ask(clis[1]), ask(clis[0])
        assert got == want
        assert got[0] == _want(idx, packed[:1], 5)[0]
    finally:
        for c in clis:
            c.close()
        jsrv.stop()
        srv.stop()


def test_image_search_test_selfbuild_on_cpu():
    """The load generator twin, self-contained on the CPU: one JSON line
    with the reference's fields; the device names the CPU."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "verticut_tpu_torch.tools.image_search_test",
         "--selfbuild", "3000", "--device", "cpu", "-n", "16"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "serving_rpc" and rec["n_codes"] == 3000
    assert rec["device"] == "cpu" and rec["nvidia_smi"] is None
    for row in ("sequential", "threads16", "threads64"):
        assert rec[row]["qps"] > 0
        assert set(rec[row]["latency_ms"]) == {"50", "90", "99"}


def test_image_server_serves_a_jax_index_file(tmp_path):
    """The server twin loads an index file written by the JAX package and
    serves it until SIGTERM."""
    from verticut_tpu.index.mih import save_index as jax_save_index
    _, packed, idx = _corpus(13, 400)
    path = str(tmp_path / "idx.npz")
    jax_save_index(path, jax_build_index(packed, JMIHConfig()))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "verticut_tpu_torch.tools.image_server",
         "--index", path, "--device", "cpu", "--ip", "127.0.0.1", "-p", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving 400 codes on 127.0.0.1:"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        cli = ImageSearchClient(port=int(line.rsplit(":", 1)[1]), pool=1,
                                timeout=TIMEOUT)
        assert cli.ping() == "pong"
        assert cli.search_image_by_id(8, 4) == _want(idx, packed[8:9], 4)[0]
        cli.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)
        proc.stdout.close()
        proc.stderr.close()
