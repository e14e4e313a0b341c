"""msgpack-RPC query front-end — the ``image_search_server`` analog, on
the port's search engine.

The port's copy of ``verticut_tpu/service/server.py``: the same wire
protocol (standard msgpack-RPC over TCP, request ``[0, msgid, method,
params]`` / response ``[1, msgid, err, result]``, spoken by :mod:`.wire`),
the same methods, the same micro-batching worker and its depth-2
dispatch / finalize loop. Methods:

  * ``ping()                      -> "pong"``
  * ``search_image_by_id(id, k, approx) -> [[id, dist], ...]``
  * ``search_by_code(code_bytes, k, approx) -> [[id, dist], ...]``
  * ``search_batch(codes_bytes, k, approx) -> [[[id, dist], ...], ...]``
  * ``stats() -> {...}``

Where the port differs: the index lives on the card, so a
``search_image_by_id`` request carries its id to the worker, which
gathers a batch's id rows with one ``index_select`` on the device; a
batch's results are read back with one ``tolist`` each; ``prewarm``
builds the blockmin kernel (torch compiles no graphs) before its one batch
per bucket. ``sharded=True`` waits for the multi-device port.
"""

from __future__ import annotations

import queue
import socket
import socketserver
import threading
from typing import Optional

import numpy as np
import torch

from verticut_tpu_torch import bits as bits_lib
from verticut_tpu_torch import codes as codes_lib
from verticut_tpu_torch.config import DEFAULT_SERVER_PORT, SearchConfig
from verticut_tpu_torch.search import (mih_search, mih_search_dispatch,
                                       mih_search_finalize)
from verticut_tpu_torch.service import wire
from verticut_tpu_torch.utils.logging import get_logger
from verticut_tpu_torch.utils.timer import Timer, timings

log = get_logger("service")


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        unpacker = wire.Unpacker()
        sock = self.request
        self.server.owner._conns.add(sock)
        try:
            while True:
                data = sock.recv(1 << 16)
                if not data:
                    return
                unpacker.feed(data)
                for msg in unpacker:
                    self._dispatch(sock, msg)
        except OSError:
            return  # connection force-closed by stop()
        finally:
            self.server.owner._conns.discard(sock)

    def _dispatch(self, sock, msg):
        srv: "ImageSearchServer" = self.server.owner
        if not isinstance(msg, (list, tuple)) or len(msg) != 4 or msg[0] != 0:
            return  # ignore notifications/garbage
        _, msgid, method, params = msg
        try:
            with Timer(f"rpc.{method}"):
                result = srv.call(method, params)
            resp = [1, msgid, None, result]
        except Exception as e:  # noqa: BLE001 — errors go on the wire
            log.warning("rpc %s failed: %s", method, e)
            resp = [1, msgid, f"{type(e).__name__}: {e}", None]
        sock.sendall(wire.packb(resp))


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    # listen backlog: socketserver's 5 drops the SYNs of a burst of new
    # clients, which then wait a 1 s retransmit
    request_queue_size = 128


class ImageSearchServer:
    """Serves K-NN queries over a built single-device index."""

    def __init__(self, index, host: str = "127.0.0.1",
                 port: int = DEFAULT_SERVER_PORT,
                 default_knn: int = 10, sharded: bool = False):
        if sharded:
            raise NotImplementedError(
                "sharded=True waits for the multi-device port (ROADMAP.md "
                "Queue 1 item 3)")
        self.index = index
        self.default_knn = default_knn
        self._srv = _Server((host, port), _Handler)
        self._srv.owner = self
        self.port = self._srv.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self.n_requests = 0
        self.n_batches = 0
        # incremented on every (re)start: clients detect a bounced server
        self.epoch = 0
        self._conns: set = set()
        # micro-batching: ONE worker thread drains a FIFO of (key, slot,
        # event) work items, bounding every request's wait to at most
        # (in-flight batch + own batch) and capping the batch rows
        self._work: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._running = False
        #: admission control: max query rows per device batch. Requests
        #: beyond the cap stay queued for the next batch (FIFO).
        self.max_batch_rows = 2048

    # -- dispatch ------------------------------------------------------------

    def call(self, method: str, params):
        if method == "ping":
            return "pong"
        if method == "stats":
            return {"n_requests": self.n_requests,
                    "n_batches": self.n_batches, "n_codes": self.index.n,
                    "epoch": self.epoch, "timings": timings()}
        if method == "search_image_by_id":
            image_id, knn, approx = (list(params) + [self.default_knn, False]
                                     )[:3]
            if self.index.codes is None:
                raise ValueError("index holds no code array")
            if not 0 <= int(image_id) < self.index.n:
                raise IndexError(f"image id {image_id} outside "
                                 f"[0, {self.index.n})")
            # an id row: the worker gathers the code on the device
            q = np.array([int(image_id)], np.int64)
            return self._search(q, int(knn), bool(approx))[0]
        if method == "search_by_code":
            code, knn, approx = (list(params) + [self.default_knn, False])[:3]
            q = codes_lib.pack_bytes(np.frombuffer(code, np.uint8)[None])
            return self._search(q, int(knn), bool(approx))[0]
        if method == "search_batch":
            blob, knn, approx = (list(params) + [self.default_knn, False])[:3]
            nbytes = self.index.cfg.n_bytes
            raw = np.frombuffer(blob, np.uint8).reshape(-1, nbytes)
            return self._search(codes_lib.pack_bytes(raw), int(knn),
                                bool(approx))
        raise ValueError(f"unknown method {method!r}")

    def _search(self, queries: np.ndarray, knn: int, approx: bool):
        """Micro-batching: concurrent requests with the same (knn, approx)
        coalesce into one device launch. ``queries`` holds packed codes
        (uint32 [r, W]) or corpus ids (int64 [r]). Request threads only
        enqueue and block on their event; all device work happens on the
        worker thread."""
        if not self._running:
            self._start_worker()
        evt = threading.Event()
        slot = [queries, None]          # [input rows, output rows]
        key = (int(knn), bool(approx))
        self._work.put((key, slot, evt))
        evt.wait()
        if isinstance(slot[1], BaseException):
            raise RuntimeError(
                f"batch worker failed: {slot[1]}") from slot[1]
        return slot[1]

    # -- worker thread: batch assembly + depth-2 device pipeline -----------

    def _start_worker(self):
        with self._work.mutex:  # idempotent start (any thread may race)
            if self._running:
                return
            self._running = True
        self._worker = threading.Thread(target=self._worker_loop,
                                        daemon=True, name="search-worker")
        self._worker.start()

    def _take_batch(self, first):
        """FIFO drain of same-key items up to the row cap; items of other
        keys (or beyond the cap) are requeued in arrival order."""
        key = first[0]
        batch = [first[1:]]
        rows = first[1][0].shape[0]
        requeue = []
        while rows < self.max_batch_rows:
            try:
                item = self._work.get_nowait()
            except queue.Empty:
                break
            if item is None:
                requeue.append(item)  # keep the stop sentinel observable
                break
            if item[0] != key:
                requeue.append(item)
                continue
            batch.append(item[1:])
            rows += item[1][0].shape[0]
        for item in requeue:
            self._work.put(item)
        return key, batch

    def _worker_loop(self):
        # Up to TWO device batches in flight: dispatch the next before
        # finalizing the previous, so the next batch's pipeline runs on
        # its dispatch worker while this thread waits for the previous one
        inflight = None  # (key, batch, handle, queries_or_none, sizes)
        while True:
            try:
                timeout = 0.0005 if inflight is not None else None
                try:
                    item = self._work.get(timeout=timeout)
                except queue.Empty:
                    item = False  # nothing queued: drain the in-flight batch
                if item is None:  # stop sentinel
                    if inflight is not None:
                        self._safe_finalize(inflight)
                    return
                if item is False:
                    self._safe_finalize(inflight)
                    inflight = None
                    continue
                key, batch = self._take_batch(item)
                prev, inflight = inflight, None
                try:
                    dispatched = self._dispatch_device(key, batch)
                except Exception as e:  # noqa: BLE001 — to the waiters
                    self._deliver_error(batch, e)
                    dispatched = None
                if prev is not None:
                    self._safe_finalize(prev)
                if dispatched is not None:
                    inflight = (key, batch) + dispatched
            except Exception:  # noqa: BLE001 — worker must survive
                log.exception("search worker iteration failed")

    def _safe_finalize(self, inflight):
        if inflight is None:
            return
        key, batch = inflight[0], inflight[1]
        try:
            self._finalize(key, *inflight[1:])
        except Exception as e:  # noqa: BLE001 — to the waiters
            self._deliver_error(batch, e)

    @staticmethod
    def _deliver_error(batch, e):
        for slot, ev in batch:
            if not ev.is_set():
                slot[1] = e
                ev.set()

    def _pad_batch(self, batch):
        """The batch's query rows, padded with copies of its first row to
        a power of two of at least 8 (the stage budgets, and so the stats,
        depend on the batch size), and each request's row count. A batch
        of id rows only is gathered from the index's codes on the device
        in one ``index_select``; otherwise the rows are host codes, an id
        row read from the device."""
        qs = [slot[0] for slot, _ in batch]
        sizes = [q.shape[0] for q in qs]
        nq = sum(sizes)
        self.n_requests += nq
        self.n_batches += 1
        n_pad = max(8, 1 << (nq - 1).bit_length()) - nq
        dev = self.index.device
        if all(q.ndim == 1 for q in qs):
            ids = np.concatenate(qs + [np.repeat(qs[0][:1], n_pad)])
            return self.index.codes.index_select(
                0, torch.from_numpy(ids).to(dev)), sizes
        queries = np.concatenate([
            q if q.ndim == 2 else bits_lib.to_u32(
                self.index.codes[torch.from_numpy(q).to(dev)])
            for q in qs])
        if n_pad:
            queries = np.concatenate(
                [queries, np.repeat(queries[:1], n_pad, axis=0)])
        return queries, sizes

    def _dispatch_device(self, key, batch):
        """Launch without waiting."""
        knn, approx = key
        queries, sizes = self._pad_batch(batch)
        h = mih_search_dispatch(self.index, queries,
                                SearchConfig(knn=knn, approximate=approx))
        if h is None:  # fused driver declined: run it at finalize
            return ("sync", queries, sizes)
        return (h, None, sizes)

    def _finalize(self, key, batch, handle, queries_or_none, sizes):
        knn, approx = key
        if handle == "sync":
            res = mih_search(self.index, queries_or_none,
                             SearchConfig(knn=knn, approximate=approx))
        else:
            res = mih_search_finalize(handle)
        self._distribute(batch, sizes, res)

    def _distribute(self, batch, sizes, res):
        ids, dists = res.ids.tolist(), res.dists.tolist()
        lo = 0
        for (slot, evt), sz in zip(batch, sizes):
            slot[1] = [[[i, d] for i, d in zip(ids[qi], dists[qi]) if i >= 0]
                       for qi in range(lo, lo + sz)]
            evt.set()
            lo += sz

    def prewarm(self, knn: Optional[int] = None, approx: bool = False,
                max_rows: Optional[int] = None):
        """Run every power-of-two batch-shape bucket up to ``max_rows``
        once through the worker, after building the blockmin kernel on a
        CUDA index (nvcc, seconds; a failed build raises): a first use under
        load would stall the single worker with every queued request
        behind it."""
        knn = self.default_knn if knn is None else knn
        max_rows = self.max_batch_rows if max_rows is None else max_rows
        if self.index.codes is None:
            raise ValueError("index holds no code array")
        if self.index.device.type == "cuda":
            from verticut_tpu_torch.kernels import blockmin
            blockmin.build()
        b = 8
        while b <= max_rows:
            self._search(np.zeros(b, np.int64), knn, approx)
            log.info("prewarm: bucket %d run", b)
            b *= 2

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        self.epoch += 1
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        log.info("image-search server on port %d", self.port)
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
        if self._running:
            self._running = False
            self._work.put(None)  # stop sentinel: worker drains in-flight
            if self._worker is not None:
                self._worker.join(timeout=10)
        # proactively disconnect live clients so they reconnect and observe
        # the new epoch (the reference's resize-protocol behavior,
        # store-server.cc:97-146: disconnect all, clients retry)
        for s in list(self._conns):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._thread:
            self._thread.join(timeout=5)
