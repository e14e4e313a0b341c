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
  * ``stats() -> {...}``: requests, batches, codes, epoch, the named
    timers (``timings``) and the search path's counters (``counters``)

Where the port differs: the index lives on the card, so a
``search_image_by_id`` request carries its id to the worker, which
gathers a batch's id rows with one ``index_select`` on the device; a
batch's results are read back with one ``tolist`` each; ``prewarm``
builds the blockmin kernel (torch compiles no graphs) before its one batch
per bucket.

``sharded=True`` serves a ``ShardedMIHIndex`` on the synchronous path, as
the reference does: each padded batch runs through ``sharded_mih_search``
on the worker thread. In a world of more than one rank, rank 0 serves and
every other rank of the mesh runs :func:`follow`: rank 0 broadcasts each
batch and its ``(knn, approximate)`` (the reference's ``bcast``,
``mpi_coordinator.cc:26-28``), all ranks search it together, and a stop
message ends the followers when the server stops. A ``search_image_by_id``
row's code is looked up across the mesh (each rank holds a slice of the
codes). Every request is checked on rank 0 before anything is broadcast,
and a batch that fails after its broadcast fails on every rank alike: rank
0 answers the error and each follower goes on to the next batch. Only the
worker thread issues collectives, the stop message included.
"""

from __future__ import annotations

import contextlib
import queue
import socket
import socketserver
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from verticut_tpu_torch import bits as bits_lib
from verticut_tpu_torch import codes as codes_lib
from verticut_tpu_torch.config import DEFAULT_SERVER_PORT, SearchConfig
from verticut_tpu_torch.search import (mih_search, mih_search_dispatch,
                                       mih_search_finalize)
from verticut_tpu_torch.service import wire
from verticut_tpu_torch.utils.logging import get_logger
from verticut_tpu_torch.utils.timer import Timer, counters, timings

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
    """Serves K-NN queries over a built index: a single-device
    ``MIHIndex``, or with ``sharded=True`` a ``ShardedMIHIndex`` (on rank
    0 of its world; see :func:`follow`)."""

    def __init__(self, index, host: str = "127.0.0.1",
                 port: int = DEFAULT_SERVER_PORT,
                 default_knn: int = 10, sharded: bool = False):
        if sharded and _world_size() > 1:
            if dist.get_rank() != 0:
                raise ValueError("rank 0 serves; the other ranks follow()")
            if index.mesh.coords is None or _mesh_size(index) != _world_size():
                raise ValueError("a sharded server's mesh must span the "
                                 "world: every other rank follows it")
        self.index = index
        self.sharded = sharded
        # rank 0 of a sharded world: every batch is broadcast to followers
        self._leads = sharded and _world_size() > 1
        self._closed = False    # stop() was called
        self._stopped = False   # the followers were sent the stop message
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
                    "epoch": self.epoch, "timings": timings(),
                    "counters": counters()}
        if method == "search_image_by_id":
            image_id, knn, approx = (list(params) + [self.default_knn, False]
                                     )[:3]
            knn = self._check_knn(knn)
            if self.index.codes is None:
                raise ValueError("index holds no code array")
            if not 0 <= int(image_id) < self.index.n:
                raise IndexError(f"image id {image_id} outside "
                                 f"[0, {self.index.n})")
            # an id row: the worker gathers the code on the device
            q = np.array([int(image_id)], np.int64)
            return self._search(q, knn, bool(approx))[0]
        if method == "search_by_code":
            code, knn, approx = (list(params) + [self.default_knn, False])[:3]
            knn = self._check_knn(knn)
            if len(code) != self.index.cfg.n_bytes:
                raise ValueError(f"a code is {self.index.cfg.n_bytes} bytes, "
                                 f"not {len(code)}")
            q = codes_lib.pack_bytes(np.frombuffer(code, np.uint8)[None])
            return self._search(q, knn, bool(approx))[0]
        if method == "search_batch":
            blob, knn, approx = (list(params) + [self.default_knn, False])[:3]
            knn = self._check_knn(knn)
            nbytes = self.index.cfg.n_bytes
            raw = np.frombuffer(blob, np.uint8).reshape(-1, nbytes)
            return self._search(codes_lib.pack_bytes(raw), knn, bool(approx))
        raise ValueError(f"unknown method {method!r}")

    def _check_knn(self, knn) -> int:
        """A request's ``knn``, checked before its batch is formed: at
        least 1, and on a sharded index at most the corpus size (a batch
        that fails after its broadcast costs every rank of the world)."""
        knn = int(knn)
        hi = self.index.n if self.sharded else None
        if knn < 1 or (hi is not None and knn > hi):
            raise ValueError(f"knn {knn} outside [1, {hi or 'inf'}]")
        return knn

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
            if self._leads and self._closed:
                raise RuntimeError("the server has stopped its followers")
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
                    self._stop_followers()
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
                    batch = []
                if prev is not None:
                    self._safe_finalize(prev)
                if dispatched is not None:
                    inflight = (key, batch) + dispatched
                elif batch:  # the sync engine (sharded)
                    try:
                        self._execute_sync(key, batch)
                    except Exception as e:  # noqa: BLE001 — to the waiters
                        self._deliver_error(batch, e)
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
        """Launch without waiting; None where only the sync path applies
        (sharded)."""
        if self.sharded:
            return None
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

    def _sharded_batch(self, batch):
        """The batch as the followers receive it: ``codes int32[nq, W]``
        (zero at id rows) and ``ids int64[nq]`` (-1 at code rows), padded
        with copies of the first row to a power of two of at least 8,
        rounded up to a multiple of the mesh's query axis (which splits
        the rows evenly), on the index's device, and each request's row
        count."""
        qs = [slot[0] for slot, _ in batch]
        sizes = [q.shape[0] for q in qs]
        nq = sum(sizes)
        self.n_requests += nq
        self.n_batches += 1
        n_rows = max(8, 1 << (nq - 1).bit_length())
        n_query = self.index.mesh.shape["query"]
        n_pad = -(-n_rows // n_query) * n_query - nq
        w = self.index.cfg.n_words
        codes = np.zeros((nq + n_pad, w), np.uint32)
        ids = np.full(nq + n_pad, -1, np.int64)
        lo = 0
        for q in qs:
            if q.ndim == 1:
                ids[lo:lo + q.shape[0]] = q
            else:
                codes[lo:lo + q.shape[0]] = q
            lo += q.shape[0]
        codes[nq:], ids[nq:] = codes[0], ids[0]
        dev = self.index.mesh.device
        return (bits_lib.as_codes(codes, dev),
                torch.from_numpy(ids).to(dev), sizes)

    def _execute_sync(self, key, batch):
        knn, approx = key
        codes, ids, sizes = self._sharded_batch(batch)
        with _on(self.index.mesh.device):
            if self._leads:
                _broadcast_batch(self.index, 1, knn, approx, codes, ids)
            res = _sharded_search(self.index, codes, ids, knn, approx)
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
        if self.index.device.type == "cuda" and not self.sharded:
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

    def _stop_followers(self):
        """Send the followers the stop message, once. Called by the worker
        at its stop sentinel, or by :meth:`stop` where no worker runs, so
        that one thread alone issues the world's collectives."""
        if self._leads and not self._stopped:
            with _on(self.index.mesh.device):
                _broadcast_batch(self.index, 0, 0, False)
        self._stopped = True

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
        with self._work.mutex:
            running, self._running = self._running, False
            self._closed = True
        if running:
            self._work.put(None)  # stop sentinel: worker drains in-flight
            if self._worker is not None:
                # a sharded world waits for the worker's stop message
                self._worker.join(timeout=None if self._leads else 10)
        else:
            self._stop_followers()
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


# --------------------------------------------------------------------------
# The sharded server's world: rank 0 serves, every other rank follows
# --------------------------------------------------------------------------

def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh_size(index) -> int:
    return index.mesh.n_model * index.mesh.shape["query"]


def _on(device):
    """The device's context for collectives issued from this thread."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _broadcast_batch(index, kind: int, knn: int, approx: bool,
                     codes: Optional[torch.Tensor] = None,
                     ids: Optional[torch.Tensor] = None) -> None:
    """Rank 0's side of the message :func:`follow` receives: the header
    ``[kind, rows, knn, approx]`` (kind 0 = stop, 1 = a batch), then the
    batch's codes and ids."""
    dev = index.mesh.device
    nq = 0 if codes is None else codes.shape[0]
    dist.broadcast(torch.tensor([kind, nq, knn, int(approx)],
                                dtype=torch.int64, device=dev), src=0)
    if kind:
        dist.broadcast(codes, src=0)
        dist.broadcast(ids, src=0)


def _sharded_search(index, codes: torch.Tensor, ids: torch.Tensor, knn: int,
                    approx: bool):
    """One batch on every rank of the mesh: the id rows' codes looked up
    across the mesh, then ``sharded_mih_search``."""
    from verticut_tpu_torch.search.sharded import (lookup_codes,
                                                   sharded_mih_search)
    is_id = ids >= 0
    if bool(is_id.any()):   # the same payload, so the same on every rank
        codes = torch.where(is_id[:, None],
                            lookup_codes(index, ids.clamp(min=0)), codes)
    return sharded_mih_search(index, codes,
                              SearchConfig(knn=knn, approximate=approx))


def follow(index) -> int:
    """A follower rank's side of a sharded server: receive every batch
    rank 0 broadcasts and join its search, until the stop message. A batch
    that raises (as it does on every rank alike, rank 0 answering the
    error) is logged and the next one awaited; a failure of the world
    itself ends it. Returns the number of batches followed."""
    dev = index.mesh.device
    w = index.cfg.n_words
    n = 0
    with _on(dev):
        while True:
            hdr = torch.empty(4, dtype=torch.int64, device=dev)
            dist.broadcast(hdr, src=0)
            kind, nq, knn, approx = hdr.tolist()
            if kind == 0:
                return n
            codes = torch.empty((nq, w), dtype=torch.int32, device=dev)
            ids = torch.empty(nq, dtype=torch.int64, device=dev)
            dist.broadcast(codes, src=0)
            dist.broadcast(ids, src=0)
            try:
                _sharded_search(index, codes, ids, knn, bool(approx))
            except dist.DistError:
                raise
            except Exception:  # noqa: BLE001 — rank 0 answers the error
                log.exception("a followed batch failed")
            n += 1
