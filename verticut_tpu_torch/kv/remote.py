"""Network KV backends and the standalone KV server: the port's copy of
``verticut_tpu/kv/remote.py``, on the same wire, so either package's
client talks to either package's server.

The reference runs its store as a separate process (``Pilaf/store-server.cc``)
and ships pluggable memcached/redis clients (``src/memcached_proxy.h``,
``src/redis_proxy.h`` over the vendored ``Redis/redisclient.h``). The search
engine never touches a KV store on the query path, but the framework keeps
the operational seam real:

* :class:`RedisKV` — a dependency-free RESP2 client (GET/SET/EXISTS/DEL)
  speaking to any Redis-protocol server.
* :class:`MemcachedKV` — a dependency-free memcached text-protocol client.
* :class:`KVServer` — OUR standalone store server: any :class:`KVStore`
  (native DHT by default) exposed over RESP2, so ``RedisKV`` connects to it
  and ops tooling (redis-cli) works against it. This is the
  ``store-server.cc`` analog; pair with ``OpLogKV`` for the op-log. Its
  listen backlog is 128, not socketserver's 5 (as the port's search
  service's).

Wire compatibility over feature count: only the verbs the BaseProxy
contract needs (``src/base_proxy.h:15-29``).
"""

from __future__ import annotations

import socket
import socketserver
import threading
from typing import Optional, Tuple

from verticut_tpu_torch.kv.store import KVStore, make_store


# --------------------------------------------------------------------------
# RESP2 wire helpers
# --------------------------------------------------------------------------

def _resp_encode_command(*parts: bytes) -> bytes:
    out = [b"*%d\r\n" % len(parts)]
    for p in parts:
        out.append(b"$%d\r\n%s\r\n" % (len(p), p))
    return b"".join(out)


class _RespReader:
    """Incremental RESP2 value reader over a buffered socket file."""

    def __init__(self, f):
        self.f = f

    def read_value(self):
        line = self.f.readline()
        if not line:
            raise ConnectionError("peer closed")
        tag, body = line[:1], line[1:-2]
        if tag == b"+":
            return body
        if tag == b"-":
            raise RuntimeError(f"server error: {body.decode()}")
        if tag == b":":
            return int(body)
        if tag == b"$":
            n = int(body)
            if n < 0:
                return None
            data = self.f.read(n + 2)
            return data[:n]
        if tag == b"*":
            n = int(body)
            if n < 0:
                return None
            return [self.read_value() for _ in range(n)]
        raise ValueError(f"bad RESP tag {tag!r}")


class RedisKV(KVStore):
    """RESP2 (Redis-protocol) client backend; works against a real Redis
    or against :class:`KVServer`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout: float = 5.0):
        self.addr = (host, port)
        self.timeout = timeout
        self._lock = threading.Lock()
        self._connect()

    def _connect(self):
        self._sock = socket.create_connection(self.addr, self.timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._f = self._sock.makefile("rb")
        self._r = _RespReader(self._f)

    def _cmd(self, *parts: bytes):
        with self._lock:
            self._sock.sendall(_resp_encode_command(*parts))
            return self._r.read_value()

    def ping(self) -> bool:
        return self._cmd(b"PING") == b"PONG"

    def get(self, key):
        return self._cmd(b"GET", key)

    def put(self, key, value):
        r = self._cmd(b"SET", key, value)
        if r != b"OK":
            raise RuntimeError(f"SET failed: {r!r}")

    def contains(self, key):
        return self._cmd(b"EXISTS", key) == 1

    def remove(self, key):
        return self._cmd(b"DEL", key) == 1

    def close(self):
        try:
            self._f.close()
            self._sock.close()
        except OSError:
            pass


class MemcachedKV(KVStore):
    """Memcached text-protocol client backend (get/set/delete subset)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 11211,
                 timeout: float = 5.0):
        self.addr = (host, port)
        self._lock = threading.Lock()
        self._sock = socket.create_connection(self.addr, timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._f = self._sock.makefile("rb")

    @staticmethod
    def _key(key: bytes) -> bytes:
        # memcached keys must be printable & short: hex-encode raw bytes
        return key.hex().encode()

    def get(self, key):
        with self._lock:
            self._sock.sendall(b"get " + self._key(key) + b"\r\n")
            line = self._f.readline()
            if line.startswith(b"VALUE"):
                n = int(line.split()[3])
                data = self._f.read(n + 2)[:n]
                end = self._f.readline()
                assert end == b"END\r\n", end
                return data
            if line == b"END\r\n":
                return None
            raise RuntimeError(f"memcached: {line!r}")

    def put(self, key, value):
        with self._lock:
            self._sock.sendall(b"set %s 0 0 %d\r\n%s\r\n"
                               % (self._key(key), len(value), value))
            line = self._f.readline()
            if line != b"STORED\r\n":
                raise RuntimeError(f"memcached set: {line!r}")

    def contains(self, key):
        return self.get(key) is not None

    def remove(self, key):
        with self._lock:
            self._sock.sendall(b"delete " + self._key(key) + b"\r\n")
            return self._f.readline() == b"DELETED\r\n"

    def close(self):
        try:
            self._f.close()
            self._sock.close()
        except OSError:
            pass


# --------------------------------------------------------------------------
# Standalone KV server (store-server.cc analog)
# --------------------------------------------------------------------------

class _RespHandler(socketserver.StreamRequestHandler):
    def handle(self):
        reader = _RespReader(self.rfile)
        store: KVStore = self.server.store          # type: ignore[attr-defined]
        lock: threading.Lock = self.server.store_lock  # type: ignore
        while True:
            try:
                cmd = reader.read_value()
            except (ConnectionError, ValueError):
                return
            if not isinstance(cmd, list) or not cmd:
                return
            verb = bytes(cmd[0]).upper()
            try:
                try:
                    self._exec(store, lock, verb, cmd)
                except (BrokenPipeError, ConnectionError):
                    return
                except Exception as e:  # noqa: BLE001 — protocol error reply
                    # a store failure (e.g. DHT capacity) must surface as a
                    # RESP error, not a reset connection
                    msg = f"{type(e).__name__}: {e}".encode()[:200]
                    msg = msg.replace(b"\r", b" ").replace(b"\n", b" ")
                    self.wfile.write(b"-ERR " + msg + b"\r\n")
                if verb == b"QUIT":
                    return
                self.wfile.flush()
            except (BrokenPipeError, ConnectionError):
                return

    def _exec(self, store, lock, verb, cmd):
        if verb == b"PING":
            self.wfile.write(b"+PONG\r\n")
        elif verb == b"SET" and len(cmd) >= 3:
            with lock:
                store.put(bytes(cmd[1]), bytes(cmd[2]))
            self.wfile.write(b"+OK\r\n")
        elif verb == b"GET" and len(cmd) == 2:
            with lock:
                v = store.get(bytes(cmd[1]))
            if v is None:
                self.wfile.write(b"$-1\r\n")
            else:
                self.wfile.write(b"$%d\r\n%s\r\n" % (len(v), v))
        elif verb == b"EXISTS" and len(cmd) == 2:
            with lock:
                n = 1 if store.contains(bytes(cmd[1])) else 0
            self.wfile.write(b":%d\r\n" % n)
        elif verb == b"DEL" and len(cmd) >= 2:
            n = 0
            with lock:
                for k in cmd[1:]:
                    n += 1 if store.remove(bytes(k)) else 0
            self.wfile.write(b":%d\r\n" % n)
        elif verb == b"QUIT":
            self.wfile.write(b"+OK\r\n")
        else:
            self.wfile.write(b"-ERR unknown command\r\n")


class _Server(socketserver.ThreadingTCPServer):
    # listen backlog: socketserver's 5 drops the SYNs of a burst of new
    # clients, which then wait a 1 s retransmit
    request_queue_size = 128


class KVServer:
    """Threaded RESP2 front over any KVStore — the standalone store-server
    process. The single writer lock serializes mutations (the native DHT is
    single-writer by contract); reads share it for simplicity — the search
    path never sits behind this server."""

    def __init__(self, store: Optional[KVStore] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.store = store or make_store("dht")
        self._srv = _Server((host, port), _RespHandler,
                            bind_and_activate=True)
        self._srv.daemon_threads = True
        self._srv.store = self.store            # type: ignore[attr-defined]
        self._srv.store_lock = threading.Lock()  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._srv.server_address  # type: ignore[return-value]

    @property
    def port(self) -> int:
        return self.address[1]

    def start(self) -> "KVServer":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self.store.close()
