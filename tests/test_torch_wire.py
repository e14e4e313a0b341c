"""The port's msgpack subset (verticut_tpu_torch.service.wire) against the
msgpack package: packb byte-equal to ``msgpack.packb(use_bin_type=True)``
and Unpacker equal to ``msgpack.Unpacker(raw=False)``, on the RPC's
request and response shapes and on generated nested values, fed whole and
split at every byte boundary; then each package's client against the other
package's server."""

import msgpack
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from verticut_tpu import codes as jcodes
from verticut_tpu.config import MIHConfig as JMIHConfig
from verticut_tpu.index import build_index as jax_build_index
from verticut_tpu.service import ImageSearchClient as JaxClient
from verticut_tpu.service import ImageSearchServer as JaxServer
from verticut_tpu_torch.config import MIHConfig
from verticut_tpu_torch.index import build_index
from verticut_tpu_torch.service import (ImageSearchClient, ImageSearchServer,
                                        wire)

TIMEOUT = 30

RPC = [
    [0, 1, "ping", []],
    [0, 2, "search_image_by_id", [5, 10, False]],
    [0, 3, "search_by_code", [bytes(range(16)), 3, True]],
    [0, 2**31 + 7, "search_batch", [bytes(range(256)) * 64, 100, False]],
    [1, 2, None, "pong"],
    [1, 3, None, [[5, 0], [199, 49], [58, 50]]],
    [1, 4, None, [[[i * 70_001 % 2**32, i % 129] for i in range(10)]
                  for _ in range(40)]],
    [1, 5, "RuntimeError: batch worker failed: injected", None],
    [1, 6, None, {"n_requests": 17, "n_batches": 3, "n_codes": 10**9,
                  "epoch": 1, "timings": {"rpc.search_batch": {
                      "total_s": 0.25, "count": 3, "mean_s": 1 / 12}}}],
]

EDGES = [None, True, False, 0, 127, 128, 255, 256, 2**16 - 1, 2**16,
         2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129, -2**15,
         -2**15 - 1, -2**31, -2**31 - 1, -2**63, 0.0, -0.0, 1.5, 1e300,
         float("inf"), "", "x" * 31, "x" * 32, "é" * 128, "y" * 2**16, b"",
         b"z" * 255, b"z" * 256, b"z" * 2**16, [], [0] * 15, [0] * 16,
         [0] * 2**16, (1, "t"), {}, {str(i): i for i in range(15)},
         {str(i): i for i in range(16)}, {b"k": [b"v"]}]


def _feed_split(data: bytes, cut: int):
    u = wire.Unpacker()
    u.feed(data[:cut])
    out = list(u)
    u.feed(data[cut:])
    return out + list(u)


@pytest.mark.parametrize("obj", RPC + EDGES, ids=range(len(RPC + EDGES)))
def test_packb_and_unpacker_equal_msgpack(obj):
    data = msgpack.packb(obj, use_bin_type=True)
    assert wire.packb(obj) == data
    want = msgpack.unpackb(data, raw=False)
    u = wire.Unpacker()
    u.feed(data)
    assert list(u) == [want]
    if len(data) < 2000:
        cuts = range(len(data) + 1)
    else:
        cuts = range(0, len(data) + 1, len(data) // 97)
    for cut in cuts:
        assert _feed_split(data, cut) == [want], cut


def test_unpacker_streams_messages_and_keeps_the_tail():
    """Several messages in one feed come out in order; a partial one
    waits for the rest; float32 decodes; what the subset lacks raises."""
    stream = b"".join(msgpack.packb(m, use_bin_type=True) for m in RPC)
    u = wire.Unpacker()
    u.feed(stream[:-3])
    assert list(u) == [msgpack.unpackb(msgpack.packb(m, use_bin_type=True),
                                       raw=False) for m in RPC[:-1]]
    u.feed(stream[-3:])
    assert len(list(u)) == 1
    u.feed(b"\xca\x3f\xc0\x00\x00")            # float32 1.5
    assert list(u) == [1.5]
    for bad in (b"\xc1", b"\xd4\x01\x02", b"\x81\x01\x02"):
        u = wire.Unpacker()
        u.feed(bad)
        with pytest.raises(ValueError):
            list(u)
    for big in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            wire.packb(big)
    with pytest.raises(TypeError):
        wire.packb(np.int64(3))


scalars = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40)
           | st.binary(max_size=300))
values = st.recursive(
    scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=8)
                                     | st.binary(max_size=4), inner,
                                     max_size=6)),
    max_leaves=40)


@settings(max_examples=80, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(values)
def test_generated_values_equal_msgpack(obj):
    data = msgpack.packb(obj, use_bin_type=True)
    assert wire.packb(obj) == data
    want = msgpack.unpackb(data, raw=False)
    for cut in range(len(data) + 1):
        assert _feed_split(data, cut) == [want]


@pytest.fixture(scope="module")
def servers():
    """A JAX server and the port's server on the same 400 uniform codes."""
    rng = np.random.default_rng(17)
    raw = rng.integers(0, 256, size=(400, 16), dtype=np.uint8)
    packed = jcodes.pack_bytes(raw)
    jsrv = JaxServer(jax_build_index(packed, JMIHConfig()), port=0).start()
    srv = ImageSearchServer(build_index(packed, MIHConfig(), device="cpu"),
                            port=0).start()
    yield raw, jsrv, srv
    jsrv.stop()
    srv.stop()


def _ask(cli, raw):
    return ([cli.ping()] + [cli.search_image_by_id(i, 4) for i in (2, 333)]
            + [cli.search_by_code(raw[9].tobytes(), 6),
               cli.search_batch(raw[100:110].tobytes(), 3)])


@pytest.mark.parametrize("server", ["jax", "port"])
def test_each_client_calls_the_other_package_server(servers, server):
    """The JAX client calls the port's server and the port's client the
    JAX server; both get what the same-package pair gets."""
    raw, jsrv, srv = servers
    s = jsrv if server == "jax" else srv
    same_cls, other_cls = ((JaxClient, ImageSearchClient) if server == "jax"
                           else (ImageSearchClient, JaxClient))
    same = same_cls(port=s.port, pool=1, timeout=TIMEOUT)
    other = other_cls(port=s.port, pool=1, timeout=TIMEOUT)
    try:
        want = _ask(same, raw)
        assert _ask(other, raw) == want
        assert want[1][0] == [2, 0] and want[0] == "pong"
        st_other = other.stats()
        assert st_other["n_codes"] == 400 and st_other["epoch"] == 1
        with pytest.raises(RuntimeError, match="rpc error"):
            other.call("no_such_method")
    finally:
        same.close()
        other.close()
