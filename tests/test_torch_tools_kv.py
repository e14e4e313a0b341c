"""The port's last five command-line tools (``verticut_tpu_torch/tools``:
kv_loadtest, perf_sweep, tcp_echo, collective_bench, multiproc_demo)
against the JAX package's (``tools/``), and ``parallel.world.spawn``'s
default device.

Three JAX tools run as their users run them, in subprocesses on the CPU
(``JAX_PLATFORMS=cpu``, started together when the module's first test
asks for one): kv_loadtest, perf_sweep's search mode and
collective_bench with a mesh. perf_sweep's kv and echo modes and
tcp_echo's client are host code and run in this process from the JAX
tool's file. The port's tool runs in this process, ``main([...])``, its
output read with ``capsys``. Held with tolerance 0: the printed lines but
for their measured numbers, every JSON key, the ``stats:`` line of the
native store, the rows' cells, and (multiproc_demo) every field of the
committed ``MULTIPROC_r05.json`` but its times and process layout.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from verticut_tpu_torch.parallel.world import spawn
from verticut_tpu_torch.tools import (collective_bench, kv_loadtest,
                                      multiproc_demo, perf_sweep, tcp_echo)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_RUNS = {
    "kv_loadtest": ("kv_loadtest", ["--backend", "dht", "-n", "20000",
                                    "--key_space", "2000"]),
    "search": ("perf_sweep", ["search", "--n", "20000", "--q", "64", "--k",
                              "10", "--repeats", "1", "--out",
                              "{tmp}/jax.json"]),
    "collective": ("collective_bench", ["--cpu", "--max_pow", "6", "--mesh",
                                        "2x1x1"]),
}


def _jax_tool(tmp, tool, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               VERTICUT_JAX_CACHE=os.path.join(tmp, "jax_cache"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", f"{tool}.py"),
         *[a.format(tmp=tmp) for a in args]],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tools_kv"))


@pytest.fixture(scope="module")
def jax_runs(tmp):
    with ThreadPoolExecutor(len(JAX_RUNS)) as ex:
        yield {k: ex.submit(_jax_tool, tmp, *v) for k, v in JAX_RUNS.items()}


def _jax(jax_runs, name):
    proc = jax_runs[name].result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _jax_module(name):
    """A JAX tool's file as a module (host code only)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(capsys, tool, args):
    capsys.readouterr()
    tool.main(args)
    return capsys.readouterr().out


def _shape(text):
    """The lines with every number, and the padding before it, cut out."""
    return [re.sub(r" *-?\d[\d,.]*", " #", ln) for ln in text.splitlines()]


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _keys(obj):
    """The nested key structure of a JSON value."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return type(obj).__name__


# --------------------------------------------------------------------------
# kv_loadtest
# --------------------------------------------------------------------------

def test_kv_loadtest_matches_jax(jax_runs, capsys):
    want = _jax(jax_runs, "kv_loadtest")
    got = _port(capsys, kv_loadtest, JAX_RUNS["kv_loadtest"][1])
    assert _shape(got) == _shape(want)
    stats = [ln for ln in got.splitlines() if ln.startswith("stats:")]
    assert stats == [ln for ln in want.splitlines()
                     if ln.startswith("stats:")]
    assert "'crc_failures': 0" in stats[0]
    g, w = _json_lines(got)[0], _json_lines(want)[0]
    assert list(g) == list(w)
    assert {k: g[k] for k in ("metric", "backend", "read_mode", "shards",
                              "ops", "get_ratio", "val_len")} == \
        {k: w[k] for k in ("metric", "backend", "read_mode", "shards",
                           "ops", "get_ratio", "val_len")}


@pytest.mark.parametrize("args", [["--read_mode", "server"],
                                  ["--n_shards", "3"],
                                  ["--backend", "memory"]])
def test_kv_loadtest_modes(capsys, args):
    """The server read mode (every op over TCP to a KVServer), a sharded
    store and the dict backend: the same report, no stats line where the
    store keeps none."""
    got = _port(capsys, kv_loadtest, ["-n", "2000", "--key_space", "300"]
                + args)
    rec = _json_lines(got)[0]
    assert rec["ops"] == 2000 and rec["p50_us"] > 0
    assert [ln.split(":")[0] for ln in got.splitlines()[2:6]] == [
        "p50", "p90", "p99", "p99.9"]
    assert not any(ln.startswith("stats:") for ln in got.splitlines())


# --------------------------------------------------------------------------
# perf_sweep
# --------------------------------------------------------------------------

def test_perf_sweep_search_matches_jax(jax_runs, tmp, capsys):
    _jax(jax_runs, "search")
    out = os.path.join(tmp, "port.json")
    got = _port(capsys, perf_sweep, ["search", "--n", "20000", "--q", "64",
                                     "--k", "10", "--repeats", "1", "--out",
                                     out, "--device", "cpu"])
    with open(out) as f, open(os.path.join(tmp, "jax.json")) as g:
        port, jax = json.load(f), json.load(g)
    assert port["mode"] == jax["mode"] == "search"
    assert [r["cell"] for r in port["rows"]] == \
        [r["cell"] for r in jax["rows"]] == [{"n": 20000, "q": 64, "k": 10}]
    assert _keys(port) == _keys(jax)
    assert _json_lines(got) == port["rows"]


def test_perf_sweep_kv_matches_jax(capsys):
    jax = _jax_module("perf_sweep").sweep_kv(argparse.Namespace(
        backends=["memory", "dht"], sizes=[64, 1024], ops=500, repeats=2))
    capsys.readouterr()
    got = _port(capsys, perf_sweep, ["kv", "--backends", "memory,dht",
                                     "--sizes", "64,1024", "--ops", "500",
                                     "--repeats", "2"])
    port = _json_lines(got)
    assert [r["cell"] for r in port] == [r["cell"] for r in jax]
    assert _keys(port) == _keys(jax)
    assert all(r["get_ops_per_s"]["n_runs"] == 2 for r in port)


def test_perf_sweep_echo_matches_jax(capsys, monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    jax = _jax_module("perf_sweep").sweep_echo(argparse.Namespace(
        ops=50, max_log2=3, repeats=1))
    capsys.readouterr()
    got = _port(capsys, perf_sweep, ["echo", "--ops", "50", "--max-log2",
                                     "3"])
    port = _json_lines(got)
    assert [r["size"] for r in port] == [r["size"] for r in jax[0]] == \
        [1, 2, 4, 8]
    assert _keys(port) == _keys(jax[0])


# --------------------------------------------------------------------------
# tcp_echo
# --------------------------------------------------------------------------

def test_tcp_echo_self_test(capsys):
    got = _port(capsys, tcp_echo, ["--iters", "60", "--max-log2", "5"])
    rows = _json_lines(got)
    assert [r["size"] for r in rows] == [1 << i for i in range(6)]
    assert all(r["iters"] == 60 and r["rtt_us_min"] <= r["rtt_us_max"]
               for r in rows)


@pytest.mark.parametrize("server,client", [("port", "jax"), ("jax", "port")])
def test_tcp_echo_across_packages(capsys, server, client):
    """Either package's client against the other's echo server: the same
    rows."""
    jax = _jax_module("tcp_echo")
    smod = tcp_echo if server == "port" else jax
    cmod = tcp_echo if client == "port" else jax
    srv = smod.EchoServer().start()
    try:
        rows = cmod.run_client("127.0.0.1", srv.port, iters=50, max_log2=4)
    finally:
        srv.stop()
    assert [r["size"] for r in rows] == [1, 2, 4, 8, 16]
    assert list(rows[0]) == ["size", "iters", "rtt_us_min", "rtt_us_avg",
                             "rtt_us_stddev", "rtt_us_max", "goodput_MBps"]


# --------------------------------------------------------------------------
# collective_bench
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def collective_port():
    """The port's run, its mesh sweep in a spawned gloo world of 2."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        collective_bench.main(JAX_RUNS["collective"][1])
    return out.getvalue()


@pytest.mark.parametrize("kind", ["gather", "all_gather"])
def test_collective_bench_matches_jax(jax_runs, collective_port, kind):
    """``--cpu --max_pow 6 --mesh 2x1x1``: the gather sweep's and the
    all_gather sweep's lines on the same grid as the JAX tool's."""
    want = _jax(jax_runs, "collective")

    def lines(text):
        return [ln for ln in text.splitlines()
                if ln.split(" ")[0] == kind]
    got = lines(collective_port)
    assert len(got) == 3
    assert _shape("\n".join(got)) == _shape("\n".join(lines(want)))
    sizes = [int(ln.split()[1]) for ln in got]
    assert sizes == [int(ln.split()[1]) for ln in lines(want)] == [1, 8, 64]
    assert collective_port.splitlines()[0] == "devices: ['cpu']"


# --------------------------------------------------------------------------
# multiproc_demo
# --------------------------------------------------------------------------

def test_multiproc_demo_reproduces_the_committed_artifact(tmp, capsys):
    """``--device cpu``: a gloo world of 8 on the default 4x2x1 mesh.
    Every field of ``MULTIPROC_r05.json`` but the times and the process
    layout is reproduced, and the artifact goes where ``--out`` says."""
    out = os.path.join(tmp, "multiproc.json")
    got = _port(capsys, multiproc_demo, ["--device", "cpu", "--out", out])
    with open(out) as f:
        port = json.load(f)
    assert _json_lines(got) == [port]
    with open(os.path.join(REPO, "MULTIPROC_r05.json")) as f:
        ref = json.load(f)
    layout = {"build_s", "search_s", "total_s", "n_processes",
              "local_devices_per_process", "platform"}
    assert list(port) == list(ref)
    assert {k: v for k, v in port.items() if k not in layout} == \
        {k: v for k, v in ref.items() if k not in layout}
    assert port["ok"] and port["n_shard_files"] == 24
    assert (port["n_processes"], port["local_devices_per_process"]) == (8, 1)
    assert port["platform"] == "cpu (8 processes x 1 device, gloo)"


def test_multiproc_demo_default_artifact_name(tmp_path, monkeypatch):
    """Without ``--out`` the demo writes ``MULTIPROC_torch.json``, never
    the JAX package's artifact."""
    from verticut_tpu_torch.tools import _mesh
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(_mesh, "run", lambda fn, shape, device, *a: {
        "metric": "multiproc_compact_demo", "mesh": shape})
    multiproc_demo.main(["--device", "cpu"])
    assert os.listdir(tmp_path) == ["MULTIPROC_torch.json"]


# --------------------------------------------------------------------------
# the card by default
# --------------------------------------------------------------------------

def _rank_id(rank):
    return rank


def test_spawn_runs_on_the_card_by_default(monkeypatch):
    """``spawn`` with no device takes the card and raises where there is
    none; ``device="cpu"`` keeps the gloo world."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(_rank_id, 1)


def test_spawn_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 8 CUDA devices"):
        spawn(_rank_id, 8)
    with pytest.raises(RuntimeError, match="needs 8 CUDA devices"):
        multiproc_demo.main(["--out", os.devnull])


TOOLS = {
    perf_sweep: ["search", "--n", "1000"],
    collective_bench: ["--max_pow", "0"],
    multiproc_demo: ["--mesh", "1x1x1", "--out", os.devnull],
}


@pytest.mark.parametrize("tool", list(TOOLS), ids=lambda m: m.__name__)
def test_tools_raise_without_a_card(monkeypatch, tool):
    """Given no ``--device``, a tool that touches torch runs on the card,
    and raises before any work where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(TOOLS[tool])
