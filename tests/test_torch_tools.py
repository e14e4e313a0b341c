"""The port's command-line tools (``verticut_tpu_torch/tools``) against
the JAX package's (``tools/``) on the same files: build_index, search
(single device and ``--mesh``), linear_search, integrity_check and
generate_bitmap.

Each JAX tool runs as its users run it, in a subprocess on the CPU
(``JAX_PLATFORMS=cpu``, its compile cache under a temporary directory),
on a file of 20,000 clustered codes; the subprocesses start together, a
few at a time, when the module's first test asks for one. The port's tool
runs in this process, ``main([..., "--device", "cpu"])``, its output read
with ``capsys``; its ``--mesh`` runs spawn gloo worlds. Held with
tolerance 0: every array of the built files, key by key and in dtype; the
result lines, the stat line and the timer names of a search; the scan
lines; the integrity report but for its seconds; the bitmap files' bytes
and the printed lines.
"""

import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from verticut_tpu import codes as jcodes
from verticut_tpu.config import MIHConfig as JMIHConfig
from verticut_tpu.config import SearchConfig as JSearchConfig
from verticut_tpu.index.build_native import build_index_native
from verticut_tpu.index.mih import save_index as jax_save_index
from verticut_tpu.parallel import make_mesh as jax_make_mesh
from verticut_tpu.search.sharded_compact import (
    build_sharded_compact as jax_build_compact,
    save_sharded_compact as jax_save_compact,
    sharded_compact_search as jax_compact_search)

import torch_world_cases as cases
from verticut_tpu_torch.config import MIHConfig
from verticut_tpu_torch.index import build_index, save_index
from verticut_tpu_torch.models.lsh import write_code_file
from verticut_tpu_torch.parallel.world import spawn
from verticut_tpu_torch.tools import (build_index as t_build,
                                      generate_bitmap as t_bitmap,
                                      integrity_check as t_integrity,
                                      linear_search as t_linear,
                                      search as t_search)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 20_000
#: the JAX tools run at once (each takes 4-10 s here)
JAX_PARALLEL = 4

BUILDS = {"default": [], "compact": ["--compact"],
          "bitmap": ["--bitmap", "--ntables", "8"], "native": ["--native"]}
SEARCHES = {"q_k5": ["-q", "123", "-k", "5"],
            "q_k100": ["-q", "123", "-k", "100"],
            "f_k5": ["-f", "{queries}", "-k", "5"],
            "f_k100_a": ["-f", "{queries}", "-k", "100", "-a"]}
MESH_SEARCH = ["-f", "{queries}", "-k", "10", "--mesh", "4x1x1",
               "--cpu-devices", "4"]


def _jax_tool(tmp, tool, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               VERTICUT_JAX_CACHE=os.path.join(tmp, "jax_cache"))
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", f"{tool}.py"), *args],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The code file, a query file and the reference's saved index (its
    native build of the code file), in a fresh directory."""
    tmp = str(tmp_path_factory.mktemp("tools"))
    packed = jcodes.clustered_codes(0, N, 128, n_clusters=N // 200,
                                    flip_p=0.02)
    paths = {"tmp": tmp, "packed": packed,
             "codes": os.path.join(tmp, "lsh.code"),
             "queries": os.path.join(tmp, "queries.code"),
             "index": os.path.join(tmp, "index.npz"),
             "nocodes": os.path.join(tmp, "nocodes.npz"),
             "corrupt": os.path.join(tmp, "corrupt.npz")}
    write_code_file(paths["codes"], packed)
    write_code_file(paths["queries"], jcodes.random_codes(1, 40, 128))
    jax_save_index(paths["index"],
                   build_index_native(packed, JMIHConfig(bits=128,
                                                         n_tables=4)))
    save_index(paths["nocodes"], build_index(
        packed, MIHConfig(), keep_codes=False, device="cpu"))
    with np.load(paths["index"]) as z:
        arrs = dict(z)
    arrs["t0_ids"] = arrs["t0_ids"].copy()
    arrs["t0_ids"][5] ^= 1                      # one entry id flipped
    np.savez(paths["corrupt"], **arrs)
    return paths


def _fill(args, files):
    return [a.format(**files) for a in args]


@pytest.fixture(scope="module")
def jax_runs(files):
    """Every JAX tool run of this module, started at once: name ->
    future of the finished process."""
    tmp = files["tmp"]
    codes = ["--binary_file", files["codes"], "-i", str(N)]
    jobs = {f"build_{k}": ("build_index", codes + v + [
        "--out", os.path.join(tmp, f"jax_{k}.npz")])
        for k, v in BUILDS.items()}
    jobs.update({f"search_{k}": ("search", ["--index", files["index"]]
                                 + _fill(v, files))
                 for k, v in SEARCHES.items()})
    jobs["search_mesh"] = ("search", ["--index", files["index"]]
                           + _fill(MESH_SEARCH, files))
    jobs["search_nocodes"] = ("search", ["--index", files["nocodes"], "-q",
                                         "0"])
    jobs.update({f"linear_{m}": ("linear_search", codes + [
        "-q", "77", "-k", "12", "--method", m])
        for m in ("popcount", "matmul")})
    jobs["integrity_good"] = ("integrity_check", ["--index", files["index"]])
    jobs["integrity_corrupt"] = ("integrity_check",
                                 ["--index", files["corrupt"]])
    jobs["integrity_synthetic"] = ("integrity_check",
                                   ["--synthetic", str(N)])
    jobs["bitmap"] = ("generate_bitmap", codes + [
        "--binary_bits", "64", "--ntables", "4", "--out_prefix",
        os.path.join(tmp, "jax_bitmap")])
    with ThreadPoolExecutor(JAX_PARALLEL) as ex:
        yield {k: ex.submit(_jax_tool, tmp, *v) for k, v in jobs.items()}


def _jax(jax_runs, name, rc=0):
    proc = jax_runs[name].result()
    assert proc.returncode == rc, proc.stderr[-3000:]
    return proc


def _port(capsys, tool, args, rc=0):
    """``tool.main(args)`` on the CPU: ``(stdout, stderr)``."""
    capsys.readouterr()
    if rc:
        with pytest.raises(SystemExit) as e:
            tool.main(args + ["--device", "cpu"])
        assert e.value.code == rc
    else:
        tool.main(args + ["--device", "cpu"])
    return capsys.readouterr()


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def _result_lines(text):
    return [ln for ln in text.splitlines() if re.fullmatch(r"-?\d+ : \d+", ln)]


def _stat_line(text):
    return [ln for ln in text.splitlines() if ln.startswith("average radius")]


def _timer_names(text):
    lines = text.splitlines()
    head = lines.index("===== timings =====")
    return [ln.split()[0] for ln in lines[head + 1:] if ln.strip()]


# --------------------------------------------------------------------------
# build_index
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(BUILDS))
def test_build_index_matches_jax(files, jax_runs, capsys, kind):
    jax = _jax(jax_runs, f"build_{kind}")
    out = os.path.join(files["tmp"], f"port_{kind}.npz")
    got = _port(capsys, t_build, ["--binary_file", files["codes"], "-i",
                                  str(N), "--out", out] + BUILDS[kind])
    _npz_equal(out, os.path.join(files["tmp"], f"jax_{kind}.npz"))
    strip = [re.sub(r"[\d.]+s$", "", ln) for ln in got.out.splitlines()]
    want = [re.sub(r"[\d.]+s$", "", ln) for ln in jax.stdout.splitlines()]
    assert [s.replace("port_", "jax_") for s in strip] == want
    assert ("--native" in got.err) == (kind == "native")


def test_build_index_mesh_matches_jax(files, capsys):
    """``--mesh 4x1x1``: the port's per-shard directory (built in a gloo
    world of 4) holds the arrays and meta the reference's
    ``save_sharded_compact`` writes, and loads, through the port's
    ``load_sharded_compact`` in a world of 4, into an index that answers
    as the reference's does."""
    tmp = files["tmp"]
    port_dir = os.path.join(tmp, "port_mesh")
    jax_dir = os.path.join(tmp, "jax_mesh")
    cfg = JMIHConfig(bits=128, n_tables=4)
    jidx = jax_build_compact(files["packed"], cfg, jax_make_mesh(4, 1, 1))
    jax_save_compact(jax_dir, jidx)
    got = _port(capsys, t_build, ["--binary_file", files["codes"], "--out",
                                  port_dir, "--mesh", "4x1x1"])
    st = jidx.memory_stats()
    assert (f"built compact sharded index over {N} codes on "
            f"{st['n_devices']} devices in ") in got.out
    assert f"({st['bytes_per_code']:.1f} B/code)" in got.out
    assert f"saved per-shard to {port_dir}/ in " in got.out
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for name in os.listdir(jax_dir):
        a, b = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if name.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        else:
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), name
    q = files["packed"][:16]
    port_res, jax_res = spawn(cases.run_loaded_compact, 4,
                              [port_dir, jax_dir], q, device="cpu",
                              threads=1)[0]
    want = jax_compact_search(jidx, q, JSearchConfig(knn=10))
    for f in ("dists", "ids", "radius", "n_probes", "n_nonempty", "n_cands"):
        assert np.array_equal(port_res[f], jax_res[f]), f
    for f in ("dists", "radius", "n_probes", "n_nonempty", "n_cands"):
        assert np.array_equal(port_res[f], np.asarray(getattr(want, f))), f


# --------------------------------------------------------------------------
# search
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(SEARCHES))
def test_search_matches_jax(files, jax_runs, capsys, case):
    jax = _jax(jax_runs, f"search_{case}")
    got = _port(capsys, t_search, ["--index", files["index"]]
                + _fill(SEARCHES[case], files))
    lines = _result_lines(got.out)
    assert lines and lines == _result_lines(jax.stdout)
    assert "tensor(" not in got.out
    assert _stat_line(got.err) == _stat_line(jax.stderr) != []
    assert _timer_names(got.out) == _timer_names(jax.stdout) == [
        "load_index", "while_loop"]


def test_search_mesh_matches_jax(files, jax_runs, capsys):
    """``--mesh 4x1x1 --cpu-devices 4``: the port's inline sharded engine
    in a gloo world of 4 gives JAX's dists and stat line, and the ids of
    the port's single-device engine (the sharded ids are held to the
    single-device engine, not to JAX's tie order: ROADMAP.md Queue 3)."""
    jax = _jax(jax_runs, "search_mesh")
    got = _port(capsys, t_search, ["--index", files["index"]]
                + _fill(MESH_SEARCH, files))
    one = _port(capsys, t_search, ["--index", files["index"]]
                + _fill(MESH_SEARCH[:4], files))
    lines = _result_lines(got.out)
    assert len(lines) == 40 * 10
    assert lines == _result_lines(one.out)
    dists = [ln.split(" : ")[1] for ln in lines]
    assert dists == [ln.split(" : ")[1] for ln in _result_lines(jax.stdout)]
    assert _stat_line(got.err) == _stat_line(jax.stderr) != []
    assert _timer_names(got.out) == _timer_names(jax.stdout)



def test_search_mesh_under_torchrun(files, capsys):
    """The same ``--mesh 4x1x1`` run as four processes of a torchrun
    world (``--standalone``: its own rendezvous on a free local port):
    each joins torchrun's world, only rank 0 prints, and it prints the
    single-device lines and stat line."""
    one = _port(capsys, t_search, ["--index", files["index"]]
                + _fill(MESH_SEARCH[:4], files))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m", "verticut_tpu_torch.tools.search",
         "--index", files["index"]] + _fill(MESH_SEARCH, files),
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _result_lines(proc.stdout) == _result_lines(one.out)
    assert proc.stdout.count("===== timings =====") == 1
    assert _stat_line(proc.stderr) == _stat_line(one.err) != []

def test_search_without_codes_is_a_usage_error(files, jax_runs, capsys):
    jax = _jax(jax_runs, "search_nocodes", rc=2)
    got = _port(capsys, t_search, ["--index", files["nocodes"], "-q", "0"],
                rc=2)
    msg = "index stores no codes; use -f"
    assert msg in jax.stderr and msg in got.err


# --------------------------------------------------------------------------
# linear_search, integrity_check, generate_bitmap
# --------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["popcount", "matmul"])
def test_linear_search_matches_jax(files, jax_runs, capsys, method):
    jax = _jax(jax_runs, f"linear_{method}")
    got = _port(capsys, t_linear, ["--binary_file", files["codes"], "-i",
                                   str(N), "-q", "77", "-k", "12",
                                   "--method", method])
    assert got.out.splitlines() == jax.stdout.splitlines()
    assert len(_result_lines(got.out)) == 12
    assert f"scan of {N} codes in " in got.err


def _report(text):
    rep = json.loads(next(ln for ln in text.splitlines()
                          if ln.startswith("{")))
    assert rep.pop("check_s") >= 0
    return rep


@pytest.mark.parametrize("case,rc", [("good", 0), ("corrupt", 1)])
def test_integrity_check_matches_jax(files, jax_runs, capsys, case, rc):
    jax = _jax(jax_runs, f"integrity_{case}", rc=rc)
    got = _port(capsys, t_integrity, ["--index", files[
        "index" if case == "good" else "corrupt"]], rc=rc)
    assert _report(got.out) == _report(jax.stdout)
    assert _report(got.out)["ok"] == (rc == 0)
    assert ("INTEGRITY FAIL" in got.err) == ("INTEGRITY FAIL" in
                                             jax.stderr) == bool(rc)


def test_integrity_check_synthetic(files, jax_runs, capsys):
    """``--synthetic N``: the port's generator is another stream than
    ``jax.random``, so the reports compare in shape and verdict."""
    jax = _report(_jax(jax_runs, "integrity_synthetic").stdout)
    got = _report(_port(capsys, t_integrity, ["--synthetic", str(N)]).out)
    assert got.pop("build_s") >= 0 and jax.pop("build_s") >= 0
    assert got == jax and got["ok"] and got["n"] == N


def test_generate_bitmap_matches_jax(files, jax_runs, capsys):
    jax = _jax(jax_runs, "bitmap")
    prefix = os.path.join(files["tmp"], "port_bitmap")
    got = _port(capsys, t_bitmap, ["--binary_file", files["codes"], "-i",
                                   str(N), "--binary_bits", "64",
                                   "--ntables", "4", "--out_prefix", prefix])
    assert got.out.replace("port_bitmap", "jax_bitmap").splitlines() == \
        jax.stdout.splitlines()
    for t in range(4):
        with open(f"{prefix}.{t}", "rb") as a, \
                open(os.path.join(files["tmp"], f"jax_bitmap.{t}"), "rb") as b:
            assert a.read() == b.read(), t


# --------------------------------------------------------------------------
# every tool: the card by default, no jax
# --------------------------------------------------------------------------

TOOLS = {
    "build_index": ["--binary_file", "x.code", "--out", "x.npz"],
    "search": ["--index", "x.npz", "-q", "0"],
    "linear_search": ["--binary_file", "x.code", "-q", "0"],
    "integrity_check": ["--index", "x.npz"],
    "generate_bitmap": ["--binary_file", "x.code"],
    "accuracy_test": ["--synth", "1000"],
    "accuracy_sweep": ["x.json", "1000", "8"],
    "bigann": ["--synth", "1000"],
    "profile_stages": ["--n", "1000"],
    "profile_stages2": ["--n", "1000"],
    "profile_tiers": ["--n", "1000"],
    "profile_fused_ablate": ["--n", "1000"],
    "qscale_bench": ["--n", "1000"],
    "pipeline_overlap_bench": ["--n", "1000"],
    "profile_scan": ["1000"],
    "int8_scan_bench": ["1000"],
    "gather_bench": ["--n", "1000"],
    "microbench_r5": ["--n", "1000"],
    "compact_chip_bench": ["1000", "x.json"],
    "virtual_scale_run": ["1000", "x.json", "--mesh", "1x1x1"],
}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tools_raise_without_a_card(monkeypatch, tool):
    """Given no ``--device``, a tool runs on the card, and raises before it
    touches a file where there is none."""
    import importlib
    mod = importlib.import_module(f"verticut_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(TOOLS[tool])


def test_port_and_chip_smoke_import_no_jax():
    """No line of the port or of chip_smoke.py imports jax or the JAX
    package, and importing every tool loads neither."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|verticut_tpu)\b",
                     re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "verticut_tpu_torch")):
        paths += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in paths:
        with open(path) as f:
            assert not pat.search(f.read()), path
    code = ("import sys\n"
            + "".join(f"import verticut_tpu_torch.tools.{t}\n"
                      for t in list(TOOLS) + ["_mesh", "_profile"])
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'verticut_tpu')]\n"
              "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
