"""The port's evaluation tools against the JAX package's: accuracy_test
(the reference's approximate-accuracy protocol), accuracy_sweep (its
artifact) and bigann (features -> codes -> index -> recall), and the
port's copy of ``utils/io.py``.

The JAX tools run in subprocesses on the CPU (``JAX_PLATFORMS=cpu``, the
compile cache under a temporary directory), started together when the
module's first test asks for one; the port's run in this process on the
CPU (accuracy_sweep starts its own subprocesses, as the reference's
does). Held with tolerance 0: every field of accuracy_test's rows but the
times; bigann's features byte for byte, its L2 ground-truth ids, and every
recall and ratio field of its rows given the reference's codes; the
vector files byte for byte.
"""

import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax.numpy as jnp

from verticut_tpu.models.lsh import ITQEncoder as JITQEncoder
from verticut_tpu.models.lsh import encode_corpus as jax_encode_corpus
from verticut_tpu.utils import io as jio

from verticut_tpu_torch.config import MIHConfig
from verticut_tpu_torch.tools import accuracy_sweep, accuracy_test, bigann
from verticut_tpu_torch.utils import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACCURACY = {"clustered": [], "uniform": ["--uniform"],
            "clustered_loop": ["--no-fused"],
            "uniform_loop": ["--uniform", "--no-fused"]}
ACCURACY_ARGS = ["--synth", "20000", "-c", "32", "--ks", "3,100"]
#: bigann's small case: corpus, queries, k, shortlists
BIG_N, BIG_Q, BIG_K, SHORTLISTS = 20_000, 64, 10, (10, 100, 1000)
TIMES = ("exact_s", "approx_s")


def _jax_tool(tmp, tool, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               VERTICUT_JAX_CACHE=os.path.join(tmp, "jax_cache"))
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", f"{tool}.py"), *args],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """``(tmp dir, {name: future of the JAX tool's finished process})``."""
    tmp = str(tmp_path_factory.mktemp("tools_eval"))
    jobs = {f"accuracy_{k}": ("accuracy_test", ACCURACY_ARGS + v)
            for k, v in ACCURACY.items()}
    jobs["bigann"] = ("bigann", [
        "--synth", str(BIG_N), "--queries", str(BIG_Q), "--k", str(BIG_K),
        "--shortlists", ",".join(map(str, SHORTLISTS)),
        "--json", os.path.join(tmp, "jax_bigann.json")])
    with ThreadPoolExecutor(len(jobs)) as ex:
        yield tmp, {k: ex.submit(_jax_tool, tmp, *v)
                    for k, v in jobs.items()}


def _jax(jax_runs, name):
    proc = jax_runs[1][name].result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _rows(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _untimed(row):
    return {k: v for k, v in row.items() if k not in TIMES}


@pytest.fixture(scope="module")
def jax_bigann():
    """The reference tool's module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "jax_bigann_tool", os.path.join(REPO, "tools", "bigann.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------------
# accuracy_test and accuracy_sweep
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(ACCURACY))
def test_accuracy_test_matches_jax(jax_runs, capsys, case):
    want = _rows(_jax(jax_runs, f"accuracy_{case}").stdout)
    capsys.readouterr()
    accuracy_test.main(ACCURACY_ARGS + ACCURACY[case] + ["--device", "cpu"])
    got = _rows(capsys.readouterr().out)
    assert [r["k"] for r in got] == [3, 100]
    assert [_untimed(r) for r in got] == [_untimed(r) for r in want]
    assert all(r[t] >= 0 for r in got for t in TIMES)


def test_accuracy_sweep_artifact(tmp_path):
    """The sweep's artifact has the keys of the reference's
    ``ACCURACY_r05.json``, each row those of its rows, and the reference's
    artifact keeps its name: the default output is another file."""
    out = str(tmp_path / "sweep.json")
    art = accuracy_sweep.main([out, "5000", "16", "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == art
    with open(os.path.join(REPO, "ACCURACY_r05.json")) as f:
        ref = json.load(f)
    assert set(art) == set(ref)
    for corpus in ("clustered", "uniform"):
        assert [r["k"] for r in art[corpus]] == [3, 100, 500, 1000]
        for row in art[corpus]:
            assert set(row) == set(ref[corpus][0])
            assert row["queries"] == 16
    assert (art["corpus_n"], art["queries_per_k"]) == (5000, 16)
    assert "TPU" not in art["note"] and "cpu" in art["note"]
    assert accuracy_sweep.DEFAULT_OUT == "ACCURACY_torch.json"


# --------------------------------------------------------------------------
# bigann
# --------------------------------------------------------------------------

def test_synth_features_byte_equal(jax_bigann):
    for n, nq, dim, seed in [(BIG_N, BIG_Q, 128, 0), (3000, 17, 96, 5)]:
        want = jax_bigann.synth_features(n, nq, dim, seed)
        got = bigann.synth_features(n, nq, dim, seed)
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype == np.uint8
            assert a.tobytes() == b.tobytes()


def test_l2_ground_truth_matches_jax(jax_bigann):
    """Exact L2 ids on 20k x 64 queries, chunked so that the merge runs,
    and with tied distances (duplicated base rows) going to the lower
    id."""
    base, q = bigann.synth_features(BIG_N, BIG_Q, 128, 0)
    base = base.copy()
    base[7000:7040] = base[100:140]          # ties across chunks
    for k, chunk in [(10, 6000), (100, 65536)]:
        want = jax_bigann.l2_ground_truth(q, base, k, chunk=chunk)
        got = bigann.l2_ground_truth(q, base, k, "cpu", chunk=chunk)
        assert got.dtype == np.int64 and np.array_equal(got, want)


def test_evaluate_on_jax_codes_gives_jax_rows(jax_runs, jax_bigann):
    """The reference tool's pipeline up to its codes (features, ground
    truth, ITQ fit on the same sample, encode) run here in JAX; the port's
    evaluate on those codes gives every recall and ratio field of the
    reference tool's rows."""
    _jax(jax_runs, "bigann")
    with open(os.path.join(jax_runs[0], "jax_bigann.json")) as f:
        want = json.load(f)
    base_f, query_f = jax_bigann.synth_features(BIG_N, BIG_Q, 128, 0)
    gt = jax_bigann.l2_ground_truth(query_f, base_f, BIG_K)
    rng = np.random.default_rng(0)
    sample = base_f[rng.choice(BIG_N, min(50000, BIG_N), replace=False)]
    enc = JITQEncoder.fit(jnp.asarray(sample, jnp.float32), bits=128)
    base_codes = jax_encode_corpus(enc, base_f.astype(np.float32))
    query_codes = jax_encode_corpus(enc, query_f.astype(np.float32))
    ev = bigann.evaluate(base_codes, query_codes, base_f, query_f, gt,
                         MIHConfig(bits=128, n_tables=4), SHORTLISTS, "cpu")
    fields = ("shortlist", "recall_at_1", f"recall_at_{BIG_K}",
              "distance_ratio")
    assert [{f: r[f] for f in fields} for r in ev.rows] == [
        {f: r[f] for f in fields} for r in want["sweep"]]
    assert set(ev.rows[0]) == set(want["sweep"][0])
    assert ev.rows[-1]["recall_at_1"] == 1.0     # R = 1000 holds every gt
    assert sorted(ev.results) == list(SHORTLISTS)


def test_bigann_main_end_to_end(jax_runs, tmp_path, capsys):
    """The port's whole pipeline on the CPU (its own ITQ fit): the
    reference tool's artifact keys and printed lines, and the shortlist
    that holds the whole ground truth recalls all of it."""
    _jax(jax_runs, "bigann")
    with open(os.path.join(jax_runs[0], "jax_bigann.json")) as f:
        want = json.load(f)
    out = str(tmp_path / "bigann.json")
    ev = bigann.main(["--synth", str(BIG_N), "--queries", str(BIG_Q),
                      "--k", str(BIG_K), "--shortlists",
                      ",".join(map(str, SHORTLISTS)), "--json", out,
                      "--device", "cpu"])
    with open(out) as f:
        art = json.load(f)
    assert set(art) == set(want)
    assert [set(r) for r in art["sweep"]] == [set(r) for r in want["sweep"]]
    assert art["sweep"] == ev.rows and art["sweep"][-1]["recall_at_10"] == 1.0
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 4 * len(SHORTLISTS)
    assert printed[0] == (f"recall@1 (shortlist 10): "
                          f"{art['sweep'][0]['recall_at_1']:.4f}")


# --------------------------------------------------------------------------
# utils/io
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,dtype", [("bvecs", np.uint8),
                                        ("fvecs", np.float32),
                                        ("ivecs", np.int32)])
def test_vecs_round_trip_byte_equal(tmp_path, kind, dtype):
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 256, (57, 24)) if kind == "bvecs"
         else rng.normal(0, 100, (57, 24))).astype(dtype)
    a, b = str(tmp_path / f"port.{kind}"), str(tmp_path / f"jax.{kind}")
    tio.write_vecs(a, x)
    jio.write_vecs(b, x)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for reader in (tio.read_vecs, jio.read_vecs):
        assert np.array_equal(reader(a), x)
    for kw in ({"max_rows": 10}, {"offset_rows": 50}, {"max_rows": 3,
                                                       "offset_rows": 4}):
        got, want = tio.read_vecs(a, **kw), jio.read_vecs(b, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError):
        tio.read_vecs(str(tmp_path / "x.npy"))
