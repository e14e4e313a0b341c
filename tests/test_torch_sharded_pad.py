"""Both sharded engines on corpora that their builds pad, against brute
force on the unpadded corpus: the JAX package's single-device
``linear_search``, itself held equal to ``reference_model.brute_force``.

The inline build pads the corpus with all-zero codes to a multiple of
n_shards * 200 rows, the compact build to one of 128 rows per rank. A
query near the zero code (the zero code itself, codes with 1 to 8 set
bits) is nearer to those pads than to any real row, so a scan tier that
let a pad into a rank's top k would lose real candidates. The port runs
in one gloo world of 8 CPU processes (``torch_world_cases.run_pad``), on
the meshes (1, 2, 1) and (4, 2, 1), including ranks with fewer than k
real rows and ranks with none. Held (tolerance 0): ``sharded_linear_search``
equal to brute force in dists and ids; ``sharded_mih_search`` and
``sharded_compact_search`` under both drivers equal in dists, in ids below
each row's kth distance, and every id at its returned distance (the
reference's stop rule may keep other ids at the kth distance, ROADMAP.md
Queue 3), and so is the sharded server's answer; every rank of a mesh
returning the same result. The JAX
package's sharded scan masks the pads only after its top k, and is pinned
to differ from brute force on one case.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax.numpy as jnp

from verticut_tpu.config import MIHConfig as JMIHConfig
from verticut_tpu.parallel import make_mesh as jax_make_mesh
from verticut_tpu.search.sharded import build_sharded_index as jax_build
from verticut_tpu.search import linear_search as jax_linear_search
from verticut_tpu.search.sharded import sharded_linear_search as jax_lin

import reference_model as ref
import torch_world_cases as cases
from verticut_tpu_torch.parallel.world import spawn


@pytest.fixture(scope="module")
def world():
    """The port's results, computed in a world of 8 while the tests run."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(spawn, cases.run_pad, 8, device="cpu", threads=1)


def port_case(world, name, entry):
    """The case's result at one entry point, after checking that every
    rank of its mesh returned the same one."""
    got = [r[name][entry] for r in world.result() if r[name] is not None]
    assert got, name
    for other in got[1:]:
        for f, v in got[0].items():
            assert np.array_equal(other[f], v), (name, entry, f)
    return got[0]


def brute_force(db, q, k):
    """The exact top k over the unpadded corpus, ties to the lower id:
    the JAX package's single-device scan, checked against the numpy
    model."""
    d, i = jax_linear_search(jnp.asarray(q), jnp.asarray(db), k,
                             method="popcount")
    d, i = np.asarray(d), np.asarray(i)
    rd, ri = ref.brute_force(q.view(np.uint8), db.view(np.uint8), k)
    assert np.array_equal(d, rd) and np.array_equal(i, ri)
    return d, i


def true_dists(db, q, ids):
    """Hamming distance from each query to each of its ids, in numpy."""
    x = db[ids.astype(np.int64)] ^ q[:, None, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


@pytest.mark.parametrize("entry", cases.PAD_ENTRIES)
@pytest.mark.parametrize("name", [c[0] for c in cases.PAD_CASES])
def test_padded_corpus_equals_brute_force(world, name, entry):
    _, _, _, n, k = next(c for c in cases.PAD_CASES if c[0] == name)
    db, q = cases.pad_db(n)
    got = port_case(world, name, entry)
    ld, li = brute_force(db, q, k)
    assert np.array_equal(got["dists"], ld)
    assert (got["ids"] >= 0).all() and (got["ids"] < n).all()
    if entry == "linear":
        assert np.array_equal(got["ids"], li)
        return
    below = ld < ld[:, -1:]
    assert np.array_equal(np.where(below, got["ids"], -1),
                          np.where(below, li, -1))
    assert np.array_equal(true_dists(db, q, got["ids"]), got["dists"])


def test_sharded_server_on_a_padded_corpus(world):
    """The server's ``sharded=True`` branch on the (4, 2, 1) mesh at
    n = 1001: the ``search_batch`` answer to the 16 queries equals brute
    force as the engine's answers do."""
    db, q = cases.pad_db(1001)
    got = world.result()[0]["server"]
    assert all(r["server"] is None for r in world.result()[1:])
    ids = np.array([[i for i, _ in row] for row in got])
    dists = np.array([[d for _, d in row] for row in got])
    ld, li = brute_force(db, q, 10)
    assert np.array_equal(dists, ld)
    below = ld < ld[:, -1:]
    assert np.array_equal(np.where(below, ids, -1), np.where(below, li, -1))


def test_reference_scan_lets_pads_take_real_rows_slots(world):
    """The JAX package's sharded scan, on the (1, 2, 1) mesh at n = 1000,
    takes its top k over each rank's slice pads included and masks the
    pads after it: every near-zero row comes back with other dists than
    brute force finds (ROADMAP.md Queue 3). The port's answer on the same
    case equals brute force."""
    db, q = cases.pad_db(1000)
    mesh = jax_make_mesh(1, 2, 1)
    idx = jax_build(db, JMIHConfig(bits=128, n_tables=4), mesh)
    jd, _ = jax_lin(mesh, idx.codes, jnp.asarray(q), 10, n_total=idx.n)
    ld, li = brute_force(db, q, 10)
    assert (np.asarray(jd) != ld).any(-1)[:9].all()
    got = port_case(world, "inline_1000_121", "linear")
    assert np.array_equal(got["dists"], ld)
    assert np.array_equal(got["ids"], li)
