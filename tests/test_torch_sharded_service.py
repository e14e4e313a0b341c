"""The port's server on a sharded index (``sharded=True``): in a world of
one, in a gloo world of 8 on a (4, 2, 1) mesh where rank 0 serves and
ranks 1-7 follow its broadcasts, and in a world of 3 on a (1, 1, 3) mesh,
whose query axis divides no power-of-two batch. 16 client threads of
``search_image_by_id``, one ``search_batch`` and one ``search_by_code``
are served; every answer equals ``sharded_mih_search`` on the same rows
(tolerance 0), and every follower joined every batch the server ran. A
request with ``knn`` 0 is refused, a batch that fails on every rank after
its broadcast is answered with its error, and the world serves the next
request."""

import pytest

import torch_world_cases as cases
from verticut_tpu_torch.parallel.world import spawn


@pytest.mark.parametrize("shape", [(1, 1, 1), (4, 2, 1), (1, 1, 3)])
def test_sharded_server_answers_equal_sharded_search(shape):
    n = shape[0] * shape[1] * shape[2]
    out = spawn(cases.run_server, n, shape, device="cpu", threads=1)
    got = out[0]
    assert got["got_ids"] == got["want_ids"]
    assert got["got_batch"] == got["want_batch"]
    assert got["got_code"] == got["want_ids"][3]
    assert "knn 0 outside" in got["bad_rpc"], got["bad_rpc"]
    assert "batch worker failed" in got["bad_batch"], got["bad_batch"]
    assert got["got_after"] == got["want_ids"][1]
    # every follower joined every batch the server ran
    assert all(f == got["n_batches"] for f in out[1:]), out[1:]
    assert got["n_batches"] >= 3


def test_single_device_mesh_removes_its_store():
    """A world of one started by ``single_device_mesh`` rendezvouses
    through a file store in a temporary directory, which ``close_world``
    removes."""
    got = spawn(cases.run_own_world_of_one, 1, device="cpu", threads=1)[0]
    assert got["shape"] == {"table": 1, "shard": 1, "query": 1}
    assert got["coords"] == (0, 0, 0) and got["backend"] == "gloo"
    assert got["during"] and not got["after"]
