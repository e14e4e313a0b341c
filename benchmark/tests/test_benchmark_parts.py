"""The yardstick's parts on their own: the reference, the comparison,
the generators, the roofline arithmetic and the trace reduction."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, gen, roofline, trace
from benchmark.references import hamming_topk as ref

CPU = torch.device("cpu")


def popcount_np(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


@pytest.mark.parametrize("n,k,words", [(3000, 10, 4), (700, 100, 4),
                                       (500, 7, 2)])
def test_reference_is_brute_force_with_ties_to_the_smaller_id(n, k, words):
    g = gen.generator(5, CPU)
    corpus = gen.random_words(g, (n, words), CPU)
    corpus[n // 2:] = corpus[: n - n // 2]          # many exact ties
    queries = gen.random_words(g, (40, words), CPU)
    d, i = ref.topk(queries, corpus, k)
    c, q = corpus.numpy().view(np.uint32), queries.numpy().view(np.uint32)
    dist = popcount_np(c[None, :, :] ^ q[:, None, :])      # [40, n]
    order = np.lexsort((np.broadcast_to(np.arange(n), dist.shape), dist))
    want_i = order[:, :k]
    assert np.array_equal(i.numpy(), want_i)
    assert np.array_equal(d.numpy(), np.take_along_axis(dist, want_i, 1))
    assert torch.equal(ref.hamming(corpus[i.long()], queries[:, None, :]), d)


def judged(d, ids, rd, ri, true_d=None, n=100, boundary=True):
    t = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    return check.judge(t(d), t(ids), t(rd), t(ri),
                       t(true_d if true_d is not None else d), n, boundary)


def test_judge_holds_the_guarantee():
    rd, ri = [1, 2, 2, 5, 5], [7, 3, 9, 1, 4]
    assert judged(rd, ri, rd, ri) is None
    assert judged(rd, ri, rd, ri, boundary=False) is None
    # other codes at the k-th distance, ascending, at that distance: open
    # on a boundary row only
    assert judged(rd, [7, 3, 9, 2, 8], rd, ri) is None
    assert judged(rd, [7, 3, 9, 2, 8], rd, ri, boundary=False) == "ids"
    assert judged(rd, [7, 3, 9, 4, 1], rd, ri, boundary=False) == "ids"
    assert judged([1, 2, 2, 5, 6], ri, rd, ri) == "dists"
    assert judged([1, 2, 2, 5, 6], ri, rd, ri, boundary=False) == "dists"
    assert judged(rd, [7, 9, 3, 1, 4], rd, ri) == "ids"     # order below k-th
    assert judged(rd, [7, 3, 8, 1, 4], rd, ri) == "ids"     # missing closer
    assert judged(rd, [7, 3, 9, 4, 1], rd, ri) == "ids"     # k-th unsorted
    assert judged(rd, [7, 3, 9, 4, 4], rd, ri) == "ids"     # repeated
    assert judged(rd, [7, 3, 9, 1, 100], rd, ri) == "ids"   # out of range
    assert judged(rd, [7, 3, 9, 1, 8], rd, ri,
                  true_d=[1, 2, 2, 5, 6]) == "ids"          # wrong distance


def test_generators_repeat_from_the_seed():
    a = gen.clustered(11, 5000, 128, 200, 0.02, CPU)
    assert torch.equal(a, gen.clustered(11, 5000, 128, 200, 0.02, CPU))
    assert not torch.equal(a, gen.clustered(12, 5000, 128, 200, 0.02, CPU))
    traffic = {"kind": "perturbed", "n_flips": 3}
    b = gen.batch(traffic, 9, 4, a, 300)
    assert torch.equal(b, gen.batch(traffic, 9, 4, a, 300))
    assert not torch.equal(b, gen.batch(traffic, 9, 5, a, 300))
    # every query lies within 3 bits of some corpus row
    d, _ = ref.topk(b, a, 1)
    assert int(d.max()) <= 3 and int((d == 3).sum()) > 200
    u = gen.batch({"kind": "uniform"}, 9, 4, a, 300)
    bits = ((u[..., None] >> torch.arange(32, dtype=torch.int32)) & 1)
    assert abs(float(bits.float().mean()) - 0.5) < 0.01
    assert gen.derive(2**31 + 5, 1, 2) != gen.derive(2**31 + 6, 1, 2)
    with pytest.raises(ValueError):
        gen.batch({"kind": "zipf"}, 9, 4, a, 10)


def test_clustered_codes_sit_near_their_centres():
    a = gen.clustered(3, 20000, 128, 200, 0.02, CPU)
    d, _ = ref.topk(a[:200], a, 2)
    # a row's nearest other row lies in its cluster, a few bits away, where
    # uniform codes would lie ~40 bits apart
    assert 0.5 <= float(d[:, 1].float().mean()) <= 8


def test_roofline_of_the_blockmin_scan():
    w = roofline.hamming_blockmin(8192, 100_000_000, 128, 512)
    assert w["int8_ops"] == 2 * 8192 * 100_000_000 * 128
    assert w["bytes"] == (8192 + 100_000_000) * 16 + 4 * 8192 * 195313
    s, by = roofline.bound_s(w, "NVIDIA H100 80GB HBM3")
    assert by == "int8_ops" and s == pytest.approx(0.10597, rel=1e-3)
    with pytest.raises(KeyError):
        roofline.peaks("a card without published peaks")


class Ev:
    def __init__(self, name, start, dur, cuda, tid=1):
        self._n, self._s, self._d, self._c, self._t = name, start, dur, cuda, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        dt = torch.autograd.DeviceType
        return dt.CUDA if self._c else dt.CPU

    def start_thread_id(self):
        return self._t


def test_trace_reduction():
    ms = 1_000_000
    events = [Ev("kernA", 0, 2 * ms, True), Ev("kernB", 1 * ms, 2 * ms, True),
              Ev("Memcpy HtoD", 5 * ms, 1 * ms, True),
              Ev("kernA", 8 * ms, 4 * ms, True),            # clipped at 10
              Ev("aten::item", 2 * ms, 3 * ms, False),
              Ev("cudaLaunchKernel", 3 * ms, ms // 2, False),
              Ev("cudaLaunchKernel", 8 * ms + ms // 2, ms // 2, False),
              Ev("other thread", 0, 10 * ms, False, tid=2)]
    t = trace.reduce(events, 0, 10 * ms, batches=2)
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.003 + 0.001 + 0.002)
    assert t.launches == 3
    assert t.idle_share == pytest.approx(0.4)
    ops = dict(t.device_ops)
    assert ops["kernA"] == pytest.approx(0.004)
    gaps = dict(t.idle_gaps)
    # 3-5 ms: at its middle (4) inside aten::item, past the launch; 6-8 ms:
    # no operator
    assert gaps["aten::item"] == pytest.approx(0.002)
    assert gaps[trace.OUTSIDE] == pytest.approx(0.002)
    assert sum(gaps.values()) == pytest.approx(0.004)


def test_a_collective_counts_once():
    """The profiler records an NCCL collective twice on the card: an
    ``nccl:<op>`` range and the kernel under it. The range is busy time;
    only the kernel is an operation and a launch."""
    ms = 1_000_000
    kern = "ncclDevKernel_AllGather_RING_LL"
    t = trace.reduce([Ev("nccl:all_gather", 0, 3 * ms, True),
                      Ev(kern, ms, 2 * ms, True)], 0, 10 * ms, batches=1)
    assert t.launches == 1
    assert t.device_ops == [[kern, pytest.approx(0.002)]]
    assert t.busy_s == pytest.approx(0.003)


def test_keeper_draws_each_stratum():
    k, m = 3, 4
    res = SimpleNamespace(
        dists=torch.tensor([[0, 1, 2], [5, 8, 9], [1, 2, 8], [0, 0, 0]],
                           dtype=torch.int32),
        ids=torch.arange(12, dtype=torch.int32).reshape(4, 3),
        radius=torch.tensor([0, 1, 1, 0], dtype=torch.int32))
    keeper = check.Keeper(seed=1, k=k, n_tables=m)
    keeper.take(0, res)
    assert {r for _, r, *_ in keeper.rows["tier"]} == {1}
    assert {r for _, r, *_ in keeper.rows["boundary"]} == {2}
    assert len(keeper.rows["random"]) == 4
    # the boundary flag travels with a row of any stratum
    assert {r for _, r, _, _, b in keeper.rows["random"] if b} == {2}
    assert not any(b for *_, b in keeper.rows["tier"])
    sample = keeper.sample()
    assert len({(i, r) for i, r, *_ in sample}) == len(sample) == 4
