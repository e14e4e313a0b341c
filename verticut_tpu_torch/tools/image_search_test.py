"""RPC load generator on the port — the twin of ``tools/image_search_test.py``
(the ``image-search-test`` binary analog): sequential and concurrent
(thread-per-query) throughput against a running image server, with
per-request latency percentiles (p50/p90/p99).

    python -m verticut_tpu_torch.tools.image_search_test [-p PORT] [-t N]
    python -m verticut_tpu_torch.tools.image_search_test --selfbuild N \\
        [--device cpu]

``--selfbuild N`` makes the run self-contained: build the benchmark's
N-code clustered index (``bench.make_index``) on the card (on ``--device``
if given), start the in-process server, run the sequential and threaded
loads, and print one JSON line: the reference's fields, with ``device``
the card's name and ``nvidia_smi`` its ``name, power.limit`` line.
"""

import argparse
import json
import sys
import threading
import time


def run_load(cli, qids, knn, threads):
    """Run one load; returns (wall_s, sorted per-request latencies,
    {query id: result})."""
    lats, results = [], {}
    lock = threading.Lock()

    def one(qid):
        t0 = time.perf_counter()
        r = cli.search_image_by_id(qid, knn)
        dt = time.perf_counter() - t0
        if not r:
            raise RuntimeError(f"empty result for {qid}")
        with lock:
            lats.append(dt)
            results[qid] = r

    t0 = time.time()
    if threads <= 1:
        for qid in qids:
            one(qid)
    else:
        errs = []

        def worker(chunk):
            try:
                for qid in chunk:
                    one(qid)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        per = (len(qids) + threads - 1) // threads
        ts = [threading.Thread(target=worker,
                               args=(qids[i * per:(i + 1) * per],))
              for i in range(threads)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        if errs:
            raise errs[0]
    return time.time() - t0, sorted(lats), results


def pcts(lats):
    if not lats:
        return {}
    return {p: round(lats[min(len(lats) - 1, int(len(lats) * p / 100))] * 1e3,
                     2)
            for p in (50, 90, 99)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("-p", "--port", type=int, default=9191)
    p.add_argument("-n", "--num", type=int, default=100)
    p.add_argument("-k", "--knn", type=int, default=10)
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="0 = sequential; else concurrent thread count")
    p.add_argument("--query_id_file", default=None,
                   help="file of query ids, one per line")
    p.add_argument("--selfbuild", type=int, default=0, metavar="N",
                   help="build an N-code index + in-process server, then "
                        "run sequential AND threaded loads (one artifact)")
    p.add_argument("--device", default=None,
                   help="with --selfbuild: the device to build and serve "
                        "on (default: the card)")
    args = p.parse_args(argv)

    server = None
    if args.selfbuild:
        from verticut_tpu_torch import bench, bits
        from verticut_tpu_torch.service import ImageSearchServer
        device = bits.entry_device(args.device)
        print(f"selfbuild: {args.selfbuild} codes on {device}",
              file=sys.stderr, flush=True)
        index, _ = bench.make_index(args.selfbuild, device)
        server = ImageSearchServer(index, port=0,
                                   default_knn=args.knn).start()
        print("selfbuild: prewarming shape buckets", file=sys.stderr,
              flush=True)
        # run the batch buckets this load can reach (<= 2x peak
        # concurrency), and build the kernels, before taking any
        server.prewarm(max_rows=128)
        args.port = server.port
        card = (bench.card() if device.type == "cuda"
                else {"device": str(device), "nvidia_smi": None})

    from verticut_tpu_torch.service import ImageSearchClient

    cli = ImageSearchClient(host=args.host, port=args.port)
    if cli.ping() != "pong":
        raise RuntimeError("the server did not answer ping")
    if args.query_id_file:
        with open(args.query_id_file) as f:
            qids = [int(line) for line in f if line.strip()][:args.num]
    else:
        qids = list(range(args.num))

    if args.selfbuild:
        # one artifact: warm-up of the sequential and threaded arrival
        # shapes, then the sequential and threaded rows
        run_load(cli, qids[:8], args.knn, 0)
        for th in (16, 64):
            run_load(cli, qids[:2 * th], args.knn, th)
        rows = {}
        for name, th in (("sequential", 0), ("threads16", 16),
                         ("threads64", 64)):
            dt, lats, _ = run_load(cli, qids, args.knn, th)
            rows[name] = {"qps": round(len(qids) / dt, 1),
                          "latency_ms": pcts(lats)}
            print(f"{name}: {rows[name]}", file=sys.stderr, flush=True)
        print(json.dumps({
            "metric": "serving_rpc", "n_codes": args.selfbuild,
            "knn": args.knn, "n_queries": len(qids), **card, **rows}))
        cli.close()
        server.stop()
        return

    dt, lats, _ = run_load(cli, qids, args.knn, args.threads)
    mode = "seq" if args.threads <= 1 else f"{args.threads} threads"
    print(f"{len(qids)} queries in {dt:.3f}s -> {len(qids)/dt:.1f} qps "
          f"({mode}) p50/p90/p99 ms: {pcts(lats)}")


if __name__ == "__main__":
    main()
