"""KV store load/latency harness — the ``Pilaf/loadtest.cc`` +
``ploadtest/ploadtest.cc`` analog: mixed get/put workloads against any
backend, with latency percentiles and a middle-window throughput figure
(the reference measures the middle fifth of ops to exclude warmup,
``dht-test.cc:343-344``). The port's twin of ``tools/kv_loadtest.py``,
with the same flags and output over the port's ``kv`` layer:

    python -m verticut_tpu_torch.tools.kv_loadtest --backend dht \
        [--read_mode direct|server] [--n_shards N] [-n OPS]

For the same arguments the ``stats:`` line of the ``dht`` backend equals
the JAX tool's: the same operations reach the same native store.
"""

import argparse
import json
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--backend", default="dht",
                   choices=["dht", "memory", "pilaf", "memcached", "redis"])
    p.add_argument("--read_mode", default="direct",
                   choices=["direct", "server"],
                   help="direct = in-process store access (the one-sided "
                        "RDMA-READ analog: the reader touches the table "
                        "without a server round trip); server = every op "
                        "goes through a spawned KVServer over TCP (the "
                        "server-mediated read path). Mirrors the "
                        "reference's -r read_mode experiment "
                        "(Pilaf/store-client.h:16-19, "
                        "src/args_config.cc:8-17). Only meaningful for "
                        "in-process backends (dht/memory).")
    p.add_argument("--n_shards", type=int, default=1)
    p.add_argument("-n", "--ops", type=int, default=100_000)
    p.add_argument("--get_ratio", type=float, default=0.9)
    p.add_argument("--key_space", type=int, default=10_000)
    p.add_argument("--val_len", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import numpy as np
    from verticut_tpu_torch.kv import make_store

    rng = np.random.default_rng(args.seed)
    server = None
    if args.read_mode == "server":
        # server-mediated path: the SAME backing store, behind a local
        # KVServer; the client pays one TCP round trip per op — the
        # read_mode=server arm of the reference's RDMA-vs-server
        # comparison, collapsed onto loopback
        from verticut_tpu_torch.kv.remote import KVServer, RedisKV
        backing = make_store(args.backend, n_shards=args.n_shards)
        server = KVServer(store=backing).start()
        store = RedisKV(port=server.port)
    else:
        store = make_store(args.backend, n_shards=args.n_shards)
    val = bytes(rng.integers(0, 256, args.val_len, dtype=np.uint8))

    # preload
    for i in range(args.key_space):
        store.put(f"key-{i}".encode(), val)

    keys = [f"key-{int(k)}".encode()
            for k in rng.integers(0, args.key_space, args.ops)]
    is_get = rng.random(args.ops) < args.get_ratio
    lat = np.empty(args.ops)
    t_all0 = time.perf_counter()
    for i, key in enumerate(keys):
        t0 = time.perf_counter()
        if is_get[i]:
            store.get(key)
        else:
            store.put(key, val)
        lat[i] = time.perf_counter() - t0
    wall = time.perf_counter() - t_all0

    # middle-fifth window throughput
    lo, hi = 2 * args.ops // 5, 3 * args.ops // 5
    mid_s = lat[lo:hi].sum()
    print(f"backend={args.backend} read_mode={args.read_mode} "
          f"shards={args.n_shards} ops={args.ops} "
          f"get_ratio={args.get_ratio}")
    print(f"throughput: {args.ops/wall:,.0f} ops/s "
          f"(middle fifth: {(hi-lo)/mid_s:,.0f} ops/s)")
    for q in (50, 90, 99, 99.9):
        print(f"p{q}: {np.percentile(lat, q)*1e6:.2f} us")
    if hasattr(store, "stats"):
        print("stats:", store.stats())
    print(json.dumps({
        "metric": "kv_loadtest", "backend": args.backend,
        "read_mode": args.read_mode, "shards": args.n_shards,
        "ops": args.ops, "get_ratio": args.get_ratio,
        "val_len": args.val_len,
        "ops_per_s": round(args.ops / wall, 1),
        "mid_fifth_ops_per_s": round((hi - lo) / mid_s, 1),
        "p50_us": round(float(np.percentile(lat, 50)) * 1e6, 2),
        "p99_us": round(float(np.percentile(lat, 99)) * 1e6, 2),
    }))
    store.close()
    if server is not None:
        server.stop()


if __name__ == "__main__":
    main()
