"""Run K-NN queries against a saved index on the port — the twin of
``tools/search.py`` (the ``run_distributed_search.py`` +
``distributed-image-search`` analog), with the same flags:

    python -m verticut_tpu_torch.tools.search --index index.npz -q 12345 -k 100
    python -m verticut_tpu_torch.tools.search --index index.npz -f q.bin -k 10 -a
    python -m verticut_tpu_torch.tools.search --index index.npz -q 0 --mesh 4x2x1

Output follows the reference's stdout contract parsed by the RPC front-end
(``image_search_server.cc:86-102``): one ``"%u : %u"`` line per result,
then the named timers ``load_index`` and ``while_loop``; the per-query
average stat line (``distributed_image_search.cc:87-93``) goes to stderr.

Runs on the card unless ``--device`` names another device. ``--mesh``
runs the inline sharded engine on a (table, shard, query) mesh
(``tools/_mesh.py``: a torchrun world, else ``T*S*Q`` ranks started
here); ``--cpu-devices N`` runs that mesh as N gloo CPU processes, N
being ``T*S*Q``.
"""

import argparse
import math
import sys


def _sharded_search(mesh, path, queries, scfg):
    """One rank's sharded build and batch; every rank reads the index's
    codes from the file."""
    import numpy as np
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.search.sharded import (build_sharded_index,
                                                   sharded_mih_search)
    with np.load(path) as z:
        cfg = MIHConfig(bits=int(z["bits"]), n_tables=int(z["n_tables"]))
        codes = z["codes"]
    sidx = build_sharded_index(codes, cfg, mesh)
    return sharded_mih_search(sidx, queries, scfg)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    # flags follow src/run_distributed_search.py:29-59
    p.add_argument("--index", required=True)
    p.add_argument("-q", "--query_id", type=int, default=None)
    p.add_argument("-f", "--query_file", default=None)
    p.add_argument("-k", "--knn", type=int, default=100)
    p.add_argument("-a", "--approximate", action="store_true")
    p.add_argument("-c", "--count", type=int, default=200,
                   help="max queries from file (reference caps at 200)")
    p.add_argument("--mesh", default=None,
                   help="TxSxQ mesh for the sharded engine, e.g. 4x1x1")
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="run the mesh as N gloo CPU processes (N = T*S*Q)")
    p.add_argument("--device", default=None,
                   help="device to search on (default: the card)")
    args = p.parse_args(argv)

    from verticut_tpu_torch import bits as bits_lib
    from verticut_tpu_torch.codes import read_code_file
    from verticut_tpu_torch.config import SearchConfig
    from verticut_tpu_torch.index import load_index
    from verticut_tpu_torch.search import mih_search
    from verticut_tpu_torch.tools import _mesh
    from verticut_tpu_torch.utils import timer

    device = bits_lib.entry_device("cpu" if args.cpu_devices
                                   else args.device)
    shape = _mesh.parse(args.mesh) if args.mesh else None
    if shape and args.cpu_devices and args.cpu_devices != math.prod(shape):
        p.error(f"--cpu-devices {args.cpu_devices} must equal the size of "
                f"--mesh {args.mesh}")
    timer.reset()          # this run's timers only
    with timer.Timer("load_index"):
        # under --mesh the ranks search on their own devices; this process
        # needs only the config and the query rows
        index = load_index(args.index, device="cpu" if shape else device)

    if args.query_file:
        queries = read_code_file(args.query_file, index.cfg.n_bytes,
                                 args.count)
    elif args.query_id is not None:
        if index.codes is None:
            p.error("index stores no codes; use -f")
        queries = index.codes[args.query_id:args.query_id + 1]
    else:
        p.error("need -q or -f")

    scfg = SearchConfig(knn=args.knn, approximate=args.approximate)
    with timer.Timer("while_loop"):  # name parity: distributed_image_search.cc:60
        if shape:
            res = _mesh.run(_sharded_search, shape, device, args.index,
                            bits_lib.to_u32(bits_lib.as_codes(queries)),
                            scfg)
            if res is None:      # not rank 0 of a torchrun world
                return
        else:
            res = mih_search(index, queries, scfg)   # host tensors

    nq = queries.shape[0]
    for row_i, row_d in zip(res.ids.tolist(), res.dists.tolist()):
        for i, d in zip(row_i, row_d):
            if i >= 0:
                print(f"{i} : {d}")
    # stat line parity: distributed_image_search.cc:87-93, the probes'
    # mean divided by nq once more as the reference tool does
    # (ROADMAP.md Queue 3)
    r = {f: getattr(res, f).numpy() for f in res._fields}
    print(f"average radius: {r['radius'].mean():.2f}, "
          f"average probes: {r['n_probes'].mean() / nq:.2f}, "
          f"average nonempty reads: {r['n_nonempty'].mean():.2f}, "
          f"average candidates: {r['n_cands'].mean():.2f}",
          file=sys.stderr)
    timer.show_all_timings()


if __name__ == "__main__":
    main()
