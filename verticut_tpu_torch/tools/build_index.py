"""Build an MIH index from a raw binary code file on the port — the twin
of ``tools/build_index.py`` (the ``build-tables`` binary analog), with the
same flags:

    python -m verticut_tpu_torch.tools.build_index --binary_file lsh.code \
        --binary_bits 128 --ntables 4 -i 1000000 --out index.npz \
        [--native] [--bitmap] [--compact] [--mesh TxSxQ] [--device cpu]

Runs on the card unless ``--device`` names another device, and writes the
reference's ``.npz`` (either package loads it). The port builds on the
device only: ``--native`` (the reference's host C++ radix build) takes the
same device build, which is held equal to the native one, and says so.
``--mesh`` builds the compact sharded index on a (table, shard, query)
mesh (``tools/_mesh.py``: a torchrun world, else ``T*S*Q`` ranks started
here) and saves it per shard into the ``--out`` directory.
"""

import argparse
import sys
import time


def _build_sharded(mesh, path, cfg, image_total, out):
    """One rank's build and save; returns ``(n, memory_stats, build s,
    save s)``."""
    from verticut_tpu_torch.bench import sync
    from verticut_tpu_torch.codes import read_code_file
    from verticut_tpu_torch.search.sharded_compact import (
        build_sharded_compact, save_sharded_compact)
    packed = read_code_file(path, cfg.n_bytes, image_total)
    t0 = time.time()
    index = build_sharded_compact(packed, cfg, mesh)
    sync(mesh.device)
    build_s = time.time() - t0
    t0 = time.time()
    save_sharded_compact(out, index)
    return index.n, index.memory_stats(), build_s, time.time() - t0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    # flag names follow src/args_config.cc:8-17
    p.add_argument("--binary_file", required=True)
    p.add_argument("--binary_bits", type=int, default=128)
    p.add_argument("--ntables", type=int, default=4)
    p.add_argument("-i", "--image_total", type=int, default=120_000_000,
                   help="max codes to read (reference caps at 120M)")
    p.add_argument("--out", required=True, help="output .npz index path")
    p.add_argument("--native", action="store_true",
                   help="the reference's host build; the port runs its "
                        "device build, held equal to it")
    p.add_argument("--bitmap", action="store_true",
                   help="also build occupancy bitmaps")
    p.add_argument("--compact", action="store_true",
                   help="store entry ids only (no inline codes)")
    p.add_argument("--mesh", default=None, metavar="TxSxQ",
                   help="build the compact SHARDED index over a "
                        "(table, shard, query) mesh and save it per shard "
                        "to the --out DIRECTORY")
    p.add_argument("--device", default=None,
                   help="device to build on (default: the card)")
    args = p.parse_args(argv)

    from verticut_tpu_torch.bench import sync
    from verticut_tpu_torch.bits import entry_device
    from verticut_tpu_torch.codes import read_code_file
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.index import build_index, save_index
    from verticut_tpu_torch.tools import _mesh

    device = entry_device(args.device)
    cfg = MIHConfig(bits=args.binary_bits, n_tables=args.ntables)
    t0 = time.time()
    packed = read_code_file(args.binary_file, cfg.n_bytes, args.image_total)
    print(f"read {packed.shape[0]} codes in {time.time()-t0:.2f}s")

    if args.mesh:
        out = _mesh.run(_build_sharded, _mesh.parse(args.mesh), device,
                        args.binary_file, cfg, args.image_total, args.out)
        if out is None:          # not rank 0 of a torchrun world
            return
        n, st, build_s, save_s = out
        print(f"built compact sharded index over {n} codes on "
              f"{st['n_devices']} devices in {build_s:.2f}s "
              f"({st['bytes_per_code']:.1f} B/code)")
        print(f"saved per-shard to {args.out}/ in {save_s:.2f}s")
        return

    if args.native:
        print("--native: the port has no host C++ build; running its "
              "device build, which is held equal to the native one",
              file=sys.stderr)
    t0 = time.time()
    index = build_index(packed, cfg, with_bitmap=args.bitmap,
                        store_codes=not args.compact, device=device)
    sync(device)
    print(f"built {cfg.n_tables} tables over {index.n} codes "
          f"in {time.time()-t0:.2f}s")

    t0 = time.time()
    save_index(args.out, index)
    print(f"saved to {args.out} in {time.time()-t0:.2f}s")


if __name__ == "__main__":
    main()
