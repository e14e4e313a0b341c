"""Brute-force ground-truth scan on the port — the twin of
``tools/linear_search.py`` (the ``linear-search`` binary analog,
``src/linear_search.cc:39-64``), with the same flags and methods:

    python -m verticut_tpu_torch.tools.linear_search --binary_file lsh.code \
        -q 12345 -k 10 [--method popcount|matmul] [--device cpu]

Prints one ``"id : dist"`` line per result and the scan's seconds on
stderr. Runs on the card unless ``--device`` names another device.
"""

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--binary_file", required=True)
    p.add_argument("--binary_bits", type=int, default=128)
    p.add_argument("-i", "--image_total", type=int, default=120_000_000)
    p.add_argument("-q", "--query_id", type=int, required=True)
    p.add_argument("-k", "--knn", type=int, default=10)
    p.add_argument("--method", choices=["popcount", "matmul"],
                   default="popcount")
    p.add_argument("--device", default=None,
                   help="device to scan on (default: the card)")
    args = p.parse_args(argv)

    from verticut_tpu_torch.bench import sync
    from verticut_tpu_torch.bits import as_codes, entry_device
    from verticut_tpu_torch.codes import read_code_file
    from verticut_tpu_torch.search import linear_search

    device = entry_device(args.device)
    packed = read_code_file(args.binary_file, args.binary_bits // 8,
                            args.image_total)
    db = as_codes(packed, device)
    q = db[args.query_id:args.query_id + 1]
    t0 = time.time()
    d, i = linear_search(q, db, args.knn, method=args.method)
    sync(device)
    dt = time.time() - t0
    for idx, dist in zip(i[0].tolist(), d[0].tolist()):
        if idx >= 0:
            print(f"{idx} : {dist}")
    print(f"scan of {packed.shape[0]} codes in {dt:.3f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
