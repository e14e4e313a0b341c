"""Post-build index validation on the port — the twin of
``tools/integrity_check.py`` (the ``integrity-check`` binary analog,
``src/integrity_check.cc:37-70``), with the same flags:

    python -m verticut_tpu_torch.tools.integrity_check --index index.npz
    python -m verticut_tpu_torch.tools.integrity_check --synthetic 100000000

``--index PATH`` checks a saved index (either package's ``.npz``);
``--synthetic N`` generates the bench corpus (clustered codes) on the
device, builds it as the reference tool does (inline rows up to 10 GiB,
range directories, flat id columns below 20M codes) and checks it. The
check (``index/integrity.py``) recomputes every table's sort on the device
and compares every stored array. Prints one JSON report; a bad index
prints ``INTEGRITY FAIL`` on stderr and exits 1. Runs on the card unless
``--device`` names another device.
"""

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--index", help="saved index (.npz)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="device-build a clustered N-code index and check it")
    p.add_argument("--bits", type=int, default=128)
    p.add_argument("--ntables", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="device to build and check on (default: the card)")
    args = p.parse_args(argv)

    from verticut_tpu_torch.bench import sync
    from verticut_tpu_torch.bits import entry_device
    from verticut_tpu_torch.codes import clustered_codes_device
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.index import build_index, load_index
    from verticut_tpu_torch.index.integrity import check_index

    device = entry_device(args.device)
    if not args.index and not args.synthetic:
        p.error("need --index or --synthetic")
    t0 = time.time()
    if args.synthetic:
        n = args.synthetic
        cfg = MIHConfig(bits=args.bits, n_tables=args.ntables)
        codes_dev = clustered_codes_device(
            0, n, cfg.bits, n_clusters=max(2, n // 200), flip_p=0.02,
            device=device)
        inline = n * 21 * cfg.n_tables <= 10 * (1 << 30)
        index = build_index(codes_dev, cfg, store_codes=inline,
                            directory="range",
                            keep_entry_ids=n < 20_000_000)
        sync(device)
        build_s = time.time() - t0
        print(f"built {n} codes in {build_s:.1f}s", file=sys.stderr)
    else:
        index = load_index(args.index, device=device)
        build_s = None
        if index.codes is None:
            p.error("index stores no code array")

    t0 = time.time()
    report = check_index(index)     # its counts are host ints: synced
    report["check_s"] = round(time.time() - t0, 2)
    if build_s is not None:
        report["build_s"] = round(build_s, 2)
    report["metric"] = "integrity_check"
    print(json.dumps(report))
    if not report["ok"]:
        print("INTEGRITY FAIL", file=sys.stderr)
        sys.exit(1)
    print(f"integrity OK ({report['check_s']}s)", file=sys.stderr)


if __name__ == "__main__":
    main()
