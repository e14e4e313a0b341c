"""Run the reference accuracy protocol on the port (clustered + uniform
corpora, the k sweep of ``src/test_approximate_accuracy.py:12``) and wrap
the rows into one artifact JSON, the shape of the JAX package's
``ACCURACY_r{N}.json`` — the twin of ``tools/accuracy_sweep.py``:

    python -m verticut_tpu_torch.tools.accuracy_sweep [out.json] [N] [count] \
        [--device cpu]

Each corpus runs ``python -m verticut_tpu_torch.tools.accuracy_test`` in
a subprocess, on the card unless ``--device`` names another device. The
artifact goes to ``ACCURACY_torch.json`` by default: the reference's own
artifacts keep their names.
"""

import argparse
import json
import os
import subprocess
import sys

#: the root of the checkout holding the package
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = "ACCURACY_torch.json"


def sweep(uniform: bool, n: int, count: int, device: str):
    cmd = [sys.executable, "-m", "verticut_tpu_torch.tools.accuracy_test",
           "--synth", str(n), "-c", str(count), "--device", device]
    if uniform:
        cmd.append("--uniform")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=2400,
                         cwd=REPO)
    if out.returncode != 0:
        print(out.stderr[-2000:], file=sys.stderr)
        raise SystemExit(f"sweep uniform={uniform} failed rc={out.returncode}")
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    for r in rows:
        print(f"uniform={uniform} k={r['k']} exact={r['exact_s']}s "
              f"approx={r['approx_s']}s acc={r['accuracy']}",
              file=sys.stderr, flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out", nargs="?", default=DEFAULT_OUT)
    p.add_argument("n", nargs="?", type=int, default=1_000_000)
    p.add_argument("count", nargs="?", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="device to search on (default: the card)")
    args = p.parse_args(argv)

    from verticut_tpu_torch.bits import entry_device

    device = entry_device(args.device)
    if device.type == "cuda":
        from verticut_tpu_torch.bench import card
        where = card()["nvidia_smi"]
    else:
        where = str(device)
    art = {
        "round": None,   # the reference numbers its artifacts by round
        "protocol": "src/accuracy_test.cc:72-135 metrics over "
                    "src/test_approximate_accuracy.py:12 k-sweep",
        "corpus_n": args.n,
        "queries_per_k": args.count,
        "bits": 128,
        "n_tables": 4,
        "note": "queries drawn from the corpus; approx = k*20 pool "
                "early-stop (search_worker.h:14) with the reference's "
                "approx_exact_crossover: pools wider than 1024 run the "
                "exact engine; times are warm batched seconds for all "
                f"queries on {where} (verticut_tpu_torch); accuracy = "
                "fraction of approx results within the exact max distance",
        "clustered": sweep(False, args.n, args.count, str(device)),
        "uniform": sweep(True, args.n, args.count, str(device)),
    }
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1)
    print("wrote", args.out)
    return art


if __name__ == "__main__":
    main()
