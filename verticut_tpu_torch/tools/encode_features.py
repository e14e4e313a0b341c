"""Encode float feature vectors into binary codes, on the port's encoders
— the twin of ``tools/encode_features.py``, with the same flags:

    python -m verticut_tpu_torch.tools.encode_features --features feats.npy \
        --bits 128 --method itq --out lsh.code [--train_sample 20000] \
        [--device cpu]

Runs on the card unless ``--device`` names another device, and writes the
reference's raw code file (``4 * bits / 32`` bytes per row).
"""

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--features", required=True, help=".npy float [N, D]")
    p.add_argument("--bits", type=int, default=128)
    p.add_argument("--method", choices=["lsh", "itq"], default="itq")
    p.add_argument("--train_sample", type=int, default=20000)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True, help="raw code file (16B rows)")
    p.add_argument("--device", default=None,
                   help="device to encode on (default: the card)")
    args = p.parse_args(argv)

    import numpy as np
    from verticut_tpu_torch.bits import entry_device
    from verticut_tpu_torch.models import ITQEncoder, RandomProjectionLSH
    from verticut_tpu_torch.models.lsh import encode_corpus, write_code_file

    device = entry_device(args.device)
    x = np.load(args.features, mmap_mode="r")
    print(f"features: {x.shape} {x.dtype}")
    t0 = time.time()
    if args.method == "lsh":
        enc = RandomProjectionLSH.create(x.shape[1], args.bits, args.seed,
                                         device=device)
    else:
        sample = np.asarray(x[:args.train_sample], np.float32)
        enc = ITQEncoder.fit(sample, args.bits, args.iters, args.seed,
                             device=device)
    print(f"encoder ready in {time.time()-t0:.2f}s")
    t0 = time.time()
    packed = encode_corpus(enc, np.asarray(x, np.float32))
    write_code_file(args.out, packed)
    print(f"encoded {packed.shape[0]} codes -> {args.out} "
          f"in {time.time()-t0:.2f}s")


if __name__ == "__main__":
    main()
