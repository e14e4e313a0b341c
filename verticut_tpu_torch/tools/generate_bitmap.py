"""Build bucket-occupancy bitmap files on the port — the twin of
``tools/generate_bitmap.py`` (the ``generate-bitmap`` binary analog,
``src/generate_bitmap.cc:84-125``), with the same flags:

    python -m verticut_tpu_torch.tools.generate_bitmap --binary_file lsh.code \
        --binary_bits 128 --ntables 8 --out_prefix bitmap [--device cpu]

Writes one raw file per table, ``{out_prefix}.{t}``: the table's bitmap
words (``index/bitmap.build_bitmap`` of its sorted substrings) as
little-endian uint32, the bytes of the reference's ``native.build_bitmap``.
A file holds ``2^s_bits / 8`` bytes: 512 MiB at 32-bit substrings. Runs
on the card unless ``--device`` names another device.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--binary_file", required=True)
    p.add_argument("--binary_bits", type=int, default=128)
    p.add_argument("--ntables", type=int, default=4)
    p.add_argument("-i", "--image_total", type=int, default=120_000_000)
    p.add_argument("--out_prefix", default="bitmap")
    p.add_argument("--device", default=None,
                   help="device to sort on (default: the card)")
    args = p.parse_args(argv)

    from verticut_tpu_torch.bits import as_codes, entry_device, to_u32
    from verticut_tpu_torch.codes import read_code_file
    from verticut_tpu_torch.config import MIHConfig
    from verticut_tpu_torch.index.bitmap import build_bitmap
    from verticut_tpu_torch.index.mih import sort_table

    device = entry_device(args.device)
    cfg = MIHConfig(bits=args.binary_bits, n_tables=args.ntables)
    codes = as_codes(read_code_file(args.binary_file, cfg.n_bytes,
                                    args.image_total), device)
    for t in range(cfg.n_tables):
        subs, _ = sort_table(codes, t, cfg.s_bits)
        bmp = build_bitmap(subs, cfg.s_bits)
        words = to_u32(bmp.words)
        path = f"{args.out_prefix}.{t}"
        words.tofile(path)
        print(f"table {t}: {int(bmp.count())} occupied buckets "
              f"-> {path} ({words.nbytes} bytes)")


if __name__ == "__main__":
    main()
