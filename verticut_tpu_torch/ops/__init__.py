"""Device ops of the port: enumeration, chunk descriptors, selection,
scans."""

from verticut_tpu_torch.ops import enumeration, hamming, topk  # noqa: F401
