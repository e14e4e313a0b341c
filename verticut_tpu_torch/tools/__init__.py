"""Command-line tools of the port, the twins of the reference's
``tools/`` scripts, each run as ``python -m verticut_tpu_torch.tools.<name>``."""
