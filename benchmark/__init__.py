"""The benchmark of ``verticut_tpu_torch``: batched exact MIH K-NN on CUDA
cards, driven by ``BENCHMARK.json``.

``python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once from the root of a checkout and prints
one JSON line. Everything a cell is made of lives in data files found by
name: ``configs/<config>.json`` (the deployment: corpus size, code width,
tables, layout, search settings), ``traffic/<traffic>.json`` (the query
mix), ``cells/<workload>.json`` (the batch size), and one reader per
metric in ``metrics/<metric>.py``. The yardstick is the benchmark's own:
the corpus and query generators (``gen.py``), the
brute-force reference (``references/``), the roofline arithmetic
(``roofline.py``) and the trace reduction (``trace.py``). Nothing here
imports ``jax`` or the JAX package, and the reference imports nothing of
the program.
"""
