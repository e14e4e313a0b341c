"""queries_per_s.radius_step: ``queries_per_s`` in the cells where the
radius step does the work and its host dispatch paces the card. Their
runs spread more than those of the cells the card paces, so the rate has
a bound of its own there. On several cards it reads as
``queries_per_s`` does there: rank 0's clock."""

from benchmark import spec

read = spec.reader("queries_per_s")
