"""device_idle_share.radius_step: ``device_idle_share`` in the cells of
``queries_per_s.radius_step``, the end-to-end metric it moves there; on several cards as there."""

from benchmark import spec

read = spec.reader("device_idle_share")
