"""Named timers, spans and counters, and the leveled logger: the port's
copies of ``verticut_tpu/utils/timer.py`` and ``utils/logging.py``."""

from verticut_tpu_torch.utils.timer import (  # noqa: F401
    Timer, count, counters, scoped, show_all_timings, span, timings)
from verticut_tpu_torch.utils.logging import get_logger  # noqa: F401
