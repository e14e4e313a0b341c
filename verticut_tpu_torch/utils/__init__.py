"""Named timers and the leveled logger: the port's copies of
``verticut_tpu/utils/timer.py`` and ``utils/logging.py``."""

from verticut_tpu_torch.utils.timer import Timer, scoped, show_all_timings, timings  # noqa: F401
from verticut_tpu_torch.utils.logging import get_logger  # noqa: F401
