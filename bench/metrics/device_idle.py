"""Share of the traced window in which no operation ran on the card."""
from bench.metrics_common import device_idle as read  # noqa: F401
