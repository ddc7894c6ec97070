"""Device milliseconds per pass of the kernels launched by the program's
wgrad calls."""
from bench.metrics_common import direction_ms


def read(record):
    return direction_ms(record, "wgrad")
