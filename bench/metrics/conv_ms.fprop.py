"""Device milliseconds per pass of the kernels launched by the program's
fprop calls."""
from bench.metrics_common import direction_ms


def read(record):
    return direction_ms(record, "fprop")
