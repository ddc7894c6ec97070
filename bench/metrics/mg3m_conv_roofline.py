"""The conv kernels' share of their roofline: the count's bound summed over
every call into the program's conv entry, over the device time of the
kernels those calls launched."""
from bench.metrics_common import conv_roofline as read  # noqa: F401
