"""Reductions that more than one per-layer reader shares."""


def _conv_traced(record) -> bool:
    """Whether every noted conv call matched a layer and its kernels were
    traced."""
    tr = record.get("trace") or {}
    return (tr.get("conv_device_s", 0.0) > 0 and record.get("conv_calls", 0)
            > 0 and record.get("conv_unmatched", 1) == 0)


def conv_roofline(record):
    """100 x (the count's bound of the noted conv calls) / (device time of
    the kernels they launched); nothing where no conv kernel was traced or
    a call matched no layer of the configuration."""
    if not _conv_traced(record):
        return None
    return 100.0 * record["conv_bound_s"] / record["trace"]["conv_device_s"]


def direction_ms(record, direction: str):
    """Device ms per pass of the kernels one direction's calls launched."""
    if not _conv_traced(record) or not record.get("passes"):
        return None
    s = record["trace"].get("conv_device_s_by", {}).get(direction, 0.0)
    return 1e3 * s / record["passes"] if s > 0 else None


def device_idle(record):
    """100 x (1 - busy / window) of the traced window."""
    tr = record.get("trace") or {}
    window, busy = tr.get("window_s", 0.0), tr.get("busy_s", 0.0)
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
