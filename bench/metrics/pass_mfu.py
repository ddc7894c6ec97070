"""The whole pass's share of the card's peak: the count's operations of
every pass in the window over the window, against the configuration's
peak rate."""
from bench import count


def read(record):
    if not record.get("passes") or record.get("window_s", 0) <= 0:
        return None
    rate = record["passes"] * record["pass_flops"] / record["window_s"]
    return 100.0 * rate / count.PEAK_FLOPS[record["dtype"]]
