"""The traced run: ``torch.profiler`` over the measured window, reduced to
what the per-layer readers need.

The harness marks its own ranges with ``record_function``: ``bench.window``
around the whole window, ``bench.conv/<direction>`` around every call into
the program's conv entry (``ConvPlan.execute``), and ``bench.pass``
around each pass a user makes.  A device operation is charged to a
``bench.conv`` range, and to its direction, when the host op that
launched it (the profiler's kernel-to-op correlation) started inside that
range on the same thread, so the conv time covers whatever kernels the
entry launches, by any name.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch

WINDOW = "bench.window"
CONV = "bench.conv"
TOP = 10


def _activities(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _all_threads():
    """Profiler settings that record every thread's host ops (autograd
    runs a CUDA backward on a thread of its own), where this PyTorch has
    them."""
    try:
        return {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except (TypeError, AttributeError):
        return {}


@contextlib.contextmanager
def capture(device: torch.device, enabled: bool) -> Iterator[Dict]:
    """Profile the block when ``enabled``; the yielded dict gets the
    reduction (``reduce``) once the block has ended."""
    out: Dict = {}
    if not enabled:
        yield out
        return
    with torch.profiler.profile(activities=_activities(device),
                                **_all_threads()) as prof:
        with torch.profiler.record_function(WINDOW):
            yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    out.update(reduce(prof.profiler.kineto_results.events()))


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _rows(events):
    """(device?, name, start_ns, end_ns, thread, correlation, linked) of
    every event, user annotations on the device side left out."""
    cpu = torch.autograd.DeviceType.CPU
    rows = []
    for e in events:
        on_device = e.device_type() != cpu
        if on_device and e.is_user_annotation():
            continue
        s = e.start_ns()
        rows.append((on_device, e.name(), s, s + e.duration_ns(),
                     e.start_thread_id(), e.correlation_id(),
                     e.linked_correlation_id()))
    return rows


def reduce(events) -> Dict:
    """Window, device busy time, conv kernel time, the longest device ops
    and the longest idle gaps by what the host was doing."""
    rows = _rows(events)
    host = [r for r in rows if not r[0]]
    device = [r for r in rows if r[0]]
    window = [r for r in host if r[1] == WINDOW]
    if not window:
        return {}
    w0, w1 = window[0][2], window[0][3]

    # a device op is the conv entry's when the host op it is linked to
    # started inside a bench.conv range on the same thread, or when the
    # runtime call that launched it started inside one (by time alone:
    # the runtime's thread ids are numbered apart from the ranges'); it is
    # charged to that range's direction
    ranges: Dict[int, List[Tuple[int, int, str]]] = {}
    for _, name, s, e, tid, _, _ in host:
        if name == CONV or name.startswith(CONV + "/"):
            ranges.setdefault(tid, []).append((s, e, name[len(CONV) + 1:]))
    for r in ranges.values():
        r.sort()
    spans = sorted(iv for r in ranges.values() for iv in r)
    conv_ops: Dict[int, str] = {}
    launched: Dict[int, str] = {}
    for _, name, s, _, tid, corr, _ in host:
        label = _label(ranges.get(tid), s)
        if label is not None:
            conv_ops[corr] = label
        if "aunch" in name:
            label = _label(spans, s)
            if label is not None:
                launched[corr] = label
    n_conv = sum(len(r) for r in ranges.values())

    busy, by_name, conv_s, by_dir = [], {}, 0.0, {}
    how = {"linked": 0, "launched": 0, "both": 0, "unlinked": 0}
    for _, name, s, e, _, corr, linked in device:
        a, b = max(s, w0), min(e, w1)
        if b <= a:
            continue
        busy.append((a, b))
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
        by_link, by_launch = conv_ops.get(linked), launched.get(corr)
        how["unlinked"] += not linked
        label = by_link if by_link is not None else by_launch
        if label is not None:
            conv_s += (b - a) * 1e-9
            by_dir[label] = by_dir.get(label, 0.0) + (b - a) * 1e-9
            how["both" if by_link is not None and by_launch is not None
                else "linked" if by_link is not None else "launched"] += 1
    merged = _union(busy)
    busy_s = sum(b - a for a, b in merged) * 1e-9

    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), reverse=True)[:TOP]
    idle = [[_host_label(host, (a + b) // 2), g * 1e-9] for g, a, b in gaps]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_s,
            "conv_device_s": conv_s, "conv_device_s_by": by_dir,
            "conv_ranges": n_conv,
            "conv_attribution": how,
            "mg3m_named_s": sum(v for k, v in by_name.items() if "mg3m" in k),
            "device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}


def _label(spans: Optional[List[Tuple[int, int, str]]], t: int
           ) -> Optional[str]:
    """The label of the sorted, disjoint ``spans`` that ``t`` falls in."""
    if not spans:
        return None
    i = bisect.bisect_right(spans, (t, 1 << 62, "")) - 1
    if i >= 0 and spans[i][0] <= t < spans[i][1]:
        return spans[i][2]
    return None


def _host_label(host, t: int) -> str:
    """The innermost ``bench.`` range and the innermost other host op
    running at ``t``."""
    best: Dict[bool, Optional[Tuple[int, str]]] = {True: None, False: None}
    for _, name, s, e, _, _, _ in host:
        if s <= t < e and name != WINDOW:
            key = name.startswith("bench.")
            if best[key] is None or e - s < best[key][0]:
                best[key] = (e - s, name)
    parts = [b[1] for b in (best[True], best[False]) if b is not None]
    return " > ".join(parts) if parts else "host: no op"
