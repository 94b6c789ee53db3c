"""The profiled slice of a ``--trace 1`` window, reduced to plain lists.

``torch.profiler`` stamps the host ranges the benchmark opened
(``pb.step#i``, ``pb.prefill#i``, ``pb.decode#i``, ``pb.wait``,
``pb.slice``) and the device's operations on one clock. What comes out:
every device operation as (name, start, end) in seconds, sorted; the
benchmark's ranges by kind, each (start, end, index); the slice; and the
K1 work that the metric readers price (K2's counts of each decode step,
the assignments each prefill's launches got), with the kernel launches
the port counted inside the slice."""
from __future__ import annotations

import bisect

from ..yardstick.stats import merge, union_length

GAP_KIND = {"prefill": "prefill", "decode": "decode", "wait": "wait_arrivals",
            "step": "engine_host"}


def collect(prof, *, decode_counts: dict, prefill_work: dict,
            launches: dict) -> dict:
    from torch.autograd import DeviceType

    ops, spans = [], {"step": [], "prefill": [], "decode": [], "wait": []}
    window = None
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        name = e.name
        if e.device_type == DeviceType.CUDA:
            if not name.startswith("pb."):  # not a range's device mirror
                ops.append((name, s, t))
            continue
        if not name.startswith("pb."):
            continue
        kind, _, idx = name[3:].partition("#")
        if kind == "slice":
            window = (s, t)
        elif kind in spans:
            spans[kind].append((s, t, int(idx) if idx else -1))
    ops.sort(key=lambda o: o[1])
    for v in spans.values():
        v.sort()
    return {"ops": ops, "spans": spans, "window": window,
            "decode_counts": decode_counts, "prefill_work": prefill_work,
            "launches": launches}


def ops_between(trace: dict, start: float, end: float) -> list:
    """The device operations that began inside [start, end]."""
    ops = trace["ops"]
    starts = trace.setdefault("_starts", [o[1] for o in ops])
    lo = bisect.bisect_left(starts, start)
    hi = bisect.bisect_right(starts, end)
    return ops[lo:hi]


def busy(trace: dict) -> tuple[float, float]:
    """(busy seconds, window seconds) of the slice."""
    s, t = trace["window"]
    clipped = [(max(a, s), min(b, t)) for _, a, b in trace["ops"]
               if b > s and a < t]
    return union_length(clipped), t - s


def idle_gaps(trace: dict) -> list[tuple[str, float, float]]:
    """The slice's gaps with no device operation, each (what the host was
    doing at its middle, start, end)."""
    s, t = trace["window"]
    merged = merge((max(a, s), min(b, t)) for _, a, b in trace["ops"]
                   if b > s and a < t)
    edges = [s] + [x for iv in merged for x in iv] + [t]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = trace["spans"]
    starts = {k: [x for x, _, _ in v] for k, v in spans.items()}
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        kind = "harness"
        for name in ("prefill", "decode", "wait", "step"):
            i = bisect.bisect_right(starts[name], mid) - 1
            if i >= 0 and spans[name][i][1] >= mid:
                kind = GAP_KIND[name]
                break
        out.append((kind, a, b))
    return out


def breakdown(trace: dict, top: int = 10) -> dict:
    by_op: dict[str, float] = {}
    for name, a, b in trace["ops"]:
        by_op[name[:120]] = by_op.get(name[:120], 0.0) + (b - a)
    by_gap: dict[str, float] = {}
    for kind, a, b in idle_gaps(trace):
        by_gap[kind] = by_gap.get(kind, 0.0) + (b - a)
    return {
        "device_ops": sorted(([k, v] for k, v in by_op.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in by_gap.items()),
                            key=lambda kv: -kv[1])[:top],
    }
