"""The share of the decode steps' time in the profiled slice in which no
operation ran on the card: each ``pb.decode#i`` range (the step's host
work, the captured graph's replay and the wait for it) less the union of
the device operations that began inside it. The decode step is one graph
launch, so the profiler's cost per host operation, which stretches the
eager prefills, barely reaches it."""
from portbench.bench.trace import ops_between
from portbench.yardstick.stats import union_length


def read(run):
    t = run.trace
    if t is None or t["window"] is None:
        return None
    s, e = t["window"]
    total = busy = 0.0
    for a, b, _ in t["spans"]["decode"]:
        a, b = max(a, s), min(b, e)
        if b <= a:
            continue
        total += b - a
        busy += union_length([(x, min(y, b)) for _, x, y in
                              ops_between(t, a, b)])
    return 100.0 * (1.0 - busy / total) if total > 0 else None
