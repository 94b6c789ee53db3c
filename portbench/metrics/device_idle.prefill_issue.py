"""The share of the prefills' ``issue`` spans in the profiled slice (the
program's timeline, placed on the profiler's clock) in which no operation
ran on the card. Read beside ``prefill_issue_share``: a long issue with an
idle device means the prefill is launch-bound, a long issue with a busy
device that the launch queue is full. The profiler's own cost on each
launch lengthens a launch-bound issue, so there this share reads high."""
from portbench.bench import program_spans as ps


def read(run):
    t = run.trace
    off = ps.clock_offset(run)
    if off is None:
        return None
    s, e = t["window"]
    total = busy = 0.0
    for p in ps.prefills(run):
        for issue in p.named("issue"):
            a, b = max(issue.start + off, s), min(issue.end + off, e)
            if b <= a:
                continue
            total += b - a
            busy += ps.device_busy(t, a, b)
    return 100.0 * (1.0 - busy / total) if total > 0 else None
