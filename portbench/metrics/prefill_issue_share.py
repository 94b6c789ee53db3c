"""The share of the prefills' wall time in which the host was still
issuing the forward: the program's ``issue`` spans over their ``prefill``
spans, over the window's prefills that do not overlap the profiled slice
(the profiler stretches the host's launches there). A high share means
the host is still issuing when the device could be done."""
from portbench.bench import program_spans as ps


def read(run):
    clear = ps.clear_of_slice(run)
    if clear is None:
        return None
    spans = [p for p in ps.prefills(run) if clear(p.start, p.end)]
    issue = sum(ps.total(p.named("issue")) for p in spans)
    wall = ps.total(spans)
    return 100.0 * issue / wall if wall > 0 else None
