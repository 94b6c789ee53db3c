"""90th percentile, over the requests admitted in the window, of the time
from a request's admission to the start of its own ``prefill`` span: the
wait behind the prefills issued before its own in the same step (the
program's timeline). A wait that overlaps the profiled slice is left out:
the profiler stretches the host's launches of the prefills it waits for."""
import math

from portbench.bench import program_spans as ps
from portbench.yardstick.stats import percentile


def read(run):
    clear = ps.clear_of_slice(run)
    if clear is None:
        return None
    every = ps.spans(run)
    waits = []
    for tl in ps.timelines(run):
        if (tl.prefill < 0 or math.isnan(tl.admitted)
                or not ps.in_window(run, tl.admitted)):
            continue
        start = every[tl.prefill].start
        if clear(tl.admitted, start):
            waits.append((start - tl.admitted) * 1e3)
    return percentile(waits, 90)
