"""The share of the decoding rows' time spent behind other requests'
prefills: over the window's steps that do not overlap the profiled slice
(the profiler stretches the prefills' launches there), the sum of each
step's ``rows_before`` (the rows that held a token when it began, from its
``decode`` span) times its ``prefill`` children's wall, over the sum of
``rows_before`` times the step's wall (the program's timeline)."""
from portbench.bench import program_spans as ps


def read(run):
    clear = ps.clear_of_slice(run)
    if clear is None:
        return None
    stalled = held = 0.0
    for s in ps.steps(run):
        if not clear(s.start, s.end):
            continue
        dec = s.named("decode")
        rows = dec[0].args["rows_before"] if dec else 0
        stalled += rows * ps.total(s.named("prefill"))
        held += rows * (s.end - s.start)
    return 100.0 * stalled / held if held > 0 else None
