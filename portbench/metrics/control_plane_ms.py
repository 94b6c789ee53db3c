"""Host milliseconds of GEM's per-step control plane a decode step: the
program's ``control`` spans (the expert-count and drop readbacks, then
the planner's or the online controller's observation) over the window's
steps that decoded and do not overlap the profiled slice (the profiler
stretches the host's operations there)."""
from portbench.bench import program_spans as ps


def read(run):
    clear = ps.clear_of_slice(run)
    if clear is None:
        return None
    decoded = [s for s in ps.steps(run)
               if s.named("decode") and clear(s.start, s.end)]
    control = [c for s in decoded for c in s.named("control")]
    if not control:
        return None
    return ps.total(control) / len(decoded) * 1e3
