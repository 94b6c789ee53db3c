"""Host milliseconds a step outside the model's calls: each engine step's
wall time less its prefill calls (ending on their first token's sync) and
its decode call (ending, with --trace 1, on a sync), over the window's
steps. Reads the benchmark's spans around ``ServingEngine.step``,
``_install_paged_slot``/``_write_slot`` and ``_decode``."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    step = sum(e - s for s, e in run.steps)
    model = (sum(e - s for s, e, _ in run.prefills)
             + sum(e - s for s, e, _ in run.decodes))
    return (step - model) / len(run.steps) * 1e3
