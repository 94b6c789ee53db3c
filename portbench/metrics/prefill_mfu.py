"""The prefills' model FLOPs (the frozen ``active_param_count`` and the
causal attention products) over their wall time at the bf16 peak."""
from portbench.yardstick.flops import prefill_flops
from portbench.yardstick.peaks import BF16_FLOPS_PER_S


def read(run):
    wall = sum(e - s for s, e, _ in run.prefills)
    if wall <= 0:
        return None
    work = sum(prefill_flops(run.model, p) for _, _, p in run.prefills)
    return 100.0 * work / (wall * BF16_FLOPS_PER_S)
