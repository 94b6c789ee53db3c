"""The decode steps' model FLOPs (each row that carried a request: its
parameters and the keys it attended to) over their CUDA-event time at the
bf16 peak."""
from portbench.yardstick.flops import decode_flops
from portbench.yardstick.peaks import BF16_FLOPS_PER_S


def read(run):
    if not run.decode_event_ms:
        return None
    work = sum(decode_flops(run.model, k) for _, _, keys in run.decodes
               for k in keys)
    return 100.0 * work / (sum(run.decode_event_ms) * 1e-3 * BF16_FLOPS_PER_S)
