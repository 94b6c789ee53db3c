"""K1's share of its roofline inside the profiled decode steps: the bound
of the work the step's inputs need (K2's counts of every row's routed
assignments and the slots they reached; ``yardstick/k1.py``) over the
device time of K1's kernels (``ffn_mma_kernel``, ``ffn_wgmma_kernel``,
``grouped_gemm_kernel``) that began inside the step's span. Stated
against the data-sheet peaks, the card's power limit beside it."""
from portbench.bench.trace import ops_between
from portbench.yardstick.k1 import bound_s

K1 = ("ffn_mma_kernel", "ffn_wgmma_kernel", "grouped_gemm_kernel")


def read(run):
    t = run.trace
    if t is None:
        return None
    m = run.model
    D, tp = m["d_model"], m["expert_tp"]
    Fv = m["expert_d_ff"] // tp
    bound = device = 0.0
    for s, e, idx in t["spans"]["decode"]:
        counts = t["decode_counts"].get(idx)
        if counts is None:
            continue
        dev = sum(b - a for name, a, b in ops_between(t, s, e)
                  if any(k in name for k in K1))
        if dev <= 0:
            continue
        device += dev
        bound += sum(bound_s(int(c.sum()) * tp, int((c > 0).sum()) * tp, D, Fv)
                     for c in counts)
    return 100.0 * bound / device if device > 0 else None
