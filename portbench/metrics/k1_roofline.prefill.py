"""K1's share of its roofline inside the profiled prefills: the bound of
the assignments each launch kept and the slots they reached (read from
the dispatch plan as each prefill's MoE layers run; ``yardstick/k1.py``)
over the device time of K1's kernels that began inside the prefill's
span."""
from portbench.bench.trace import ops_between
from portbench.yardstick.k1 import bound_s

K1 = ("ffn_mma_kernel", "ffn_wgmma_kernel", "grouped_gemm_kernel")


def read(run):
    t = run.trace
    if t is None:
        return None
    m = run.model
    D, Fv = m["d_model"], m["expert_d_ff"] // m["expert_tp"]
    bound = device = 0.0
    for s, e, idx in t["spans"]["prefill"]:
        work = t["prefill_work"].get(idx)
        if not work:
            continue
        dev = sum(b - a for name, a, b in ops_between(t, s, e)
                  if any(k in name for k in K1))
        if dev <= 0:
            continue
        device += dev
        bound += sum(bound_s(a, n, D, Fv) for a, n in work)
    return 100.0 * bound / device if device > 0 else None
