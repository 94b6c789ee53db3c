"""The check that decides ``correct`` for a serve cell.

Once the window has closed, ``memory_peak_bytes`` is read and the
program's state is freed, a sample of the requests the window finished,
drawn from the seed with the longest among them, is run through the plain
reference (``reference/model.py``) on weights made again from the seed, in
their original order. A served token's gap is how far its logit lies
below the reference's best at its position (every served token is
greedy); the numbers compared are the mean of the sample's gaps and, where
the configuration holds it, the widest (``check`` in its file). The
control puts the reference itself in the program's place at float8 and
reads the gaps of the tokens float8 puts first."""
from __future__ import annotations

import numpy as np
import torch

from ..reference.model import Served, gaps, served_logits
from ..traffic.process import _stream
from . import weights as W


def sample(requests, *, tokens: int, most: int, seed: int) -> list:
    """The longest finished request (by served tokens), then others drawn
    from the seed until ``tokens`` served tokens or ``most`` requests."""
    done = [r for r in requests if r.finished]
    if not done:
        return []
    done.sort(key=lambda r: (-len(r.ereq.generated), r.due))
    picked = [done[0]]
    rest = done[1:]
    order = _stream(seed, "check").permutation(len(rest))
    total = len(done[0].ereq.generated) + 1
    for i in order:
        if total >= tokens or len(picked) >= most:
            break
        picked.append(rest[i])
        total += len(rest[i].ereq.generated) + 1
    return picked


def to_served(rec) -> Served:
    gen = np.asarray(rec.ereq.generated, np.int64)
    prompt = np.asarray(rec.spec.prompt, np.int64)
    served = np.concatenate([[rec.t0], gen]).astype(np.int64)
    return Served(prompt=prompt, decode_inputs=served[:-1],
                  decode_pos=np.asarray(rec.pos, np.int64), served=served)


def schedule_faults(recs, *, paged: bool) -> list[str]:
    """What in the recorded schedule the reference cannot follow: a decode
    step count that differs from the tokens, or (paged) a row that did
    not decode at its own length."""
    out = []
    for r in recs:
        n = len(r.ereq.generated)
        if len(r.pos) != n:
            out.append(f"request {r.ereq.uid}: {len(r.pos)} decode steps "
                       f"for {n} tokens")
        elif paged and list(r.pos) != list(range(len(r.spec.prompt),
                                                 len(r.spec.prompt) + n)):
            out.append(f"request {r.ereq.uid}: paged positions "
                       f"{r.pos[:4]}… are not its own lengths")
    return out


def reference_engine(cfg: dict, *, paged: bool, max_len: int) -> dict:
    m = cfg["model"]
    w = m.get("sliding_window", 0)
    return {"kv": "paged" if paged else "ring",
            "ring": min(w, max_len) if w else max_len,
            "capacity_factor": m["capacity_factor"]}


def _summary(per_request) -> dict:
    """The gaps of every served token of the sample: ``mean_logit_gap``
    (over all of them) and ``logit_gap`` (the widest), the numbers a
    configuration's ``check`` may hold to a limit, and more for the log."""
    every = torch.cat(per_request).double().cpu()
    q = every.quantile(torch.tensor([0.5, 0.9, 0.99], dtype=every.dtype))
    return {"mean_logit_gap": float(every.mean()),
            "logit_gap": float(every.max()),
            "p50": float(q[0]), "p90": float(q[1]), "p99": float(q[2]),
            "widest_each": [round(float(g.max()), 4) for g in per_request]}


def run_check(cfg: dict, recs: list, *, seed: int, device, paged: bool,
              max_len: int, control: bool = False) -> dict:
    """The widest gap over ``recs`` (and with ``control`` the control's).
    The program's weights must be freed already: these are made again."""
    m = cfg["model"]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["engine"]["dtype"]]
    seqs = [to_served(r) for r in recs]
    engine = reference_engine(cfg, paged=paged, max_len=max_len)
    weights = W.make(m, seed, device, dtype)
    out = {"requests": len(seqs),
           "tokens": int(sum(len(s.served) for s in seqs))}
    ref = served_logits(weights, m, engine, seqs)
    out["program"] = _summary([gaps(r, s.served) for r, s in zip(ref, seqs)])
    if control:
        low = served_logits(weights, m, engine, seqs, precision="fp8")
        picks = [lo.argmax(dim=1).cpu().numpy() for lo in low]
        out["control"] = _summary([gaps(r, t) for r, t in zip(ref, picks)])
    del weights
    return out
