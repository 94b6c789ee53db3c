"""Per-request SLO accounting: percentile TTFT / TPOT / E2E reports.

The port's own copy of ``repro/serving/slo.py``.

``latency_report()`` historically summarised *step* latencies (mean and
step-level percentiles), which is a statement about the batch, not about
any request a user submitted. Serving SLOs are per-request:

  * **TTFT** — time to first token: ``first_token_time - arrival_time``
    (queueing + prefill; the prefill's own output token counts as the
    first token, matching the standard definition);
  * **TPOT** — time per output token after the first:
    ``(finish_time - first_token_time) / num_decode_tokens``;
  * **E2E** — ``finish_time - arrival_time``.

All times are the engine's simulated clock (seconds) — on hardware the
same fields would be wall-clock timestamps. Percentiles are p50/p90/p99
because the paper's claims (and the fig23 gate) are tail statements: a
migration spike that a mean absorbs shows up at p99.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

__all__ = ["request_metrics", "slo_report", "PERCENTILES"]

PERCENTILES = (0.50, 0.90, 0.99)


def request_metrics(req) -> dict[str, float] | None:
    """TTFT/TPOT/E2E for one finished request; None if it never started."""
    first = getattr(req, "first_token_time", -1.0)
    if first < 0 or req.finish_time < req.arrival_time:
        return None
    decode_tokens = max(len(req.generated) - 1, 1)
    return {
        "ttft": float(first - req.arrival_time),
        "tpot": float((req.finish_time - first) / decode_tokens),
        "e2e": float(req.finish_time - req.arrival_time),
    }


def slo_report(finished: Iterable, *, prefix: str = "") -> dict[str, float]:
    """Percentile report over finished requests.

    Keys: ``{prefix}ttft_p50/p90/p99``, ``{prefix}tpot_p50/p90/p99``,
    ``{prefix}e2e_p50/p90/p99`` plus means and the request count. Requests
    that never produced a first token (preempted at shutdown, cancelled)
    are excluded and counted under ``{prefix}slo_excluded``.
    """
    reqs = list(finished)
    rows = [m for m in (request_metrics(r) for r in reqs) if m is not None]
    out: dict[str, float] = {
        f"{prefix}slo_requests": float(len(rows)),
        f"{prefix}slo_excluded": float(len(reqs) - len(rows)),
    }
    if not rows:
        return out
    for metric in ("ttft", "tpot", "e2e"):
        vals = np.asarray([m[metric] for m in rows])
        out[f"{prefix}{metric}_mean"] = float(vals.mean())
        for q in PERCENTILES:
            out[f"{prefix}{metric}_p{int(q * 100)}"] = float(
                np.quantile(vals, q)
            )
    return out
