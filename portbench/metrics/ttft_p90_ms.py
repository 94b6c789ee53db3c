"""Time to first token, 90th percentile over every request due in the
window: from when it was due on the open-loop schedule to when its first
token was on the host. A request still without one a minute past the
close counts as the slowest (and the run is not correct)."""
import math

from portbench.yardstick.stats import percentile


def read(run):
    v = percentile([(r.first - r.due) * 1e3 if not math.isnan(r.first)
                    else math.inf for r in run.requests], 90)
    return v if v is not None and math.isfinite(v) else None
