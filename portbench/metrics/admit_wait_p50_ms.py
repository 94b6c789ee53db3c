"""Median time from due to admitted into a decode slot, over the requests
admitted inside the window (the wrapped ``scheduler.admit``)."""
import math

from portbench.yardstick.stats import percentile


def read(run):
    return percentile([(r.admit - r.due) * 1e3 for r in run.requests
                       if not math.isnan(r.admit) and r.admit < run.end], 50)
