"""Inter-token latency, 95th percentile over every gap between two
consecutive tokens of one request (the first token included) whose later
token reached the host inside the window, over all requests."""
from portbench.yardstick.stats import percentile


def read(run):
    gaps = [(b - a) * 1e3 for r in run.requests
            for a, b in zip([r.first] + r.tokens, r.tokens) if b < run.end]
    return percentile(gaps, 95)
