"""Every output token that reached the host inside the window (first
tokens included), over the window."""


def read(run):
    n = 0
    for r in run.requests:
        n += run.start <= r.first < run.end
        n += sum(run.start <= t < run.end for t in r.tokens)
    return n / run.seconds if n else None
