"""Wall milliseconds of the window's prefill calls (each ending on the
sync that brings its first token to the host) per 1,000 prompt tokens."""


def read(run):
    toks = sum(p for _, _, p in run.prefills)
    if not toks:
        return None
    return sum(e - s for s, e, _ in run.prefills) * 1e6 / toks
