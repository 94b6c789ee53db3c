"""Device milliseconds a decode step: CUDA events around each call of the
captured step in the window, their total over the steps (--trace 1)."""


def read(run):
    if not run.decode_event_ms:
        return None
    return sum(run.decode_event_ms) / len(run.decode_event_ms)
