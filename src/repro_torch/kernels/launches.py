"""Launch counts of the hand-written kernels, CUDA graphs included.

A wrapper calls :func:`count` where it launches its kernel. Outside stream
capture that is a launch and adds one to the kernel's count in
:data:`LAUNCHES`. During capture the kernel is only recorded into a graph:
the call adds one to the tally of the open :func:`recording` instead, and
whoever replays the graph adds that tally again on every replay
(:func:`replayed`), so that the counts stay the launches the card ran.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["LAUNCHES", "count", "recording", "replayed", "reset"]

# kernel launches since the last reset (see ops.reset_launch_counts)
LAUNCHES = {"moe_ffn": 0, "topk_router_stats": 0, "topk_router": 0}
_tally: dict[str, int] | None = None  # open while a graph is captured


def count(name: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        if _tally is None:
            raise RuntimeError(
                f"{name}: kernel recorded into a CUDA graph outside "
                "launches.recording(); its replays would go uncounted"
            )
        _tally[name] += 1
    else:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def recording():
    """Tally the kernels recorded by a capture inside this block."""
    global _tally
    outer, _tally = _tally, dict.fromkeys(LAUNCHES, 0)
    try:
        yield _tally
    finally:
        _tally = outer


def replayed(tally: dict[str, int]) -> None:
    """One replay of a graph whose capture recorded ``tally``."""
    for name, n in tally.items():
        LAUNCHES[name] += n


def reset() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
