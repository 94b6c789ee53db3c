"""The one generator that reads every traffic file of ``traffic/``.

An open loop: requests are due on a schedule whatever the system does.
The arrival process is a frozen copy of the port's
``serving/arrivals.py`` Poisson process (exponential gaps at the mix's
rate), and the tasks are its vocab bands: a task's prompts draw their
token ids from its slice of the vocabulary, so tasks with disjoint bands
excite different experts. Lengths come from the traffic file:

* prompts lognormal (``median``, ``sigma``), rounded, clipped to ``clip``;
* outputs exponential (``mean``), rounded, clipped to ``clip``.

Every seed gets the same work: the schedule (each request's arrival time,
prompt length, output length and task, in one order) is drawn once from
the file's ``shape_seed``, and ``--seed`` draws the token ids (and the
weights). Shuffling the lengths over the arrivals by the seed made the
tails of two seeds differ by several times what two runs of one seed do:
which long prompt lands in which burst is most of a tail.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    due: float  # seconds after the window opens
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    task: str


def _lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    lo, hi = spec["clip"]
    if spec["dist"] == "lognormal":
        x = rng.lognormal(math.log(spec["median"]), spec["sigma"], size=n)
    elif spec["dist"] == "exponential":
        x = rng.exponential(spec["mean"], size=n)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def _task_counts(tasks: list[dict], n: int) -> list[int]:
    shares = np.asarray([t["share"] for t in tasks], np.float64)
    counts = np.floor(shares / shares.sum() * n).astype(int)
    counts[: n - counts.sum()] += 1  # the remainder, first tasks first
    return counts.tolist()


def _stream(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1),
                                  int.from_bytes(name.encode(), "little")])


def count_for(traffic: dict, seconds: float, rate: float | None = None) -> int:
    """Requests drawn for a window: enough that the schedule outlasts it
    (at ``rate``, the file's by default)."""
    rate = traffic["rate"] if rate is None else rate
    return int(math.ceil(rate * seconds * 1.3)) + 16


def generate(traffic: dict, vocab_size: int, seed: int, n: int,
             *, rate: float | None = None) -> list[Request]:
    """``n`` requests of the mix, due in order; ``rate`` overrides the
    file's (a sweep for the knee)."""
    if traffic["process"] != "poisson":
        raise ValueError(f"unknown process {traffic['process']!r}")
    rate = float(traffic["rate"] if rate is None else rate)
    shape = np.random.default_rng(traffic["shape_seed"])
    gaps = shape.exponential(1.0 / rate, size=n)
    prompts = _lengths(traffic["prompt"], n, shape)
    outputs = _lengths(traffic["output"], n, shape)
    tasks = traffic["tasks"]
    task_of = np.repeat(np.arange(len(tasks)), _task_counts(tasks, n))

    task_of = shape.permutation(task_of)
    tokens = _stream(seed, "tokens")
    due = np.cumsum(gaps)
    out = []
    for i in range(n):
        task = tasks[task_of[i]]
        lo = int(task["vocab_band"][0] * vocab_size)
        hi = max(lo + 1, int(task["vocab_band"][1] * vocab_size))
        prompt = tokens.integers(lo, hi, size=int(prompts[i]),
                                 dtype=np.int32)
        out.append(Request(float(due[i]), prompt, int(outputs[i]),
                           task["name"]))
    return out


def warmup(traffic: dict, vocab_size: int, seed: int, count: int,
           max_new_tokens: int) -> list[Request]:
    """``count`` requests of the mix's prompt lengths and tasks, all due
    at once, the longest prompt of the clip among them (so that set-up
    meets the largest prefill the window can bring), each asking for
    ``max_new_tokens``."""
    reqs = generate(traffic, vocab_size, seed ^ 0x5EED, count)
    rng = _stream(seed, "warmup")
    hi = traffic["prompt"]["clip"][1]
    out = []
    for i, r in enumerate(reqs):
        prompt = r.prompt
        if i == 0:
            lo_hi = traffic["tasks"][0]["vocab_band"]
            prompt = rng.integers(int(lo_hi[0] * vocab_size),
                                  max(int(lo_hi[0] * vocab_size) + 1,
                                      int(lo_hi[1] * vocab_size)),
                                  size=hi, dtype=np.int32)
        out.append(Request(0.0, prompt, max_new_tokens, r.task))
    return out


def max_len(traffic: dict, block: int = 16) -> int:
    """The positions a slot must hold: the longest prompt plus the longest
    output and the one the engine keeps spare, rounded up to ``block``."""
    need = traffic["prompt"]["clip"][1] + traffic["output"]["clip"][1] + 1
    return -(-need // block) * block
