"""The serving engine's real-clock timeline (``serving/timeline.py``) on a
smoke config served by the port's engine, on the CPU: the span tree of
every step, each request's ordered stamps and the steps it decoded in,
in the paged pool (roomy and preempting) and the dense cache; the garbage
collector stops tracking its rows. The timeline imports no ``torch`` and
opens no profiler range."""
import gc
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineConfig,
    PagedKVConfig,
    ServingEngine,
    batch_arrivals,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CHILDREN = {"step": {"prefill", "decode", "control"}, "prefill": {"issue"}}
NAMES = set(CHILDREN) | set().union(*CHILDREN.values())
LENGTHS, NEWS = [6, 9, 13, 6, 9], [8, 5, 10, 7, 6]
CASES = {"paged": ("paged", None), "preempting": ("paged", 9),
         "dense": ("dense", None)}


def _engine(kv_mode, num_blocks):
    cfg = get_smoke_config("granite-moe-3b-a800m")
    params = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    return ServingEngine(
        params, cfg,
        EngineConfig(max_batch=3, max_len=40, kv_mode=kv_mode,
                     kv=PagedKVConfig(block_size=4, num_blocks=num_blocks)),
        device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(21)
    return [rng.integers(0, vocab, size=n) for n in LENGTHS]


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request):
    eng = _engine(*CASES[request.param])
    # the decode step's rows when each step began, seen from outside
    rows = []
    inner = eng._prefill_phase

    def prefill_phase(step_row):
        rows.append(int(eng.installed.sum()))
        return inner(step_row)

    eng._prefill_phase = prefill_phase
    eng.serve(batch_arrivals(_prompts(eng.config.vocab_size), NEWS))
    assert len(eng.finished) == len(LENGTHS)
    if request.param == "preempting":
        assert eng.preemption_count > 0  # the preemption path ran
    return request.param, eng, rows


class _Span:
    """A span of the engine's timeline, with its row and its children."""

    def __init__(self, row, r):
        self.row, self.name, self.start, self.end, self.parent = row, *r[:4]
        self.args = dict(zip(r[4::2], r[5::2]))
        self.children = []

    def named(self, name):
        return [c for c in self.children if c.name == name]


def _tree(eng):
    """Every span of the engine's timeline, by row, with its children."""
    spans = [_Span(i, r) for i, r in enumerate(eng.timeline.rows)]
    for s in spans:
        if s.parent >= 0:
            spans[s.parent].children.append(s)
    return spans


def _steps(eng):
    """Every step span reachable from the finished requests, by start."""
    spans = _tree(eng)
    rows = {i for r in eng.finished for i in r.timeline.steps}
    return sorted((spans[i] for i in rows), key=lambda s: s.start)


def _walk(span):
    yield span
    for c in span.children:
        yield from _walk(c)


def test_children_lie_inside_their_parents(served):
    case, eng, rows = served
    steps = _steps(eng)
    for step in steps:
        for span in _walk(step):
            assert math.isfinite(span.start) and math.isfinite(span.end)
            assert span.start <= span.end, span
            assert {c.name for c in span.children} <= CHILDREN.get(
                span.name, set()), span
            for c in span.children:
                assert span.start <= c.start and c.end <= span.end, (span, c)
            # siblings follow one another
            for a, b in zip(span.children, span.children[1:]):
                assert a.end <= b.start, (a, b)
        assert len(step.named("decode")) == len(step.named("control")) <= 1
        for p in step.named("prefill"):
            assert [c.name for c in p.children] == ["issue"]
            assert p.args["tokens"] in LENGTHS
            assert 0 <= p.args["slot"] < 3
    # every step with work, each once, and every row in a step's tree
    assert [s.args["step"] for s in steps] == list(range(eng.step_count))
    assert [s.named("decode")[0].args["rows_before"] if s.named("decode")
            else rows[i] for i, s in enumerate(steps)] == rows
    assert sum(len(list(_walk(s))) for s in steps) == len(eng.timeline.rows)


def test_request_stamps_are_ordered(served):
    _, eng, _ = served
    spans = _tree(eng)
    for r in eng.finished:
        tl = r.timeline
        assert tl.spans is eng.timeline
        p = spans[tl.prefill]
        assert p.name == "prefill" and p.args["uid"] == r.uid
        issue = p.named("issue")[0]
        # the prefill ends when the first token is on the host, before the
        # first step the request decoded in ends
        first, last = spans[tl.steps[0]], spans[tl.steps[-1]]
        assert (tl.admitted <= p.start <= issue.start <= issue.end <= p.end
                <= first.end <= last.end), r.uid


def test_every_step_a_request_decoded_in_is_reachable(served):
    case, eng, _ = served
    spans = _tree(eng)
    for r in eng.finished:
        steps = [spans[i] for i in r.timeline.steps]
        assert len(set(r.timeline.steps)) == len(steps)
        assert all(s.name == "step" and s.named("decode") for s in steps)
        if case != "preempting" or r.preemptions == 0:
            # from its prefill's step on, one step a token, none skipped
            assert len(steps) == len(r.generated)
            # the first is the step that prefilled it, which holds its
            # prefill
            assert spans[r.timeline.prefill] in steps[0].children
            first = steps[0].args["step"]
            assert [s.args["step"] for s in steps] == list(
                range(first, first + len(steps)))
        else:  # its tokens before the preemption were decoded too
            assert len(steps) > len(r.generated)
    # the steps are shared between the requests, not copied
    counts = {}
    for r in eng.finished:
        for i in r.timeline.steps:
            counts[i] = counts.get(i, 0) + 1
    assert max(counts.values()) > 1


def test_timeline_imports_no_torch():
    path = ROOT / "src" / "repro_torch" / "serving" / "timeline.py"
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('tl', {str(path)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "t = mod.Timeline()\n"
        "t.close(t.add('step', 1.0), 2.0)\n"
        "t.add('decode', 1.0, 1.5, parent=0, rows_before=2)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'torch', 'numpy', 'repro_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_profiled_step_shows_no_timeline_span():
    eng = _engine("paged", None)
    for prompt, new in zip(_prompts(eng.config.vocab_size)[:2], NEWS):
        eng.submit(prompt, new)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.step()
        eng.step()
    names = {e.name for e in prof.events()}
    assert names  # the profiler saw the step's operations
    assert not names & NAMES, names & NAMES
    # and the timeline recorded both steps all the same
    req = eng.scheduler.active[0]
    assert len(req.timeline.steps) == 2
    spans = _tree(eng)
    assert spans[req.timeline.prefill] in spans[req.timeline.steps[0]].children


def test_the_collector_stops_tracking_the_rows(served):
    """A row of the timeline holds only strings and numbers, so the first
    collection it survives stops the garbage collector from tracking it:
    none reaches the collector's older generations, where it would bring
    the next full pass sooner. A row that an earlier collection had kept
    tracked would still be tracked after this young one."""
    _, eng, _ = served
    gc.collect(0)
    rows = eng.timeline.rows
    assert len(rows) > 10
    assert not any(gc.is_tracked(r) for r in rows)
    # where a row held a container, it would stay tracked
    held = (*rows[0][:4], [])
    gc.collect(0)
    assert gc.is_tracked(held)
