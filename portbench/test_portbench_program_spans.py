"""The readers of the program's own spans (``bench/program_spans.py`` and
the five metrics on it): known answers on hand-built runs, the profiler's
clock recovered from ``pb.step#i``, the profiled slice left out, nothing
read (and nothing raised) from a program without a timeline, and the
spans of a smoke window served through the harness on the CPU."""
import bisect
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.bench import program_spans as ps
from portbench.bench import serve, spec
from portbench.bench.serve import Rec, Run
from portbench.test_portbench_reference import serve_smoke
from portbench.traffic.process import Request
from repro_torch.serving.timeline import RequestTimeline, Timeline

NEW = ("prefill_issue_share", "prefill_wait_p90_ms",
       "decode_prefill_stall_share", "control_plane_ms",
       "device_idle.prefill_issue")
OFFSET = 100.0  # the profiler's clock less perf_counter's, in these runs


def _read(name, run):
    return spec.reader(name)(run)


def _prefill(tl, step, start, uid, issue, rest):
    """A prefill of the step at row ``step`` from ``start``: ``issue`` s
    of issue, then ``rest`` s to its first token; its row."""
    p = tl.add("prefill", start, start + issue + rest, parent=step, uid=uid,
               slot=uid, tokens=10)
    tl.add("issue", start, start + issue, parent=p)
    return p


def _rec(tl, due):
    r = Rec(Request(due, np.zeros(4, np.int32), 4, "t"), due, due,
            SimpleNamespace(finish_step=0, generated=[], timeline=tl))
    r.first = tl.spans.rows[tl.prefill][2]
    return r


def _run():
    """Three steps of a window [0, 2): step 0 [0, 1) admits two requests
    and prefills them behind two decoding rows (from 0.01 and 0.41 s, 0.4
    and 0.2 s long, of which 0.3 and 0.05 s issue); step 1 [1, 1.5) and
    step 2 [1.5, 1.8) decode four rows. Two older requests were prefilled
    before the window."""
    t = Timeline()
    old = t.add("step", -1.0, -0.5, step=-1)
    s0 = t.add("step", 0.0, 1.0, step=0)
    p1 = _prefill(t, s0, 0.01, 1, 0.30, 0.10)  # [0.01, 0.41]
    p2 = _prefill(t, s0, 0.41, 2, 0.05, 0.15)  # [0.41, 0.61]
    t.add("decode", 0.62, 0.70, parent=s0, rows_before=2)
    t.add("control", 0.90, 0.91, parent=s0)
    s1 = t.add("step", 1.0, 1.5, step=1)
    t.add("decode", 1.0, 1.2, parent=s1, rows_before=4)
    t.add("control", 1.3, 1.302, parent=s1)
    s2 = t.add("step", 1.5, 1.8, step=2)
    t.add("decode", 1.5, 1.7, parent=s2, rows_before=4)
    t.add("control", 1.7, 1.701, parent=s2)
    recs = []
    for uid, (p, admitted) in enumerate(
            [(p1, 0.005), (p2, 0.005),
             (_prefill(t, old, -1.0, 3, 0.1, 0.2), -1.0),
             (_prefill(t, old, -0.7, 4, 0.1, 0.1), -1.0)], start=1):
        tl = RequestTimeline()
        tl.spans, tl.admitted, tl.prefill = t, admitted, p
        tl.steps = [s0, s1, s2] if uid > 2 else [s0, s1]
        recs.append(_rec(tl, admitted))
    return Run(cell="c", seconds=2.0, setup_s=1.0, start=0.0, end=2.0,
               model={}, slots=4, requests=recs,
               steps=[(0.0, 1.0), (1.0, 1.5), (1.5, 1.8)], prefills=[],
               decodes=[], waits=[], decode_event_ms=[])


def _trace(window):
    """A slice ``window`` on the profiler's clock, whose ``pb.step#i``
    ranges open a few microseconds off ``OFFSET`` + the host's stamps; the
    device ran [0.0, 0.03] and [0.11, 0.21] (host clock)."""
    o = OFFSET
    return {
        "ops": [("k", o + 0.0, o + 0.03), ("k", o + 0.11, o + 0.21)],
        "spans": {"step": [(o + 0.0 + 1e-5, o + 1.0, 0),
                           (o + 1.0 + 3e-5, o + 1.5, 1),
                           (o + 1.5 + 2e-5, o + 1.8, 2),
                           (o + 9.0, o + 9.1, 7)],  # past run.steps
                  "prefill": [], "decode": [], "wait": []},
        "window": (o + window[0], o + window[1]),
        "decode_counts": {}, "prefill_work": {}, "launches": {}}


def test_readers_give_the_known_answers_without_a_trace():
    run = _run()
    # the window's prefills: 0.35 s of issue in 0.6 s
    assert _read("prefill_issue_share", run) == pytest.approx(100 * 0.35 / 0.6)
    # admission to own prefill: 5 ms and 405 ms (the older two are out)
    assert _read("prefill_wait_p90_ms", run) == pytest.approx(405.0)
    # 2 rows behind 0.6 s of prefills in a 1-s step; 4 rows in 0.5 + 0.3 s
    assert _read("decode_prefill_stall_share", run) == pytest.approx(
        100 * 2 * 0.6 / (2 * 1.0 + 4 * 0.5 + 4 * 0.3))
    assert _read("control_plane_ms", run) == pytest.approx(
        (0.01 + 0.002 + 0.001) / 3 * 1e3)
    assert _read("device_idle.prefill_issue", run) is None  # no slice
    assert [s.args["step"] for s in ps.steps(run)] == [0, 1, 2]


def test_the_profilers_clock_is_recovered_from_the_steps():
    run = _run()
    run.trace = _trace((0.0, 0.4))
    # the median of 1e-5, 3e-5 and 2e-5; the range past run.steps is out
    assert ps.clock_offset(run) == pytest.approx(OFFSET + 2e-5, abs=1e-9)
    a, b = ps.host_slice(run)
    assert (a, b) == pytest.approx((-2e-5, 0.4 - 2e-5), abs=1e-9)


# p1's issue [0.01, 0.31] in the first slice: busy 0.01-0.03 (an operation
# that began before it) and 0.11-0.21, shifted by the offset's 2 us
BUSY = (0.03 - 0.01 - 2e-5) + 0.10
SLICES = {
    # the slice holds p1, whose launches it stretched, and step 0: p2 alone
    # is read, both waits overlap it, steps 1 and 2 decode with no prefill
    "step 0": ((0.0, 0.4), {
        "prefill_issue_share": 100 * 0.05 / 0.2,
        "prefill_wait_p90_ms": None,
        "decode_prefill_stall_share": 0.0,
        "control_plane_ms": (0.002 + 0.001) / 2 * 1e3,
        "device_idle.prefill_issue": 100 * (1 - BUSY / 0.30)}),
    # the slice holds step 2 alone: no issue span lies in it
    "step 2": ((1.6, 1.7), {
        "prefill_issue_share": 100 * 0.35 / 0.6,
        "prefill_wait_p90_ms": 405.0,
        "decode_prefill_stall_share": 100 * 2 * 0.6 / (2 * 1.0 + 4 * 0.5),
        "control_plane_ms": (0.01 + 0.002) / 2 * 1e3,
        "device_idle.prefill_issue": None}),
}


@pytest.mark.parametrize("where", sorted(SLICES))
def test_the_profiled_slice_is_left_out_and_its_issues_are_read(where):
    """The readers of host spans leave out what overlaps the slice, where
    the profiler stretches the host's work; the device's idle share reads
    the issue spans inside it."""
    window, want = SLICES[where]
    run = _run()
    run.trace = _trace(window)
    for name, value in want.items():
        got = _read(name, run)
        if value is None:
            assert got is None, name
        else:
            assert got == pytest.approx(value, rel=1e-6), name


def test_a_program_without_a_timeline_reads_nothing():
    run = _run()
    for r in run.requests:
        r.ereq = SimpleNamespace(finish_step=0, generated=[])
    run.trace = _trace((0.0, 0.4))
    for name in NEW:
        assert _read(name, run) is None, name


@pytest.fixture(scope="module", params=["granite", "mixtral_dense"])
def smoke_window(request):
    """A smoke window served through the harness (the paged cache, the
    dense one), with the program's timeline on its requests."""
    _, state, w, _ = serve_smoke(request.param)
    serve.release(state)
    return request.param, w["run"]


def test_a_served_window_reads_the_programs_spans(smoke_window):
    _, run = smoke_window
    for name in NEW[:4]:
        v = _read(name, run)
        assert v is not None and v >= 0, name
    assert 0 < _read("prefill_issue_share", run) <= 100
    assert _read("decode_prefill_stall_share", run) <= 100
    assert _read("device_idle.prefill_issue", run) is None  # no trace
    # the benchmark's own spans lie inside the program's: each wrapped
    # prefill inside its prefill span, each engine step around its step
    spans = ps.prefills(run)
    assert len(spans) == len(run.prefills)
    for p, (t0, t1, tokens) in zip(spans, run.prefills):
        assert p.start <= t0 and t1 <= p.end and p.args["tokens"] == tokens
        assert [c.name for c in p.children] == ["issue"]
    steps = ps.steps(run)
    starts = [a for a, _ in run.steps]
    for s in steps:  # each program step inside one of the harness's
        a, b = run.steps[bisect.bisect_right(starts, s.start) - 1]
        assert a <= s.start and s.end <= b
