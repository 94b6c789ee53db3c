"""The metric readers and the benchmark's definition: tails and rates over
every request, K1's count against the kernel table's bounds, the trace's
reductions, and the names, units and ``moves`` of ``BENCHMARK.json``."""
import math
import re
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.bench import spec, trace
from portbench.bench.serve import Rec, Run
from portbench.traffic.process import Request
from portbench.yardstick import k1, stats
from portbench.yardstick.flops import (active_param_count, decode_flops,
                                       prefill_flops)

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _rec(due, first, tokens, admit=None):
    spec_ = Request(due, np.zeros(4, np.int32), len(tokens), "t")
    r = Rec(spec_, due, due, SimpleNamespace(finish_step=0,
                                             generated=[1] * len(tokens)))
    r.first = first
    r.tokens = list(tokens)
    r.admit = due if admit is None else admit
    return r


def _window(n=40, stall_at=None, stall=0.0):
    """``n`` requests due every 0.1 s, each answered 50 ms after it is due
    and then a token every 20 ms; from ``stall_at`` on, the host stalls
    ``stall`` seconds before every token it hands out."""
    reqs = []
    for i in range(n):
        due = 0.1 * i
        times, t = [], due + 0.05
        for _ in range(9):
            if stall_at is not None and t >= stall_at:
                t += stall
            times.append(t)
            t += 0.02
        reqs.append(_rec(due, times[0], times[1:]))
    return Run(cell="c", seconds=4.0, setup_s=12.5, start=0.0, end=4.0,
               model={}, slots=8, requests=reqs, steps=[], prefills=[],
               decodes=[], waits=[], decode_event_ms=[])


def _read(name, run):
    return spec.reader(name)(run)


def test_tails_and_rate_read_every_request():
    run = _window()
    assert _read("ttft_p90_ms", run) == pytest.approx(50.0)
    assert _read("itl_p95_ms", run) == pytest.approx(20.0)
    assert _read("output_tokens_per_s", run) == pytest.approx(
        sum(1 + sum(t < 4.0 for t in r.tokens) for r in run.requests) / 4.0)
    assert _read("setup_s", run) == 12.5


def test_a_stall_moves_the_tails_and_the_rate():
    calm, stalled = _window(), _window(stall_at=1.0, stall=0.04)
    assert _read("itl_p95_ms", stalled) > 2 * _read("itl_p95_ms", calm)
    assert _read("ttft_p90_ms", stalled) > _read("ttft_p90_ms", calm) + 30
    assert (_read("output_tokens_per_s", stalled)
            < _read("output_tokens_per_s", calm))


def test_an_unanswered_request_is_the_slowest():
    run = _window(n=10)
    for r in run.requests[3:5]:
        r.first = math.nan
        r.tokens = []
    assert _read("ttft_p90_ms", run) is None  # the 90th is unanswered
    assert stats.percentile([1.0, math.inf], 50) == 1.0


@pytest.mark.parametrize("shape,bound_ms", [
    ((80, 4, 1536, 256), 0.0569),  # granite decode, bytes
    ((16, 4, 4096, 7168), 0.8417),  # Mixtral decode, bytes
    ((16, 1279, 4096, 7168), 3.645),  # Mixtral prefill, operations
])
def test_k1_count_is_the_tables_bound_when_slots_are_full(shape, bound_ms):
    S, C, D, F = shape
    full = k1.bound_s(S * C, S, D, F) * 1e3
    assert full == pytest.approx(bound_ms, rel=1e-3)
    # fewer assignments on as many slots, and as many on fewer slots
    assert k1.bound_s(S * C // 2, S, D, F) * 1e3 <= full
    assert k1.bound_s(S * C // 2, S // 2, D, F) * 1e3 < full
    assert k1.nbytes(S * C, S // 2, D, F) < k1.nbytes(S * C, S, D, F)


def test_model_flops_follow_the_param_count():
    m = spec.load_json(spec.HERE / "configs"
                       / "granite-moe-3b-a800m.json")["model"]
    n = active_param_count(m)
    assert 0.7e9 < n < 1.0e9  # "a800m"
    assert prefill_flops(m, 10) == pytest.approx(
        2 * n * 10 + 4 * 24 * 64 * 55 * 32)
    mx = spec.load_json(spec.HERE / "configs"
                        / "mixtral-8x7b-16l.json")["model"]
    assert decode_flops(mx, 9000) > decode_flops(mx, 4096)  # no window
    windowed = {**mx, "sliding_window": 4096}
    assert decode_flops(windowed, 9000) == decode_flops(windowed, 4096)


def _trace(ops, spans, window=(0.0, 10.0)):
    t = {"ops": sorted(ops, key=lambda o: o[1]), "window": window,
         "spans": {"step": [], "prefill": [], "decode": [], "wait": [],
                   **spans},
         "decode_counts": {}, "prefill_work": {}, "launches": {}}
    return t


def test_trace_busy_idle_and_gaps():
    ops = [("k", 1.0, 2.0), ("k", 1.5, 3.0), ("ffn_mma_kernel", 5.0, 6.0)]
    t = _trace(ops, {"wait": [(7.0, 10.0, -1)], "decode": [(4.0, 6.5, 0)],
                     "step": [(0.5, 6.5, 0)]})
    busy, win = trace.busy(t)
    assert (busy, win) == (3.0, 10.0)
    kinds = {k: b - a for k, a, b in trace.idle_gaps(t)}
    assert kinds == {"engine_host": 1.0, "decode": 2.0, "wait_arrivals": 4.0}
    run = _window()
    run.trace = t
    # the decode span (4.0, 6.5) holds 1 s of device work
    assert _read("device_idle.decode", run) == pytest.approx(100 * (1 - 1 / 2.5))
    out = trace.breakdown(t)
    assert out["device_ops"][0] == ["k", 2.5]
    assert len(out["idle_gaps"]) <= 10


def test_k1_roofline_readers_price_the_spans_work():
    D, F = 1536, 256
    counts = np.zeros((2, 40), np.int64)
    counts[:, :16] = 2  # 32 assignments a layer on 16 experts
    t = _trace([("void ffn_mma_kernel<1>", 1.0, 1.0 + 1e-4),
                ("other", 1.2, 1.3),
                ("void ffn_wgmma_kernel<2>", 3.0, 3.0 + 2e-4)],
               {"decode": [(0.9, 1.5, 7)], "prefill": [(2.9, 3.5, 0)]})
    t["decode_counts"] = {7: counts}
    t["prefill_work"] = {0: [[100, 20], [90, 18]]}
    m = {"d_model": D, "expert_d_ff": 2 * F, "expert_tp": 2}
    run = _window()
    run.model, run.trace = m, t
    want = 2 * k1.bound_s(64, 32, D, F) / 1e-4 * 100
    assert _read("k1_roofline.decode", run) == pytest.approx(want)
    want = (k1.bound_s(100, 20, D, F) + k1.bound_s(90, 18, D, F)) / 2e-4 * 100
    assert _read("k1_roofline.prefill", run) == pytest.approx(want)
    run.trace = None
    assert _read("k1_roofline.decode", run) is None


def test_span_readers():
    run = _window()
    run.steps = [(0.0, 0.1), (0.2, 0.3)]
    run.prefills = [(0.0, 0.05, 1000)]
    run.decodes = [(0.06, 0.08, [10, 20]), (0.2, 0.25, [11])]
    run.decode_event_ms = [20.0, 40.0]
    run.model = spec.load_json(spec.HERE / "configs"
                               / "granite-moe-3b-a800m.json")["model"]
    run.trace = _trace([], {})
    assert _read("engine_host_ms", run) == pytest.approx(
        (0.2 - 0.05 - 0.07) / 2 * 1e3)
    assert _read("prefill_ms_per_ktok", run) == pytest.approx(50.0)
    assert _read("decode_step_ms", run) == 30.0
    assert _read("admit_wait_p50_ms", run) == 0.0
    assert 0 < _read("decode_mfu", run) < 100
    assert 0 < _read("prefill_mfu", run) < 100


def test_names_units_and_characters():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        assert set(spec.load_json(spec.ROOT / c["file"])["reduced"]) == set(
            c["reduced"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_per_layer_metrics_cells_report_its_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"], (
                m["name"], cell)
    for cell in cells:
        got = [m for m in BENCH["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        assert len(got) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_a_layer_has_one_spelling():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len({s.lower() for s in layers}) == len(layers)
    assert all("\n" not in s and 0 < len(s) <= 200 for s in layers)
