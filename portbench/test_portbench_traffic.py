"""The traffic generator: deterministic in the seed, the same work for
every seed, lengths inside the mix's clips."""
import numpy as np
import pytest

from portbench.bench import spec
from portbench.traffic import process

MIXES = ("chat", "docqa")


def _mix(name):
    return spec.load_json(spec.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    t = _mix(name)
    a = process.generate(t, 32000, 2**31 + 17, 50)
    b = process.generate(t, 32000, 2**31 + 17, 50)
    assert [r.due for r in a] == [r.due for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert [r.max_new_tokens for r in a] == [r.max_new_tokens for r in b]
    assert [r.task for r in a] == [r.task for r in b]


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_the_schedule_and_differ_in_content(name):
    t = _mix(name)
    a = process.generate(t, 32000, 5, 80)
    b = process.generate(t, 32000, 6, 80)
    assert [r.due for r in a] == [r.due for r in b]
    assert [len(r.prompt) for r in a] == [len(r.prompt) for r in b]
    assert [r.max_new_tokens for r in a] == [r.max_new_tokens for r in b]
    assert [r.task for r in a] == [r.task for r in b]
    assert not all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_lengths_bands_and_rate(name):
    t = _mix(name)
    reqs = process.generate(t, 49155, 3, 400)
    lo, hi = t["prompt"]["clip"]
    assert all(lo <= len(r.prompt) <= hi for r in reqs)
    olo, ohi = t["output"]["clip"]
    assert all(olo <= r.max_new_tokens <= ohi for r in reqs)
    bands = {task["name"]: task["vocab_band"] for task in t["tasks"]}
    for r in reqs:
        b0, b1 = bands[r.task]
        assert r.prompt.min() >= int(b0 * 49155)
        assert r.prompt.max() < max(int(b0 * 49155) + 1, int(b1 * 49155))
    gaps = np.diff([0.0] + [r.due for r in reqs])
    assert abs(gaps.mean() * t["rate"] - 1.0) < 0.15
    assert process.max_len(t) >= hi + ohi + 1


def test_rate_override_keeps_the_mix():
    t = _mix("chat")
    slow = process.generate(t, 49155, 9, 60, rate=1.0)
    fast = process.generate(t, 49155, 9, 60, rate=4.0)
    assert np.isclose(slow[-1].due, 4 * fast[-1].due)
    assert [len(r.prompt) for r in slow] == [len(r.prompt) for r in fast]


def test_warmup_meets_the_longest_prompt():
    t = _mix("docqa")
    reqs = process.warmup(t, 32000, 11, 16, 20)
    assert len(reqs) == 16
    assert max(len(r.prompt) for r in reqs) == t["prompt"]["clip"][1]
    assert all(r.max_new_tokens == 20 and r.due == 0.0 for r in reqs)


def test_task_counts_follow_the_shares():
    tasks = [{"share": 0.5}, {"share": 0.5}]
    assert process._task_counts(tasks, 11) == [6, 5]
    assert sum(process._task_counts([{"share": 1.0}], 7)) == 7
