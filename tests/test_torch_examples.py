"""The port's examples (``examples/torch_*.py``) run on the CPU.

* ``torch_placement_study.py`` prints what ``placement_study.py`` prints,
  byte for byte: both run the same numpy core.
* ``torch_quickstart.py --device cpu`` prints the Step 1–4 lines of
  ``quickstart.py`` byte for byte (the profile line's host wall seconds
  masked), a data-plane Δ of 0 under the GEM placement, and serves every
  live request; with ``--moe-backend dense_ref`` as well, on the oracle. The JAX quickstart's numpy part (everything before its
  data plane) is run from its own source, which spares its JAX compiles.
* ``torch_serve_moe.py --device cpu --requests 4`` serves every request.
* ``torch_train_small.py --device cpu`` is killed mid-run and relaunched:
  it resumes from its last checkpoint and ends with the loss of an
  uninterrupted run. The test swaps the example's 100M-parameter config
  for a small one (the module's ``CFG_100M``).
"""
import importlib.util
import re
import runpy
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ModelConfig  # noqa: E402

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _run(path: Path, argv, capsys) -> list[str]:
    old = sys.argv
    sys.argv = [str(path), *argv]
    try:
        runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out.splitlines()


def test_placement_study_prints_the_jax_lines(capsys):
    ours = _run(EXAMPLES / "torch_placement_study.py", [], capsys)
    theirs = _run(EXAMPLES / "placement_study.py", [], capsys)
    assert len(ours) > 10 and ours == theirs


def _mask_wall(line: str) -> str:
    return re.sub(r"in \d+\.\d+s wall", "in <wall>s wall", line)


def test_quickstart_steps_match_jax_and_the_data_plane_is_exact(
        capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the Chrome trace lands here
    ours = _run(EXAMPLES / "torch_quickstart.py", ["--device", "cpu"], capsys)
    src = (EXAMPLES / "quickstart.py").read_text()
    numpy_part = src[:src.index("# Data plane:")]
    old = sys.argv
    sys.argv = ["quickstart.py"]
    try:
        exec(compile(numpy_part, "quickstart.py", "exec"), {"__name__": "qs"})
    finally:
        sys.argv = old
    theirs = capsys.readouterr().out.splitlines()
    assert len(theirs) == 5
    assert [_mask_wall(x) for x in ours[:5]] == [_mask_wall(x) for x in theirs]
    plane = ours[5]
    assert plane.startswith("data plane [einsum] on cpu under GEM placement: ")
    assert "max|Δ| vs identity = 0.00e+00" in plane
    assert ours[6].startswith("served 8 live requests [cpu]: ")
    assert "wrote torch_quickstart_trace.json" in ours[7]
    assert (tmp_path / "torch_quickstart_trace.json").stat().st_size > 0


def test_quickstart_runs_the_oracle_plane(capsys, tmp_path, monkeypatch):
    """``--moe-backend dense_ref``: the oracle under the GEM placement
    equals its identity run bit for bit, drops nothing, and serves."""
    monkeypatch.chdir(tmp_path)
    ours = _run(EXAMPLES / "torch_quickstart.py",
                ["--device", "cpu", "--moe-backend", "dense_ref"], capsys)
    assert ours[5] == ("data plane [dense_ref] on cpu under GEM placement: "
                       "max|Δ| vs identity = 0.00e+00 (dropped=0.000)")
    assert ours[6].startswith("served 8 live requests [cpu]: ")


def test_serve_moe_serves_every_request(capsys):
    out = _run(EXAMPLES / "torch_serve_moe.py",
               ["--device", "cpu", "--requests", "4"], capsys)
    assert out[0] == ("policy=gem variability=high device=cpu "
                      "moe_backend=einsum online=False")
    assert out[1].startswith("served 4 requests in ")
    assert out[2] == "placement re-plan applied: True"
    assert any(x.startswith("  p99_tpot   = ") for x in out)
    assert out[-1].startswith("sample completion (uid=")


SMALL_LM = ModelConfig(
    name="lm-small", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
)


def _train_module():
    spec = importlib.util.spec_from_file_location(
        "torch_train_small", EXAMPLES / "torch_train_small.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.CFG_100M = SMALL_LM
    return mod


def _train(mod, ckpt, capsys) -> list[str]:
    old = sys.argv
    sys.argv = ["torch_train_small.py", "--device", "cpu", "--steps", "6",
                "--seq-len", "16", "--batch", "2", "--ckpt-every", "2",
                "--ckpt-dir", str(ckpt)]
    try:
        mod.main()
    finally:
        sys.argv = old
    return capsys.readouterr().out.splitlines()


def _loss_lines(lines):
    return [re.sub(r"\s+\(\d+\.\d+s\)$", "", x) for x in lines
            if x.startswith("step ")]


def test_train_small_resumes_after_a_kill(capsys, tmp_path, monkeypatch):
    mod = _train_module()
    straight = _train(mod, tmp_path / "a", capsys)
    assert straight[0].startswith("model: lm-small (")
    assert straight[-1] == "done; checkpoint saved."

    make = mod.make_train_step

    def killed_at_step_3(*a, **k):
        fn = make(*a, **k)
        calls = []

        def step(state, batch):
            if len(calls) == 3:
                raise KeyboardInterrupt  # the run is killed at step 3
            calls.append(1)
            return fn(state, batch)

        return step

    monkeypatch.setattr(mod, "make_train_step", killed_at_step_3)
    with pytest.raises(KeyboardInterrupt):
        _train(mod, tmp_path / "b", capsys)
    capsys.readouterr()
    monkeypatch.setattr(mod, "make_train_step", make)
    resumed = _train(mod, tmp_path / "b", capsys)
    assert "resumed from checkpoint at step 2" in resumed
    assert _loss_lines(resumed)[-1] == _loss_lines(straight)[-1]
    assert _loss_lines(straight)[-1].startswith("step    5  loss ")
