"""The port's checkpoints, on the CPU: a round trip of a train state (fp32,
bf16 and int32 leaves), torn steps ignored, retention, each package
restoring the other's files at fp32 and bf16 (the bytes cross unchanged),
and the training launcher's resume reproducing an uninterrupted run.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro.training import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.training import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.bridge import state_from_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.training import AdamWConfig, init_train_state  # noqa: E402

torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"


def _state(dtype, compress=False):
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, seed=2, device="cpu", dtype=dtype)
    state = init_train_state(params, AdamWConfig(compress=compress))
    g = torch.Generator().manual_seed(5)
    for t in (state["opt"]["mu"]["embed"], state["opt"]["nu"]["final_norm"]):
        t.copy_(torch.randn(t.shape, generator=g))
    state["opt"]["step"].fill_(7)
    return state


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = v
    return out


def _bits(t) -> np.ndarray:
    """A leaf's bytes (torch or numpy, bf16 in any of its forms)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return np.ascontiguousarray(t.numpy()).view(np.uint8)
    a = np.ascontiguousarray(np.asarray(t))
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip(tmp_path, dtype):
    state = _state(dtype, compress=True)
    mgr = CheckpointManager(str(tmp_path))
    d = mgr.save(10, state, extra={"data": {"step": 10, "seed": 0}})
    assert sorted(os.listdir(d)) == ["COMMIT", "arrays.npz", "manifest.json"]
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 10
    paths = manifest["paths"]
    assert paths["opt/step"] == {"shape": [], "dtype": "int32"}
    assert paths["opt/mu/blocks/moe/w_gate"]["dtype"] == "float32"
    assert paths["ef_residual/embed"]["dtype"] == "float32"
    assert paths["params/blocks/moe/w_gate"]["dtype"] == str(dtype).split(".")[1]
    skeleton = _state(dtype, compress=True)
    back, extra, step = mgr.restore(skeleton)
    assert step == 10 and extra == {"data": {"step": 10, "seed": 0}}
    want, got = _flat(state), _flat(back)
    assert sorted(got) == sorted(want) == sorted(paths)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(w), err_msg=k)
    assert int(back["opt"]["step"]) == 7


def test_torn_steps_are_ignored_and_retention_keeps_the_newest(tmp_path):
    state = _state(torch.float32)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (10, 20, 30):
        mgr.save(step, state, extra={"n": step})
    assert mgr.committed_steps() == [20, 30]
    # a crash mid-save: a .tmp directory, and a step directory without COMMIT
    os.makedirs(tmp_path / "step_00000040.tmp")
    os.makedirs(tmp_path / "step_00000050")
    np.savez(tmp_path / "step_00000050" / "arrays.npz", x=np.zeros(1))
    assert mgr.latest_step() == 30
    _, extra, step = mgr.restore(_state(torch.float32))
    assert (step, extra) == (30, {"n": 30})
    with pytest.raises(FileNotFoundError, match="not committed"):
        mgr.restore(_state(torch.float32), step=50)
    with pytest.raises(FileNotFoundError, match="no committed"):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_manager_restores_a_port_checkpoint(tmp_path, dtype):
    state = _state(getattr(torch, dtype))
    CheckpointManager(str(tmp_path)).save(3, state, extra={"who": "port"})
    skeleton = jax.tree.map(np.asarray, _jax_state(dtype))
    back, extra, step = JaxCheckpointManager(str(tmp_path)).restore(skeleton)
    assert (step, extra) == (3, {"who": "port"})
    want, got = _flat(state), _flat(back)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(np.shape(got[k])) == tuple(w.shape), k
        np.testing.assert_array_equal(_bits(got[k]), _bits(w), err_msg=k)
    # the JAX side reads its bf16 leaves back as bfloat16
    w = np.asarray(back["params"]["blocks"]["moe"]["w_gate"])
    if dtype == "bfloat16":
        assert w.dtype.itemsize == 2
        np.testing.assert_array_equal(
            w.view(jnp.bfloat16).astype(np.float32),
            state["params"]["blocks"]["moe"]["w_gate"].float().numpy())


def _jax_state(dtype):
    cfg = jax_smoke_config(ARCH)
    params, _ = jax_init_params(cfg, jax.random.PRNGKey(4), host_policy(),
                                getattr(jnp, dtype))
    state = jax_init_train_state(params, JaxAdamWConfig())
    state["opt"]["step"] = jnp.asarray(12, jnp.int32)
    state["opt"]["mu"]["embed"] = jnp.full_like(state["opt"]["mu"]["embed"],
                                                0.25)
    return state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_restores_a_jax_checkpoint(tmp_path, dtype):
    state = _jax_state(dtype)
    JaxCheckpointManager(str(tmp_path)).save(12, state, extra={"who": "jax"})
    skeleton = _state(getattr(torch, dtype))
    back, extra, step = CheckpointManager(str(tmp_path)).restore(skeleton)
    assert (step, extra) == (12, {"who": "jax"})
    assert back["params"]["embed"].dtype == getattr(torch, dtype)
    assert back["opt"]["step"].dtype == torch.int32
    assert int(back["opt"]["step"]) == 12
    want = _flat(jax.tree.map(np.asarray, state))
    got = _flat(back)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(_bits(got[k]), _bits(w), err_msg=k)
    # and the bridge moves the same state across unchanged
    bridged = _flat(state_from_numpy(jax.tree.map(np.asarray, state), "cpu"))
    for k, t in bridged.items():
        np.testing.assert_array_equal(_bits(t), _bits(got[k]), err_msg=k)


def test_launcher_resume_reproduces_the_uninterrupted_run(tmp_path, capsys):
    """``--smoke --device cpu`` under a placement: 20 steps straight
    against 10 steps, a kill after the step-10 checkpoint, and a restart
    that runs the other 10. On the CPU the losses are equal bit for bit."""
    argv = ["--smoke", "--device", "cpu", "--steps", "20", "--batch", "2",
            "--seq-len", "16", "--placement-seed", "3"]
    straight = launch_train.run(launch_train.parse_args(argv))
    assert len(straight) == 20

    class Killed(Exception):
        pass

    def kill_at_10(step, metrics):
        if step == 10:
            raise Killed

    ckpt = ["--ckpt-dir", str(tmp_path)]
    with pytest.raises(Killed):
        launch_train.run(launch_train.parse_args(argv + ckpt),
                         on_step=kill_at_10)
    assert CheckpointManager(str(tmp_path)).committed_steps() == [10]
    capsys.readouterr()
    resumed = launch_train.run(launch_train.parse_args(argv + ckpt))
    assert capsys.readouterr().out.splitlines()[0] == "resumed at step 10"
    assert [h["step"] for h in resumed] == list(range(10, 20))
    for a, b in zip(resumed, straight[10:]):
        assert a["loss"] == b["loss"], a["step"]
        np.testing.assert_array_equal(a["expert_counts"], b["expert_counts"])
    assert CheckpointManager(str(tmp_path)).committed_steps() == [10, 20]
    losses = [h["loss"] for h in straight]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_launcher_main_prints_the_jax_launchers_lines(capsys, monkeypatch):
    assert launch_train.main(["--smoke", "--device", "cpu", "--steps", "6",
                              "--batch", "2", "--seq-len", "8", "--accum", "2",
                              "--compress-grads",
                              "--arch", "qwen2.5-14b"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[1] for line in out] == ["0", "5"]
    assert all(line.startswith("step ") and " loss " in line for line in out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--smoke", "--steps", "1"])
