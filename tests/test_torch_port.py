"""The port stands alone: import isolation, no JAX in its sources, its
config copy equals the JAX one, and no silent CPU fallback."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
ARCH = "granite-moe-3b-a800m"


def test_import_leaves_jax_and_repro_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.bridge, repro_torch.configs\n"
        "import repro_torch.kernels.ops, repro_torch.models\n"
        "import repro_torch.serving, repro_torch.core, repro_torch.online\n"
        "import repro_torch.replication, repro_torch.kernels.collective\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "import repro_torch.training, repro_torch.checkpoint\n"
        "import repro_torch.kernels.autograd, repro_torch.tree\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+jax\b", re.M),
    re.compile(r"^\s*(import|from)\s+repro(\.|\s|$)", re.M),
    re.compile(r"scaled_dot_product_attention"),
    re.compile(r"torch\.compile"),
]


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_source_has_no_jax_or_library_attention(path):
    text = path.read_text()
    for pat in FORBIDDEN:
        assert not pat.search(text), f"{path}: {pat.pattern}"


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_copy_equals_jax(which):
    if which == "full":
        ours, ref = get_config(ARCH), jax_get_config(ARCH)
    else:
        ours, ref = get_smoke_config(ARCH), jax_smoke(ARCH)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    for prop in ("padded_vocab", "head_dim", "is_moe", "ffn_hidden"):
        assert getattr(ours, prop) == getattr(ref, prop), prop
    assert ours.num_virtual_experts == ref.num_experts * ref.expert_tp
    if which == "full":
        assert ours.param_count() == ref.param_count()
        assert ours.padded_vocab == 49280 and ours.num_virtual_experts == 80


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, device="cpu", dtype=torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, cfg, EngineConfig(max_batch=2, max_len=32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    eng = ServingEngine(
        params, cfg, EngineConfig(max_batch=2, max_len=32), device="cpu"
    )
    eng.submit(np.arange(5), max_new_tokens=3)
    done = eng.run()
    assert len(done) == 1 and len(done[0].generated) == 3
    assert eng.prefill_count == 1 and eng.decode_count == 3
    assert eng.expert_counts.shape == (cfg.num_layers, cfg.num_experts)


def test_launcher_replans_on_the_cpu_and_needs_cuda_otherwise(
        monkeypatch, capsys):
    from repro_torch.launch import serve

    argv = ["--smoke", "--requests", "3", "--max-new-tokens", "20"]
    assert serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "served 3 requests, 20 steps, replan=True"
    assert "  mean_tpot = " in "\n".join(out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(argv)


def test_sampling_greedy_ties_and_temperature():
    from repro_torch.serving.sampling import sample

    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert sample(logits).tolist() == [1, 0]  # first maximum, as jnp.argmax
    assert sample(logits).dtype == torch.int32
    with pytest.raises(ValueError):
        sample(logits, temperature=1.0)
    g = torch.Generator().manual_seed(0)
    hot = torch.tensor([[0.0, 50.0, 0.0, 0.0]])
    assert sample(hot, temperature=0.5, generator=g).tolist() == [1]


def test_bridge_checks_the_tree_against_the_config():
    from repro_torch.bridge import params_from_numpy

    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, device="cpu", dtype=torch.float32)

    def to_numpy(tree):
        if isinstance(tree, dict):
            return {k: to_numpy(v) for k, v in tree.items()}
        return tree.numpy()

    tree = to_numpy(params)
    back = params_from_numpy(tree, cfg, "cpu")
    assert torch.equal(back["blocks"]["moe"]["w_gate"],
                       params["blocks"]["moe"]["w_gate"])
    with pytest.raises(ValueError):
        params_from_numpy(
            dict(tree, embed=tree["embed"][:, :8]), cfg, "cpu"
        )
    with pytest.raises(KeyError):
        params_from_numpy({"embed": tree["embed"]}, cfg, "cpu")
