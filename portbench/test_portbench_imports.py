"""What a run loads and reads: no JAX and nothing of the JAX package in
the process, no program in the reference, nothing from ``benchmarks/`` or
``results/``, and no result without a card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_levels(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
        check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    code = f"""
import importlib.util, sys
sys.argv = ["run.py"]
spec = importlib.util.spec_from_file_location("run", {str(HERE / 'run.py')!r})
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from portbench.bench import check, cli, serve, spec as s, trace
import repro_torch.serving, repro_torch.core, repro_torch.models
import repro_torch.kernels._build, repro_torch.training
b = s.load_json(s.ROOT / "BENCHMARK.json")
for m in b["end_to_end"] + b["per_layer"]:
    s.reader(m["name"])
"""
    mods = _top_levels(code)
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_no_program():
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}]
import portbench.reference.model
"""
    mods = _top_levels(code)
    assert "torch" in mods
    assert not mods & (FORBIDDEN | {"repro_torch"}), mods


def test_nothing_reads_the_old_benchmarks_or_results():
    for path in HERE.rglob("*.py"):
        if path.name.startswith("test_portbench_"):
            continue
        text = path.read_text()
        for word in ('"benchmarks', "'benchmarks", "benchmarks/",
                     '"results', "'results", "results/"):
            assert word not in text, (path, word)


def _run(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "granite.chat",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: a run would measure it")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_cell_kind_is_a_module_with_setup_window_and_judge():
    from portbench.bench import cli, serve

    assert cli.kind_module("serve") is serve
    for name in ("check", "cli", "spec", "train", "../serve", "Serve"):
        assert cli.kind_module(name) is None
