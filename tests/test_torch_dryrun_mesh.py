"""The dry run on JAX's production meshes: every applicable cell's inputs
a rank holds, against JAX's, and the ``--mesh`` command line.

* For every applicable (arch × shape) cell at 16×16 and 2×16×16, rank 0's
  inputs from ``repro_torch.launch.specs.input_specs(config, shape,
  policy)`` (on meta; ``policy_for`` of a
  :class:`~repro_torch.launch.meta_mesh.MetaMesh` at the production
  shape) have JAX's ``NamedSharding.shard_shape`` of
  ``repro.launch.specs.input_specs(config, shape,
  policy_for(make_production_mesh(...)))``, leaf for leaf, and its dtype.
  JAX runs in a subprocess with 512 forced host devices and builds shapes
  only (``jax.eval_shape``), nothing compiled. One documented divergence
  (ROADMAP C6): an expert pool the model axis does not divide is whole
  over ``model`` (Mixtral's 8 experts over 16 ranks; JAX's spec names
  ``model`` and GSPMD pads).
* ``python -m repro_torch.launch.dryrun --mesh 16x16`` (``main``) on a cut
  set of cells exits 0 and writes each under ``arch|shape|16x16``, with
  a rank's memory and its collectives by JAX's kind names.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import run_jax  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import policy_for  # noqa: E402
from repro_torch.launch.meta_mesh import KINDS, production_meta_mesh  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.sharding import is_expert_leaf  # noqa: E402

MESHES = ("16x16", "2x16x16")
CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if shape_applicable(get_config(a), SHAPES[s])[0]]


def jax_shards(payload):
    """Each cell's input leaves on JAX's production mesh: (global shape,
    spec, dtype) by path (in a subprocess with 512 forced host
    devices)."""
    import jax

    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import get_config as jax_get_config
    from repro.launch.mesh import make_production_mesh
    from repro.launch.mesh import policy_for as jax_policy_for
    from repro.launch.specs import input_specs as jax_input_specs

    assert jax.device_count() == 512
    out = {}
    for name in payload["meshes"]:
        mesh = make_production_mesh(multi_pod=name == "2x16x16")
        for arch, shape_name in payload["cells"]:
            cfg, shape = jax_get_config(arch), JAX_SHAPES[shape_name]
            policy = jax_policy_for(mesh, step_kind=shape.kind,
                                    global_batch=shape.global_batch,
                                    config=cfg)
            kwargs, _ = jax_input_specs(cfg, shape, policy)
            flat, _ = jax.tree_util.tree_flatten_with_path(kwargs)
            out[(name, arch, shape_name)] = {
                "/".join(str(k.key) for k in path): (
                    tuple(x.shape), tuple(x.sharding.spec),
                    np.dtype(x.dtype).name)
                for path, x in flat}
    return out


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    return run_jax("test_torch_dryrun_mesh:jax_shards",
                   {"meshes": MESHES, "cells": CELLS},
                   tmp_path_factory.mktemp("dryrun_mesh"), devices=512)


def _port_leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _shard_shape(path, shape, spec, mesh):
    """JAX's ``shard_shape`` of a leaf, with the port's one divergence:
    a pool the model axis does not divide is whole over ``model``."""
    parts = path.split("/")
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        if (axes == ("model",) and is_expert_leaf(tuple(parts))
                and dim % mesh.size("model")):
            axes = ()
        n = mesh.size(axes) if axes else 1
        assert dim % n == 0, (path, shape, spec)
        out.append(dim // n)
    return tuple(out)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_rank_inputs_are_jax_shards(jax_out, mesh_name):
    mesh = production_meta_mesh(mesh_name)
    for arch, shape_name in CELLS:
        cfg, shape = get_config(arch), SHAPES[shape_name]
        policy = policy_for(mesh, step_kind=shape.kind,
                            global_batch=shape.global_batch, config=cfg)
        ours = _port_leaves(input_specs(cfg, shape, policy))
        theirs = jax_out[(mesh_name, arch, shape_name)]
        assert sorted(ours) == sorted(theirs), (arch, shape_name)
        for path, (full, spec, dtype) in theirs.items():
            want = _shard_shape(path, full, spec, mesh)
            assert ours[path] == (want, dtype), (arch, shape_name, path,
                                                 spec)


def test_main_mesh_16x16_writes_a_ranks_cells(tmp_path):
    out = tmp_path / "dry.json"
    cells = [("mamba2-1.3b", "decode_32k"), ("zamba2-1.2b", "long_500k"),
             ("granite-moe-3b-a800m", "long_500k")]
    for arch, shape in cells:
        assert dryrun.main(["--arch", arch, "--shape", shape, "--mesh",
                            "16x16", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert sorted(got) == sorted(f"{a}|{s}|16x16" for a, s in cells)
    for key, cell in got.items():
        arch = key.split("|")[0]
        if arch.startswith("granite"):  # full attention: no 500k decode
            assert cell["status"] == "skipped"
            continue
        assert cell["status"] == "ok" and cell["mesh"] == "16x16"
        assert set(cell["collectives"]["counts"]) == set(KINDS)
        assert cell["collectives"]["total_count"] > 0
        mem = cell["memory"]
        assert mem["params_bytes"] > 0 and mem["caches_bytes"] > 0
        assert mem["peak_bytes"] >= mem["params_bytes"] + mem["caches_bytes"]
