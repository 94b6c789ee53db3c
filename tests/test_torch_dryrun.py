"""The port's dry run (``repro_torch.launch``: ``specs``, ``cost``,
``dryrun``) against the JAX package's.

* Specs: for every applicable (config × shape) cell at full width, the
  meta-device trees of ``repro_torch.launch.specs.input_specs`` have the
  leaf paths, shapes, dtypes and total bytes of JAX's
  ``repro.launch.specs.input_specs(..., host_policy())``.
* FLOPs: on every smoke config, for a train, a prefill and a decode step,
  the port's count (``FlopCounterMode`` on meta) equals
  ``repro.launch.hlo_analysis.compute_stats(...)["flops"]`` over the JAX
  step compiled on the CPU, less the differences that the two programs
  have by construction, each named and counted exactly
  (:func:`named_terms`).
* ``run_cell``'s statuses follow ``shape_applicable``, and ``main`` exits 1
  when a cell errs.

``repro/launch/dryrun.py`` forces 512 host devices when imported, so this
file imports only ``repro.launch.specs`` and ``repro.launch.hlo_analysis``
from there, and builds the JAX step functions itself.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch.hlo_analysis import compute_stats  # noqa: E402
from repro.launch.specs import input_specs as jax_input_specs  # noqa: E402
from repro.models.model import decode_step as jax_decode_step  # noqa: E402
from repro.models.model import prefill as jax_prefill  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro.training.optimizer import AdamWConfig as JaxAdamW  # noqa: E402
from repro.training.train_step import make_train_step as jax_train_step  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCHS,
    SHAPES,
    ShapeSpec,
    get_config,
    get_smoke_config,
    shape_applicable,
)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.models.dispatch import slot_capacity  # noqa: E402

torch.set_num_threads(1)

CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if shape_applicable(get_config(a), SHAPES[s])[0]]
# small shapes of each kind for the FLOP comparison: the train step runs
# over 64 tokens a row, so every SSD block has at least two chunks
SMALL = {
    "train": ShapeSpec("train_small", 64, 2, "train"),
    "prefill": ShapeSpec("prefill_small", 32, 2, "prefill"),
    "decode": ShapeSpec("decode_small", 64, 2, "decode"),
}


def test_shape_table_is_the_jax_one():
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import shape_applicable as jax_applicable

    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for arch in ARCHS:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                jax_applicable(jax_get_config(arch), JAX_SHAPES[name])
    assert len(CELLS) == 33


def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): (tuple(x.shape),
                                                 np.dtype(x.dtype).name)
            for path, x in flat}


def _port_leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _nbytes(leaves: dict) -> int:
    size = {"bfloat16": 2, "float32": 4, "int32": 4}
    return sum(int(np.prod(s)) * size[d] for s, d in leaves.values())


@pytest.mark.parametrize("cell", CELLS, ids=["|".join(c) for c in CELLS])
def test_input_specs_match_jax_at_full_width(cell):
    arch, shape = cell
    ours = _port_leaves(input_specs(get_config(arch), SHAPES[shape]))
    theirs = _jax_leaves(jax_input_specs(
        jax_get_config(arch), SHAPES[shape], host_policy())[0])
    assert sorted(ours) == sorted(theirs)
    for path, leaf in theirs.items():
        assert ours[path] == leaf, path
    assert _nbytes(ours) == _nbytes(theirs)
    assert all(t.device.type == "meta"
               for t in _meta_leaves(input_specs(get_config(arch),
                                                 SHAPES[shape])))


def _meta_leaves(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k != "step":  # the optimizer's count lives on the host
                yield from _meta_leaves(v)
    else:
        yield tree


def _jax_step(config, shape):
    policy = host_policy()
    if shape.kind == "train":
        ts = jax_train_step(config, policy, JaxAdamW(), remat=True)
        return lambda state, batch, placements=None: ts(state, batch,
                                                        placements)
    if shape.kind == "prefill":
        return lambda params, batch, placements=None: jax_prefill(
            params, batch, config, policy, placements)
    return lambda params, caches, cur_len, tokens, placements=None: \
        jax_decode_step(params, caches, cur_len, tokens, config, policy,
                        placements)


def _jax_flops(config, shape) -> int:
    kwargs, _ = jax_input_specs(config, shape, host_policy())
    compiled = jax.jit(_jax_step(config, shape)).lower(**kwargs).compile()
    return int(compute_stats(compiled.as_text())["flops"])


def named_terms(cfg, shape) -> dict[str, int]:
    """JAX's FLOPs less the port's, by construction, term by term (each
    term 2·M·N·K of the products one side runs and the other does not).

    * ``tied_embedding``: with tied embeddings the JAX lookup is a one-hot
      (B·T, V_pad) × (V_pad, D) product; the port indexes the rows. The
      train step also differentiates it w.r.t. the table (a second one).
    * ``moe_backward_recompute`` (negative: the port's): the backward of
      the port's expert FFN (``kernels/autograd.py::MoEFFN``, the
      reference's Pallas-path VJP) recomputes x·W_gate and x·W_up; JAX's
      einsum path (the smoke configs' ``moe_backend``) differentiates
      through the products it kept.
    * ``xla_ssd_rewrites``: XLA's algebraic simplifier turns three
      multiply-and-reduce patterns of the SSD chunk's backward into dots
      (the D-skip's gradient and one other contracting head_dim, the
      (Q, Q) score gradient contracting the heads, the B/C gradient
      contracting the heads); the port runs them as elementwise products
      and sums, which count nothing.
    * ``ssd_carry_cotangents``: JAX's scan over the SSD chunks
      differentiates its carry at both ends: the zero state the first
      chunk starts from (the carried-state product's gradient w.r.t. that
      state) and the final state the train step discards (the last
      chunk's state update, two products). Torch's autograd runs neither:
      the zero state needs no gradient and the final state gets none.
    * ``dense_mix_one_hot`` (``moe_backend="dense_ref"``): JAX mixes the
      oracle's expert outputs with a one-hot (N, k, E) × (N, E, D)
      product, which XLA folds over k into one (N, E) × (E, D) product a
      token batch and layer; the train step's backward adds one more of
      that size (the mix's cotangent against the expert outputs). The
      port reads each token's k·tp rows by index and sums them, which
      counts nothing. The oracle runs no K1, so
      ``moe_backward_recompute`` does not apply to it.
    """
    B, kind = shape.global_batch, shape.kind
    P = cfg.num_patches if cfg.frontend == "vision" else 0
    T = 1 if kind == "decode" else shape.seq_len - P
    D, V = cfg.d_model, cfg.padded_vocab
    terms = {}
    if cfg.tie_embeddings:
        terms["tied_embedding"] = 2 * B * T * V * D * (2 if kind == "train"
                                                       else 1)
    dense_ref = cfg.is_moe and cfg.moe_backend == "dense_ref"
    if dense_ref:
        N = B * (1 if kind == "decode" else shape.seq_len)
        terms["dense_mix_one_hot"] = cfg.num_layers * 2 * N * (
            cfg.num_experts * D) * (2 if kind == "train" else 1)
    if kind == "train" and cfg.is_moe and not dense_ref:
        S = cfg.num_virtual_experts
        C = slot_capacity(B * shape.seq_len, cfg,
                          capacity_factor=cfg.capacity_factor, num_slots=S,
                          replicated=False)
        F = cfg.expert_d_ff // cfg.expert_tp
        terms["moe_backward_recompute"] = -cfg.num_layers * 2 * (
            2 * S * C * D * F)
    if kind == "train" and cfg.ssm_state > 0:
        Q = min(cfg.ssm_chunk, shape.seq_len)
        while shape.seq_len % Q:
            Q -= 1
        nc = shape.seq_len // Q
        nh, hd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        per_chunk = (2 * (2 * B * Q * nh * hd) + 2 * B * Q * Q * nh
                     + 2 * B * Q * N * nh)
        terms["xla_ssd_rewrites"] = cfg.num_layers * nc * per_chunk
        terms["ssd_carry_cotangents"] = cfg.num_layers * 3 * (
            2 * B * Q * nh * hd * N)
    return terms


FLOP_CASES = [(a, k) for a in ARCHS for k in SMALL]


@pytest.mark.parametrize("case", FLOP_CASES,
                         ids=["|".join(c) for c in FLOP_CASES])
def test_flops_match_jax_up_to_named_terms(case):
    arch, kind = case
    shape = SMALL[kind]
    ours = dryrun.measure(get_smoke_config(arch), shape)["cost"]["flops"]
    theirs = _jax_flops(jax_smoke(arch), shape)
    terms = named_terms(get_smoke_config(arch), shape)
    assert theirs - ours == sum(terms.values()), (theirs, ours, terms)


@pytest.mark.parametrize("kind", sorted(SMALL))
def test_oracle_flops_match_jax_up_to_named_terms(kind):
    """Granite's smoke steps under ``moe_backend="dense_ref"`` on both
    sides: every expert's three products on every token, counted alike."""
    shape = SMALL[kind]
    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              moe_backend="dense_ref")
    jcfg = dataclasses.replace(jax_smoke("granite-moe-3b-a800m"),
                               moe_backend="dense_ref")
    ours = dryrun.measure(cfg, shape)["cost"]["flops"]
    theirs = _jax_flops(jcfg, shape)
    terms = named_terms(cfg, shape)
    assert "dense_mix_one_hot" in terms
    assert "moe_backward_recompute" not in terms
    assert theirs - ours == sum(terms.values()), (theirs, ours, terms)
    # the oracle's expert products: three (N, D) × (D, F) a virtual expert
    # (and twice that again in the backward), over every token
    staged = dryrun.measure(get_smoke_config("granite-moe-3b-a800m"),
                            shape)["cost"]["flops"]
    assert ours > staged


def test_run_cell_records_the_moe_backend():
    cell = dryrun.run_cell("granite-moe-3b-a800m", SMALL["decode"],
                           config=get_smoke_config("granite-moe-3b-a800m"),
                           moe_backend="dense_ref")
    assert cell["status"] == "ok" and cell["moe_backend"] == "dense_ref"
    staged = dryrun.run_cell(
        "granite-moe-3b-a800m", SMALL["decode"],
        config=get_smoke_config("granite-moe-3b-a800m"))
    assert "moe_backend" not in staged
    assert cell["cost"]["flops"] > staged["cost"]["flops"]
    dense = dryrun.run_cell("qwen1.5-4b", SMALL["decode"],
                            config=get_smoke_config("qwen1.5-4b"),
                            moe_backend="dense_ref")
    assert dense["status"] == "ok" and "moe_backend" not in dense
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "granite-moe-3b-a800m", "--shape",
                     "decode_32k", "--moe-backend", "triton"])


def test_named_terms_cover_granites_prefill_gap():
    # granite's smoke prefill at batch 2 × 32: JAX counts 17,203,200, the
    # port 16,154,624; the gap is the one-hot lookup 2·2·32·64·128
    cfg = get_smoke_config("granite-moe-3b-a800m")
    terms = named_terms(cfg, ShapeSpec("p", 32, 2, "prefill"))
    assert terms == {"tied_embedding": 1_048_576}
    assert dryrun.measure(cfg, ShapeSpec("p", 32, 2, "prefill"))[
        "cost"]["flops"] == 16_154_624


def test_run_cell_statuses_follow_shape_applicable():
    for arch, shape in [("qwen1.5-4b", "long_500k"),
                        ("gemma-7b", "long_500k")]:
        cell = dryrun.run_cell(arch, shape)
        ok, why = shape_applicable(get_config(arch), SHAPES[shape])
        assert not ok and cell["status"] == "skipped"
        assert cell["reason"] == why
    cell = dryrun.run_cell("granite-moe-3b-a800m", "decode_32k")
    assert cell["status"] == "ok" and cell["mesh"] == "1xgpu"
    mem = cell["memory"]
    cfg = get_config("granite-moe-3b-a800m")
    assert mem["params_bytes"] == 2 * sum(
        int(np.prod(s)) for s, _ in _port_leaves(
            input_specs(cfg, SHAPES["decode_32k"])["params"]).values())
    # the dense KV cache: L × 2 × (128, 32768, KV, hd) bf16
    assert mem["caches_bytes"] == (cfg.num_layers * 2 * 128 * 32768
                                   * cfg.num_kv_heads * cfg.head_dim * 2)
    assert mem["grads_bytes"] == mem["moments_bytes"] == 0
    assert mem["peak_bytes"] >= mem["params_bytes"] + mem["caches_bytes"]
    assert cell["cost"]["flops"] > 0 and cell["cost"]["bytes"] > 0
    assert cell["hbm_source"] and cell["fits_hbm"] == (
        mem["peak_bytes"] <= cell["hbm_bytes"])


def test_train_cell_counts_grads_and_moments():
    cfg = get_smoke_config("mixtral-8x7b")
    m = dryrun.measure(cfg, SMALL["train"], remat=False)["memory"]
    assert m["grads_bytes"] == m["params_bytes"]
    assert m["moments_bytes"] == 4 * m["params_bytes"]  # fp32 ×2 of bf16
    # parameters, gradients and moments are all live at the update
    assert m["peak_bytes"] >= 6 * m["params_bytes"]


def test_main_writes_cells_and_exits_1_on_an_error(tmp_path, monkeypatch,
                                                   capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "qwen1.5-4b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    cells = json.loads(out.read_text())
    assert cells["qwen1.5-4b|long_500k|1xgpu"]["status"] == "skipped"

    def broken(*a, **k):
        raise RuntimeError("broken step")

    monkeypatch.setattr(dryrun, "build_step_fn", broken)
    assert dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k",
                        "--out", str(out)]) == 1
    cells = json.loads(out.read_text())
    bad = cells["mamba2-1.3b|long_500k|1xgpu"]
    assert bad["status"] == "error" and "broken step" in bad["error"]
    assert "RuntimeError" in bad["traceback"]
    assert "qwen1.5-4b|long_500k|1xgpu" in cells  # earlier cells kept
    assert "[error  ] mamba2-1.3b|long_500k|1xgpu" in capsys.readouterr().out


def test_cost_counts_views_once_and_saved_tensors():
    from repro_torch.launch.cost import trace_cost

    def step(x):
        v = x.view(4, 256)  # a view: no new storage, no bytes moved
        y = v * 2.0  # 4 KiB written
        return y.sum()

    x = torch.empty(1024, device="meta")
    _, c = trace_cost(step, x)
    assert c["peak_bytes"] == 4096 + 4096 + 4  # x, y, the sum
    assert c["flops"] == 0
    assert c["bytes"] == (4096 + 4096) + (4096 + 4)

    w = torch.empty(64, 64, device="meta", requires_grad=True)

    def train(a, w):
        h = torch.relu(a @ w)  # relu's output is saved for the backward
        return (h @ w).sum()

    a = torch.empty(8, 64, device="meta")
    loss, c = trace_cost(train, a, w)
    assert c["flops"] == 2 * (2 * 8 * 64 * 64)
    # w, a, relu(a@w) kept for the backward, h@w and the loss are live
    # together (a@w itself dies once relu has run)
    assert c["peak_bytes"] == 4 * (64 * 64) + 3 * (4 * 8 * 64) + 4


def test_meta_is_taken_only_when_asked_for():
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")
    cfg = get_smoke_config("granite-moe-3b-a800m")
    params = init_params(cfg, device="meta")
    moe = params["blocks"]["moe"]
    assert moe["w_gate"].device.type == "meta"
    assert moe["w_gate"].dtype == torch.bfloat16
    # the kernels' wrappers take their plain versions on meta (same shapes)
    S, C, D, F = 4, 3, 16, 8
    x = torch.empty((S, C, D), device="meta")
    w = torch.empty((S, D, F), device="meta")
    wd = torch.empty((S, F, D), device="meta")
    before = ops.launch_counts()
    assert ops.moe_ffn(x, w, w, wd).shape == (S, C, D)
    gates, ids, psum, counts = ops.topk_router(
        torch.empty((5, 8), device="meta"), 2, with_stats=True)
    assert (gates.shape, ids.shape, psum.shape, counts.shape) == (
        (5, 2), (5, 2), (8,), (8,))
    assert ops.launch_counts() == before
    # the CPU draw is the one it was: seeded, not empty
    cpu = init_params(cfg, device="cpu", dtype=torch.float32)
    again = init_params(cfg, device="cpu", dtype=torch.float32)
    assert torch.equal(cpu["embed"], again["embed"])
    assert float(cpu["embed"].abs().sum()) > 0
