"""The mesh dry run's collectives against a real mesh's: each rank's
decode and train step of granite's, mamba2's and zamba2's smoke configs
(bf16, as the dry run's inputs) on four ``gloo`` ranks, its collectives
counted by wrapping the real ``Mesh``'s methods
(:func:`~repro_torch.launch.meta_mesh.record_collectives`), against
``repro_torch.launch.dryrun.measure`` of the same step on a
:class:`~repro_torch.launch.meta_mesh.MetaMesh` at the same rank and shape
(meta tensors, nothing computed): the count and the operand bytes of
every kind equal, rank for rank. Decode at (1, 4) and (2, 2), the train
step (recomputation on, as the dry run's) at (1, 4) and under
``policy_for(mesh, step_kind="train")`` (FSDP) at (2, 2), each under
``policy_for`` as the dry run takes it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import ranks  # noqa: E402
from repro_torch.configs import ShapeSpec, get_smoke_config  # noqa: E402
from repro_torch.launch.dryrun import measure  # noqa: E402
from repro_torch.launch.mesh import policy_for  # noqa: E402
from repro_torch.launch.meta_mesh import MetaMesh, record_collectives  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    identity_placement,
    init_decode_cache,
    init_params,
)
from repro_torch.models.model import decode_cache_rows  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    init_train_state,
    make_train_step,
)

torch.set_num_threads(1)

ARCHS = ("granite-moe-3b-a800m", "mamba2-1.3b", "zamba2-1.2b")
STEPS = {"decode": ShapeSpec("decode_small", 32, 4, "decode"),
         "train": ShapeSpec("train_small", 16, 4, "train")}
# (mesh shape, step kind)
RUNS = [((1, 4), "decode"), ((2, 2), "decode"), ((1, 4), "train"),
        ((2, 2), "train")]


def _policy(mesh, kind, cfg):
    return policy_for(mesh, step_kind=kind,
                      global_batch=STEPS[kind].global_batch, config=cfg)


def _real_step(mesh, arch, kind):
    """The step the dry run traces, on this rank's real tensors."""
    cfg = get_smoke_config(arch)
    shape = STEPS[kind]
    policy = _policy(mesh, kind, cfg)
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16,
                         policy=policy)
    tables = (identity_placement(cfg, cfg.num_layers, device="cpu")
              if cfg.is_moe else None)
    B, S = shape.global_batch, shape.seq_len
    rng = np.random.default_rng(0)
    log = record_collectives(mesh)
    log.reset()
    if kind == "decode":
        rows = decode_cache_rows(policy, B)
        caches = init_decode_cache(cfg, B if rows is None
                                   else rows.stop - rows.start, S,
                                   device="cpu", policy=policy)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))
                                  .astype(np.int32))
        with torch.no_grad():
            decode_step(params, caches, torch.tensor(S // 2,
                                                     dtype=torch.int32),
                        tokens, cfg, tables, policy=policy,
                        num_slots=cfg.num_virtual_experts if cfg.is_moe
                        else None)
    else:
        state = init_train_state(params, AdamWConfig())
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32))
            for k in ("tokens", "labels")}
        make_train_step(cfg, AdamWConfig(), policy=policy, remat=True)(
            state, batch, tables)
    return log.stats()


def _rank(mesh, kind):
    return {arch: _real_step(mesh, arch, kind) for arch in ARCHS}


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_mesh_collectives")
    return {(shape, kind): ranks(_rank, *shape, tmp / f"{kind}_{shape[0]}",
                                 kind)
            for shape, kind in RUNS}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,kind", RUNS,
                         ids=[f"{k}-{s[0]}x{s[1]}" for s, k in RUNS])
def test_meta_mesh_collectives_equal_a_real_meshs(real, arch, shape, kind):
    cfg = get_smoke_config(arch)
    for rank, res in enumerate(real[(shape, kind)]):
        meta = MetaMesh({"data": shape[0], "model": shape[1]}, rank)
        policy = _policy(meta, kind, cfg)
        assert policy.fsdp == (kind == "train")
        want = measure(cfg, STEPS[kind], policy=policy)["cost"]["collectives"]
        assert res[arch] == want, (rank, res[arch], want)
        assert want["total_count"] > 0
