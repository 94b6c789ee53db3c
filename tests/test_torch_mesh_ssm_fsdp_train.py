"""``tests/test_torch_mesh_ssm_train.py`` at (2, 2) under FSDP (ZeRO-3:
the SSD projections' ``d_model`` and the vocabulary's other dim over
``data``, the heads over ``model``; each layer's blocks gathered over
``data`` before it runs, the gathers' adjoints reduce-scattering the
gradients) against JAX's ``ShardingPolicy(mesh, fsdp=True)`` mesh path of
the same shape, in its own JAX subprocess; and the elastic re-mesh: the
(2, 2) ranks save their trained state (``CheckpointManager.save(…,
mesh=…)``), which restores whole bit for bit into each rank's shards, and
onto the (4, 1) FSDP layout's shards with ``restore_sharded``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import MeshAt, rank_shard, ranks, spec_of  # noqa: E402
from test_torch_mesh_ssm_train import (  # noqa: E402
    ARCHS,
    OPT,
    STEPS,
    cfg_of,
    check_grads,
    check_moments,
    check_step,
    flat,
    restore_rank,
    run_case,
    specs_of,
)
from repro_torch.bridge import state_to_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.training import AdamWConfig, init_train_state  # noqa: E402

torch.set_num_threads(1)

NAME = "2x2_fsdp"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ssm_fsdp_2x2")
    port, jax_out = run_case(NAME, tmp, save=tmp / "ckpt")
    restored = ranks(restore_rank, 4, 1, tmp / "restore", True, tmp / "ckpt")
    return port, jax_out, restored, tmp / "ckpt"


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_mesh_path(results, arch):
    check_grads(results[:2], NAME, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_mesh_step(results, arch):
    check_step(results[:2], NAME, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_moments_hold_exactly_the_ranks_shard(results, arch):
    check_moments(results[:2], NAME, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_save_from_fsdp_2x2_restores_at_4x1(results, arch):
    """The save holds every (2, 2) rank's leaves whole (each rank's state
    is its block of the whole restore, bit for bit), and each (4, 1) rank
    restores exactly its block of it."""
    port, _, restored, root = results
    skeleton = init_train_state(init_params(
        cfg_of(arch), seed=0, device="cpu", dtype=torch.float32),
        AdamWConfig(**OPT))
    whole, _, step = CheckpointManager(f"{root}/{arch}").restore(skeleton)
    whole = flat(state_to_numpy(whole))
    assert step == STEPS
    for shape, ranks_out, key in (((2, 2), port, "state"),
                                  ((4, 1), restored, "state")):
        specs = specs_of(arch, shape, True)
        for rank, res in enumerate(ranks_out):
            got = flat(res[arch][key])
            assert got.keys() == whole.keys()
            for path, w in whole.items():
                want = rank_shard(w, spec_of(specs, path), shape, rank)
                assert np.array_equal(got[path], want), (shape, rank, path)
    assert all(r[arch]["step"] == STEPS for r in restored)
    assert MeshAt((4, 1), 0).size("data") == 4
