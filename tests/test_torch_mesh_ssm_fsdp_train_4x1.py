"""``tests/test_torch_mesh_ssm_train.py`` at (4, 1) under FSDP (ZeRO-3:
every leaf JAX's specs shard over ``data`` stored as the rank's quarter,
gathered a layer at a time; one model rank, so every head on every rank)
against JAX's ``ShardingPolicy(mesh, fsdp=True)`` mesh path of the same
shape, in its own JAX subprocess."""
import pytest

pytest.importorskip("torch")

from test_torch_mesh_ssm_train import (  # noqa: E402
    ARCHS,
    check_grads,
    check_moments,
    check_step,
    run_case,
)

NAME = "4x1_fsdp"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_case(NAME, tmp_path_factory.mktemp("mesh_ssm_fsdp_4x1"))


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_mesh_path(results, arch):
    check_grads(results, NAME, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_mesh_step(results, arch):
    check_step(results, NAME, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_moments_hold_exactly_the_ranks_shard(results, arch):
    check_moments(results, NAME, arch)
