"""``tests/test_torch_mesh_ssm_train.py`` at (2, 2) without FSDP: the
batch's rows over ``data`` (two a rank), the SSD heads, the tied
vocabulary and zamba2's shared block over ``model``, each rank's
gradients summed over ``data`` (and the B/C leaves' over ``model``)
against JAX's mesh path of the same shape (its own file and JAX
subprocess, so that the shapes run side by side)."""
import pytest

pytest.importorskip("torch")

from test_torch_mesh_ssm_train import (  # noqa: E402
    ARCHS,
    check_grads,
    check_moments,
    check_step,
    run_case,
)

NAME = "2x2"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_case(NAME, tmp_path_factory.mktemp("mesh_ssm_train_2x2"))


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_mesh_path(results, arch):
    check_grads(results, NAME, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_mesh_step(results, arch):
    check_step(results, NAME, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_moments_hold_exactly_the_ranks_shard(results, arch):
    check_moments(results, NAME, arch)
