"""``tests/test_torch_mesh_ssm_engine.py`` at (2, 2): the decode batch
over ``data`` (two rows a rank), the SSD heads, the tied vocabulary and
zamba2's shared block over ``model``, against JAX's mesh engine of the
same shape (its own file, so that the two shapes run side by side)."""
import pytest

pytest.importorskip("torch")

from test_torch_mesh_ssm_engine import (  # noqa: E402
    ARCHS,
    check_cache,
    check_tokens,
    run_both,
)

SHAPE = (2, 2)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(SHAPE, tmp_path_factory.mktemp("mesh_ssm_engine_2x2"))


@pytest.mark.parametrize("mode", ["scan", "python"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax_mesh_engine(results, arch, mode):
    check_tokens(*results, arch, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_holds_the_ranks_block_of_the_cache(results, arch):
    check_cache(results[0], arch, SHAPE)
