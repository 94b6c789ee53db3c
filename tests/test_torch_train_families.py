"""``loss_fn`` of the eight smoke configs without MoE layers against the
JAX ``loss_fn``: the loss and every gradient leaf, with recomputation on
and off (the set-up, the tolerances and the SSD families' 4-token chunks
are ``test_torch_train.py``'s)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import JAX_ARCHS, MOE_ARCHS, check_loss_and_grads  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", sorted(set(JAX_ARCHS) - set(MOE_ARCHS)))
def test_loss_and_grads_match_jax(arch, remat):
    check_loss_and_grads(arch, remat)
