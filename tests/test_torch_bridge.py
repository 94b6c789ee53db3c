"""The weight bridge, and the set-up the other port-vs-JAX parity tests
(``test_torch_*.py``) share.

Both packages get the same inputs: weights made by the JAX ``init_params``
and handed to the port through numpy (:mod:`repro_torch.bridge`), token ids
and activations drawn from ``np.random.default_rng``. Placements are
non-identity, because slot-order bugs are invisible at identity.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.moe import apply_placement as jax_apply_placement  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config as torch_smoke_config  # noqa: E402

ARCH = "granite-moe-3b-a800m"


def smoke_configs(**overrides):
    """(JAX config, port config) of granite smoke, same overrides on both."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **overrides)
    tcfg = dataclasses.replace(torch_smoke_config(ARCH), **overrides)
    return jcfg, tcfg


def placement(num_layers: int, num_slots: int, seed: int = 7):
    """A non-identity placement: (slot_to_expert, expert_to_slot), each
    (L, E_v) int32, one random permutation per layer."""
    rng = np.random.default_rng(seed)
    s2e = np.stack([rng.permutation(num_slots) for _ in range(num_layers)])
    e2s = np.argsort(s2e, axis=1)
    return s2e.astype(np.int32), e2s.astype(np.int32)


def placed_params(jcfg, tcfg, seed: int = 0):
    """JAX params with a non-identity placement applied, their port copy
    (fp32, CPU), and the (L, E_v) expert→slot tables."""
    params, _ = jax_init_params(
        jcfg, jax.random.PRNGKey(seed), host_policy(), jnp.float32
    )
    Ev = jcfg.num_experts * jcfg.expert_tp
    s2e, e2s = placement(jcfg.num_layers, Ev, seed=seed + 7)
    blocks = dict(params["blocks"])
    blocks["moe"] = jax_apply_placement(blocks["moe"], jnp.asarray(s2e))
    params = {**params, "blocks": blocks}
    tparams = params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu", torch.float32
    )
    return params, tparams, e2s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_copies_jax_params_exactly(dtype):
    jcfg, tcfg = smoke_configs(expert_tp=2)
    params, _ = jax_init_params(
        jcfg, jax.random.PRNGKey(1), host_policy(), getattr(jnp, dtype)
    )
    tree = jax.tree.map(np.asarray, params)
    tparams = params_from_numpy(tree, tcfg, "cpu", getattr(torch, dtype))

    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    want = dict(leaves(tree))
    got = dict(leaves(tparams))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape and g.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(
            g.float().numpy(), np.asarray(w, np.float32), err_msg=name
        )
