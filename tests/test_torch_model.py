"""The port's model against the JAX one: prefill, then greedy decode steps
on the paged KV cache, granite smoke under a non-identity placement
(fp32, CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_bridge import placed_params, smoke_configs  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    init_paged_decode_cache,
    prefill,
)

torch.set_num_threads(1)

BS = 4  # KV block size
N_MAX = 6  # blocks per row: 24 positions


def _install(pool, new, blocks):
    """new (L, 1, P, KV, hd) → rows of ``blocks`` in pool (L, N, bs, …)."""
    L, _, P = new.shape[:3]
    padded = np.zeros((L, len(blocks) * BS) + new.shape[3:], new.dtype)
    padded[:, :P] = new[:, 0]
    pool[:, blocks] = padded.reshape(L, len(blocks), BS, *new.shape[3:])


@pytest.mark.parametrize("expert_tp", [1, 2])
def test_prefill_then_decode_matches_jax(expert_tp):
    jcfg, tcfg = smoke_configs(expert_tp=expert_tp)
    jparams, tparams, e2s = placed_params(jcfg, tcfg, seed=expert_tp)
    policy = host_policy()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n) for n in (7, 11)]
    tables = np.stack([np.arange(1, 1 + N_MAX), np.arange(7, 7 + N_MAX)])
    tables = tables.astype(np.int32)
    shape = (jcfg.num_layers, 1 + 2 * N_MAX, BS, jcfg.num_kv_heads,
             jcfg.head_dim)
    pools = {n: np.zeros(shape, np.float32) for n in ("k", "v")}

    tokens = []
    for row, prompt in enumerate(prompts):
        jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(prompt[None])},
                             jcfg, policy, jnp.asarray(e2s))
        tl, tc = prefill(tparams, torch.from_numpy(prompt[None]), tcfg,
                         torch.from_numpy(e2s))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        for n in ("k", "v"):
            jnew = np.asarray(jc["attn"][n])
            np.testing.assert_allclose(tc["attn"][n].numpy(), jnew,
                                       rtol=1e-5, atol=1e-5)
            _install(pools[n], jnew, tables[row])
        assert int(tl.argmax()) == int(np.asarray(jl).argmax())
        tokens.append(int(tl.argmax()))

    j_caches = {"attn": {n: jnp.asarray(pools[n]) for n in pools}}
    t_caches = init_paged_decode_cache(tcfg, shape[1], BS, device="cpu",
                                       dtype=torch.float32)
    for n in pools:
        t_caches["attn"][n].copy_(torch.from_numpy(pools[n]))
    cur_len = np.array([len(p) for p in prompts], np.int32)
    tokens = np.array(tokens, np.int32)
    for _ in range(6):
        jl, j_caches, jaux = jax_decode_step(
            jparams, j_caches, jnp.asarray(cur_len),
            jnp.asarray(tokens[:, None]), jcfg, policy, jnp.asarray(e2s),
            block_tables=jnp.asarray(tables), decode_mode="python",
        )
        tl, t_caches, taux = decode_step(
            tparams, t_caches, torch.from_numpy(cur_len),
            torch.from_numpy(tokens[:, None]), tcfg, torch.from_numpy(e2s),
            block_tables=torch.from_numpy(tables),
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(taux.expert_counts.numpy(),
                                      np.asarray(jaux.expert_counts))
        assert taux.expert_counts.shape == (jcfg.num_layers, jcfg.num_experts)
        np.testing.assert_array_equal(taux.dropped_tokens.numpy(),
                                      np.asarray(jaux.dropped_tokens))
        nxt = tl.argmax(dim=-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(nxt, np.asarray(jl).argmax(-1))
        tokens = nxt
        cur_len = cur_len + 1
    for n in pools:
        np.testing.assert_allclose(t_caches["attn"][n].numpy(),
                                   np.asarray(j_caches["attn"][n]),
                                   rtol=1e-5, atol=1e-5)
