"""The port's serving engine against the JAX engine built with
``profile=None``: same weights, same non-identity placement, same requests;
ragged prompts, chunked prefill and a KV pool small enough to preempt.
The greedy token streams must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_bridge import placed_params, smoke_configs  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.kv_cache import PagedKVConfig as JaxPagedKVConfig  # noqa: E402
from repro.sharding import host_policy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineConfig,
    PagedKVConfig,
    ServingEngine,
    batch_arrivals,
)

torch.set_num_threads(1)

KNOBS = dict(
    max_batch=3, max_len=40, other_time_per_step=1e-3, prefill_chunk=4,
    prefill_time_per_token=1e-4,
)


def _run_both(num_blocks):
    jcfg, tcfg = smoke_configs(expert_tp=2)
    jparams, tparams, e2s = placed_params(jcfg, tcfg, seed=5)
    jeng = JaxServingEngine(
        jparams, jcfg, host_policy(),
        JaxEngineConfig(**KNOBS, kv=JaxPagedKVConfig(block_size=4,
                                                     num_blocks=num_blocks)),
        profile=None,
    )
    jeng.placements = jnp.asarray(e2s)
    teng = ServingEngine(
        tparams, tcfg,
        EngineConfig(**KNOBS, kv=PagedKVConfig(block_size=4,
                                               num_blocks=num_blocks)),
        device="cpu",
    )
    teng.placements = torch.from_numpy(e2s)
    rng = np.random.default_rng(21)
    lengths = [6, 9, 13, 6, 9]  # few distinct lengths: few JAX prefill traces
    prompts = [rng.integers(0, jcfg.vocab_size, size=n) for n in lengths]
    news = [8, 5, 10, 7, 6]
    for eng in (jeng, teng):
        eng.serve(batch_arrivals(prompts, news))
    return jeng, teng


@pytest.mark.parametrize("num_blocks", [None, 9], ids=["roomy", "preempting"])
def test_engine_token_streams_match_jax(num_blocks):
    jeng, teng = _run_both(num_blocks)
    assert len(teng.finished) == len(jeng.finished) == 5
    want = {r.uid: r for r in jeng.finished}
    for r in teng.finished:
        assert r.generated == want[r.uid].generated, r.uid
        assert r.preemptions == want[r.uid].preemptions
        assert r.finish_time == pytest.approx(want[r.uid].finish_time)
        assert r.first_token_time == pytest.approx(
            want[r.uid].first_token_time
        )
    assert [r.uid for r in teng.finished] == [r.uid for r in jeng.finished]
    assert teng.step_count == jeng.step_count
    assert teng.preemption_count == jeng.preemption_count
    if num_blocks is not None:
        assert teng.preemption_count > 0  # the preemption path ran
    assert teng.sim_step_latencies == pytest.approx(jeng.sim_step_latencies)
    assert teng.kv_stats() == jeng.kv_stats()
    teng.kv_pool.check_invariants()
    # every decode step ran one MoE pass per layer over all slots
    assert teng.expert_counts.shape == (2, 8)
    assert int(teng.expert_counts.sum()) == 2 * 3 * 2  # L · max_batch · k
    assert teng.prefill_count >= 5 and teng.decode_count > 0
