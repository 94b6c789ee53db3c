"""Quickstart on the PyTorch/CUDA port: GEM's four steps on a synthetic
workload, then the searched placement applied to the port's MoE data plane
and behind its serving engine.

    python examples/torch_quickstart.py                # on the CUDA device
    python examples/torch_quickstart.py --device cpu   # plain versions
    python examples/torch_quickstart.py --moe-backend dense_ref   # the oracle

(with ``src`` on ``PYTHONPATH``). The four steps run the port's numpy core
(``repro_torch.core``) and print what ``examples/quickstart.py`` prints.
The data plane runs the hand-written kernels on the card and their plain
PyTorch versions on the CPU, under ``--moe-backend`` (the JAX quickstart's
choices: ``einsum`` and ``pallas`` both name the staged plane,
``dense_ref`` the capacity-free oracle).
"""
import argparse

import numpy as np

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                help="default: the CUDA device (raises without one)")
ap.add_argument("--moe-backend", default="einsum",
                choices=("einsum", "pallas", "dense_ref"))
args = ap.parse_args()

from repro_torch.core import (  # noqa: E402
    DeviceFleet,
    GEMConfig,
    GEMPlanner,
    WorkloadSpec,
    generate_trace,
    latency_reduction,
    linear_placement,
    profile_fleet,
    setup_speeds,
    simulate_serving,
    simulator_measure_fn,
)

E, G, LAYERS = 16, 4, 1

# A 4-device node with one 12% straggler (the paper's high-variability setup)
fleet = DeviceFleet.from_speeds(setup_speeds("high", G), tile=512)

# Step-2: profile each device's token→latency staircase (minutes, not hours:
# samples only at tile boundaries)
prof = profile_fleet(simulator_measure_fn(fleet), G, max_tokens=8192, tile=512)
print(f"profiled {prof.num_samples} token counts per device in "
      f"{prof.wall_seconds:.2f}s wall")

# Step-1: observe 16 engine steps of router statistics
spec = WorkloadSpec(num_experts=E, top_k=2, tokens_per_step=2048)
planner = GEMPlanner(E, G, LAYERS, GEMConfig())
planner.set_profile(prof.profile)
fit = generate_trace(spec, 16, seed=1, identity_seed=7)
for t in range(fit.num_steps):
    planner.observe_step(0, fit.counts[t])

# Step-3: variability-aware placement search
plan = planner.plan()
print(f"placement: {plan.placements[0].expert_to_device.tolist()}")
print(f"predicted straggler-latency reduction: "
      f"{plan.predicted_improvement:.1f}% vs linear")

# Step-4 (evaluation): replay 256 unseen steps of the same workload
unseen = generate_trace(spec, 256, seed=99, identity_seed=7)
sim_linear = simulate_serving([unseen], prof.profile,
                              [linear_placement(E, G)])
sim_gem = simulate_serving([unseen], prof.profile, plan.placements)
print(f"measured e2e latency reduction on unseen steps: "
      f"{latency_reduction(sim_linear, sim_gem):.1f}%")
print(f"p99 TPOT: {sim_linear.tpot_percentile(0.99)*1e3:.3f} ms → "
      f"{sim_gem.tpot_percentile(0.99)*1e3:.3f} ms")

# Data plane: run the smoke-Mixtral MoE layer with the searched placement
# under the selected backend — outputs must match the same backend's
# identity placement regardless of placement (the permutation is exact,
# and each slot's rows go through the expert FFN alone).
import dataclasses  # noqa: E402

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import Placement  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.moe import (  # noqa: E402
    apply_placement, identity_placement, init_moe, moe_layer,
)

device = resolve_device(args.device)
cfg = dataclasses.replace(
    get_smoke_config("mixtral-8x7b"), capacity_factor=8.0
)
gen = torch.Generator(device=device).manual_seed(0)
params = init_moe(cfg, num_layers=1, dtype=torch.float32, device=device,
                  generator=gen)
lp = {k: v[0] for k, v in params.items()}
x = torch.randn((2, 16, cfg.d_model), generator=gen, device=device)
with torch.no_grad():
    y_ref, _ = moe_layer(x, lp, identity_placement(cfg, 1, device=device)[0],
                         cfg, backend=args.moe_backend)

# seed a balanced smoke-scale placement from the searched plan's ordering
# (the smoke config has fewer experts than the synthetic workload above)
Ev = cfg.num_experts * cfg.expert_tp
G_eff = min(G, Ev)
rank = np.argsort(
    np.argsort(plan.placements[0].expert_to_device[:Ev], kind="stable"),
    kind="stable",
)
pm = Placement(np.asarray(rank * G_eff // Ev, np.int32), G_eff)
lp_perm = {k: v[0] for k, v in apply_placement(
    {k: v[None] for k, v in lp.items()}, pm.slot_to_expert()[None]).items()}
lp_perm["router"] = lp["router"]
e2s = torch.as_tensor(pm.expert_to_slot(), device=device)
with torch.no_grad():
    y, aux = moe_layer(x, lp_perm, e2s, cfg, backend=args.moe_backend)
delta = float((y - y_ref).abs().max())
print(f"data plane [{args.moe_backend}] on {device.type} under GEM placement: "
      f"max|Δ| vs identity = {delta:.2e} "
      f"(dropped={float(aux.dropped):.3f})")

# Live traffic: the same data plane behind the continuous-batching serving
# front end — timestamped Poisson arrivals, paged KV blocks, chunked
# prefill/decode interleaving, per-request SLO percentiles.
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ArrivalConfig, EngineConfig, PagedKVConfig, ServingEngine, TaskProfile,
    generate_arrivals,
)
from repro_torch.telemetry import Telemetry, write_chrome_trace  # noqa: E402

serve_cfg = dataclasses.replace(
    get_smoke_config("mixtral-8x7b"),
    moe_backend=args.moe_backend, sliding_window=0,  # full attn → paged KV
    decode_capacity_factor=8.0,
)
serve_params = init_params(serve_cfg, seed=2, device=device,
                           dtype=torch.float32)
engine = ServingEngine(
    serve_params, serve_cfg,
    EngineConfig(
        max_batch=4, max_len=64, placement_policy="gem", replan_after=8,
        kv=PagedKVConfig(block_size=4, num_blocks=48),
        prefill_chunk=16, other_time_per_step=2e-5,
        # decode_mode="scan" (the default) captures the whole decode step
        # as one CUDA graph on the card, with the router tables as static
        # buffers — one capture serves any placement, including mid-run
        # migrations. decode_mode="python" runs the per-layer loop eagerly;
        # both generate identical tokens.
        decode_mode="scan",
    ),
    profile=prof.profile, num_devices=G,
    # the unified telemetry plane: span tracing on the simulated clock,
    # per-step straggler attribution, and a Chrome-trace export at the end
    telemetry=Telemetry(),
    device=device,
)
chat = TaskProfile("chat", prompt_buckets=(8, 16), output_mean=8.0,
                   output_bounds=(4, 12), vocab_band=(0.0, 1.0))
stream = generate_arrivals(
    ArrivalConfig(rate=2000.0, num_requests=8), serve_cfg.vocab_size,
    seed=3, mix=[(chat, 1.0)],
)
done = engine.serve(stream)
rep = engine.latency_report()
print(f"served {len(done)} live requests [{device.type}]: "
      f"ttft_p99={rep['ttft_p99']*1e3:.3f} ms "
      f"tpot_p99={rep['tpot_p99']*1e3:.3f} ms "
      f"kv_peak={rep['kv_peak_used_blocks']:.0f} blocks "
      f"replans={rep.get('replans', 0):.0f}")

# The run's telemetry: per-step straggler attribution (how much of the
# fleet's slack was load imbalance vs slow hardware) and a Chrome trace —
# load it in chrome://tracing or https://ui.perfetto.dev (one row per
# device, engine phases on top). JSONL export + schema:
# src/repro_torch/telemetry/.
n_events = write_chrome_trace(engine.telemetry, "torch_quickstart_trace.json",
                              example="torch_quickstart")
print(f"straggler slack: total={rep.get('attr_slack_total_s', 0)*1e3:.3f} ms "
      f"(load {rep.get('attr_load_frac', 0):.0%} / "
      f"variability {rep.get('attr_var_frac', 0):.0%}) — "
      f"wrote torch_quickstart_trace.json ({n_events} trace events)")
