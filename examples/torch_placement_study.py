"""Placement-policy study on the port's GEM core: linear vs EPLB vs GEM
across variability setups, with an expert-placement map (which device
hosts each hot expert) — the paper's Fig. 17 as a console session.

    PYTHONPATH=src python examples/torch_placement_study.py

``repro_torch.core`` is the port's copy of the numpy control plane, so this
prints what ``examples/placement_study.py`` prints; no model runs and no
device is needed.
"""
import numpy as np

from repro_torch.core import (
    DeviceFleet,
    GEMConfig,
    WorkloadSpec,
    classify_experts,
    correlated_groups,
    eplb_placement,
    gem_place,
    generate_trace,
    latency_reduction,
    linear_placement,
    profile_fleet,
    setup_speeds,
    simulate_serving,
    simulator_measure_fn,
)
E, G = 16, 4
spec = WorkloadSpec(num_experts=E, top_k=2, tokens_per_step=2048,
                    num_consistent=3, num_temporal_groups=2,
                    temporal_group_size=2)
fit = generate_trace(spec, 16, seed=1, identity_seed=43)
unseen = generate_trace(spec, 384, seed=2, identity_seed=43)
cls = classify_experts(unseen)
groups = correlated_groups(unseen, r_thresh=0.5)
print(f"consistent experts: {cls.consistent.tolist()}")
print(f"temporal experts:   {cls.temporal.tolist()}")
print(f"correlated groups:  {groups}\n")

for setup in ("high", "moderate", "low"):
    fleet = DeviceFleet.from_speeds(setup_speeds(setup, G), tile=512)
    profile = profile_fleet(
        simulator_measure_fn(fleet), G, max_tokens=8192, tile=512, repeats=5
    ).profile
    placements = {
        "linear": linear_placement(E, G),
        "eplb": eplb_placement(fit, G),
        "gem": gem_place(fit, profile, GEMConfig(num_restarts=15)).placement,
    }
    base = simulate_serving([unseen], profile, [placements["linear"]],
                            other_time_per_step=1e-3)
    print(f"=== variability: {setup} (speeds "
          f"{np.round(setup_speeds(setup, G), 3).tolist()}) ===")
    for name, p in placements.items():
        sim = simulate_serving([unseen], profile, [p],
                               other_time_per_step=1e-3)
        red = latency_reduction(base, sim)
        bar = "█" * max(int(red * 2), 0)
        hot_on_slow = sum(
            1 for e in np.concatenate([cls.consistent, cls.temporal])
            if p.expert_to_device[e] == 0
        )
        print(f"  {name:7s} e2e −{red:5.2f}% {bar:24s} "
              f"placement={p.expert_to_device.tolist()} "
              f"hot-on-slow-device={hot_on_slow}")
    print()
