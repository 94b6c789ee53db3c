"""End-to-end serving on the PyTorch/CUDA port: a Mixtral-family MoE
served with batched requests through the continuous-batching engine, with
GEM profiling, trace collection, placement search and in-deployment expert
swap.

    PYTHONPATH=src python examples/torch_serve_moe.py [--policy gem|eplb|linear]
                                                      [--requests 24] [--arch ...]
                                                      [--device cpu]
                                                      [--moe-backend dense_ref]

On the CUDA device unless ``--device cpu`` is given (the plain PyTorch
versions of the kernels). ``--online`` switches the engine to the online
adaptation plane (drift-triggered replans, budgeted partial expert
migration); ``--slowdown-at N`` then injects a mid-run power cap on the
fastest device at engine step N so the variability-drift detector has
something to catch.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import (
    DeviceFleet,
    GEMConfig,
    profile_fleet,
    setup_speeds,
    simulator_measure_fn,
)
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import EngineConfig, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--policy", default="gem",
                    choices=("gem", "eplb", "linear"))
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--variability", default="high",
                    choices=("high", "moderate", "low"))
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the CUDA device (raises without one)")
    ap.add_argument("--online", action="store_true",
                    help="drift-triggered replans + budgeted migration")
    ap.add_argument("--moe-backend", default="einsum",
                    choices=("einsum", "pallas", "dense_ref"),
                    help="MoE data plane: the staged plane (einsum, pallas) "
                         "or the capacity-free oracle (dense_ref)")
    ap.add_argument("--slowdown-at", type=int, default=0,
                    help="(online) inject a 2x power cap on the fastest "
                         "device at this engine step (0 = never)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_smoke_config(args.arch), decode_capacity_factor=4.0
    )
    params = init_params(cfg, seed=0, device=device, dtype=torch.float32)

    # emulated 4-device fleet + Step-2 profile (tile=1 so the smoke model's
    # small per-step counts still differentiate placements)
    speeds = setup_speeds(args.variability, 4)

    def fleet_profile(sp):
        fleet = DeviceFleet.from_speeds(sp, tile=1, tile_time=40e-6)
        return profile_fleet(
            simulator_measure_fn(fleet), 4, max_tokens=512, tile=1, repeats=5
        ).profile

    profile = fleet_profile(speeds)

    eng = ServingEngine(
        params, cfg,
        EngineConfig(
            max_batch=8, max_len=128,
            gem=GEMConfig(trace_length=16, num_restarts=10),
            placement_policy=args.policy,
            other_time_per_step=2e-4,
            online=args.online,
            moe_backend=args.moe_backend,
        ),
        profile=profile, num_devices=4, device=device,
    )

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=int(rng.integers(8, 32)))
        eng.submit(prompt, max_new_tokens=args.max_new_tokens)

    t0 = time.perf_counter()
    if args.online and args.slowdown_at > 0:
        slow = speeds.copy()
        slow[int(np.argmax(slow))] /= 2.0
        slow_profile = fleet_profile(slow)
        steps = 0
        while eng.scheduler.has_work() and steps < 10_000:
            if steps == args.slowdown_at:
                eng.set_true_profile(slow_profile)
                print(f"[step {steps}] injected 2x slowdown on device "
                      f"{int(np.argmax(speeds))}")
            eng.step()
            steps += 1
        done = eng.finished
    else:
        done = eng.run()
    wall = time.perf_counter() - t0
    report = eng.latency_report()
    print(f"policy={args.policy} variability={args.variability} "
          f"device={device.type} moe_backend={args.moe_backend} "
          f"online={args.online}")
    print(f"served {len(done)} requests in {eng.step_count} engine steps "
          f"({wall:.1f}s wall on this host)")
    print(f"placement re-plan applied: {eng.placement_applied}")
    if eng.controller is not None:
        for r in eng.controller.replans:
            print(f"  replan @step {r['step']}: {r['reason']} "
                  f"moves={r['moves']} applied={r['applied']}")
        print(f"  migration charged: "
              f"{eng.controller.total_migration_cost*1e3:.3f} ms over "
              f"{eng.controller.total_moves} expert moves "
              f"(max {eng.controller.max_moves_in_step}/step)")
    print("simulated fleet latency (the paper's figure of merit):")
    for k in ("mean_tpot", "p90_tpot", "p99_tpot", "mean_e2e"):
        if k in report:
            print(f"  {k:10s} = {report[k]*1e3:8.3f} ms")
    sample = done[0]
    print(f"sample completion (uid={sample.uid}): {sample.generated[:12]}…")


if __name__ == "__main__":
    main()
