"""Serving launcher: ``python -m repro_torch.launch.serve``.

The port of ``repro/launch/serve.py``: the continuous-batching engine with
GEM's one-shot control plane, on the CUDA device unless ``--device cpu``
is given. The variability profile comes from the emulated staircase fleet
(``setup_speeds`` → ``DeviceFleet`` → ``profile_fleet``), as in the JAX
launcher; the weights are random from seed 0. ``--arch`` takes the arch's
full config in bfloat16, ``--smoke`` its smoke config in float32 as the
JAX launcher serves it; either gets the JAX launcher's decode capacity
factor of 4.0.

    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m
    python -m repro_torch.launch.serve --smoke --device cpu --requests 4
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..core import (
    DeviceFleet,
    GEMConfig,
    VariabilityProfile,
    profile_fleet,
    setup_speeds,
    simulator_measure_fn,
)
from ..device import resolve_device
from ..models import init_params
from ..serving import EngineConfig, ServingEngine

__all__ = ["build", "emulated_profile", "main", "parse_args"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS),
                    default="granite-moe-3b-a800m")
    ap.add_argument("--policy", default="gem", choices=("gem", "eplb", "linear"))
    ap.add_argument("--variability", default="high",
                    choices=("high", "moderate", "low"))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--num-devices", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the arch's smoke config instead of the full one")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the CUDA device (raises without one)")
    return ap.parse_args(argv)


def emulated_profile(variability: str, num_devices: int) -> VariabilityProfile:
    """Step-2 on the emulated fleet: staircase devices at the spread of
    ``variability``, profiled at the tile boundaries up to 512 tokens."""
    fleet = DeviceFleet.from_speeds(
        setup_speeds(variability, num_devices), tile=8, tile_time=40e-6,
    )
    return profile_fleet(
        simulator_measure_fn(fleet), num_devices,
        max_tokens=512, tile=8, repeats=5,
    ).profile


def build(args: argparse.Namespace) -> ServingEngine:
    """The engine of ``args`` with its requests submitted, not yet run."""
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, decode_capacity_factor=4.0)
    dtype = torch.float32 if args.smoke else torch.bfloat16
    params = init_params(cfg, seed=0, device=device, dtype=dtype)
    eng = ServingEngine(
        params, cfg,
        EngineConfig(max_batch=8, max_len=128,
                     gem=GEMConfig(trace_length=16, num_restarts=10),
                     placement_policy=args.policy,
                     other_time_per_step=2e-4),
        profile=emulated_profile(args.variability, args.num_devices),
        num_devices=args.num_devices, device=device,
    )
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab_size, size=int(rng.integers(8, 32))),
                   max_new_tokens=args.max_new_tokens)
    return eng


def main(argv=None) -> int:
    eng = build(parse_args(argv))
    done = eng.run()
    print(f"served {len(done)} requests, {eng.step_count} steps, "
          f"replan={eng.placement_applied}")
    for k, v in eng.latency_report().items():
        print(f"  {k} = {v:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
