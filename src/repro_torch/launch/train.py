"""Training launcher: ``python -m repro_torch.launch.train``.

The port of ``repro/launch/train.py``: AdamW steps over the synthetic token
stream, with gradient accumulation, optional int8 gradient compression and
checkpoints every 10 steps, on the CUDA device unless ``--device cpu`` is
given. ``--arch`` takes the arch's full config in bfloat16 (fp32 moments),
``--smoke`` its smoke config in float32 as the JAX launcher trains it;
either gets the JAX launcher's capacity factor of 2.0 for MoE configs,
learning rate 1e-3 with 10 warm-up steps and a cosine to ``--steps``, and
no recomputation (``remat=False``). Weights are random from seed 0. With
``--placement-seed`` a MoE config trains under a seeded non-identity GEM
placement: the expert weights in slot order and the router remapped
through the (L, E_v) tables. With ``--ckpt-dir`` a run resumes from the
last committed step there, data stream included.

    python -m repro_torch.launch.train --arch granite-moe-3b-a800m --steps 20
    python -m repro_torch.launch.train --smoke --device cpu --steps 10
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import ARCHS, get_config, get_smoke_config
from ..device import resolve_device
from ..models import apply_placement, init_params
from ..training import (
    AdamWConfig,
    DataConfig,
    SyntheticTokenStream,
    init_train_state,
    make_train_step,
)

__all__ = ["build", "main", "parse_args", "placement", "run"]

CKPT_EVERY = 10


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS),
                    default="granite-moe-3b-a800m")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--smoke", action="store_true",
                    help="train the arch's smoke config instead of the full one")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the CUDA device (raises without one)")
    ap.add_argument("--placement-seed", type=int, default=None,
                    help="train a MoE config under a seeded non-identity "
                         "placement (default: identity)")
    return ap.parse_args(argv)


def placement(num_layers: int, num_slots: int, seed: int):
    """A seeded non-identity placement: (slot_to_expert, expert_to_slot),
    each (L, E_v) int32, one permutation per layer."""
    rng = np.random.default_rng(seed)
    s2e = np.stack([rng.permutation(num_slots) for _ in range(num_layers)])
    return s2e.astype(np.int32), np.argsort(s2e, axis=1).astype(np.int32)


def build(args: argparse.Namespace, *, mark=None) -> SimpleNamespace:
    """Everything a run of ``args`` needs, restored from the last committed
    checkpoint when there is one: ``cfg``, ``device``, ``state``,
    ``step_fn``, ``data``, ``mgr``, ``placements``, ``start``. ``mark`` goes
    to :func:`make_train_step`."""
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=2.0)
    dtype = torch.float32 if args.smoke else torch.bfloat16
    params = init_params(cfg, seed=0, device=device, dtype=dtype)
    placements = None
    if cfg.is_moe and args.placement_seed is not None:
        s2e, e2s = placement(cfg.num_layers, cfg.num_virtual_experts,
                             args.placement_seed)
        params["blocks"]["moe"] = apply_placement(params["blocks"]["moe"], s2e)
        placements = torch.from_numpy(e2s).to(device)
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=10,
                      total_steps=args.steps, compress=args.compress_grads)
    step_fn = make_train_step(cfg, opt, accum_steps=args.accum, remat=False,
                              mark=mark)
    state = init_train_state(params, opt)
    data = SyntheticTokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch * args.accum,
    ))
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        state, extra, start = mgr.restore(state)
        data.load_state_dict(extra["data"])
        print(f"resumed at step {start}")
    return SimpleNamespace(cfg=cfg, device=device, state=state,
                           step_fn=step_fn, data=data, mgr=mgr,
                           placements=placements, start=start)


def _to_device(batch: dict, device) -> dict:
    if device.type != "cuda":
        return {k: torch.from_numpy(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


def run(args: argparse.Namespace, *, on_step=None, mark=None) -> list[dict]:
    """Train ``args.steps`` steps (from the restored step on) and return
    each step's metrics on the host: ``step``, ``loss``, ``grad_norm``,
    ``lr`` and, for MoE configs, ``moe_dropped`` and ``expert_counts``
    (L, E). ``on_step(step, metrics)`` is called after each step is queued,
    with the metrics still on the device."""
    r = build(args, mark=mark)
    t0 = time.perf_counter()
    history = []
    for step in range(r.start, args.steps):
        r.state, metrics = r.step_fn(r.state, _to_device(next(r.data), r.device),
                                     r.placements)
        if on_step is not None:
            on_step(step, metrics)
        history.append({"step": step, **metrics})
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"({time.perf_counter() - t0:.1f}s)")
        if r.mgr and (step + 1) % CKPT_EVERY == 0:
            r.mgr.save(step + 1, r.state, extra={"data": r.data.state_dict()})
    return [{k: _host(v) for k, v in h.items()} for h in history]


def _host(v):
    if not isinstance(v, torch.Tensor):
        return v
    v = v.detach().cpu()
    return v.item() if v.dim() == 0 else v.numpy()


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
