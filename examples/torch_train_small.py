"""Train a ~100M-parameter dense LM for a few hundred steps on the
PyTorch/CUDA port, with checkpoint/restart (kill it mid-run and relaunch —
it resumes exactly).

    PYTHONPATH=src python examples/torch_train_small.py --steps 300
    PYTHONPATH=src python examples/torch_train_small.py --device cpu

On the CUDA device unless ``--device cpu`` is given. The checkpoints are
the port's ``CheckpointManager``'s (the JAX package's file layout).
"""
import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.training import (
    AdamWConfig,
    DataConfig,
    SyntheticTokenStream,
    init_train_state,
    make_train_step,
)
from repro_torch.tree import leaves

CFG_100M = ModelConfig(
    name="lm-100m", family="dense", num_layers=10, d_model=640,
    num_heads=10, num_kv_heads=10, d_ff=2560, vocab_size=32000,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="results/torch_train_small_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the CUDA device (raises without one)")
    args = ap.parse_args()

    cfg = CFG_100M
    device = resolve_device(args.device)
    params = init_params(cfg, seed=0, device=device, dtype=torch.float32)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params)")

    opt = AdamWConfig(learning_rate=6e-4, warmup_steps=20,
                      total_steps=args.steps)
    step_fn = make_train_step(cfg, opt, remat=False)
    state = init_train_state(params, opt)
    data = SyntheticTokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch,
    ))

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if mgr.latest_step() is not None:
        state, extra, start = mgr.restore(state)
        data.load_state_dict(extra["data"])
        print(f"resumed from checkpoint at step {start}")

    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(data).items()}
        state, metrics = step_fn(state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  ({dt:.1f}s)")
        if (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state, extra={"data": data.state_dict()})
    mgr.save(args.steps, state, extra={"data": data.state_dict()})
    print("done; checkpoint saved.")


if __name__ == "__main__":
    main()
