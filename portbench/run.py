#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 portbench/run.py --workload granite.chat --seed 7 --seconds 50 --trace 0

It measures the PyTorch and CUDA port (``src/repro_torch``) on the CUDA
device and prints one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, with
``--trace 1``, ``breakdown``; ``checks`` last, each number compared with
its limit (also the last lines of standard error). Without enough CUDA
devices it exits with 2 and prints no result. Caches of compiled kernels
stay inside the checkout.
"""
import os
import sys
import time

T_ORIGIN = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    cache = os.path.join(HERE, ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from portbench.bench import cli

    return cli.main(cli.parse_args(argv), T_ORIGIN)


if __name__ == "__main__":
    raise SystemExit(main())
