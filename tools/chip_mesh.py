"""Run ``chip_smoke.py``'s ``build`` and ``mesh`` phases alone on the card(s).

    python3 tools/chip_mesh.py

from the root of a checkout on a machine with an H100 and the CUDA
toolkit. With one card it serves full granite-moe-3b-a800m with 4 gloo
ranks sharing it, at (1, 4) and (2, 2), against one-process runs; with
four cards the gloo ranks get a card each and the phase also runs NCCL
``decode_mode="scan"`` at (1, 4). The phase's checks raise on failure;
its JSON lines are ``chip_smoke.py``'s. The kernels' table row is not
measured here (``chip_smoke.py``'s ``kernels`` phase measures it).
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    import torch

    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_build()
    t0 = time.perf_counter()
    unmeasured = dict.fromkeys(("shape", "ms", "device_us", "plain_ms",
                                "library_ms", "bound_ms", "bound_by",
                                "bound_share"))
    print(chip_smoke.phase_mesh({"moe_ffn/decode_rank": unmeasured}))
    print("mesh phase seconds", time.perf_counter() - t0, flush=True)
