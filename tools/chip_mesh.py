"""Run ``chip_smoke.py``'s ``build``, ``mesh`` and ``mesh_train`` phases
alone on the card(s).

    python3 tools/chip_mesh.py [--nccl]

from the root of a checkout on a machine with an H100 and the CUDA
toolkit. With one card it serves granite-moe-3b-a800m at full width with
4 gloo ranks sharing it (one world of ranks a phase, started once:
``repro_torch.launch.mesh.World``), at (1, 4) and (2, 2) in JAX's
model-axis layout (each rank its shard of every leaf and its block of the
KV cache), against
one-process runs (``chip_smoke.MESH_PINNED_LAYERS`` layers in bf16 on one
process's router logits and tokens, and ``chip_smoke.MESH_FP32_LAYERS``
layers in fp32 as they come), then under the FSDP decode policy at
(4, 1) (``policy_for``'s, for full granite: the weights over ``data``,
the activations replicated, the KV cache's rows over ``data``;
``chip_smoke.MESH_FSDP_LAYERS`` layers, bf16, held to one process bit for
bit); then trains granite at ``chip_smoke.MESH_TRAIN_LAYERS`` layers with
4 gloo ranks at (1, 4), and under FSDP
(``policy_for(mesh, step_kind="train")``) at (2, 2) and (4, 1), against
one process, with a save from FSDP (2, 2) restored at (4, 1). The SSM
and hybrid families follow (each rank its SSD heads): mamba2-1.3b at full
width, 8 layers, and zamba2-1.2b at full width, 7 layers (one stage and
the shared attention + MLP block, one tail block), served at (1, 4) and
(2, 2) in fp32 against one process, mamba2 also at (1, 4) in bf16 pinned
to one process's tokens, each also against its witness (one process
doing the mesh's sums, ``chip_smoke._MeshSums``); mamba2 at 4 layers
trained at (1, 4) and under FSDP at (2, 2). Every gloo run is first predicted by the mesh dry run
(``chip_smoke.mesh_predictions``, a metadata mesh: the bytes a rank holds
and the collectives a decode step runs), and held to it. With four
cards the gloo ranks get a card each, and the phases also serve at
(1, 4) and under the FSDP decode policy at (4, 1) in NCCL
``decode_mode="scan"`` (full granite in bf16, profiling three replays of
rank 0's captured step, the FSDP run held bit for bit; and fp32 at
``chip_smoke.MESH_FP32_LAYERS`` layers, held to one process exactly) and train full granite over NCCL
at (1, 4) and under FSDP at (2, 2) (profiling one more step on every
rank). The phases' checks raise on
failure; their JSON lines are ``chip_smoke.py``'s. The kernels' table rows
are not measured here (``chip_smoke.py``'s ``kernels`` phase measures
them). ``--nccl`` (four cards) runs only what needs them: the NCCL
``"scan"`` serves (granite, then mamba2 at its whole depth in bf16 and
at 8 layers in fp32 held to one process and to its witness, one capture
a rank) and the
NCCL training of full granite, each against its one-process run. A rank
function that captured a graph with NCCL inside frees it before the
process group is destroyed (``launch/mesh.py::spawn``): NCCL's teardown
hangs behind a live graph.
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
    if sys.argv[1:] == ["--nccl"]:
        print(chip_smoke.nccl_paths(), flush=True)
        sys.exit(0)
    t0 = time.perf_counter()
    pred = chip_smoke.mesh_predictions()
    chip_smoke._check_granite_predictions(pred)
    chip_smoke.emit({"phase": "dryrun", "mesh_predictions": pred})
    print("mesh predictions seconds", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    unmeasured = dict.fromkeys(("shape", "ms", "device_us", "plain_ms",
                                "library_ms", "bound_ms", "bound_by",
                                "bound_share"))
    print(chip_smoke.phase_mesh({"moe_ffn/decode_rank": unmeasured}, pred))
    print("mesh phase seconds", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    print(chip_smoke.phase_mesh_train(
        dict.fromkeys(chip_smoke.MESH_TRAIN_KERNEL_ROWS, unmeasured), pred))
    print("mesh_train phase seconds", time.perf_counter() - t0, flush=True)
