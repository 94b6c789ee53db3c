"""What one step costs, read off its eager trace: FLOPs, bytes and peak
memory.

The port's counterpart of ``repro/launch/hlo_analysis.py::compute_stats``
for the dry run. :func:`trace_cost` runs a step function once under two
``TorchDispatchMode``s, usually on ``torch.device("meta")`` where nothing
is allocated or computed, and reports:

* ``flops`` — ``torch.utils.flop_counter.FlopCounterMode``'s total: 2·M·N·K
  for every matrix product (``mm``, ``bmm``, ``addmm``, …, ``einsum`` as
  the products it dispatches), the backward's included. Elementwise work,
  reductions, softmax and sorts count nothing, as ``compute_stats`` counts
  only ``dot``s. The JAX count differs by construction where the two
  programs express a product differently; ``tests/test_torch_dryrun.py``
  names each such term.
* ``bytes`` — for every dispatched op that is not a view, the bytes of its
  tensor operands plus those of its results: the unfused eager count (an
  in-place op counts the tensor it writes as operand and result). XLA
  counts per fused instruction, so the two are reported, not compared.
* ``peak_bytes`` — the most bytes of distinct storages alive at once during
  the step: the inputs given (parameters, moments, caches, batch) and every
  storage an op makes, until the last tensor on it dies (autograd's saved
  tensors included; a view adds nothing). The CUDA caching allocator
  rounds each block up to 512 bytes and holds cuBLAS's workspace, which
  this count leaves out.
* ``ops`` — the number of ops dispatched;
* ``collectives`` (given the step's ``mesh``) — what the rank's step
  calls of the mesh's collectives, by JAX's kind names
  (:func:`~repro_torch.launch.meta_mesh.record_collectives`), as JAX's
  ``collective_stats`` reports them beside ``compute_stats``. A
  collective's own work is not in ``flops`` or ``bytes`` (a metadata
  mesh dispatches only the stand-in it returns).
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .meta_mesh import record_collectives

__all__ = ["StepTracker", "trace_cost", "tree_bytes"]


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tree_bytes(tree) -> int:
    """The bytes of the tensors in a nested dict / list / tuple."""
    return sum(t.nelement() * t.element_size() for t in _tensors(tree))


class StepTracker(TorchDispatchMode):
    """Counts the bytes each op reads and writes, and the live storages'
    peak. :meth:`hold` registers tensors that exist before the step."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live until they
        die."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if not func.is_view:
            self.bytes += tree_bytes((args, kwargs)) + tree_bytes(out)
        self.hold(out)
        return out


def trace_cost(fn, *args, mesh=None, **kwargs):
    """``fn(*args, **kwargs)`` once under the counters: (its result, a dict
    of ``flops``, ``bytes``, ``peak_bytes`` and ``ops``, and with
    ``mesh`` the ``collectives`` the step calls on it). The tensors in the
    arguments count as live from the start."""
    flops = FlopCounterMode(display=False)
    tracker = StepTracker()
    tracker.hold((args, kwargs))
    log = None
    if mesh is not None:
        log = record_collectives(mesh)
        log.reset()
    with flops, tracker:
        out = fn(*args, **kwargs)
    cost = {
        "flops": int(flops.get_total_flops()),
        "bytes": int(tracker.bytes),
        "peak_bytes": int(tracker.peak_bytes),
        "ops": int(tracker.ops),
    }
    if log is not None:
        cost["collectives"] = log.stats()
    return out, cost
