"""Per-card cost analysis of one traced step, over fake tensors.

The counterpart of ``src/repro/launch/hloanalysis.py``, which reads the
compiled HLO text of a sharded program.  The port has no HLO: it runs the
step eagerly over DTensors whose local shards are fake tensors, and
:class:`CostMode`, a ``TorchDispatchMode``, sees every aten op and custom
op that runs on the *local* tensors of this card (rank 0), after DTensor
has split each global op into its local op and its collectives.  From
those it derives the reference's roofline inputs, per card:

  * flops            -- ``torch.utils.flop_counter``'s formulas (matmuls,
                        convolutions, attention, and the custom ops' own
                        registered formulas) on local shapes;
  * bytes            -- eager HBM traffic: the input plus output bytes of
                        every op that moves data (views, factories that
                        only allocate, and collectives excluded);
  * coll, coll_count -- operand bytes and counts per collective type of
                        the ``_c10d_functional`` ops that DTensor emits,
                        with each call's bytes also split by link
                        (``coll_link``: a group inside one NVLink domain
                        of ``NVLINK_DOMAIN`` cards, or across nodes);
  * temp_bytes       -- the peak of live storages created during the step
                        (the arguments were made before it, so this is
                        the peak less the arguments);
  * output_bytes     -- the storages made during the step still alive
                        when it returns.

DTensor's own sharding propagation runs some ops on global shapes to learn
their output metadata; those runs are not counted.  A ``FlopCounterMode``
over DTensor ops counts global FLOPs instead (the dry-run records it as
``flops_rawhlo`` so that readers see the two side by side).
"""

from __future__ import annotations

import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .mesh import NVLINK_DOMAIN

COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops that allocate without writing, or move no data
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias", "wait_tensor",
         "_local_scalar_dense", "set_", "resize_"}


def _tensors(obj) -> list:
    """The tensors in ``obj``: op arguments and results are tensors, lists
    or tuples of them, dicts (kwargs) and scalars."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_crosses_nodes(group_name: str) -> bool:
    pg = dist.distributed_c10d._resolve_process_group(group_name)
    ranks = dist.get_process_group_ranks(pg)
    return len({r // NVLINK_DOMAIN for r in ranks}) > 1


class CostMode(TorchDispatchMode):
    """Counts the local work of the ops run under it (see the module
    docstring); read :meth:`result` after the step."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = defaultdict(int)
        self.coll_count = defaultdict(int)
        self.coll_link = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._storages = {}
        self._quiet = 0
        self._propagator = None

    # -- DTensor's metadata runs ------------------------------------------------
    def __enter__(self):
        prop = DTensor._op_dispatcher.sharding_propagator
        inner = prop._propagate_tensor_meta_non_cached

        def quiet(*args, **kwargs):
            self._quiet += 1
            try:
                return inner(*args, **kwargs)
            finally:
                self._quiet -= 1

        prop._propagate_tensor_meta_non_cached = quiet
        self._propagator = prop
        return super().__enter__()

    def __exit__(self, *exc):
        del self._propagator._propagate_tensor_meta_non_cached
        self.output_bytes = self.live
        return super().__exit__(*exc)

    # -- live storages --------------------------------------------------------------
    def _track(self, outs: list, ins: list) -> None:
        """Count the storages ``outs`` hold that the op made: not those of
        its inputs (an in-place op returns its input, whose storage may
        predate the step), nor those already counted."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages or key in seen:
                continue
            n = st.nbytes()
            self._storages[key] = (n, weakref.ref(st, self._freer(key)))
            self.live += n
            self.peak = max(self.peak, self.live)

    def _freer(self, key):
        def free(_):
            self.live -= self._storages.pop(key, (0, None))[0]
        return free

    # -- dispatch -------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor split it into local ops
        out = func(*args, **kwargs)
        if self._quiet or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if func.namespace == "_c10d_functional" and name in COLLECTIVES:
            kind = COLLECTIVES[name]
            n = sum(_nbytes(t) for t in _tensors(args))
            self.coll[kind] += n
            self.coll_count[kind] += 1
            group = [a for a in args if isinstance(a, str)][-1]
            self.coll_link["inter_node" if _group_crosses_nodes(group)
                           else "nvlink"] += n
        elif not (func.is_view or name in _FREE or func.namespace == "prim"):
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        if not func.is_view:
            self._track(outs, ins)
        return out

    def result(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll": dict(self.coll), "coll_count": dict(self.coll_count),
                "coll_link": dict(self.coll_link),
                "temp_bytes": self.peak,
                "output_bytes": getattr(self, "output_bytes", self.live)}


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under :class:`CostMode` and return the
    per-card counts with the reference's keys (``flops``, ``bytes``,
    ``coll``, ``coll_count``) and the port's (``coll_link``,
    ``temp_bytes``, ``output_bytes``)."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)      # held past the exit: output_bytes
    del out
    return mode.result()
