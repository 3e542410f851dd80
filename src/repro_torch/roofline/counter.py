"""A step's cost, counted while it runs (the counterpart of the
reference's ``roofline/hlo_parse.py``, which walks compiled XLA HLO).

PyTorch runs eagerly, so the port has no HLO to parse: ``StepCost`` is a
``TorchDispatchMode`` that sees every aten op of one step on one rank,
forward and backward, on any device, the ``meta`` device included (the
dry run, ``launch.dryrun``), and counts:

  * FLOPs  -- dot products only, as the reference counts HLO ``dot``s:
              2 * prod(result) * prod(contracted) for ``mm``, ``addmm``,
              ``bmm``, ``baddbmm``, ``mv``, ``addmv`` and ``dot`` (what
              ``einsum``, ``matmul`` and ``linear`` decompose into).
              Convolutions and elementwise ops are not counted; the stock
              ``torch.utils.flop_counter`` total, which counts
              convolutions, is kept as ``raw_flops``.
  * bytes  -- input plus output bytes of each op: in eager PyTorch every
              op is its own kernel, which reads its inputs from HBM and
              writes its outputs there. Views and allocations without a
              write (``_NO_TRAFFIC``) move none, as the reference's
              ``_NO_TRAFFIC`` says of bitcasts and constants.
              ``raw_bytes`` counts every op.
  * collectives -- every ``c10d`` and ``_c10d_functional`` collective:
              its kind, its group's size and its result's bytes, which
              ``analysis.parse_collectives`` turns into ring bytes.
  * memory -- the bytes of live storages: those of the step's arguments
              (``hold``) and each storage an op creates, until it is
              freed; ``peak`` is the most at once.

A hand-written kernel's launch goes through ``ctypes`` and is opaque to
any dispatch mode: its wrapper calls ``note`` with the work it did, which
each active ``StepCost`` adds to its counts.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, \
    _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# the dot ops, and the position of the operand whose last dim is contracted
_DOTS = {aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.dot: 0,
         aten.addmm: 1, aten.baddbmm: 1, aten.addmv: 1}
# ops that move no bytes besides the views (``OpOverload.is_view``):
# allocations without a write, and views that the schema does not mark
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten._unsafe_view,
               aten.lift_fresh, aten.lift_fresh_copy}

# collective ops by name: (kind, the result's size against the value the
# op receives); n is the group's size
_KINDS = {"all_reduce": "all-reduce", "allreduce_": "all-reduce",
          "all_reduce_coalesced": "all-reduce",
          "allreduce_coalesced_": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "allgather_": "all-gather", "_allgather_base_": "all-gather",
          "allgather_into_tensor_coalesced_": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "reduce_scatter_": "reduce-scatter",
          "_reduce_scatter_base_": "reduce-scatter",
          "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
          "alltoall_base_": "all-to-all",
          "send": "collective-permute", "recv_": "collective-permute"}


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors in an op's arguments or results: nested tuples, lists
    and dicts (a fast walk; it runs on every op)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _group_size(func, args) -> int:
    """The size of the group a collective runs over: the process group
    it holds (a ``c10d`` op) or names (a functional one)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name() \
                .endswith("c10d.ProcessGroup"):
            return dist.ProcessGroup.unbox(a).size()
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    raise ValueError(f"{func}: no process group among its arguments")


def _result_bytes(func, args, out) -> int:
    """Bytes of the collective's result per rank (what the reference reads
    off the HLO op's result shape): the output of a functional op, the
    tensors an in-place c10d op writes (its first argument)."""
    res = out if func.namespace == "_c10d_functional" else args[0]
    return sum(nbytes(t) for t in _tensors(res))


class StepCost(TorchDispatchMode):
    """Count one step: ``with StepCost() as cost: cost.hold(args);
    step(*args)``. Read ``flops``, ``bytes``, ``raw_flops``,
    ``raw_bytes``, ``calls`` [(kind, n, result bytes)], ``kernels``
    (noted launches by name),
    ``arg_bytes`` and ``peak`` after it."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._stock = flop_registry
        self.flops = 0
        self.raw_flops = 0
        self.bytes = 0
        self.raw_bytes = 0
        self.calls: List[Tuple[str, int, int]] = []
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.arg_bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, weakref.ref] = {}
        self._args: set = set()
        self._lock = threading.RLock()

    # -- memory ---------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage live until it is freed; the bytes it
        added (0 when already counted)."""
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._storages:
                return 0
            size = st.nbytes()

            def freed(_, key=key, size=size):
                with self._lock:
                    self._storages.pop(key, None)
                    self.live -= size
            self._storages[key] = weakref.ref(st, freed)
            self.live += size
            self.peak = max(self.peak, self.live)
            return size

    def hold(self, *trees) -> int:
        """Count the storages of the tensors in ``trees`` (nested dicts,
        lists, tuples, modules' parameters and buffers, DTensors' local
        blocks) as live from now: the step's arguments. Returns the bytes
        they added to ``arg_bytes``."""
        added = 0
        for t in _arg_tensors(trees):
            added += self._track(t)
            self._args.add(t.untyped_storage()._cdata)
        self.arg_bytes += added
        return added

    def out_bytes(self, tree) -> int:
        """The bytes of the storages of ``tree``'s tensors that the step
        created and that are still live (its outputs)."""
        seen, total = set(self._args), 0
        for t in _arg_tensors((tree,)):
            st = t.untyped_storage()
            if st._cdata not in seen and st._cdata in self._storages:
                seen.add(st._cdata)
                total += st.nbytes()
        return total

    # -- ops ------------------------------------------------------------------
    def note(self, name: str, flops: int = 0, nbytes_: int = 0) -> None:
        """A kernel launch the dispatch cannot see: its dot-equivalent
        FLOPs and the bytes it reads and writes."""
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                           "bytes": 0})
        k["launches"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes_)
        self.flops += int(flops)
        self.bytes += int(nbytes_)
        self.raw_bytes += int(nbytes_)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and t is not torch.nn.Parameter
               for t in types):
            return NotImplemented            # a subclass unwraps first
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        moved = sum(map(nbytes, ins)) + sum(map(nbytes, outs))
        self.raw_bytes += moved
        packet = func._overloadpacket
        if not (func.is_view or packet in _NO_TRAFFIC):
            self.bytes += moved
        if packet in _DOTS:
            a = args[_DOTS[packet]]
            self.flops += 2 * outs[0].numel() * a.shape[-1]
        if packet in self._stock:
            self.raw_flops += int(self._stock[packet](
                *args, **kwargs, out_val=out))
        if func.namespace in ("c10d", "_c10d_functional"):
            kind = _KINDS.get(packet.__name__)
            if kind is not None:
                self.calls.append((kind, _group_size(func, args),
                                   _result_bytes(func, args, out)))
        if not func.is_view:
            for t in outs:     # an in-place op's storage is counted already
                self._track(t)
        return out


def _arg_tensors(trees):
    from torch.distributed.tensor import DTensor
    for tree in trees:
        if isinstance(tree, torch.nn.Module):
            yield from tree.parameters()
            yield from tree.buffers()
            continue
        for x in tree_leaves(tree):
            if isinstance(x, DTensor):
                yield x._local_tensor
            elif isinstance(x, torch.Tensor):
                yield x
            elif isinstance(x, torch.nn.Module):
                yield from _arg_tensors((x,))


def active() -> List[StepCost]:
    """The ``StepCost`` modes on the current dispatch mode stack."""
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, StepCost)]


def note(name: str, flops: int = 0, nbytes_: int = 0) -> None:
    """Note a kernel launch's work to every active ``StepCost`` (none:
    nothing)."""
    for mode in active():
        mode.note(name, flops, nbytes_)
