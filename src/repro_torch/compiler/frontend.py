"""Tensor-expression frontend: ``compile_kernel`` and the ``dsl`` helpers
(the port's own copy of ``repro.compiler.frontend``).

A traced, NumPy-flavoured API over the compiler stack::

    from repro_torch.compiler import compile_kernel

    k = compile_kernel(lambda a, b: (a * b).seg_sum(64),
                       dict(a=32768, b=32768))
    out, info = k.run(k.random_inputs(), GGPUConfig(n_cus=4))

The callable is traced once with symbolic ``Tensor`` placeholders (one per
parameter, shapes from the ``shapes`` mapping). A ``Tensor`` is *lazy*: it
carries a shape and a per-element expression builder, so elementwise
chains fuse by construction — no intermediate arrays exist to store
(``repro_torch.compiler.opt`` module doc). The traced result lowers to both
G-GPU program variants via ``repro_torch.compiler.lower``.

Operators: ``+ - * // % & | ^ << >>`` (int32, engine ALU semantics),
``@`` (2-D matmul), ``Tensor.sum() / .seg_sum(seg)``, and the ``dsl``
namespace: ``dot``, ``fir`` (boundary-guarded convolution), ``xcorr``
(circular cross-correlation), ``stencil`` (constant-weight neighborhood
sum), ``rank_sort`` (scatter by rank — a computed store address), and
``wrap`` (circular index arithmetic).

``coarsen=C`` tiles C consecutive output elements onto one work item
(fewer wavefronts, more per-item work) — the workload half of the
CU/wavefront tiling the engine applies to ``n_items``.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.compiler import opt
from repro_torch.compiler.ir import (CompileError, Const, Expr, Item, Kernel,
                                     Load, children)
from repro_torch.compiler.ir import wrap32 as ir_wrap32
from repro_torch.compiler.lower import (DEFAULT_SCHEDULE, CompiledKernel,
                                        Schedule, lower_kernel)

Shape = Tuple[int, ...]


def _norm_shape(s) -> Shape:
    if isinstance(s, (int, np.integer)):
        return (int(s),)
    s = tuple(int(x) for x in s)
    if not s or any(x < 1 for x in s) or len(s) > 2:
        raise CompileError(f"unsupported shape {s}: need 1-D or 2-D, "
                           "positive dims")
    return s


def _size(s: Shape) -> int:
    n = 1
    for x in s:
        n *= x
    return n


class Tensor:
    """A lazy int32 tensor: shape + per-element expression builder (row-
    major linear index -> value expression)."""

    def __init__(self, shape: Shape, elem: Callable[[Expr], Expr]):
        self.shape = _norm_shape(shape)
        self.elem = elem

    @property
    def size(self) -> int:
        return _size(self.shape)

    # -- elementwise --------------------------------------------------------

    def _binary(self, other, op: str, rev: bool = False) -> "Tensor":
        if isinstance(other, (int, np.integer)):
            v = ir_wrap32(int(other))
            other = Tensor(self.shape, lambda i, _v=v: Const(_v))
        if not isinstance(other, Tensor):
            return NotImplemented
        if other.shape != self.shape:
            raise CompileError(f"shape mismatch: {self.shape} vs "
                               f"{other.shape} for {op!r}")
        a, b = (other, self) if rev else (self, other)
        return Tensor(self.shape,
                      lambda i: opt.binop(op, a.elem(i), b.elem(i)))

    def __add__(self, o):
        return self._binary(o, "add")

    def __radd__(self, o):
        return self._binary(o, "add", rev=True)

    def __sub__(self, o):
        return self._binary(o, "sub")

    def __rsub__(self, o):
        return self._binary(o, "sub", rev=True)

    def __mul__(self, o):
        return self._binary(o, "mul")

    def __rmul__(self, o):
        return self._binary(o, "mul", rev=True)

    def __floordiv__(self, o):
        return self._binary(o, "div")

    def __rfloordiv__(self, o):
        return self._binary(o, "div", rev=True)

    def __mod__(self, o):
        return self._binary(o, "rem")

    def __rmod__(self, o):
        return self._binary(o, "rem", rev=True)

    def __and__(self, o):
        return self._binary(o, "and")

    def __rand__(self, o):
        return self._binary(o, "and", rev=True)

    def __or__(self, o):
        return self._binary(o, "or")

    def __ror__(self, o):
        return self._binary(o, "or", rev=True)

    def __xor__(self, o):
        return self._binary(o, "xor")

    def __rxor__(self, o):
        return self._binary(o, "xor", rev=True)

    def __lshift__(self, o):
        return self._binary(o, "shl")

    def __rlshift__(self, o):
        return self._binary(o, "shl", rev=True)

    def __rshift__(self, o):
        return self._binary(o, "sra")

    def __rrshift__(self, o):
        return self._binary(o, "sra", rev=True)

    def __lt__(self, o):
        return self._binary(o, "slt")

    def __gt__(self, o):
        return self._binary(o, "slt", rev=True)

    def __neg__(self):
        return Tensor(self.shape,
                      lambda i: opt.sub(Const(0), self.elem(i)))

    # -- reductions ---------------------------------------------------------

    def seg_sum(self, seg: int) -> "Tensor":
        """Segmented sum: output ``i`` is the int32 sum of the ``seg``-long
        input segment ``[i*seg, (i+1)*seg)``."""
        n = self.size
        if seg < 1 or n % seg:
            raise CompileError(
                f"seg_sum: segment {seg} must divide the size {n}")
        return Tensor((n // seg,), lambda i: opt.reduce_sum(
            seg, lambda k: self.elem(opt.add(opt.mul(i, seg), k))))

    def sum(self) -> "Tensor":
        """Full reduction to one element."""
        return self.seg_sum(self.size)

    # -- matmul -------------------------------------------------------------

    def __matmul__(self, other: "Tensor") -> "Tensor":
        if not isinstance(other, Tensor):
            return NotImplemented
        if len(self.shape) != 2 or len(other.shape) != 2 \
                or self.shape[1] != other.shape[0]:
            raise CompileError(f"matmul shapes {self.shape} @ "
                               f"{other.shape} do not agree")
        m, kk = self.shape
        _, n = other.shape

        def elem(i: Expr) -> Expr:
            row = opt.div(i, n)
            col = opt.rem(i, n)
            return opt.reduce_sum(kk, lambda t: opt.mul(
                self.elem(opt.add(opt.mul(row, kk), t)),
                other.elem(opt.add(opt.mul(t, n), col))))

        return Tensor((m, n), elem)


class ScatterTensor:
    """A kernel result whose store *address* is computed per item (e.g.
    rank sort). ``addr``/``val`` map the item index expression to the
    output address (relative to the output base) and stored value."""

    def __init__(self, out_len: int, addr: Callable[[Expr], Expr],
                 val: Callable[[Expr], Expr]):
        self.out_len = out_len
        self.addr = addr
        self.val = val


# ---------------------------------------------------------------------------
# dsl namespace
# ---------------------------------------------------------------------------

class dsl:
    """Structured operators beyond the elementwise/NumPy surface."""

    @staticmethod
    def dot(a: Tensor, b: Tensor) -> Tensor:
        return (a * b).sum()

    @staticmethod
    def wrap(idx: Expr, n: int) -> Expr:
        """Circular index: ``idx - n if idx >= n else idx`` (for
        ``idx < 2n``) — compiles to the conditional-subtract idiom."""
        return opt.sub(idx, opt.guard(opt.cond("ge", idx, Const(n)),
                                      Const(n)))

    @staticmethod
    def fir(x: Tensor, h: Tensor) -> Tensor:
        """Boundary-guarded FIR filter: ``out[i] = sum_t h[t]*x[i-t]``
        for ``i - t >= 0``."""
        taps = h.size

        def elem(i: Expr) -> Expr:
            def term(t):
                j = opt.sub(i, t)
                return opt.guard(
                    opt.cond("ge", j, Const(0)),
                    opt.mul(x.elem(j), h.elem(t)))
            return opt.reduce_sum(taps, term)

        return Tensor(x.shape, elem)

    @staticmethod
    def xcorr(a: Tensor, b: Tensor) -> Tensor:
        """Circular cross-correlation:
        ``out[lag] = sum_i a[i]*b[(i+lag) mod n]``."""
        n = a.size
        if b.size != n:
            raise CompileError("xcorr operands must share a size")

        def elem(lag: Expr) -> Expr:
            return opt.reduce_sum(n, lambda i: opt.mul(
                a.elem(i), b.elem(dsl.wrap(opt.add(i, lag), n))))

        return Tensor(a.shape, elem)

    @staticmethod
    def stencil(x: Tensor, weights: Sequence[int],
                offsets: Sequence[int]) -> Tensor:
        """Constant-weight neighborhood sum with zero boundary:
        ``out[i] = sum_k w[k] * x[i + off[k]]`` for in-range indices."""
        if len(weights) != len(offsets):
            raise CompileError("stencil needs one weight per offset")
        n = x.size

        def elem(i: Expr) -> Expr:
            acc: Expr = Const(0)
            for w, off in zip(weights, offsets):
                if w == 0:
                    continue
                j = opt.add(i, Const(ir_wrap32(int(off))))
                term = opt.mul(x.elem(j), Const(ir_wrap32(int(w))))
                if off < 0:
                    term = opt.guard(opt.cond("ge", j, Const(0)), term)
                elif off > 0:
                    term = opt.guard(opt.cond("lt", j, Const(n)), term)
                acc = opt.add(acc, term)
            return acc

        return Tensor(x.shape, elem)

    @staticmethod
    def rank_sort(a: Tensor) -> ScatterTensor:
        """Stable rank sort (the paper's ``parallel_sel``): item ``i``
        stores ``a[i]`` at its rank — ``#{j : a[j] < a[i]}`` plus the tie
        count ``#{j < i : a[j] == a[i]}``. Branch-free arithmetic body
        (no wavefront divergence), scatter store."""
        n = a.size

        def addr(i: Expr) -> Expr:
            v = a.elem(i)

            def term(j):
                aj = a.elem(j)
                below = opt.lt_val(aj, v)
                # eq from the compares already in flight (CSE shares
                # ``below``): eq = !(aj<v | v<aj)
                eq = opt.binop(
                    "xor",
                    opt.binop("or", below, opt.lt_val(v, aj)), Const(1))
                return opt.add(below,
                               opt.binop("and", eq, opt.lt_val(j, i)))

            return opt.reduce_sum(n, term)

        return ScatterTensor(n, addr, lambda i: a.elem(i))


# ---------------------------------------------------------------------------
# compile_kernel
# ---------------------------------------------------------------------------

def compile_kernel(fn: Callable, shapes: Union[Dict[str, object],
                                               Sequence[object]],
                   name: Optional[str] = None,
                   coarsen: int = 1,
                   schedule: Optional[Schedule] = None) -> CompiledKernel:
    """Trace ``fn`` over symbolic tensors and lower to G-GPU programs.

    ``shapes`` maps the callable's parameter names to int / (rows, cols)
    shapes (a sequence is matched positionally). ``coarsen`` folds that
    many consecutive output elements into each work item.

    ``schedule`` selects the full lowering schedule (coarsening plus the
    hoist / branchy / peel codegen knobs — see ``repro_torch.compiler.lower.
    Schedule`` and the autotuner in ``repro_torch.compiler.autotune``). When
    given, its ``coarsen`` field is authoritative and the legacy
    ``coarsen`` argument must agree or stay at its default."""
    if schedule is None:
        schedule = Schedule(coarsen=coarsen)
    elif coarsen != 1 and coarsen != schedule.coarsen:
        raise CompileError(
            f"coarsen={coarsen} conflicts with schedule {schedule.label()}")
    coarsen = schedule.coarsen
    params = list(inspect.signature(fn).parameters)
    if isinstance(shapes, dict):
        missing = [p for p in params if p not in shapes]
        if missing:
            raise CompileError(f"no shape given for parameters {missing}")
        shape_list = [shapes[p] for p in params]
    else:
        if len(shapes) != len(params):
            raise CompileError(f"{len(params)} parameters but "
                               f"{len(shapes)} shapes")
        shape_list = list(shapes)

    arrays: Dict[str, int] = {}
    placeholders: List[Tensor] = []
    for p, s in zip(params, shape_list):
        shape = _norm_shape(s)
        arrays[p] = _size(shape)
        placeholders.append(
            Tensor(shape, lambda i, _p=p: Load(_p, i)))

    out = fn(*placeholders)
    if isinstance(out, Tensor):
        out = ScatterTensor(out.size, lambda i: i, out.elem)
    if not isinstance(out, ScatterTensor):
        raise CompileError(
            f"kernel must return a Tensor or ScatterTensor, got "
            f"{type(out).__name__}")

    if coarsen < 1 or out.out_len % coarsen:
        raise CompileError(
            f"coarsen={coarsen} must divide the output length "
            f"{out.out_len}")
    stores = []
    item = Item()
    for t in range(coarsen):
        idx = opt.add(opt.mul(item, coarsen), t)
        stores.append((out.addr(idx), out.val(idx)))

    kernel = Kernel(
        name=name or getattr(fn, "__name__", "kernel").replace(
            "<lambda>", "kernel"),
        arrays=arrays, out_len=out.out_len,
        n_items=out.out_len // coarsen, stores=stores)
    return lower_kernel(kernel, schedule)


# ---------------------------------------------------------------------------
# compile_graph: split one traced expression into a multi-kernel Program
# ---------------------------------------------------------------------------

class _GraphBuilder:
    """Trace-time stage accumulator for ``compile_graph``: each
    materialization appends one stage (a tensor whose elements land in a
    named virtual buffer earlier stages and graph inputs feed)."""

    def __init__(self):
        # (buffer name, the tensor/scatter whose elements fill it)
        self.stages: List[Tuple[str, object]] = []

    @staticmethod
    def buffer_name(idx: int) -> str:
        # the leading dot keeps generated names out of the identifier
        # space, so they can never collide with a graph parameter
        return f".s{idx}"

    def materialize(self, t: "GraphTensor") -> "GraphTensor":
        """Cut here: record ``t`` as a stage and return the tensor that
        reads the stage's output buffer."""
        if t.buffer is not None:
            return t
        buf = self.buffer_name(len(self.stages))
        self.stages.append((buf, t))
        return GraphTensor(t.shape, lambda i, _b=buf: Load(_b, i),
                           self, buffer=buf)


class GraphTensor(Tensor):
    """A ``Tensor`` that records *stage cuts* while tracing a graph:
    a reduction (``seg_sum``/``sum``/``@``) materializes its fused
    elementwise operands as map stages, and any further use of a reduced
    expression materializes the reduction itself — so one traced
    expression splits into a pipeline of individually-lowerable kernels
    at exactly the reduction boundaries. ``buffer`` names the virtual
    array this tensor *is* (a graph input or a stage output); ``None``
    means a fused, not-yet-materialized expression. Plain ``Tensor``
    operands (e.g. from ``dsl`` helpers) fuse into the consuming stage
    without extra cuts."""

    def __init__(self, shape: Shape, elem: Callable[[Expr], Expr],
                 builder: _GraphBuilder, has_reduce: bool = False,
                 buffer: Optional[str] = None):
        super().__init__(shape, elem)
        self.builder = builder
        self.has_reduce = has_reduce
        self.buffer = buffer

    def _lift(self, other):
        if isinstance(other, (int, np.integer)):
            v = ir_wrap32(int(other))
            return GraphTensor(self.shape, lambda i, _v=v: Const(_v),
                               self.builder)
        if isinstance(other, GraphTensor) and other.has_reduce:
            return self.builder.materialize(other)
        return other

    def _binary(self, other, op: str, rev: bool = False):
        me = (self.builder.materialize(self) if self.has_reduce else self)
        other = me._lift(other)
        if not isinstance(other, Tensor):
            return NotImplemented
        if other.shape != me.shape:
            raise CompileError(f"shape mismatch: {me.shape} vs "
                               f"{other.shape} for {op!r}")
        a, b = (other, me) if rev else (me, other)
        return GraphTensor(me.shape,
                           lambda i: opt.binop(op, a.elem(i), b.elem(i)),
                           self.builder)

    def __neg__(self):
        me = (self.builder.materialize(self) if self.has_reduce else self)
        return GraphTensor(me.shape,
                           lambda i: opt.sub(Const(0), me.elem(i)),
                           self.builder)

    def seg_sum(self, seg: int) -> "GraphTensor":
        n = self.size
        if seg < 1 or n % seg:
            raise CompileError(
                f"seg_sum: segment {seg} must divide the size {n}")
        src = self if self.buffer is not None \
            else self.builder.materialize(self)
        return GraphTensor((n // seg,), lambda i: opt.reduce_sum(
            seg, lambda k: src.elem(opt.add(opt.mul(i, seg), k))),
            self.builder, has_reduce=True)

    def __matmul__(self, other):
        if not isinstance(other, Tensor):
            return NotImplemented
        if len(self.shape) != 2 or len(other.shape) != 2 \
                or self.shape[1] != other.shape[0]:
            raise CompileError(f"matmul shapes {self.shape} @ "
                               f"{other.shape} do not agree")
        a = self if self.buffer is not None \
            else self.builder.materialize(self)
        b = other
        if isinstance(b, GraphTensor) and b.buffer is None:
            b = self.builder.materialize(b)
        m, kk = a.shape
        _, n = b.shape

        def elem(i: Expr) -> Expr:
            row = opt.div(i, n)
            col = opt.rem(i, n)
            return opt.reduce_sum(kk, lambda t: opt.mul(
                a.elem(opt.add(opt.mul(row, kk), t)),
                b.elem(opt.add(opt.mul(t, n), col))))

        return GraphTensor((m, n), elem, self.builder, has_reduce=True)


def _load_names(stores) -> set:
    """All array names a stage's store expressions read."""
    seen: set = set()
    names: set = set()
    work = [e for pair in stores for e in pair]
    while work:
        e = work.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, Load):
            names.add(e.array)
        work.extend(children(e))
    return names


def _stage_schedule(schedules, idx: int) -> Schedule:
    if schedules is None:
        return DEFAULT_SCHEDULE
    if isinstance(schedules, dict):
        s = schedules.get(idx)
    else:
        s = schedules[idx] if idx < len(schedules) else None
    return s if s is not None else DEFAULT_SCHEDULE


@dataclasses.dataclass
class Program:
    """A compiled multi-kernel graph: ``stages`` in topological order and
    the wiring of each stage's input arrays to graph inputs or earlier
    stages' outputs (``sources[idx][array] = ("input", name) |
    ("stage", j)``). Stage ``idx`` writes the virtual buffer ``.s{idx}``;
    the last stage's output is the graph's."""
    name: str
    stages: List[CompiledKernel]
    sources: List[Dict[str, Tuple[str, object]]]
    in_sizes: Dict[str, int]

    @property
    def out_len(self) -> int:
        return self.stages[-1].kernel.out_len

    def _stage_inputs(self, idx: int, inputs: Dict[str, np.ndarray],
                      outs: Dict[int, np.ndarray]) -> Dict[str, np.ndarray]:
        return {arr: (inputs[ref] if kind == "input" else outs[ref])
                for arr, (kind, ref) in self.sources[idx].items()}

    def reference(self, inputs) -> np.ndarray:
        """The graph's expected output: each stage's NumPy oracle chained
        through the stage wiring — the bit-exactness target for every
        execution strategy (host-staged or device-resident)."""
        inputs = {n: np.asarray(v, np.int32).reshape(-1)
                  for n, v in dict(inputs).items()}
        missing = set(self.in_sizes) - set(inputs)
        if missing:
            raise CompileError(f"missing inputs: {sorted(missing)}")
        outs: Dict[int, np.ndarray] = {}
        val = None
        for idx, ck in enumerate(self.stages):
            val = np.asarray(
                ck.reference(self._stage_inputs(idx, inputs, outs)),
                np.int32)
            outs[idx] = val
        return val

    def run_host(self, inputs, cfg, *, device=None) -> np.ndarray:
        """Execute stage-by-stage on the engine with host-staged chaining
        (download each stage's full output, re-stage it into the next
        stage's memory image) — the independently-run-stages baseline the
        device-resident serving path must match bit-exactly."""
        inputs = {n: np.asarray(v, np.int32).reshape(-1)
                  for n, v in dict(inputs).items()}
        outs: Dict[int, np.ndarray] = {}
        val = None
        for idx, ck in enumerate(self.stages):
            val, _ = ck.run(self._stage_inputs(idx, inputs, outs), cfg,
                            device=device)
            outs[idx] = val
        return val

    def random_inputs(self, lo: int = -100, hi: int = 100,
                      seed: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        return {n: rng.integers(lo, hi, ln).astype(np.int32)
                for n, ln in self.in_sizes.items()}


def compile_graph(fn: Callable, shapes: Union[Dict[str, object],
                                              Sequence[object]],
                  name: Optional[str] = None,
                  schedules: Union[Dict[int, Schedule],
                                   Sequence[Optional[Schedule]],
                                   None] = None) -> Program:
    """Trace ``fn`` and split it at reduction boundaries into a
    multi-kernel ``Program`` graph.

    Where ``compile_kernel`` fuses everything into one kernel,
    ``compile_graph`` cuts the traced expression wherever a reduction
    consumes a fused elementwise chain (the chain becomes a *map* stage)
    and wherever a reduced expression is consumed further (the reduction
    becomes its own stage) — e.g. ``(a * b).seg_sum(64) * k`` compiles to
    a map → reduce → scale pipeline of three kernels. Each stage is an
    ordinary ``CompiledKernel``, individually autotunable: ``schedules``
    maps stage index → ``Schedule`` (dict or sequence; missing entries
    lower with the default schedule). An expression with no reduction
    compiles to a single-stage program identical to ``compile_kernel``.
    The serving layer executes programs with device-resident inter-stage
    chaining (``repro_torch.serve.graphs.submit_program``)."""
    params = list(inspect.signature(fn).parameters)
    if isinstance(shapes, dict):
        missing = [p for p in params if p not in shapes]
        if missing:
            raise CompileError(f"no shape given for parameters {missing}")
        shape_list = [shapes[p] for p in params]
    else:
        if len(shapes) != len(params):
            raise CompileError(f"{len(params)} parameters but "
                               f"{len(shapes)} shapes")
        shape_list = list(shapes)

    builder = _GraphBuilder()
    sizes: Dict[str, int] = {}
    placeholders: List[GraphTensor] = []
    for p, s in zip(params, shape_list):
        shape = _norm_shape(s)
        sizes[p] = _size(shape)
        placeholders.append(
            GraphTensor(shape, lambda i, _p=p: Load(_p, i), builder,
                        buffer=p))

    out = fn(*placeholders)
    gname = name or getattr(fn, "__name__", "graph").replace(
        "<lambda>", "graph")
    if isinstance(out, ScatterTensor):
        builder.stages.append(
            (builder.buffer_name(len(builder.stages)), out))
    elif isinstance(out, Tensor):
        if not (isinstance(out, GraphTensor) and builder.stages
                and out.buffer == builder.stages[-1][0]):
            # the result is not already the last stage's buffer:
            # materialize it as the final stage (covers fused
            # expressions, identity of an input, and plain Tensors
            # produced by dsl helpers)
            builder.stages.append(
                (builder.buffer_name(len(builder.stages)), out))
    else:
        raise CompileError(
            f"graph must return a Tensor or ScatterTensor, got "
            f"{type(out).__name__}")

    stage_sizes: Dict[str, int] = {}
    stages: List[CompiledKernel] = []
    sources: List[Dict[str, Tuple[str, object]]] = []
    for idx, (buf, t) in enumerate(builder.stages):
        sched = _stage_schedule(schedules, idx)
        coarsen = sched.coarsen
        if isinstance(t, ScatterTensor):
            out_len, addr, val = t.out_len, t.addr, t.val
        else:
            out_len, addr, val = t.size, (lambda i: i), t.elem
        if coarsen < 1 or out_len % coarsen:
            raise CompileError(
                f"stage {idx}: coarsen={coarsen} must divide the stage "
                f"output length {out_len}")
        stores = []
        item = Item()
        for c in range(coarsen):
            ie = opt.add(opt.mul(item, coarsen), c)
            stores.append((addr(ie), val(ie)))
        reads = _load_names(stores)
        arrays: Dict[str, int] = {}
        srcs: Dict[str, Tuple[str, object]] = {}
        for p in params:                       # inputs in signature order
            if p in reads:
                arrays[p] = sizes[p]
                srcs[p] = ("input", p)
        for j in range(idx):                   # then stage feeds by index
            bn = builder.stages[j][0]
            if bn in reads:
                arrays[bn] = stage_sizes[bn]
                srcs[bn] = ("stage", j)
        unknown = reads - set(arrays)
        if unknown:
            raise CompileError(
                f"stage {idx} reads unknown arrays {sorted(unknown)}")
        kernel = Kernel(name=f"{gname}_s{idx}", arrays=arrays,
                        out_len=out_len, n_items=out_len // coarsen,
                        stores=stores)
        stages.append(lower_kernel(kernel, sched))
        sources.append(srcs)
        stage_sizes[buf] = out_len
    if isinstance(schedules, dict):
        bad = [k for k in schedules if not 0 <= k < len(stages)]
        if bad:
            raise CompileError(f"schedules for nonexistent stages {bad} "
                               f"(program has {len(stages)})")
    return Program(gname, stages, sources, sizes)
