"""Expression IR for the kernel compiler: nodes + the NumPy reference
(the port's own copy of ``repro.compiler.ir``; pure numpy).

The compiler's internal representation is a *per-work-item scalar
expression graph*: every kernel output element is one expression over the
work-item index (``Item``), integer constants, loads from named input
arrays, reduction loops, and guarded (conditional) terms. The tensor-level
frontend (``repro_torch.compiler.frontend``) never materializes intermediate
arrays — elementwise chains compose into one expression per output element
(fusion by construction), and ``repro_torch.compiler.lower`` turns the graph
into a G-GPU ISA program.

Nodes are frozen dataclasses, so structurally identical subtrees compare
and hash equal — common-subexpression elimination is a cache keyed on the
node itself (``opt.use_counts`` / the codegen cache in ``lower``).

``eval_expr`` is the differential-testing oracle: a vectorized NumPy
evaluator with exactly the engine ALU's semantics (int32 wraparound,
floor division with div-by-zero -> 0, shift amounts clipped to [0, 31]).
Every compiled kernel is verified against it (``CompiledKernel.verify``).

Aliasing contract: input arrays are read-only and the output region is
write-only and disjoint from the inputs, so loop-invariant loads may be
hoisted and work items never observe each other's stores.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


class CompileError(Exception):
    """A DSL expression the compiler cannot lower (shape mismatch, out of
    registers, unsupported construct)."""


# ---------------------------------------------------------------------------
# nodes
# ---------------------------------------------------------------------------

class Expr:
    """Base class for scalar expression nodes (int32-valued)."""
    __slots__ = ()


@dataclass(frozen=True)
class Item(Expr):
    """The global work-item index (TID on the SIMT build; the outer loop
    counter on the sequential scalar build)."""


@dataclass(frozen=True)
class Const(Expr):
    v: int


@dataclass(frozen=True)
class LoopVar(Expr):
    """A reduction loop counter, bound by the enclosing ``Reduce``."""
    uid: int


@dataclass(frozen=True)
class Bin(Expr):
    """Binary ALU op. ``op`` is one of ``BIN_OPS`` (engine ALU names)."""
    op: str
    a: Expr
    b: Expr


@dataclass(frozen=True)
class Load(Expr):
    """``mem[base(array) + idx]`` — the array base offset is resolved by
    the memory layout at lowering time."""
    array: str
    idx: Expr


@dataclass(frozen=True)
class Cond:
    """A branch condition (not first-class — only ``Guard`` consumes it).
    ``op`` in {'lt', 'ge', 'eq', 'ne'}, matching the four ISA branches."""
    op: str
    a: Expr
    b: Expr


@dataclass(frozen=True)
class Guard(Expr):
    """``body if cond else 0`` — compiled as a forward branch (the FGPU
    idiom for boundary conditions), evaluated as a masked select."""
    cond: Cond
    body: Expr


@dataclass(frozen=True)
class Reduce(Expr):
    """``sum(body for var in range(count))`` with int32 wraparound."""
    var: LoopVar
    count: int
    body: Expr


#: ops with a direct ALU opcode; 'slt' is the value-producing compare
BIN_OPS = ("add", "sub", "mul", "div", "rem", "and", "or", "xor",
           "shl", "srl", "sra", "slt")

_loopvar_ids = itertools.count()


def fresh_loopvar() -> LoopVar:
    return LoopVar(next(_loopvar_ids))


def children(e: Expr) -> Tuple[Expr, ...]:
    """The sub-expressions the codegen reads when materializing ``e`` (a
    ``Reduce``'s bound var is not a child — it is defined, not read)."""
    if isinstance(e, Bin):
        return (e.a, e.b)
    if isinstance(e, Load):
        return (e.idx,)
    if isinstance(e, Guard):
        return (e.cond.a, e.cond.b, e.body)
    if isinstance(e, Reduce):
        return (e.body,)
    return ()


# ---------------------------------------------------------------------------
# the NumPy oracle (engine ALU semantics, vectorized over work items)
# ---------------------------------------------------------------------------

_I32 = 1 << 32


def w32(x: np.ndarray) -> np.ndarray:
    """Wrap an int64 value vector to int32 two's-complement range."""
    return ((np.asarray(x, np.int64) + (1 << 31)) % _I32) - (1 << 31)


def wrap32(v: int) -> int:
    """Wrap a Python int to int32 — every ``Const`` must hold an already-
    wrapped value, or folding/strength-reduction would see a number the
    engine's register file cannot (e.g. ``1 << 31`` materializes as
    ``-2**31`` through LUI/ORI)."""
    return int(((int(v) + (1 << 31)) % _I32) - (1 << 31))


def _shift_amount(b):
    return np.clip(b, 0, 31)


def _eval_bin(op: str, a, b):
    if op == "add":
        return w32(a + b)
    if op == "sub":
        return w32(a - b)
    if op == "mul":
        return w32(a * b)
    if op == "div":
        # engine: floor division, div-by-zero -> 0
        safe = np.where(b == 0, 1, b)
        return w32(np.where(b == 0, 0, np.floor_divide(a, safe)))
    if op == "rem":
        safe = np.where(b == 0, 1, b)
        return w32(np.where(b == 0, 0, np.remainder(a, safe)))
    if op == "and":
        return w32(a & b)
    if op == "or":
        return w32(a | b)
    if op == "xor":
        return w32(a ^ b)
    if op == "shl":
        return w32(a << _shift_amount(b))
    if op == "srl":
        return w32((a & 0xFFFFFFFF) >> _shift_amount(b))
    if op == "sra":
        return w32(a >> _shift_amount(b))
    if op == "slt":
        return (np.asarray(a) < b).astype(np.int64)
    raise CompileError(f"unknown binary op {op!r}")


def _eval_cond(c: Cond, item, arrays, loops):
    a = eval_expr(c.a, item, arrays, loops)
    b = eval_expr(c.b, item, arrays, loops)
    if c.op == "lt":
        return a < b
    if c.op == "ge":
        return a >= b
    if c.op == "eq":
        return a == b
    if c.op == "ne":
        return a != b
    raise CompileError(f"unknown condition {c.op!r}")


def eval_expr(e: Expr, item: np.ndarray, arrays: Dict[str, np.ndarray],
              loops: Dict[LoopVar, int]) -> np.ndarray:
    """Evaluate ``e`` for a vector of work-item indices.

    ``item`` is the int64 vector of item indices; ``arrays`` maps input
    names to int64 value vectors (int32-wrapped); ``loops`` binds
    enclosing reduction counters. Out-of-range load indices are clipped to
    the array (a guarded load's discarded lane mirrors the engine's
    address clip)."""
    if isinstance(e, Item):
        return item
    if isinstance(e, Const):
        return np.full_like(item, np.int64(e.v))
    if isinstance(e, LoopVar):
        if e not in loops:
            raise CompileError("loop variable used outside its Reduce")
        return np.full_like(item, np.int64(loops[e]))
    if isinstance(e, Bin):
        return _eval_bin(e.op, eval_expr(e.a, item, arrays, loops),
                         eval_expr(e.b, item, arrays, loops))
    if isinstance(e, Load):
        arr = arrays[e.array]
        idx = eval_expr(e.idx, item, arrays, loops)
        return arr[np.clip(idx, 0, len(arr) - 1)]
    if isinstance(e, Guard):
        mask = _eval_cond(e.cond, item, arrays, loops)
        body = eval_expr(e.body, item, arrays, loops)
        return np.where(mask, body, np.int64(0))
    if isinstance(e, Reduce):
        acc = np.zeros_like(item)
        loops = dict(loops)
        for k in range(e.count):
            loops[e.var] = k
            acc = w32(acc + eval_expr(e.body, item, arrays, loops))
        return acc
    raise CompileError(f"cannot evaluate {type(e).__name__}")


# ---------------------------------------------------------------------------
# kernel container
# ---------------------------------------------------------------------------

@dataclass
class Kernel:
    """A lowered-ready kernel: named input arrays (in memory-layout
    order), the output length, and per-item stores.

    ``stores`` addresses are relative to the output base; every work item
    must write a distinct address (the engine gives no intra-round store
    ordering between lanes)."""
    name: str
    arrays: "Dict[str, int]"                    # name -> length, in order
    out_len: int
    n_items: int
    stores: "List[Tuple[Expr, Expr]]"           # (addr, value) per item

    def layout(self) -> Dict[str, int]:
        """name -> base word offset; inputs first, then the output."""
        off, out = {}, 0
        for name, ln in self.arrays.items():
            off[name] = out
            out += ln
        off["__out__"] = out
        return off

    @property
    def mem_size(self) -> int:
        return sum(self.arrays.values()) + self.out_len
