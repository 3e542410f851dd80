"""Optimizer: folding smart constructors, strength reduction, CSE/graph
analyses, and the fusion story (the port's own copy of
``repro.compiler.opt``, int64/``wrap32`` arithmetic unchanged).

Expressions are built through the smart constructors here, which fold at
construction time:

  * **constant folding** — ``Bin`` of two ``Const``s evaluates through the
    NumPy oracle (so folding is bit-faithful to the engine ALU, including
    wraparound and div-by-zero);
  * **algebraic identities** — ``x+0``, ``x*1``, ``x*0``, ``x<<0``,
    ``x//1``, ``x%1``, and constant canonicalization to the right operand
    of commutative ops (which also flattens ``(x+c1)+c2`` so address
    offsets land in load/store immediates);
  * **strength reduction** — multiply / floor-divide / floor-mod by a
    power-of-two constant become shift / arithmetic-shift / mask. These
    are exact for *all* int32 values (floor semantics match arithmetic
    shift and two's-complement masking), so no sign analysis is needed.

**CSE** falls out of the frozen-dataclass IR: structurally identical
subtrees are equal and hash equal, so ``use_counts`` + the codegen cache
in ``lower`` materialize each distinct subexpression once (e.g. the
``a[i-t]`` index shared by a FIR guard and its load).

**Fusion** happens a level up, by construction: the frontend composes
per-element callables, so an elementwise chain compiles to one load per
input, a straight ALU run, and one store — exactly the straight-line
rounds the engine's fused dispatch (``GGPUConfig.fuse``) retires through
its memory-system-skipping fast path (DESIGN.md §Compiler).
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, Set

import numpy as np

from repro_torch.compiler.ir import (Bin, CompileError, Cond, Const, Expr,
                                     Guard, Load, Reduce, _eval_bin, children,
                                     fresh_loopvar, wrap32)


def _as_expr(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, (int, np.integer)):
        return Const(wrap32(int(x)))
    raise CompileError(f"expected int or Expr, got {type(x).__name__}")


def _fold(op: str, a: int, b: int) -> Expr:
    return Const(int(_eval_bin(op, np.int64(a), np.int64(b))))


def _log2(v: int):
    if v > 0 and (v & (v - 1)) == 0:
        return v.bit_length() - 1
    return None


def binop(op: str, a, b) -> Expr:
    """Folding constructor for every ALU binary op."""
    a, b = _as_expr(a), _as_expr(b)
    if isinstance(a, Const) and isinstance(b, Const):
        return _fold(op, a.v, b.v)
    # canonicalize constants to the rhs of commutative ops
    if op in ("add", "mul", "and", "or", "xor") and isinstance(a, Const):
        a, b = b, a
    if isinstance(b, Const):
        v = b.v
        if op in ("add", "sub") and v == 0:
            return a
        if op == "mul":
            if v == 0:
                return Const(0)
            if v == 1:
                return a
            k = _log2(v)
            if k is not None:
                return binop("shl", a, Const(k))
        if op == "div":
            if v == 1:
                return a
            k = _log2(v)
            if k is not None:       # floor div == arithmetic shift (all i32)
                return binop("sra", a, Const(k))
        if op == "rem":
            if v == 1:
                return Const(0)
            k = _log2(v)
            if k is not None:       # floor mod == two's-complement mask
                return binop("and", a, Const(v - 1))
        if op in ("shl", "srl", "sra") and v == 0:
            return a
        if op in ("or", "xor") and v == 0:
            return a
        if op == "and" and v == 0:
            return Const(0)
    # (x + c1) + c2 -> x + (c1+c2): keeps address offsets in immediates
    if op in ("add", "sub") and isinstance(b, Const) \
            and isinstance(a, Bin) and a.op == "add" \
            and isinstance(a.b, Const):
        delta = a.b.v + (b.v if op == "add" else -b.v)
        return binop("add", a.a, Const(wrap32(delta)))
    if op not in ("add", "sub", "mul", "div", "rem", "and", "or", "xor",
                  "shl", "srl", "sra", "slt"):
        raise CompileError(f"unknown binary op {op!r}")
    return Bin(op, a, b)


def add(a, b) -> Expr:
    return binop("add", a, b)


def sub(a, b) -> Expr:
    return binop("sub", a, b)


def mul(a, b) -> Expr:
    return binop("mul", a, b)


def div(a, b) -> Expr:
    return binop("div", a, b)


def rem(a, b) -> Expr:
    return binop("rem", a, b)


def lt_val(a, b) -> Expr:
    """0/1 value of ``a < b`` (signed) — the SLT datapath."""
    return binop("slt", a, b)


def ne_val(a, b) -> Expr:
    """0/1 value of ``a != b`` built from XOR + two sign compares."""
    x = binop("xor", a, b)
    return binop("or", lt_val(Const(0), x), lt_val(x, Const(0)))


def eq_val(a, b) -> Expr:
    return binop("xor", ne_val(a, b), Const(1))


def cond(op: str, a, b) -> Cond:
    a, b = _as_expr(a), _as_expr(b)
    if op in ("gt", "le"):          # normalize to the four ISA branches
        op = {"gt": "lt", "le": "ge"}[op]
        a, b = b, a
    if op not in ("lt", "ge", "eq", "ne"):
        raise CompileError(f"unknown condition {op!r}")
    return Cond(op, a, b)


def guard(c: Cond, body) -> Expr:
    body = _as_expr(body)
    if isinstance(c.a, Const) and isinstance(c.b, Const):
        a, b = c.a.v, c.b.v
        taken = {"lt": a < b, "ge": a >= b,
                 "eq": a == b, "ne": a != b}[c.op]
        return body if taken else Const(0)
    if isinstance(body, Const) and body.v == 0:
        return Const(0)
    return Guard(c, body)


def cond_val(c: Cond) -> Expr:
    """The 0/1 *value* of a condition, on the ALU datapath instead of the
    branch unit — the building block of branch-free (select) lowering."""
    if c.op == "lt":
        return lt_val(c.a, c.b)
    if c.op == "ge":
        return binop("xor", lt_val(c.a, c.b), Const(1))
    if c.op == "eq":
        return eq_val(c.a, c.b)
    if c.op == "ne":
        return ne_val(c.a, c.b)
    raise CompileError(f"unknown condition {c.op!r}")


def to_select(e: Expr, memo: Dict[Expr, Expr] = None) -> Expr:
    """Rewrite every ``Guard`` in ``e`` into the branch-free select form
    ``cond_val(c) * body``.  Bit-exact: the oracle evaluates ``Guard`` as a
    masked select whose body always runs (``ir.eval_expr``), and the engine
    ALU has no traps, so multiplying by the 0/1 condition value is the same
    function.  Shared subtrees stay shared through ``memo`` (CSE-preserving),
    and callers may pass one memo across several roots."""
    if memo is None:
        memo = {}
    if e in memo:
        return memo[e]
    if isinstance(e, Guard):
        c = cond(e.cond.op, to_select(e.cond.a, memo), to_select(e.cond.b, memo))
        out = mul(cond_val(c), to_select(e.body, memo))
    elif isinstance(e, Bin):
        out = binop(e.op, to_select(e.a, memo), to_select(e.b, memo))
    elif isinstance(e, Reduce):
        body = to_select(e.body, memo)
        out = e if body is e.body else Reduce(e.var, e.count, body)
    else:
        if isinstance(e, Load):
            idx = to_select(e.idx, memo)
            out = e if idx is e.idx else Load(e.array, idx)
        else:
            out = e                 # Item / Const / LoopVar: leaves
    memo[e] = out
    return out


def reduce_sum(count: int, body_fn) -> Expr:
    """``sum(body_fn(k) for k in range(count))`` as a ``Reduce`` node;
    ``body_fn`` receives the bound ``LoopVar``."""
    if count < 1:
        return Const(0)
    var = fresh_loopvar()
    body = _as_expr(body_fn(var))
    if isinstance(body, Const):     # loop-invariant body folds entirely
        return _fold("mul", body.v, count)
    return Reduce(var, count, body)


# ---------------------------------------------------------------------------
# graph analyses (consumed by the codegen)
# ---------------------------------------------------------------------------

def use_counts(roots: Iterable[Expr]) -> Dict[Expr, int]:
    """Number of *materialization-time reads* of every distinct node in the
    DAG: a shared (structurally equal) subtree is counted once per parent
    reference but its children only once — mirroring the codegen, which
    computes each distinct node into one register and serves later
    references from the cache."""
    counts: Dict[Expr, int] = {}

    def walk(e: Expr):
        counts[e] = counts.get(e, 0) + 1
        if counts[e] > 1:
            return
        for c in children(e):
            walk(c)

    for r in roots:
        walk(r)
    return counts


def contains_vars(e: Expr, vars_: FrozenSet[Expr],
                  memo: Dict[Expr, bool] = None) -> bool:
    """Whether ``e`` reads any of ``vars_`` (``Item`` / ``LoopVar`` nodes)
    — the loop-variance test behind invariant hoisting."""
    if memo is None:
        memo = {}
    if e in memo:
        return memo[e]
    if e in vars_:
        memo[e] = True
        return True
    out = any(contains_vars(c, vars_, memo) for c in children(e))
    memo[e] = out
    return out


def collect_ops(roots: Iterable[Expr]) -> Set[str]:
    """All distinct ``Bin`` op names in the DAG (for tests/diagnostics)."""
    seen: Set[Expr] = set()
    ops: Set[str] = set()

    def walk(e: Expr):
        if e in seen:
            return
        seen.add(e)
        if isinstance(e, Bin):
            ops.add(e.op)
        for c in children(e):
            walk(c)

    for r in roots:
        walk(r)
    return ops
