"""Lowering: expression graph -> G-GPU ISA programs (the port's copy of
``repro.compiler.lower``: the same codegen, so the encoded programs are
byte-identical to the reference's; ``run``/``verify`` simulate on the
port's engine, on the card unless ``device`` names another).

The codegen walks the (CSE'd, folded) expression DAG and emits through
``repro_torch.ggpu.isa.Assembler``, producing *two* programs per kernel
from the same IR:

  * the **SIMT** program — one work item per output element; the engine
    tiles items over CUs/wavefronts exactly as for the hand-written
    benches (an optional ``coarsen`` factor folds several outputs into
    one item, trading wavefront count for per-item work — the workload
    side of the tiling knob);
  * the **sequential scalar** program — the same per-item body wrapped in
    an outer loop over items, the RISC-V-baseline shape of Table III.

Codegen strategy (deliberately close to the hand-written idiom, so simple
kernels compile to the *same instruction sequences* and therefore the same
cycle counts):

  * **register allocation** — lowest-free-register, scope-based: each
    ``Reduce``/``Guard`` body is a scope whose registers free at scope
    exit; a value is freed eagerly when its last structural use is read
    in the scope that allocated it. Shared (CSE) nodes stay resident
    until their owner scope closes. R0 is the hardwired zero; constants
    fold into immediates wherever an I-form exists.
  * **loop-invariant hoisting** — compound subexpressions of a reduction
    body that do not read the loop counter are materialized once before
    the loop (sound because inputs are read-only — see ``ir`` module
    doc). The loop bound is a cached ``Const`` node, so in-body uses of
    the same constant (e.g. a circular wrap limit) hit its register.
  * **guarded terms** — ``Reduce(.., Guard(c, e))`` emits the FGPU
    boundary idiom: branch-if-false over the term and its accumulate.
    ``x - Guard(c, y)`` (and +/or/xor) emits a conditional-update peephole
    (branch over a single in-place op), matching the hand-written
    circular-wrap sequence.

Address expressions peel their constant tail into the load/store
immediate field, so ``a[i]`` is one ``LW`` with the array base in ``imm``.

Every choice above is a **schedule knob** (``Schedule``): the default
schedule reproduces the hand-written idiom exactly (and therefore the
golden cycle counts), while the autotuner (``repro_torch.compiler.autotune``)
sweeps the alternatives — output coarsening, hoisting off, the branch-free
select lowering of guards, address-peeling off — and keeps whichever
lowering is fastest in true cycles on the target design point.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.compiler import opt
from repro_torch.compiler.ir import (Bin, CompileError, Const, Expr, Guard,
                                     Item, Kernel, Load, LoopVar, Reduce,
                                     children, eval_expr, w32)
from repro_torch.ggpu.engine import run_kernel
from repro_torch.ggpu.isa import Assembler
from repro_torch.ggpu.programs import Bench

#: Bin op -> (register mnemonic, immediate mnemonic or None)
_MNEMONICS = {
    "add": ("add", "addi"), "sub": ("sub", None), "mul": ("mul", None),
    "div": ("div", None), "rem": ("rem", None),
    "and": ("and_", "andi"), "or": ("or_", "ori"), "xor": ("xor", "xori"),
    "shl": ("sll", "slli"), "srl": ("srl", "srli"), "sra": ("sra", "srai"),
    "slt": ("slt", "slti"),
}
#: branch emitted when the condition is FALSE (skip the guarded body)
_INV_BRANCH = {"lt": "bge", "ge": "blt", "eq": "bne", "ne": "beq"}
#: ops whose identity element is 0 (conditional-update peephole)
_COND_UPDATE_OPS = ("add", "sub", "or", "xor")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One point in the lowering-choice space the autotuner searches.

    ``coarsen`` tiles that many consecutive output elements onto one work
    item (must divide the kernel's output length). ``hoist`` enables
    loop-invariant hoisting. ``branchy`` selects the Guard lowering:
    ``True`` emits the hand-written branch idioms (branch-over-term,
    conditional update), ``False`` rewrites every ``Guard(c, e)`` into the
    branch-free ``cond_val(c) * e`` select before codegen — more ALU work,
    no divergence. ``peel`` enables peeling constant address tails into
    the LW/SW immediate field; off, addresses materialize through the
    register file (the register-pressure end of that trade-off).

    ``Schedule()`` is the default lowering — bit- and cycle-identical to
    the pre-schedule compiler on every kernel.
    """
    coarsen: int = 1
    hoist: bool = True
    branchy: bool = True
    peel: bool = True

    def __post_init__(self):
        if self.coarsen < 1:
            raise CompileError(f"coarsen={self.coarsen} must be >= 1")

    def label(self) -> str:
        """Compact stable label, e.g. ``c2+nohoist+select``; ``c1`` is
        the default schedule."""
        parts = [f"c{self.coarsen}"]
        if not self.hoist:
            parts.append("nohoist")
        if not self.branchy:
            parts.append("select")
        if not self.peel:
            parts.append("nopeel")
        return "+".join(parts)

    def sort_key(self) -> tuple:
        """Deterministic tie-break order: the default schedule first,
        then least-surprising (closest to default) lowerings."""
        return (self.coarsen != 1, self.coarsen, not self.branchy,
                not self.hoist, not self.peel)


DEFAULT_SCHEDULE = Schedule()


class _Codegen:
    """One emission pass over a kernel body (SIMT or scalar variant)."""

    def __init__(self, asm: Assembler, roots: Sequence[Expr],
                 layout: Dict[str, int], item_reg: int,
                 schedule: Schedule = DEFAULT_SCHEDULE):
        self.asm = asm
        self.layout = layout
        self.schedule = schedule
        self.uses = opt.use_counts(roots)
        self.free = sorted(set(range(2, 32)) - {item_reg})
        self.cache: Dict[Expr, int] = {Item(): item_reg}
        self.owner: Dict[Expr, int] = {Item(): 0}
        self.scopes: List[List[Expr]] = [[Item()]]
        self._labels = itertools.count()
        self._vars_memo: Dict[Expr, frozenset] = {}

    # -- registers ----------------------------------------------------------

    def _alloc(self, node: Optional[Expr]) -> int:
        if not self.free:
            raise CompileError(
                "out of registers: expression too wide for the 32-entry "
                "register file — split the kernel or reduce sharing")
        reg = self.free.pop(0)
        if node is not None:
            self.cache[node] = reg
            self.owner[node] = len(self.scopes) - 1
            self.scopes[-1].append(node)
        return reg

    def _free_reg(self, reg: int):
        if reg != 0:
            self.free.append(reg)
            self.free.sort()

    def release(self, e: Expr):
        """Account one read of ``e``; frees its register on the last read
        if the current scope owns it (otherwise the owner scope exit
        does)."""
        if e not in self.cache:
            return                       # r0 constant / peeled node
        self.uses[e] = self.uses.get(e, 1) - 1
        if self.uses[e] <= 0 and self.owner[e] == len(self.scopes) - 1:
            self._evict(e)

    def _evict(self, e: Expr):
        reg = self.cache.pop(e)
        self.scopes[self.owner.pop(e)].remove(e)
        self._free_reg(reg)

    def _open_scope(self):
        self.scopes.append([])

    def _close_scope(self):
        for e in self.scopes.pop():
            self._free_reg(self.cache.pop(e))
            self.owner.pop(e)

    def _label(self) -> str:
        return f"L{next(self._labels)}"

    # -- emission -----------------------------------------------------------

    def emit(self, e: Expr) -> int:
        if e in self.cache:
            return self.cache[e]
        if isinstance(e, Const):
            if e.v == 0:
                return 0
            reg = self._alloc(e)
            self.asm.li(reg, e.v)
            return reg
        if isinstance(e, LoopVar):
            raise CompileError("loop variable escaped its Reduce")
        if isinstance(e, Bin):
            return self._emit_bin(e)
        if isinstance(e, Load):
            base, imm, node = self._emit_addr(e.idx)
            off = self.layout[e.array]
            rd = self._reuse_or_alloc(e, node, base)
            self.asm.lw(rd, base, off + imm)
            return rd
        if isinstance(e, Guard):
            return self._emit_guard(e)
        if isinstance(e, Reduce):
            return self._emit_reduce(e)
        raise CompileError(f"cannot lower {type(e).__name__}")

    def _reuse_or_alloc(self, e: Expr, operand: Optional[Expr],
                        operand_reg: int) -> int:
        """Destination register: reuse ``operand``'s register in place when
        this read retires it (dataflow-safe — operands are read before
        writeback), else allocate."""
        if operand is not None and operand in self.cache \
                and self.cache[operand] == operand_reg:
            self.release(operand)
            if operand not in self.cache:        # retired: mutate in place
                self.cache[e] = operand_reg
                self.owner[e] = len(self.scopes) - 1
                self.scopes[-1].append(e)
                # reclaim it from the free list — it is live again
                self.free.remove(operand_reg)
                return operand_reg
            return self._alloc(e)
        if operand is not None:
            self.release(operand)
        return self._alloc(e)

    def _emit_bin(self, e: Bin) -> int:
        reg_mn, imm_mn = _MNEMONICS[e.op]
        # conditional-update peephole: x OP Guard(c, y) with identity 0
        if isinstance(e.b, Guard) and e.op in _COND_UPDATE_OPS:
            return self._emit_cond_update(e)
        b_const = isinstance(e.b, Const)
        if b_const and e.op == "sub" and -2048 <= -e.b.v < 2048:
            ra = self.emit(e.a)
            rd = self._reuse_or_alloc(e, e.a, ra)
            self.asm.addi(rd, ra, -e.b.v)
            return rd
        if b_const and imm_mn is not None and -2048 <= e.b.v < 2048:
            ra = self.emit(e.a)
            rd = self._reuse_or_alloc(e, e.a, ra)
            getattr(self.asm, imm_mn)(rd, ra, e.b.v)
            return rd
        ra = self.emit(e.a)
        rb = self.emit(e.b)
        self.release(e.b)
        rd = self._reuse_or_alloc(e, e.a, ra)
        getattr(self.asm, reg_mn)(rd, ra, rb)
        return rd

    def _transfer(self, old: Expr, new: Expr) -> int:
        """Rebind ``old``'s live register to ``new`` (in-place mutation)."""
        reg = self.cache.pop(old)
        self.scopes[self.owner.pop(old)].remove(old)
        self.uses[old] = 0
        self.cache[new] = reg
        self.owner[new] = len(self.scopes) - 1
        self.scopes[-1].append(new)
        return reg

    def _emit_cond_update(self, e: Bin) -> int:
        """``x OP Guard(c, y)``: branch over a single in-place update when
        the guard is false (the hand-written circular-wrap idiom). The
        update mutates x's register when this op and the condition are its
        last reads; otherwise x is copied first."""
        g: Guard = e.b
        ra = self.emit(e.a)
        rca, rcb = self.emit(g.cond.a), self.emit(g.cond.b)
        pending = 1 + (g.cond.a == e.a) + (g.cond.b == e.a)
        in_place = (e.a in self.cache
                    and self.uses.get(e.a, 0) <= pending
                    and self.owner.get(e.a) == len(self.scopes) - 1)
        if in_place:
            rd = ra
        else:
            rd = self._alloc(e)
            self.asm.mv(rd, ra)
        skip = self._label()
        getattr(self.asm, _INV_BRANCH[g.cond.op])(rca, rcb, skip)
        self.release(g.cond.a)
        self.release(g.cond.b)
        if in_place:
            self._transfer(e.a, e)
        else:
            self.release(e.a)
        self._open_scope()
        ry = self.emit(g.body)
        self.release(g.body)
        getattr(self.asm, _MNEMONICS[e.op][0])(rd, rd, ry)
        self._close_scope()
        self.asm.label(skip)
        return rd

    def _emit_guard(self, e: Guard) -> int:
        rd = self._alloc(e)
        self.asm.li(rd, 0)
        rca, rcb = self.emit(e.cond.a), self.emit(e.cond.b)
        skip = self._label()
        getattr(self.asm, _INV_BRANCH[e.cond.op])(rca, rcb, skip)
        self.release(e.cond.a)
        self.release(e.cond.b)
        self._open_scope()
        rb = self.emit(e.body)
        self.release(e.body)
        self.asm.mv(rd, rb)
        self._close_scope()
        self.asm.label(skip)
        return rd

    def _vars_of(self, e: Expr) -> frozenset:
        """The free index variables (``Item`` / unbound ``LoopVar``) an
        expression reads; a ``Reduce`` binds its own counter."""
        if e in self._vars_memo:
            return self._vars_memo[e]
        if isinstance(e, (Item, LoopVar)):
            out = frozenset({e})
        else:
            out = frozenset().union(
                *(self._vars_of(c) for c in children(e))) \
                if children(e) else frozenset()
            if isinstance(e, Reduce):
                out -= {e.var}
        self._vars_memo[e] = out
        return out

    def _hoist(self, e: Expr, newvar: Expr):
        """Materialize compound subexpressions of a loop body that do not
        read the loop counter before the loop opens. A node is hoistable
        when it avoids ``newvar`` and every other variable it reads is
        already live (an enclosing loop's counter or the item index).
        Disabled schedules recompute invariants inside the loop instead
        (fewer registers live across the loop)."""
        if not self.schedule.hoist:
            return
        if isinstance(e, (Const, Item, LoopVar)):
            return
        vs = self._vars_of(e)
        if newvar not in vs and all(v in self.cache for v in vs):
            if e not in self.cache:
                self.emit(e)
            return
        for c in children(e):
            self._hoist(c, newvar)

    def _emit_reduce(self, e: Reduce) -> int:
        acc = self._alloc(e)
        self.asm.li(acc, 0)
        var_reg = self._alloc(e.var)
        self.asm.li(var_reg, 0)
        rlim = self.emit(Const(e.count))
        self._hoist(e.body, e.var)
        top, done = self._label(), self._label()
        self.asm.label(top)
        self.asm.bge(var_reg, rlim, done)
        self._open_scope()
        body = e.body
        if isinstance(body, Guard):
            # FGPU boundary idiom: skip the term AND its accumulate
            rca, rcb = self.emit(body.cond.a), self.emit(body.cond.b)
            skip = self._label()
            getattr(self.asm, _INV_BRANCH[body.cond.op])(rca, rcb, skip)
            self.release(body.cond.a)
            self.release(body.cond.b)
            rb = self.emit(body.body)
            self.release(body.body)
            self.asm.add(acc, acc, rb)
            self._close_scope()
            self.asm.label(skip)
        else:
            rb = self.emit(body)
            self.release(body)
            self.asm.add(acc, acc, rb)
            self._close_scope()
        self.asm.addi(var_reg, var_reg, 1)
        self.asm.beq(0, 0, top)
        self.asm.label(done)
        # retire the loop counter; the bound Const stays cached (shared)
        if e.var in self.cache:
            self._evict(e.var)
        return acc

    def _emit_addr(self, e: Expr) -> Tuple[int, int, Optional[Expr]]:
        """(base register, immediate, node to release) for an address
        expression, peeling the constant tail into the immediate."""
        if e in self.cache:
            return self.cache[e], 0, e
        if not self.schedule.peel:
            # schedule knob: address constants materialize through the
            # register file (folded by the ADDI immediate forms instead)
            return self.emit(e), 0, e
        imm = 0
        peeled = False
        while isinstance(e, Bin) and e.op == "add" \
                and isinstance(e.b, Const) and e not in self.cache:
            imm += e.b.v
            e = e.a
            peeled = True
        if isinstance(e, Const):
            return 0, imm + e.v, None
        # a peeled base's reads are accounted to the skipped +const
        # wrappers, not the base itself — never release it here (it frees
        # at scope exit), or shared bases would retire early
        return self.emit(e), imm, (None if peeled else e)

    def store(self, addr: Expr, value: Expr, out_off: int):
        rv = self.emit(value)
        base, imm, node = self._emit_addr(opt.add(addr, Const(out_off)))
        self.asm.sw(rv, base, imm)
        self.release(value)
        if node is not None:
            self.release(node)


# ---------------------------------------------------------------------------
# program builders
# ---------------------------------------------------------------------------

def _scheduled_stores(kernel: Kernel,
                      schedule: Schedule) -> List[Tuple[Expr, Expr]]:
    """The store list the codegen lowers: the kernel's own under the
    branchy (default) schedule, the branch-free select rewrite otherwise.
    The kernel's IR — and therefore the oracle — is never mutated."""
    if schedule.branchy:
        return kernel.stores
    memo: Dict[Expr, Expr] = {}
    return [(opt.to_select(a, memo), opt.to_select(v, memo))
            for a, v in kernel.stores]


def build_simt(kernel: Kernel,
               schedule: Schedule = DEFAULT_SCHEDULE) -> np.ndarray:
    """The G-GPU program: TID -> item, body, stores, HALT."""
    asm = Assembler()
    layout = kernel.layout()
    stores = _scheduled_stores(kernel, schedule)
    roots = [r for a, v in stores
             for r in (v, opt.add(a, Const(layout["__out__"])))]
    asm.tid(1)
    gen = _Codegen(asm, roots, layout, item_reg=1, schedule=schedule)
    for addr, value in stores:
        gen.store(addr, value, layout["__out__"])
    asm.halt()
    return asm.assemble()


def build_scalar(kernel: Kernel,
                 schedule: Schedule = DEFAULT_SCHEDULE) -> np.ndarray:
    """The sequential baseline: the same body in an outer item loop."""
    asm = Assembler()
    layout = kernel.layout()
    stores = _scheduled_stores(kernel, schedule)
    roots = [r for a, v in stores
             for r in (v, opt.add(a, Const(layout["__out__"])))]
    asm.li(1, 0)
    gen = _Codegen(asm, roots, layout, item_reg=1, schedule=schedule)
    rlim = gen._alloc(None)
    asm.li(rlim, kernel.n_items)
    # hoist item-invariant work out of the outer loop
    for root in roots:
        gen._hoist(root, Item())
    top, end = gen._label(), gen._label()
    asm.label(top)
    asm.bge(1, rlim, end)
    gen._open_scope()
    for addr, value in stores:
        gen.store(addr, value, layout["__out__"])
    gen._close_scope()
    asm.addi(1, 1, 1)
    asm.beq(0, 0, top)
    asm.label(end)
    asm.halt()
    return asm.assemble()


# ---------------------------------------------------------------------------
# compiled kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompiledKernel:
    """A lowered kernel: both program variants, the memory layout, and the
    NumPy oracle for differential verification."""
    name: str
    kernel: Kernel
    prog: np.ndarray                 # SIMT program (one item per output)
    scalar_prog: np.ndarray          # sequential outer-loop program
    n_items: int
    schedule: Schedule = DEFAULT_SCHEDULE

    @property
    def layout(self) -> Dict[str, int]:
        return self.kernel.layout()

    @property
    def out(self) -> slice:
        off = self.layout["__out__"]
        return slice(off, off + self.kernel.out_len)

    @property
    def mem_size(self) -> int:
        return self.kernel.mem_size

    # -- memory images ------------------------------------------------------

    def _inputs_dict(self, inputs) -> Dict[str, np.ndarray]:
        names = list(self.kernel.arrays)
        if isinstance(inputs, dict):
            missing = set(names) - set(inputs)
            if missing:
                raise CompileError(f"missing inputs: {sorted(missing)}")
            d = {n: np.asarray(inputs[n], np.int32).reshape(-1)
                 for n in names}
        else:
            if len(inputs) != len(names):
                raise CompileError(
                    f"expected {len(names)} inputs, got {len(inputs)}")
            d = {n: np.asarray(x, np.int32).reshape(-1)
                 for n, x in zip(names, inputs)}
        for n, ln in self.kernel.arrays.items():
            if d[n].shape[0] != ln:
                raise CompileError(
                    f"input {n!r}: expected {ln} words, got {d[n].shape[0]}")
        return d

    def build_mem(self, inputs) -> np.ndarray:
        d = self._inputs_dict(inputs)
        return np.concatenate(
            [d[n] for n in self.kernel.arrays]
            + [np.zeros(self.kernel.out_len, np.int32)])

    def extract_inputs(self, mem: np.ndarray) -> Dict[str, np.ndarray]:
        layout = self.layout
        return {n: np.asarray(mem[layout[n]:layout[n] + ln], np.int32)
                for n, ln in self.kernel.arrays.items()}

    # -- the oracle ---------------------------------------------------------

    def reference(self, inputs) -> np.ndarray:
        """Expected output computed by the NumPy oracle (engine ALU
        semantics)."""
        d = self._inputs_dict(inputs)
        arrays = {n: np.asarray(v, np.int64) for n, v in d.items()}
        item = np.arange(self.n_items, dtype=np.int64)
        out = np.zeros(self.kernel.out_len, np.int64)
        addrs, vals = [], []
        for addr, value in self.kernel.stores:
            addrs.append(eval_expr(addr, item, arrays, {}))
            vals.append(eval_expr(value, item, arrays, {}))
        # collisions are checked across ALL stores of all items: lanes
        # have no inter-item store order, so an address written by two
        # different items races. The same item writing an address twice
        # (coarsened store pairs) is deterministic — program order — on
        # both the engine and this oracle, and is allowed.
        A = np.stack(addrs)                       # (n_stores, n_items)
        owner = np.broadcast_to(item, A.shape)
        pairs = np.unique(np.stack([A.ravel(), owner.ravel()], axis=1),
                          axis=0)
        if len(np.unique(pairs[:, 0])) != len(pairs):
            raise CompileError(
                f"kernel {self.name!r}: store addresses collide across "
                "work items (lanes have no inter-item store order)")
        for a, v in zip(addrs, vals):
            out[a] = w32(v)
        return out.astype(np.int32)

    # -- execution ----------------------------------------------------------

    def run(self, inputs, cfg, *, scalar: bool = False, device=None):
        """Execute on the port's engine (on the card unless ``device``
        names another; ``"cpu"``: the plain path); returns (out_array,
        info) with the output slice brought back as numpy."""
        mem0 = self.build_mem(inputs)
        prog = self.scalar_prog if scalar else self.prog
        n = 1 if scalar else self.n_items
        mem, info = run_kernel(prog, mem0, n, cfg, device=device)
        return np.asarray(mem)[self.out], info

    def verify(self, inputs, cfg, *, scalar: bool = False,
               device=None) -> dict:
        """Differential check: engine output must be bit-exact vs the
        NumPy oracle. Returns the engine info dict."""
        got, info = self.run(inputs, cfg, scalar=scalar, device=device)
        np.testing.assert_array_equal(got, self.reference(inputs))
        return info

    def random_inputs(self, lo: int = -100, hi: int = 100,
                      seed: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        return {n: rng.integers(lo, hi, ln).astype(np.int32)
                for n, ln in self.kernel.arrays.items()}

    # -- interop ------------------------------------------------------------

    def as_bench(self, inputs=None, seed: int = 0):
        """A ``repro_torch.ggpu.programs.Bench`` record, so compiled kernels
        drop into ``dse.Evaluator`` (via ``workloads=``), ``serve``, and
        the bench tables."""
        if inputs is None:
            inputs = self.random_inputs(seed=seed)
        mem0 = self.build_mem(inputs)

        def ref(m, _n, _self=self):
            return _self.reference(_self.extract_inputs(m))

        return Bench(self.name, self.prog, mem0, self.n_items, self.out,
                     self.scalar_prog, mem0.copy(), self.out, ref,
                     self.n_items, self.n_items)


def lower_kernel(kernel: Kernel,
                 schedule: Schedule = DEFAULT_SCHEDULE) -> CompiledKernel:
    return CompiledKernel(kernel.name, kernel, build_simt(kernel, schedule),
                          build_scalar(kernel, schedule), kernel.n_items,
                          schedule)
