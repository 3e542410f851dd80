"""The paper's seven AMD OpenCL SDK micro-benchmarks, as ISA programs (the
port's own copy of ``repro.ggpu.programs``: same programs, memory images
and references, bit for bit).

Each benchmark provides the SIMT (G-GPU) kernel — one work-item per output
element — and the sequential scalar (RISC-V baseline) program, plus a numpy
reference for correctness. Input sizes follow Table III: the scalar core
gets the small size, the G-GPU the large one (sized to saturate 8 CUs), and
Fig-5 speed-ups scale the scalar cycle count by the input-size ratio exactly
as the paper does (a pessimistic-for-G-GPU convention).

mat_mul sizes are element counts of the output matrix (16x16 scalar,
64x64 G-GPU — the paper's 128 -> 2048 element ratio of 16 is preserved).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np

from repro_torch.ggpu.isa import Assembler


@dataclass
class Bench:
    name: str
    gpu_prog: np.ndarray
    gpu_mem: np.ndarray
    gpu_items: int
    gpu_out: slice
    scalar_prog: np.ndarray
    scalar_mem: np.ndarray
    scalar_out: slice
    ref: Callable[[np.ndarray, int], np.ndarray]   # (mem0, n) -> expected out
    gpu_n: int
    scalar_n: int


def _rand(n, lo=-100, hi=100, seed=0):
    return np.random.default_rng(seed).integers(lo, hi, n).astype(np.int32)


# ---------------------------------------------------------------------------
# copy
# ---------------------------------------------------------------------------

def _copy(n_scalar=512, n_gpu=32768):
    def mem(n):
        return np.concatenate([_rand(n, seed=1), np.zeros(n, np.int32)])

    g = Assembler()
    g.tid(1).lw(2, 1, 0).sw(2, 1, n_gpu).halt()

    s = Assembler()
    s.li(1, 0).li(2, n_scalar)
    s.label("loop").bge(1, 2, "end")
    s.lw(3, 1, 0).sw(3, 1, n_scalar).addi(1, 1, 1).beq(0, 0, "loop")
    s.label("end").halt()

    ref = lambda m, n: m[:n]
    return Bench("copy", g.assemble(), mem(n_gpu), n_gpu,
                 slice(n_gpu, 2 * n_gpu), s.assemble(), mem(n_scalar),
                 slice(n_scalar, 2 * n_scalar), ref, n_gpu, n_scalar)


# ---------------------------------------------------------------------------
# vec_mul
# ---------------------------------------------------------------------------

def _vec_mul(n_scalar=1024, n_gpu=65536):
    def mem(n):
        return np.concatenate([_rand(n, seed=2), _rand(n, seed=3),
                               np.zeros(n, np.int32)])

    g = Assembler()
    g.tid(1).lw(2, 1, 0).lw(3, 1, n_gpu).mul(2, 2, 3).sw(2, 1, 2 * n_gpu).halt()

    s = Assembler()
    s.li(1, 0).li(2, n_scalar)
    s.label("loop").bge(1, 2, "end")
    s.lw(3, 1, 0).lw(4, 1, n_scalar).mul(3, 3, 4).sw(3, 1, 2 * n_scalar)
    s.addi(1, 1, 1).beq(0, 0, "loop")
    s.label("end").halt()

    ref = lambda m, n: (m[:n].astype(np.int64) * m[n:2 * n]).astype(np.int32)
    return Bench("vec_mul", g.assemble(), mem(n_gpu), n_gpu,
                 slice(2 * n_gpu, 3 * n_gpu), s.assemble(), mem(n_scalar),
                 slice(2 * n_scalar, 3 * n_scalar), ref, n_gpu, n_scalar)


# ---------------------------------------------------------------------------
# mat_mul (dim x dim, one item per output element)
# ---------------------------------------------------------------------------

def _mat_mul(dim_scalar=16, dim_gpu=64):
    def mem(d):
        return np.concatenate([_rand(d * d, -10, 10, seed=4),
                               _rand(d * d, -10, 10, seed=5),
                               np.zeros(d * d, np.int32)])

    def gpu(d):
        lg = int(np.log2(d))
        n2 = d * d
        g = Assembler()
        g.tid(1)
        g.srli(2, 1, lg)          # row
        g.andi(3, 1, d - 1)       # col
        g.slli(4, 2, lg)          # row*d
        g.li(5, 0).li(6, 0).li(7, d)
        g.label("loop").bge(6, 7, "done")
        g.add(8, 4, 6).lw(8, 8, 0)              # A[row*d + k]
        g.slli(9, 6, lg).add(9, 9, 3).lw(9, 9, n2)  # B[k*d + col]
        g.mul(8, 8, 9).add(5, 5, 8)
        g.addi(6, 6, 1).beq(0, 0, "loop")
        g.label("done").sw(5, 1, 2 * n2).halt()
        return g

    def scalar(d):
        lg = int(np.log2(d))
        n2 = d * d
        s = Assembler()
        s.li(1, 0).li(7, d)                      # r1 = row
        s.label("rloop").bge(1, 7, "end")
        s.li(2, 0)                               # r2 = col
        s.label("cloop").bge(2, 7, "rnext")
        s.slli(4, 1, lg)                         # row*d
        s.li(5, 0).li(6, 0)
        s.label("kloop").bge(6, 7, "kdone")
        s.add(8, 4, 6).lw(8, 8, 0)
        s.slli(9, 6, lg).add(9, 9, 2).lw(9, 9, n2)
        s.mul(8, 8, 9).add(5, 5, 8)
        s.addi(6, 6, 1).beq(0, 0, "kloop")
        s.label("kdone").add(10, 4, 2).sw(5, 10, 2 * n2)
        s.addi(2, 2, 1).beq(0, 0, "cloop")
        s.label("rnext").addi(1, 1, 1).beq(0, 0, "rloop")
        s.label("end").halt()
        return s

    def ref(m, n2):
        d = int(np.sqrt(n2))
        a = m[:n2].reshape(d, d).astype(np.int64)
        b = m[n2:2 * n2].reshape(d, d).astype(np.int64)
        return (a @ b).astype(np.int32).reshape(-1)

    dg, ds = dim_gpu, dim_scalar
    return Bench("mat_mul", gpu(dg).assemble(), mem(dg), dg * dg,
                 slice(2 * dg * dg, 3 * dg * dg), scalar(ds).assemble(),
                 mem(ds), slice(2 * ds * ds, 3 * ds * ds), ref,
                 dg * dg, ds * ds)


# ---------------------------------------------------------------------------
# fir (16 taps; first items diverge on the boundary)
# ---------------------------------------------------------------------------

def _fir(n_scalar=128, n_gpu=4096, taps=16):
    def mem(n):
        return np.concatenate([_rand(n, seed=6), _rand(taps, -8, 8, seed=7),
                               np.zeros(n, np.int32)])

    def build(n, outer: bool):
        a = Assembler()
        if outer:
            a.li(11, 0).li(12, n)
            a.label("outer").bge(11, 12, "end")
            i_reg = 11
        else:
            a.tid(1)
            i_reg = 1
        a.li(5, 0).li(6, 0).li(7, taps)
        a.label("loop").bge(6, 7, "done")
        a.sub(8, i_reg, 6)
        a.blt(8, 0, "skip")
        a.lw(9, 8, 0).lw(10, 6, n).mul(9, 9, 10).add(5, 5, 9)
        a.label("skip").addi(6, 6, 1).beq(0, 0, "loop")
        a.label("done").sw(5, i_reg, n + taps)
        if outer:
            a.addi(11, 11, 1).beq(0, 0, "outer")
            a.label("end").halt()
        else:
            a.halt()
        return a

    def ref(m, n):
        x = m[:n].astype(np.int64)
        h = m[n:n + taps].astype(np.int64)
        out = np.zeros(n, np.int64)
        for t in range(taps):
            out[t:] += h[t] * x[:n - t]
        return out.astype(np.int32)

    return Bench("fir", build(n_gpu, False).assemble(), mem(n_gpu), n_gpu,
                 slice(n_gpu + taps, 2 * n_gpu + taps),
                 build(n_scalar, True).assemble(), mem(n_scalar),
                 slice(n_scalar + taps, 2 * n_scalar + taps), ref,
                 n_gpu, n_scalar)


# ---------------------------------------------------------------------------
# div_int (integer division: the G-GPU's weak spot, per the paper)
# ---------------------------------------------------------------------------

def _div_int(n_scalar=512, n_gpu=4096):
    def mem(n):
        a = _rand(n, -1000, 1000, seed=8)
        b = _rand(n, 1, 50, seed=9)
        return np.concatenate([a, b, np.zeros(n, np.int32)])

    g = Assembler()
    g.tid(1).lw(2, 1, 0).lw(3, 1, n_gpu).div(2, 2, 3).sw(2, 1, 2 * n_gpu).halt()

    s = Assembler()
    s.li(1, 0).li(2, n_scalar)
    s.label("loop").bge(1, 2, "end")
    s.lw(3, 1, 0).lw(4, 1, n_scalar).div(3, 3, 4).sw(3, 1, 2 * n_scalar)
    s.addi(1, 1, 1).beq(0, 0, "loop")
    s.label("end").halt()

    def ref(m, n):
        a, b = m[:n].astype(np.int64), m[n:2 * n].astype(np.int64)
        return (a // b).astype(np.int32)   # python floor-div matches DIV

    return Bench("div_int", g.assemble(), mem(n_gpu), n_gpu,
                 slice(2 * n_gpu, 3 * n_gpu), s.assemble(), mem(n_scalar),
                 slice(2 * n_scalar, 3 * n_scalar), ref, n_gpu, n_scalar)


# ---------------------------------------------------------------------------
# xcorr (circular cross-correlation, O(n^2), cache-pressure heavy)
# ---------------------------------------------------------------------------

def _xcorr(n_scalar=256, n_gpu=4096):
    def mem(n):
        return np.concatenate([_rand(n, -20, 20, seed=10),
                               _rand(n, -20, 20, seed=11),
                               np.zeros(n, np.int32)])

    def build(n, outer: bool):
        a = Assembler()
        if outer:
            a.li(11, 0).li(12, n)
            a.label("outer").bge(11, 12, "end")
            lag = 11
        else:
            a.tid(1)
            lag = 1
        a.li(5, 0).li(6, 0).li(7, n)
        a.label("loop").bge(6, 7, "done")
        a.lw(8, 6, 0)                       # a[i]
        a.add(9, 6, lag)
        a.blt(9, 7, "nowrap")
        a.sub(9, 9, 7)
        a.label("nowrap").lw(2, 9, n)       # b[(i+lag) mod n]
        a.mul(8, 8, 2).add(5, 5, 8)
        a.addi(6, 6, 1).beq(0, 0, "loop")
        a.label("done").sw(5, lag, 2 * n)
        if outer:
            a.addi(11, 11, 1).beq(0, 0, "outer")
            a.label("end").halt()
        else:
            a.halt()
        return a

    def ref(m, n):
        a = m[:n].astype(np.int64)
        b = m[n:2 * n].astype(np.int64)
        return np.array([(a * np.roll(b, -lag)).sum() for lag in range(n)],
                        np.int64).astype(np.int32)

    return Bench("xcorr", build(n_gpu, False).assemble(), mem(n_gpu), n_gpu,
                 slice(2 * n_gpu, 3 * n_gpu), build(n_scalar, True).assemble(),
                 mem(n_scalar), slice(2 * n_scalar, 3 * n_scalar), ref,
                 n_gpu, n_scalar)


# ---------------------------------------------------------------------------
# parallel_sel (rank sort: branch-divergent compares)
# ---------------------------------------------------------------------------

def _parallel_sel(n_scalar=128, n_gpu=2048):
    def mem(n):
        return np.concatenate([_rand(n, -500, 500, seed=12),
                               np.zeros(n, np.int32)])

    def build(n, outer: bool):
        a = Assembler()
        if outer:
            a.li(11, 0).li(12, n)
            a.label("outer").bge(11, 12, "end")
            i_reg = 11
        else:
            a.tid(1)
            i_reg = 1
        a.lw(2, i_reg, 0)                    # v = a[i]
        a.li(5, 0).li(6, 0).li(7, n)
        a.label("loop").bge(6, 7, "done")
        a.lw(8, 6, 0)
        a.blt(8, 2, "inc")
        a.bne(8, 2, "next")
        a.bge(6, i_reg, "next")
        a.label("inc").addi(5, 5, 1)
        a.label("next").addi(6, 6, 1).beq(0, 0, "loop")
        a.label("done").sw(2, 5, n)          # out[rank] = v
        if outer:
            a.addi(11, 11, 1).beq(0, 0, "outer")
            a.label("end").halt()
        else:
            a.halt()
        return a

    def ref(m, n):
        return np.sort(m[:n], kind="stable").astype(np.int32)

    return Bench("parallel_sel", build(n_gpu, False).assemble(), mem(n_gpu),
                 n_gpu, slice(n_gpu, 2 * n_gpu),
                 build(n_scalar, True).assemble(), mem(n_scalar),
                 slice(n_scalar, 2 * n_scalar), ref, n_gpu, n_scalar)


# ---------------------------------------------------------------------------
# reduction (segmented parallel dot/sum: few outputs over many inputs —
# beyond the paper's seven; the shape none of them cover)
# ---------------------------------------------------------------------------

REDUCTION_SEG = 64          # inputs folded per work-item (power of two)


def _reduction(n_scalar=1024, n_gpu=32768, seg=REDUCTION_SEG):
    """Parallel reduction: work-item ``i`` computes the dot product of the
    ``seg``-long segments ``a[i*seg:(i+1)*seg] . b[...]`` and stores the
    partial at ``out[i]`` — the first (parallel) phase of a tree dot/sum.
    Unlike the paper's seven benches, the item count is ``n/seg``, so the
    launch is load-heavy per item with few wavefronts — the shape a fleet
    router places on a small high-clock device while wide launches go to a
    many-CU one."""
    if n_scalar % seg or n_gpu % seg:
        raise ValueError(f"reduction sizes must be multiples of seg={seg}")
    lg = int(np.log2(seg))
    if 1 << lg != seg:
        raise ValueError("seg must be a power of two")

    def mem(n):
        return np.concatenate([_rand(n, -100, 100, seed=13),
                               _rand(n, -100, 100, seed=14),
                               np.zeros(n // seg, np.int32)])

    def build(n, outer: bool):
        k = n // seg
        a = Assembler()
        if outer:
            a.li(11, 0).li(12, k)
            a.label("outer").bge(11, 12, "end")
            i_reg = 11
        else:
            a.tid(1)
            i_reg = 1
        a.slli(2, i_reg, lg)                 # base = i * seg
        a.li(3, 0).li(4, 0).li(5, seg)
        a.label("loop").bge(4, 5, "done")
        a.add(6, 2, 4)
        a.lw(7, 6, 0).lw(8, 6, n).mul(7, 7, 8).add(3, 3, 7)
        a.addi(4, 4, 1).beq(0, 0, "loop")
        a.label("done").sw(3, i_reg, 2 * n)
        if outer:
            a.addi(11, 11, 1).beq(0, 0, "outer")
            a.label("end").halt()
        else:
            a.halt()
        return a

    def ref(m, n):
        a = m[:n].astype(np.int64).reshape(-1, seg)
        b = m[n:2 * n].astype(np.int64).reshape(-1, seg)
        return (a * b).sum(axis=1).astype(np.int32)

    return Bench("reduction", build(n_gpu, False).assemble(), mem(n_gpu),
                 n_gpu // seg, slice(2 * n_gpu, 2 * n_gpu + n_gpu // seg),
                 build(n_scalar, True).assemble(), mem(n_scalar),
                 slice(2 * n_scalar, 2 * n_scalar + n_scalar // seg), ref,
                 n_gpu, n_scalar)


#: the reference's table order of the benches
LEGACY_ORDER = ("mat_mul", "copy", "vec_mul", "fir", "div_int", "xcorr",
                "parallel_sel", "reduction")

#: (scalar, gpu) build arguments of a minimal launch per bench (the
#: reference registry's smoke sizes)
SMOKE_SIZES = {
    "mat_mul": (4, 8),
    "copy": (32, 128),
    "vec_mul": (32, 128),
    "fir": (16, 64),
    "div_int": (32, 64),
    "xcorr": (16, 32),
    "parallel_sel": (16, 32),
    "reduction": (64, 128),
}


def build(name: str, *sizes) -> Bench:
    """Bench ``name`` at ``sizes`` (none: the paper's Table III sizes)."""
    if name not in LEGACY_ORDER:
        raise KeyError(f"unknown bench {name!r}; choices: {LEGACY_ORDER}")
    return globals()[f"_{name}"](*sizes)


def all_benches() -> Dict[str, Bench]:
    """Every bench in table order, at Table III sizes. The paper tables
    only report the seven in ``PAPER_CYCLES``."""
    return {n: build(n) for n in LEGACY_ORDER}


# paper values for comparison (Table III, k-cycles)
PAPER_CYCLES = {
    "mat_mul": dict(riscv=202, cu1=48, cu2=28, cu4=18, cu8=14),
    "copy": dict(riscv=71, cu1=73, cu2=36, cu4=24, cu8=22),
    "vec_mul": dict(riscv=78, cu1=100, cu2=49, cu4=31, cu8=26),
    "fir": dict(riscv=542, cu1=694, cu2=358, cu4=185, cu8=169),
    "div_int": dict(riscv=32, cu1=209, cu2=105, cu4=57, cu8=62),
    "xcorr": dict(riscv=542, cu1=5343, cu2=2802, cu4=1467, cu8=2079),
    "parallel_sel": dict(riscv=765, cu1=5979, cu2=3157, cu4=1656, cu8=1660),
}
PAPER_INPUT = {
    "mat_mul": (128, 2048), "copy": (512, 32768), "vec_mul": (1024, 65536),
    "fir": (128, 4096), "div_int": (512, 4096), "xcorr": (256, 4096),
    "parallel_sel": (128, 2048),
}
