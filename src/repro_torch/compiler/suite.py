"""DSL re-implementations of the eight hand-written benches (the port's
copy of ``repro.compiler.suite``).

Each of ``repro_torch.ggpu.programs``' kernels re-derives from a one-line
tensor-DSL definition. The compiled kernels share the hand-written memory
layout (inputs in argument order, then the output region), so a compiled
program runs against the *same* memory image as its hand-written twin and
must produce bit-exact results — ``tests/test_compiler.py`` proves this
and pins golden cycle counts.

Compiled-vs-hand cycle parity (measured, see the golden test):

  * ``copy``, ``vec_mul``, ``div_int``, ``mat_mul``, ``fir``,
    ``reduction``, ``xcorr`` compile to the same instruction sequences as
    the hand-written programs (same per-round ops, same addresses) and
    are cycle-identical;
  * ``parallel_sel`` compiles to a *branch-free* arithmetic rank body
    instead of the hand-written divergent compare chain — more
    instructions per iteration but no wavefront divergence; its cycles
    are pinned as goldens and compared to the hand-written count in the
    test (documented-different, bit-exact results).

``dsl_benches`` returns ``programs.Bench`` records whose programs are the
compiled ones (memory images, references, and slices reused from the
hand-written builders), ready for ``dse.Evaluator(workloads=...)`` and
the serving stack.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.compiler.frontend import compile_kernel, dsl
from repro_torch.compiler.ir import CompileError
from repro_torch.compiler.lower import CompiledKernel, Schedule
from repro_torch.ggpu import programs

KernelDef = Tuple[Callable, Dict[str, object]]


def d_copy(n: int) -> KernelDef:
    return (lambda a: a), dict(a=n)


def d_vec_mul(n: int) -> KernelDef:
    return (lambda a, b: a * b), dict(a=n, b=n)


def d_mat_mul(d: int) -> KernelDef:
    return (lambda a, b: a @ b), dict(a=(d, d), b=(d, d))


def d_fir(n: int, taps: int = 16) -> KernelDef:
    return (lambda x, h: dsl.fir(x, h)), dict(x=n, h=taps)


def d_div_int(n: int) -> KernelDef:
    return (lambda a, b: a // b), dict(a=n, b=n)


def d_xcorr(n: int) -> KernelDef:
    return (lambda a, b: dsl.xcorr(a, b)), dict(a=n, b=n)


def d_parallel_sel(n: int) -> KernelDef:
    return (lambda a: dsl.rank_sort(a)), dict(a=n)


def d_reduction(n: int, seg: int = programs.REDUCTION_SEG) -> KernelDef:
    return (lambda a, b: (a * b).seg_sum(seg)), dict(a=n, b=n)


#: bench name -> (fn, shapes) definition builder, taking the same size
#: arguments as the ``k_<name>`` kernel builders below. The autotuner
#: re-traces these under candidate schedules (`repro_torch.compiler.autotune`).
_DEFS: Dict[str, Callable[..., KernelDef]] = {
    "copy": d_copy,
    "vec_mul": d_vec_mul,
    "mat_mul": d_mat_mul,
    "fir": d_fir,
    "div_int": d_div_int,
    "xcorr": d_xcorr,
    "parallel_sel": d_parallel_sel,
    "reduction": d_reduction,
}

#: the compiler benchmark's fast sizes (``hand_benches`` size arguments)
#: and the (cus, freq_targets) grid of its fast co-design and DSE sections;
#: the card's check and the CPU parity tests both run at these
FAST_SIZES: Dict[str, Tuple[int, ...]] = {
    "copy": (64, 512), "vec_mul": (64, 512), "div_int": (64, 512),
    "reduction": (64, 512, 8), "fir": (64, 512), "mat_mul": (8, 16),
    "xcorr": (32, 128), "parallel_sel": (32, 128),
}
FAST_SPECS = {"cus": (1, 2), "freq_targets": (500.0, 667.0)}


def kernel_def(name: str, *args) -> KernelDef:
    """The traceable ``(fn, shapes)`` definition of a suite bench — the
    re-compilable form a schedule search needs. Resolved through the
    ``BENCHES`` registry axis, so a drop-in plugin bench that registers
    a ``kernel_def`` autotunes exactly like a built-in."""
    from repro_torch.registry import BENCHES
    spec = BENCHES.get(name)
    if spec.kernel_def is None:
        raise KeyError(f"bench {name!r} registers no tensor-DSL "
                       "kernel_def (ISA-only bench)")
    fn, shapes = spec.kernel_def(*args)
    return fn, shapes


def _build(name: str, *args,
           schedule: Optional[Schedule] = None) -> CompiledKernel:
    fn, shapes = kernel_def(name, *args)
    return compile_kernel(fn, shapes, name=name, schedule=schedule)


def k_copy(n: int, **kw) -> CompiledKernel:
    return _build("copy", n, **kw)


def k_vec_mul(n: int, **kw) -> CompiledKernel:
    return _build("vec_mul", n, **kw)


def k_mat_mul(d: int, **kw) -> CompiledKernel:
    return _build("mat_mul", d, **kw)


def k_fir(n: int, taps: int = 16, **kw) -> CompiledKernel:
    return _build("fir", n, taps, **kw)


def k_div_int(n: int, **kw) -> CompiledKernel:
    return _build("div_int", n, **kw)


def k_xcorr(n: int, **kw) -> CompiledKernel:
    return _build("xcorr", n, **kw)


def k_parallel_sel(n: int, **kw) -> CompiledKernel:
    return _build("parallel_sel", n, **kw)


def k_reduction(n: int, seg: int = programs.REDUCTION_SEG,
                **kw) -> CompiledKernel:
    return _build("reduction", n, seg, **kw)


#: bench name -> (gpu-size kernel builder, scalar-size kernel builder)
#: taking the same size arguments as the ``programs._<name>`` builders
_BUILDERS = {
    "copy": k_copy,
    "vec_mul": k_vec_mul,
    "mat_mul": k_mat_mul,
    "fir": k_fir,
    "div_int": k_div_int,
    "xcorr": k_xcorr,
    "parallel_sel": k_parallel_sel,
    "reduction": k_reduction,
}


def suite_names() -> list:
    """The compile-suite membership: every registered bench with a
    tensor-DSL ``kernel_def``, in legacy table order (plugin benches
    join the suite — and its gated parity artifacts — by registering a
    def; ISA-only benches stay engine workloads outside the suite)."""
    from repro_torch.registry import BENCHES
    from repro_torch.registry.benches import ordered_names
    return [n for n in ordered_names()
            if BENCHES.get(n).kernel_def is not None]


def hand_benches(sizes: Optional[Dict[str, Tuple[int, ...]]] = None
                 ) -> Dict[str, "programs.Bench"]:
    """The hand-written benches at the given sizes (one build per name —
    shared by every suite entry point so nothing constructs them twice).
    ``sizes`` maps a name to the ``programs._<name>`` builder's size
    arguments (scalar, gpu[, extra]); defaults are Table III."""
    from repro_torch.registry import BENCHES
    sizes = dict(sizes or {})
    out = {}
    for name in suite_names():
        build = BENCHES.get(name).build
        sz = sizes.get(name)
        out[name] = build(*sz) if sz is not None else build()
    return out


def def_args(name: str, b: "programs.Bench",
             scalar: bool = False) -> Tuple[int, ...]:
    """The ``kernel_def``/``k_<name>`` size arguments matching a built
    hand bench (gpu-size by default, scalar-size with ``scalar=True``)."""
    n = b.scalar_n if scalar else b.gpu_n
    if name == "mat_mul":
        return (int(np.sqrt(n)),)
    if name == "fir":
        return (n, 16)
    if name == "reduction":
        return (n, b.gpu_n // b.gpu_items)
    return (n,)


def compile_pair(name: str, b: "programs.Bench"
                 ) -> Tuple[CompiledKernel, CompiledKernel]:
    """(gpu-size, scalar-size) compiled kernels matching a hand bench."""
    return (_build(name, *def_args(name, b)),
            _build(name, *def_args(name, b, scalar=True)))


def dsl_kernels(sizes: Optional[Dict[str, Tuple[int, ...]]] = None
                ) -> Dict[str, Tuple[CompiledKernel, CompiledKernel]]:
    """Compile all eight benches; returns name -> (gpu-size kernel,
    scalar-size kernel). ``sizes`` as in ``hand_benches``."""
    return {name: compile_pair(name, b)
            for name, b in hand_benches(sizes).items()}


def dsl_benches(sizes: Optional[Dict[str, Tuple[int, ...]]] = None,
                prefix: str = "dsl_",
                hands: Optional[Dict[str, "programs.Bench"]] = None
                ) -> Dict[str, "programs.Bench"]:
    """``programs.Bench`` records with compiled programs in place of the
    hand-written ones. The memory images, output slices, item counts, and
    NumPy references are the hand-written builders' own — the compiled
    layout is verified to coincide. Pass ``hands`` (from
    ``hand_benches``) to reuse already-built benches."""
    out = {}
    for name, b in (hands or hand_benches(sizes)).items():
        kg, ks = compile_pair(name, b)
        if kg.mem_size != b.gpu_mem.shape[0] or kg.n_items != b.gpu_items \
                or kg.out != b.gpu_out:
            raise CompileError(
                f"compiled {name} layout diverges from the hand-written "
                f"bench: mem {kg.mem_size} vs {b.gpu_mem.shape[0]}, "
                f"items {kg.n_items} vs {b.gpu_items}, "
                f"out {kg.out} vs {b.gpu_out}")
        out[prefix + name] = dataclasses.replace(
            b, name=prefix + name, gpu_prog=kg.prog,
            scalar_prog=ks.scalar_prog)
    return out
