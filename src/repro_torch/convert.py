"""Carry state from the JAX package's objects into the port's.

The G-GPU simulator has no weights: its state is the machine
configuration, the ISA programs and the memory images. These helpers take
them as plain data (a config's ``dataclasses.asdict``, a bench's numpy
arrays), so the two packages run the same machines on the same data
without the port importing the JAX package.

The compiler has no parameters; what carries across is the compiled
artefact. ``compiled_from_reference`` and ``program_from_reference``
rebuild a reference ``CompiledKernel``/``Program`` (its programs as numpy
arrays, its expression IR node by node) as the port's, for the parity
tests; the port's own path compiles with ``repro_torch.compiler``.

The language models' state is their parameter tree:
``params_from_reference`` fills the port's modules from a tree in the
reference's layout (nested dicts of arrays, each layer group stacked),
such as ``repro.models.schema.init_params`` gives or
``models.schema.init_numpy`` makes from a seed; a tree of gradients maps
the same way. ``opt_state_from_reference`` carries AdamW's moments and
step across.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.compiler import ir
from repro_torch.compiler.frontend import Program
from repro_torch.compiler.lower import CompiledKernel, Schedule
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine.config import GGPUConfig, ScalarConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM
from repro_torch.models.schema import init_numpy, layer_groups
from repro_torch.optim.adamw import AdamWState


def load_tree(module, tree, rep=None) -> None:
    """Copy the leaves of ``tree`` (nested dicts of arrays named as the
    module's attributes; ``leaf[rep]`` when ``rep`` is given) into
    ``module``'s parameters. Raises unless every parameter is filled."""
    filled: set = set()
    _fill(module, tree, rep, "", filled)
    _check_filled(module, filled)


def _check_filled(module, filled: set) -> None:
    missing = [n for n, p in module.named_parameters()
               if id(p) not in filled]
    if missing:
        raise KeyError(f"leaves missing from the tree: {missing}")


def _fill(module, tree, rep, path, filled):
    for key, val in tree.items():
        target = getattr(module, key, None)
        where = f"{path}/{key}"
        if target is None:
            raise KeyError(f"{where}: the port's model has no such leaf")
        if isinstance(val, dict):
            _fill(target, val, rep, where, filled)
            continue
        arr = np.asarray(val)
        if rep is not None:
            arr = arr[rep]
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{where}: shape {arr.shape} != the port's "
                             f"{tuple(target.shape)}")
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:         # e.g. a view of a jax.Array
            arr = arr.copy()
        with torch.no_grad():
            target.copy_(torch.from_numpy(arr))
        filled.add(id(target))


def params_from_reference(tree, cfg: ModelConfig, device=None) -> LM:
    """The port's model of ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU), with the parameters of ``tree``: the
    reference's pytree, whose group ``gi`` holds each leaf stacked over
    its ``repeats`` (leaf[r] is the r-th repeat of the unit). Raises on a
    missing, unknown or misshapen leaf."""
    model = LM(cfg, device)
    filled: set = set()
    top = {k: v for k, v in tree.items() if k != "groups"}
    _fill(model, top, None, "", filled)
    layer = 0
    for gi, (unit, reps) in enumerate(layer_groups(cfg)):
        group = tree["groups"][str(gi)]
        for rep in range(reps):
            for idx in range(len(unit)):
                _fill(model.layers[layer + rep * len(unit) + idx],
                      group[str(idx)], rep, f"groups/{gi}/{idx}[{rep}]",
                      filled)
        layer += reps * len(unit)
    _check_filled(model, filled)
    return model


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """The port's model with the weights ``init_numpy(cfg, seed)`` makes."""
    return params_from_reference(init_numpy(cfg, seed), cfg, device)


def opt_state_from_reference(m, v, step, cfg: ModelConfig,
                             device=None) -> AdamWState:
    """The port's ``AdamWState`` from the reference's ``AdamWState``
    fields: the moment trees ``m`` and ``v`` (the parameters' layout)
    keyed by the port's parameter names, and ``step``."""
    def moments(tree):
        return {n: p.detach() for n, p in
                params_from_reference(tree, cfg, device).named_parameters()}
    mm = moments(m)
    dev = next(iter(mm.values())).device
    return AdamWState(mm, moments(v), torch.tensor(int(np.asarray(step)),
                                                   dtype=torch.int32,
                                                   device=dev))


def config_from_reference(fields: dict, scalar: bool = False) -> GGPUConfig:
    """The port's ``GGPUConfig`` (``ScalarConfig`` when ``scalar``) with
    the fields of a reference config, e.g. ``dataclasses.asdict(cfg)``.
    Raises ``TypeError`` on a field the port does not know."""
    return (ScalarConfig if scalar else GGPUConfig)(**fields)


def bench_from_arrays(name: str, gpu_prog, gpu_mem, gpu_items: int,
                      gpu_out: slice, scalar_prog, scalar_mem,
                      scalar_out: slice, gpu_n: int, scalar_n: int,
                      **_ignored) -> programs.Bench:
    """A port ``Bench`` from a reference bench's programs, memory images
    and output slices (pass ``vars(bench)``; its ``ref`` is not taken: the
    port's own reference for ``name`` is used)."""
    ref = programs.build(name, *programs.SMOKE_SIZES[name]).ref
    return programs.Bench(
        name, np.asarray(gpu_prog, np.int32).copy(),
        np.asarray(gpu_mem, np.int32).copy(), int(gpu_items), gpu_out,
        np.asarray(scalar_prog, np.int32).copy(),
        np.asarray(scalar_mem, np.int32).copy(), scalar_out, ref,
        int(gpu_n), int(scalar_n))


def expr_from_reference(e, memo=None):
    """The port's IR node for a reference IR node (``Item``, ``Const``,
    ``LoopVar``, ``Bin``, ``Load``, ``Cond``, ``Guard``, ``Reduce``), by
    class name and fields; a subtree shared in the reference stays
    shared."""
    memo = {} if memo is None else memo
    if id(e) in memo:
        return memo[id(e)]
    cls = getattr(ir, type(e).__name__, None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise TypeError(f"not an IR node: {type(e).__name__}")
    out = cls(**{f.name: _ir_field(getattr(e, f.name), memo)
                 for f in dataclasses.fields(cls)})
    memo[id(e)] = out
    return out


def _ir_field(v, memo):
    if isinstance(v, (str, int, np.integer)):
        return v
    return expr_from_reference(v, memo)


def compiled_from_reference(ck) -> CompiledKernel:
    """The port's ``CompiledKernel`` for a reference one: its programs
    copied as int32 arrays, its kernel's stores rebuilt as port IR, its
    schedule by field."""
    memo: dict = {}
    k = ck.kernel
    kernel = ir.Kernel(
        name=k.name, arrays=dict(k.arrays), out_len=int(k.out_len),
        n_items=int(k.n_items),
        stores=[(expr_from_reference(a, memo), expr_from_reference(v, memo))
                for a, v in k.stores])
    return CompiledKernel(
        ck.name, kernel, np.asarray(ck.prog, np.int32).copy(),
        np.asarray(ck.scalar_prog, np.int32).copy(), int(ck.n_items),
        Schedule(**dataclasses.asdict(ck.schedule)))


def program_from_reference(prog) -> Program:
    """The port's ``Program`` for a reference one: each stage by
    ``compiled_from_reference``, the wiring and input sizes copied."""
    return Program(prog.name,
                   [compiled_from_reference(ck) for ck in prog.stages],
                   [dict(src) for src in prog.sources],
                   dict(prog.in_sizes))
