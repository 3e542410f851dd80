#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of the G-GPU simulator on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on any mismatch:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions;
  2. build: nvcc builds the CUDA kernel pe_execute from
     src/repro_torch/kernels/csrc/ for sm_90a;
  3. kernel: pe_execute against its plain PyTorch version (select_alu) on
     the card, bit-exact, on all 32 opcodes with int32 edge operands and on
     random inputs at the main path's shapes (1x1, 64x64, 1024x64), with and
     without an opcode mask; timed with CUDA events;
  4. main path: the paper's benches at Table III sizes through run_kernel
     on the card; each run's output slice must equal the bench's numpy
     reference, and its cycles, instrs, mem_ops, hits, misses, steps and
     the sha256 of its final memory must equal the JAX reference's result
     in src/repro_torch/ggpu/golden_runs.json;
  5. fold: run_kernel_cohort of 8 fir images and run_kernel_batch of
     [copy, vec_mul, div_int], each launch against the golden file and,
     after the main path's launch count is read, against its single run
     on the card.

Every line but the last is JSON or the nvidia-smi line; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, without
a CUDA device or without the repository's src/ beside it.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.ggpu import isa, programs  # noqa: E402
from repro_torch.ggpu.engine import (GGPUConfig, ScalarConfig,  # noqa: E402
                                     run_kernel, run_kernel_batch,
                                     run_kernel_cohort)
from repro_torch.ggpu.engine.alu import select_alu  # noqa: E402
from repro_torch.kernels import pe_simd  # noqa: E402

GOLDEN = ROOT / "src" / "repro_torch" / "ggpu" / "golden_runs.json"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
CUDA_CORE_OPS_PER_S = 67e12      # H100 SXM non-tensor fp32 rate, data sheet
STAT_KEYS = ("cycles", "instrs", "mem_ops", "hits", "misses", "steps")


class Run(NamedTuple):
    """One simulator launch: ``bench`` at Table III size, its G-GPU
    (``kind="gpu"``) or scalar program, a config's fields, and optionally
    a seed that replaces the bench's input words."""
    key: str
    bench: str
    kind: str
    cfg: dict
    seed: Optional[int] = None


def _main_runs():
    runs = [Run(f"8cu/shared/{n}", n, "gpu", {"n_cus": 8})
            for n in programs.LEGACY_ORDER]
    runs += [Run(f"1cu/shared/{n}", n, "gpu", {"n_cus": 1})
             for n in ("mat_mul", "copy", "vec_mul", "fir", "div_int",
                       "reduction")]
    runs += [Run(f"scalar/{n}", n, "scalar", {})
             for n in ("copy", "vec_mul", "div_int")]
    runs += [Run(f"8cu/{m}/{n}", n, "gpu", {"n_cus": 8, "memsys": m})
             for m in ("banked", "banked-iso") for n in ("fir", "mat_mul")]
    runs.append(Run("8cu/shared/depth1/fir", "fir", "gpu",
                    {"n_cus": 8, "pipeline_depth": 1}))
    return tuple(runs)


MAIN_RUNS = _main_runs()
COHORT_RUNS = tuple(Run(f"8cu/shared/fir/seed{k}", "fir", "gpu",
                        {"n_cus": 8}, seed=k) for k in range(8))
BATCH_RUNS = tuple(Run(f"4cu/shared/{n}", n, "gpu", {"n_cus": 4})
                   for n in ("copy", "vec_mul", "div_int"))
ALL_RUNS = MAIN_RUNS + COHORT_RUNS + BATCH_RUNS
REDUCED = ["1-CU and scalar xcorr/parallel_sel (58k-625k lockstep rounds "
           "each) are left out until rounds are captured in CUDA graphs"]


def launch(run: Run, benches):
    """(prog, mem0, n_items, out_slice, expected_out) of ``run``, from a
    name -> Bench map (the port's, or the JAX package's in the golden
    file's generator)."""
    b = benches[run.bench]
    if run.kind == "scalar":
        return (b.scalar_prog, b.scalar_mem, 1, b.scalar_out,
                b.ref(b.scalar_mem, b.scalar_n))
    mem = b.gpu_mem
    if run.seed is not None:
        mem = mem.copy()
        mem[:b.gpu_n] = np.random.default_rng(run.seed).integers(
            -100, 100, b.gpu_n).astype(np.int32)
    return b.gpu_prog, mem, b.gpu_items, b.gpu_out, b.ref(mem, b.gpu_n)


def make_config(run: Run, gpu_cls, scalar_cls):
    return (scalar_cls if run.kind == "scalar" else gpu_cls)(**run.cfg)


def summary(mem, info) -> dict:
    """What the golden file holds of one launch."""
    out = {k: int(info[k]) for k in STAT_KEYS}
    out["mem_sha256"] = hashlib.sha256(
        np.ascontiguousarray(mem, dtype="<i4").tobytes()).hexdigest()
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


# -- phase 3: the kernel against its plain version ---------------------------

def _edge_inputs(dev):
    """All 32 opcodes x int32 edge operands (INT_MIN, INT_MAX, -1, 0,
    b = 0, INT_MIN // -1, shift amounts < 0 / 0 / 31 / > 31, LUI wrap)."""
    edges = np.array([-2**31, 2**31 - 1, -1, 0, 1, 2, -2, 31, 32, 33, -7,
                      65536, -65536, 2**20, 12345, -99999], np.int64)
    a, b = np.meshgrid(edges, edges, indexing="ij")
    a, b = a.reshape(-1), b.reshape(-1)
    L = a.size                                   # every (a, b) pair
    ops = np.arange(isa.N_OPS)
    imms = edges
    op = np.repeat(ops, imms.size)[:, None]
    imm = np.tile(imms, ops.size)[:, None]
    W = op.shape[0]
    t = lambda x: torch.as_tensor(x.astype(np.int32), device=dev)  # noqa
    return (t(op), t(imm), t(np.broadcast_to(a, (W, L)).copy()),
            t(np.broadcast_to(b, (W, L)).copy()))


def _random_inputs(W, L, seed, dev):
    g = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x.astype(np.int32), device=dev)  # noqa
    return (t(g.integers(0, isa.N_OPS, (W, 1))),
            t(g.integers(-2**31, 2**31, (W, 1))),
            t(g.integers(-2**31, 2**31, (W, L))),
            t(g.integers(-2**31, 2**31, (W, L))))


def _eager_ms(fn, iters: int) -> float:
    """Time per call of ``fn`` issued eagerly from the host, back to back
    (CUDA events; includes what the host costs between launches)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int, reps: int = 5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so no host work sits between the launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def kernel_phase(dev) -> dict:
    cases = [("edges", _edge_inputs(dev), None)]
    mask = frozenset({isa.ADD, isa.MUL, isa.DIV, isa.SRL, isa.LUI})
    for W, L in ((1, 1), (64, 64), (1024, 64)):
        for ops in (None, mask):
            cases.append((f"{W}x{L}" + ("/mask" if ops else ""),
                          _random_inputs(W, L, W + L, dev), ops))
    max_err = 0
    for name, (op, imm, a, b), ops in cases:
        got = pe_simd.pe_execute(op, imm, a, b, ops)
        want = select_alu(op, a, b, imm, ops)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"pe_execute != select_alu on {name}")
    timings = {}
    for W, L in ((64, 64), (1024, 64)):
        op, imm, a, b = _random_inputs(W, L, 7, dev)
        nbytes = 4 * (2 * W + 3 * W * L)      # op, imm read; a, b read; out
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = W * L / CUDA_CORE_OPS_PER_S * 1e3    # one select per lane
        kernel = lambda: pe_simd.pe_execute(op, imm, a, b)  # noqa: E731
        plain = lambda: select_alu(op, a, b, imm)            # noqa: E731
        timings[f"{W}x{L}"] = {
            "ms": _device_ms(kernel, 100), "plain_ms": _device_ms(plain, 10),
            "eager_ms": _eager_ms(kernel, 200),
            "plain_eager_ms": _eager_ms(plain, 20),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}
    emit({"kernel_phase": {"pe_execute": {"exact": True, "cases": len(cases),
                                          "max_abs_err": max_err,
                                          "shapes": timings}}})
    return {"max_abs_err": max_err, **timings["1024x64"]}


# -- phases 4 and 5: the simulator on the card -------------------------------

def _check_run(run: Run, mem, info, expected, out, golden) -> None:
    check(np.array_equal(mem[out], expected),
          f"{run.key}: output differs from the numpy reference")
    check(run.key in golden, f"{run.key}: no entry in {GOLDEN.name}")
    got = summary(mem, info)
    check(got == golden[run.key],
          f"{run.key}: {got} != golden {golden[run.key]}")


def main_path(benches, golden, dev) -> None:
    for run in MAIN_RUNS:
        prog, mem0, n, out, expected = launch(run, benches)
        cfg = make_config(run, GGPUConfig, ScalarConfig)
        before = pe_simd.LAUNCHES
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mem, info = run_kernel(prog, mem0, n, cfg, device=dev)
        wall = time.perf_counter() - t0
        rounds = pe_simd.LAUNCHES - before
        _check_run(run, mem, info, expected, out, golden)
        check(rounds >= info["steps"],
              f"{run.key}: {rounds} pe_execute launches < {info['steps']} "
              "steps")
        emit({"run": run.key, "wall_s": wall, "steps": info["steps"],
              "rounds": rounds, "us_per_round": wall / rounds * 1e6,
              "launches": rounds, "cycles": info["cycles"],
              "sim_instrs_per_s": info["instrs"] / wall,
              "peak_device_mb": torch.cuda.max_memory_allocated() / 2**20})


def fold_path(benches, golden, dev):
    """The folded entry points: each launch against the numpy reference
    and the golden file. Returns what ``verify_folds`` checks against the
    single runs, which are made after the main path's launch count is
    read so that they do not add to it."""
    pending = []
    folds = (("cohort", COHORT_RUNS, GGPUConfig(n_cus=8)),
             ("batch", BATCH_RUNS, GGPUConfig(n_cus=4)))
    for what, runs, cfg in folds:
        lanes = [launch(r, benches) for r in runs]
        before = pe_simd.LAUNCHES
        t0 = time.perf_counter()
        if what == "cohort":
            results = run_kernel_cohort(lanes[0][0], [x[1] for x in lanes],
                                        lanes[0][2], cfg, device=dev)
        else:
            results = run_kernel_batch(
                [x[0] for x in lanes], [x[1] for x in lanes],
                [x[2] for x in lanes], cfg, device=dev)
        wall = time.perf_counter() - t0
        rounds = pe_simd.LAUNCHES - before
        for run, lane, (mem, info) in zip(runs, lanes, results):
            _check_run(run, mem, info, lane[4], lane[3], golden)
        emit({"fold": what, "launches_folded": len(lanes), "wall_s": wall,
              "rounds": rounds, "us_per_round": wall / rounds * 1e6})
        pending.append((what, runs, lanes, results, cfg))
    return pending


def verify_folds(pending, dev) -> None:
    """Each folded launch equals its single run_kernel on the card."""
    for what, runs, lanes, results, cfg in pending:
        for run, lane, (mem, info) in zip(runs, lanes, results):
            single = run_kernel(lane[0], lane[1], lane[2], cfg, device=dev)
            check(summary(*single) == summary(mem, info),
                  f"{run.key}: {what} launch != its single run")


def profile_phase(benches, dev, key: str = "8cu/shared/fir") -> None:
    """Where a round's time goes: one run under torch.profiler, its device
    (kernel) time and kernel count per round against the wall time of the
    same run without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    run = next(r for r in MAIN_RUNS if r.key == key)
    prog, mem0, n, _, _ = launch(run, benches)
    cfg = make_config(run, GGPUConfig, ScalarConfig)
    t0 = time.perf_counter()
    run_kernel(prog, mem0, n, cfg, device=dev)        # unprofiled wall time
    wall_ms = (time.perf_counter() - t0) * 1e3
    before = pe_simd.LAUNCHES
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_kernel(prog, mem0, n, cfg, device=dev)
    profiled_ms = (time.perf_counter() - t0) * 1e3
    rounds = pe_simd.LAUNCHES - before
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    pe_ms = sum(e.self_device_time_total for e in kernels
                if "pe_execute_kernel" in e.name) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name[:60]] = (by_name.get(e.name[:60], 0)
                                + e.self_device_time_total / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    emit({"profile": {
        "run": key, "rounds": rounds, "wall_ms_per_round": wall_ms / rounds,
        "profiled_wall_ms_per_round": profiled_ms / rounds,
        "device_ms_per_round": busy_ms / rounds,
        "device_busy_share": busy_ms / wall_ms,   # of the unprofiled wall
        "device_ops_per_round": len(kernels) / rounds,
        "pe_execute_device_us_per_round": pe_ms / rounds * 1e3,
        "top_device_ms": dict(top)}})


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(no src/repro_torch beside this script)", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA "
              "card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"device": {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
                     "torch": torch.__version__, "cuda": torch.version.cuda,
                     "capability": list(torch.cuda.get_device_capability(0))}})

    t0 = time.perf_counter()
    pe_simd._lib()
    emit({"build": {"pe_simd": {"seconds": time.perf_counter() - t0,
                                "arch": "sm_90a"}}})

    kernel = kernel_phase(dev)

    golden = json.loads(GOLDEN.read_text())
    benches = programs.all_benches()
    emit({"reduced": REDUCED})
    pe_simd.LAUNCHES = 0
    t0 = time.perf_counter()
    main_path(benches, golden, dev)
    pending = fold_path(benches, golden, dev)
    launches = pe_simd.LAUNCHES                 # the main path's runs only
    emit({"main_path": {"wall_s": time.perf_counter() - t0,
                        "runs": len(ALL_RUNS), "pe_execute_launches":
                        launches}})
    verify_folds(pending, dev)
    profile_phase(benches, dev)
    emit({"kernels": [{
        "name": "pe_execute", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pe_simd.cu",
        "replaces": "src/repro/kernels/pe_simd.py:39",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
        "library_ms": None, "shape": [1024, 64], "exact": True}]})
    check(launches > 0, "the main path launched no pe_execute kernel")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
