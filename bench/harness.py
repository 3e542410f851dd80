"""One run of one cell: set-up, the measured window, the metrics and the
check that what the window served is correct.

Everything is found by name from ``BENCHMARK.json``: the cell
(``workloads``), its configuration file (``configs[].file``), its mix
(``bench/mixes/<traffic>.json``), each metric's reader
(``bench/metrics/<metric>.py``, a ``read(run)`` that returns a number or
None) and the cell's limits (``bench/limits/<cell>.json``). A new cell,
mix, configuration or metric is new files and new entries.

The window drives ``Engine.generate`` as a user calls it: a closed loop
of one client that submits a wave of ``slots`` prompts, waits for its
tokens and submits the next, until ``seconds`` have passed; the last wave
is let finish, and the window ends with it. A mix whose waves come in
rounds (``round_waves``: the ``code`` mix's longer and shorter wave in
turn) ends the window with a whole round, so that where the window cuts
the cycle moves its rate less. Set-up (the process's start,
imports, the weights made on the device, the engine, one wave at the
mix's longest padded length, and in a traced run the profiler's start)
ends where the window starts.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import re
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from bench import check, system, traffic, weights as W
from bench.spans import DeviceTrace, Spans

FOREIGN = ("jax", "jaxlib", "flax", "repro")     # whole top-level names


def foreign_modules() -> List[str]:
    """Modules of JAX or the JAX package loaded in this process."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {name!r}")


def cell_files(root: Path, spec: dict, cell: str):
    """(workload entry, configuration dict, mix dict) of ``cell``."""
    work = _named(spec["workloads"], cell)
    conf = _named(spec["configs"], work["config"])
    arch = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "bench" / "mixes"
                      / f"{work['traffic']}.json").read_text())
    return work, arch, mix


def metrics_of(spec: dict, cell: str, kind: str) -> List[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics ``cell``
    reports: those that list it, or list no cells."""
    return [m for m in spec[kind]
            if cell in m.get("workloads", [cell])]


def reader(root: Path, metric: str):
    path = root / "bench" / "metrics" / f"{metric}.py"
    mod_name = "bench_metric_" + re.sub(r"\W", "_", metric)
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


@dataclass
class Wave:
    prompts: List[List[int]]
    outputs: List[List[int]]
    submitted: float            # host seconds, perf_counter
    returned: float

    @property
    def padded(self) -> int:
        return max(map(len, self.prompts))


@dataclass
class Run:
    """What a reader may read: the cell's files, the waves of the window,
    its length, set-up, the device peak and, in a traced run, the spans
    and the device trace."""
    cell: str
    arch: dict
    mix: dict
    waves: List[Wave]
    window_s: float
    setup_s: float
    memory_peak_bytes: int
    spans: Optional[Spans] = None
    device_trace: Optional[DeviceTrace] = None


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"


def serve(engine, waves_in, new_tokens: int, seconds: float,
          spans: Optional[Spans] = None, round_waves: int = 1):
    """The closed loop: waves from ``waves_in`` through ``generate``
    until ``seconds`` have passed and a whole round of ``round_waves``
    has run, or ``waves_in`` ends. Returns (waves, window seconds)."""
    waves: List[Wave] = []
    t0 = time.perf_counter()
    for prompts in waves_in:
        with spans.span("generate") if spans else contextlib.nullcontext():
            ts = time.perf_counter()
            out = engine.generate(prompts, new_tokens)
            te = time.perf_counter()
        waves.append(Wave(prompts, out, ts, te))
        if te - t0 >= seconds and len(waves) % round_waves == 0:
            break
    return waves, te - t0


def run_cell(root: Path, cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             fault=None) -> dict:
    """One run; returns the result line's dict. ``fault(engine)``, for
    tests, breaks the timed path before the window."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(root)
    _, arch, mix = cell_files(root, spec, cell)
    limits = json.loads((root / "bench" / "limits"
                         / f"{cell}.json").read_text())
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    system.load(root)
    marks = {"imports": time.perf_counter()}

    weights = W.make(arch, seed, dev)
    engine, _ = system.build(arch, weights, mix["slots"], seed)
    waves_in = traffic.Traffic(mix, seed, arch["vocab_size"])
    if on_card:
        torch.cuda.synchronize(dev)
    marks["weights_and_engine"] = time.perf_counter()
    warm = np.random.default_rng([int(seed), 2])
    longest = traffic.longest_wave(mix)
    engine.generate([warm.integers(0, arch["vocab_size"], longest).tolist()
                     for _ in range(mix["slots"])], 2)
    marks["warm_up_wave"] = time.perf_counter()
    if fault is not None:
        fault(engine)
    spans = Spans(dev) if trace else None
    dtrace = DeviceTrace() if trace and on_card else None
    if on_card:
        torch.cuda.synchronize(dev)

    with (system.instrument(engine, spans) if trace
          else contextlib.nullcontext()):
        if dtrace is not None:
            dtrace.start()
        setup_s = time.perf_counter() - t_start
        t0_ns = time.perf_counter_ns()
        waves, window_s = serve(engine, waves_in, mix["new_tokens"],
                                seconds, spans,
                                round_waves=mix.get("round_waves", 1))
        t1_ns = time.perf_counter_ns()
        if dtrace is not None:
            dtrace.stop()
    if spans is not None and on_card:
        spans.settle()
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    foreign = foreign_modules()
    if foreign:
        raise ForeignModules(foreign)

    last, parts = t_start, {}
    for name, t in marks.items():
        parts[name] = t - last
        last = t
    parts["profiler_start"] = setup_s - (last - t_start)   # traced runs
    run = Run(cell, arch, mix, waves, window_s, setup_s, peak, spans,
              dtrace)
    metrics = {}
    for kind in ("per_layer",) if trace else ("end_to_end",):
        for m in metrics_of(spec, cell, kind):
            value = reader(root, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_card else dev.type,
                "kind": (torch.cuda.get_device_name(dev) if on_card
                         else "cpu"),
                "count": 1, "memory_peak_bytes": peak}
    result = {"metrics": metrics, "setup_parts_s": parts}
    if dtrace is not None:
        dev_info["busy_s"] = dtrace.busy_s()
        dev_info["window_s"] = window_s
        result["breakdown"] = {
            "device_ops": dtrace.top_ops(),
            "idle_gaps": dtrace.idle_gaps(spans, (t0_ns, t1_ns))}

    # the program's state goes before the reference runs; the weights
    # are the benchmark's inputs and stay
    del engine, run, spans, dtrace
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = check.judge(arch, mix, waves, weights, seed, limits)
    return {"correct": verdict.correct, "attempted": verdict.attempted,
            "failed": verdict.failed, **result, "device": dev_info,
            "readings": verdict.readings, "compared": verdict.compared}


class ForeignModules(RuntimeError):
    def __init__(self, names):
        super().__init__("modules of JAX or the JAX package are loaded: "
                         + ", ".join(names))
        self.names = names
