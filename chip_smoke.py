#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA card: the G-GPU simulator's
main path, the RecurrentGemma-2B serving path, SmolLM-360M training, the
MoE family's serving path (Mixtral-8x7B, Llama-4-Scout) with
Qwen1.5-0.5B, and xLSTM-350M, HuBERT-XLarge's encode and Qwen2-VL-72B's
vision prefill.

    python3 chip_smoke.py

Phases, each fatal on any mismatch:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions;
  2. build: nvcc builds the CUDA kernels pe_execute, flash_attention and
     rglru_scan from src/repro_torch/kernels/csrc/ for sm_90a, one nvcc
     per source, all started together;
  3. kernels: pe_execute against its plain PyTorch version (select_alu)
     bit-exact, on all 32 opcodes with int32 edge operands and on random
     inputs at the main path's shapes, L no multiple of 32 and a base off
     16 bytes; flash_attention (bf16 on its
     tensor-core route, f32 on its SIMT route) against attention_ref at
     RecurrentGemma-2B's prefill shape, Mixtral-8x7B's (4 x 6,144 tokens,
     hd 128, GQA 4, window 4,096), HuBERT-XLarge's encode (4 x 1,500
     frames, hd 80, bidirectional), Qwen2-VL-72B's vision prefill (2 x
     4,096 patches, hd 128, GQA 8, causal), the SmolLM-360M shape, the shapes
     of tests/test_kernels.py and the tensor-core route's edges (max |err|
     2e-5 f32, 2e-2 bf16; per query row over its largest |o| 1e-5 f32,
     1e-2 bf16), and a planted fault, the window one key short, must fail
     them;
     rglru_scan against rglru_scan_ref on both routes (ring and direct)
     at the path's two prefill shapes, the test shapes and the routes'
     edges (1e-5) and split-and-carry (1e-4); each timed with CUDA events
     at its main-path shapes beside its plain version, its bound and, for
     attention, one PyTorch call (scaled_dot_product_attention, a
     yardstick the port never calls); the launch routes counted;
  4. simulator: the paper's benches at Table III sizes through run_kernel
     on the card; each run's output slice must equal the bench's numpy
     reference, and its cycles, instrs, mem_ops, hits, misses, steps and
     the sha256 of its final memory must equal the JAX reference's result
     in src/repro_torch/ggpu/golden_runs.json; then run_kernel_cohort of 8
     fir images and run_kernel_batch of [copy, vec_mul, div_int], each
     launch against the golden file and, after the path's launch counts
     are read (pe_execute's calls counted by (W, L) as the simulator
     makes them; every call a launch), against its single run on the
     card; pe_execute then timed at every (W, L) the path launched it at,
     beside an empty launch of the same grid (the launch floor), weighted
     by the path's launches;
  5. serving: the async entry points on the 8-CU benches (out_region
     slices, (0, 0) with nothing downloaded, a uniform cohort region, a
     batch of slice / nothing / full image) against the golden file, and
     a BlockPatch and an XorBlockPatch chain against the same chain
     staged through the host (the producers' memory unchanged); one
     Scheduler drain (max_inflight 8) of every 8-CU shared bench but
     xcorr and parallel_sel (DRAIN_BENCHES) twice, the golden image
     against the golden file and a seeded variant,
     checksum-audited, against the numpy reference and the golden
     file's stats (the JAX package's run of the same variant); the serve
     benchmark's throughput traffic (vec_mul(32, 512) on 2 CUs, 8 bursts of 16
     seeded images, chunks of 2), three passes at each of max_inflight 1
     and 8 in turns, each served output against the bench's numpy
     reference and sync runs, with launches/s (best and median of the
     passes), batch occupancy and the executor's hit rate;
     a two-request Dep chain; a poisoned request (max_steps 50)
     quarantined while the rest are served;
  6. DSE: the CI smoke grid (1 CU at 500 and 667 MHz, xcorr (16, 128),
     check=True) against benchmarks/baselines/BENCH_dse.json's exact
     fields, and the nightly grid's axes (48 specs, 33 simulated configs)
     at xcorr (16, 128) against src/repro_torch/dse/golden_dse.json,
     which the JAX package computes on the CPU;
  7. fleet, faults, registry: the serve benchmark's fleet leg (fast
     sizes: the DSE frontier's two ends over 1 and 8 CUs at 667 MHz, 3 x
     (copy(16, 1024), reduction(64, 256)) images) through Fleet.drain and
     pinned_makespan, every exact field against
     benchmarks/baselines/BENCH_serve.json's "fleet" and every output
     against the numpy reference; the resilience benchmark's three legs
     at its fast sizes (SEU chaos with checksum audits against its
     fault-free control, a device wedged from its first dispatch evicted
     by the executor timeout, straggler holds hedged and unhedged) with
     the exact fields, fault and re-route counts and health against
     benchmarks/baselines/BENCH_resilience.json and the benchmark's
     invariants (hedged p99 below unhedged among them); the registry's
     selfcheck and smoke (every bench, memsys, policy, router, traffic
     pattern and fault scenario), with no problem;
  8. compiler and kernel graphs: the compiler benchmark's fast sections
     through repro_torch.compiler on 2 CUs — the eight compiled benches
     and their hand twins through run_kernel (cycles, bit-exactness,
     program length), the autotune of copy and vec_mul over SMOKE_SPACE
     (every candidate verified), the co-design over 1 and 2 CUs at 500
     and 667 MHz (schedules, population, the joint frontier's pairs) and
     a DSE over compiled workloads (dsl_vec_mul, dsl_reduction,
     user_segred) — every exact field against
     benchmarks/baselines/BENCH_compiler.json; the serve benchmark's
     graph section (map -> segmented reduce -> scale, 8 instances),
     pipelined, host-staged and host-folded, every output against
     Program.reference, stages and the pipelined dispatches against
     BENCH_serve.json's "graph" and the speedup at least 1.5; one graph
     instance through a Fleet of the compiled DSE frontier's two ends,
     its stages on one device;
  8b. mesh and legacy (mesh_legacy_path): the launch axis split 8 ways
     over LaunchMesh([card] * 8) — (a) run_kernel_cohort_async of the 8
     seeded fir images at Table III size on 8 CUs, then of 12 (the golden
     image, its variant, seeds 0-9; 16 rows with the padding), each
     against the golden file; (b) run_kernel_batch of copy, vec_mul,
     div_int and fir, golden and variant, and fir seeds 0-1 (six HALT
     fillers), against the golden file; (c) a patch chain across shards
     (shard 0's output into shard 7's launch, a BlockPatch, an
     XorBlockPatch) against the same chain unsharded on the card; (d) the
     serving traffic through Scheduler(max_batch=4, mesh=) against the
     unsharded Scheduler, launches/s of both; (e) Fleet([fast, wide],
     mesh=) sliced 4 + 4 on a mixed trace, against direct runs, its
     report's invariants; (f) Scheduler(mesh=make_launch_mesh()), one
     entry a card (the unsharded path on one card); then (g)
     run_kernel(legacy=True), fuse 1, on 8-CU copy, div_int, vec_mul,
     fir and reduction and 1-CU fir, each against the golden file, its
     launches equal to its steps;
     for phases 4-8b pe_execute's calls are counted by (W, L) per path
     (seven: simulator, serve, dse, fleet, compiler, mesh, legacy), each
     path's wall time, rounds and µs per round reported, for 4-8 also the
     device's busy share (torch.profiler over a representative piece),
     and at every (W, L) the paths launched, pe_execute held bit for
     bit against select_alu on random inputs (with each opcode set the
     paths gave it there) and then timed;
  9. LM golden: recurrentgemma-2b at full width, 3 layers, f32 compute,
     numpy-seeded weights, through Engine.generate and the kernels: six
     prompts (3072 to 37 tokens) in two waves of 4 slots, 16 greedy
     tokens; prefill logits and tokens against
     src/repro_torch/models/golden_lm.json, which the JAX package computes
     on the CPU;
  10. LM main path: the full 26-layer recurrentgemma-2b (bf16 compute, f32
     weights) on the same traffic through the kernels, timed with CUDA
     events and no copy of the logits (flash_attention runs 8 times per
     prefill wave, all on its tensor-core route, rglru_scan 18 times, all
     on its ring route, and neither in decode); then
     with use_kernels=False on the card, and the kernel path again fed
     the plain path's tokens: the logits of every prefill and decode step
     agree within 0.3, and planted faults (the window halved, the scan fed
     bf16 inputs) must exceed it;
  11. LM training (lm_train_path): smollm-360m at full width cut to 4
     layers, f32 compute, 4 AdamW steps in 2 microbatches through
     make_train_step against src/repro_torch/train/golden_train.json,
     which the JAX package computes on the CPU, and two planted faults
     (decay on every tensor, bias correction off) that must fall outside
     its limits; then python -m repro_torch.launch.train in-process at
     full width (32 layers, bf16 compute, 12 steps of (8, 2048), the
     plan's remat "dots", a temporary checkpoint directory in the
     checkout): the loss must fall by 10 %, no kernel launches (the
     kernels have no backward; training runs the plain attention and
     scan, as the JAX package does), with ms per step, tokens/s, model
     FLOP share of 989 TFLOP/s, peak memory against the plan's estimate,
     the checkpoints' seconds and bytes, a determinism probe and a
     2-step profile; then the Trainer at 4 layers (bf16) for 6 steps
     uninterrupted against a run that fails at step 4 and resumes from
     its step-3 checkpoint, equal bit for bit. The launcher builds its
     (data, model) mesh and sharding rules over the world: on one card a
     world of one, a (1, 1) mesh;
  11b. sharded training (lm_train_sharded): python -m
     repro_torch.launch.train at full width for 4 steps, started alone
     (it opens an NCCL world of one and closes it), its sharded Trainer
     on the (1, 1) mesh held bit for bit against the one-device Trainer
     (rules=None) over the same 4 steps: losses, parameters, both AdamW
     moments and the step (within the determinism probe's reading, if
     phase 11's probe found the card's gradients irreproducible); its
     checkpoint restored on one device and, in a new world, onto a new
     (1, 1) mesh by the Trainer's elastic resume, both bit for bit; step
     ms sharded and unsharded, peak memory against the plan, and one more
     step through the sharded step's path (the model bound to its shards,
     each layer unit's dp gather, the global norm over shards; the world
     of one issues no collective), its per-unit gathers and global norm
     counted and timed to a synchronize;
  12. MoE serving (lm_moe_path): mixtral-8x7b at full width, 1 layer, f32
     compute, through Engine.generate and the kernels: six prompts (4,160
     to 12 tokens) in two waves of 4 slots, 16 greedy tokens; every
     step's top-8 logits and the tokens against
     src/repro_torch/models/golden_moe.json, which the JAX package
     computes on the CPU (with each call's smallest router gap); then
     Mixtral at full width cut to 4 layers, bf16 compute, six prompts
     (6,144 to 45 tokens) in two waves, timed with CUDA events
     (flash_attention 4 times per prefill wave on its tensor-core route,
     never in decode), then its plain path on the card and the kernel
     path fed the plain path's tokens: the logits of every (call, row)
     whose current token kept its experts within MOE_TOL, and every
     changed expert at a plain-path router gap under MOE_GAP_TOL; planted
     faults (gates not renormalised, expert positions counted across a
     wave's rows, the window halved) must fail that, and capacity
     without its rounding to 4 is reported; a short profile; then
     llama4-scout-17b-a16e at full width cut to 1 layer and the whole
     qwen1.5-0.5b (QKV bias), one wave each, against their plain paths
     with a planted fault each;
  13. the last three families (lm_families_path), each at its published
     widths, numpy-seeded weights: xlstm-350m, all 24 layers, f32,
     Engine.generate of one wave of four prompts (512 to 9 tokens), 16
     greedy tokens, every step's top-8 logits and the tokens against
     src/repro_torch/models/golden_xlstm.json, three planted faults (the
     mLSTM's carried stabiliser taken as 0, its chunk-end memory
     undecayed, a sigmoid sLSTM forget gate) beyond the limit, a prefill
     decoded onward against one pass over the whole sequence and the
     mLSTM's chunked scan against its recurrent form (a chunk-end memory
     1e-3 high beyond its limit); then all 24 layers
     in bf16 on a wave up to 2,048 tokens, timed, with a profile (no
     kernel: the mLSTM and sLSTM are torch operations, as the reference's
     are plain XLA); hubert-xlarge at 2 of its 48 layers, f32, encode of
     (2, 400) frames through flash_attention against golden_hubert.json,
     three faults (a causal mask, LayerNorm without its mean, wo without
     its bias) beyond; all 48 layers in bf16 on (4, 1,500, 512) frames
     through flash_attention against the plain path, timed, profiled;
     qwen2-vl-72b at 1 of its 80 layers, f32, a vision prefill of 2 x
     256 patches at their (t, h, w) positions with 8 decode steps and
     Engine.generate of two token prompts against golden_qwen2_vl.json,
     three M-RoPE faults (h and w swapped, plain RoPE over t, sections
     rotated) beyond on the vision prefill; 4 of its 80 layers in bf16, a
     vision prefill of 2 x 4,096 patches and 8 decode steps through
     flash_attention, timed, and Engine.generate of four prompts (2,048
     to 45 tokens), each against the plain path;
  14. the dry run and validate (dryrun_path): started with the script, in
     a process of its own that sees no card, the dry-run CLI
     (python -m repro_torch.launch.dryrun) traces smollm-360m x train_4k
     and mixtral-8x7b x prefill_32k with the flash kernel (its meta
     route) on the meta device on a 16 x 16 stand-in world of 256 ranks,
     each record printed; then MeshPlanner.validate of two one-card
     plans on the 1 x 1 mesh: (b) smollm-360m's training step at phase
     11's (8, 2048) and (c) recurrentgemma-2b's prefill at the LM main
     path's 4 x 3072 with the kernels on. Phases 11 and the LM main path
     each run one more real step of those cells on the card under the
     port's StepCost (the kernels' noted work counted); the dry run's dot
     FLOPs must equal the card's, and its predicted per-rank bytes lie
     within DRYRUN_MEMORY_TOL of torch.cuda.max_memory_allocated; the
     roofline's step time is printed beside the measured one. The
     smollm-360m x train_4k record's per-rank dot FLOPs, peak and
     arguments are printed beside the record the step gave before it
     computed its "model" parts (DRYRUN_BEFORE: the whole model gathered
     on every rank), and the FLOPs and the peak must be lower.

Matrix products run in full precision wherever the port is compared with
a reference (no TF32, no reduced-precision bf16 reductions).

Every line but the last is JSON or the nvidia-smi line; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, without
a CUDA device or without the repository's src/ beside it.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import math
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch import compiler  # noqa: E402
from repro_torch.compiler import suite  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import init_model, params_from_reference  # noqa
from repro_torch.ggpu import isa, programs  # noqa: E402
from repro_torch import dse  # noqa: E402
from repro_torch.ggpu.engine import (BlockPatch, GGPUConfig,  # noqa: E402
                                     ScalarConfig, XorBlockPatch,
                                     cohort_rows, run_kernel,
                                     run_kernel_async, run_kernel_batch,
                                     run_kernel_batch_async,
                                     run_kernel_cohort,
                                     run_kernel_cohort_async)
from repro_torch.ggpu.engine.alu import select_alu  # noqa: E402
from repro_torch.kernels import _build, pe_simd  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels.ref import attention_ref, rglru_scan_ref  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa: E402
                                       to_device)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import LaunchMesh, make_host_mesh, \
    make_launch_mesh  # noqa: E402
from repro_torch.models import attention as MA  # noqa: E402
from repro_torch.models import layers as ML  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402
from repro_torch.models.schema import init_numpy  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.models import steps as steps_mod  # noqa: E402
from repro_torch.models.steps import make_train_step  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.roofline.analysis import (PEAK_FLOPS,  # noqa: E402
                                           model_flops_estimate)
from repro_torch.roofline.counter import StepCost  # noqa: E402
from repro_torch.sharding import ctx as shard_ctx  # noqa: E402
from repro_torch.sharding import set_rules  # noqa: E402
from repro_torch.sharding.rules import is_whole, make_rules  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainConfig  # noqa: E402
from repro_torch.models.recurrent import linear_scan  # noqa: E402
from repro_torch.faults import FaultPlan  # noqa: E402
from repro_torch.registry import FAULTS  # noqa: E402
from repro_torch.registry import smoke as registry_smoke  # noqa: E402
from repro_torch.serve import (Dep, Fleet, FleetResilience,  # noqa: E402
                               Request, Scheduler, extract_outputs,
                               pinned_makespan, poisson_arrivals, replay,
                               result_checksum, run_chains_host_staged,
                               run_program, run_programs_host_staged,
                               sim_key, submit_programs)
from repro_torch.serve.llm import Engine, EngineConfig  # noqa: E402

GOLDEN = ROOT / "src" / "repro_torch" / "ggpu" / "golden_runs.json"
GOLDEN_LM = ROOT / "src" / "repro_torch" / "models" / "golden_lm.json"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
CUDA_CORE_OPS_PER_S = 67e12      # H100 SXM non-tensor fp32 rate, data sheet
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core rate
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
MAIN_RUNS_BY_KEY = {r.key: r for r in MAIN_RUNS}
COHORT_RUNS = tuple(Run(f"8cu/shared/fir/seed{k}", "fir", "gpu",
                        {"n_cus": 8}, seed=k) for k in range(8))
BATCH_RUNS = tuple(Run(f"4cu/shared/{n}", n, "gpu", {"n_cus": 4})
                   for n in ("copy", "vec_mul", "div_int"))
ALL_RUNS = MAIN_RUNS + COHORT_RUNS + BATCH_RUNS
# the serving drain's seeded variant of every 8-CU shared bench (seed
# VARIANT_SEED + its index in table order); the golden file holds them too
VARIANT_SEED = 100
VARIANT_RUNS = tuple(Run(f"8cu/shared/{n}/variant", n, "gpu", {"n_cus": 8},
                         seed=VARIANT_SEED + k)
                     for k, n in enumerate(programs.LEGACY_ORDER))
VARIANTS = {r.bench: r for r in VARIANT_RUNS}
# the drain's benches: xcorr's and parallel_sel's golden and variant
# images (cohorts of 2, ~41k and ~15k rounds) are left out to keep the
# script within its limit (REDUCED)
DRAIN_BENCHES = tuple(n for n in programs.LEGACY_ORDER
                      if n not in ("xcorr", "parallel_sel"))
# the mesh path's cohort of twelve (mesh_cohort) adds fir seeds 8 and 9
MESH_RUNS = tuple(Run(f"8cu/shared/fir/seed{k}", "fir", "gpu", {"n_cus": 8},
                      seed=k) for k in (8, 9))
GOLDEN_RUNS = ALL_RUNS + VARIANT_RUNS + MESH_RUNS   # every launch the file has
# The DSE sweep: the CI smoke grid (benchmarks/baselines/BENCH_dse.json)
# and the nightly grid's full axes, both on xcorr at (16, 128).
GOLDEN_DSE = ROOT / "src" / "repro_torch" / "dse" / "golden_dse.json"
BENCH_DSE = ROOT / "benchmarks" / "baselines" / "BENCH_dse.json"
DSE_BENCH, DSE_SIZES = "xcorr", (16, 128)
DSE_SMOKE = {"cus": (1,), "freq_targets": (500.0, 667.0)}
DSE_NIGHTLY = {"cus": (1, 2, 4, 8),
               "freq_targets": (500.0, 590.0, 667.0, 750.0),
               "memsys": ("shared", "banked", "banked-iso")}
REDUCED = ["1-CU and scalar xcorr/parallel_sel (58k-625k lockstep rounds "
           "each) are left out until rounds are captured in CUDA graphs",
           "DSE nightly grid: xcorr (64, 1024) -> (16, 128) (about 420k "
           "eager lockstep rounds at full size, which waits for graph "
           "capture of rounds); all 48 specs and every axis kept",
           "LM golden run: recurrentgemma-2b n_layers 26 -> 3 (one "
           "(rglru, rglru, local) unit) at f32 compute, so that the JAX "
           "package can compute the golden file on a CPU; full width",
           "LM main path: the full 26-layer model is held against its own "
           "plain path on the card, not against the JAX package",
           "MoE golden run: mixtral-8x7b n_layers 32 -> 1 at f32 compute, "
           "so that the JAX package computes golden_moe.json on a CPU "
           "(17.6 GB at its peak); full width",
           "MoE main path: mixtral-8x7b n_layers 32 -> 4 (6.07 B "
           "parameters, 24.3 GB in f32 on the card); full width",
           "llama4-scout-17b-a16e n_layers 48 -> 1 (4.15 B parameters); "
           "full width",
           "the registry's cross-product cell (shared, cohort, "
           "earliest-finish, seu; ~6.8k rounds), the serving drain's xcorr "
           "and parallel_sel cohorts (their golden and variant images, "
           "~41k and ~15k rounds): with phase 13 the script took 1,134.5 s "
           "of its 1,200 s on one host and 1,365 s on a slower one after "
           "the first two cuts (PERF.md); xcorr and parallel_sel still run "
           "on the main path, until rounds are captured in CUDA graphs",
           "hubert-xlarge golden run: n_layers 48 -> 2 at f32 compute; the "
           "main path runs all 48; full width",
           "qwen2-vl-72b golden run: n_layers 80 -> 1 at f32 compute (3.38 "
           "B parameters), so that the JAX package computes its golden "
           "file on a CPU; full width",
           "qwen2-vl-72b main path: n_layers 80 -> 4 (6.01 B parameters, "
           "24.0 GB in f32 on the card); full width"]

# The LM serving path: RecurrentGemma-2B, numpy-seeded weights, six
# prompts of seeded token ids in two waves of 4 slots (the first prefills
# past the 2048-token window, the second stays under it), 16 greedy tokens.
LM_ARCH = "recurrentgemma-2b"
LM_SEED = 0
LM_LENGTHS = (3072, 2900, 2500, 2049, 600, 37)
LM_SLOTS = 4
LM_MAX_NEW = 16
LM_TOPK = 8
GOLDEN_LM_LAYERS = 3
# f32 logits of magnitude ~1-5 after 3 full-width layers: the card and the
# CPU sum in other orders (cuBLAS, the kernels' tiles, XLA) and agree to
# ~1e-5 relative; 1e-3 leaves room and still catches any wrong term.
GOLDEN_TOL = 1e-3
# bf16 compute, 26 layers, the kernel path fed the plain path's tokens at
# every step (teacher forcing); the two paths round attention's output and
# the scan's input to bf16 at other points. Read on an H100 (PERF.md): the
# sound kernel path is at most ~0.1 from the plain path in the logits of
# any step, the path with rglru_scan fed bf16 inputs ~0.9 and with the
# window halved ~5.6. The limit sits between the sound path and the
# faults it must catch, about 3x from each.
BF16_TOL = 0.3


def lm_config(golden: bool = False):
    """The port's RecurrentGemma-2B config of the main path, or the golden
    run's (3 layers, f32 compute)."""
    cfg = get_config(LM_ARCH)
    if golden:
        cfg = cfg.replace(n_layers=GOLDEN_LM_LAYERS, compute_dtype="float32")
    return cfg


def lm_prompts(vocab: int):
    g = np.random.default_rng([LM_SEED, 1])
    return [[int(t) for t in g.integers(0, vocab, n)] for n in LM_LENGTHS]


def to_numpy(x) -> np.ndarray:
    """f32 numpy copy of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def record_generate(engine, prompts, max_new: int, forced=None,
                    per_call=None):
    """``engine.generate`` (the port's or the JAX package's Engine), with
    the logits of every ``_sample`` call kept (one call per wave for the
    prefill, then one per decode step). With ``forced`` (the tokens of
    another run's calls) each call returns those tokens instead of its own
    choice: teacher forcing, so that two paths see the same inputs at
    every step. Returns (tokens, calls) with calls[i] = (logits (rows, V)
    numpy, the tokens the call returned[, what ``per_call()`` returns
    after the call's logits are read])."""
    calls = []
    sample = engine._sample

    def recording(logits, rng):
        tok = sample(logits, rng)
        if forced is not None:
            tok = torch.as_tensor(forced[len(calls)], device=logits.device)
        call = (to_numpy(logits), [int(t) for t in tok.tolist()])
        calls.append(call if per_call is None else call + (per_call(),))
        return tok
    engine._sample = recording
    try:
        out = engine.generate(prompts, max_new)
    finally:
        del engine._sample
    return out, calls


def timed_generate(engine, prompts, max_new: int):
    """``engine.generate`` as a user calls it, with a CUDA event recorded
    after each ``_sample`` call and the kernels' launch counts read there:
    no copy of the logits and no sync that ``generate`` does not make
    itself. Returns (tokens, marks) with marks[i] = (ms since the start,
    launch_counts())."""
    marks = []
    sample = engine._sample

    def marking(logits, rng):
        tok = sample(logits, rng)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((ev, launch_counts()))
        return tok
    engine._sample = marking
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    try:
        out = engine.generate(prompts, max_new)
    finally:
        del engine._sample
    torch.cuda.synchronize()
    return out, [(start.elapsed_time(ev), n) for ev, n in marks]


def launch_counts() -> tuple:
    """(flash_attention launches, rglru_scan launches, flash_attention
    launches on its tensor-core route, rglru_scan launches on its ring
    route)."""
    return (fa.LAUNCHES, rg.LAUNCHES, fa.ROUTE_LAUNCHES["tensor_core"],
            rg.ROUTE_LAUNCHES["ring"])


def reset_launch_counts() -> None:
    fa.LAUNCHES = rg.LAUNCHES = 0
    fa.ROUTE_LAUNCHES = dict.fromkeys(fa.ROUTE_LAUNCHES, 0)
    rg.ROUTE_LAUNCHES = dict.fromkeys(rg.ROUTE_LAUNCHES, 0)


def per_prompt(calls, n_prompts: int, slots: int, max_new: int):
    """Split the recorded calls by prompt: for prompt i, its rows of the
    ``max_new`` logits that chose its generated tokens (the first is the
    prefill's)."""
    rows = []
    for i in range(n_prompts):
        wave, r = divmod(i, slots)
        first = wave * max_new
        rows.append([calls[first + t][0][r] for t in range(max_new)])
    return rows


def summarize(out, calls, prompts):
    """What the golden file keeps of one generate: per prompt its
    generated tokens, the top-1/top-2 margin of the logits behind each,
    and the top-k ids and values of its prefill logits."""
    out_rows = []
    for i, rows in enumerate(per_prompt(calls, len(prompts), LM_SLOTS,
                                        LM_MAX_NEW)):
        margins = []
        for logits in rows:
            top2 = np.sort(logits)[-2:]
            margins.append(float(top2[1] - top2[0]))
        ids = np.argsort(-rows[0], kind="stable")[:LM_TOPK]
        out_rows.append({"tokens": [int(t) for t in out[i][len(prompts[i]):]],
                         "margins": margins,
                         "prefill_top_ids": [int(t) for t in ids],
                         "prefill_top_vals": [float(rows[0][t]) for t in ids]})
    return out_rows


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


def _sha(mem) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        mem, dtype="<i4").tobytes()).hexdigest()


def summary(mem, info) -> dict:
    """What the golden file holds of one launch."""
    return {**{k: int(info[k]) for k in STAT_KEYS}, "mem_sha256": _sha(mem)}


def dse_summary(res) -> dict:
    """What the DSE golden file holds of a search result (the port's or
    the JAX package's): per point, in order, its label, the planner's
    achieved/depth/fmax/area/power as reported, and the cycle-accurate
    and free-pipelining cycles with the simulator's stats; the frontier,
    the analytic frontier and the excluded analytic picks."""
    points = []
    for p in res.points:
        row = p.report()
        m = p.per_bench[DSE_BENCH]
        points.append({
            **{k: row[k] for k in ("label", "achieved", "pipeline_depth",
                                   "fmax_mhz", "area_mm2", "power_w")},
            "cycles": int(m.cycles), "analytic_cycles": int(m.analytic_cycles),
            "stats": {k: int(m.info[k]) for k in STAT_KEYS}})
    return {"points": points,
            **{key: [p.label() for p in getattr(res, key)]
               for key in ("frontier", "analytic_frontier",
                           "excluded_analytic")}}


DSE_EXACT_POINT_KEYS = ("label", "achieved", "pipeline_depth", "fmax_mhz",
                        "area_mm2", "power_w", "time_us", "analytic_time_us",
                        "on_frontier", "on_analytic_frontier")


def dse_artifact_mismatches(fresh: dict, base: dict) -> list:
    """The exact fields of a ``BENCH_dse.json`` artifact that differ from
    the baseline's: those ``benchmarks.check_bench`` holds exactly
    (schema, bench set and cycles, frontier, analytic frontier, excluded
    picks) and, point by point, the labels, the planner's fields and the
    cycle-derived times. Wall-clock fields are not compared."""
    bad = []
    for key in ("schema", "reference"):
        if fresh.get(key) != base.get(key):
            bad.append(f"{key}: {fresh.get(key)!r} != {base.get(key)!r}")
    fb, bb = fresh.get("benches", {}), base.get("benches", {})
    if sorted(fb) != sorted(bb):
        bad.append(f"bench set {sorted(fb)} != {sorted(bb)}")
    for name in sorted(set(fb) & set(bb)):
        if fb[name]["cycles"] != bb[name]["cycles"]:
            bad.append(f"benches.{name}.cycles: {fb[name]['cycles']} != "
                       f"{bb[name]['cycles']}")
    for key in ("frontier", "analytic_frontier", "excluded_analytic"):
        if sorted(fresh.get(key, [])) != sorted(base.get(key, [])):
            bad.append(f"{key}: {fresh.get(key)} != {base.get(key)}")
    fp, bp = fresh.get("points", []), base.get("points", [])
    if len(fp) != len(bp):
        bad.append(f"{len(fp)} points != {len(bp)}")
    for f, b in zip(fp, bp):
        for key in DSE_EXACT_POINT_KEYS:
            if f.get(key) != b.get(key):
                bad.append(f"point {b.get('label')}.{key}: {f.get(key)!r} "
                           f"!= {b.get(key)!r}")
    return bad


def dse_spec() -> dict:
    """What the DSE golden file must have been computed for."""
    return {"grid": {k: list(v) for k, v in DSE_NIGHTLY.items()},
            "bench": DSE_BENCH, "sizes": list(DSE_SIZES)}


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


def _turns_ms(fns: dict, iters: int) -> dict:
    """``_device_ms`` of each of ``fns`` ({name: fn}), timed in turns
    (a, b, c, c, b, a): the mean of each one's two turns, so that a drift
    over the measurement favours none of them."""
    times = {name: [] for name in fns}
    order = list(fns)
    for name in order + order[::-1]:
        times[name].append(_device_ms(fns[name], iters))
    return {name: sum(t) / len(t) for name, t in times.items()}


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


def _offset(x):
    """``x`` copied to a base one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _pe_exact(name, op, imm, a, b, ops) -> int:
    """pe_execute against select_alu on one input, bit for bit; the call
    must launch the kernel once. Returns max |err| (0 when it passes)."""
    want = select_alu(op, a, b, imm, ops)
    before = pe_simd.LAUNCHES
    got = pe_simd.pe_execute(op, imm, a, b, ops)
    torch.cuda.synchronize()
    check(pe_simd.LAUNCHES == before + 1,
          f"pe_execute {name}: {pe_simd.LAUNCHES - before} launches")
    err = int((got.long() - want.long()).abs().max())
    check(torch.equal(got, want), f"pe_execute != select_alu on {name}")
    return err


def kernel_phase(dev) -> dict:
    """pe_execute against select_alu bit for bit on every case; each call
    must launch the kernel once."""
    cases = [("edges", _edge_inputs(dev), None)]
    mask = frozenset({isa.ADD, isa.MUL, isa.DIV, isa.SRL, isa.LUI})
    for W, L in ((1, 1), (64, 64), (1024, 64), (8, 64), (9, 96), (37, 5),
                 (5, 3), (7, 48)):
        for ops in (None, mask):
            cases.append((f"{W}x{L}" + ("/mask" if ops else ""),
                          _random_inputs(W, L, W + L, dev), ops))
    op, imm, a, b = _random_inputs(64, 64, 3, dev)
    cases.append(("64x64/offset", (op, imm, _offset(a), _offset(b)), None))
    max_err = max(_pe_exact(name, *inputs, ops)
                  for name, inputs, ops in cases)
    emit({"kernel_phase": {"pe_execute": {
        "exact": True, "cases": len(cases), "max_abs_err": max_err}}})
    return {"max_abs_err": max_err}


def pe_bound(W: int, L: int) -> dict:
    nbytes = 4 * (2 * W + 3 * W * L)      # op, imm read; a, b read; out
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = W * L / CUDA_CORE_OPS_PER_S * 1e3    # one select per lane
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}


def pe_shapes_phase(dev, paths: dict) -> dict:
    """pe_execute at every (W, L) the paths (``{path: {(W, L):
    launches}}``) launched it at: first held bit for bit against
    select_alu on random full-range inputs, with no opcode set and with
    each set the paths passed at that shape (``PATH_OPS``), one counted
    launch a check; then timed in turns with the launch floor (an empty
    kernel with the same arguments and grid); the bound; launch-weighted
    sums over all paths and over each. At 1024 x 64 also the plain version
    and eager launches from the host."""
    by_shape: dict = {}
    for counts in paths.values():
        for key, n in counts.items():
            by_shape[key] = by_shape.get(key, 0) + n
    shapes, checks, max_err = {}, 0, 0
    for (W, L), n in sorted(by_shape.items(), key=lambda kv: -kv[1]):
        op, imm, a, b = _random_inputs(W, L, 7, dev)
        op_sets = PATH_OPS.get((W, L), set()) | {None}
        for ops in sorted(op_sets, key=lambda o: (o is not None,
                                                  sorted(o or ()))):
            max_err = max(max_err, _pe_exact(
                f"{W}x{L}" + (f"/ops{sorted(ops)}" if ops else ""),
                op, imm, a, b, ops))
        checks += len(op_sets)
        out = torch.empty_like(a)
        shapes[f"{W}x{L}"] = {
            "launches": n, "exact_checks": len(op_sets),
            "launches_by_path": {
                path: counts.get((W, L), 0)
                for path, counts in paths.items()}, **_turns_ms({
                    "ms": lambda: pe_simd.pe_execute(op, imm, a, b),
                    "launch_floor_ms": lambda: pe_simd.launch_floor(
                        op, imm, a, b, out)}, 100),
            **pe_bound(W, L)}
    W, L = 1024, 64
    op, imm, a, b = _random_inputs(W, L, 7, dev)
    out = torch.empty_like(a)
    kernel = lambda: pe_simd.pe_execute(op, imm, a, b)  # noqa: E731
    plain = lambda: select_alu(op, a, b, imm)            # noqa: E731
    largest = {
        **_turns_ms({"ms": kernel,
                     "launch_floor_ms": lambda: pe_simd.launch_floor(
                         op, imm, a, b, out)}, 100),
        "plain_ms": _device_ms(plain, 10), "eager_ms": _eager_ms(kernel, 200),
        "plain_eager_ms": _eager_ms(plain, 20), **pe_bound(W, L)}

    def weighted(path=None):
        def n(v):
            return v["launches"] if path is None \
                else v["launches_by_path"][path]

        def total(key):
            return sum(n(v) * v[key] for v in shapes.values())
        out = {"launches": sum(n(v) for v in shapes.values()),
               "ms": total("ms"), "launch_floor_ms": total("launch_floor_ms"),
               "bound_ms": total("bound_ms")}
        out["gap_ms"] = out["ms"] - out["bound_ms"]
        out["above_floor_ms"] = out["ms"] - out["launch_floor_ms"]
        return out
    by_path = {path: weighted(path) for path in paths}
    exact = {"shapes": len(shapes), "checks": checks, "max_abs_err": max_err}
    emit({"pe_execute_shapes": {"exact": exact, "1024x64": largest,
                                "by_shape": shapes,
                                "launch_weighted": weighted(),
                                "launch_weighted_by_path": by_path}})
    return {**largest, "launch_weighted": weighted(),
            "launch_weighted_by_path": by_path, "exact": exact,
            "top_shapes": dict(list(shapes.items())[:3])}


# -- phase 3, continued: the LM kernels against their plain versions --------

# (bh, bhkv, sq, skv, hd, causal, window, dtype): RecurrentGemma-2B's
# prefill (4 sequences x 10 q heads, 1 kv head), SmolLM-360M's (4 x 15 q
# heads, 5 kv heads, hd 64, no window), the shapes of
# tests/test_kernels.py, and the tensor-core route's edges: hd no multiple
# of 16, a window no multiple of the kv tile (rows meet a fully masked
# first tile), cross lengths, hd no multiple of 8 (plain loads in place
# of 16-byte cp.async)
FLASH_PATH = (40, 4, 3072, 3072, 256, True, 2048, torch.bfloat16)
# Mixtral-8x7B's prefill of a 6,144-token wave of 4: 32 q heads, 8 kv
# heads (GQA 4), hd 128, the 4,096-token window
FLASH_MOE = (128, 32, 6144, 6144, 128, True, 4096, torch.bfloat16)
# HuBERT-XLarge's encode of 4 clips of 1,500 frames: 16 heads of hd 80
# (the tensor-core route pads it to 128), bidirectional; Qwen2-VL-72B's
# vision prefill of 2 images of 64 x 64 patches: 64 q heads, 8 kv heads
# (GQA 8), hd 128, causal over all 4,096 positions
FLASH_HUBERT = (64, 64, 1500, 1500, 80, False, 0, torch.bfloat16)
FLASH_QWEN_VL = (128, 16, 4096, 4096, 128, True, 0, torch.bfloat16)
# the shapes timed beside FLASH_PATH: {key: (case, sequences)}
FLASH_TIMED = {"moe_shape": (FLASH_MOE, 4), "hubert_shape": (FLASH_HUBERT, 4),
               "qwen2_vl_shape": (FLASH_QWEN_VL, 2)}
FLASH_CASES = [
    FLASH_PATH,
    FLASH_MOE,
    FLASH_HUBERT,
    FLASH_QWEN_VL,
    (60, 20, 2048, 2048, 64, True, 0, torch.bfloat16),
    (4, 2, 256, 256, 64, True, 0, torch.float32),
    (4, 4, 128, 128, 32, False, 0, torch.float32),
    (8, 2, 200, 200, 64, True, 64, torch.float32),
    (2, 1, 384, 384, 128, True, 128, torch.float32),
    (2, 2, 128, 128, 64, True, 0, torch.bfloat16),
    (6, 3, 96, 160, 64, False, 0, torch.float32),
    (8, 2, 200, 200, 72, True, 64, torch.bfloat16),
    (10, 1, 1000, 1000, 256, True, 300, torch.bfloat16),
    (6, 3, 96, 160, 64, False, 0, torch.bfloat16),
    (3, 1, 130, 130, 33, True, 0, torch.bfloat16),
]
# flash_attention's limits: max |err| as the JAX package's tests hold its
# kernel, and max |err| per query row over the row's largest |o|, since
# most rows of the 2048-key window average so many keys that |o| is a few
# 1e-2 there, where the absolute limit alone would pass a wrong kernel.
# Kernel and plain version both sum in f32 and round the result, so at
# bf16 they may differ by one bf16 ulp, at most 2**-7 = 7.8e-3 of the
# row's largest |o|: the limit is 1e-2 (at f32, 1e-5, ~1e-6 is seen).
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_ROW_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# rglru_scan: the path's two prefill waves (4 x 3072 and 2 x 600 rows of
# 2560 channels), the test shapes, a ragged channel tile (D = 40), S = 1, a
# ragged last stage over several turns of the ring; D no multiple of 4 and
# a base off by one float on the direct route. (B, S, D, offset base)
RGLRU_PATH = (4, 3072, 2560)
RGLRU_WAVE2 = (2, 600, 2560)
RGLRU_CASES = [RGLRU_PATH + (False,), RGLRU_WAVE2 + (False,),
               (1, 64, 128, False), (3, 100, 96, False), (2, 17, 40, False),
               (1, 1, 64, False), (2, 1000, 64, False), (2, 17, 33, False),
               (2, 100, 64, True)]
SPLIT_CASES = [(2, 1), (7, 3), (30, 2), (3072, 4)]     # (S, B), D = 16


def _normal(shape, seed, dev, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return torch.as_tensor(x, device=dev).to(dtype)


def _flash_inputs(case, dev, seed=0):
    bh, bhkv, sq, skv, hd, _, _, dtype = case
    return (_normal((bh, sq, hd), seed, dev, dtype),
            _normal((bhkv, skv, hd), seed + 1, dev, dtype),
            _normal((bhkv, skv, hd), seed + 2, dev, dtype))


def _sdpa(q, k, v, causal, window, bsz):
    """One PyTorch call for the same attention, as a yardstick only: the
    port never calls it. (BH, S, hd) -> (B, H, S, hd) views; an explicit
    boolean mask carries causality and the window."""
    bh, sq, hd = q.shape
    bhkv, skv, _ = k.shape
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q.view(bsz, bh // bsz, sq, hd),
                        k.view(bsz, bhkv // bsz, skv, hd),
                        v.view(bsz, bhkv // bsz, skv, hd), attn_mask=mask,
                        scale=hd ** -0.5, enable_gqa=True)


def issued_pairs(sq: int, skv: int, causal: bool, window: int, bq: int,
                 bk: int) -> int:
    """(q, k) pairs the tensor-core route computes per head: whole
    bq x bk tiles, all that the skip rule keeps."""
    nk = -(-skv // bk)
    tiles = 0
    for q0 in range(0, sq, bq):
        lo = q0 - window + 1
        begin = lo // bk if window > 0 and lo > 0 else 0
        end = min(nk, (min(q0 + bq, sq) - 1) // bk + 1) if causal else nk
        tiles += max(end - begin, 0)
    return tiles * bq * bk


def _flash_name(case) -> str:
    bh, bhkv, sq, skv, hd, causal, window, dtype = case
    return "x".join(map(str, case[:5])) + f"/c{int(causal)}/w{window}" \
        + f"/{str(dtype)[6:]}"


def _plain_attention(q, k, v, causal, window, max_heads: int = 16):
    """``attention_ref`` in chunks of at most ``max_heads`` query heads
    (whole GQA groups) where the (heads, sq, skv) f32 scores pass 4 GiB,
    so that a long prompt's reference fits on the card."""
    bh, sq, hd = q.shape
    bhkv, skv = k.shape[:2]
    kw = dict(causal=causal, window=window, scale=hd ** -0.5)
    if bh * sq * skv <= 2 ** 30:
        return attention_ref(q, k, v, **kw)
    g = bh // bhkv
    step = max(g, max_heads - max_heads % g)
    return torch.cat([attention_ref(q[i:i + step], k[i // g:(i + step) // g],
                                    v[i // g:(i + step) // g], **kw)
                      for i in range(0, bh, step)])


def _flash_errs(got, want):
    """(max |err|, the largest over query rows of max |err| in the row
    over the row's largest |want|)."""
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    return float(d.max()), float((d.amax(-1) / scale).max())


def flash_phase(dev) -> dict:
    errs, row_errs = {}, {}
    for case in FLASH_CASES:
        bh, bhkv, sq, skv, hd, causal, window, dtype = case
        q, k, v = _flash_inputs(case, dev)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = _plain_attention(q, k, v, causal, window)
        torch.cuda.synchronize()
        name = _flash_name(case)
        errs[name], row_errs[name] = _flash_errs(got, want)
        tol, rtol = FLASH_ATOL[dtype], FLASH_ROW_RTOL[dtype]
        check(errs[name] <= tol and row_errs[name] <= rtol,
              f"flash_attention {name}: max |err| {errs[name]} (limit "
              f"{tol}), per row {row_errs[name]} of its max |o| (limit "
              f"{rtol})")
        if case is FLASH_PATH:
            # a planted fault: the kernel's result against a window one key
            # short must fail the limits
            short = attention_ref(q, k, v, causal=causal, window=window - 1,
                                  scale=hd ** -0.5)
            fault = _flash_errs(got, short)
            check(fault[0] > tol or fault[1] > rtol,
                  f"flash_attention {name}: a window one key short passes "
                  f"the limits (max |err| {fault[0]}, per row {fault[1]})")
        del q, k, v, got, want
    timing = {**_flash_timing(FLASH_PATH, dev, 4),
              "max_abs_err": errs[next(iter(errs))],
              "max_row_rel_err": row_errs[next(iter(row_errs))],
              "planted_window_short": {"max_abs_err": fault[0],
                                       "max_row_rel_err": fault[1]}}
    for key, (case, bsz) in FLASH_TIMED.items():
        timing[key] = {**_flash_timing(case, dev, bsz),
                       "shape": list(case[:7]),
                       "max_abs_err": errs[_flash_name(case)],
                       "max_row_rel_err": row_errs[_flash_name(case)]}
    emit({"kernel_phase": {"flash_attention": {
        "cases": errs, "row_rel": row_errs,
        "limits": {"f32": [FLASH_ATOL[torch.float32],
                           FLASH_ROW_RTOL[torch.float32]],
                   "bf16": [FLASH_ATOL[torch.bfloat16],
                            FLASH_ROW_RTOL[torch.bfloat16]]},
        "tensor_core_designs": {w: fa.tensor_core_design(w)
                                for w in (64, 128, 256)},
        "path_shape": timing}}})
    return timing


def _flash_timing(case, dev, bsz: int) -> dict:
    """flash_attention at ``case`` (``bsz`` sequences) timed beside its
    plain version and scaled_dot_product_attention, with its bound: the
    operations of the visible (q, k) pairs at the bf16 tensor-core rate,
    or the bytes of q, k, v and o at the memory rate, the larger."""
    bh, bhkv, sq, skv, hd, causal, window, dtype = case
    q, k, v = _flash_inputs(case, dev, seed=5)
    pairs = fa.visible_pairs(sq, skv, causal, window) * bh
    flops = 4 * hd * pairs                       # QK and PV, 2 per MAC
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    design = fa.tensor_core_design(hd)
    check(tuple(design[key] for key in ("hd_pad", "block_q", "block_k"))
          == fa.tensor_core_tiles(hd),
          f"flash_attention: the built design {design} differs from "
          f"tensor_core_tiles({hd}) = {fa.tensor_core_tiles(hd)}")
    # QK once and PV twice (p as two bf16 terms), 2 flops per MAC, at the
    # padded head width
    issued = 6 * design["hd_pad"] * bh * issued_pairs(
        sq, skv, causal, window, design["block_q"], design["block_k"])
    kernel = lambda: fa.flash_attention(q, k, v, causal=causal,  # noqa
                                        window=window)
    plain = lambda: _plain_attention(q, k, v, causal, window)  # noqa: E731
    library = _sdpa(q, k, v, causal, window, bsz=bsz)
    lib_err = float((library().reshape(q.shape).float()
                     - kernel().float()).abs().max())
    ms = _device_ms(kernel, 5)
    return {"ms": ms, "plain_ms": _device_ms(plain, 2),
            "library_ms": _device_ms(library, 5),
            "route": fa.route(dtype, hd),
            "tflops": flops / ms * 1e-9,
            "issued_tflops": issued / ms * 1e-9,
            "design": {**design, "p": "hi + lo bf16 terms",
                       "mma": "mma.sync.m16n8k16 bf16, f32 accumulate"},
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "issued_flops": issued, "bytes": nbytes,
            "visible_pairs": pairs,
            "library_vs_kernel_max_abs": lib_err}


def _scan_inputs(shape, seed, dev):
    b, s, d = shape
    return (torch.sigmoid(_normal((b, s, d), seed, dev)),
            _normal((b, s, d), seed + 1, dev), _normal((b, d), seed + 2, dev))


def _scan_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def rglru_phase(dev) -> dict:
    """rglru_scan against rglru_scan_ref (1e-5) on the route the wrapper
    picks (its counter must move) and, where that is the ring, on the
    direct route too; split-and-carry (1e-4); both routes timed in turns
    at the path's two prefill shapes beside the bound and the plain
    version."""
    design = rg.ring_design()
    check(design["spill_bytes"] == 0 and design["blocks_per_sm"] >= 3,
          f"rglru_scan: the built ring {design} spills or fits fewer than "
          "3 blocks an SM")
    errs, routes = {}, {}
    for i, (b, s, d, off) in enumerate(RGLRU_CASES):
        a, x, h0 = _scan_inputs((b, s, d), 10 + 3 * i, dev)
        if off:
            a, x = _offset(a), _offset(x)
        ref = rglru_scan_ref(a, x, h0)
        path = rg.scan_route(b, s, d, not off)
        name = f"{b}x{s}x{d}" + ("/offset" if off else "")
        for p in (("ring", "direct") if path == "ring" else ("direct",)):
            before = dict(rg.ROUTE_LAUNCHES)
            got = (rg.rglru_scan(a, x, h0) if p == path
                   else rg._launch(p, a, x, h0))
            torch.cuda.synchronize()
            moved = {r: n - before[r] for r, n in rg.ROUTE_LAUNCHES.items()}
            check(moved == {r: int(r == p) for r in rg.ROUTES},
                  f"rglru_scan {name}: launches by route {moved}, want {p}")
            err = _scan_err(got, ref)
            errs[f"{name}/{p}"] = err
            check(err <= 1e-5, f"rglru_scan {name} ({p} route): max |err| "
                  f"{err} > 1e-5")
        routes[name] = path
    for s, b in SPLIT_CASES:
        a, x, h0 = _scan_inputs((b, s, 16), s, dev)
        cut = max(1, s // 2)
        h_full, hf_full = rglru_scan_ref(a, x, h0)
        _, hf1 = rg.rglru_scan(a[:, :cut].contiguous(),
                               x[:, :cut].contiguous(), h0)
        h2, hf2 = rg.rglru_scan(a[:, cut:].contiguous(),
                                x[:, cut:].contiguous(), hf1)
        err = max(float((hf2 - hf_full).abs().max()),
                  float((h2 - h_full[:, cut:]).abs().max()))
        errs[f"split/{b}x{s}x16"] = err
        check(err <= 1e-4, f"rglru_scan split {b}x{s}: {err} > 1e-4")
    shapes = {}
    for j, shape in enumerate((RGLRU_PATH, RGLRU_WAVE2)):
        b, s, d = shape
        a, x, h0 = _scan_inputs(shape, 40 + 3 * j, dev)
        nbytes = 4 * (3 * b * s * d + 2 * b * d)  # a, b read; h written; h0, hf
        shapes["x".join(map(str, shape))] = {
            "route": rg.scan_route(b, s, d, True), **_turns_ms({
                "ms": lambda: rg.rglru_scan(a, x, h0),
                "direct_ms": lambda: rg._launch("direct", a, x, h0)},
                20),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    b, s, d = RGLRU_PATH
    a, x, h0 = _scan_inputs(RGLRU_PATH, 40, dev)
    timing = {**shapes["x".join(map(str, RGLRU_PATH))],
              "plain_ms": _device_ms(lambda: rglru_scan_ref(a, x, h0), 1, 2),
              "plain_model_path_ms": _device_ms(
                  lambda: linear_scan(a, x, h0), 2),
              "bound_by": "bytes", "library_ms": None,
              "max_abs_err": errs[f"{b}x{s}x{d}/ring"]}
    emit({"kernel_phase": {"rglru_scan": {
        "cases": errs, "routes": routes,
        "ring_design": {**design, "copies": "cp.async.bulk.tensor.3d "
                        "(TMA), one mbarrier per stage"},
        "shapes": shapes, "path_shape": timing}}})
    return {**timing, "shapes": shapes, "design": design}


# -- phases 7 and 8: the LM serving path --------------------------------------

def golden_spec() -> dict:
    """What the golden file must have been computed for."""
    return {"arch": LM_ARCH, "n_layers": GOLDEN_LM_LAYERS,
            "compute_dtype": "float32", "seed": LM_SEED,
            "lengths": list(LM_LENGTHS), "slots": LM_SLOTS,
            "max_new": LM_MAX_NEW, "topk": LM_TOPK}


def _waves(marks, n_start, max_new: int = LM_MAX_NEW):
    """Per wave of ``timed_generate``'s marks: prefill ms, decode ms per
    step, and the kernels' launches (``launch_counts``) in its prefill and
    in its decode steps (``n_start``: the counts when the run began)."""
    out = []
    prev_ms, prev_n = 0.0, n_start
    for w in range(len(marks) // max_new):
        first, last = marks[w * max_new], marks[(w + 1) * max_new - 1]
        out.append({
            "prefill_ms": first[0] - prev_ms,
            "decode_ms_per_step": (last[0] - first[0]) / (max_new - 1),
            "prefill_launches": [first[1][j] - prev_n[j]
                                 for j in range(len(prev_n))],
            "decode_launches": [last[1][j] - first[1][j]
                                for j in range(len(prev_n))]})
        prev_ms, prev_n = last[0], last[1]
    return out


def _window_of(new_window):
    """flash_attention with its window set to ``new_window(window)``."""
    def wrap(orig):
        def run(q, k, v, *, causal, window, scale):
            return orig(q, k, v, causal=causal, window=new_window(window),
                        scale=scale)
        return run
    return wrap


def _bf16_scan(orig):
    """rglru_scan fed a and b rounded to bf16 (h still carried in f32)."""
    def run(a, b, h0):
        return orig(a.bfloat16().float(), b.bfloat16().float(), h0)
    return run


# Faults planted in the kernel path to show what the teacher-forced LM
# comparison can see: (name, module, attribute the model calls, wrapper,
# whether the comparison must catch it). A window one key short moves the
# logits no more than bf16 rounding does; the kernel phase catches it.
LM_FAULTS = (("flash_attention window one key short", kops,
              "flash_attention", _window_of(lambda w: w - 1), False),
             ("flash_attention window halved", kops, "flash_attention",
              _window_of(lambda w: w // 2), True),
             ("rglru_scan inputs rounded to bf16", rg, "rglru_scan",
              _bf16_scan, True))


def router_gap(probs, k: int):
    """The gap between the k-th and (k+1)-th router probability of each
    token: (B, S)."""
    top = probs.topk(k + 1, dim=-1).values
    return top[..., k - 1] - top[..., k]


class RoutingLog:
    """While open, ``models.moe.route`` also records, per MoE layer of a
    forward: its experts (B, S, K) as int8 on the device, the smallest
    router gap over the forward's tokens and each row's gap at its last
    token. ``take`` returns (and clears) what the forward since the last
    take recorded: pass it as ``record_generate``'s ``per_call``."""

    def __init__(self):
        self.layers = []

    def __enter__(self):
        self._orig = orig = moe.route

        def recording(hx, w, k):
            probs, gates, experts = orig(hx, w, k)
            gap = router_gap(probs, k)
            self.layers.append((experts.to(torch.int8), gap.min(),
                                gap[:, -1]))
            return probs, gates, experts
        moe.route = recording
        return self

    def __exit__(self, *exc):
        moe.route = self._orig

    def take(self) -> list:
        out, self.layers = self.layers, []
        return out


class planted:
    """While open, each (module, attribute, wrapper) of ``patches`` is
    planted: the attribute replaced by wrapper(the original)."""

    def __init__(self, patches):
        self.patches = patches

    def __enter__(self):
        self.origs = [(mod, attr, getattr(mod, attr))
                      for mod, attr, _ in self.patches]
        for mod, attr, wrap in self.patches:
            setattr(mod, attr, wrap(getattr(mod, attr)))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.origs:
            setattr(mod, attr, orig)


def _forced_calls(engine, prompts, ref_calls, max_new: int, fault=None):
    """The calls of ``engine`` fed ``ref_calls``' tokens, with its routing
    (a RoutingLog) for an MoE config; ``fault``: an entry of LM_FAULTS,
    MOE_FAULTS, SCOUT_FAULTS or QWEN_FAULTS to plant for the run."""
    patches = () if fault is None else ((fault[1], fault[2], fault[3]),)
    with planted(patches):
        return _routed_generate(engine, prompts, max_new,
                                forced=[c[1] for c in ref_calls])[1]


def _routed_generate(engine, prompts, max_new: int, forced=None):
    """record_generate, with each call's RoutingLog layers as its third
    element when the config has experts."""
    if not engine.cfg.n_experts:
        return record_generate(engine, prompts, max_new, forced)
    with RoutingLog() as log:
        return record_generate(engine, prompts, max_new, forced,
                               per_call=log.take)


def _compare(calls, ref_calls, max_new: int) -> dict:
    """The kernel path's teacher-forced ``calls`` against the plain path's
    ``ref_calls``: per call, the tokens (over layers and positions) whose
    expert sets differ; the (call, row)s whose current token changed
    experts in some layer, with the plain path's router gap at the first
    such layer; and the largest |logits error| of the other (call, row)s,
    over all calls, the prefills and the decode steps."""
    errs = [np.abs(g[0] - w[0]).max(-1) for g, w in zip(calls, ref_calls)]
    flips, differing = {}, []
    for c, (got, want) in enumerate(zip(calls, ref_calls)):
        n = 0
        for (ea, _, _), (eb, _, gap) in zip(got[2] if len(got) > 2 else (),
                                            want[2] if len(want) > 2 else ()):
            d = (ea.sort(-1).values != eb.sort(-1).values).any(-1)
            n += int(d.sum())
            for r in torch.nonzero(d[:, -1]).flatten().tolist():
                flips.setdefault((c, r), float(gap[r]))
        differing.append(n)
    sound = [(c, float(e)) for c, row in enumerate(errs)
             for r, e in enumerate(row) if (c, r) not in flips]

    def worst(sel):
        return max((e for c, e in sound if sel(c)), default=0.0)
    res = {"max": worst(lambda c: True),
           "prefill_max": worst(lambda c: c % max_new == 0),
           "decode_max": worst(lambda c: c % max_new != 0),
           "call_rows": sum(len(e) for e in errs),
           "max_flip_gap": max(flips.values(), default=0.0)}
    if any(len(c) > 2 for c in ref_calls):          # the routing was logged
        res.update(flipped_call_rows=len(flips),
                   flip_gaps=sorted(flips.values()),
                   tokens_with_other_experts=differing)
    return res


def _over(res: dict, tol: float) -> bool:
    """Whether a comparison fails its limits."""
    return res["max"] > tol or res["max_flip_gap"] > MOE_GAP_TOL


def _matched_steps(tokens, ref_tokens, ref_margins, tol, what):
    """Tokens equal up to the first step whose reference top-2 margin is
    under ``tol`` (there the argmax may rightly differ). Returns the
    number of steps held equal."""
    for t, (mine, ref, margin) in enumerate(zip(tokens, ref_tokens,
                                                ref_margins)):
        if margin < tol:
            return t
        check(mine == ref, f"{what}: token {t} is {mine}, reference {ref} "
              f"(margin {margin})")
    return len(ref_tokens)


def lm_golden(dev) -> None:
    golden = json.loads(GOLDEN_LM.read_text())
    check(golden["spec"] == golden_spec(),
          f"{GOLDEN_LM.name} was made for {golden['spec']}, not "
          f"{golden_spec()}: regenerate it")
    cfg = lm_config(golden=True)
    t0 = time.perf_counter()
    model = init_model(cfg, LM_SEED, dev)
    init_s = time.perf_counter() - t0
    prompts = lm_prompts(cfg.vocab_size)
    before = dict(fa.ROUTE_LAUNCHES)
    t0 = time.perf_counter()
    out, calls = record_generate(Engine(cfg, model,
                                        EngineConfig(slots=LM_SLOTS)),
                                 prompts, LM_MAX_NEW)
    wall = time.perf_counter() - t0
    routes = {r: n - before[r] for r, n in fa.ROUTE_LAUNCHES.items()}
    check(routes["simt"] > 0 and routes["tensor_core"] == 0,
          f"golden run (f32): flash_attention launches by route {routes}")
    check(len(calls) == 2 * LM_MAX_NEW, f"{len(calls)} sampling calls")
    mine = summarize(out, calls, prompts)
    rows = per_prompt(calls, len(prompts), LM_SLOTS, LM_MAX_NEW)
    top_err, matched = 0.0, []
    for i, (ref, got) in enumerate(zip(golden["prompts"], mine)):
        at_ref = rows[i][0][ref["prefill_top_ids"]]
        top_err = max(top_err,
                      float(np.abs(at_ref - ref["prefill_top_vals"]).max()),
                      float(np.abs(np.asarray(got["prefill_top_vals"])
                                   - ref["prefill_top_vals"]).max()))
        matched.append(_matched_steps(got["tokens"], ref["tokens"],
                                      ref["margins"], GOLDEN_TOL,
                                      f"golden prompt {i}"))
    check(top_err <= GOLDEN_TOL, f"golden prefill logits: max |err| "
          f"{top_err} > {GOLDEN_TOL}")
    emit({"lm_golden": {"layers": cfg.n_layers, "compute": "float32",
                        "params": cfg.n_params(), "init_s": init_s,
                        "wall_s": wall, "flash_launches_by_route": routes,
                        "prefill_top_max_abs_err": top_err,
                        "tol": GOLDEN_TOL, "steps_matched": matched,
                        "of_steps": LM_MAX_NEW}})
    del model, calls, rows
    torch.cuda.empty_cache()


def lm_main_path(dev) -> tuple:
    """The full model through the kernels, timed as a user runs it; then
    its plain path on the card, and the kernel path fed the plain path's
    tokens (teacher forcing), clean and with each of LM_FAULTS planted.
    Returns the kernels' launch_counts() of the timed run."""
    cfg = lm_config()
    t0 = time.perf_counter()
    model = init_model(cfg, LM_SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = lm_prompts(cfg.vocab_size)
    engine = Engine(cfg, model, EngineConfig(slots=LM_SLOTS))
    t0 = time.perf_counter()
    engine.generate(prompts, LM_MAX_NEW)      # warm-up: first-use costs
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out, marks = timed_generate(engine, prompts, LM_MAX_NEW)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts[:2]
    peak = torch.cuda.max_memory_allocated()
    waves = _waves(marks, (0, 0, 0, 0))
    n_attn = sum(k != "rglru" for k in cfg.pattern())
    n_rglru = cfg.n_layers - n_attn
    for w in waves:
        # [flash, rglru, flash on the tensor-core route, rglru on the ring
        # route]: bf16 compute, every scan on the ring
        check(w["prefill_launches"] == [n_attn, n_rglru, n_attn, n_rglru],
              f"prefill launches {w['prefill_launches']}")
        check(w["decode_launches"] == [0, 0, 0, 0],
              f"decode launches {w['decode_launches']}")
    plain = Engine(cfg.replace(use_kernels=False), model,
                   EngineConfig(slots=LM_SLOTS))
    t1 = time.perf_counter()
    out_p, calls_p = record_generate(plain, prompts, LM_MAX_NEW)
    plain_wall = time.perf_counter() - t1
    check(launch_counts() == counts, "the plain path launched a kernel")
    sound = _compare(_forced_calls(engine, prompts, calls_p, LM_MAX_NEW),
                     calls_p, LM_MAX_NEW)
    faults = {fault[0]: {**_compare(_forced_calls(engine, prompts, calls_p,
                                                  LM_MAX_NEW, fault),
                                    calls_p, LM_MAX_NEW),
                         "must_fail": fault[4]} for fault in LM_FAULTS}
    ref = summarize(out_p, calls_p, prompts)
    matched = [_matched_steps(out[i][len(p):], r["tokens"], r["margins"],
                              BF16_TOL, f"plain-path prompt {i}")
               for i, (p, r) in enumerate(zip(prompts, ref))]
    generated = sum(len(o) - len(p) for o, p in zip(out, prompts))
    emit({"lm_main_path": {
        "arch": cfg.name, "layers": cfg.n_layers, "compute": cfg.compute_dtype,
        "params": cfg.n_params(), "init_s": init_s, "warm_up_s": warm_s,
        "wall_s": wall,
        "waves": waves, "generated_tokens": generated,
        "tokens_per_s": generated / wall, "peak_device_gb": peak / 1e9,
        "flash_attention_launches": launches[0],
        "flash_attention_tensor_core_launches": counts[2],
        "rglru_scan_launches": launches[1],
        "rglru_scan_ring_launches": counts[3],
        "plain_path_wall_s_with_logit_copies": plain_wall,
        "forced_logits_max_abs_err_vs_plain": sound,
        "forced_calls": len(calls_p), "tol": BF16_TOL,
        "planted_faults": faults,
        "steps_matched_vs_plain": matched, "of_steps": LM_MAX_NEW}})
    check(len(calls_p) == 2 * LM_MAX_NEW,
          f"{len(calls_p)} forced sampling calls")
    check(sound["max"] <= BF16_TOL, f"bf16 logits, kernels vs plain "
          f"(teacher forced, every step): max |err| {sound['max']} > "
          f"{BF16_TOL}")
    for name, f in faults.items():
        check(not f["must_fail"] or f["max"] > BF16_TOL,
              f"planted fault '{name}' passes the {BF16_TOL} limit "
              f"(max |err| {f['max']})")
    profile = lm_profile(model, cfg, prompts[:LM_SLOTS])
    del engine, plain, out, out_p, calls_p
    leg = prefill_leg(model, cfg, dev)
    leg["measured_ms"] = profile["prefill"]["wall_ms"]
    del model
    torch.cuda.empty_cache()
    return counts, leg


# the kernels' symbols, as the profiler names them: flash_attention's
# tensor-core (bf16) and SIMT (f32) routes, rglru_scan's ring and direct
# routes, pe_execute's kernel
FLASH_SYMBOLS = ("flash_mma_kernel", "flash_simt_kernel")
RGLRU_SYMBOLS = ("rglru_ring_kernel", "rglru_direct_kernel")
PE_SYMBOLS = ("pe_execute_kernel",)


def lm_profile(model, cfg, prompts, steps: int = 5,
               key: str = "lm_profile") -> None:
    """Where the first wave's time goes: its prefill and ``steps`` decode
    steps, each timed without the profiler and then run under it (device
    time, device ops, busy share of the unprofiled wall, top kernels);
    emitted under ``key``."""
    plen = max(map(len, prompts))
    batch = np.zeros((len(prompts), plen), np.int64)
    for r, p in enumerate(prompts):
        batch[r, plen - len(p):] = p
    tokens = torch.from_numpy(batch).to(model.device)
    cap = plen + 2 * steps + 1
    state = {}

    def prefill():
        state["logits"], state["cache"] = M.prefill(model, cfg, tokens=tokens,
                                                    pad_to=cap)

    def decode(start):
        def run():
            for t in range(steps):
                last = state["logits"].argmax(-1)[:, None]
                state["logits"], state["cache"] = M.decode_step(
                    model, cfg, state["cache"], last, start + t)
        return run

    out = {}
    with torch.inference_mode():
        for name, fn, profiled_fn, per in (
                ("prefill", prefill, prefill, 1),
                ("decode_step", decode(plen), decode(plen + steps), steps)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            before = fa.LAUNCHES
            kernels, profiled_ms = _profiled(profiled_fn)
            flash_launched = fa.LAUNCHES - before
            busy = _device_ms_of(kernels)
            flash_ms = sum(_device_ms_of(kernels, sym)
                           for sym in FLASH_SYMBOLS)
            check(flash_ms > 0 or not flash_launched,
                  f"lm_profile {name}: {flash_launched} flash_attention "
                  f"launches but no device time under {FLASH_SYMBOLS}")
            out[name] = {
                "wall_ms": wall_ms / per, "profiled_wall_ms": profiled_ms / per,
                "device_ms": busy / per, "device_busy_share": busy / wall_ms,
                "device_ops": len(kernels) / per,
                "flash_attention_launches": flash_launched / per,
                "flash_attention_ms": flash_ms / per,
                "rglru_scan_ms": sum(_device_ms_of(kernels, sym)
                                     for sym in RGLRU_SYMBOLS) / per,
                "top_device_ms": {k: v / per
                                  for k, v in _top(kernels, 8).items()}}
    emit({key: {"rows": len(prompts), "prompt_len": plen, **out}})
    return out


# -- phase 4: the simulator on the card ---------------------------------------

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


def _profiled(fn):
    """Run ``fn`` once under torch.profiler, tracing device activity only
    (every reader takes device kernels alone; a host trace costs read-back
    time). Returns (each device op's (name, ms), profiled host wall ms),
    read from the raw trace: parsing it into profiler events gives the
    same ops and costs seconds of host time per 10k kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return ([(e.name(), e.duration_ns() / 1e6)
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA], wall_ms)


def _device_ms_of(kernels, match: str = "") -> float:
    return sum(ms for name, ms in kernels if match in name)


def _top(kernels, n: int = 6) -> dict:
    by_name: dict = {}
    for name, ms in kernels:
        by_name[name[:60]] = by_name.get(name[:60], 0) + ms
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:n])


def profile_phase(benches, dev, key: str = "8cu/shared/fir") -> None:
    """Where a round's time goes: one run under torch.profiler, its device
    (kernel) time and kernel count per round against the wall time of the
    same run without the profiler."""
    run = next(r for r in MAIN_RUNS if r.key == key)
    prog, mem0, n, _, _ = launch(run, benches)
    cfg = make_config(run, GGPUConfig, ScalarConfig)
    t0 = time.perf_counter()
    run_kernel(prog, mem0, n, cfg, device=dev)        # unprofiled wall time
    wall_ms = (time.perf_counter() - t0) * 1e3
    before = pe_simd.LAUNCHES
    kernels, profiled_ms = _profiled(
        lambda: run_kernel(prog, mem0, n, cfg, device=dev))
    rounds = pe_simd.LAUNCHES - before
    busy_ms = _device_ms_of(kernels)
    emit({"profile": {
        "run": key, "rounds": rounds, "wall_ms_per_round": wall_ms / rounds,
        "profiled_wall_ms_per_round": profiled_ms / rounds,
        "device_ms_per_round": busy_ms / rounds,
        "device_busy_share": busy_ms / wall_ms,   # of the unprofiled wall
        "device_ops_per_round": len(kernels) / rounds,
        "pe_execute_device_us_per_round":
            sum(_device_ms_of(kernels, sym) for sym in PE_SYMBOLS)
            / rounds * 1e3,
        "top_device_ms": _top(kernels)}})


# the opcode sets (ops_present) the counted paths gave pe_execute, by
# (W, L): pe_shapes_phase holds the kernel at each against select_alu
PATH_OPS: dict = {}


def _counted_by_shape(fn, by_shape: dict):
    """``fn`` (pe_execute), counting its calls in ``by_shape`` by the
    (W, L) of their operands and noting their opcode sets in
    ``PATH_OPS``."""
    def counted(op, imm, a, b, ops_present=None):
        key = tuple(a.shape)
        by_shape[key] = by_shape.get(key, 0) + 1
        PATH_OPS.setdefault(key, set()).add(
            None if ops_present is None else frozenset(ops_present))
        return fn(op, imm, a, b, ops_present)
    return counted


def counted_path(fn, *args):
    """Run a path with ``pe_execute``'s launch count set to 0 just before
    it and its calls counted by (W, L). Returns (fn's result, launches,
    launches by shape, wall s); fails unless every call launched."""
    by_shape: dict = {}
    kernel_fn = pe_simd.pe_execute
    pe_simd.pe_execute = _counted_by_shape(kernel_fn, by_shape)
    pe_simd.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    finally:
        pe_simd.pe_execute = kernel_fn
    wall = time.perf_counter() - t0
    launches = pe_simd.LAUNCHES
    check(sum(by_shape.values()) == launches,
          f"pe_execute: {sum(by_shape.values())} calls on {fn.__name__} but "
          f"{launches} kernel launches")
    return out, launches, by_shape, wall


def _timed(fn, *args):
    """(fn's result, pe_execute launches it made, wall s)."""
    before, t0 = pe_simd.LAUNCHES, time.perf_counter()
    out = fn(*args)
    return out, pe_simd.LAUNCHES - before, time.perf_counter() - t0


def _rounds_line(wall, rounds) -> dict:
    return {"wall_s": wall, "rounds": rounds,
            "us_per_round": wall / rounds * 1e6 if rounds else None}


# -- phase 5: kernel serving on the card -------------------------------------

# the async entry points' checks: the 8-CU shared benches whose single
# launches are repeated with out_regions (xcorr and parallel_sel, 55k
# rounds together, go through run_kernel_async already: run_kernel is
# run_kernel_async(...).result() on the main path)
ASYNC_BENCHES = ("mat_mul", "copy", "vec_mul", "fir", "div_int", "reduction")
# The serve benchmark's throughput traffic: vec_mul(32, 512) on 2 CUs, 8
# bursts of 16 seeded images, chunks of 2 launches.
SERVE_BENCH, SERVE_SIZES, SERVE_CUS = "vec_mul", (32, 512), 2
SERVE_BURSTS, SERVE_BURST, SERVE_MAX_BATCH, SERVE_SEED = 8, 16, 2, 0
SERVE_REPS = 3          # passes of the traffic at each depth, in turns
POISON_MAX_STEPS = 50


def _golden_stats(golden, key) -> dict:
    return {k: v for k, v in golden[key].items() if k != "mem_sha256"}


def _stats(info) -> dict:
    return {k: int(info[k]) for k in STAT_KEYS}


def _fresh_mems(b, k, rng):
    """k fresh memory images for bench ``b`` (same envelope, new data:
    inputs in [-100, 100)), as the serve and resilience benchmarks make
    them (their ``_bursty_mems`` and ``_fresh_mems``: one function under
    two names)."""
    n = b.gpu_mem.shape[0]
    return [np.concatenate([rng.integers(-100, 100,
                                         2 * b.gpu_n).astype(np.int32),
                            np.zeros(n - 2 * b.gpu_n, np.int32)])
            for _ in range(k)]


def serve_traffic(b):
    """The throughput traffic's images: SERVE_BURSTS bursts of SERVE_BURST
    seeded images of ``b``."""
    rng = np.random.default_rng(SERVE_SEED)
    return [_fresh_mems(b, SERVE_BURST, rng) for _ in range(SERVE_BURSTS)]


def async_parity(benches, golden, dev) -> dict:
    """run_kernel_async with an out_region slice and with (0, 0) on the
    8-CU benches; run_kernel_cohort_async with one uniform region (one
    slice of the chunk); run_kernel_batch_async with a slice, (0, 0) and
    a full image; a BlockPatch and an XorBlockPatch chain against the
    same chain staged through the host. Each launch against the golden
    file (stats; memory by sha256 where the full image is read)."""
    cfg8 = GGPUConfig(n_cus=8)
    for name in ASYNC_BENCHES:
        key = f"8cu/shared/{name}"
        prog, mem0, n, out, expected = launch(MAIN_RUNS_BY_KEY[key], benches)
        h = run_kernel_async(prog, mem0, n, cfg8, out_region=(out.start,
                                                              out.stop),
                             device=dev)
        mem, info = h.result()
        check(h.ready(), f"async {key}: not ready after resolution")
        check(np.array_equal(mem, expected) and _stats(info)
              == _golden_stats(golden, key), f"async {key}: region slice "
              f"or stats differ from the golden file")
        check(_sha(h.device_mem(0).cpu().numpy()) == golden[key]
              ["mem_sha256"], f"async {key}: final memory != golden")
        h0 = run_kernel_async(prog, mem0, n, cfg8, out_region=(0, 0),
                              device=dev)
        mem, info = h0.result()
        # (0, 0): no download, and no full image cached on the handle
        check(mem.shape == (0,) and h0._mem_full is None
              and _stats(info) == _golden_stats(golden, key),
              f"async {key}: out_region (0, 0)")
    lanes = [launch(r, benches) for r in COHORT_RUNS]
    out = lanes[0][3]
    hc = run_kernel_cohort_async(lanes[0][0], [x[1] for x in lanes],
                                 lanes[0][2], cfg8, device=dev,
                                 out_regions=[(out.start, out.stop)]
                                 * len(lanes))
    for i, (run, lane) in enumerate(zip(COHORT_RUNS, lanes)):
        check(np.array_equal(hc.mem(i), lane[4])
              and _stats(hc.info(i)) == _golden_stats(golden, run.key)
              and _sha(hc.device_mem(i).cpu().numpy())
              == golden[run.key]["mem_sha256"],
              f"async cohort {run.key} differs from the golden file")
    lanes = [launch(r, benches) for r in BATCH_RUNS]
    regions = [(lanes[0][3].start, lanes[0][3].stop), (0, 0), None]
    hb = run_kernel_batch_async([x[0] for x in lanes], [x[1] for x in lanes],
                                [x[2] for x in lanes], GGPUConfig(n_cus=4),
                                out_regions=regions, device=dev)
    for i, (run, lane) in enumerate(zip(BATCH_RUNS, lanes)):
        mem, info = hb.mem(i), hb.info(i)
        want = (lane[4] if i == 0 else np.zeros(0, np.int32) if i == 1
                else None)
        ok = (_sha(mem) == golden[run.key]["mem_sha256"] if want is None
              else np.array_equal(mem, want))
        check(ok and _stats(info) == _golden_stats(golden, run.key),
              f"async batch {run.key} (out_region {regions[i]}) differs")
    return patch_chain(benches, dev)


def patch_chain(benches, dev) -> dict:
    """Three 8-CU copy launches (the golden image and two seeded ones)
    feed a consumer cohort's input words from their output words by a
    BlockPatch of device_mem_block; a second consumer takes seeded bits
    XORed in by an XorBlockPatch (row 0 zero). Both equal the same chains
    staged through the host, and the producers' memory is unchanged after
    the consumers ran."""
    b, cfg8 = benches["copy"], GGPUConfig(n_cus=8)
    n, M = b.gpu_n, b.gpu_mem.shape[0]
    prods = [launch(Run("copy", "copy", "gpu", {}, seed=s), benches)[1]
             for s in (None, 1, 2)]
    cons = [np.zeros(M, np.int32) for _ in prods]
    flips = np.random.default_rng(3).integers(
        0, 2**31 - 1, (len(prods), n)).astype(np.int32)
    flips[0] = 0
    hp = run_kernel_cohort_async(b.gpu_prog, prods, b.gpu_items, cfg8,
                                 device=dev)
    before = hp.device_mem_block(0, M).clone()
    hc = run_kernel_cohort_async(
        b.gpu_prog, cons, b.gpu_items, cfg8, device=dev,
        patches=BlockPatch(0, n, hp.device_mem_block(n, 2 * n)))
    hx = run_kernel_cohort_async(
        b.gpu_prog, cons, b.gpu_items, cfg8, device=dev,
        patches=XorBlockPatch(0, n, torch.from_numpy(flips).to(dev)))
    got_c, got_x = hc.results(), hx.results()
    check(torch.equal(hp.device_mem_block(0, M), before),
          "patch chain: a consumer wrote into its producer's memory")
    staged = [c.copy() for c in cons]
    flipped = [c.copy() for c in cons]
    for k, (mem, _) in enumerate(hp.results()):
        staged[k][:n] = mem[n:2 * n]
        flipped[k][:n] ^= flips[k]
    for what, got, images in (("BlockPatch", got_c, staged),
                              ("XorBlockPatch", got_x, flipped)):
        want = run_kernel_cohort(b.gpu_prog, images, b.gpu_items, cfg8,
                                 device=dev)
        check([summary(*g) for g in got] == [summary(*w) for w in want],
              f"patch chain: {what} != the chain staged through the host")
    return {"launches": 3 * len(prods)}


def serve_drain(benches, golden, dev):
    """Every bench of DRAIN_BENCHES on 8 CUs twice, its golden image and
    a seeded variant, through one Scheduler drain with max_inflight 8. The
    originals download their full image, held against the golden file;
    the variants their output slice, audited against the checksum of the
    bench's numpy reference and held against it and against the golden
    file's stats (the JAX reference's run of the same variant)."""
    sched = Scheduler(GGPUConfig(n_cus=8), max_inflight=8, device=dev)
    expected = {}
    for name in DRAIN_BENCHES:
        key = f"8cu/shared/{name}"
        prog, mem0, n, out, _ = launch(MAIN_RUNS_BY_KEY[key], benches)
        sched.submit(prog, mem0, n, tag=key)
        run = VARIANTS[name]
        vprog, vmem, vn, vout, vexp = launch(run, benches)
        sched.submit_request(Request(vprog, vmem, vn, tag=run.key,
                                     out_region=(vout.start, vout.stop),
                                     audit=result_checksum(vexp)))
        expected[run.key] = vexp
    results = sched.drain()
    check(not sched.quarantined
          and len(results) == 2 * len(DRAIN_BENCHES),
          f"serve drain: {len(results)} results, quarantined "
          f"{ {t: str(q.error) for t, q in sched.quarantined.items()} }")
    for res in results:
        tag = res.info["tag"]
        if tag in expected:
            check(np.array_equal(res.mem, expected[tag]) and _stats(
                res.info) == _golden_stats(golden, tag),
                f"serve drain {tag}: != the numpy reference or golden")
        else:
            check(summary(res.mem, res.info) == golden[tag],
                  f"serve drain {tag}: != golden")
    st = sched.executor.stats
    return {"dispatches": st.dispatches, "launches": st.launches,
            "batch_occupancy": st.batch_occupancy}


def verify_serve(traffic_out, b, dev) -> None:
    """Every served launch of the throughput traffic equals its sync
    run."""
    cfg = GGPUConfig(n_cus=SERVE_CUS)
    images = [m for burst in serve_traffic(b) for m in burst]
    for i, mem0 in enumerate(images):
        want = summary(*run_kernel(b.gpu_prog, mem0, b.gpu_items, cfg,
                                   device=dev))
        check(summary(*traffic_out[i]) == want,
              f"serving traffic launch {i}: != sync run_kernel")


def serving_traffic(b, dev) -> tuple:
    """The throughput traffic drained burst by burst at max_inflight 1 and
    8, SERVE_REPS passes of each in turns (1, 8, 8, 1, ...), as the serve
    benchmark takes the best of its repetitions: launches/s of each pass,
    the best and the median, batch occupancy, the executor's hit rate.
    Every served output equals the bench's numpy reference, and every
    pass serves the same bits. Returns (per-depth rows, the results)."""
    traffic = serve_traffic(b)
    images = [m for burst in traffic for m in burst]
    want = [b.ref(m, b.gpu_n) for m in images]
    scheds = {depth: Scheduler(GGPUConfig(n_cus=SERVE_CUS),
                               max_batch=SERVE_MAX_BATCH, max_inflight=depth,
                               device=dev) for depth in (1, 8)}
    passes = {depth: [] for depth in scheds}
    first = None
    for rep in range(SERVE_REPS):
        for depth in (1, 8) if rep % 2 == 0 else (8, 1):
            sched, served = scheds[depth], []
            t0, rounds0 = time.perf_counter(), pe_simd.LAUNCHES
            for burst in traffic:
                for mem in burst:
                    sched.submit(b.gpu_prog, mem, b.gpu_items)
                served += sched.drain()
            wall = time.perf_counter() - t0
            passes[depth].append({
                "launches_per_s": len(served) / wall,
                **_rounds_line(wall, pe_simd.LAUNCHES - rounds0)})
            check(len(served) == len(images) and all(
                np.array_equal(r.mem[b.gpu_out], w)
                for r, w in zip(served, want)),
                f"serving traffic (max_inflight {depth}, pass {rep}): "
                "an output != the numpy reference")
            got = [summary(r.mem, r.info) for r in served]
            if first is None:
                first = ([(r.mem, r.info) for r in served], got)
            check(got == first[1], f"serving traffic (max_inflight "
                  f"{depth}, pass {rep}) served other bits than the first")
    rows = {}
    for depth, sched in scheds.items():
        rates = sorted(p["launches_per_s"] for p in passes[depth])
        rows[f"max_inflight_{depth}"] = {
            "launches_per_pass": len(images), "launches_per_s": rates[-1],
            "launches_per_s_median": rates[len(rates) // 2],
            "passes": passes[depth], **sched.executor.stats.report()}
    return rows, first[0]


def dep_and_poison(benches, golden, dev) -> dict:
    """A two-request Dep chain (a copy's output words feed a second
    copy's input words, device-resident) against the chain staged through
    the host; then one poisoned request (a spinner, max_steps 50)
    quarantined while the rest are served."""
    b, cfg8 = benches["copy"], GGPUConfig(n_cus=8)
    n = b.gpu_n
    sched = Scheduler(cfg8, device=dev)
    t0 = sched.submit(b.gpu_prog, b.gpu_mem, b.gpu_items,
                      out_region=(n, 2 * n))
    consumer = np.zeros_like(b.gpu_mem)
    t1 = sched.submit(b.gpu_prog, consumer, b.gpu_items,
                      deps=[Dep(t0, (0, n))])
    res = {r.info["ticket"]: r for r in sched.drain()}
    check(set(res) == {t0, t1} and not sched._resident,
          f"dep chain: served {sorted(res)}, resident {sched._resident}")
    host = consumer.copy()
    host[:n] = res[t0].mem
    check(summary(res[t1].mem, res[t1].info) == summary(*run_kernel(
        b.gpu_prog, host, b.gpu_items, cfg8, device=dev)),
        "dep chain != the chain staged through the host")
    spin = isa.Assembler()
    spin.label("spin").beq(0, 0, "spin")
    sched = Scheduler(GGPUConfig(n_cus=8, max_steps=POISON_MAX_STEPS),
                      device=dev)
    good = {}
    for name in ("copy", "div_int"):
        key = f"8cu/shared/{name}"
        prog, mem0, n_items, _, _ = launch(MAIN_RUNS_BY_KEY[key], benches)
        good[sched.submit(prog, mem0, n_items)] = key
    t_bad = sched.submit(spin.assemble(), np.zeros(8, np.int32), 8)
    served = sched.drain()
    check(set(sched.quarantined) == {t_bad}
          and "max_steps" in str(sched.quarantined[t_bad].error),
          f"poisoned request: quarantined {sorted(sched.quarantined)}")
    check(sorted(r.info["ticket"] for r in served) == sorted(good)
          and all(summary(r.mem, r.info) == golden[good[r.info["ticket"]]]
                  for r in served), "poisoned drain: survivors != golden")
    return {"dep_chain": "ok", "quarantined": [t_bad]}


def serve_path(benches, golden, dev) -> dict:
    """Kernel serving on the card (module doc, phase 5). Returns what
    ``verify_serve`` needs after the launch count is read."""
    steps = {}
    out, rounds, wall = _timed(async_parity, benches, golden, dev)
    steps["async_parity"] = _rounds_line(wall, rounds)
    stats, rounds, wall = _timed(serve_drain, benches, golden, dev)
    steps["drain"] = {**_rounds_line(wall, rounds), **stats,
                      "launches_per_s": 16 / wall}
    b = programs.build(SERVE_BENCH, *SERVE_SIZES)
    (rows, traffic_out), rounds, wall = _timed(serving_traffic, b, dev)
    steps["traffic"] = rows
    for stat in ("launches_per_s", "launches_per_s_median"):
        steps["traffic"][f"{stat}_8_over_1"] = (
            rows["max_inflight_8"][stat] / rows["max_inflight_1"][stat])
    poison, rounds, wall = _timed(dep_and_poison, benches, golden, dev)
    steps["dep_and_poison"] = {**_rounds_line(wall, rounds), **poison}
    emit({"serve_path": steps})
    return {"pending": (traffic_out, b), "steps": steps}


def busy_share(name, fn) -> dict:
    """Device busy share of ``fn``: the device kernels' time under
    torch.profiler over the wall time of the same call unprofiled."""
    before = pe_simd.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rounds = pe_simd.LAUNCHES - before
    kernels, _ = _profiled(fn)
    busy = _device_ms_of(kernels)
    return {"what": name, "rounds": rounds, "wall_ms": wall_ms,
            "wall_ms_per_round": wall_ms / rounds,
            "device_ms_per_round": busy / rounds,
            "device_busy_share": busy / wall_ms,
            "device_ops_per_round": len(kernels) / rounds}


def serve_profile(benches, dev) -> dict:
    """Busy share of the serving phase's two kinds of work: one burst of
    the throughput traffic (8 cohorts of 2 on 2 CUs), and the first 100
    rounds of the drain's largest chunk (xcorr, a cohort of 2 on 8 CUs;
    stopped by max_steps and never resolved)."""
    b = programs.build(SERVE_BENCH, *SERVE_SIZES)
    burst = serve_traffic(b)[0]

    def one_burst():
        sched = Scheduler(GGPUConfig(n_cus=SERVE_CUS),
                          max_batch=SERVE_MAX_BATCH, max_inflight=8,
                          device=dev)
        for mem in burst:
            sched.submit(b.gpu_prog, mem, b.gpu_items)
        sched.drain()
    x = benches["xcorr"]
    cfg = GGPUConfig(n_cus=8, max_steps=100)
    xcorr_rounds = lambda: run_kernel_cohort_async(  # noqa: E731
        x.gpu_prog, [x.gpu_mem, launch(VARIANTS["xcorr"], benches)[1]],
        x.gpu_items, cfg, device=dev)
    return {"traffic_burst": busy_share("traffic burst", one_burst),
            "drain_xcorr_cohort": busy_share("xcorr cohort of 2, 100 rounds",
                                             xcorr_rounds)}


# -- phase 6: the DSE sweep on the card --------------------------------------

def dse_path(dev) -> dict:
    """The CI smoke grid (check=True) against BENCH_dse.json's exact
    fields, then the nightly grid's full axes against golden_dse.json,
    both with the Evaluator's simulations on the card."""
    sizes = {DSE_BENCH: DSE_SIZES}
    out = {}
    t0, r0 = time.perf_counter(), pe_simd.LAUNCHES
    res = dse.search(specs=dse.enumerate_specs(**DSE_SMOKE),
                     evaluator=dse.Evaluator(benches=(DSE_BENCH,),
                                             sizes=sizes, check=True,
                                             device=dev))
    ref = min(res.frontier, key=lambda p: p.time_us)
    art = dse.dse_artifact(ref, res)
    bad = dse_artifact_mismatches(art, json.loads(BENCH_DSE.read_text()))
    check(not bad, f"DSE smoke grid != {BENCH_DSE.name}: {bad}")
    out["smoke"] = {**_rounds_line(time.perf_counter() - t0,
                                   pe_simd.LAUNCHES - r0),
                    "points": len(res.points), "frontier": art["frontier"],
                    "reference": art["reference"],
                    "cycles": art["benches"][DSE_BENCH]["cycles"]}
    golden = json.loads(GOLDEN_DSE.read_text())
    check(golden["spec"] == dse_spec(), f"{GOLDEN_DSE.name} was made for "
          f"{golden['spec']}, not {dse_spec()}: regenerate it")
    t0, r0 = time.perf_counter(), pe_simd.LAUNCHES
    ev = dse.Evaluator(benches=(DSE_BENCH,), sizes=sizes, device=dev)
    res = dse.search(specs=dse.enumerate_specs(**DSE_NIGHTLY), evaluator=ev)
    wall, rounds = time.perf_counter() - t0, pe_simd.LAUNCHES - r0
    mine = dse_summary(res)
    for got, want in zip(mine["points"], golden["points"]):
        check(got == want, f"DSE nightly point {want['label']}: {got} != "
              f"golden {want}")
    for key in ("points", "frontier", "analytic_frontier",
                "excluded_analytic"):
        check(mine[key] == golden[key] if key != "points"
              else len(mine[key]) == len(golden[key]),
              f"DSE nightly {key}: {mine[key]} != golden {golden[key]}")
    configs = {(p.point.config, dataclasses.replace(
        p.point.config, pipeline_depth=0)) for p in res.points}
    n_configs = len({sim_key(c) for pair in configs for c in pair})
    out["nightly"] = {**_rounds_line(wall, rounds), "specs": len(res.points),
                      "simulated_configs": n_configs,
                      "wall_s_per_config": wall / n_configs,
                      "frontier": mine["frontier"],
                      "excluded_analytic": mine["excluded_analytic"],
                      "cache_size": ev.cache_size()}
    emit({"dse_path": out})
    return out


def dse_profile(dev) -> dict:
    """Busy share of one DSE simulation: the first 100 rounds of xcorr
    (16, 128) on the 1-CU depth-1 config (stopped by max_steps, never
    resolved)."""
    x = programs.build(DSE_BENCH, *DSE_SIZES)
    cfg = GGPUConfig(n_cus=1, pipeline_depth=1, max_steps=100)
    return busy_share("DSE config, 100 rounds", lambda: run_kernel_async(
        x.gpu_prog, x.gpu_mem, x.gpu_items, cfg, device=dev))


# -- phase 7: the fleet, fault injection and the registry on the card --------

BENCH_SERVE = ROOT / "benchmarks" / "baselines" / "BENCH_serve.json"
BENCH_RESILIENCE = ROOT / "benchmarks" / "baselines" / "BENCH_resilience.json"
# The serve benchmark's fleet leg at its fast sizes: the two ends of the
# DSE frontier over 1 and 8 CUs at 667 MHz (xcorr (16, 128), memo hits
# after dse_path), and 3 x (copy(16, 1024), reduction(64, 256)) images.
FLEET_SPECS = {"cus": (1, 8), "freq_targets": (667.0,)}
FLEET_WIDE, FLEET_NARROW, FLEET_REPS, FLEET_SEED = (16, 1024), (64, 256), 3, 1
FLEET_EXACT = ("devices", "placement", "busy_us", "eta_us", "makespan_us",
               "pinned_us", "speedup_vs_best_pin", "beats_both_pins")
# The resilience benchmark's three legs at its --fast sizes: vec_mul(16,
# 128) on dev0 (1 CU) and dev1 (2 CUs), max_batch 8, plan seed 0, the
# image seeds 11 / 13 / 17 and the arrival seed 5.
RES_BENCH, RES_SIZES, RES_SEED, RES_MAX_BATCH = "vec_mul", (16, 128), 0, 8
RES_SEU_N, RES_SEU_REPS, RES_SEU_WARM = 24, 3, 2
RES_LOSS_N, RES_LOSS_TIMEOUT_S = 8, 0.2
RES_STRAGGLER_N, RES_STRAGGLER_DELAY_S, RES_STRAGGLER_HZ = 24, 0.25, 60.0
# the fields benchmarks/check_bench.py compares exactly, plus the fault
# and re-route counts and the health the JAX package gives the baseline
RES_EXACT = {
    "seu": ("n", "seed", "served", "served_correct", "quarantined",
            "silently_corrupted", "injections", "health"),
    "device_loss": ("n", "seed", "served", "lost", "quarantined", "evicted",
                    "bit_exact", "device_state", "faults", "reroutes"),
    "straggler": ("n",)}
# resilience_bench.invariant_problems' limits
MIN_SERVED_CORRECT, MIN_GOODPUT_RATIO = 0.999, 0.2


def fleet_leg(dev) -> tuple:
    """The serve benchmark's fleet leg (fast): route the mixed trace over
    the frontier's two ends, drain, price each pinned placement; every
    served output against the bench's numpy reference. Returns (report,
    devices, trace)."""
    res = dse.search(specs=dse.enumerate_specs(**FLEET_SPECS),
                     evaluator=dse.Evaluator(benches=(DSE_BENCH,),
                                             sizes={DSE_BENCH: DSE_SIZES},
                                             device=dev))
    frontier = sorted(res.frontier, key=lambda p: p.time_us)
    check(frontier[0] is not frontier[-1], "fleet: the DSE frontier "
          "collapsed to one design")
    devices = [(p.label(), p.point.config) for p in (frontier[0],
                                                     frontier[-1])]
    wide = programs.build("copy", *FLEET_WIDE)
    narrow = programs.build("reduction", *FLEET_NARROW)
    rng = np.random.default_rng(FLEET_SEED)
    trace, benches_of = [], []
    for _ in range(FLEET_REPS):
        for b in (wide, narrow):
            trace.append((b.gpu_prog, _fresh_mems(b, 1, rng)[0],
                          b.gpu_items))
            benches_of.append(b)
    fleet = Fleet(devices, device=dev)
    tickets = [fleet.submit(*t) for t in trace]
    t0 = time.perf_counter()
    out = fleet.drain()
    wall = time.perf_counter() - t0
    check([r.info["ticket"] for r in out] == tickets, "fleet: lost a launch")
    for res_, b, (_, mem0, _) in zip(out, benches_of, trace):
        check(np.array_equal(res_.mem[b.gpu_out], b.ref(mem0, b.gpu_n)),
              f"fleet: ticket {res_.info['ticket']} on "
              f"{res_.info['device']} != the numpy reference")
    rep = fleet.report()
    pinned = {name: round(pinned_makespan(cfg, trace, device=dev), 3)
              for name, cfg in devices}
    best = min(pinned.values())
    rep.update(pinned_us=pinned,
               speedup_vs_best_pin=round(best / rep["makespan_us"], 3),
               beats_both_pins=rep["makespan_us"] < best)
    base = json.loads(BENCH_SERVE.read_text())["fleet"]
    bad = {k: (rep[k], base[k]) for k in FLEET_EXACT if rep[k] != base[k]}
    check(not bad, f"fleet != {BENCH_SERVE.name}: {bad}")
    return {**rep, "drain_wall_s": wall}, devices, trace


def _res_devices():
    return [("dev0", GGPUConfig(n_cus=1)), ("dev1", GGPUConfig(n_cus=2))]


def _res_reference(sched, b, mems):
    """Fault-free oracle results for ``mems`` in submission order, each
    also against the bench's numpy reference."""
    tickets = [sched.submit(b.gpu_prog, m, b.gpu_items) for m in mems]
    by = {r.info["ticket"]: r for r in sched.flush()}
    refs = [by[t] for t in tickets]
    for r, m in zip(refs, mems):
        check(np.array_equal(r.mem[b.gpu_out], b.ref(m, b.gpu_n)),
              "resilience oracle != the numpy reference")
    return refs


def _serve_trace(fleet, b, mems, refs, audit):
    """Serve ``mems`` through ``fleet`` (audited when asked), timing the
    drain; (wall s, correctness accounting against ``refs``)."""
    tickets = [fleet.submit_request(Request(
        b.gpu_prog, m, b.gpu_items,
        audit=result_checksum(ref.mem) if audit else None))
        for m, ref in zip(mems, refs)]
    t0 = time.perf_counter()
    out = fleet.drain()
    wall = time.perf_counter() - t0
    by = {r.info["ticket"]: r for r in out}
    correct = sum(1 for t, ref in zip(tickets, refs) if t in by
                  and np.array_equal(by[t].mem, ref.mem))
    return {"wall_s": wall, "served": len(out), "served_correct": correct,
            "silently_corrupted": len(out) - correct,
            "quarantined": len(fleet.quarantined)}


def res_seu(b, dev) -> dict:
    """SEU chaos against its fault-free control (the same resilience
    machinery under an inactive plan) over identical traces: goodput is
    the best of RES_SEU_REPS passes after RES_SEU_WARM warm ones."""
    rng = np.random.default_rng(11)
    oracle = Scheduler(GGPUConfig(n_cus=2), max_batch=RES_MAX_BATCH,
                       device=dev)

    def run(scenario):
        fleet = Fleet(_res_devices(), max_batch=RES_MAX_BATCH, device=dev,
                      **scenario.fleet_kwargs())
        for _ in range(RES_SEU_WARM):
            mems = _fresh_mems(b, RES_SEU_N, rng)
            _serve_trace(fleet, b, mems, _res_reference(oracle, b, mems),
                         scenario.audit)
        total = {"served": 0, "served_correct": 0, "silently_corrupted": 0,
                 "goodput_per_s": 0.0}
        for _ in range(RES_SEU_REPS):
            mems = _fresh_mems(b, RES_SEU_N, rng)
            stats = _serve_trace(fleet, b, mems,
                                 _res_reference(oracle, b, mems),
                                 scenario.audit)
            total["goodput_per_s"] = max(total["goodput_per_s"],
                                         RES_SEU_N / stats.pop("wall_s"))
            for key in ("served", "served_correct", "silently_corrupted"):
                total[key] += stats[key]
        total["quarantined"] = len(fleet.quarantined)
        return fleet, total

    control = FAULTS.get("seu")(seed=RES_SEED)
    control.plan = FaultPlan(seed=RES_SEED)
    _, clean = run(control)
    chaos_sc = FAULTS.get("seu")(seed=RES_SEED)
    fleet, chaos = run(chaos_sc)
    offered = RES_SEU_REPS * RES_SEU_N
    return {"kernel": b.name, "n": offered, "seed": RES_SEED,
            "injections": len(chaos_sc.decision_log()),
            "served": chaos["served"],
            "served_correct": chaos["served_correct"],
            "served_correct_fraction": round(
                chaos["served_correct"] / offered, 6),
            "silently_corrupted": chaos["silently_corrupted"],
            "quarantined": chaos["quarantined"],
            "clean_goodput_per_s": round(clean["goodput_per_s"], 2),
            "chaos_goodput_per_s": round(chaos["goodput_per_s"], 2),
            "goodput_ratio": round(chaos["goodput_per_s"]
                                   / clean["goodput_per_s"], 3),
            "health": fleet.report()["health"]}


def res_device_loss(b, dev) -> dict:
    """dev0 wedges from its first dispatch: the executor timeout surfaces
    it, retries exhaust, the fleet evicts it and re-routes its backlog;
    every result bit-exact with the fault-free oracle."""
    rng = np.random.default_rng(13)
    mems = _fresh_mems(b, RES_LOSS_N, rng)
    refs = _res_reference(Scheduler(GGPUConfig(n_cus=2),
                                    max_batch=RES_MAX_BATCH, device=dev),
                          b, mems)
    sc = FAULTS.get("device-loss")(seed=RES_SEED, stuck_after=0,
                                   timeout_s=RES_LOSS_TIMEOUT_S)
    fleet = Fleet(_res_devices(), max_batch=RES_MAX_BATCH, device=dev,
                  **sc.fleet_kwargs())
    t0 = time.perf_counter()
    stats = _serve_trace(fleet, b, mems, refs, sc.audit)
    wall = time.perf_counter() - t0
    rep = fleet.report()
    return {"kernel": b.name, "n": RES_LOSS_N, "seed": RES_SEED,
            "timeout_s": RES_LOSS_TIMEOUT_S, "served": stats["served"],
            "bit_exact": stats["served_correct"] == stats["served"],
            "lost": RES_LOSS_N - stats["served"] - stats["quarantined"],
            "quarantined": stats["quarantined"],
            "evicted": rep["device_state"]["dev0"] == "evicted",
            "device_state": rep["device_state"],
            "reroutes": rep["reroutes"], "faults": rep["faults"],
            "wall_s": wall, "decision_log": len(sc.decision_log())}


def res_straggler(b, dev) -> dict:
    """One open-loop Poisson trace replayed under identical straggler
    injection, hedged and unhedged (after warming every cohort size)."""
    rng = np.random.default_rng(17)
    mems = _fresh_mems(b, 16, rng)
    arrivals = poisson_arrivals(RES_STRAGGLER_HZ, RES_STRAGGLER_N, seed=5)

    def run(scenario):
        fleet = Fleet(_res_devices(), max_batch=RES_MAX_BATCH, device=dev,
                      **scenario.fleet_kwargs())
        k = 8
        while k >= 1:
            for m in _fresh_mems(b, k, rng):
                fleet.submit_request(Request(b.gpu_prog, m, b.gpu_items))
            fleet.drain()
            k //= 2
        res = replay(fleet, arrivals,
                     lambda i: Request(b.gpu_prog, mems[i % len(mems)],
                                       b.gpu_items))
        return fleet, res

    hedged_sc = FAULTS.get("straggler")(seed=RES_SEED,
                                        delay_s=RES_STRAGGLER_DELAY_S)
    unhedged_sc = FAULTS.get("straggler")(seed=RES_SEED,
                                          delay_s=RES_STRAGGLER_DELAY_S)
    unhedged_sc.resilience = FleetResilience()   # same machinery, no hedge
    hedged_fleet, hedged = run(hedged_sc)
    _, unhedged = run(unhedged_sc)
    return {"kernel": b.name, "n": RES_STRAGGLER_N, "seed": RES_SEED,
            "arrivals": "poisson",
            "straggler_delay_s": RES_STRAGGLER_DELAY_S,
            "hedges_fired": hedged_fleet.report()["hedged"],
            "hedged": hedged.report(), "unhedged": unhedged.report(),
            "hedge_p99_speedup": round(unhedged.p99_ms / hedged.p99_ms, 3)
            if hedged.p99_ms else 0.0}


def resilience_problems(art: dict) -> list:
    """resilience_bench.invariant_problems' invariants."""
    s, d, st = art["seu"], art["device_loss"], art["straggler"]
    bad = []
    if s["served_correct_fraction"] < MIN_SERVED_CORRECT:
        bad.append(f"seu.served_correct_fraction "
                   f"{s['served_correct_fraction']}")
    if s["silently_corrupted"]:
        bad.append(f"seu.silently_corrupted {s['silently_corrupted']}")
    if s["goodput_ratio"] < MIN_GOODPUT_RATIO:
        bad.append(f"seu.goodput_ratio {s['goodput_ratio']}")
    if not d["evicted"]:
        bad.append("device_loss: dev0 was never evicted")
    if d["lost"]:
        bad.append(f"device_loss.lost {d['lost']}")
    if not d["bit_exact"]:
        bad.append("device_loss.bit_exact is false")
    if not st["hedged"]["p99_ms"] < st["unhedged"]["p99_ms"]:
        bad.append(f"straggler: hedged p99 {st['hedged']['p99_ms']} ms is "
                   f"not below unhedged {st['unhedged']['p99_ms']} ms")
    if not st["hedges_fired"]:
        bad.append("straggler: no hedge fired")
    for leg in ("hedged", "unhedged"):
        if st[leg]["served"] != st["n"]:
            bad.append(f"straggler.{leg}: served {st[leg]['served']} of "
                       f"{st['n']}")
    return bad


def resilience_legs(dev) -> dict:
    """The resilience benchmark's three legs (fast): the exact fields
    against BENCH_resilience.json, and its invariants."""
    b = programs.build(RES_BENCH, *RES_SIZES)
    art, walls = {}, {}
    for leg, fn in (("seu", res_seu), ("device_loss", res_device_loss),
                    ("straggler", res_straggler)):
        t0 = time.perf_counter()
        art[leg] = fn(b, dev)
        walls[leg] = time.perf_counter() - t0
    base = json.loads(BENCH_RESILIENCE.read_text())
    bad = {f"{leg}.{k}": (art[leg][k], base[leg][k])
           for leg, keys in RES_EXACT.items() for k in keys
           if art[leg][k] != base[leg][k]}
    check(not bad, f"resilience != {BENCH_RESILIENCE.name}: {bad}")
    bad = resilience_problems(art)
    check(not bad, f"resilience invariants: {bad}")
    # wall-clock numbers beside the baseline's, which were taken on a CPU
    # host by the JAX package: printed, not gated
    cpu = {"seu": {k: base["seu"][k] for k in (
        "clean_goodput_per_s", "chaos_goodput_per_s", "goodput_ratio")},
        "straggler": {"hedges_fired": base["straggler"]["hedges_fired"],
                      **{f"{leg}_{k}": base["straggler"][leg][k]
                         for leg in ("hedged", "unhedged")
                         for k in ("p50_ms", "p99_ms")}}}
    return {**art, "leg_wall_s": walls, "baseline_cpu_host": cpu}


def registry_leg(dev) -> dict:
    """selfcheck and smoke_all on the card with no problem (the
    cross-product cell is cut: REDUCED)."""
    out = {}
    for name, fn in (("selfcheck", registry_smoke.selfcheck),
                     ("smoke_all", lambda emit: registry_smoke.smoke_all(
                         emit, device=dev))):
        lines = []
        t0, r0 = time.perf_counter(), pe_simd.LAUNCHES
        bad = fn(lines.append)
        check(not bad, f"registry {name}: {bad}")
        out[name] = {**_rounds_line(time.perf_counter() - t0,
                                    pe_simd.LAUNCHES - r0),
                     "lines": lines}
    return out


def fleet_path(dev) -> dict:
    """The fleet, fault and registry layers on the card (module doc,
    phase 7). Returns the fleet leg's devices and trace (for
    fleet_profile) and the phase's steps."""
    steps = {}
    (fleet, devices, trace), rounds, wall = _timed(fleet_leg, dev)
    steps["fleet"] = {**_rounds_line(wall, rounds), **fleet}
    res, rounds, wall = _timed(resilience_legs, dev)
    steps["resilience"] = {**_rounds_line(wall, rounds), **res}
    reg, rounds, wall = _timed(registry_leg, dev)
    steps["registry"] = {**_rounds_line(wall, rounds), **reg}
    emit({"fleet_path": steps})
    return {"devices": devices, "trace": trace, "steps": steps}


def fleet_profile(dev, devices, trace) -> dict:
    """Busy share of one drain of the fleet leg's trace on a fresh
    Fleet."""
    def drain():
        fleet = Fleet(devices, device=dev)
        for t in trace:
            fleet.submit(*t)
        fleet.drain()
    return busy_share("fleet drain", drain)


# -- phase 8: the compiler, its autotuner and kernel graphs on the card -----

BENCH_COMPILER = ROOT / "benchmarks" / "baselines" / "BENCH_compiler.json"
# The compiler benchmark at its --fast sizes on GGPUConfig(n_cus=2): suite
# parity, the autotune of copy and vec_mul over SMOKE_SPACE, the co-design
# over 1 and 2 CUs at 500 and 667 MHz, and a DSE over compiled workloads
# (two suite kernels and user_segred (512, 32), a bench with seed 11).
COMPILER_SIZES, COMPILER_SPECS = suite.FAST_SIZES, suite.FAST_SPECS
COMPILER_CUS, COMPILER_TUNE = 2, ("copy", "vec_mul")
COMPILER_SAMPLE, USER_SEGRED, USER_SEED = ("vec_mul", "reduction"), \
    (512, 32), 11
SUITE_EXACT = ("cycles_hand", "cycles_dsl", "cycle_ratio", "bit_exact",
               "prog_len")
TUNE_EXACT = ("best_schedule", "default_cycles", "tuned_cycles",
              "tuned_vs_default", "n_candidates", "cycles_hand",
              "tuned_vs_hand", "verified")
# The serve benchmark's graph section (fast): map -> segmented reduce ->
# scale, n 256, seg 64, 8 instances from rng 7, 2 CUs, three passes of
# each way; its speedup limit (benchmarks/serve_bench.py
# GRAPH_MIN_SPEEDUP).
GRAPH_N, GRAPH_SEG, GRAPH_INST, GRAPH_SEED, GRAPH_REPS = 256, 64, 8, 7, 3
GRAPH_MIN_SPEEDUP = 1.5


def compiler_suite(dev, base) -> tuple:
    """The eight compiled benches and their hand twins through run_kernel
    on the card: cycles, bit-exactness and program length against the
    baseline's suite_parity, each output against the numpy reference.
    Returns (rows, the compiled benches)."""
    hands = compiler.hand_benches(COMPILER_SIZES)
    compiled = compiler.dsl_benches(COMPILER_SIZES, hands=hands)
    cfg = GGPUConfig(n_cus=COMPILER_CUS)
    rows = {}
    for name in sorted(compiled):
        base_name = name[len("dsl_"):]
        hand, d = hands[base_name], compiled[name]
        mh, ih = run_kernel(hand.gpu_prog, hand.gpu_mem, hand.gpu_items,
                            cfg, device=dev)
        md, idd = run_kernel(d.gpu_prog, d.gpu_mem, d.gpu_items, cfg,
                             device=dev)
        want = hand.ref(hand.gpu_mem, hand.gpu_n)
        check(np.array_equal(md[d.gpu_out], want),
              f"compiled {base_name} != the numpy reference")
        exact = bool(np.array_equal(mh[hand.gpu_out], md[d.gpu_out]))
        rows[base_name] = {
            "cycles_hand": ih["cycles"], "cycles_dsl": idd["cycles"],
            "cycle_ratio": round(idd["cycles"] / ih["cycles"], 3),
            "bit_exact": exact, "prog_len": int(d.gpu_prog.shape[0])}
    bad = {f"{n}.{k}": (rows[n][k], row[k]) for n, row in base.items()
           for k in SUITE_EXACT if rows.get(n, {}).get(k) != row[k]}
    check(sorted(rows) == sorted(base) and not bad,
          f"compiler suite_parity != {BENCH_COMPILER.name}: {bad}")
    return rows, compiled


def compiler_autotune(dev, base) -> dict:
    """autotune_suite of copy and vec_mul over SMOKE_SPACE on the card,
    every candidate verified (check=True) against the default kernel's
    oracle: picks, cycles and candidate rows against the baseline."""
    cfg = GGPUConfig(n_cus=COMPILER_CUS)
    results = compiler.autotune_suite(COMPILER_TUNE, cfg,
                                      sizes=COMPILER_SIZES,
                                      space=compiler.SMOKE_SPACE,
                                      device=dev)
    hands = compiler.hand_benches(COMPILER_SIZES)
    out = {}
    for name, r in results.items():
        h = hands[name]
        _, ih = run_kernel(h.gpu_prog, h.gpu_mem, h.gpu_items, cfg,
                           device=dev)
        row = r.report()
        row.update(verified=all(c.verified for c in r.candidates),
                   cycles_hand=int(ih["cycles"]),
                   tuned_vs_hand=round(r.best_cycles / ih["cycles"], 4))
        want = base["benches"][name]
        bad = {k: (row[k], want[k]) for k in TUNE_EXACT
               if row[k] != want[k]}
        rows = [{k: c[k] for k in ("schedule", "cycles", "prog_len",
                                   "verified", "best")}
                for c in row["candidates"]]
        check(not bad and rows == [{k: c[k] for k in rows[0]}
                                   for c in want["candidates"]],
              f"compiler autotune {name} != {BENCH_COMPILER.name}: {bad}")
        out[name] = {k: row[k] for k in TUNE_EXACT}
    return out


def compiler_codesign(dev, base) -> dict:
    """codesign of copy and vec_mul over SMOKE_SPACE x the 4 specs: the
    schedules, the population and the joint frontier's (label,
    schedule) pairs with their times and areas against the baseline."""
    hands = compiler.hand_benches(COMPILER_SIZES)
    defs = {n: compiler.kernel_def(n, *compiler.def_args(n, hands[n]))
            for n in COMPILER_TUNE}
    res = compiler.codesign(defs, dse.enumerate_specs(**COMPILER_SPECS),
                            space=compiler.SMOKE_SPACE, device=dev)
    frontier = sorted(({"label": jp.label(), "schedule": jp.variant,
                        "time_us": round(jp.point.time_us, 3),
                        "area_mm2": round(jp.point.area_mm2, 2)}
                       for jp in res.frontier), key=lambda r: r["label"])
    got = {"workloads": sorted(defs), "schedules": sorted(res.results),
           "n_points": sum(len(r.points) for r in res.results.values()),
           "frontier": frontier}
    bad = {k: (v, base[k]) for k, v in got.items() if v != base[k]}
    check(not bad, f"compiler codesign != {BENCH_COMPILER.name}: {bad}")
    return got


def compiler_dse(dev, compiled, base) -> tuple:
    """dse.search over compiled workloads (check=True: each against its
    own reference) on the card: the nested artifact's exact fields
    against the baseline's. Returns (summary, the search result)."""
    workloads = {n: b for n, b in compiled.items()
                 if n[len("dsl_"):] in COMPILER_SAMPLE}
    user = compiler.compile_kernel(lambda a, b: ((a - b) * a).seg_sum(
        USER_SEGRED[1]), dict(a=USER_SEGRED[0], b=USER_SEGRED[0]),
        name="user_segred")
    workloads["dsl_user_segred"] = user.as_bench(seed=USER_SEED)
    ev = dse.Evaluator(benches=(), workloads=workloads, check=True,
                       device=dev)
    res = dse.search(specs=dse.enumerate_specs(**COMPILER_SPECS),
                     evaluator=ev)
    ref = min(res.frontier, key=lambda p: p.time_us)
    art = dse.dse_artifact(ref, res)
    art["workloads"] = sorted(workloads)
    bad = dse_artifact_mismatches(art, base)
    if art["workloads"] != base["workloads"]:
        bad.append(f"workloads {art['workloads']} != {base['workloads']}")
    check(not bad, f"compiler dse != {BENCH_COMPILER.name}: {bad}")
    return {"cycles": {n: row["cycles"] for n, row in art["benches"].items()},
            "frontier": art["frontier"],
            "analytic_frontier": art["analytic_frontier"]}, res


def _graph_program():
    return compiler.compile_graph(
        lambda a, b: (a * b).seg_sum(GRAPH_SEG) * 3 + 1,
        {"a": GRAPH_N, "b": GRAPH_N}, name="map_reduce_scale")


def compiler_graph(dev, base) -> dict:
    """The serve benchmark's graph section (fast) on the card: pipelined
    (stage-major, device-resident), host-staged per chain and host-folded,
    best of three passes each after a warm pass; every output against
    Program.reference, bit_exact, stages and the pipelined dispatches
    against the baseline, the speedup over the host-staged way at least
    GRAPH_MIN_SPEEDUP."""
    program = _graph_program()
    rng = np.random.default_rng(GRAPH_SEED)

    def instances():
        return [{"a": rng.integers(-100, 100, GRAPH_N).astype(np.int32),
                 "b": rng.integers(-100, 100, GRAPH_N).astype(np.int32)}
                for _ in range(GRAPH_INST)]
    cfg = GGPUConfig(n_cus=COMPILER_CUS)
    pipe, staged, folded = (Scheduler(cfg, max_batch=GRAPH_INST,
                                      max_inflight=8, device=dev)
                            for _ in range(3))
    submit_programs(pipe, program, instances())
    pipe.drain()
    run_chains_host_staged(staged, program, instances())
    run_programs_host_staged(folded, program, instances())
    best = {"pipelined": math.inf, "host_staged": math.inf,
            "host_folded": math.inf}
    dispatches = 0
    for _ in range(GRAPH_REPS):
        ins = instances()
        d0 = pipe.executor.stats.dispatches
        t0 = time.perf_counter()
        handles = submit_programs(pipe, program, ins)
        outs = extract_outputs(pipe.drain(), handles)
        best["pipelined"] = min(best["pipelined"], time.perf_counter() - t0)
        dispatches = pipe.executor.stats.dispatches - d0
        t0 = time.perf_counter()
        staged_outs = run_chains_host_staged(staged, program, ins)
        best["host_staged"] = min(best["host_staged"],
                                  time.perf_counter() - t0)
        t0 = time.perf_counter()
        folded_outs = run_programs_host_staged(folded, program, ins)
        best["host_folded"] = min(best["host_folded"],
                                  time.perf_counter() - t0)
        for o, s_, f, i in zip(outs, staged_outs, folded_outs, ins):
            ref = program.reference(i)
            check(o is not None and np.array_equal(o, ref)
                  and np.array_equal(s_, ref) and np.array_equal(f, ref),
                  "graph: an output != Program.reference")
    row = {"stages": [ck.name for ck in program.stages], "bit_exact": True,
           "instances": GRAPH_INST, "launches": 3 * GRAPH_INST,
           **{way: {"wall_s": t, "chains_per_sec": GRAPH_INST / t}
              for way, t in best.items()},
           "speedup": best["host_staged"] / best["pipelined"],
           "folded_speedup": best["host_folded"] / best["pipelined"]}
    row["pipelined"]["dispatches"] = dispatches
    got = {"bit_exact": row["bit_exact"], "stages": row["stages"],
           "pipelined.dispatches": dispatches}
    want = {"bit_exact": base["bit_exact"], "stages": base["stages"],
            "pipelined.dispatches": base["pipelined"]["dispatches"]}
    bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    check(not bad, f"graph != {BENCH_SERVE.name}: {bad}")
    check(row["speedup"] >= GRAPH_MIN_SPEEDUP,
          f"graph speedup {row['speedup']:.3f} < {GRAPH_MIN_SPEEDUP}")
    return row


def compiler_graph_fleet(dev, frontier) -> dict:
    """One graph instance through a Fleet of the compiled-workload DSE
    frontier's two ends: its output against Program.reference, every
    stage of the chain on one device."""
    ends = sorted(frontier, key=lambda p: p.time_us)
    check(ends[0] is not ends[-1], "graph fleet: the frontier collapsed")
    devices = [(p.label(), p.point.config) for p in (ends[0], ends[-1])]
    program = _graph_program()
    ins = program.random_inputs(seed=GRAPH_SEED)
    fleet = Fleet(devices, device=dev)
    out = run_program(fleet, program, ins)
    check(np.array_equal(out, program.reference(ins)),
          "graph fleet: output != Program.reference")
    placed = sorted(set(fleet.placement.values()))
    check(len(placed) == 1, f"graph fleet: one chain's stages on {placed}")
    return {"devices": [n for n, _ in devices], "placed_on": placed[0],
            "learned": len(fleet._learned)}


def compiler_path(dev) -> dict:
    """The compiler benchmark's fast sections and the serve benchmark's
    graph section through the port on the card (module doc, phase 8)."""
    base = json.loads(BENCH_COMPILER.read_text())
    steps = {}
    (rows, compiled), rounds, wall = _timed(compiler_suite, dev,
                                            base["suite_parity"])
    steps["suite_parity"] = {**_rounds_line(wall, rounds), "benches": rows}
    tune, rounds, wall = _timed(compiler_autotune, dev, base["autotune"])
    steps["autotune"] = {**_rounds_line(wall, rounds), "benches": tune}
    co, rounds, wall = _timed(compiler_codesign, dev, base["codesign"])
    steps["codesign"] = {**_rounds_line(wall, rounds), **co}
    (dse_row, res), rounds, wall = _timed(compiler_dse, dev, compiled,
                                          base["dse"])
    steps["dse"] = {**_rounds_line(wall, rounds), **dse_row}
    graph, rounds, wall = _timed(
        compiler_graph, dev, json.loads(BENCH_SERVE.read_text())["graph"])
    steps["graph"] = {**_rounds_line(wall, rounds), **graph}
    gf, rounds, wall = _timed(compiler_graph_fleet, dev, res.frontier)
    steps["graph_fleet"] = {**_rounds_line(wall, rounds), **gf}
    emit({"compiler_path": steps})
    return steps


def compiler_profile(dev) -> dict:
    """Busy share of one autotune drain: vec_mul (64, 512) over
    SMOKE_SPACE on 2 CUs, on fresh seeded inputs each call (so nothing
    is a memo hit)."""
    fn, shapes = compiler.kernel_def("vec_mul", COMPILER_SIZES["vec_mul"][1])
    seeds = iter(range(1000, 1010))
    return busy_share("autotune drain, vec_mul over SMOKE_SPACE",
                      lambda: compiler.autotune(
                          fn, shapes, GGPUConfig(n_cus=COMPILER_CUS),
                          space=compiler.SMOKE_SPACE, name="vec_mul",
                          seed=next(seeds), device=dev))


# -- phase 8b: the mesh and legacy launch modes on the card -----------------

# the launch axis split 8 ways over one card: LaunchMesh([card] * 8) runs
# eight machines, one a shard, one after the other on the card's stream
MESH_ENTRIES = 8
MESH_BATCH = ("copy", "vec_mul", "div_int", "fir")
# the fleet leg's two configs (tests/test_fleet_sharded.py's) and trace
MESH_FLEET = (("fast", {"n_cus": 1, "freq_mhz": 800.0}),
              ("wide", {"n_cus": 8, "freq_mhz": 500.0}))
MESH_FLEET_TRACE = (("copy", (16, 1024)), ("reduction", (64, 256)))
MESH_SERVE_MAX_BATCH = 4
# the legacy stepper (fuse 1, one host check a round) at Table III size
LEGACY_RUNS = tuple(MAIN_RUNS_BY_KEY[f"8cu/shared/{n}"] for n in (
    "copy", "div_int", "vec_mul", "fir", "reduction")) + (
        MAIN_RUNS_BY_KEY["1cu/shared/fir"],)


def mesh_cohort(benches, golden, mesh) -> dict:
    """(a) run_kernel_cohort_async over the mesh: the eight seeded fir
    images (one a shard), then twelve (the golden image, its variant and
    seeds 0-9: cohort_rows(12, 8) = 16 rows, four of them padding), each
    launch against the golden file and the numpy reference."""
    cfg8, rows = GGPUConfig(n_cus=8), []
    fir = (MAIN_RUNS_BY_KEY["8cu/shared/fir"], VARIANTS["fir"])
    for runs in (COHORT_RUNS, fir + COHORT_RUNS + MESH_RUNS):
        lanes = [launch(r, benches) for r in runs]
        h = run_kernel_cohort_async(lanes[0][0], [x[1] for x in lanes],
                                    lanes[0][2], cfg8, mesh=mesh)
        padded = cohort_rows(len(runs), mesh.size)
        check(len(h) == len(runs) and len(h.staged) == mesh.size
              and h._b_local * mesh.size == padded,
              f"mesh cohort of {len(runs)}: {len(h)} launches, "
              f"{h._b_local} rows a shard")
        for run, lane, (mem, info) in zip(runs, lanes, h.results()):
            _check_run(run, mem, info, lane[4], lane[3], golden)
        rows.append({"launches": len(runs), "rows": padded})
    return {"cohorts": rows}


def mesh_batch(benches, golden, mesh) -> dict:
    """(b) run_kernel_batch over the mesh: copy, vec_mul, div_int and fir,
    golden and variant, and fir seeds 0 and 1: ten launches padded with
    six 1-item HALT fillers to 16 rows; each against the golden file."""
    runs = ([MAIN_RUNS_BY_KEY[f"8cu/shared/{n}"] for n in MESH_BATCH]
            + [VARIANTS[n] for n in MESH_BATCH] + list(COHORT_RUNS[:2]))
    lanes = [launch(r, benches) for r in runs]
    results = run_kernel_batch([x[0] for x in lanes], [x[1] for x in lanes],
                               [x[2] for x in lanes], GGPUConfig(n_cus=8),
                               mesh=mesh)
    check(len(results) == len(runs), f"mesh batch: {len(results)} results")
    for run, lane, (mem, info) in zip(runs, lanes, results):
        _check_run(run, mem, info, lane[4], lane[3], golden)
    return {"launches": len(runs), "fillers": -len(runs) % mesh.size}


def mesh_patch_chain(benches, mesh, dev) -> dict:
    """(c) eight 8-CU copy producers, one a shard, feed consumers over the
    same mesh: shard 0's output into the launch on shard 7 (a per-launch
    patch), every row into its consumer (a BlockPatch of
    device_mem_block), seeded bits XORed in (an XorBlockPatch); each
    equal to the same chain unsharded on the card, and the producers'
    memory unchanged."""
    b, cfg8 = benches["copy"], GGPUConfig(n_cus=8)
    n, M, k = b.gpu_n, b.gpu_mem.shape[0], mesh.size
    prods = [launch(Run("copy", "copy", "gpu", {}, seed=s), benches)[1]
             for s in range(k)]
    cons = [np.zeros(M, np.int32) for _ in prods]
    flips = torch.from_numpy(np.random.default_rng(3).integers(
        0, 2**31 - 1, (k, n)).astype(np.int32)).to(dev)
    chains = {}
    for what, where in (("sharded", {"mesh": mesh}), ("unsharded",
                                                      {"device": dev})):
        hp = run_kernel_cohort_async(b.gpu_prog, prods, b.gpu_items, cfg8,
                                     **where)
        before = hp.device_mem_block(0, M).clone()
        per = [None] * (k - 1) + [[(0, n, hp.device_mem(0, (n, 2 * n)))]]
        outs = []
        for patches in (per, BlockPatch(0, n, hp.device_mem_block(n, 2 * n)),
                        XorBlockPatch(0, n, flips)):
            h = run_kernel_cohort_async(b.gpu_prog, cons, b.gpu_items, cfg8,
                                        patches=patches, **where)
            outs.append([summary(*r) for r in h.results()])
        check(torch.equal(hp.device_mem_block(0, M), before),
              f"mesh patch chain ({what}): a consumer wrote its producer")
        chains[what] = outs
    check(chains["sharded"] == chains["unsharded"],
          "mesh patch chain: sharded != unsharded on the card")
    return {"launches": 4 * k, "patch_forms": 3}


def _serve_pass(sched, b, traffic) -> tuple:
    """One pass of the traffic, burst by burst: (results, launches/s)."""
    served, t0 = [], time.perf_counter()
    for burst in traffic:
        for mem in burst:
            sched.submit(b.gpu_prog, mem, b.gpu_items)
        served += sched.drain()
    return served, len(served) / (time.perf_counter() - t0)


def mesh_serving(mesh, dev) -> dict:
    """(d) the serving phase's traffic (vec_mul(32, 512) on 2 CUs, 8
    bursts of 16) through Scheduler(max_batch=4, mesh=8 entries) against
    the unsharded Scheduler on the card, and (f) through
    Scheduler(mesh=make_launch_mesh()), whose extent is the card count
    (1: the unsharded path); launches/s of each (a reading: on one card
    the shards take turns)."""
    b = programs.build(SERVE_BENCH, *SERVE_SIZES)
    traffic = serve_traffic(b)
    cfg = GGPUConfig(n_cus=SERVE_CUS)
    machine = make_launch_mesh()
    check(machine.size == torch.cuda.device_count(),
          f"make_launch_mesh: extent {machine.size}")
    scheds = {"unsharded": Scheduler(cfg, max_batch=MESH_SERVE_MAX_BATCH,
                                     device=dev),
              "sharded": Scheduler(cfg, max_batch=MESH_SERVE_MAX_BATCH,
                                   mesh=mesh),
              "make_launch_mesh": Scheduler(
                  cfg, max_batch=MESH_SERVE_MAX_BATCH, mesh=machine)}
    check(scheds["sharded"].plan_batch == MESH_SERVE_MAX_BATCH * mesh.size
          and scheds["make_launch_mesh"].executor.shards == machine.size,
          "mesh serving: plan widths")
    out, want = {}, None
    for name, sched in scheds.items():
        served, rate = _serve_pass(sched, b, traffic)
        got = [summary(r.mem, r.info) for r in served]
        want = got if want is None else want
        check(len(served) == SERVE_BURSTS * SERVE_BURST and got == want,
              f"mesh serving ({name}) != the unsharded Scheduler")
        out[name] = {"launches_per_s": rate, "shards":
                     sched.executor.shards,
                     **sched.executor.stats.report()}
    out["sharded_over_unsharded"] = (out["sharded"]["launches_per_s"]
                                     / out["unsharded"]["launches_per_s"])
    return out


def mesh_fleet(mesh, dev) -> dict:
    """(e) Fleet([fast, wide], mesh=8 entries), sliced 4 + 4, on a mixed
    trace (copy(16, 1024) and reduction(64, 256), three seeded images
    each): every result equal to a direct run on the card and to the
    numpy reference; utilisation, queue depth and shards hold."""
    cfgs = {name: GGPUConfig(**c) for name, c in MESH_FLEET}
    fleet = Fleet(list(cfgs.items()), max_batch=4, mesh=mesh)
    check([d.mesh.size for d in fleet.devices] == [4, 4],
          "mesh fleet: slices != 4 + 4")
    rng = np.random.default_rng(1)
    trace = {}
    for _ in range(3):
        for name, sizes in MESH_FLEET_TRACE:
            b = programs.build(name, *sizes)
            mem = _fresh_mems(b, 1, rng)[0]
            trace[fleet.submit(b.gpu_prog, mem, b.gpu_items)] = (b, mem)
    depth = fleet.report()["queue_depth"]
    out = fleet.drain()
    rep = fleet.report()
    util = rep["utilization"]
    check(sum(depth.values()) == len(trace) and len(out) == len(trace)
          and not fleet.quarantined
          and all(v == 0 for v in rep["queue_depth"].values())
          and max(util.values()) == 1.0
          and all(0.0 <= v <= 1.0 for v in util.values())
          and sum(rep["placement"].values()) == len(trace)
          and rep["shards"] == {"fast": 4, "wide": 4},
          f"mesh fleet report: {rep}")
    for r in out:
        b, mem = trace[r.info["ticket"]]
        want = run_kernel(b.gpu_prog, mem, b.gpu_items,
                          cfgs[r.info["device"]], device=dev)
        check(summary(r.mem, r.info) == summary(*want)
              and np.array_equal(r.mem[b.gpu_out], b.ref(mem, b.gpu_n)),
              f"mesh fleet ticket {r.info['ticket']} != its direct run")
    return {"placement": rep["placement"], "shards": rep["shards"],
            "utilization": util, "makespan_us": rep["makespan_us"]}


def mesh_path(benches, golden, dev) -> dict:
    """mesh= over LaunchMesh([card] * 8) (module doc, phase 8b, legs
    a-f).
    Returns each leg's rounds and wall."""
    mesh = LaunchMesh([dev] * MESH_ENTRIES)
    legs = {}
    for name, fn, args in (("cohort", mesh_cohort, (benches, golden, mesh)),
                           ("batch", mesh_batch, (benches, golden, mesh)),
                           ("patch_chain", mesh_patch_chain,
                            (benches, mesh, dev)),
                           ("serving", mesh_serving, (mesh, dev)),
                           ("fleet", mesh_fleet, (mesh, dev))):
        out, rounds, wall = _timed(fn, *args)
        legs[name] = {**_rounds_line(wall, rounds), **out}
    check(legs["cohort"]["rounds"] > 0, "the mesh cohort launched nothing")
    emit({"mesh_path": legs})
    return legs


def legacy_path(benches, golden, dev) -> dict:
    """(g) run_kernel(legacy=True) at Table III size: 8-CU shared copy,
    div_int, vec_mul, fir and reduction and 1-CU shared fir, each against
    the golden file (memory, cycles, stats, steps); one round a host
    check, so its pe_execute launches equal its steps."""
    runs = {}
    for run in LEGACY_RUNS:
        prog, mem0, n, out, expected = launch(run, benches)
        cfg = make_config(run, GGPUConfig, ScalarConfig)
        (mem, info), rounds, wall = _timed(
            lambda: run_kernel(prog, mem0, n, cfg, legacy=True, device=dev))
        _check_run(run, mem, info, expected, out, golden)
        check(rounds == info["steps"],
              f"legacy {run.key}: {rounds} rounds for {info['steps']} steps")
        runs[run.key] = {**_rounds_line(wall, rounds),
                         "steps": info["steps"]}
    emit({"legacy_path": runs})
    return runs


# -- phase 11: LM training on the card ---------------------------------------

GOLDEN_TRAIN = ROOT / "src" / "repro_torch" / "train" / "golden_train.json"
TRAIN_ARCH = "smollm-360m"
TRAIN_SEED = 0
GOLDEN_TRAIN_LAYERS = 4
GOLDEN_TRAIN_STEPS = 4
GOLDEN_TRAIN_MICROBATCHES = 2
GOLDEN_TRAIN_DATA = {"seq_len": 256, "global_batch": 4, "seed": 1234}
GOLDEN_TRAIN_HP = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 8}
# Limits of the golden run's errors (train_golden_errs). The port on the
# CPU is within 2.6e-7 (loss), 1.0e-6 (grad_norm), 0 (lr), 5.6e-5 (sum)
# and 1.9e-7 (max |x|) of the JAX package (f32 sums in other orders); each
# limit is ~100x that, room for cuBLAS's orders on the card, where an
# H100 (700 W) read 1.3e-7, 7.0e-7, 0, 2.2e-4 and 1.9e-7 (PERF.md). The
# planted faults land at >= 6x the loss limit and >= 16x the max |x|
# limit (decay on every tensor: 1.2e-4, 2.7e-4, 0, 10.0, 3.2e-4) and far
# beyond (bias correction off: 0.13, 0.20, 0, 10.9, 1.1e-2).
TRAIN_GOLDEN_TOL = {"loss_rel": 2e-5, "grad_norm_rel": 1e-4, "lr_rel": 1e-6,
                    "sum_err": 5e-3, "max_abs_rel": 2e-5}
# the launcher's command line of the main path, and its timed steps
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 12, 2048, 8
TRAIN_ARGV = ("--arch", TRAIN_ARCH, "--full-config", "--steps",
              str(TRAIN_STEPS), "--seq-len", str(TRAIN_SEQ), "--batch",
              str(TRAIN_BATCH))
TRAIN_TIMED = slice(2, TRAIN_STEPS)          # steps 3-12
# the resume check: full width, 4 layers, bf16, the golden run's data
RESUME_STEPS, RESUME_SAVE_EVERY, RESUME_FAIL_AT = 6, 3, 4


def train_config(golden: bool = False):
    """The port's SmolLM-360M as training runs it (the plain path, the
    planner's remat), or the golden run's (4 layers, f32 compute)."""
    cfg = get_config(TRAIN_ARCH).replace(use_kernels=False, remat="dots")
    if golden:
        cfg = cfg.replace(n_layers=GOLDEN_TRAIN_LAYERS,
                          compute_dtype="float32")
    return cfg


def train_golden_spec() -> dict:
    """What golden_train.json must have been computed for."""
    return {"arch": TRAIN_ARCH, "n_layers": GOLDEN_TRAIN_LAYERS,
            "compute_dtype": "float32", "remat": "dots",
            "seed": TRAIN_SEED, "steps": GOLDEN_TRAIN_STEPS,
            "microbatches": GOLDEN_TRAIN_MICROBATCHES,
            "data": GOLDEN_TRAIN_DATA, "hp": GOLDEN_TRAIN_HP}


def tensor_summary(named) -> dict:
    """{name: {"numel", "sum", "max_abs"}} of numpy arrays (the sum in
    f64)."""
    return {n: {"numel": int(x.size),
                "sum": float(np.sum(x, dtype=np.float64)),
                "max_abs": float(np.abs(x).max())} for n, x in named}


def golden_train_batches() -> list:
    """The golden run's batches, as SyntheticLM makes them here. They are
    kept in golden_train.json, and the card's run reads them from there:
    numpy's ``Generator.zipf`` draws other tokens under other numpy
    versions (the card's machine has another one), so the pipeline's
    batches are the same only within one installation."""
    data = SyntheticLM(DataConfig(train_config().vocab_size,
                                  **GOLDEN_TRAIN_DATA))
    return [{k: v.tolist() for k, v in data.batch_at(s).items()}
            for s in range(GOLDEN_TRAIN_STEPS)]


def train_golden_record(dev, batches) -> dict:
    """The golden run on ``dev`` over ``batches`` (the golden file's):
    per step loss, grad_norm and lr, and the final parameters'
    summaries."""
    cfg = train_config(golden=True)
    model = init_model(cfg, TRAIN_SEED, dev)
    model.requires_grad_(True)
    opt = adamw.init(dict(model.named_parameters()))
    step = make_train_step(cfg, adamw.AdamWConfig(**GOLDEN_TRAIN_HP),
                           GOLDEN_TRAIN_MICROBATCHES)
    steps = []
    for batch in batches:
        metrics = step(model, opt, to_device(
            {k: np.asarray(v, np.int32) for k, v in batch.items()}, dev))
        steps.append({k: float(v) for k, v in sorted(metrics.items())})
    return {"steps": steps, "tensors": tensor_summary(
        (n, to_numpy(p.detach())) for n, p in model.named_parameters())}


def train_golden_errs(record, golden) -> dict:
    """The record's largest errors against the golden file's, each in
    the unit TRAIN_GOLDEN_TOL limits."""
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    steps = list(zip(record["steps"], golden["steps"]))
    tens = [(record["tensors"][n], t) for n, t in golden["tensors"].items()]
    return {
        "loss_rel": max(rel(a["loss"], b["loss"]) for a, b in steps),
        "grad_norm_rel": max(rel(a["grad_norm"], b["grad_norm"])
                             for a, b in steps),
        "lr_rel": max(rel(a["lr"], b["lr"]) for a, b in steps),
        # a sum's error over lr * sqrt(numel): the rms error per element
        # in units of lr where the elements' errors are independent
        "sum_err": max(abs(a["sum"] - b["sum"]) / math.sqrt(b["numel"])
                       for a, b in tens) / GOLDEN_TRAIN_HP["lr"],
        "max_abs_rel": max(rel(a["max_abs"], b["max_abs"]) for a, b in tens)}


# planted faults: (name, module, attribute, replacement)
TRAIN_FAULTS = (
    ("weight decay on every tensor, 1-D ones included", M, "decay_ndims",
     lambda model: {n: 2 for n, _ in model.named_parameters()}),
    ("AdamW bias correction off", adamw, "bias_corrections",
     lambda hp, step: (1.0, 1.0)),
)


def _planted(fault, fn, *args):
    _, mod, attr, repl = fault
    orig = getattr(mod, attr)
    setattr(mod, attr, repl)
    try:
        return fn(*args)
    finally:
        setattr(mod, attr, orig)


def _train_golden_over(errs) -> list:
    return [k for k, v in errs.items() if v > TRAIN_GOLDEN_TOL[k]]


def lm_train_golden(dev) -> dict:
    """The golden run on the card against golden_train.json, and each
    planted fault, which must fall outside TRAIN_GOLDEN_TOL."""
    golden = json.loads(GOLDEN_TRAIN.read_text())
    check(golden["spec"] == train_golden_spec(),
          f"{GOLDEN_TRAIN.name} was made for {golden['spec']}, not "
          f"{train_golden_spec()}: regenerate it")
    batches = golden["batches"]
    here = golden_train_batches() == batches
    t0 = time.perf_counter()
    errs = train_golden_errs(train_golden_record(dev, batches), golden)
    wall = time.perf_counter() - t0
    faults = {}
    for fault in TRAIN_FAULTS:
        ferrs = train_golden_errs(_planted(fault, train_golden_record, dev,
                                           batches), golden)
        faults[fault[0]] = {"errs": ferrs, "over": _train_golden_over(ferrs)}
    out = {"layers": GOLDEN_TRAIN_LAYERS, "compute": "float32",
           "steps": GOLDEN_TRAIN_STEPS, "wall_s": wall, "errs": errs,
           "tol": TRAIN_GOLDEN_TOL, "planted_faults": faults,
           "numpy": np.__version__,
           "synthetic_batches_equal_the_golden_files": here}
    emit({"lm_train_golden": out})
    over = _train_golden_over(errs)
    check(not over, f"golden training run: {over} over the limit: {errs}")
    for name, f in faults.items():
        check(bool(f["over"]), f"planted fault '{name}' passes the golden "
              f"training limits: {f['errs']}")
    torch.cuda.empty_cache()
    return out


def _timed_saves(saves: list):
    """A wrapper of checkpoint.save that records each save's seconds and
    bytes (the device-to-host copy and the write) in ``saves``."""
    save = checkpoint.save

    def timed(ckpt_dir, step, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(ckpt_dir, step, *args, **kwargs)
        saves.append({"step": step, "seconds": time.perf_counter() - t0,
                      "bytes": (path / "arrays.npz").stat().st_size})
        return path
    return save, timed


def _grads_of(model, cfg, batch) -> dict:
    loss = M.loss_fn(model, cfg, batch)
    params = dict(model.named_parameters())
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def train_profile(trainer, model, params, opt, steps: int = 2) -> dict:
    """Busy share and top device ops of ``steps`` train steps: each run
    unprofiled (host wall clock to a synchronize) and then under
    torch.profiler, on the main path's next batches."""
    first = trainer.tc.steps
    batches = [trainer.put_batch(first + i) for i in range(2 * steps)]

    def run(bs):
        def fn():
            with set_rules(trainer.rules):
                for b in bs:
                    trainer.step(model, params, opt, b)
        return fn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(batches[:steps])()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    # device activity only: a step is ~51k device ops, and host events
    # would double what the profiler records and then sorts through
    kernels, profiled_ms = _profiled(run(batches[steps:]))
    busy = _device_ms_of(kernels)
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "profile_s": time.perf_counter() - t0,
            "profiled_wall_ms_per_step": profiled_ms / steps,
            "device_ms_per_step": busy / steps,
            "device_busy_share": busy / wall_ms,
            "device_ops_per_step": len(kernels) / steps,
            "top_device_ms_per_step": {
                k: v / steps for k, v in _top(kernels, 10).items()}}


def lm_train_main(dev) -> dict:
    """``python -m repro_torch.launch.train`` in-process at full width on
    the card (TRAIN_ARGV, a temporary checkpoint directory in the
    checkout): the loss must fall by 10 %; step time, throughput, model
    FLOP share, peak memory against the plan, checkpoint cost, a profile
    and a determinism probe (one batch's gradients twice)."""
    saves: list = []
    save, timed = _timed_saves(saves)
    with tempfile.TemporaryDirectory(prefix=".train_ckpt_", dir=ROOT) as d:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        checkpoint.save = timed
        t0 = time.perf_counter()
        try:
            out = launch_train.main(list(TRAIN_ARGV) + ["--ckpt-dir", d])
        finally:
            checkpoint.save = save
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
    trainer, model, opt, mp = (out["trainer"], out["model"], out["opt"],
                               out["plan"])
    cfg = trainer.cfg
    log = trainer.metrics_log
    losses = [m["loss"] for m in log]
    step_s = float(np.median([m["seconds"] for m in log[TRAIN_TIMED]]))
    tokens = TRAIN_SEQ * TRAIN_BATCH
    flops = model_flops_estimate(cfg, ShapeSpec("launch", TRAIN_SEQ,
                                                TRAIN_BATCH, "train"))
    t0 = time.perf_counter()
    batch = to_device(trainer.data.batch_at(0), dev)
    g1 = _grads_of(model, cfg, batch)
    g2 = _grads_of(model, cfg, batch)
    differ = [n for n in g1 if not torch.equal(g1[n], g2[n])]
    probe = {"tensors": len(g1), "differ": len(differ),
             "max_abs_diff": max((float((g1[n] - g2[n]).abs().max())
                                  for n in differ), default=0.0),
             "first_differing": differ[:4],
             "wall_s": time.perf_counter() - t0}
    del g1, g2
    res = {
        "arch": cfg.name, "layers": cfg.n_layers, "compute": cfg.compute_dtype,
        "params": cfg.n_params(), "seq_len": TRAIN_SEQ, "batch": TRAIN_BATCH,
        "steps": len(log), "plan": {
            "remat": mp.knobs.remat, "microbatches": out["microbatches"],
            "use_kernels": cfg.use_kernels,
            "estimate_gib": mp.estimate.total_bytes / 2**30,
            "bound": mp.estimate.bound()},
        "losses": losses, "loss_drop": 1 - losses[-1] / losses[0],
        "step_seconds": [m["seconds"] for m in log],
        "ms_per_step": step_s * 1e3, "timed_steps": "3-12 (median)",
        "tokens_per_s": tokens / step_s,
        "model_flops_per_step": flops,
        "model_flops_share_of_989_tflops": flops / step_s / PEAK_FLOPS,
        "peak_device_gib": peak / 2**30,
        "peak_over_estimate": peak / mp.estimate.total_bytes,
        "checkpoints": saves, "wall_s": wall,
        "kernel_launches": dict(zip(("flash_attention", "rglru_scan"),
                                    counts[:2])),
        "determinism_probe": probe}
    res["profile"] = train_profile(trainer, model, out["params"], opt)
    res["step_cost"] = train_leg(trainer, model, out["params"], opt)
    res["step_cost"]["measured_ms"] = res["ms_per_step"]
    emit({"lm_train_main": res})
    check(counts == (0, 0, 0, 0), f"training launched kernels: {counts}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0] * 0.9,
          f"loss fell {losses[0]} -> {losses[-1]}, not by 10 %")
    check(len(saves) == 2 and saves[-1]["step"] == TRAIN_STEPS,
          f"checkpoints {saves}")
    del out, trainer, model, opt
    torch.cuda.empty_cache()
    return res


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x.detach()


def _state_diff(params_a, opt_a, params_b, opt_b) -> dict:
    """The tensors of two training states (parameters, both AdamW
    moments, the step; a DTensor by its block, whole on a (1, 1) mesh)
    that are not equal bit for bit, with their largest difference."""
    pairs = [(f"params/{n}", params_a[n], params_b[n]) for n in params_b]
    for key in ("m", "v"):
        pairs += [(f"opt/{key}/{n}", getattr(opt_a, key)[n],
                   getattr(opt_b, key)[n]) for n in params_b]
    pairs.append(("opt/step", opt_a.step, opt_b.step))
    differ = []
    for k, x, y in pairs:
        x, y = _local(x), _local(y)
        if not torch.equal(x, y):
            differ.append((k, float((x.float() - y.float()).abs().max())))
    return {"tensors": len(pairs), "differ": len(differ),
            "max_abs_diff": max((v for _, v in differ), default=0.0),
            "first_differing": differ[:4]}


def lm_train_resume(dev) -> dict:
    """The Trainer at full width, 4 layers, bf16: RESUME_STEPS steps
    uninterrupted against a run that fails at step RESUME_FAIL_AT and
    resumes from its last checkpoint; the final parameters and AdamW
    state must be equal bit for bit."""
    cfg = train_config().replace(n_layers=GOLDEN_TRAIN_LAYERS)
    hp = adamw.AdamWConfig(**GOLDEN_TRAIN_HP)
    dc = DataConfig(cfg.vocab_size, **GOLDEN_TRAIN_DATA)
    with tempfile.TemporaryDirectory(prefix=".train_ckpt_", dir=ROOT) as d:
        def tc(sub, **kw):
            return TrainConfig(steps=RESUME_STEPS, save_every=RESUME_SAVE_EVERY,
                               ckpt_dir=f"{d}/{sub}", **kw)
        t0 = time.perf_counter()
        a = Trainer(cfg, hp, tc("a"), dc, dev).run()
        failed = ""
        try:
            Trainer(cfg, hp, tc("b", fail_at_step=RESUME_FAIL_AT), dc,
                    dev).run()
        except RuntimeError as e:
            failed = str(e)
        resumed_from = checkpoint.latest_step(f"{d}/b")
        b = Trainer(cfg, hp, tc("b"), dc, dev).run()
        wall = time.perf_counter() - t0
    diff = _state_diff(a["params"], a["opt"], b["params"], b["opt"])
    res = {"layers": cfg.n_layers, "compute": cfg.compute_dtype,
           "steps": RESUME_STEPS, "save_every": RESUME_SAVE_EVERY,
           "failed_with": failed, "resumed_from": resumed_from,
           **diff, "wall_s": wall}
    emit({"lm_train_resume": res})
    check(failed == f"injected failure at step {RESUME_FAIL_AT}",
          f"the interrupted run: {failed!r}")
    check(resumed_from == RESUME_SAVE_EVERY, f"resumed from {resumed_from}")
    check(int(a["opt"].step) == int(b["opt"].step) == RESUME_STEPS,
          "AdamW step counts")
    check(diff["differ"] == 0, f"the resumed run differs from the "
          f"uninterrupted one: {diff}")
    del a, b
    torch.cuda.empty_cache()
    return res


def lm_train_path(dev) -> dict:
    """Phase 11 (module doc): the golden run, the launcher's main path,
    the resume check."""
    t0 = time.perf_counter()
    golden = lm_train_golden(dev)
    # a world of one around the launcher (which leaves it as found) and
    # the profile's steps on its sharded state
    opened = launch_train.open_world(dev)
    try:
        main_res = lm_train_main(dev)
    finally:
        if opened:
            dist.destroy_process_group()
    resume = lm_train_resume(dev)
    return {"golden": golden, "main": main_res, "resume": resume,
            "wall_s": time.perf_counter() - t0}


# -- phase 11b: sharded training ----------------------------------------------

SHARDED_STEPS = 4
SHARDED_ARGV = ("--arch", TRAIN_ARCH, "--full-config", "--steps",
                str(SHARDED_STEPS), "--seq-len", str(TRAIN_SEQ), "--batch",
                str(TRAIN_BATCH))
SHARDED_TIMED = slice(1, SHARDED_STEPS)      # steps 2-4


def sharded_spans(trainer, model, params, opt, step: int) -> dict:
    """One sharded step, with its parts the one-device step lacks (each
    parameter's dp gather at its layer unit, ``ctx.gather_param``, and
    the global norm over shards, ``steps.global_norm``) counted and the
    norm timed to a synchronize; the step's ms, and whether the model's
    parameters are the shards' own storage after it."""
    spans = {"gather_param": [], "global_norm": []}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spans[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def counted(fn):
        def run(*args):
            spans["gather_param"].append(0.0)
            return fn(*args)
        return run
    batch = trainer.put_batch(step)
    orig = shard_ctx.gather_param, steps_mod.global_norm
    shard_ctx.gather_param = counted(orig[0])
    steps_mod.global_norm = timed("global_norm", orig[1])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with set_rules(trainer.rules):
            trainer.step(model, params, opt, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        shard_ctx.gather_param, steps_mod.global_norm = orig
    bound = all(p.untyped_storage()._cdata
                == params[n].to_local().untyped_storage()._cdata
                for n, p in model.named_parameters())
    return {"step_ms": step_ms, "params_are_shards": bound,
            "gather_param": {"calls": len(spans["gather_param"])},
            "global_norm": {"ms": sum(spans["global_norm"]),
                            "calls": len(spans["global_norm"])}}


def lm_train_sharded(dev, probe: dict) -> dict:
    """Phase 11b (module doc). ``probe`` is phase 11's determinism probe:
    with no gradient differing there, the sharded and one-device states
    must be equal bit for bit; else within its largest difference."""
    t_phase = time.perf_counter()
    parts = {}

    def lap(name, t0):
        parts[name] = time.perf_counter() - t0
        return time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".train_ckpt_", dir=ROOT) as d:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = launch_train.main(list(SHARDED_ARGV)
                                + ["--ckpt-dir", f"{d}/sharded"])
        t0 = lap("sharded_launcher", t0)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        left_open = dist.is_initialized()
        trainer, mp = out["trainer"], out["plan"]
        mesh = {k: int(v) for k, v in zip(out["mesh"].mesh_dim_names,
                                          out["mesh"].shape)}
        whole = all(is_whole(p.device_mesh, p.placements)
                    for p in out["params"].values())
        plain_tr = Trainer(trainer.cfg, trainer.hp, dataclasses.replace(
            trainer.tc, ckpt_dir=f"{d}/plain"), trainer.data.cfg, dev)
        plain = plain_tr.run()
        t0 = lap("unsharded_trainer", t0)
        vs_plain = _state_diff(out["params"], out["opt"], plain["params"],
                               plain["opt"])
        losses = [m["loss"] for m in trainer.metrics_log]
        plain_losses = [m["loss"] for m in plain_tr.metrics_log]
        step_ms = {k: float(np.median([m["seconds"] for m in
                                       log[SHARDED_TIMED]])) * 1e3
                   for k, log in (("sharded", trainer.metrics_log),
                                  ("unsharded", plain_tr.metrics_log))}
        del plain, plain_tr
        torch.cuda.empty_cache()
        t0 = lap("compare", t0)

        # the checkpoint: on one device, then onto a new mesh
        params, opt, _ = checkpoint.restore(f"{d}/sharded", SHARDED_STEPS,
                                            dev)
        one_device = _state_diff(params, adamw.AdamWState(**opt),
                                 out["params"], out["opt"])
        del params, opt
        t0 = lap("restore_one_device", t0)
        opened = launch_train.open_world(dev)
        try:
            again = Trainer(trainer.cfg, trainer.hp, dataclasses.replace(
                trainer.tc, ckpt_dir=f"{d}/sharded"), trainer.data.cfg,
                rules=make_rules(make_host_mesh()))
            t0 = lap("open_world", t0)
            model, params, opt, start = again.resume_or_init()
            on_mesh = _state_diff(params, opt, out["params"], out["opt"])
            t0 = lap("restore_on_mesh", t0)
            spans = sharded_spans(again, model, params, opt, start)
            del model, params, opt
            t0 = lap("spans_step", t0)
        finally:
            if opened:
                dist.destroy_process_group()
        t0 = lap("close_world", t0)
    lap("cleanup", t0)
    exact = probe["differ"] == 0
    bound = 0.0 if exact else probe["max_abs_diff"]
    res = {"arch": trainer.cfg.name, "layers": trainer.cfg.n_layers,
           "compute": trainer.cfg.compute_dtype, "seq_len": TRAIN_SEQ,
           "batch": TRAIN_BATCH, "steps": SHARDED_STEPS, "mesh": mesh,
           "every_shard_whole": whole, "launcher_closed_its_world":
           not left_open, "losses": losses, "unsharded_losses":
           plain_losses, "vs_unsharded": vs_plain,
           "bit_for_bit_required": exact, "bound": bound,
           "determinism_probe": probe,
           "ms_per_step": step_ms, "timed_steps": "2-4 (median)",
           "peak_device_gib": peak / 2**30,
           "plan_estimate_gib": mp.estimate.total_bytes / 2**30,
           "peak_over_estimate": peak / mp.estimate.total_bytes,
           "restore_one_device": one_device, "restore_on_mesh": on_mesh,
           "spans": spans, "seconds": parts,
           "kernel_launches": dict(zip(("flash_attention", "rglru_scan"),
                                       counts[:2]))}
    emit({"lm_train_sharded": res})
    check(counts == (0, 0, 0, 0), f"sharded training launched kernels: "
          f"{counts}")
    check(not left_open, "the launcher left the world it opened open")
    check(mesh == {"data": 1, "model": 1} and whole,
          f"one card's mesh {mesh}, every shard whole: {whole}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    if exact:
        check(losses == plain_losses and vs_plain["differ"] == 0,
              f"the sharded Trainer differs from the one-device one: "
              f"{vs_plain}, losses {losses} vs {plain_losses}")
    else:
        check(vs_plain["max_abs_diff"] <= bound,
              f"the sharded Trainer differs from the one-device one by "
              f"more than the determinism probe's {bound}: {vs_plain}")
    check(one_device["differ"] == 0 and on_mesh["differ"] == 0,
          f"checkpoint round trip: one device {one_device}, "
          f"mesh {on_mesh}")
    check(spans["params_are_shards"] and spans["gather_param"]["calls"] > 0
          and spans["global_norm"]["calls"] == 1,
          f"the sharded step did not take its path: {spans}")
    del out, trainer
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_phase
    return res

# -- phase 12: the MoE family and the dense Qwen1.5 config -------------------

GOLDEN_MOE = ROOT / "src" / "repro_torch" / "models" / "golden_moe.json"
MOE_ARCH = "mixtral-8x7b"
MOE_SEED = 0
MOE_SLOTS = 4
MOE_MAX_NEW = 16
# The golden run: Mixtral-8x7B at full width, 1 of its 32 layers, f32
# compute, so that the JAX package computes golden_moe.json on a CPU. Two
# waves of 4 slots: the first prefills past the 4,096-token window (its
# cache rolls), the second stays far under it.
GOLDEN_MOE_LAYERS = 1
GOLDEN_MOE_LENGTHS = (4160, 1100, 600, 37, 900, 12)
# The main path: full width, 4 of the 32 layers (6.07 B parameters, 24.3
# GB in f32 on the card), bf16 compute. The first wave prefills 6,144
# tokens a row (FLASH_MOE), the second 2,002 (its capacity, 625.6 slots,
# rounds up to 628).
MOE_LAYERS = 4
MOE_LENGTHS = (6144, 5000, 3500, 1200, 2002, 45)
# bf16 compute, the kernel path fed the plain path's tokens. Read on an
# H100 (PERF.md): the sound kernel path is at most 0.082 from the plain
# path in the logits of any (call, row) whose current token kept its
# experts; the planted faults reach 0.73 (expert positions counted across
# the wave's rows), 2.5 (the window halved) and 3.6 (gates not
# renormalised). The limit sits ~3x from the sound path and the nearest
# fault.
MOE_TOL = 0.25
# A token whose k-th and (k+1)-th router probabilities nearly tie may
# pick another expert on the kernel path than on the plain one (the two
# round attention to bf16 at other points); its output then differs by a
# whole expert's share. Such a (call, row), whose current token changed
# experts, is held not to MOE_TOL but to this: the plain path's gap at
# the first layer where it changed must be under MOE_GAP_TOL. The sound
# path's changes sat at gaps of 3.2e-5 and 4.9e-4, the faults' reach
# 0.17-0.26 (PERF.md): 1e-2 is 20x above the one and 17x below the
# other.
MOE_GAP_TOL = 1e-2
# Llama-4-Scout at full width, 1 of its 48 layers (4.15 B parameters):
# read 0.031 sound, 2.49 with gates not renormalised. Qwen1.5-0.5B whole
# (24 layers, QKV bias): read 0.078 sound, 5.9 with flash_attention's
# causal mask off. One short wave each, the kernel path against the
# plain path; each limit ~3x or more from both readings.
SCOUT_ARCH, SCOUT_LAYERS = "llama4-scout-17b-a16e", 1
SCOUT_LENGTHS, SCOUT_MAX_NEW, SCOUT_TOL = (1500, 200), 4, 0.25
QWEN_ARCH = "qwen1.5-0.5b"
QWEN_LENGTHS, QWEN_MAX_NEW, QWEN_TOL = (700, 300, 90, 20), 8, 0.3


def moe_config(golden: bool = False):
    """The port's Mixtral-8x7B of the main path (MOE_LAYERS, bf16), or of
    the golden run (GOLDEN_MOE_LAYERS, f32 compute)."""
    cfg = get_config(MOE_ARCH)
    if golden:
        return cfg.replace(n_layers=GOLDEN_MOE_LAYERS,
                           compute_dtype="float32")
    return cfg.replace(n_layers=MOE_LAYERS)


def moe_prompts(vocab: int, lengths):
    g = np.random.default_rng([MOE_SEED, 2])
    return [[int(t) for t in g.integers(0, vocab, n)] for n in lengths]


def golden_moe_spec() -> dict:
    """What golden_moe.json must have been computed for."""
    return {"arch": MOE_ARCH, "n_layers": GOLDEN_MOE_LAYERS,
            "compute_dtype": "float32", "seed": MOE_SEED,
            "lengths": list(GOLDEN_MOE_LENGTHS), "slots": MOE_SLOTS,
            "max_new": MOE_MAX_NEW, "topk": LM_TOPK}


def rows_summary(steps, tokens) -> list:
    """Per row: its tokens, the top-1/top-2 margin of the logits behind
    each, and the top-k ids and values of every step's logits.
    ``steps[i]``: row i's logits (V,) of each step; ``tokens[i]``: its
    tokens."""
    out = []
    for row, toks in zip(steps, tokens):
        ids = [np.argsort(-x, kind="stable")[:LM_TOPK] for x in row]
        out.append({
            "tokens": [int(t) for t in toks],
            "margins": [float(np.diff(np.sort(x)[-2:])[0]) for x in row],
            "top_ids": [[int(t) for t in d] for d in ids],
            "top_vals": [[float(x[t]) for t in d]
                         for x, d in zip(row, ids)]})
    return out


def steps_summary(out, calls, prompts, slots: int, max_new: int) -> list:
    """``rows_summary`` of one generate, per prompt (the prefill's step
    first)."""
    return rows_summary(per_prompt(calls, len(prompts), slots, max_new),
                        [o[len(p):] for o, p in zip(out, prompts)])


def golden_steps_err(steps, mine, golden_rows, n_steps: int, what: str,
                     tol: float = GOLDEN_TOL):
    """A run's rows against a golden file's: tokens equal up to the first
    step whose golden margin is under ``tol``, and the largest |error| of
    the top-k logits at the golden ids over those steps and the next
    (which saw equal tokens). Returns (largest error, steps matched per
    row, steps compared)."""
    top_err, matched, compared = 0.0, [], 0
    for i, (ref, got) in enumerate(zip(golden_rows, mine)):
        n = _matched_steps(got["tokens"], ref["tokens"], ref["margins"],
                           tol, f"{what} {i}")
        matched.append(n)
        top_err = max(top_err, float(np.abs(np.asarray(
            got["top_vals"][0]) - ref["top_vals"][0]).max()))
        for t in range(min(n + 1, n_steps)):
            at_ref = steps[i][t][ref["top_ids"][t]]
            top_err = max(top_err,
                          float(np.abs(at_ref - ref["top_vals"][t]).max()))
            compared += 1
    return top_err, matched, compared


def moe_summarize(out, calls, prompts):
    """What golden_moe.json keeps of one generate: ``steps_summary``; per
    sampling call the smallest router gap of its forward."""
    return {"prompts": steps_summary(out, calls, prompts, MOE_SLOTS,
                                     MOE_MAX_NEW),
            "router_gaps": [float(c[2]) for c in calls]}


def _min_gap(log: RoutingLog):
    """``per_call`` for the golden run: the forward's smallest gap."""
    def take():
        return min(float(g) for _, g, _ in log.take())
    return take


def moe_golden(dev) -> dict:
    """The golden run on the card against golden_moe.json: the top-k
    logits of every step within GOLDEN_TOL at the golden ids (up to the
    first step whose golden margin is under it), the tokens equal there."""
    golden = json.loads(GOLDEN_MOE.read_text())
    check(golden["spec"] == golden_moe_spec(),
          f"{GOLDEN_MOE.name} was made for {golden['spec']}, not "
          f"{golden_moe_spec()}: regenerate it")
    cfg = moe_config(golden=True)
    t0 = time.perf_counter()
    model = init_model(cfg, MOE_SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = moe_prompts(cfg.vocab_size, GOLDEN_MOE_LENGTHS)
    before = dict(fa.ROUTE_LAUNCHES)
    t0 = time.perf_counter()
    with RoutingLog() as log:
        out, calls = record_generate(
            Engine(cfg, model, EngineConfig(slots=MOE_SLOTS)), prompts,
            MOE_MAX_NEW, per_call=_min_gap(log))
    wall = time.perf_counter() - t0
    routes = {r: n - before[r] for r, n in fa.ROUTE_LAUNCHES.items()}
    check(routes["simt"] > 0 and routes["tensor_core"] == 0,
          f"MoE golden run (f32): flash_attention launches by route {routes}")
    check(len(calls) == 2 * MOE_MAX_NEW, f"{len(calls)} sampling calls")
    mine = moe_summarize(out, calls, prompts)
    steps = per_prompt(calls, len(prompts), MOE_SLOTS, MOE_MAX_NEW)
    top_err, matched, compared = golden_steps_err(
        steps, mine["prompts"], golden["prompts"], MOE_MAX_NEW,
        "MoE golden prompt")
    res = {"layers": cfg.n_layers, "compute": "float32",
           "params": cfg.n_params(), "init_s": init_s, "wall_s": wall,
           "flash_launches_by_route": routes, "top_max_abs_err": top_err,
           "tol": GOLDEN_TOL, "steps_compared": compared,
           "steps_matched": matched, "of_steps": MOE_MAX_NEW,
           "router_gap_min": min(mine["router_gaps"]),
           "golden_router_gap_min": min(golden["router_gaps"]),
           "router_gaps_max_abs_diff": max(
               abs(a - b) for a, b in zip(mine["router_gaps"],
                                          golden["router_gaps"]))}
    emit({"moe_golden": res})
    check(top_err <= GOLDEN_TOL, f"MoE golden logits: max |err| {top_err} > "
          f"{GOLDEN_TOL}")
    del model, calls, steps
    torch.cuda.empty_cache()
    return res


def _raw_gates(orig):
    """route with the top-k probabilities as the gates, not renormalised."""
    def run(hx, w, k):
        probs, _, experts = orig(hx, w, k)
        return probs, probs.gather(-1, experts), experts
    return run


def _wave_positions(orig):
    """_slots counting each expert's positions across the wave's rows, as
    one row, where the capacity is per row."""
    def run(experts, e, cap):
        b = experts.shape[0]
        slot, keep = orig(experts.reshape(1, -1, experts.shape[-1]), e, cap)
        return slot.reshape(b, -1), keep.reshape(b, -1)
    return run


def _unrounded(orig):
    """capacity without the rounding up to a multiple of 4."""
    def run(s, cfg):
        return int(max(1, (s * cfg.topk / cfg.n_experts)
                       * cfg.capacity_factor))
    return run


def _acausal(orig):
    """flash_attention with the causal mask off."""
    def run(q, k, v, *, causal, window, scale):
        return orig(q, k, v, causal=False, window=window, scale=scale)
    return run


# Faults planted in the kernel path of each comparison: (name, module,
# attribute the path calls, wrapper, whether the comparison must catch it).
# Capacity without its rounding changes only the second wave's prefill
# (625 slots in place of 628 at 2,002 tokens; 1,920 at 6,144 is a multiple
# of 4, and a decode step's single token fills no expert), so it is
# reported, not required.
MOE_FAULTS = (("router gates not renormalised", moe, "route", _raw_gates,
               True),
              ("expert positions counted across the wave's rows", moe,
               "_slots", _wave_positions, True),
              ("capacity not rounded up to 4", moe, "capacity", _unrounded,
               False),
              ("flash_attention window halved", kops, "flash_attention",
               _window_of(lambda w: w // 2), True))
SCOUT_FAULTS = (MOE_FAULTS[0],)
QWEN_FAULTS = (("flash_attention causal mask off", kops, "flash_attention",
                _acausal, True),)


def kernel_vs_plain(cfg, model, prompts, slots: int, max_new: int,
                    tol: float, faults=()) -> dict:
    """The plain path (use_kernels=False) on the card, then the kernel
    path fed its tokens, clean and with each fault planted, each compared
    by ``_compare`` (``_check_served`` then holds the clean one within
    ``tol`` and MOE_GAP_TOL, and every fault that must fail outside)."""
    engine = Engine(cfg, model, EngineConfig(slots=slots))
    plain = Engine(cfg.replace(use_kernels=False), model,
                   EngineConfig(slots=slots))
    counts = launch_counts()
    t0 = time.perf_counter()
    out_p, calls_p = _routed_generate(plain, prompts, max_new)
    plain_wall = time.perf_counter() - t0
    check(launch_counts() == counts, "the plain path launched a kernel")
    sound = _compare(_forced_calls(engine, prompts, calls_p, max_new),
                     calls_p, max_new)
    faults_out = {}
    for fault in faults:
        res = _compare(_forced_calls(engine, prompts, calls_p, max_new,
                                     fault), calls_p, max_new)
        faults_out[fault[0]] = {**res, "must_fail": fault[4],
                                "caught": _over(res, tol)}
    res = {"forced_vs_plain": sound, "tol": tol, "gap_tol": MOE_GAP_TOL,
           "forced_calls": len(calls_p), "planted_faults": faults_out,
           "plain_path_wall_s_with_logit_copies": plain_wall,
           "plain_tokens": [o[len(p):] for o, p in zip(out_p, prompts)]}
    check(len(calls_p) == -(-len(prompts) // slots) * max_new,
          f"{len(calls_p)} sampling calls")
    return res


def _check_served(what: str, res: dict) -> None:
    sound, tol = res["forced_vs_plain"], res["tol"]
    check(not _over(sound, tol),
          f"{what}: kernels vs plain (teacher forced, every step): max "
          f"|err| {sound['max']} (limit {tol}) over the rows whose experts "
          f"agree; router gap at a changed expert {sound['max_flip_gap']} "
          f"(limit {MOE_GAP_TOL})")
    for name, f in res["planted_faults"].items():
        check(not f["must_fail"] or f["caught"],
              f"{what}: planted fault '{name}' passes the limits (max "
              f"|err| {f['max']}, router gap {f['max_flip_gap']})")


def _host_peak_gb() -> float:
    """This process's peak resident memory on the host, GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _init_timed(cfg, dev, tree=None):
    """The port's model of ``cfg`` on ``dev``, from ``tree`` or the seeded
    ``init_model``, with the seconds it took and the host's peak RSS."""
    t0 = time.perf_counter()
    model = (init_model(cfg, MOE_SEED, dev) if tree is None
             else params_from_reference(tree, cfg, dev))
    torch.cuda.synchronize()
    return model, {"init_s": time.perf_counter() - t0,
                   "host_peak_rss_gb": _host_peak_gb()}


def moe_main(dev) -> tuple:
    """Mixtral-8x7B at full width (MOE_LAYERS) through Engine.generate as a
    user runs it, timed with CUDA events; then its plain path and the
    kernel path fed its tokens, clean and with MOE_FAULTS planted; a
    short profile. Returns (flash_attention launches, on the tensor-core
    route) of the timed run."""
    cfg = moe_config()
    model, init = _init_timed(cfg, dev)
    prompts = moe_prompts(cfg.vocab_size, MOE_LENGTHS)
    engine = Engine(cfg, model, EngineConfig(slots=MOE_SLOTS))
    t0 = time.perf_counter()
    engine.generate(prompts, MOE_MAX_NEW)      # warm-up: first-use costs
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out, marks = timed_generate(engine, prompts, MOE_MAX_NEW)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    waves = _waves(marks, (0, 0, 0, 0), MOE_MAX_NEW)
    for w in waves:
        # [flash, rglru, flash on the tensor-core route, rglru on the ring]
        check(w["prefill_launches"] == [cfg.n_layers, 0, cfg.n_layers, 0],
              f"Mixtral prefill launches {w['prefill_launches']}")
        check(w["decode_launches"] == [0, 0, 0, 0],
              f"Mixtral decode launches {w['decode_launches']}")
    served = kernel_vs_plain(cfg, model, prompts, MOE_SLOTS, MOE_MAX_NEW,
                             MOE_TOL, MOE_FAULTS)
    matched = []
    for o, p, ref in zip(out, prompts, served.pop("plain_tokens")):
        mine = o[len(p):]
        matched.append(next((t for t, (a, b) in enumerate(zip(mine, ref))
                             if a != b), len(ref)))
    generated = sum(len(o) - len(p) for o, p in zip(out, prompts))
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "compute": cfg.compute_dtype, "params": cfg.n_params(),
           "active_params": cfg.n_active_params(), **init,
           "warm_up_s": warm_s, "wall_s": wall, "waves": waves,
           "capacities": [moe.capacity(max(map(len, prompts[i:i + MOE_SLOTS])),
                                       cfg)
                          for i in range(0, len(prompts), MOE_SLOTS)],
           "generated_tokens": generated, "tokens_per_s": generated / wall,
           "peak_device_gb": peak / 1e9,
           "flash_attention_launches": counts[0],
           "flash_attention_tensor_core_launches": counts[2],
           "free_running_steps_equal_to_plain": matched,
           "of_steps": MOE_MAX_NEW, **served}
    emit({"moe_main": res})
    _check_served("Mixtral-8x7B", res)
    lm_profile(model, cfg, prompts[:MOE_SLOTS], key="moe_profile")
    del model, engine
    torch.cuda.empty_cache()
    return counts[0], counts[2]


def served_pair(arch: str, layers: Optional[int], lengths, max_new: int,
                tol: float, faults, dev) -> dict:
    """One wave of ``arch`` (cut to ``layers``) through the kernels,
    checking flash_attention's launches (every layer in the prefill, on
    the tensor-core route; none in decode), then against its plain path
    (``kernel_vs_plain``)."""
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    model, init = _init_timed(cfg, dev)
    prompts = moe_prompts(cfg.vocab_size, lengths)
    reset_launch_counts()
    t0 = time.perf_counter()
    _, marks = timed_generate(Engine(cfg, model,
                                     EngineConfig(slots=len(prompts))),
                              prompts, max_new)
    wall = time.perf_counter() - t0
    waves = _waves(marks, (0, 0, 0, 0), max_new)
    check([w["prefill_launches"] for w in waves]
          == [[cfg.n_layers, 0, cfg.n_layers, 0]]
          and waves[0]["decode_launches"] == [0, 0, 0, 0],
          f"{arch}: flash_attention launches {waves}")
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "params": cfg.n_params(), **init, "wall_s": wall,
           "waves": waves, **kernel_vs_plain(cfg, model, prompts,
                                             len(prompts), max_new, tol,
                                             faults)}
    del res["plain_tokens"], model
    torch.cuda.empty_cache()
    return res


def lm_moe_path(dev) -> dict:
    """Phase 12 (module doc): the MoE golden run, Mixtral-8x7B's main
    path, Llama-4-Scout and Qwen1.5-0.5B against their plain paths.
    Returns the main path's flash_attention launches."""
    t0 = time.perf_counter()
    # equal router probabilities rank lowest index first on the card too
    d, e = moe_config().d_model, moe_config().n_experts
    _, gates, experts = moe.route(torch.zeros((2, 3, d), device=dev),
                                  torch.zeros((d, e), device=dev), 2)
    check(experts.tolist() == [[[0, 1]] * 3] * 2
          and bool((gates == 0.5).all()),
          f"router tie on the card: experts {experts.tolist()}")
    moe_golden(dev)
    launches, tensor_core = moe_main(dev)
    scout = served_pair(SCOUT_ARCH, SCOUT_LAYERS, SCOUT_LENGTHS,
                        SCOUT_MAX_NEW, SCOUT_TOL, SCOUT_FAULTS, dev)
    emit({"scout_vs_plain": scout})
    _check_served("Llama-4-Scout", scout)
    qwen = served_pair(QWEN_ARCH, None, QWEN_LENGTHS, QWEN_MAX_NEW,
                       QWEN_TOL, QWEN_FAULTS, dev)
    emit({"qwen_vs_plain": qwen})
    _check_served("Qwen1.5-0.5B", qwen)
    return {"flash_launches": launches, "tensor_core": tensor_core,
            "wall_s": time.perf_counter() - t0}


# -- phase 13: xLSTM-350M, HuBERT-XLarge and Qwen2-VL-72B --------------------

MODELS = ROOT / "src" / "repro_torch" / "models"
GOLDEN_XLSTM = MODELS / "golden_xlstm.json"
GOLDEN_HUBERT = MODELS / "golden_hubert.json"
GOLDEN_QWEN2_VL = MODELS / "golden_qwen2_vl.json"
FAMILY_SEED = 0
# xLSTM-350M at its published widths and all 24 layers. The golden run
# (f32) is one wave of 4: the sLSTM runs 512 steps in 24 blocks of 22
# (16 padded steps, which move its state), the mLSTM two chunks of 256.
# The main path (bf16) is one wave up to 2,048 tokens.
XLSTM_ARCH = "xlstm-350m"
XLSTM_SLOTS = 4
XLSTM_MAX_NEW = 16
GOLDEN_XLSTM_LENGTHS = (512, 300, 37, 9)
XLSTM_LENGTHS = (2048, 1024, 300, 37)
# its profile runs the wave's prompts cut to 256 tokens: the profiler's
# ~250k events of a 2,048-token prefill (the sLSTM's loop) take ~40 s to
# read back, and the loop's busy share does not depend on its length
XLSTM_PROFILE_TOKENS = 256
# The consistency check: the golden run's first prompt and its tokens,
# 528 in all, prefilled to 506 = 22 x 23 (no padded sLSTM step) and
# decoded the rest of the way, against one prefill of all 528.
XLSTM_SPLIT = 506
# HuBERT-XLarge at its published widths: the golden run at 2 of its 48
# layers (f32), the main path at all 48 (bf16) on 4 clips of 30 s at 50
# frames a second. Its biases and LayerNorm scales are drawn too
# (``family_tree``): at their init (0 and 1) a missing bias cannot show.
HUBERT_ARCH = "hubert-xlarge"
GOLDEN_HUBERT_LAYERS = 2
GOLDEN_HUBERT_FRAMES = (2, 400)
HUBERT_FRAMES = (4, 1500)
# Qwen2-VL-72B at its published widths: the golden run at 1 of its 80
# layers (f32; 3.38 B parameters), the main path at 4 (bf16; 6.01 B, 24.0
# GB in f32). A vision prefill of 2 images of (t, h, w) patches, then
# greedy decode steps; then Engine.generate on token prompts.
QWEN_VL_ARCH = "qwen2-vl-72b"
GOLDEN_VL_LAYERS = 1
GOLDEN_VL_GRID = (1, 16, 16)
GOLDEN_VL_LENGTHS = (40, 17)
VL_LAYERS = 4
VL_GRID = (1, 64, 64)
VL_LENGTHS = (2048, 700, 300, 45)
VL_IMAGES = 2
VL_DECODE = 8
VL_MAX_NEW = 8
# f32 golden runs: GOLDEN_TOL (1e-3) on the top-8 logits, as the other
# golden runs, except xLSTM's. Its 24 layers of exponential gates carry
# f32 rounding forward: read 8.4e-4 from the JAX package's logits on the
# CPU and 6.6e-4 on an H100 (PERF.md), and 1.03e-3 between its own
# chunked prefill and its recurrent decode on the card, where each block
# alone agrees within 1e-5; the planted faults read 3.85 and more. Its
# limit, XLSTM_TOL, sits 5x over the sound readings and ~800x under the
# nearest fault, for the golden run and for the decoded steps against one
# pass. The mLSTM's chunked scan and its recurrent form (chunks of 1) on
# the same inputs differ only in the order of f32 sums: 3.3e-5 of the
# largest |x| on an H100, on m (PERF.md). Their limit, XLSTM_STATE_TOL,
# sits 3x over it; a chunk-end C 1e-3 high, which XLSTM_TOL would pass,
# must fail it (XLSTM_STATE_FAULT). bf16 kernel path
# against its plain path on the card, teacher forced where tokens feed
# back: the 0.3 of the LM main path (the two round attention to bf16 at
# other points; RecurrentGemma read ~0.1 over 26 layers).
XLSTM_TOL = 5e-3
XLSTM_STATE_TOL = 1e-4
XLSTM_STATE_FAULT = 1e-3
HUBERT_TOL = 0.3
VL_TOL = 0.3


def family_config(arch: str, layers: Optional[int] = None,
                  golden: bool = False):
    """``arch``'s published config, cut to ``layers``; f32 compute for a
    golden run."""
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    return cfg.replace(compute_dtype="float32") if golden else cfg


def family_tree(cfg, seed: int = FAMILY_SEED) -> dict:
    """``init_numpy(cfg, seed)``; for a LayerNorm model every bias and
    LayerNorm scale is then drawn from numpy as well (0.1 + 0.2 N(0, 1)
    and 1 + 0.2 N(0, 1), in the schema's order)."""
    tree = init_numpy(cfg, seed)
    if cfg.norm != "layernorm":
        return tree
    g = np.random.default_rng([seed, 3])

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("b", "bias"):
                t[k] = (0.1 + 0.2 * g.standard_normal(v.shape)).astype(
                    np.float32)
            elif k == "scale":
                t[k] = (1 + 0.2 * g.standard_normal(v.shape)).astype(
                    np.float32)
    walk(tree)
    return tree


def frames(shape, d: int, seed: int) -> np.ndarray:
    """Frame or patch embeddings (B, S, d) made from ``seed``."""
    return np.random.default_rng([FAMILY_SEED, seed]).standard_normal(
        (*shape, d), np.float32)


def grid_positions(images: int, grid) -> np.ndarray:
    """(3, images, t·h·w) positions of each image's t x h x w patches,
    row-major: patch (i, j, k) sits at (t, h, w) = (i, j, k)."""
    t, h, w = np.meshgrid(*(np.arange(n) for n in grid), indexing="ij")
    pos = np.stack([t.ravel(), h.ravel(), w.ravel()])
    return np.array(np.broadcast_to(pos[:, None], (3, images,
                                                   pos.shape[1])))


def family_prompts(vocab: int, lengths, seed: int):
    """Token prompts of ``lengths`` made from (FAMILY_SEED, ``seed``)."""
    g = np.random.default_rng([FAMILY_SEED, seed])
    return [[int(t) for t in g.integers(0, vocab, n)] for n in lengths]


def golden_xlstm_spec() -> dict:
    return {"arch": XLSTM_ARCH, "n_layers": get_config(XLSTM_ARCH).n_layers,
            "compute_dtype": "float32", "seed": FAMILY_SEED,
            "lengths": list(GOLDEN_XLSTM_LENGTHS), "slots": XLSTM_SLOTS,
            "max_new": XLSTM_MAX_NEW, "topk": LM_TOPK}


def golden_hubert_spec() -> dict:
    return {"arch": HUBERT_ARCH, "n_layers": GOLDEN_HUBERT_LAYERS,
            "compute_dtype": "float32", "seed": FAMILY_SEED,
            "frames": list(GOLDEN_HUBERT_FRAMES), "topk": LM_TOPK}


def golden_vl_spec() -> dict:
    return {"arch": QWEN_VL_ARCH, "n_layers": GOLDEN_VL_LAYERS,
            "compute_dtype": "float32", "seed": FAMILY_SEED,
            "images": VL_IMAGES, "grid": list(GOLDEN_VL_GRID),
            "decode_steps": VL_DECODE, "lengths": list(GOLDEN_VL_LENGTHS),
            "slots": len(GOLDEN_VL_LENGTHS), "max_new": VL_MAX_NEW,
            "topk": LM_TOPK}


def encode_summary(logits) -> dict:
    """The top-k ids and values of every frame's logits (B, S, V)."""
    x = to_numpy(logits)
    ids = np.argsort(-x, axis=-1, kind="stable")[..., :LM_TOPK]
    return {"top_ids": ids.tolist(),
            "top_vals": np.take_along_axis(x, ids, -1).tolist()}


def encode_err(logits, golden: dict) -> float:
    """Largest |error| of ``logits`` at the golden top-k ids."""
    ids = np.asarray(golden["top_ids"])
    return float(np.abs(np.take_along_axis(to_numpy(logits), ids, -1)
                        - np.asarray(golden["top_vals"])).max())


def vision_generate(model, cfg, embeds, positions, steps: int,
                    forced=None):
    """A vision prefill of patch embeddings (B, S, d_frontend) at (3, B,
    S) positions, then ``steps`` greedy decode steps at cache positions S,
    S + 1, ... (every stream the same, as the reference decodes). With
    ``forced`` (per call, the rows' tokens) those are fed instead of the
    model's choice. Returns calls[i] = (logits (B, V) numpy, the tokens
    chosen): the prefill's first."""
    s = embeds.shape[1]
    calls = []
    with torch.inference_mode():
        logits, cache = M.prefill(model, cfg, embeds=embeds,
                                  positions=positions, pad_to=s + steps + 1)
        for t in range(steps + 1):
            tok = logits.argmax(-1)
            calls.append((to_numpy(logits), [int(x) for x in tok.tolist()]))
            if t == steps:
                break
            if forced is not None:
                tok = torch.as_tensor(forced[t], device=logits.device)
            logits, cache = M.decode_step(model, cfg, cache, tok[:, None],
                                          s + t)
    return calls


def calls_rows(calls):
    """(per row its logits of each call, per row its tokens)."""
    rows = range(len(calls[0][1]))
    return ([[c[0][r] for c in calls] for r in rows],
            [[c[1][r] for c in calls] for r in rows])


def forced_err(steps, golden_rows) -> float:
    """Largest |error| of teacher-forced rows at the golden top-k ids,
    over every step."""
    return max(float(np.abs(row[t][ref["top_ids"][t]]
                            - ref["top_vals"][t]).max())
               for row, ref in zip(steps, golden_rows)
               for t in range(len(ref["top_ids"])))


def _mp_dropped(orig):
    """An mLSTM chunk that takes the carried stabiliser m as 0 (the
    carried C and n keep their scale)."""
    def run(carry, inp):
        c, n, m = carry
        return orig((c, n, torch.zeros_like(m)), inp)
    return run


def _c_undecayed(orig):
    """An mLSTM chunk whose chunk-end C keeps the carried C undecayed."""
    def run(carry, inp):
        (c_new, n_new, m_new), h = orig(carry, inp)
        c_p, _, m_p = carry
        decay = torch.exp(inp[4].sum(1) + m_p - m_new)
        return (c_new + (1 - decay)[..., None, None] * c_p, n_new, m_new), h
    return run


def _chunk_c_high(orig):
    """An mLSTM chunk of more than one step whose chunk-end C comes out
    XLSTM_STATE_FAULT high (the recurrent form's chunks of 1 are sound)."""
    def run(carry, inp):
        (c_new, n_new, m_new), h = orig(carry, inp)
        if inp[0].shape[1] > 1:
            c_new = c_new * (1 + XLSTM_STATE_FAULT)
        return (c_new, n_new, m_new), h
    return run


def _sigmoid_forget(orig):
    """An sLSTM step whose forget gate is sigmoid(f), not the stabilised
    exponential exp(f + m - m_new)."""
    def run(carry, g_t, rg):
        c, n, hprev, m = carry
        b, d = c.shape
        h, hd = rg.shape[:2]
        r = torch.einsum("bhd,hde->bhe", hprev.reshape(b, h, hd),
                         rg).reshape(b, 4 * d)
        gi, gf, gz, go = (g_t + r).chunk(4, dim=-1)
        m_new = torch.maximum(gf + m, gi)
        ip = torch.exp(gi - m_new)
        fp = torch.sigmoid(gf)
        c_new = fp * c + ip * torch.tanh(gz)
        n_new = fp * n + ip
        return (c_new, n_new,
                torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1e-6),
                m_new)
    return run


def _causal(orig):
    """flash_attention with the causal mask on."""
    def run(q, k, v, *, causal, window, scale):
        return orig(q, k, v, causal=True, window=window, scale=scale)
    return run


def _no_mean(orig):
    """apply_norm whose LayerNorm subtracts no mean (RMS with the bias)."""
    def run(p, x, cfg):
        return orig(p, x, cfg.replace(norm="rmsnorm"))
    return run


def _no_wo_bias(orig):
    """attn_block without wo's bias."""
    def run(p, x, cfg, kind, **kw):
        bias, p.wo.b = p.wo.b, None
        try:
            return orig(p, x, cfg, kind, **kw)
        finally:
            p.wo.b = bias
    return run


def _hw_swapped(orig):
    """apply_mrope with the h and w streams swapped."""
    def run(x, pos3, theta, sections):
        return orig(x, pos3[[0, 2, 1]], theta, sections)
    return run


def _t_stream_rope(orig):
    """plain RoPE over the t stream in place of M-RoPE."""
    def run(x, pos3, theta, sections):
        return ML.apply_rope(x, pos3[0], theta)
    return run


def _sections_rotated(orig):
    """apply_mrope with its sections rotated by one: (24, 24, 16) for the
    published (16, 24, 24)."""
    def run(x, pos3, theta, sections):
        return orig(x, pos3, theta, tuple(sections[1:]) + tuple(sections[:1]))
    return run


# Faults planted in each family's golden run, (name, patches): each must
# move the golden comparison past GOLDEN_TOL. LayerNorm is patched where
# each module looks it up.
XLSTM_FAULTS = (
    ("mLSTM without its stabiliser carry (m_p taken as 0)",
     ((rec, "_mlstm_chunk", _mp_dropped),)),
    ("sLSTM forget gate a sigmoid", ((rec, "slstm_step", _sigmoid_forget),)),
    ("mLSTM chunk-end C not decayed",
     ((rec, "_mlstm_chunk", _c_undecayed),)))
HUBERT_FAULTS = (
    ("causal attention mask", ((kops, "flash_attention", _causal),)),
    ("LayerNorm without mean subtraction",
     tuple((mod, "apply_norm", _no_mean) for mod in (MA, ML, M))),
    ("wo without its bias", ((M, "attn_block", _no_wo_bias),)))
VL_FAULTS = (
    ("h and w streams swapped", ((MA, "apply_mrope", _hw_swapped),)),
    ("plain RoPE over the t stream", ((MA, "apply_mrope", _t_stream_rope),)),
    ("M-RoPE sections (24, 24, 16)", ((MA, "apply_mrope",
                                       _sections_rotated),)))


def _golden(path, spec) -> dict:
    golden = json.loads(path.read_text())
    check(golden["spec"] == spec, f"{path.name} was made for "
          f"{golden['spec']}, not {spec}: regenerate it")
    return golden


def _check_faults(what: str, faults: dict, tol: float) -> None:
    for name, err in faults.items():
        check(err > tol, f"{what}: planted fault '{name}' passes the "
              f"{tol} limit (max |err| {err})")


def xlstm_golden(dev) -> tuple:
    """xLSTM-350M, 24 layers, f32, against golden_xlstm.json: every
    step's top-8 logits within XLSTM_TOL, the tokens equal; each of
    XLSTM_FAULTS, teacher forced with the golden tokens, past it. Then
    the consistency of the chunked and recurrent forms (XLSTM_SPLIT).
    Returns (the result, the model: the main path's weights too)."""
    golden = _golden(GOLDEN_XLSTM, golden_xlstm_spec())
    cfg = family_config(XLSTM_ARCH, golden=True)
    model, init = _init_timed(cfg, dev)
    prompts = family_prompts(cfg.vocab_size, GOLDEN_XLSTM_LENGTHS, 1)
    engine = Engine(cfg, model, EngineConfig(slots=XLSTM_SLOTS))
    counts = launch_counts()
    t0 = time.perf_counter()
    out, calls = record_generate(engine, prompts, XLSTM_MAX_NEW)
    wall = time.perf_counter() - t0
    check(launch_counts() == counts, "xLSTM launched a kernel")
    steps = per_prompt(calls, len(prompts), XLSTM_SLOTS, XLSTM_MAX_NEW)
    mine = steps_summary(out, calls, prompts, XLSTM_SLOTS, XLSTM_MAX_NEW)
    top_err, matched, compared = golden_steps_err(
        steps, mine, golden["prompts"], XLSTM_MAX_NEW, "xLSTM golden prompt",
        XLSTM_TOL)
    forced = [[row["tokens"][t] for row in golden["prompts"]]
              for t in range(XLSTM_MAX_NEW)]

    def forced_run():
        _, fcalls = record_generate(engine, prompts, XLSTM_MAX_NEW, forced)
        return forced_err(per_prompt(fcalls, len(prompts), XLSTM_SLOTS,
                                     XLSTM_MAX_NEW), golden["prompts"])
    # every step's logits, fed the golden tokens (the free run above
    # compares steps only up to the first margin under XLSTM_TOL)
    forced_sound = forced_run()
    faults = {}
    for name, patches in XLSTM_FAULTS:
        with planted(patches):
            faults[name] = forced_run()
    consist = xlstm_consistency(model, cfg, out[0])
    res = {"layers": cfg.n_layers, "compute": "float32",
           "params": cfg.n_params(), **init, "wall_s": wall,
           "top_max_abs_err": top_err, "tol": XLSTM_TOL,
           "forced_top_max_abs_err": forced_sound,
           "steps_compared": compared, "steps_matched": matched,
           "of_steps": XLSTM_MAX_NEW, "planted_faults": faults,
           "consistency": consist}
    emit({"xlstm_golden": res})
    check(max(top_err, forced_sound) <= XLSTM_TOL, f"xLSTM golden logits: "
          f"max |err| {top_err} (free), {forced_sound} (fed the golden "
          f"tokens) > {XLSTM_TOL}")
    _check_faults("xLSTM golden", faults, XLSTM_TOL)
    check(consist["decode_vs_prefill"] <= XLSTM_TOL,
          f"xLSTM: decoding on from a prefill differs from one pass: "
          f"{consist}")
    check(consist["chunked_vs_recurrent"] <= XLSTM_STATE_TOL,
          f"xLSTM: the chunked and recurrent scans differ: {consist}")
    _check_faults("xLSTM chunked vs recurrent",
                  consist["planted_fault"], XLSTM_STATE_TOL)
    del engine, calls, steps
    return res, model


def xlstm_consistency(model, cfg, seq) -> dict:
    """``seq`` prefilled to XLSTM_SPLIT and decoded the rest of the way,
    each step's logits against one pass over all of ``seq`` at the same
    position; and the first mLSTM layer's scan of the prefill in chunks of
    ``cfg.mlstm_chunk`` against chunks of 1 (the recurrent form): its
    outputs and final (C, n, m), over each one's largest |x|, sound and
    with the chunk-end C XLSTM_STATE_FAULT high."""
    toks = torch.as_tensor([seq], device=model.device)
    taken = []
    scan = rec.mlstm_scan

    def first_scan(*args):
        out = scan(*args)
        if not taken:
            taken.append(args)
        return out
    rec.mlstm_scan = first_scan
    try:
        with torch.inference_mode():
            logits, cache = M.prefill(model, cfg, tokens=toks[:, :XLSTM_SPLIT])
    finally:
        rec.mlstm_scan = scan
    with torch.inference_mode():
        got = []
        for t in range(XLSTM_SPLIT, len(seq)):
            got.append(logits)
            logits, cache = M.decode_step(model, cfg, cache,
                                          toks[:, t:t + 1], t)
        x, _, _ = M.forward(model, cfg, tokens=toks, mode="encode")
        whole = M.lm_logits(model, cfg, x[:, XLSTM_SPLIT - 1:-1])
        step_err = float((torch.stack(got, 1) - whole).abs().max())
        q, k, v, logi, logf, state, chunk = taken[0]
        h_r, st_r = scan(q, k, v, logi, logf, state, 1)

        def rel_errs():
            h_c, st_c = scan(q, k, v, logi, logf, state, chunk)
            return [float((a - b).abs().max() / b.abs().max())
                    for a, b in zip((h_c, *st_c), (h_r, *st_r))]
        rel = rel_errs()
        with planted(((rec, "_mlstm_chunk", _chunk_c_high),)):
            fault = max(rel_errs())
    return {"split": XLSTM_SPLIT, "decoded": len(seq) - XLSTM_SPLIT,
            "decode_vs_prefill": step_err, "tol": XLSTM_TOL, "chunk": chunk,
            "chunked_vs_recurrent": max(rel),
            "chunked_vs_recurrent_h_c_n_m": rel,
            "state_tol": XLSTM_STATE_TOL,
            "planted_fault": {f"chunk-end C {XLSTM_STATE_FAULT} high": fault}}


def xlstm_main(model, dev) -> dict:
    """xLSTM-350M, 24 layers, bf16 (``model``: the golden run's weights),
    one wave of XLSTM_LENGTHS through Engine.generate, timed with CUDA
    events; no kernel on this path (the mLSTM and sLSTM are torch
    operations, as the reference's are plain XLA); a profile of its
    prefill (cut to XLSTM_PROFILE_TOKENS) and decode steps, device ops
    only."""
    cfg = family_config(XLSTM_ARCH)
    prompts = family_prompts(cfg.vocab_size, XLSTM_LENGTHS, 2)
    engine = Engine(cfg, model, EngineConfig(slots=XLSTM_SLOTS))
    t0 = time.perf_counter()
    # warm-up, first-use costs: the wave's shapes but 64 tokens a row
    engine.generate([p[:64] for p in prompts], 2)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out, marks = timed_generate(engine, prompts, XLSTM_MAX_NEW)
    wall = time.perf_counter() - t0
    waves = _waves(marks, (0, 0, 0, 0), XLSTM_MAX_NEW)
    check(launch_counts() == (0, 0, 0, 0),
          f"xLSTM launched kernels: {launch_counts()}")
    generated = sum(len(o) - len(p) for o, p in zip(out, prompts))
    check(all(0 <= t < cfg.vocab_size for o in out for t in o),
          "xLSTM generated a token outside the vocabulary")
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "compute": cfg.compute_dtype, "params": cfg.n_params(),
           "warm_up_s": warm_s, "wall_s": wall, "waves": waves,
           "generated_tokens": generated, "tokens_per_s": generated / wall,
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
           "kernels": "none on this path: the mLSTM and sLSTM are torch "
                      "operations (plain XLA in the reference)"}
    emit({"xlstm_main": res})
    lm_profile(model, cfg, [p[:XLSTM_PROFILE_TOKENS] for p in prompts],
               key="xlstm_profile")
    del model, engine
    torch.cuda.empty_cache()
    return res


def hubert_golden(dev) -> dict:
    """HuBERT-XLarge at 2 layers, f32, ``encode`` of seeded frames through
    flash_attention (SIMT route) against golden_hubert.json: every
    frame's top-8 logits within GOLDEN_TOL; each of HUBERT_FAULTS past
    it."""
    golden = _golden(GOLDEN_HUBERT, golden_hubert_spec())
    cfg = family_config(HUBERT_ARCH, GOLDEN_HUBERT_LAYERS, golden=True)
    model, init = _init_timed(cfg, dev, family_tree(cfg))
    x = torch.as_tensor(frames(GOLDEN_HUBERT_FRAMES, cfg.d_frontend, 1),
                        device=dev)
    before = dict(fa.ROUTE_LAUNCHES)
    logits = M.encode(model, cfg, x)
    routes = {r: n - before[r] for r, n in fa.ROUTE_LAUNCHES.items()}
    check(routes == {"simt": cfg.n_layers, "tensor_core": 0},
          f"HuBERT golden run (f32): flash_attention launches by route "
          f"{routes}")
    err = encode_err(logits, golden)
    faults = {}
    for name, patches in HUBERT_FAULTS:
        with planted(patches):
            faults[name] = encode_err(M.encode(model, cfg, x), golden)
    res = {"layers": cfg.n_layers, "compute": "float32",
           "params": cfg.n_params(), **init,
           "frames": list(GOLDEN_HUBERT_FRAMES),
           "flash_launches_by_route": routes, "top_max_abs_err": err,
           "tol": GOLDEN_TOL, "planted_faults": faults}
    emit({"hubert_golden": res})
    check(err <= GOLDEN_TOL, f"HuBERT golden logits: max |err| {err} > "
          f"{GOLDEN_TOL}")
    _check_faults("HuBERT golden", faults, GOLDEN_TOL)
    del model
    torch.cuda.empty_cache()
    return res


def hubert_main(dev) -> dict:
    """HuBERT-XLarge, 48 layers, bf16: ``encode`` of HUBERT_FRAMES through
    flash_attention (bidirectional, hd 80, tensor-core route), timed,
    against its plain path (use_kernels=False) within HUBERT_TOL; a
    profile. Returns the flash_attention launches of one encode."""
    cfg = family_config(HUBERT_ARCH)
    t0 = time.perf_counter()
    model, init = _init_timed(cfg, dev, family_tree(cfg))
    init["init_s"] = time.perf_counter() - t0   # the tree's draws too
    x = torch.as_tensor(frames(HUBERT_FRAMES, cfg.d_frontend, 2), device=dev)
    plain_cfg = cfg.replace(use_kernels=False)
    M.encode(model, cfg, x)                    # warm-up: first-use costs
    reset_launch_counts()
    logits = M.encode(model, cfg, x)
    counts = launch_counts()
    check(counts == (cfg.n_layers, 0, cfg.n_layers, 0),
          f"HuBERT encode launches {counts}")
    plain = M.encode(model, plain_cfg, x)
    check(launch_counts() == counts, "the plain path launched a kernel")
    err = float((logits.float() - plain.float()).abs().max())
    finite = bool(torch.isfinite(logits).all())
    ms = _eager_ms(lambda: M.encode(model, cfg, x), 3)
    plain_ms = _eager_ms(lambda: M.encode(model, plain_cfg, x), 1)
    kernels, profiled_ms = _profiled(lambda: M.encode(model, cfg, x))
    busy = _device_ms_of(kernels)
    n_frames = HUBERT_FRAMES[0] * HUBERT_FRAMES[1]
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "compute": cfg.compute_dtype, "params": cfg.n_params(), **init,
           "frames": list(HUBERT_FRAMES), "logits_shape": list(logits.shape),
           "finite": finite, "kernel_vs_plain_max_abs": err,
           "tol": HUBERT_TOL, "flash_attention_launches": counts[0],
           "flash_attention_tensor_core_launches": counts[2],
           "encode_ms": ms, "plain_encode_ms": plain_ms,
           "frames_per_s": n_frames / ms * 1e3,
           "profile": {"profiled_wall_ms": profiled_ms, "device_ms": busy,
                       "device_busy_share": busy / ms,
                       "device_ops": len(kernels),
                       "flash_attention_ms": sum(
                           _device_ms_of(kernels, sym)
                           for sym in FLASH_SYMBOLS),
                       "top_device_ms": _top(kernels, 8)},
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit({"hubert_main": res})
    check(finite and tuple(logits.shape) == (*HUBERT_FRAMES, cfg.vocab_size),
          f"HuBERT logits {tuple(logits.shape)}, finite {finite}")
    check(err <= HUBERT_TOL, f"HuBERT bf16 encode, kernels vs plain: max "
          f"|err| {err} > {HUBERT_TOL}")
    del model, logits, plain
    torch.cuda.empty_cache()
    return res


def _vision_inputs(cfg, grid, seed: int, dev):
    s = int(np.prod(grid))
    return (torch.as_tensor(frames((VL_IMAGES, s), cfg.d_frontend, seed),
                            device=dev),
            torch.as_tensor(grid_positions(VL_IMAGES, grid), device=dev))


def first_layers(model, n: int):
    """``model`` with its first ``n`` layers only, sharing their
    parameters. ``init_numpy`` draws a stacked leaf's first layers as a
    shallower model's, so this is the seeded ``n``-layer model."""
    view = copy.copy(model)
    view._modules = dict(model._modules, layers=model.layers[:n])
    return view


def vl_golden(dev, deep) -> dict:
    """Qwen2-VL-72B at 1 layer (the first of ``deep``, the main path's
    model), f32, against golden_qwen2_vl.json: the vision prefill and
    VL_DECODE decode steps, and Engine.generate on token prompts, every
    step's top-8 logits within GOLDEN_TOL, the tokens equal; each of
    VL_FAULTS past it on the vision prefill."""
    golden = _golden(GOLDEN_QWEN2_VL, golden_vl_spec())
    cfg = family_config(QWEN_VL_ARCH, GOLDEN_VL_LAYERS, golden=True)
    model = first_layers(deep, GOLDEN_VL_LAYERS)
    embeds, pos = _vision_inputs(cfg, GOLDEN_VL_GRID, 1, dev)
    calls = vision_generate(model, cfg, embeds, pos, VL_DECODE)
    steps, toks = calls_rows(calls)
    vis_err, vis_matched, _ = golden_steps_err(
        steps, rows_summary(steps, toks), golden["vision"], VL_DECODE + 1,
        "Qwen2-VL golden image")
    faults = {}
    for name, patches in VL_FAULTS:
        with planted(patches):
            with torch.inference_mode():
                logits, _ = M.prefill(model, cfg, embeds=embeds,
                                      positions=pos)
        faults[name] = forced_err([[r] for r in to_numpy(logits)],
                                  [{k: v[:1] for k, v in row.items()}
                                   for row in golden["vision"]])
    prompts = family_prompts(cfg.vocab_size, GOLDEN_VL_LENGTHS, 3)
    slots = len(prompts)
    out, gcalls = record_generate(Engine(cfg, model,
                                         EngineConfig(slots=slots)),
                                  prompts, VL_MAX_NEW)
    gen_steps = per_prompt(gcalls, len(prompts), slots, VL_MAX_NEW)
    gen_err, gen_matched, _ = golden_steps_err(
        gen_steps, steps_summary(out, gcalls, prompts, slots, VL_MAX_NEW),
        golden["prompts"], VL_MAX_NEW, "Qwen2-VL golden prompt")
    res = {"layers": cfg.n_layers, "compute": "float32",
           "params": cfg.n_params(),
           "vision": {"tokens": int(embeds.shape[1]), "top_max_abs_err":
                      vis_err, "steps_matched": vis_matched,
                      "of_steps": VL_DECODE + 1},
           "generate": {"top_max_abs_err": gen_err,
                        "steps_matched": gen_matched,
                        "of_steps": VL_MAX_NEW},
           "tol": GOLDEN_TOL, "planted_faults_on_the_vision_prefill": faults}
    emit({"qwen2_vl_golden": res})
    check(max(vis_err, gen_err) <= GOLDEN_TOL, f"Qwen2-VL golden logits: "
          f"max |err| {vis_err} (vision), {gen_err} (tokens) > {GOLDEN_TOL}")
    _check_faults("Qwen2-VL golden", faults, GOLDEN_TOL)
    return res


def vl_main(model, init: dict, dev) -> dict:
    """Qwen2-VL-72B at 4 layers (``model``, built in ``init``), bf16: the
    vision prefill of VL_IMAGES images of VL_GRID patches and VL_DECODE
    decode steps through
    flash_attention (causal, GQA 8, hd 128; tensor-core route), timed,
    then its plain path and the kernel path fed the plain path's tokens
    within VL_TOL; then Engine.generate on VL_LENGTHS through
    ``kernel_vs_plain``. Returns the flash_attention launches of the
    timed vision run."""
    cfg = family_config(QWEN_VL_ARCH, VL_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    embeds, pos = _vision_inputs(cfg, VL_GRID, 2, dev)
    vision_generate(model, cfg, embeds, pos, 1)     # warm-up
    reset_launch_counts()
    start, mid, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    s = embeds.shape[1]
    with torch.inference_mode():
        start.record()
        logits, cache = M.prefill(model, cfg, embeds=embeds, positions=pos,
                                  pad_to=s + VL_DECODE + 1)
        mid.record()
        counts = launch_counts()
        for t in range(VL_DECODE):
            logits, cache = M.decode_step(model, cfg, cache,
                                          logits.argmax(-1)[:, None], s + t)
        end.record()
    torch.cuda.synchronize()
    check(counts == (cfg.n_layers, 0, cfg.n_layers, 0)
          and launch_counts() == counts,
          f"Qwen2-VL vision launches {counts} in the prefill, "
          f"{launch_counts()} after decode")
    del cache
    plain_cfg = cfg.replace(use_kernels=False)
    plain = vision_generate(model, plain_cfg, embeds, pos, VL_DECODE)
    check(launch_counts() == counts, "the plain path launched a kernel")
    forced = vision_generate(model, cfg, embeds, pos, VL_DECODE,
                             forced=[c[1] for c in plain])
    errs = [float(np.abs(a[0] - b[0]).max()) for a, b in zip(forced, plain)]
    served = kernel_vs_plain(cfg, model, family_prompts(
        cfg.vocab_size, VL_LENGTHS, 4), len(VL_LENGTHS), VL_MAX_NEW, VL_TOL)
    del served["plain_tokens"]
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "compute": cfg.compute_dtype, "params": cfg.n_params(), **init,
           "vision": {"images": VL_IMAGES, "grid": list(VL_GRID),
                      "tokens": s, "prefill_ms": start.elapsed_time(mid),
                      "decode_ms_per_step": mid.elapsed_time(end)
                      / VL_DECODE,
                      "flash_attention_launches": counts[0],
                      "flash_attention_tensor_core_launches": counts[2],
                      "forced_vs_plain_max": max(errs),
                      "forced_vs_plain_prefill": errs[0],
                      "tol": VL_TOL},
           "generate": served,
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit({"qwen2_vl_main": res})
    check(max(errs) <= VL_TOL, f"Qwen2-VL vision, kernels vs plain (teacher "
          f"forced): max |err| {max(errs)} > {VL_TOL}")
    _check_served("Qwen2-VL-72B", served)
    return res


def lm_families_path(dev) -> dict:
    """Phase 13 (module doc): xLSTM-350M, HuBERT-XLarge and Qwen2-VL-72B,
    each a golden run with planted faults and a main run at full width.
    Returns flash_attention's launches on HuBERT's and Qwen2-VL's main
    runs."""
    t0 = time.perf_counter()
    walls = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        return out
    _, model = timed("xlstm_golden", xlstm_golden, dev)
    timed("xlstm_main", xlstm_main, model, dev)
    del model
    torch.cuda.empty_cache()
    timed("hubert_golden", hubert_golden, dev)
    hubert = timed("hubert_main", hubert_main, dev)
    model, init = timed("qwen2_vl_init", _init_timed,
                        family_config(QWEN_VL_ARCH, VL_LAYERS), dev)
    timed("qwen2_vl_golden", vl_golden, dev, model)
    vl = timed("qwen2_vl_main", vl_main, model, init, dev)
    del model
    torch.cuda.empty_cache()
    return {"hubert_flash_launches": hubert["flash_attention_launches"],
            "qwen2_vl_flash_launches":
                vl["vision"]["flash_attention_launches"],
            "wall_s": time.perf_counter() - t0, "wall_s_by_run": walls}


# -- phase 14: the dry run and validate ----------------------------------------

# (a) the dry-run CLI on two cells of the 16 x 16 stand-in world; (b) and
# (c) validate of the one-card plans of a training step (phase 11's SmolLM
# batch) and a prefill (the LM main path's 4 x 3072, the kernels on), each
# held against one real step on the card under StepCost
DRYRUN_OUT = ROOT / "experiments" / "dryrun"      # the CLI's default
DRYRUN_CLI = (("--arch", "smollm-360m", "--shape", "train_4k"),
              ("--arch", "mixtral-8x7b", "--shape", "prefill_32k",
               "--flash-kernel"))
DRYRUN_VALIDATE = {
    "train": (TRAIN_ARCH, ("launch", TRAIN_SEQ, TRAIN_BATCH, "train"), False),
    "prefill": (LM_ARCH, ("prefill", LM_LENGTHS[0], LM_SLOTS, "prefill"),
                True)}
# predicted per-rank bytes against the card's max_memory_allocated
DRYRUN_MEMORY_TOL = 0.10
# smollm-360m x train_4k at 16 x 16 before the step computed its "model"
# parts (PERF.md §6, the table's earlier columns): per-rank dot FLOPs,
# peak and arguments
DRYRUN_BEFORE = {"arch": "smollm-360m", "shape": "train_4k",
                 "flops": 3.773e14, "peak_gib": 21.11, "arg_gib": 1.36}
# the dry runs' process: a world opens once per process, and it sees no
# card (nothing of it may touch the card this script measures)
DRYRUN_CODE = """
import json, sys, time
t0 = time.perf_counter()
from repro_torch.configs import get_config
from repro_torch.core import meshplanner as mp
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeSpec
spec = json.loads(sys.argv[1])
out = {"cli": []}
for argv in spec["cli"]:
    out["cli"] += dryrun.main(argv)
for name, (arch, shape, flash) in spec["validate"].items():
    shape = ShapeSpec(*shape)
    plan = mp.plan(get_config(arch), shape)
    plan.knobs.use_flash_kernel = flash
    out[name] = mp.validate(plan, shape=shape, host=True)
out["seconds"] = time.perf_counter() - t0
print("DRYRUN " + json.dumps(out))
"""


class DryRun:
    """Phase 14's dry runs, started at the script's start in a process of
    their own; ``result`` waits for them."""

    def __init__(self):
        spec = {"cli": [list(a) + ["--out", str(DRYRUN_OUT)]
                        for a in DRYRUN_CLI],
                "validate": DRYRUN_VALIDATE}
        self.log = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CODE, json.dumps(spec)],
            stdout=self.log, stderr=subprocess.STDOUT, cwd=str(ROOT),
            env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                 "CUDA_VISIBLE_DEVICES": ""})

    def result(self) -> tuple:
        """(the dry runs' records and seconds, the process's output)."""
        rc = self.proc.wait(timeout=600)
        self.log.seek(0)
        text = self.log.read()
        self.log.close()
        check(rc == 0, f"the dry runs failed (exit {rc}):\n{text[-4000:]}")
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("DRYRUN "))
        return json.loads(line[len("DRYRUN "):]), text

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def counted_leg(fn, *held) -> dict:
    """One real step on the card under StepCost: its counted dot FLOPs
    (the kernels' noted work included), bytes, arguments and live peak,
    and the allocator's peak over it; the step's wall with the counter
    on."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with StepCost() as cost:
        cost.hold(*held)
        fn()
        torch.cuda.synchronize()
    return {"flops": cost.flops, "bytes": cost.bytes,
            "arg_bytes": cost.arg_bytes, "counted_peak_bytes": cost.peak,
            "kernels": cost.kernels, "allocated_before": before,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "max_memory_reserved": torch.cuda.max_memory_reserved(),
            "wall_s": time.perf_counter() - t0}


def train_leg(trainer, model, params, opt) -> dict:
    """Leg (b): one more step of phase 11's launcher (the sharded step
    on the (1, 1) mesh) on its next batch, its last gradients freed
    first."""
    batch = trainer.put_batch(trainer.tc.steps + 8)
    model.zero_grad(set_to_none=True)

    def step():
        with set_rules(trainer.rules):
            trainer.step(model, params, opt, batch)
    return counted_leg(step, model, params, opt, batch)


def prefill_leg(model, cfg, dev) -> dict:
    """Leg (c): the prefill step (``steps.make_prefill_step``) of the LM
    main path's model on LM_SLOTS x LM_LENGTHS[0] seeded tokens, the
    kernels on."""
    g = np.random.default_rng([LM_SEED, 14])
    tokens = torch.from_numpy(g.integers(
        0, cfg.vocab_size, (LM_SLOTS, LM_LENGTHS[0])).astype(np.int32)).to(dev)
    prefill = steps_mod.make_prefill_step(cfg)

    def step():
        with torch.no_grad():
            prefill(model, {"tokens": tokens})
    return counted_leg(step, model, tokens)


def dryrun_path(dry: DryRun, legs: dict) -> dict:
    """Phase 14 (module doc): the dry runs' records, and each card leg
    against its validate record."""
    t0 = time.perf_counter()
    recs, text = dry.result()
    wait_s = time.perf_counter() - t0
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    (DRYRUN_OUT / "dryrun.log").write_text(text)
    for rec in recs["cli"]:
        emit({"dryrun_record": rec})
        check(rec["supported"] and rec["n_devices"] == 256
              and rec["flops"] > 0 and rec["total_dev_bytes"] > 0
              and all(math.isfinite(rec[k]) for k in (
                  "compute_s", "memory_s", "collective_s")),
              f"dry run of {rec['arch']} x {rec['shape']}: {rec}")
    rec = next(r for r in recs["cli"] if r["arch"] == DRYRUN_BEFORE["arch"]
               and r["shape"] == DRYRUN_BEFORE["shape"])
    now = {"flops": rec["flops"],
           "peak_gib": rec["total_dev_bytes"] / 2**30,
           "arg_gib": rec["arg_bytes"] / 2**30}
    emit({"dryrun_vs_before": {"cell": f"{rec['arch']} x {rec['shape']} "
                               f"{rec['mesh']}", "now": now,
                               "before": DRYRUN_BEFORE}})
    check(now["flops"] < DRYRUN_BEFORE["flops"]
          and now["peak_gib"] < DRYRUN_BEFORE["peak_gib"],
          f"the sharded step's dry run did not fall: {now} against "
          f"{DRYRUN_BEFORE}")
    out = {"process_s": recs["seconds"], "wait_s": wait_s, "legs": {},
           "vs_before": now}
    for name, leg in legs.items():
        rec = recs[name]
        peak = leg["max_memory_allocated"]
        err = abs(rec["total_dev_bytes"] - peak) / peak
        step_ms = 1e3 * max(rec["compute_s"], rec["memory_s"],
                            rec["collective_s"])
        out["legs"][name] = {
            "arch": rec["arch"], "mesh": rec["mesh"],
            "dry_flops": rec["flops"], "card_flops": leg["flops"],
            "dry_bytes_hbm": rec["bytes_hbm"], "card_bytes": leg["bytes"],
            "dry_total_dev_bytes": rec["total_dev_bytes"],
            "dry_arg_bytes": rec["arg_bytes"],
            "max_memory_allocated": peak,
            "max_memory_reserved": leg["max_memory_reserved"],
            "card_counted_peak_bytes": leg["counted_peak_bytes"],
            "card_arg_bytes": leg["arg_bytes"],
            "allocated_before": leg["allocated_before"],
            "memory_rel_err": err, "kernels": leg["kernels"],
            "roofline_ms": step_ms, "measured_ms": leg["measured_ms"],
            "measured_over_roofline": leg["measured_ms"] / step_ms,
            "bound": rec["bound"], "counted_step_wall_s": leg["wall_s"],
            "trace_s": rec["lower_s"]}
        check(rec["flops"] == leg["flops"],
              f"dry run {name}: {rec['flops']} dot FLOPs, the card's step "
              f"{leg['flops']}")
        check(err <= DRYRUN_MEMORY_TOL,
              f"dry run {name}: {rec['total_dev_bytes']} bytes predicted, "
              f"max_memory_allocated {peak} ({err:.3f} off)")
    out["wall_s"] = time.perf_counter() - t0
    emit({"dryrun_path": out})
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.is_file() \
            or not all(p.is_file() for p in (
                GOLDEN_LM, GOLDEN_TRAIN, GOLDEN_MOE, GOLDEN_XLSTM,
                GOLDEN_HUBERT, GOLDEN_QWEN2_VL)):
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(no src/repro_torch beside this script)", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA "
              "card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    # every comparison with a reference runs its matrix products in full
    # precision: no TF32, no reduced-precision bf16 reductions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"device": {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
                     "torch": torch.__version__, "cuda": torch.version.cuda,
                     "capability": list(torch.cuda.get_device_capability(0))}})

    laps = [("start", time.perf_counter())]     # each phase's wall, s
    dry = DryRun()                        # phase 14's dry runs, meanwhile
    try:
        return _phases(dev, laps, dry)
    finally:
        dry.stop()


def _phases(dev, laps, dry) -> int:
    """Phases 2-14 (module doc); the last line on success."""
    t0 = time.perf_counter()
    _build.build_all(["pe_simd", "flash_attention", "rglru_scan"])
    build_s = time.perf_counter() - t0
    for lib in (pe_simd._lib, fa._lib, rg._lib):
        lib()
    emit({"build": {"seconds": build_s, "arch": "sm_90a", "parallel": True,
                    "kernels": ["pe_simd", "flash_attention", "rglru_scan"]}})

    kernel = kernel_phase(dev)
    flash = flash_phase(dev)
    rglru = rglru_phase(dev)
    laps.append(("build_and_kernels", time.perf_counter()))

    golden = json.loads(GOLDEN.read_text())
    benches = programs.all_benches()
    emit({"reduced": REDUCED})
    by_shape = {}
    kernel_fn = pe_simd.pe_execute
    pe_simd.pe_execute = _counted_by_shape(kernel_fn, by_shape)
    pe_simd.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        main_path(benches, golden, dev)
        pending = fold_path(benches, golden, dev)
    finally:
        pe_simd.pe_execute = kernel_fn
    # the main path's runs only
    launches = pe_simd.LAUNCHES
    emit({"main_path": {"wall_s": time.perf_counter() - t0,
                        "runs": len(ALL_RUNS), "pe_execute_launches":
                        launches, "pe_execute_launches_by_shape": {
                            f"{W}x{L}": n for (W, L), n in by_shape.items()}}})
    check(sum(by_shape.values()) == launches,
          f"pe_execute: {sum(by_shape.values())} calls on the main path but "
          f"{launches} kernel launches")
    verify_folds(pending, dev)
    profile_phase(benches, dev)
    laps.append(("simulator", time.perf_counter()))

    serve, serve_launches, serve_shapes, serve_wall = counted_path(
        serve_path, benches, golden, dev)
    emit({"serve_path_counts": {
        "wall_s": serve_wall, "pe_execute_launches": serve_launches,
        "pe_execute_launches_by_shape": {
            f"{W}x{L}": n for (W, L), n in serve_shapes.items()}}})
    _, rounds, wall = _timed(verify_serve, *serve["pending"], dev)
    emit({"serve_checks": _rounds_line(wall, rounds)})
    emit({"serve_profile": serve_profile(benches, dev)})
    laps.append(("serving", time.perf_counter()))
    _, dse_launches, dse_shapes, dse_wall = counted_path(dse_path, dev)
    emit({"dse_path_counts": {
        "wall_s": dse_wall, "pe_execute_launches": dse_launches,
        "pe_execute_launches_by_shape": {
            f"{W}x{L}": n for (W, L), n in dse_shapes.items()}}})
    emit({"dse_profile": dse_profile(dev)})
    laps.append(("dse", time.perf_counter()))
    fleet, fleet_launches, fleet_shapes, fleet_wall = counted_path(
        fleet_path, dev)
    emit({"fleet_path_counts": {
        **_rounds_line(fleet_wall, fleet_launches),
        "ms_per_round": fleet_wall / fleet_launches * 1e3,
        "pe_execute_launches": fleet_launches,
        "pe_execute_launches_by_shape": {
            f"{W}x{L}": n for (W, L), n in fleet_shapes.items()}}})
    emit({"fleet_profile": fleet_profile(dev, fleet["devices"],
                                         fleet["trace"])})
    laps.append(("fleet", time.perf_counter()))
    _, compiler_launches, compiler_shapes, compiler_wall = counted_path(
        compiler_path, dev)
    emit({"compiler_path_counts": {
        **_rounds_line(compiler_wall, compiler_launches),
        "pe_execute_launches": compiler_launches,
        "pe_execute_launches_by_shape": {
            f"{W}x{L}": n for (W, L), n in compiler_shapes.items()}}})
    emit({"compiler_profile": compiler_profile(dev)})
    laps.append(("compiler", time.perf_counter()))
    # phase 8b, mesh_legacy_path: the mesh legs and the legacy runs, each
    # counted on its own
    _, mesh_launches, mesh_shapes, mesh_wall = counted_path(
        mesh_path, benches, golden, dev)
    _, legacy_launches, legacy_shapes, legacy_wall = counted_path(
        legacy_path, benches, golden, dev)
    emit({"mesh_legacy_path_counts": {
        name: {**_rounds_line(wall, n), "pe_execute_launches": n,
               "pe_execute_launches_by_shape": {
                   f"{W}x{L}": k for (W, L), k in shapes.items()}}
        for name, n, shapes, wall in (
            ("mesh", mesh_launches, mesh_shapes, mesh_wall),
            ("legacy", legacy_launches, legacy_shapes, legacy_wall))}})
    laps.append(("mesh_legacy", time.perf_counter()))
    path_launches = {"simulator": launches, "serve": serve_launches,
                     "dse": dse_launches, "fleet": fleet_launches,
                     "compiler": compiler_launches, "mesh": mesh_launches,
                     "legacy": legacy_launches}
    pe = pe_shapes_phase(dev, {"simulator": by_shape, "serve": serve_shapes,
                               "dse": dse_shapes, "fleet": fleet_shapes,
                               "compiler": compiler_shapes,
                               "mesh": mesh_shapes,
                               "legacy": legacy_shapes})
    laps.append(("pe_execute_shapes", time.perf_counter()))

    lm_golden(dev)
    (flash_launches, rglru_launches, _, ring_launches), prefill_cost = \
        lm_main_path(dev)
    check(ring_launches == rglru_launches,
          f"rglru_scan: {ring_launches} of {rglru_launches} launches of the "
          "LM path on the ring route")
    laps.append(("lm", time.perf_counter()))
    train = lm_train_path(dev)
    emit({"lm_train_path": {"wall_s": train["wall_s"]}})
    laps.append(("lm_train", time.perf_counter()))
    sharded = lm_train_sharded(dev, train["main"]["determinism_probe"])
    emit({"lm_train_sharded_path": {"wall_s": sharded["wall_s"]}})
    laps.append(("lm_train_sharded", time.perf_counter()))
    moe_path = lm_moe_path(dev)
    emit({"lm_moe_path": moe_path})
    laps.append(("lm_moe", time.perf_counter()))
    families = lm_families_path(dev)
    emit({"lm_families_path": families})
    laps.append(("lm_families", time.perf_counter()))
    dryrun_path(dry, {"train": train["main"]["step_cost"],
                      "prefill": prefill_cost})
    laps.append(("dryrun", time.perf_counter()))
    emit({"phase_walls": {name: t - laps[i][1]
                          for i, (name, t) in enumerate(laps[1:])}})

    emit({"kernels": [
        {"name": "pe_execute", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pe_simd.cu",
         "replaces": "src/repro/kernels/pe_simd.py:39",
         "launches": launches, "max_abs_err": max(
             kernel["max_abs_err"], pe["exact"]["max_abs_err"]),
         "ms": pe["ms"], "plain_ms": pe["plain_ms"],
         "bound_ms": pe["bound_ms"], "bound_by": pe["bound_by"],
         "library_ms": None, "shape": [1024, 64], "exact": True,
         "launch_floor_ms": pe["launch_floor_ms"],
         "path_launches": path_launches,
         "launch_weighted": pe["launch_weighted"],
         "launch_weighted_by_path": pe["launch_weighted_by_path"],
         "top_shapes": pe["top_shapes"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "routes": {"bfloat16": "tensor_core: flash_mma_kernel "
                                "(mma.sync bf16, f32 accumulate)",
                    "float32": "simt: flash_simt_kernel (f32 CUDA cores)"},
         "replaces": "src/repro/kernels/flash_attention.py:87",
         "launches": flash_launches, "max_abs_err": flash["max_abs_err"],
         "ms": flash["ms"], "plain_ms": flash["plain_ms"],
         "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
         "library_ms": flash["library_ms"], "shape": list(FLASH_PATH[:7]),
         "dtype": "bfloat16", "path_route": flash["route"],
         "path_launches": {"lm": flash_launches,
                           "moe": moe_path["flash_launches"],
                           "hubert": families["hubert_flash_launches"],
                           "qwen2_vl": families["qwen2_vl_flash_launches"]},
         **{key: {k: flash[key][k] for k in (
             "shape", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "max_abs_err", "max_row_rel_err", "tflops",
             "issued_tflops")} for key in FLASH_TIMED}},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
         "routes": {"ring": "rglru_ring_kernel (TMA ring of "
                            f"{rglru['design']['stages']} stages)",
                    "direct": "rglru_direct_kernel (one thread per "
                              "channel, loads from device memory)"},
         "replaces": "src/repro/kernels/rglru_scan.py:47",
         "launches": rglru_launches, "ring_launches": ring_launches,
         "max_abs_err": rglru["max_abs_err"],
         "ms": rglru["ms"], "plain_ms": rglru["plain_ms"],
         "bound_ms": rglru["bound_ms"], "bound_by": rglru["bound_by"],
         "library_ms": None, "shape": list(RGLRU_PATH), "dtype": "float32",
         "path_route": rglru["route"], "direct_route_ms": rglru["direct_ms"],
         "shapes": rglru["shapes"]}]})
    check(launches > 0, "the simulator's path launched no pe_execute kernel")
    check(serve_launches > 0, "the serving path launched no pe_execute")
    check(dse_launches > 0, "the DSE path launched no pe_execute")
    check(fleet_launches > 0, "the fleet path launched no pe_execute")
    check(compiler_launches > 0, "the compiler path launched no pe_execute")
    check(mesh_launches > 0, "the mesh path launched no pe_execute")
    check(legacy_launches > 0, "the legacy path launched no pe_execute")
    check(flash_launches > 0, "the LM path launched no flash_attention")
    check(moe_path["flash_launches"] > 0,
          "the MoE path launched no flash_attention")
    check(families["hubert_flash_launches"] > 0,
          "HuBERT's encode launched no flash_attention")
    check(families["qwen2_vl_flash_launches"] > 0,
          "Qwen2-VL's vision prefill launched no flash_attention")
    check(rglru_launches > 0, "the LM path launched no rglru_scan")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
