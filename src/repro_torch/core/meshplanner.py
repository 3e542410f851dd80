"""MeshPlanner: GPUPlanner's DSE loop, retargeted at a training or
serving launch (the port's ``repro.core.meshplanner``).

The port plans for one card (``n_devices=1, tp=1``, its defaults here),
against the H100's constants (``roofline.analysis``); ``estimate`` and
``plan`` keep the reference's mesh arithmetic, so the tests hold them to
the reference's at 1, 8 and 256 devices. ``Knobs.apply`` sets the port's
``use_kernels`` from ``use_flash_kernel``. ``plan_all`` plans every
architecture x shape cell (the training launcher plans for its mesh,
``launch.train``). ``validate`` dry-runs a plan (``launch.dryrun``): the
counted roofline record of its cell under the plan's knobs.

The structural mapping (DESIGN.md §2):

  GPUPlanner (65nm ASIC)              MeshPlanner (a mesh of devices)
  ----------------------------------  ---------------------------------------
  spec: #CUs + frequency target       spec: arch x input shape x mesh + HBM
  first-order PPA map (spreadsheet)   first-order roofline/memory estimator
  critical path in a memory macro     per-device HBM over budget
    -> divide the macro                 -> divide the tensor: remat policy up,
                                          sequence-shard activations, FSDP the
                                          master weights, split microbatches
  critical path in logic              step time bound by a roofline term
    -> insert pipeline stage            -> microbatch pipelining (overlap
                                          reduce-scatter with compute)
  critical path in interconnect       collective term dominates
    -> STOP (wires don't pipeline)      -> re-shard (head vs seq), or accept:
                                          interconnect-bound is the
                                          mesh-level analogue

Like the paper's map, iterations run on the cheap analytic estimator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.models.config import (SHAPES, ModelConfig, ShapeSpec,
                                       cell_supported)
from repro_torch.roofline.analysis import (HBM_BW, HBM_PER_CHIP, ICI_BW,
                                           PEAK_FLOPS)


@dataclass
class Knobs:
    """The DSE action space (all appliable to dryrun/train launches)."""
    remat: str = "dots"              # none | dots | full
    fsdp: bool = True
    seq_shard: bool = True
    microbatches: int = 1
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    use_flash_kernel: bool = False   # the flash_attention kernel

    def apply(self, cfg: ModelConfig) -> ModelConfig:
        return cfg.replace(remat=self.remat, attn_q_chunk=self.attn_q_chunk,
                           attn_kv_chunk=self.attn_kv_chunk,
                           use_kernels=self.use_flash_kernel)


@dataclass
class Estimate:
    """First-order per-device model — the 'dynamic spreadsheet'."""
    params_bytes: float
    opt_bytes: float
    act_bytes: float
    total_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float

    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


@dataclass
class MapEntry:
    iteration: int
    estimate: Estimate
    bottleneck: str
    action: str


@dataclass
class MeshPlan:
    arch: str
    shape: str
    knobs: Knobs
    estimate: Estimate
    map_log: List[MapEntry] = field(default_factory=list)
    fits: bool = True
    reason: str = ""


def estimate(cfg: ModelConfig, shape: ShapeSpec, knobs: Knobs,
             n_devices: int = 1, tp: int = 1) -> Estimate:
    """Analytic per-device memory + roofline terms (documented first-order
    model; the compile-backed analyzer is ground truth)."""
    dp = n_devices // tp
    n = cfg.n_params()
    n_act = cfg.n_active_params()
    d = cfg.d_model
    train = shape.kind == "train"

    # --- parameter + optimizer bytes (f32 master; FSDP shards over dp
    # for training AND serving — the sharding rules 2-D shard weights) ---
    shard = n_devices if knobs.fsdp else tp
    params_bytes = 4.0 * n / shard
    opt_bytes = (8.0 * n / shard) if train else 0.0

    # --- activation bytes ---
    tokens_loc = shape.global_batch * shape.seq_len / dp
    if train:
        sp = tp if knobs.seq_shard else 1
        per_layer = tokens_loc / sp * d * 2.0          # bf16 residual
        remat_k = {"none": 8.0, "dots": 3.0, "full": 1.0}[knobs.remat]
        act = per_layer * cfg.n_layers * remat_k / knobs.microbatches
        # transient attention scores (the flash kernel keeps them on chip)
        if not knobs.use_flash_kernel:
            bh = shape.global_batch / dp * max(cfg.n_heads // tp, 1)
            act += bh * knobs.attn_q_chunk * min(
                knobs.attn_kv_chunk, shape.seq_len) * 4.0
    elif shape.kind == "prefill":
        act = tokens_loc * d * 2.0 * 4
    else:
        kvb = (shape.global_batch * shape.seq_len * cfg.n_kv_heads
               * cfg.hd * 2 * 2.0)
        n_attn = sum(1 for k in cfg.pattern() if k in ("attn", "swa", "local"))
        if cfg.window:
            kvb = kvb * min(1.0, cfg.window / shape.seq_len)
        act = kvb * n_attn / n_devices
    total = params_bytes + opt_bytes + act

    # --- roofline terms (model flops; HLO waste shows up in validation) ---
    if train:
        flops_dev = 6.0 * n_act * shape.global_batch * shape.seq_len / n_devices
        remat_f = 8.0 / 6.0 if knobs.remat != "none" else 1.0
        flops_dev *= remat_f
        # non-flash blocked attention computes masked pairs too (2x causal)
        attn_flops = (12.0 * shape.seq_len * cfg.n_heads * cfg.hd
                      * cfg.n_layers * shape.global_batch * shape.seq_len
                      / n_devices)
        if cfg.window:
            attn_flops *= min(1.0, 2.0 * cfg.window / shape.seq_len)
        if not knobs.use_flash_kernel:
            attn_flops *= 2.0
        flops_dev += attn_flops
        bytes_dev = (params_bytes + opt_bytes) * 3 + act * 6
        coll = (2.0 * n / tp * 2.0                      # TP all-reduces (bf16)
                + (2.0 * n / shard) * 2.0 * knobs.microbatches  # FSDP gathers
                + 4.0 * n / shard)                      # grad reduce-scatter
    else:
        toks = 1 if shape.kind == "decode" else shape.seq_len
        flops_dev = 2.0 * n_act * shape.global_batch * toks / n_devices
        bytes_dev = params_bytes / 2 + act * (2 if shape.kind == "decode" else 4)
        coll = 2.0 * n / tp * (0.25 if shape.kind == "decode" else 2.0)
    return Estimate(
        params_bytes=params_bytes, opt_bytes=opt_bytes, act_bytes=act,
        total_bytes=total,
        compute_s=flops_dev / PEAK_FLOPS,
        memory_s=bytes_dev / HBM_BW,
        collective_s=coll / n_devices / ICI_BW * 16,
    )


# ---------------------------------------------------------------------------
# the planning loop (mirrors core.planner.plan)
# ---------------------------------------------------------------------------

_MEM_ACTIONS = ("remat_dots", "remat_full", "seq_shard", "fsdp",
                "microbatch_2", "microbatch_4", "microbatch_8",
                "attn_chunk_down")


def plan(cfg: ModelConfig, shape: ShapeSpec, *, n_devices: int = 1,
         tp: int = 1, hbm_budget: float = HBM_PER_CHIP,
         step_target_s: Optional[float] = None) -> MeshPlan:
    ok, reason = cell_supported(cfg, shape)
    knobs = Knobs(remat="none" if shape.kind != "train" else "dots")
    if not ok:
        return MeshPlan(cfg.name, shape.name, knobs,
                        estimate(cfg, shape, knobs, n_devices, tp),
                        fits=False, reason=reason)
    log: List[MapEntry] = []
    it = 0
    actions = list(_MEM_ACTIONS)
    while True:
        it += 1
        est = estimate(cfg, shape, knobs, n_devices, tp)
        if est.total_bytes <= hbm_budget:
            break
        # memory over budget -> "divide the memory" (paper's move)
        applied = None
        while actions:
            a = actions.pop(0)
            if a == "remat_dots" and knobs.remat == "none":
                knobs.remat = "dots"; applied = a; break
            if a == "remat_full" and knobs.remat != "full" \
                    and shape.kind == "train":
                knobs.remat = "full"; applied = a; break
            if a == "seq_shard" and not knobs.seq_shard:
                knobs.seq_shard = True; applied = a; break
            if a == "fsdp" and not knobs.fsdp:
                knobs.fsdp = True; applied = a; break
            if a.startswith("microbatch_") and shape.kind == "train":
                m = int(a.split("_")[1])
                if m > knobs.microbatches and shape.global_batch % m == 0:
                    knobs.microbatches = m; applied = a; break
            if a == "attn_chunk_down" and knobs.attn_q_chunk > 128:
                knobs.attn_q_chunk = 128; knobs.attn_kv_chunk = 512
                applied = a; break
        if applied is None:
            log.append(MapEntry(it, est, "memory",
                                "STOP: no memory-division action left"))
            return MeshPlan(cfg.name, shape.name, knobs, est, log,
                            fits=False,
                            reason=f"{est.total_bytes/2**30:.1f} GiB > budget")
        log.append(MapEntry(it, est, "memory",
                            f"divide: {applied} "
                            f"({est.total_bytes/2**30:.1f} GiB over budget)"))
        if it > 16:
            return MeshPlan(cfg.name, shape.name, knobs, est, log, False,
                            "did not converge")

    # optional step-time loop: attack the dominant roofline term
    if step_target_s is not None:
        for _ in range(4):
            est = estimate(cfg, shape, knobs, n_devices, tp)
            step = max(est.compute_s, est.memory_s, est.collective_s)
            if step <= step_target_s:
                break
            b = est.bound()
            if b == "memory" and not knobs.use_flash_kernel:
                knobs.use_flash_kernel = True
                log.append(MapEntry(it, est, b,
                                    "enable the flash_attention kernel "
                                    "(scores stay on chip)"))
            elif b == "collective" and knobs.microbatches < 8 \
                    and shape.kind == "train" \
                    and shape.global_batch % (knobs.microbatches * 2) == 0:
                knobs.microbatches *= 2
                log.append(MapEntry(it, est, b,
                                    "insert pipeline: more microbatches to "
                                    "overlap reduce-scatter with compute"))
            else:
                log.append(MapEntry(it, est, b,
                                    "STOP: term is interconnect-bound "
                                    "(pod-level wires) — accept"))
                break
            it += 1

    est = estimate(cfg, shape, knobs, n_devices, tp)
    log.append(MapEntry(it + 1, est, "-", "plan accepted"))
    return MeshPlan(cfg.name, shape.name, knobs, est, log,
                    fits=est.total_bytes <= hbm_budget)


def validate(plan_: MeshPlan, *, shape: Optional[ShapeSpec] = None,
             multi_pod: bool = False, host: bool = False, out_dir=None):
    """'Synthesis': trace the planned cell on the meta device and return
    its counted roofline record (``dryrun.run_cell`` with the plan's
    knobs). ``shape`` stands for the plan's cell where that is not one
    of ``SHAPES``; ``host`` takes the one-device mesh, the one a plan for
    one card runs on. Needs an open world of the mesh's size
    (``dryrun.open_world``)."""
    from repro_torch.launch.dryrun import run_cell
    k = plan_.knobs
    return run_cell(plan_.arch, shape or plan_.shape, multi_pod=multi_pod,
                    host=host, remat=k.remat, microbatches=k.microbatches,
                    fsdp=k.fsdp, seq_shard=k.seq_shard,
                    use_flash_kernel=k.use_flash_kernel, out_dir=out_dir)


def plan_all(archs, shapes=None, **kw) -> Dict[str, MeshPlan]:
    """{"<arch>/<shape>": plan} over ``archs`` x ``shapes`` (names of
    ``SHAPES``, all of them by default); ``kw`` go to ``plan``."""
    from repro_torch.configs import get_config
    out = {}
    for a in archs:
        for s in (shapes or SHAPES):
            out[f"{a}/{s}"] = plan(get_config(a), SHAPES[s], **kw)
    return out
