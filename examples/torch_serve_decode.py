"""Batched serving through the PyTorch port (``repro_torch``) on one
NVIDIA card: prefill + slot-batched decode on any arch, the same
continuous-batching idea applied to G-GPU kernel launches, and the fleet
router serving a mixed trace across two DSE-selected configs.

    PYTHONPATH=src python examples/torch_serve_decode.py --arch granite-8b
    PYTHONPATH=src python examples/torch_serve_decode.py --ggpu 6
    PYTHONPATH=src python examples/torch_serve_decode.py --fleet 4
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu

On the card the LLM leg's prefill runs the ``flash_attention`` kernel
(and ``rglru_scan`` for RecurrentGemma), and every simulator round of the
other two legs the ``pe_execute`` kernel; ``--device cpu`` runs their
plain PyTorch versions. Weights are drawn by ``schema.init_numpy(cfg,
0)``. Sampling (``--temperature`` above 0) draws from a
``torch.Generator`` seeded by ``EngineConfig.seed``: the same seed gives
the same tokens, but not the JAX package's, whose ``jax.random`` draws
differ; greedy decoding (``--temperature 0``) is the same function.
"""
import argparse
import time

import numpy as np

from repro_torch import _device, dse
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.convert import params_from_reference
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import GGPUConfig
from repro_torch.models.schema import init_numpy
from repro_torch.serve import (Engine, EngineConfig, Fleet, Scheduler,
                               pinned_makespan)


def serve_llm(args, params=None):
    """The LLM leg. ``params``: a parameter tree in the reference's
    layout (``convert.params_from_reference``); ``None`` draws
    ``init_numpy(cfg, 0)``. Returns the generated tokens."""
    cfg = get_smoke(args.arch)
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode")
    tree = init_numpy(cfg, 0) if params is None else params
    model = params_from_reference(tree, cfg, _device.resolve(args.device))
    engine = Engine(cfg, model,
                    EngineConfig(slots=3, temperature=args.temperature))
    prompts = [[1, 5, 9], [2, 4], [10, 11, 12, 13], [3]]
    outs = engine.generate(prompts, max_new=args.max_new)
    for p, o in zip(prompts, outs):
        print(f"prompt {p} -> {o[len(p):]}")
    return outs


def serve_ggpu(n_requests: int, device=None):
    """A burst of G-GPU kernel launch requests served through the
    continuous-batching Scheduler: same-shape launches ride one cohort
    stepper call, and submissions interleave with incremental drains."""
    cfg = GGPUConfig(n_cus=2)
    b = programs._vec_mul(64, 2048)
    rng = np.random.default_rng(0)
    sched = Scheduler(cfg, device=device)

    def submit_burst():
        refs = {}
        for i in range(n_requests):
            mem0 = np.concatenate([
                rng.integers(-100, 100, 2 * 2048).astype(np.int32),
                np.zeros(2048, np.int32)])
            t = sched.submit(b.gpu_prog, mem0, b.gpu_items, tag=f"req{i}")
            refs[t] = b.ref(mem0, 2048)
        return refs

    submit_burst()
    # warm-up drain: it builds the kernel's library on first use, the
    # executor's first envelope (so the measured burst is a trace-cache
    # hit, as the reference's is after its jit compile) and the
    # allocator's first blocks on the device
    sched.drain()
    refs = submit_burst()
    st = sched.executor.stats
    l0, d0, h0 = st.launches, st.dispatches, st.trace_hits
    t0 = time.perf_counter()
    results = sched.drain()
    dt = time.perf_counter() - t0
    for res in results:
        t = res.info["ticket"]
        ok = np.array_equal(res.mem[b.gpu_out], refs[t])
        print(f"{res.info['tag']}: cycles={res.info['cycles']} "
              f"batch={res.info['batch_size']} correct={ok}")
    # deltas over the measured burst only (the warm-up excluded)
    dispatches = st.dispatches - d0
    print(f"served {n_requests} launches in {dt * 1e3:.1f} ms "
          f"(occupancy {(st.launches - l0) / dispatches:.1f} "
          f"launches/dispatch, trace-cache hit rate "
          f"{(st.trace_hits - h0) / dispatches:.0%}; compile excluded)")
    return results


def serve_fleet(n_bursts: int, device=None):
    """Route a mixed wide+narrow trace across the two ends of a DSE Pareto
    front and compare against pinning everything to one config."""
    res = dse.search(specs=dse.enumerate_specs(cus=(1, 8),
                                               freq_targets=(667.0,)),
                     evaluator=dse.Evaluator(benches=("xcorr",),
                                             sizes={"xcorr": (16, 128)},
                                             device=device))
    frontier = sorted(res.frontier, key=lambda p: p.time_us)
    if frontier[0] is frontier[-1]:
        raise SystemExit("DSE frontier collapsed to one design: nothing to "
                         "route across — widen the spec grid")
    devices = [(p.label(), p.point.config)
               for p in (frontier[0], frontier[-1])]
    print("fleet devices:", " + ".join(name for name, _ in devices))

    wide = programs._copy(16, 1024)          # W=16: wants CUs
    narrow = programs._reduction(64, 256)    # W=1: wants clock
    rng = np.random.default_rng(0)
    trace = []
    for _ in range(n_bursts):
        for b in (wide, narrow):
            mem0 = rng.integers(-50, 50, b.gpu_mem.shape[0]).astype(np.int32)
            trace.append((b.gpu_prog, mem0, b.gpu_items))

    fleet = Fleet(devices, device=device)
    for prog, mem0, n_items in trace:
        fleet.submit(prog, mem0, n_items)
    fleet.drain()
    rep = fleet.report()
    print(f"placement: {rep['placement']}")
    print(f"fleet makespan: {rep['makespan_us']:.1f} us (modeled)")
    for name, cfg in devices:
        print(f"pinned to {name}: "
              f"{pinned_makespan(cfg, trace, device=device):.1f} us")
    return rep


def main(argv=None, *, params=None):
    """``params``: the LLM leg's weights (see ``serve_llm``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_IDS)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--ggpu", type=int, default=0, metavar="N",
                    help="serve N G-GPU kernel launches instead of LLM decode")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve N mixed bursts across a 2-config DSE fleet")
    ap.add_argument("--device", default=None,
                    help="where it runs (default: the card; 'cpu' for the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    if args.fleet:
        return serve_fleet(args.fleet, args.device)
    if args.ggpu:
        return serve_ggpu(args.ggpu, args.device)
    return serve_llm(args, params)


if __name__ == "__main__":
    main()
