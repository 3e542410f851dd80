"""Device-resident kernel graphs through the PyTorch port (``repro_torch``)
on one NVIDIA card: serve a multi-kernel DAG with zero host round-trips
between stages.

``compile_graph`` splits a traced expression at reduction boundaries
into a 3-stage ``Program`` (map -> segmented reduce -> scale); the
scheduler's dependency-aware planner then folds every instance's stage
into one cohort dispatch and feeds each producer's still-device-resident
output straight into its consumer's staged buffer. The same chains run
again stage-by-stage through the pre-graph idiom (full image download +
host re-staging per edge) for comparison. Every simulator round runs the
``pe_execute`` kernel on the card; ``--device cpu`` runs its plain
PyTorch version instead.

    PYTHONPATH=src python examples/torch_serve_graph.py
    PYTHONPATH=src python examples/torch_serve_graph.py --instances 16 --fleet
    PYTHONPATH=src python examples/torch_serve_graph.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.compiler import compile_graph
from repro_torch.ggpu.engine import GGPUConfig
from repro_torch.serve import (Fleet, Scheduler, extract_outputs,
                               run_chains_host_staged, run_program,
                               submit_programs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--instances", type=int, default=8, metavar="N",
                    help="independent chains to pipeline (default 8)")
    ap.add_argument("--fleet", action="store_true",
                    help="also route the graph through a 2-device Fleet "
                         "(stages co-locate on one device)")
    ap.add_argument("--device", default=None,
                    help="where it runs (default: the card; 'cpu' for the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    n, seg = 256, 64
    program = compile_graph(lambda a, b: (a * b).seg_sum(seg) * 3 + 1,
                            {"a": n, "b": n}, name="map_reduce_scale")
    print(f"{program.name}: {len(program.stages)} stages "
          f"({' -> '.join(ck.name for ck in program.stages)})")

    rng = np.random.default_rng(0)
    instances = [{"a": rng.integers(-50, 50, n).astype(np.int32),
                  "b": rng.integers(-50, 50, n).astype(np.int32)}
                 for _ in range(args.instances)]
    refs = [program.reference(inp) for inp in instances]

    cfg = GGPUConfig(n_cus=2)
    pipe = Scheduler(cfg, max_batch=args.instances, max_inflight=8,
                     device=args.device)
    staged = Scheduler(cfg, max_batch=args.instances, max_inflight=8,
                       device=args.device)

    # warm-up on both paths: the kernel's library, each executor's
    # envelopes and the allocator's first blocks on the device
    submit_programs(pipe, program, instances)
    pipe.drain()
    run_chains_host_staged(staged, program, instances)

    st = pipe.executor.stats
    d0 = st.dispatches
    t0 = time.perf_counter()
    handles = submit_programs(pipe, program, instances)
    outs = extract_outputs(pipe.drain(), handles)
    t_pipe = time.perf_counter() - t0

    t0 = time.perf_counter()
    outs_staged = run_chains_host_staged(staged, program, instances)
    t_staged = time.perf_counter() - t0

    ok = all(np.array_equal(o, r) and np.array_equal(s, r)
             for o, s, r in zip(outs, outs_staged, refs))
    launches = args.instances * len(program.stages)
    print(f"pipelined:   {t_pipe * 1e3:7.2f} ms  "
          f"({st.dispatches - d0} dispatches for {launches} launches)")
    print(f"host-staged: {t_staged * 1e3:7.2f} ms  "
          f"({launches} dispatches, full download per edge)")
    print(f"speedup {t_staged / t_pipe:.2f}x, bit-exact vs reference: {ok}")

    if args.fleet:
        fleet = Fleet([("wide", GGPUConfig(n_cus=8)),
                       ("narrow", GGPUConfig(n_cus=1))], device=args.device)
        out = run_program(fleet, program, instances[0])
        print(f"fleet: co-located chain bit-exact: "
              f"{np.array_equal(out, refs[0])} "
              f"(learned service times: {len(fleet._learned)} keys)")
        ok = ok and np.array_equal(out, refs[0])
    return {"bit_exact": ok, "stages": len(program.stages),
            "dispatches": st.dispatches - d0}


if __name__ == "__main__":
    main()
