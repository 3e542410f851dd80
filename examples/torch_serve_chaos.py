"""Deterministic chaos serving through the PyTorch port (``repro_torch``)
on one NVIDIA card: replay a fault scenario against a self-healing fleet
and check every served result against the fault-free oracle.

A ``FAULTS`` scenario bundles a seed-keyed :class:`FaultPlan` (SEU bit
flips, stragglers, wedged devices) with the resilience machinery that
answers it — checksum audits + bounded retries, executor timeouts,
eviction, and deadline-aware hedging. Same seed, same trace => the
byte-identical injection decision log and the same served bits (the JAX
package's ``examples/serve_chaos.py`` logs the same decisions). Every
simulator round runs the ``pe_execute`` kernel on the card;
``--device cpu`` runs its plain PyTorch version instead.

    PYTHONPATH=src python examples/torch_serve_chaos.py
    PYTHONPATH=src python examples/torch_serve_chaos.py --faults device-loss
    PYTHONPATH=src python examples/torch_serve_chaos.py --faults straggler --n 12
    PYTHONPATH=src python examples/torch_serve_chaos.py --device cpu
"""
import argparse
import collections
import time

import numpy as np

from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import GGPUConfig, run_kernel
from repro_torch.registry import FAULTS
from repro_torch.serve import Fleet, Request, result_checksum


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--faults", default="seu", metavar="SCENARIO",
                    help="FAULTS scenario to replay (default seu; see "
                         "`python -m repro_torch.registry --json`)")
    ap.add_argument("--n", type=int, default=16, metavar="N",
                    help="requests to serve under chaos (default 16)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=None,
                    help="override the scenario's injection rate")
    ap.add_argument("--device", default=None,
                    help="where it runs (default: the card; 'cpu' for the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    b = programs._vec_mul(16, 64)
    cfg = GGPUConfig(n_cus=2)
    rng = np.random.default_rng(args.seed)
    mems = [rng.integers(-30, 30, b.gpu_mem.shape[0]).astype(np.int32)
            for _ in range(args.n)]
    refs = [run_kernel(b.gpu_prog, m, b.gpu_items, cfg,
                       device=args.device)[0] for m in mems]

    kw = {} if args.rate is None else {"rate": args.rate}
    if args.faults == "device-loss":
        kw["stuck_after"] = 0            # dev0 wedges on its 1st dispatch
    elif args.faults == "straggler" and args.rate is None:
        kw["rate"] = 0.5                 # demo-sized trace: make it land
    sc = FAULTS.get(args.faults)(seed=args.seed, **kw)
    fleet = Fleet([("dev0", cfg), ("dev1", GGPUConfig(n_cus=1))],
                  max_batch=2, device=args.device, **sc.fleet_kwargs())
    for m, ref in zip(mems, refs):
        # the audit is what makes post-compute corruption detectable
        audit = result_checksum(ref) if sc.audit else None
        fleet.submit_request(Request(b.gpu_prog, m, b.gpu_items,
                                     audit=audit))

    t0 = time.perf_counter()
    results = fleet.drain()
    wall = time.perf_counter() - t0

    served_ok = sum(np.array_equal(r.mem, refs[r.info["ticket"]])
                    for r in results)
    kinds = collections.Counter(e[0] for e in sc.decision_log())
    rep = fleet.report()
    print(f"scenario {args.faults!r} seed {args.seed}: "
          f"{len(results)}/{args.n} served in {wall * 1e3:.1f} ms")
    print(f"  injected: {dict(kinds) or 'nothing'}")
    print(f"  bit-exact vs fault-free oracle: {served_ok}/{len(results)}")
    print(f"  quarantined: {sorted(fleet.quarantined) or 'none'}")
    print(f"  devices: {rep['device_state']}  health {rep['health']}")
    print(f"  reroutes {rep.get('reroutes', 0)}, "
          f"hedged {rep.get('hedged', 0)}")
    # determinism: the decision log is a pure function of (seed, plan,
    # trace) — rerun with the same --seed and diff this line
    print(f"  decision log ({len(sc.decision_log())} entries): "
          f"{sc.decision_log()[:3]}{' ...' if kinds.total() > 3 else ''}")
    return {"served": len(results), "bit_exact": served_ok,
            "quarantined": sorted(fleet.quarantined),
            "decision_log": sc.decision_log(), "report": rep}


if __name__ == "__main__":
    main()
