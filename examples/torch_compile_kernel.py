"""compile_kernel end to end through the PyTorch port (``repro_torch``) on
one NVIDIA card: DSL -> verified program -> DSE -> fleet.

    PYTHONPATH=src python examples/torch_compile_kernel.py
    PYTHONPATH=src python examples/torch_compile_kernel.py --device cpu

Compiles a user-written segmented reduction (a workload none of the
hand-written benches cover), differentially verifies it against the
NumPy oracle on several machines, autotunes its lowering schedule,
sweeps it through the unified DSE, and routes a small trace of it (plus
a wide compiled kernel) across the resulting Pareto front with the
serving fleet. The programs are byte-identical to the JAX package's
compiler's, and the cycles, schedules and frontiers equal its
``examples/compile_kernel.py``. Every simulator round runs the
``pe_execute`` kernel on the card; ``--device cpu`` runs its plain
PyTorch version instead.
"""
import argparse

import numpy as np

from repro_torch import dse
from repro_torch.compiler import (SMOKE_SPACE, autotune, codesign,
                                  compile_kernel, dsl, kernel_def)
from repro_torch.ggpu.engine import GGPUConfig, ScalarConfig
from repro_torch.serve import Fleet


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where it runs (default: the card; 'cpu' for the "
                         "plain PyTorch path)")
    dev = ap.parse_args(argv).device
    n, seg = 4096, 64
    k = compile_kernel(lambda a, b: ((a - b) * a).seg_sum(seg),
                       dict(a=n, b=n), name="user_segred")
    print(f"compiled {k.name}: {k.prog.shape[0]} SIMT instructions, "
          f"{k.scalar_prog.shape[0]} scalar, {k.n_items} items, "
          f"{k.mem_size} memory words")

    ins = k.random_inputs(seed=0)
    for cfg in (GGPUConfig(n_cus=1), GGPUConfig(n_cus=4)):
        info = k.verify(ins, cfg, device=dev)
        print(f"  {cfg.n_cus} CU: bit-exact vs oracle, "
              f"{info['cycles']} cycles ({info['time_us']:.1f} us)")
    info = k.verify(ins, ScalarConfig(), scalar=True, device=dev)
    print(f"  scalar baseline: bit-exact, {info['cycles']} cycles")

    # autotune the lowering schedule: every candidate verified bit-exact
    # against the default kernel's oracle, ranked by true cycles, never
    # worse than the default lowering by construction
    tuned = autotune(lambda a, b: ((a - b) * a).seg_sum(seg),
                     dict(a=n, b=n), GGPUConfig(n_cus=2),
                     name="user_segred", device=dev)
    print(f"autotune picked {tuned.best_schedule.label()}: "
          f"{tuned.best_cycles} cycles vs {tuned.default_cycles} default "
          f"({tuned.speedup:.2f}x) over {len(tuned.candidates)} candidates")
    r = autotune(*kernel_def("copy", 512), GGPUConfig(n_cus=2),
                 space=SMOKE_SPACE, name="copy", device=dev)
    print(f"  copy@512: {r.best_schedule.label()} {r.best_cycles} vs "
          f"{r.default_cycles} default (coarsening amortizes the TID "
          f"prologue)")

    # co-design: (DesignPoint, Schedule) pairs on one Pareto frontier
    cod = codesign({m: kernel_def(m, 256) for m in ("copy", "vec_mul")},
                   space=SMOKE_SPACE, cus=(1, 2),
                   freq_targets=(500.0, 667.0), device=dev)
    print("co-designed frontier (hardware point | schedule):")
    for jp in cod.frontier:
        print(f"  {jp.label():32s} {jp.point.time_us:8.2f} us  "
              f"{jp.point.area_mm2:6.2f} mm^2")

    # the compiled kernel as a first-class DSE workload
    res = dse.search(
        specs=dse.enumerate_specs(cus=(1, 2, 4),
                                  freq_targets=(500.0, 667.0)),
        evaluator=dse.Evaluator(benches=(),
                                workloads={"user_segred": k.as_bench()},
                                check=True, device=dev))
    print("DSE frontier over the compiled workload:")
    for p in res.frontier:
        print(f"  {p.label():24s} {p.time_us:8.2f} us  "
              f"{p.area_mm2:6.2f} mm^2")

    # route a mixed compiled trace across the frontier ends
    wide = compile_kernel(
        lambda x: dsl.stencil(x, [1, -2, 1], [-1, 0, 1]),
        dict(x=8 * 4096), name="laplace")
    front = sorted(res.frontier, key=lambda p: p.area_mm2)
    fleet = Fleet([(p.label(), p.point.config)
                   for p in (front[0], front[-1])], device=dev)
    w_ins = wide.random_inputs(seed=1)
    for _ in range(3):
        fleet.submit(k.prog, k.build_mem(ins), k.n_items, tag="segred")
        fleet.submit(wide.prog, wide.build_mem(w_ins), wide.n_items,
                     tag="laplace")
    results = fleet.drain()
    for r in results:
        want = (k if r.info["tag"] == "segred" else wide)
        np.testing.assert_array_equal(
            r.mem[want.out], want.reference(ins if r.info["tag"] ==
                                            "segred" else w_ins))
    print(f"fleet routed {len(results)} compiled launches bit-exactly: "
          f"{fleet.report()['placement']}")
    return {"frontier": [p.label() for p in res.frontier],
            "placement": fleet.report()["placement"]}


if __name__ == "__main__":
    main()
