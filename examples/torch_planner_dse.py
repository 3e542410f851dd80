"""GPUPlanner + unified DSE + MeshPlanner walkthrough, through the
PyTorch port (``repro_torch``) on one NVIDIA card.

Runs the paper's analytic map, then the port's unified ``dse``
subsystem: a joint analytic+cycle-accurate Pareto search that shows
which free-pipelining (analytic-only) picks the simulator rejects. Every
simulator round runs the ``pe_execute`` kernel on the card;
``--device cpu`` runs its plain PyTorch version instead. Last, the same
planning loop sizes three LM cells for a 16 x 16 mesh of H100s (the
port's MeshPlanner carries the H100's data-sheet constants).

    PYTHONPATH=src python examples/torch_planner_dse.py
    PYTHONPATH=src python examples/torch_planner_dse.py --device cpu
"""
import argparse

from repro_torch import dse
from repro_torch.configs import get_config
from repro_torch.core import meshplanner
from repro_torch.core.planner import enumerate_versions, plan
from repro_torch.models.config import SHAPES

MESH = (256, 16)          # (cards, tensor-parallel width): 16 x 16


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the simulator runs (default: the card; "
                         "'cpu' for the plain PyTorch path)")
    dev = ap.parse_args(argv).device

    print("=== GPUPlanner: the paper's map (1 CU @ 667 MHz) ===")
    p = plan(1, 667.0)
    for e in p.map_log:
        print(f"  it{e.iteration}: fmax={e.fmax_mhz:6.0f} MHz "
              f"bottleneck={e.bottleneck:22s} -> {e.action}")
    r = p.version.report()
    print(f"  result: {r['total_area_mm2']} mm^2, {r['n_memory']} memory "
          f"blocks, {r['total_w']} W")

    print("\n=== the paper's failure case: 8 CU @ 667 MHz ===")
    p8 = plan(8, 667.0)
    print(f"  achieved={p8.achieved}: {p8.reason}")

    print("\n=== the 12-version Table I sweep ===")
    for pv in enumerate_versions():
        r = pv.version.report()
        print(f"  {r['n_cus']}CU: fmax={r['fmax_mhz']:6.1f} "
              f"area={r['total_area_mm2']:6.2f}mm^2 mem={r['n_memory']:3d} "
              f"power={r['total_w']:5.2f}W")

    print("\n=== third DSE axis: cache organization (xcorr, reduced) ===")
    for (c, ms), info in dse.sweep_memsys(bench="xcorr", n_cus=(1, 8),
                                          sizes=(32, 256),
                                          device=dev).items():
        print(f"  {c}CU {ms:10s}: {info['cycles']:>7d} cycles "
              f"hits/misses={info['hits']}/{info['misses']}")

    print("\n=== unified DSE: joint analytic+cycle-accurate Pareto search ===")
    specs = dse.enumerate_specs(cus=(1, 2), freq_targets=(500.0, 667.0,
                                                          750.0))
    res = dse.search(specs=specs,
                     evaluator=dse.Evaluator(benches=("xcorr",),
                                             sizes={"xcorr": (16, 128)},
                                             device=dev))
    for p, row in zip(res.points, res.report()):
        mark = ("*" if row["on_frontier"] else
                "x" if row["on_analytic_frontier"] else " ")
        print(f"  {mark} {p.label():22s} time={p.time_us:7.1f}us "
              f"(analytic {p.analytic_time_us:6.1f}us) "
              f"area={p.area_mm2:5.2f}mm^2 energy={p.energy_uj:6.1f}uJ")
    print("  * = Pareto frontier; x = analytic-only pick rejected by the")
    print("      cycle model (free-pipelining assumption; see DESIGN.md)")

    cards, tp = MESH
    print(f"\n=== MeshPlanner: same loop, {cards // tp} x {tp} mesh of "
          f"H100s ({cards} cards) ===")
    for arch, shape in [("qwen2-vl-72b", "train_4k"),
                        ("mixtral-8x7b", "train_4k"),
                        ("granite-8b", "decode_32k")]:
        mp = meshplanner.plan(get_config(arch), SHAPES[shape],
                              n_devices=cards, tp=tp,
                              hbm_budget=meshplanner.HBM_PER_CHIP)
        e = mp.estimate
        print(f"  {arch} x {shape}: fits={mp.fits} knobs=(remat={mp.knobs.remat},"
              f" mb={mp.knobs.microbatches}, fsdp={mp.knobs.fsdp}) "
              f"est {e.total_bytes/2**30:.1f} GiB, bound={e.bound()}")
        for ent in mp.map_log[:-1]:
            print(f"      it{ent.iteration}: {ent.action}")
    return res


if __name__ == "__main__":
    main()
