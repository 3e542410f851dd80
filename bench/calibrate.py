"""The readings a cell's limit is set from, on the card, in one process.

    python3 bench/calibrate.py --workload granite-8b.code \
        --seeds 11,12,13 --control-seeds 11,12,13 [--check-requests 48]

For each seed: the cell's weights, its engine and its traffic, served
through ``Engine.generate`` at the cell's own slots and lengths until the
window holds as many requests as a run compares and a wave at the mix's
longest padded length; then the number a run compares,
the numbers a run with that seed reads (``check.summarize``) over the
same sample, and each sampled request's own. ``--check-requests`` reads
a sample of another size than the cell's limits file sets (as many as a
window serves, to see how the number spreads from request to request).
For
each control seed, also the control's reading: the float8 reference
(``Decoder(precision="fp8")``) put in the program's place, the gap of
the token it ranks first at each of the same positions. One JSON line a
seed on standard output. The benchmark's runs do not run this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(root: Path, cell: str, seeds, control_seeds=(),
             compute_dtype: str = "", check_requests: int = 0):
    """Yield one dict of readings a seed (module doc). ``compute_dtype``
    serves the program in another compute type than the configuration's
    (a witness: in float32 it should agree with the reference);
    ``check_requests``, where set, the sample's size."""
    import torch
    from bench import check, harness, system, traffic, weights as W
    from bench.reference.decoder import Decoder

    spec = harness.load_spec(root)
    _, arch, mix = harness.cell_files(root, spec, cell)
    limits = json.loads((root / "bench" / "limits" / f"{cell}.json")
                        .read_text())
    margin = limits.get("router_margin", 0.0)
    k = check_requests or limits["check_requests"]
    system.load(root)
    longest = traffic.longest_wave(mix)
    for seed in seeds:
        t0 = time.perf_counter()
        weights = W.make(arch, seed, "cuda")
        engine, _ = system.build(
            {**arch, "compute_dtype": compute_dtype or arch["compute_dtype"]},
            weights, mix["slots"], seed)
        waves = []
        for prompts in traffic.Traffic(mix, seed, arch["vocab_size"]):
            waves += harness.serve(engine, [prompts], mix["new_tokens"],
                                   float("inf"))[0]
            if (sum(len(w.prompts) for w in waves) >= k
                    and max(w.padded for w in waves) == longest):
                break
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        check.reference_setup()
        ref = Decoder(weights, arch)
        reqs = check.requests(waves)
        pick = check.sample(reqs, k, seed)

        def per_request(control=None):
            return [check.gaps(ref, reqs[i][0], reqs[i][1][len(reqs[i][0]):],
                               reqs[i][2], control) for i in pick]
        prog = per_request()
        t2 = time.perf_counter()
        line = {"seed": seed, "requests": len(reqs), "waves": len(waves),
                "bad_outputs": sum(not check.served_ok(p, o,
                                                       mix["new_tokens"])
                                   for p, o, _ in reqs),
                **_summary(prog, "", margin),
                "serve_s": t1 - t0, "reference_s": t2 - t1}
        if seed in control_seeds:
            ctrl = per_request(Decoder(weights, arch, precision="fp8"))
            line.update(**_summary(ctrl, "control_", margin),
                        control_s=time.perf_counter() - t2)
        yield line
        del weights, ref
        gc.collect()
        torch.cuda.empty_cache()


def _summary(per_request, prefix: str, margin: float) -> dict:
    """What a run reads (``check.summarize``), with each request's mean
    and widest gap and the share of served tokens whose gap is above 0."""
    from bench import check
    out = {prefix + k: v
           for k, v in check.summarize(per_request, margin).items()}
    gaps = [g for g, _ in per_request]
    out[prefix + "request_means"] = [float(g.mean()) for g in gaps]
    out[prefix + "request_worst"] = [float(g.max()) for g in gaps]
    decided = [g if m is None else g[m >= margin] for g, m in per_request]
    out[prefix + "request_decided_sum"] = [float(g.sum()) for g in decided]
    out[prefix + "request_decided_n"] = [int(g.numel()) for g in decided]
    out[prefix + "share_nonzero"] = float(
        sum(int((g > 0).sum()) for g in gaps) / sum(g.numel() for g in gaps))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--compute-dtype", default="")
    ap.add_argument("--check-requests", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for line in readings(ROOT, args.workload, seeds, controls,
                         args.compute_dtype, args.check_requests):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
