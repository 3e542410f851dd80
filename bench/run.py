"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload granite-8b.code --seed 7 --seconds 50 \
        --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the program's ``src/``. The last line on standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``, each
number checked beside its limit; those numbers are also the last lines
on standard error. Exits non-zero with no result line when the card or
the program is missing, when fewer cards are present than the cell asks
for, or when JAX or the JAX package was loaded.

Build and kernel caches stay inside the checkout at fixed paths: the
program's kernels in ``src/repro_torch/kernels/build/``, and PyTorch's
and Triton's caches under ``.bench_cache/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[0] = str(ROOT)       # the checkout, not bench/ itself
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in spec["workloads"]
                 if w["name"] == args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from bench import harness
    try:
        result = harness.run_cell(ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  t_start=T_START)
    except harness.ForeignModules as e:
        print(e, file=sys.stderr)
        return 3
    foreign = harness.foreign_modules()
    if foreign:
        print("modules of JAX or the JAX package are loaded: "
              + ", ".join(foreign), file=sys.stderr)
        return 3
    print("card:", harness.power_limit(), file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
