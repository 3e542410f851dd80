"""Run the paper's micro-benchmarks on the simulated G-GPU, through the
PyTorch port (``repro_torch``) on one NVIDIA card.

The launch goes through the ``LaunchQueue`` API (``repro_torch.serve``):
submit a ticket, flush, read the result; then the bench's scalar
(RISC-V) program runs through ``run_kernel``. Every round's execute
stage is the ``pe_execute`` CUDA kernel on the card; ``--device cpu``
runs its plain PyTorch version instead. Cycles, cache hits and misses
are exact: they equal the JAX package's ``examples/ggpu_simulate.py``.

    PYTHONPATH=src python examples/torch_ggpu_simulate.py --kernel mat_mul --cus 4
    PYTHONPATH=src python examples/torch_ggpu_simulate.py --kernel fir \
        --cus 8 --memsys banked
    PYTHONPATH=src python examples/torch_ggpu_simulate.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.ggpu.engine import (MEMSYS_REGISTRY, GGPUConfig,
                                     ScalarConfig, run_kernel)
from repro_torch.ggpu.programs import all_benches
from repro_torch.serve import LaunchQueue


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="mat_mul",
                    choices=sorted(all_benches()))
    ap.add_argument("--cus", type=int, default=4, choices=(1, 2, 4, 8))
    ap.add_argument("--memsys", default="shared",
                    choices=sorted(MEMSYS_REGISTRY))
    ap.add_argument("--fuse", type=int, default=4,
                    help="rounds retired per host check")
    ap.add_argument("--device", default=None,
                    help="where the simulator runs (default: the card; "
                         "'cpu' for the plain PyTorch path)")
    args = ap.parse_args(argv)

    b = all_benches()[args.kernel]
    cfg = GGPUConfig(n_cus=args.cus, memsys=args.memsys, fuse=args.fuse)
    print(f"kernel={args.kernel} items={b.gpu_items} CUs={args.cus} "
          f"memsys={args.memsys}")
    queue = LaunchQueue(cfg, device=args.device)
    ticket = queue.submit(b.gpu_prog, b.gpu_mem, b.gpu_items,
                          tag=args.kernel)
    mem, info = queue.flush()[ticket]
    ok = np.array_equal(mem[b.gpu_out], b.ref(b.gpu_mem, b.gpu_n))
    print(f"G-GPU : {info['cycles']:>9d} cycles "
          f"({info['time_us']:.1f} us @500MHz)  "
          f"cache hits/misses={info['hits']}/{info['misses']}  correct={ok}")
    mem, si = run_kernel(b.scalar_prog, b.scalar_mem, 1, ScalarConfig(),
                         device=args.device)
    ok_scalar = np.array_equal(mem[b.scalar_out],
                               b.ref(b.scalar_mem, b.scalar_n))
    print(f"RISC-V: {si['cycles']:>9d} cycles (input {b.scalar_n} vs "
          f"{b.gpu_n})  correct={ok_scalar}")
    ratio = b.gpu_n / b.scalar_n
    print(f"paper-style speed-up (input-scaled): "
          f"{si['cycles'] * ratio / info['cycles']:.1f}x")
    return {"gpu": info, "scalar": si, "correct": ok and ok_scalar}


if __name__ == "__main__":
    main()
