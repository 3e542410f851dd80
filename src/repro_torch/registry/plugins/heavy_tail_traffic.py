"""Heavy-tailed arrival pattern — a drop-in traffic plugin.

The port's copy of the reference's plugin: lognormal
inter-arrival gaps (sigma ~ 1.3) produce occasional very long idle
stretches followed by tight clumps — heavier-tailed than ``poisson``
but, unlike ``bursty``, never exactly simultaneous, so the
continuous-batching scheduler sees ragged partial cohorts instead of
clean full ones. Registered here, it appears in the registry smoke and
in every traffic sweep with no other edit.
"""
import numpy as np

from repro_torch.registry import TRAFFIC


@TRAFFIC.register("heavy-tail")
def heavy_tail_arrivals(n: int, seed: int = 0,
                        median_gap_s: float = 0.004,
                        sigma: float = 1.3) -> np.ndarray:
    """``n`` arrival times with lognormal inter-arrival gaps (median
    ``median_gap_s``, shape ``sigma``). Deterministic per seed."""
    if median_gap_s <= 0:
        raise ValueError("median_gap_s must be > 0")
    rng = np.random.default_rng(seed)
    gaps = rng.lognormal(mean=np.log(median_gap_s), sigma=sigma,
                         size=int(n))
    return np.cumsum(gaps)
