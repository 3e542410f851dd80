"""The recurrent mixers' "acts_ffn" split in the sharded train step, on 2
and 4 gloo ranks on the CPU (``tests/_sharded_ranks.py``):
RecurrentGemma-2B (RG-LRU) and xLSTM-350M (mLSTM and sLSTM) SMOKE,
batch 4 x 32 tokens, 3 steps at lr 1e-3.

* At (1, 2), (2, 2) and (1, 4), in float64 throughout
  (``_sharded_ranks.Float64``), against the one-device step from the
  same weights and batches: losses, grad norms, every gradient, the
  parameters and both moments, at the bounds of
  ``tests/test_torch_sharded_train.py`` (they read ~1e-13 of each
  tensor's largest and ~1e-10 x lr). The SMOKE widths divide both axes
  (dr 64; d 64, de 128, 2 heads), so no width is overridden for these:
  at (1, 2) and (2, 2) the mLSTM runs on each rank's head, at (1, 4) on
  whole heads (2 heads on 4 ranks), each rank keeping its channels of
  the head-normed output. Two overridden widths take the fallback
  (``ctx.whole_block``) where the rules leave a weight unsplit: RG-LRU
  at ``lru_width`` 66 on (1, 4) (66 does not divide 4: the block runs
  whole), and xLSTM at ``d_model`` 66 on (1, 4), whose sLSTM ``wo``
  (66 x 66) stays unsplit while its mLSTM (de 132) splits.
* Each rank's dot FLOPs at (1, 4), counted by ``StepCost`` over one
  step, against the one-device step (the split path taken, not the
  fallback: at most 0.30 of it for RecurrentGemma and 0.45 for xLSTM)
  and against the reference's ``HloCost`` of its partitioned step on
  (1, 4) forced host devices (``tests/test_torch_tp_hlo.py``'s
  subprocess, remat full, f32). RecurrentGemma-2B equals it. xLSTM-350M
  has two gaps, named and bounded:
    - the sLSTM recurrence: ``slstm_step`` reshapes (B, H, 4 hd) to (B,
      4 d) before splitting i|f|z|o, so each gate of a channel reads
      other heads' h_{t-1}; the port runs the recurrence whole on every
      rank, with no collective inside its step loop, where XLA splits
      the per-step product (B, H, hd) x (H, hd, 4 hd) over the ranks
      and exchanges the carry every step. The port runs it 5 S' - 1
      times (S' the steps padded to whole isqrt(S) blocks: the forward,
      the unit's and the block's recomputes and two gradients, none for
      the zero initial state), XLA 5 S' times on a quarter: 8,536,064
      FLOPs, 6.18 % of the reference's count (bound 6.5 %);
    - the mLSTM's autograd: at one device too, PyTorch's backward
      issues one (B H, c, hd) x (hd, hd) product and six reductions of
      (B, c, H, hd) over hd a layer more than XLA's, 2 B H c hd (hd + 6)
      = 573,440 FLOPs a layer (c the chunk), 1.25 % of the reference's
      count over the three mLSTM layers (bound 1.3 %).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _sharded_ranks as ranks
from repro_torch.configs import get_smoke
from test_torch_sharded_train import BOUNDS, TOL, _close_scaled
from test_torch_tp_hlo import JAX_COST

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("recurrentgemma-2b", "xlstm-350m")
TP, ROWS = 4, 4
FLOPS_SHARE = {"recurrentgemma-2b": 0.30, "xlstm-350m": 0.45}
SLSTM_GAP_BOUND = 0.065         # of the reference's count (read 6.18 %)
MLSTM_GAP_BOUND = 0.013         # (read 1.25 %)

CASES = ([(f"{m[0]}x{m[1]}/{a}", dict(arch=a, mesh=m, f64=True))
          for m in ((1, 2), (2, 2), (1, 4)) for a in ARCHS]
         + [("1x4/lru66/recurrentgemma-2b", dict(
             arch="recurrentgemma-2b", mesh=(1, 4), f64=True,
             overrides={"lru_width": 66})),
            ("1x4/d66/xlstm-350m", dict(
                arch="xlstm-350m", mesh=(1, 4), f64=True,
                overrides={"d_model": 66}))])
COUNTS = [(f"1x4/count/{a}", dict(arch=a, mesh=(1, TP), rows=ROWS,
                                  n_steps=1, count=True)) for a in ARCHS]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's per-device counts (a subprocess of 4 forced host
    devices), a world of 4 ranks and one of 2, all started together."""
    tmp = tmp_path_factory.mktemp("tp_recurrent")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={TP}"}
    ref = subprocess.Popen(
        [sys.executable, "-c", JAX_COST, ",".join(ARCHS), str(TP),
         str(ROWS), str(ranks.SEQ)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def on(n):
        return [(name, "steps", kw) for name, kw in CASES + COUNTS
                if kw["mesh"][0] * kw["mesh"][1] == n]
    try:
        started = [ranks.start(4, on(4), tmp / "world4"),
                   ranks.start(2, on(2), tmp / "world2")]
        res = {}
        for world in started:
            res.update(ranks.collect(world))
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    res["hlo"] = json.loads(out.strip().splitlines()[-1])
    return res


@pytest.mark.parametrize("name", [n for n, _ in CASES])
def test_recurrent_split_matches_one_device(worlds, name):
    res = worlds[name]
    got, want = res["sharded"]["state"], res["one_device"]["state"]
    grad_tol, norm_tol = BOUNDS.get(name.split("/")[-1], (TOL, 1e-6))
    for a, b in zip(res["sharded"]["metrics"], res["one_device"]["metrics"],
                    strict=True):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=norm_tol)
        assert a["lr"] == b["lr"]
    for step, (a, b) in enumerate(zip(res["sharded"]["grads"],
                                      res["one_device"]["grads"],
                                      strict=True)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _close_scaled(x, y, grad_tol, f"step {step} grad {i}")
    for n in want["params"]:
        np.testing.assert_allclose(got["params"][n].numpy(),
                                   want["params"][n].numpy(), rtol=0,
                                   atol=1e-2 * ranks.LR, err_msg=n)
        for key in ("m", "v"):
            _close_scaled(got[key][n], want[key][n], 5e-5, f"{key} {n}")
    assert res["sharded"]["blocks"]


def _xlstm_gaps():
    """(the sLSTM recurrence's gap, the mLSTM autograd's) per device at
    (1, TP) (module doc)."""
    cfg = get_smoke("xlstm-350m")
    b, s, d, h = ROWS, ranks.SEQ, cfg.d_model, cfg.n_heads
    hd = d // h
    blk = int(s ** 0.5)
    steps = -(-s // blk) * blk                      # padded to whole blocks
    step = 2 * b * h * hd * 4 * hd
    n_s = cfg.pattern().count("slstm")
    slstm = n_s * (step * (5 * steps - 1) - 5 * steps * step // TP)
    hd_m = 2 * d // h
    c = cfg.mlstm_chunk
    mlstm = cfg.pattern().count("mlstm") * 2 * b * h * c * hd_m * (hd_m + 6)
    return slstm, mlstm


@pytest.mark.parametrize("arch", ARCHS)
def test_per_rank_dot_flops(worlds, arch):
    res = worlds[f"1x4/count/{arch}"]
    got, whole = res["sharded"]["flops"], res["one_device"]["flops"]
    assert got <= FLOPS_SHARE[arch] * whole, got / whole
    ref = worlds["hlo"][arch]
    if arch == "recurrentgemma-2b":
        assert got == ref
        return
    slstm, mlstm = _xlstm_gaps()
    assert got == ref + slstm + mlstm
    assert slstm <= SLSTM_GAP_BOUND * ref and mlstm <= MLSTM_GAP_BOUND * ref
