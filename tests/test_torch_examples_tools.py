"""The port's compiler and planner examples against the JAX package's, on
the CPU.

``examples/torch_compile_kernel.py`` (``main(["--device", "cpu"])``)
prints ``examples_golden.json``'s compile_kernel lines, which
``tests/test_torch_examples_golden.py`` recomputes from
``examples/compile_kernel.py``. Its scalar baseline, 44k eager simulator
rounds on the CPU, is stubbed here to the golden file's cycles; every
other line (compilation, the 1- and 4-CU runs, autotune, co-design, the
DSE over the compiled workload, the fleet's bit-exact routing) runs.
``chip_smoke.py`` (phase 8c) runs the whole script on the card, against
the same file.

``examples/torch_planner_dse.py`` prints the lines
``examples/planner_dse.py`` prints, run in this process. The port's
MeshPlanner carries the H100's constants, so its example plans for a
16 x 16 mesh of H100s. Here the constants are patched to the
reference's (as ``tests/test_torch_trainer.py`` does) and the mesh is
the reference's default, so its MeshPlanner lines equal the reference's
but for the section's header and the flash action's wording.
"""
import re
import types
from unittest import mock

from repro.roofline import analysis as janalysis
from repro_torch.compiler.lower import CompiledKernel
from repro_torch.core import meshplanner as mp
from repro_torch.ggpu.engine import ScalarConfig

from _examples import golden, one_thread, port_module, run_port  # noqa: F401
from _examples import run_reference, smoke

FLASH_ACTION = ("enable the flash_attention kernel (scores stay on chip)",
                "enable Pallas flash attention (scores stay in VMEM)")


def test_compile_kernel_prints_the_golden_lines(monkeypatch):
    """The whole script but its scalar baseline, which prints the golden
    file's cycles."""
    want = golden()["compile_kernel"]["lines"]
    (cycles,) = re.findall(r"^  scalar baseline: bit-exact, (\d+) cycles$",
                           "\n".join(want), re.M)
    verify, scalar_cfgs = CompiledKernel.verify, []

    def stub(self, inputs, cfg, *, scalar=False, device=None):
        if scalar:
            scalar_cfgs.append(cfg)
            return {"cycles": int(cycles)}
        return verify(self, inputs, cfg, device=device)
    monkeypatch.setattr(CompiledKernel, "verify", stub)
    out, text = run_port("compile_kernel")
    assert len(scalar_cfgs) == 1 and isinstance(scalar_cfgs[0], ScalarConfig)
    assert smoke.exact_lines("compile_kernel", text) == want
    assert out["frontier"] and sum(out["placement"].values()) == 6


def test_planner_dse_prints_the_reference_lines(monkeypatch):
    want = run_reference("planner_dse").splitlines()
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "HBM_PER_CHIP"):
        monkeypatch.setattr(mp, name, getattr(janalysis, name))
    mod = port_module("planner_dse")
    _, text = run_port("planner_dse", mod=mod)
    assert mod.MESH == (256, 16)            # the reference plan's default
    got = text.replace(*FLASH_ACTION).splitlines()
    head = [i for i, ln in enumerate(want)
            if ln.startswith(smoke.PLANNER_MESH_HEADER)]
    assert len(head) == 1 and len(got) == len(want)
    i = head[0]
    assert want[i] == "=== MeshPlanner: same loop, TPU pod target ==="
    assert got[i] == ("=== MeshPlanner: same loop, 16 x 16 mesh of H100s "
                      "(256 cards) ===")
    assert got[:i] == want[:i] and got[i + 1:] == want[i + 1:]
    assert smoke.exact_lines("planner_dse", text) == want[:i - 1]


def test_planner_dse_plans_for_the_h100():
    """Unpatched, the MeshPlanner section prints the H100's plans, no
    TPU figure: each cell as meshplanner.plan gives it on the mesh."""
    from repro_torch.configs import get_config
    mod = port_module("planner_dse")
    calls = []

    def plan(cfg, shape, **kw):
        calls.append((cfg.name, shape.name, kw))
        return real(cfg, shape, **kw)
    real = mp.plan
    no_search = types.SimpleNamespace(points=(), report=lambda: [])
    with mock.patch.object(mp, "plan", plan), \
            mock.patch.object(mod.dse, "sweep_memsys", lambda **kw: {}), \
            mock.patch.object(mod.dse, "search", lambda **kw: no_search):
        _, text = run_port("planner_dse", mod=mod)
    assert "TPU" not in text and "Pallas" not in text
    assert [c[:2] for c in calls] == [
        (get_config("qwen2-vl-72b").name, "train_4k"),
        (get_config("mixtral-8x7b").name, "train_4k"),
        (get_config("granite-8b").name, "decode_32k")]
    assert all(kw == {"n_devices": 256, "tp": 16, "hbm_budget": 80e9}
               for *_, kw in calls)
