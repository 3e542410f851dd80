"""The port stands alone: it, its examples (``examples/torch_*.py``) and
``chip_smoke.py`` import neither JAX nor anything of the JAX package, and
it runs on the card unless a caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax_and_no_reference_module():
    mods = _port_modules()
    for name in ("repro_torch.ggpu.engine.stepper", "repro_torch.serve.llm",
                 "repro_torch.models.model", "repro_torch.kernels.ops",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.rglru_scan",
                 "repro_torch.optim.adamw", "repro_torch.optim.compress",
                 "repro_torch.data.pipeline", "repro_torch.train.trainer",
                 "repro_torch.train.checkpoint",
                 "repro_torch.core.meshplanner",
                 "repro_torch.roofline.analysis",
                 "repro_torch.launch.train", "repro_torch.models.moe",
                 "repro_torch.configs.mixtral_8x7b",
                 "repro_torch.configs.llama4_scout_17b_a16e",
                 "repro_torch.configs.granite_8b",
                 "repro_torch.configs.qwen1_5_0_5b",
                 "repro_torch.configs.qwen1_5_4b",
                 "repro_torch.launch.mesh"):
        assert name in mods
    # the kernel wrapper first: it must import on its own (no cycle)
    mods.remove("repro_torch.kernels.pe_simd")
    mods.insert(0, "repro_torch.kernels.pe_simd")
    assert len(EXAMPLES) == 8
    code = (
        "import sys, importlib, importlib.util\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"for p in {[str(p) for p in EXAMPLES]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('example', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ,
                                         "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port pulled in: {out.stdout}"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"] + EXAMPLES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_reference_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("repro", "jax", "jaxlib"), (path, name)


def test_default_device_is_the_card(monkeypatch):
    """Without ``device=`` the entry points run on the card; on a host
    without one they raise instead of running on the CPU."""
    import torch

    from repro_torch import _device
    from repro_torch.ggpu import programs
    from repro_torch.ggpu.engine import (GGPUConfig, run_kernel,
                                         run_kernel_batch, run_kernel_cohort)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _device.resolve("cpu").type == "cpu"
    b = programs.build("copy", *programs.SMOKE_SIZES["copy"])
    cfg = GGPUConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_kernel(b.gpu_prog, b.gpu_mem, b.gpu_items, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_kernel_cohort(b.gpu_prog, [b.gpu_mem], b.gpu_items, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_kernel_batch([b.gpu_prog], [b.gpu_mem], [b.gpu_items], cfg)
    mem, info = run_kernel(b.gpu_prog, b.gpu_mem, b.gpu_items, cfg,
                           device="cpu")
    np.testing.assert_array_equal(mem[b.gpu_out], b.ref(b.gpu_mem, b.gpu_n))


def test_legacy_stepper_names_its_roadmap_item():
    """The legacy stepper (ROADMAP item 4) runs on the plain path, equal
    to the fused engine, and refuses what the reference's refuses."""
    from repro_torch.ggpu import programs
    from repro_torch.ggpu.engine import GGPUConfig, run_kernel
    b = programs.build("copy", *programs.SMOKE_SIZES["copy"])
    args = (b.gpu_prog, b.gpu_mem, b.gpu_items)
    mem, info = run_kernel(*args, GGPUConfig(), device="cpu")
    mem_l, info_l = run_kernel(*args, GGPUConfig(), legacy=True,
                               device="cpu")
    np.testing.assert_array_equal(mem, mem_l)
    assert info == info_l
    with pytest.raises(ValueError, match="shared"):
        run_kernel(*args, GGPUConfig(memsys="banked"), legacy=True,
                   device="cpu")


def test_chip_smoke_refuses_a_host_without_a_card():
    """The smoke script exits non-zero and prints no result line."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_a_directory_without_the_repo(tmp_path):
    """Alone in a directory the smoke script fails, even where the port is
    importable from elsewhere: it must run from a checkout."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env={**os.environ,
                                            "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode != 0
    assert "not a checkout" in out.stderr
    assert '"ok"' not in out.stdout
