"""Shared pieces of ``tests/test_torch_examples_*.py`` and
``tests/test_torch_registry_cli.py``: ``chip_smoke.py`` loaded as a
module (its example loaders, ``exact_lines`` and golden file), the
golden file's records, a module-scoped fixture that runs each test
module with one torch thread, and the two ways an example runs here:
the JAX package's ``examples/<script>.py`` with ``sys.argv`` set, and
the port's ``examples/torch_<script>.py`` through ``main(argv +
["--device", "cpu"])``, each with its stdout captured.

A test module takes the fixture by importing it::

    from _examples import one_thread  # noqa: F401
"""
import importlib.util
import json
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_chip_smoke()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread in this worker: the examples' tensors are
    small, and a thread per core in each of the test run's workers
    oversubscribes the cores several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def golden() -> dict:
    """``src/repro_torch/examples_golden.json``, which
    ``tests/test_torch_examples_golden.py`` holds to the reference."""
    return json.loads(smoke.GOLDEN_EXAMPLES.read_text())


def reference_module(script: str):
    return smoke.load_example(ROOT / "examples" / f"{script}.py",
                              f"reference_{script}")


def run_reference(script: str, argv=(), mod=None) -> str:
    """What the JAX package's ``examples/<script>.py`` (or ``mod``, the
    script loaded and patched) prints at ``argv``."""
    path = ROOT / "examples" / f"{script}.py"
    mod = mod or reference_module(script)
    with mock.patch.object(sys, "argv", [str(path), *argv]):
        return smoke.captured(mod.main)[1]


def port_module(script: str):
    return smoke.load_example(ROOT / "examples" / f"torch_{script}.py")


def run_port(script: str, argv=(), mod=None, **kw) -> tuple:
    """(result, printed text) of the port's ``examples/torch_<script>.py``
    (or ``mod``, the script loaded and patched) on the CPU."""
    mod = mod or port_module(script)
    return smoke.captured(mod.main, [*argv, "--device", "cpu"], **kw)

