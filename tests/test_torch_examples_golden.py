"""``src/repro_torch/examples_golden.json``: the lines ``chip_smoke.py``
holds the port's examples to on the card (phase 8c), recomputed here from
the JAX package's ``examples/*.py`` on the CPU.

For each of ``chip_smoke.EXACT_EXAMPLES`` (ggpu_simulate, serve_decode's
``--ggpu`` and ``--fleet`` legs, serve_graph, serve_chaos,
compile_kernel, planner_dse) the reference example runs at the argv the
file names, and its printed lines, wall-clock fields masked
(``chip_smoke.exact_lines``), must equal the file's field for field.

The port's examples print these lines on the card (``chip_smoke.py``,
phase 8c), where the golden file is what they are held to; on the CPU
``tests/test_torch_examples_{sim,tools}.py`` hold the port's examples to
the file, so that each reference example runs once in the test run
(but planner_dse, whose MeshPlanner section, past the file's lines, is
compared with the reference's there).

Regenerate after changing an example's argv or the masking::

    PYTHONPATH=src python tests/test_torch_examples_golden.py
"""
import json

import pytest

from _examples import one_thread, run_reference  # noqa: F401
from _examples import smoke


def reference_record(key: str) -> dict:
    """The JAX package's example for ``key``, run in this process at its
    argv: its exact lines."""
    script, argv = smoke.EXACT_EXAMPLES[key]
    return {"script": script, "argv": list(argv),
            "lines": smoke.exact_lines(key, run_reference(script, argv))}


def record() -> dict:
    return {key: reference_record(key) for key in smoke.EXACT_EXAMPLES}


@pytest.fixture(scope="module")
def fresh():
    return record()


@pytest.fixture(scope="module")
def golden():
    return json.loads(smoke.GOLDEN_EXAMPLES.read_text())


def test_golden_file_names_every_exact_example(golden):
    assert sorted(golden) == sorted(smoke.EXACT_EXAMPLES)
    for key, (script, argv) in smoke.EXACT_EXAMPLES.items():
        assert golden[key]["script"] == script
        assert golden[key]["argv"] == list(argv)
        assert golden[key]["lines"], key


@pytest.mark.parametrize("key", sorted(smoke.EXACT_EXAMPLES))
def test_golden_lines_equal_the_reference(key, fresh, golden):
    assert fresh[key] == golden[key]


def test_masking_keeps_exact_fields():
    """Only wall-clock fields are masked: modeled times (us), cycle
    ratios and counts stay."""
    text = ("served 6 launches in 6.0 ms (occupancy 6.0 launches/dispatch"
            ")\npipelined:      7.14 ms  (3 dispatches for 24 launches)\n"
            "speedup 8.14x, bit-exact vs reference: True\n"
            "G-GPU :     87472 cycles (174.9 us @500MHz)\n"
            "autotune picked c1: 37456 cycles vs 37456 default (1.00x)\n"
            "  1cu@500/shared/d0           74.91 us    4.12 mm^2\n\n")
    assert smoke.exact_lines("x", text) == [
        "served 6 launches in <ms> (occupancy 6.0 launches/dispatch)",
        "pipelined: <ms>  (3 dispatches for 24 launches)",
        "speedup <x>, bit-exact vs reference: True",
        "G-GPU :     87472 cycles (174.9 us @500MHz)",
        "autotune picked c1: 37456 cycles vs 37456 default (1.00x)",
        "  1cu@500/shared/d0           74.91 us    4.12 mm^2"]
    planner = "=== GPUPlanner ===\n  it1\n\n=== MeshPlanner: x ===\n  a\n"
    assert smoke.exact_lines("planner_dse", planner) == [
        "=== GPUPlanner ===", "  it1"]


def main() -> None:
    smoke.GOLDEN_EXAMPLES.write_text(json.dumps(record(), indent=1) + "\n")
    print(f"wrote {smoke.GOLDEN_EXAMPLES}")


if __name__ == "__main__":
    main()
