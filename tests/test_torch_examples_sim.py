"""The port's simulator and kernel-serving examples against the JAX
package's, on the CPU: ``examples/torch_{ggpu_simulate, serve_decode,
serve_graph, serve_chaos}.py`` (``main(argv + ["--device", "cpu"])``)
print the lines ``examples/{...}.py`` print at the same argv, their
wall-clock fields masked (``chip_smoke.exact_lines``). Cycles, hits,
misses, ``correct=``, the speed-up, occupancy and hit-rate deltas,
placements, makespans, dispatch counts and the chaos decision log are
exact.

The cases in ``examples_golden.json`` (serve_decode's ``--ggpu 6`` and
``--fleet 4`` legs, serve_chaos) are held to its lines, which
``tests/test_torch_examples_golden.py`` recomputes from the reference;
the rest to the reference example run once in this module.

ggpu_simulate runs copy on 4 CUs and div_int on 8 banked CUs here: its
default, mat_mul, adds a 43k-round scalar run (~50 s on the CPU), which
``chip_smoke.py`` holds on the card against ``examples_golden.json``.
"""
import pytest
import torch

from _examples import golden, one_thread, port_module, run_port  # noqa: F401
from _examples import run_reference, smoke

# case: (script, argv); the golden file's cases under its keys
CASES = {
    "ggpu_simulate_copy": ("ggpu_simulate", ("--kernel", "copy", "--cus",
                                             "4")),
    "ggpu_simulate_div_int_banked": ("ggpu_simulate", (
        "--kernel", "div_int", "--cus", "8", "--memsys", "banked", "--fuse",
        "2")),
    "serve_decode_ggpu": smoke.EXACT_EXAMPLES["serve_decode_ggpu"],
    "serve_decode_fleet": smoke.EXACT_EXAMPLES["serve_decode_fleet"],
    "serve_graph_fleet": ("serve_graph", ("--fleet",)),
    "serve_chaos": smoke.EXACT_EXAMPLES["serve_chaos"],
    "serve_chaos_device_loss": ("serve_chaos", ("--faults", "device-loss")),
}


@pytest.fixture(scope="module")
def reference():
    """Every case's reference lines: the golden file's, else the
    example's, run once."""
    lines = {case: rec["lines"] for case, rec in golden().items()
             if case in CASES}
    for case, (script, argv) in CASES.items():
        if case not in lines:
            lines[case] = smoke.exact_lines(case,
                                            run_reference(script, argv))
    return lines


@pytest.mark.parametrize("case", sorted(CASES))
def test_example_prints_the_reference_lines(case, reference):
    script, argv = CASES[case]
    out, text = run_port(script, argv)
    got = smoke.exact_lines(case, text)
    assert got == reference[case]
    assert got, case
    if script == "ggpu_simulate":
        assert out["correct"] is True
    if script == "serve_chaos":
        assert out["bit_exact"] == out["served"] == 16


def test_the_card_is_the_default(monkeypatch):
    """Without --device the examples run on the card; on a host without
    one they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for script, argv in (("ggpu_simulate", ("--kernel", "copy")),
                         ("serve_decode", ("--ggpu", "2")),
                         ("serve_graph", ()), ("serve_chaos", ())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            smoke.captured(port_module(script).main, list(argv))
