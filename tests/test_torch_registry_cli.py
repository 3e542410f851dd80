"""``python -m repro_torch.registry`` against ``python -m repro.registry``,
on the CPU, each run in this process through its ``main(argv)``:

* ``--json`` equals the reference's enumeration without what waits for
  the port's benchmark runners (ROADMAP.md item 10): the ``sections``
  axis, ``ci.smoke`` and the nightly matrix's ``sweep`` legs;
* ``--ci-matrix nightly`` equals the reference's 72 cells, in order;
* ``--selfcheck`` prints the reference's lines but the sections', and
  ``--smoke`` exits 0;
* ``--run-cell shared cohort earliest-finish seu`` loses nothing (all 24
  requests of each traffic pattern served);
* ``--ci-matrix smoke`` exits non-zero, naming item 10; ``--smoke`` and
  ``--run-cell`` need ``--device cpu`` on a host without a card.

The CLI also runs once as ``python -m repro_torch.registry`` in a
process of its own, with ``PYTHONPATH=src``.
"""
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.registry.__main__ import main

from _examples import ROOT, one_thread  # noqa: F401

CELL = ["shared", "cohort", "earliest-finish", "seu"]


def _run(fn, argv, capsys) -> tuple:
    rc = fn(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def reference_main(argv):
    return importlib.import_module("repro.registry.__main__").main(argv)


def test_json_equals_the_reference_but_sections(capsys):
    rc, out, _ = _run(main, ["--json"], capsys)
    rc_ref, ref, _ = _run(reference_main, ["--json"], capsys)
    assert rc == rc_ref == 0
    got, want = json.loads(out), json.loads(ref)
    del want["axes"]["sections"], want["ci"]["smoke"]
    want["ci"]["nightly"]["include"] = [
        e for e in want["ci"]["nightly"]["include"] if e["kind"] == "cell"]
    assert got == want
    assert got["schema"] == "ggpu-registry/1"


def test_nightly_matrix_equals_the_reference_cells(capsys):
    rc, out, _ = _run(main, ["--ci-matrix", "nightly"], capsys)
    _, ref, _ = _run(reference_main, ["--ci-matrix", "nightly"], capsys)
    assert rc == 0 and len(out.splitlines()) == 1
    cells = json.loads(out)["include"]
    assert len(cells) == 72 == 3 * 3 * 2 * 4
    assert cells == [e for e in json.loads(ref)["include"]
                     if e["kind"] == "cell"]


def test_smoke_matrix_waits_for_item_10(capsys):
    rc, out, err = _run(main, ["--ci-matrix", "smoke"], capsys)
    assert rc != 0 and out == ""
    assert "SECTIONS" in err and "item 10" in err


def test_selfcheck_and_smoke_exit_0(capsys):
    """--selfcheck prints the reference's axis lines but the sections';
    --smoke (one launch per scenario: tests/test_torch_registry.py holds
    smoke_all against the reference) finds no problem."""
    rc, out, err = _run(main, ["--selfcheck"], capsys)
    rc_ref, ref, _ = _run(reference_main, ["--selfcheck"], capsys)
    assert rc == rc_ref == 0 and err == ""
    axes = out.splitlines()
    assert axes == [ln for ln in ref.splitlines()
                    if not ln.startswith("axis sections:")]
    rc, out, err = _run(main, ["--smoke", "--device", "cpu"], capsys)
    assert rc == 0 and "REGISTRY PROBLEM" not in err
    assert out.splitlines()[:len(axes)] == axes


def test_run_cell_loses_nothing(capsys):
    rc, out, err = _run(main, ["--run-cell", *CELL, "--device", "cpu"],
                        capsys)
    assert rc == 0 and "REGISTRY PROBLEM" not in err
    served = [ln.split(" p99=")[0] for ln in out.splitlines()]
    assert served == [f"cell {'/'.join(CELL)}/{t}: served=24"
                      for t in ("bursty", "heavy-tail", "poisson")]


def test_launching_modes_default_to_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--smoke"], ["--run-cell", *CELL]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert main(["--selfcheck"]) == 0          # launches nothing
    capsys.readouterr()


def test_bad_run_cell_arity_is_an_error(capsys):
    with pytest.raises(SystemExit) as exc:
        main(["--run-cell", "shared", "cohort"])
    assert exc.value.code == 2
    assert "MEMSYS POLICY ROUTER" in capsys.readouterr().err


def test_cli_runs_as_a_module():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.registry", "--ci-matrix",
         "nightly"], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=120)
    assert out.returncode == 0, out.stderr
    cells = json.loads(out.stdout)["include"]
    assert len(cells) == 72
    assert cells[0]["name"] == "cell-banked-cohort-earliest-finish-device-loss"
