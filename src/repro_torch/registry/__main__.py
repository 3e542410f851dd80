"""Registry CLI (the port's ``python -m repro.registry``): the
machine-readable enumeration of the port's scenario registry.

Modes (exactly one):

  ``--json``
      Full enumeration: every axis's plugin names (plus per-plugin
      detail where the spec provides ``describe()``) and the nightly CI
      matrix. Schema ``ggpu-registry/1``.
  ``--ci-matrix nightly``
      The scenario cross-product as compact JSON on a single line: one
      cell per (memsys, policy, router, fault) combination, each
      replaying every registered traffic pattern over every bench under
      the named chaos scenario.
  ``--selfcheck``
      Discover every axis; exit non-zero on import errors, duplicate
      names (both raise), or an empty axis.
  ``--smoke``
      ``--selfcheck`` plus one minimal launch per registered scenario.
  ``--run-cell MEMSYS POLICY ROUTER [FAULT]``
      Execute one nightly cross-product cell (``FAULT`` names a
      ``FAULTS`` scenario; default ``none``).

``--smoke`` and ``--run-cell`` launch on ``--device``: the card by
default, ``cpu`` only when asked for; without a card they raise. The
other modes enumerate and launch nothing.

The reference's ``SECTIONS`` axis (benchmark-harness sections) waits for
the port's benchmark runners, ROADMAP.md queue item 10: so ``--json``
has no ``sections`` axis and no ``ci.smoke`` matrix, the nightly matrix
has no full-sweep legs, and ``--ci-matrix smoke`` exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch import _device
from repro_torch.registry import AXES

SCHEMA = "ggpu-registry/1"


def nightly_matrix() -> dict:
    """The nightly matrix: the scenario cross-product cells."""
    include = []
    for ms in AXES["memsys"].names():
        for pol in AXES["schedulers"].names():
            for rt in AXES["routers"].names():
                for ft in AXES["faults"].names():
                    include.append({
                        "kind": "cell",
                        "memsys": ms, "policy": pol, "router": rt,
                        "fault": ft,
                        "xla_flags": "",
                        "name": f"cell-{ms}-{pol}-{rt}-{ft}",
                    })
    return {"include": include}


def full_enumeration() -> dict:
    axes = {}
    for axis_name, axis in AXES.items():
        entries = {}
        for name, obj in axis.items():
            detail = obj.describe() if hasattr(obj, "describe") else {}
            entries[name] = detail
        axes[axis_name] = {"names": axis.names(), "detail": entries}
    return {"schema": SCHEMA, "axes": axes,
            "ci": {"nightly": nightly_matrix()}}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.registry",
        description="Enumerate, self-check, and smoke the port's scenario "
                    "registry (see module doc).")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--json", action="store_true",
                      help="full enumeration + the nightly matrix as JSON")
    mode.add_argument("--ci-matrix", choices=("smoke", "nightly"),
                      help="one CI matrix as single-line JSON (smoke "
                           "waits for the SECTIONS axis)")
    mode.add_argument("--selfcheck", action="store_true",
                      help="fail on empty axes / duplicate names / "
                           "import errors")
    mode.add_argument("--smoke", action="store_true",
                      help="selfcheck + one minimal launch per "
                           "registered scenario")
    mode.add_argument("--run-cell", nargs="+",
                      metavar="MEMSYS POLICY ROUTER [FAULT]",
                      help="run one nightly cross-product cell "
                           "(FAULT defaults to 'none')")
    ap.add_argument("--device", default=None,
                    help="where --smoke and --run-cell launch (default: "
                         "the card; 'cpu' for the plain path)")
    args = ap.parse_args(argv)
    if args.run_cell is not None and len(args.run_cell) not in (3, 4):
        ap.error("--run-cell takes MEMSYS POLICY ROUTER [FAULT]")

    if args.json:
        json.dump(full_enumeration(), sys.stdout, indent=2, sort_keys=True)
        print()
        return 0
    if args.ci_matrix == "smoke":
        print("--ci-matrix smoke: the port's SECTIONS axis (benchmark-"
              "harness sections and their smoke legs) waits for its "
              "benchmark runners, ROADMAP.md item 10", file=sys.stderr)
        return 2
    if args.ci_matrix:
        print(json.dumps(nightly_matrix(), sort_keys=True))
        return 0

    from repro_torch.registry import smoke as smoke_mod
    if args.selfcheck or args.smoke:
        problems = smoke_mod.selfcheck(print)
        if args.smoke and not problems:
            problems += smoke_mod.smoke_all(
                print, device=_device.resolve(args.device))
    else:
        ms, pol, rt = args.run_cell[:3]
        fault = args.run_cell[3] if len(args.run_cell) > 3 else "none"
        problems = smoke_mod.run_cell(ms, pol, rt, print, fault=fault,
                                      device=_device.resolve(args.device))
    for p in problems:
        print(f"REGISTRY PROBLEM: {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
