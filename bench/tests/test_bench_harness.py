"""The harness driven end to end on the CPU at a test's size: the two
small cells run, report their metrics and come out correct; each fault
that a served cell can have, planted under the timed path, comes out not
correct; a new configuration, mix, cell and metric are new files and new
entries only; and what must stop a run does."""
import json
import subprocess
import sys

import pytest

from bench import harness
from bench.tests import smoke
from bench.tests.smoke import CELLS

SEED = 2**31 + 17


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct(root, cell, trace):
    r = harness.run_cell(root, cell, SEED, 0.3, trace, device="cpu")
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 4           # a wave of the tiny mix
    assert list(r)[-1] == "compared"
    assert r["compared"]["worst_logit_gap"]["limit"] == smoke.SMOKE_LIMIT
    spec = json.loads((root / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.metrics_of(spec, cell, kind)}
    # the device's metrics need a card; every other one is there
    cpu_only = want - {"flash_attention_roofline", "device_idle",
                       "peak_device_gb"}
    assert cpu_only <= set(r["metrics"]) <= want
    for m in r["metrics"].values():
        assert m["value"] > 0


def _alter_a_token(engine):
    sample, calls = engine._sample, []

    def altered(logits, gen):
        tok = sample(logits, gen)
        calls.append(1)
        if len(calls) == 3:                 # one row, one decode step
            tok = tok.clone()
            tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    engine._sample = altered


def _state_unchanged(engine):
    step = engine.decode_fn

    def unchanged(model, cache, token, pos):
        kept = [type(c)(*(t.clone() for t in c)) for c in cache]
        logits, _ = step(model, cache, token, pos)
        return logits, kept
    engine.decode_fn = unchanged


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_alter_a_token, _state_unchanged])
def test_faults_come_out_not_correct(root, cell, fault):
    r = harness.run_cell(root, cell, SEED, 0.0, False, device="cpu",
                         fault=fault)
    assert r["correct"] is False
    gap = r["compared"]["worst_logit_gap"]
    assert gap["value"] > gap["limit"]


def test_a_fault_outside_the_sample_still_fails(root, monkeypatch):
    """A request that comes back short counts as failed, sampled or not."""
    def short(engine):
        gen = engine.generate

        def one_less(prompts, new):
            out = gen(prompts, new)
            out[-1] = out[-1][:-1]
            return out
        engine.generate = one_less
    r = harness.run_cell(root, CELLS[0], SEED, 0.0, False, device="cpu",
                         fault=short)
    assert r["correct"] is False and r["failed"] >= 1
    assert r["compared"]["bad_outputs"]["value"] == r["failed"]


def test_new_cell_is_files_and_entries(tmp_path):
    """A throw-away configuration, mix, cell and per-layer metric, added
    as new files and new BENCHMARK.json entries, run with no edit to any
    file the benchmark has."""
    root = smoke.make_root(tmp_path)
    b = root / "bench"
    arch = json.loads((b / "configs" / "granite-smoke.json").read_text())
    (b / "configs" / "wide-smoke.json").write_text(json.dumps(
        {**arch, "name": "wide-smoke", "num_hidden_layers": 3}))
    mix = json.loads((b / "mixes" / "tiny.json").read_text())
    (b / "mixes" / "burst.json").write_text(json.dumps(
        {**mix, "slots": 2, "new_tokens": 3}))
    (b / "metrics" / "waves_run.py").write_text(
        "def read(run):\n    return float(len(run.waves))\n")
    (b / "limits" / "wide-smoke.burst.json").write_text(
        json.dumps({"worst_logit_gap": smoke.SMOKE_LIMIT,
                    "check_requests": smoke.SMOKE_REQUESTS}))
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "wide-smoke", "source": "test",
                            "file": "bench/configs/wide-smoke.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "wide-smoke.burst",
                              "config": "wide-smoke", "traffic": "burst",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "waves_run", "unit": "waves",
                              "better": "higher", "source": "host_clock",
                              "layer": "engine",
                              "moves": "output_tokens_per_s",
                              "workloads": ["wide-smoke.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = harness.run_cell(root, "wide-smoke.burst", SEED, 0.2, True,
                         device="cpu")
    assert r["correct"] is True
    assert r["metrics"]["waves_run"]["value"] >= 1
    assert "waves_run" not in harness.run_cell(
        root, CELLS[0], SEED, 0.0, True, device="cpu")["metrics"]
    assert all(p.read_bytes() == data for p, data in before.items())


def test_no_program_in_the_checkout_is_refused(tmp_path):
    root = smoke.make_root(tmp_path)
    (root / "src").unlink()
    with pytest.raises(RuntimeError, match="not in this checkout"):
        harness.run_cell(root, CELLS[0], SEED, 0.0, False, device="cpu")


def test_run_without_a_card_prints_no_result(tmp_path):
    root = smoke.make_root(tmp_path)
    (root / "src").unlink()
    p = subprocess.run([sys.executable, str(root / "bench" / "run.py"),
                        "--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1"], capture_output=True, text=True, cwd=root,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_foreign_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert harness.foreign_modules() == ["repro"]

