"""The serving path's tracer (``repro_torch.trace``) on the CPU at SMOKE
size: ``Engine.generate`` returns the same tokens with a ``Tracer`` and
without one, ``OFF`` records nothing, the spans follow and nest as the
engine runs them, on the clock of ``time.perf_counter_ns``, and the
counters equal counts made by hand: the prefill's left pads over two
uneven waves, and the MoE pairs dropped past capacity."""
import time

import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_smoke
from repro_torch.convert import init_model
from repro_torch.models import moe as MOE
from repro_torch.serve.llm import Engine, EngineConfig

LENGTHS = (30, 5, 17, 9, 12)            # waves of 3: [30, 5, 17], [9, 12]
SLOTS, NEW = 3, 4
TOP = ("prefill", "decode_step", "sample", "sync")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prompts(vocab):
    g = torch.Generator().manual_seed(0)
    return [torch.randint(0, vocab, (n,), generator=g).tolist()
            for n in LENGTHS]


_MODELS = {}


def _model(arch, **change):
    key = (arch, tuple(sorted(change.items())))
    if key not in _MODELS:
        cfg = get_smoke(arch).replace(**change)
        _MODELS[key] = cfg, init_model(cfg, 0, "cpu")
    return _MODELS[key]


def _generate(arch, tracer=None, **change):
    cfg, model = _model(arch, **change)
    engine = Engine(cfg, model, EngineConfig(slots=SLOTS), tracer=tracer)
    out = engine.generate(_prompts(cfg.vocab_size), NEW)
    if tracer is not None:
        tracer.settle()
    return out, cfg


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x7b"])
def test_tokens_are_the_same_with_the_tracer_on_and_off(arch):
    off, _ = _generate(arch)
    tr = trace.Tracer("cpu")
    on, _ = _generate(arch, tr)
    assert on == off
    assert tr.counters["decode_steps"] == 2 * (NEW - 1)


def test_off_records_nothing():
    _generate("mixtral-8x7b")
    off = trace.OFF
    assert off.on is False and trace.current() is off
    assert off.span("a", device=True) is off.span("b")
    assert off.host == [] and not off.device_ms and not off.counters
    assert not off._events and not off._pending


def test_spans_follow_and_nest_as_the_engine_runs_them():
    tr = trace.Tracer("cpu")
    _, cfg = _generate("mixtral-8x7b", tr)
    spans = sorted(tr.host, key=lambda s: s[1])
    top = [lab for lab, _, _, parent in spans if parent is None]
    wave = ["prefill", "sample", "sync"] + \
        ["decode_step", "sample", "sync"] * (NEW - 1)
    assert top == wave * 2
    outer = [s for s in spans if s[3] is None]
    for (_, _, a1, _), (_, b0, _, _) in zip(outer, outer[1:]):
        assert a1 <= b0                 # each sync after its step's sample
    moe = [s for s in spans if s[0] == "moe"]
    assert {s[3] for s in moe} == {"prefill", "decode_step"}
    for parent in ("prefill", "decode_step"):
        opened = [s for s in outer if s[0] == parent]
        inner = [s for s in moe if s[3] == parent]
        assert len(inner) == cfg.n_layers * len(opened)
        for _, t0, t1, _ in inner:
            assert any(o0 <= t0 and t1 <= o1 for _, o0, o1, _ in opened)
    # off a card a device span's host interval stands in for its time
    assert len(tr.ms("moe", parent="decode_step")) == \
        cfg.n_layers * 2 * (NEW - 1)
    assert sorted(tr.device_ms) == ["decode_step", "moe", "prefill"]


def test_one_clock_holds_every_span():
    tr = trace.Tracer("cpu")
    t0 = time.perf_counter_ns()
    _generate("granite-8b", tr)
    t1 = time.perf_counter_ns()
    assert {lab for lab, *_ in tr.host} == set(TOP)
    assert all(t0 <= s0 <= s1 <= t1 for _, s0, s1, _ in tr.host)


def test_prefill_pads_are_counted_by_hand():
    tr = trace.Tracer("cpu")
    _generate("granite-8b", tr)
    waves = [LENGTHS[i:i + SLOTS] for i in range(0, len(LENGTHS), SLOTS)]
    pads = sum(max(w) * len(w) - sum(w) for w in waves)
    assert pads == (90 - 52) + (24 - 21)
    assert tr.counters["prefill_pad_tokens"] == pads
    assert tr.counters["prefill_tokens"] == sum(LENGTHS)


def test_moe_dropped_pairs_are_counted_by_hand(monkeypatch):
    """At a capacity factor of 0.5 a row holds half its pairs: the
    counter equals, over every call of every layer, the pairs that pick
    an expert past its ``capacity`` slots in their row, with ``route``'s
    choices."""
    seen = []
    routed = MOE._routed

    def recording(p, h_route, h_disp, cfg, *a, **k):
        seen.append((p, h_route.clone(), cfg))
        return routed(p, h_route, h_disp, cfg, *a, **k)
    monkeypatch.setattr(MOE, "_routed", recording)
    tr = trace.Tracer("cpu")
    _generate("mixtral-8x7b", tr, capacity_factor=0.5)

    pairs = dropped = 0
    for p, h, cfg in seen:
        b, s, _ = h.shape
        _, _, experts = MOE.route(h, p.router.w, cfg.topk)
        cap = MOE.capacity(s, cfg)
        pairs += experts.numel()
        for row in experts.reshape(b, -1).tolist():
            dropped += sum(max(0, row.count(e) - cap)
                           for e in range(cfg.n_experts))
    assert len(seen) == 2 * 2 * NEW        # layers x waves x calls
    assert dropped > 0
    assert tr.counters["moe_pairs"] == pairs
    assert tr.counters["moe_dropped_pairs"] == dropped


def test_tensor_counts_wait_for_settle():
    tr = trace.Tracer("cpu")
    tr.count("n", 2)
    tr.count("n", torch.tensor(3))
    tr.count("n", torch.tensor(4))
    assert tr.counters["n"] == 2
    tr.settle()
    assert tr.counters["n"] == 9
    with trace.active(tr):
        assert trace.current() is tr
    assert trace.current() is trace.OFF
