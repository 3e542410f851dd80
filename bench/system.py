"""The system under test, as the benchmark drives it: the port's
``repro_torch.serve.llm.Engine`` over ``repro_torch.models.model.LM``.

This is the only module of the benchmark that imports the program.
``load`` imports it from the checkout's own ``src/`` and refuses a copy
from anywhere else. ``model_config`` builds the program's ``ModelConfig``
from a configuration file (it does not read ``repro_torch.configs``);
``build`` puts the benchmark's weights into an ``LM`` without a copy and
wraps it in an ``Engine``. ``instrument`` wraps, for a traced run, the
calls ``generate`` makes: ``engine._sample`` and ``engine.decode_fn``,
the module-level ``prefill``, each layer's ``apply_moe`` and the kernels'
``flash_attention`` entry, recording spans and calls into a ``Spans``.
"""
from __future__ import annotations

import contextlib
import sys
from pathlib import Path


def load(root: Path):
    """Import ``repro_torch`` from ``root / "src"``; raise if it is
    missing there or comes from elsewhere."""
    src = (root / "src").resolve()
    if not (src / "repro_torch" / "__init__.py").exists():
        raise RuntimeError(f"the program is not in this checkout: no "
                           f"{src / 'repro_torch'}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch
    got = Path(repro_torch.__file__).resolve()
    if src not in got.parents:
        raise RuntimeError(f"repro_torch was imported from {got}, not from "
                           f"this checkout's {src}")
    return repro_torch


def model_config(arch: dict):
    from repro_torch.models.config import ModelConfig
    window = arch.get("sliding_window") or 0
    experts = arch.get("num_local_experts") or 0
    return ModelConfig(
        name=arch["name"], family="moe" if experts else "dense",
        n_layers=arch["num_hidden_layers"], d_model=arch["hidden_size"],
        n_heads=arch["num_attention_heads"],
        n_kv_heads=arch["num_key_value_heads"],
        d_ff=arch["intermediate_size"], vocab_size=arch["vocab_size"],
        head_dim=arch["head_dim"], window=window,
        rope_theta=float(arch["rope_theta"]),
        n_experts=experts, topk=arch.get("num_experts_per_tok") or 0,
        capacity_factor=arch.get("capacity_factor", 1.25),
        pattern_unit=("swa",) if window else ("attn",),
        norm_eps=arch["rms_norm_eps"],
        tie_embeddings=arch["tie_word_embeddings"],
        compute_dtype=arch["compute_dtype"], param_dtype=arch["param_dtype"],
        use_kernels=True)


def build(arch: dict, weights: dict, slots: int, seed: int):
    """(engine, cfg): greedy sampling, no end-of-sequence token."""
    from repro_torch.models.model import LM
    from repro_torch.serve.llm import Engine, EngineConfig
    cfg = model_config(arch)
    model = LM(cfg, device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    return Engine(cfg, model, EngineConfig(slots=slots, temperature=0.0,
                                           eos_id=-1, seed=seed)), cfg


@contextlib.contextmanager
def _patched(obj, name: str, wrap):
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


@contextlib.contextmanager
def instrument(engine, spans):
    """Record into ``spans`` (``spans.Spans``) while the block runs:
    "prefill", "decode_step" and "sample" spans on the host and, for the
    first two and "moe", on the device; each ``flash_attention`` call's
    shapes under "flash_attention"."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    def spanned(label, device=True):
        def wrap(fn):
            def run(*a, **k):
                with spans.span(label, device):
                    return fn(*a, **k)
            return run
        return wrap

    def flash(fn):
        def run(q, k, v, **kw):
            spans.call("flash_attention", dict(
                q=tuple(q.shape), k=tuple(k.shape), dtype=str(q.dtype),
                itemsize=q.element_size(), causal=kw.get("causal", True),
                window=kw.get("window", 0)))
            return fn(q, k, v, **kw)
        return run

    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(M, "prefill", spanned("prefill")))
        stack.enter_context(_patched(M, "apply_moe", spanned("moe")))
        stack.enter_context(_patched(ops, "flash_attention", flash))
        stack.enter_context(_patched(engine, "decode_fn",
                                     spanned("decode_step")))
        stack.enter_context(_patched(engine, "_sample",
                                     spanned("sample", device=False)))
        yield
