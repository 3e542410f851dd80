"""Step factories (the serving part of the port's
``repro.models.steps``): ``make_prefill_step`` and ``make_decode_step``.
PyTorch runs eagerly, so a step is the function itself, with no ``jit``.
Training steps are not ported yet (ROADMAP.md)."""
from __future__ import annotations

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model, batch):
        return M.prefill(model, cfg, tokens=batch["tokens"],
                         positions=batch.get("positions"))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(model, cache, token, pos):
        return M.decode_step(model, cfg, cache, token, pos)
    return decode_step
