"""LLM serving engine (the port's ``repro.serve.llm``): prefill + decode
with slot-wave batching. Greedy or temperature sampling.

Prompts are admitted in FIFO waves of at most ``slots`` (``plan_waves``).
Each wave is left-padded to its longest prompt and prefilled at once (the
pads are not masked, as in the reference), then decoded one token per
step for the whole wave until every row has ``max_new`` tokens or has
emitted ``eos_id`` (a first token equal to ``eos_id``, straight out of
prefill, stops its row too). Results return in submission order.

The engine runs where the model lives; ``EngineConfig.seed`` seeds the
``torch.Generator`` of temperature sampling (its draws differ from the
reference's ``jax.random``; greedy decoding is the same function).

``Engine(..., tracer=Tracer(device))`` records the spans and counters
that ``repro_torch.trace`` lists; the default ``OFF`` records nothing and
adds no sync, event or kernel.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.steps import make_decode_step
from repro_torch.serve.scheduler import plan_waves
from repro_torch.trace import OFF, Tracer, active


@dataclasses.dataclass
class EngineConfig:
    slots: int = 4
    temperature: float = 0.0
    eos_id: int = -1              # -1: never stop early
    seed: int = 0


class Engine:
    def __init__(self, cfg: ModelConfig, model: M.LM, ecfg: EngineConfig,
                 tracer: Optional[Tracer] = None):
        self.cfg, self.model, self.ecfg = cfg, model, ecfg
        self.decode_fn = make_decode_step(cfg)
        self.tracer = OFF if tracer is None else tracer

    def _sample(self, logits, gen: torch.Generator):
        if self.ecfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.ecfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    @torch.inference_mode()
    def generate(self, prompts: List[List[int]], max_new: int
                 ) -> List[List[int]]:
        """Slot-batched generation. Prompts are queued; each wave prefills
        up to ``slots`` prompts padded to a common length."""
        ecfg, tr = self.ecfg, self.tracer
        dev = self.model.device
        results: List[Optional[List[int]]] = [None] * len(prompts)
        gen = torch.Generator(device=dev).manual_seed(ecfg.seed)
        with active(tr):
            for wave in plan_waves(range(len(prompts)), ecfg.slots):
                plen = max(len(prompts[i]) for i in wave)
                batch = np.zeros((len(wave), plen), np.int64)
                for r, i in enumerate(wave):
                    batch[r, plen - len(prompts[i]):] = prompts[i]  # left-pad
                real = sum(len(prompts[i]) for i in wave)
                tr.count("prefill_tokens", real)
                tr.count("prefill_pad_tokens", batch.size - real)
                cap = plen + max_new + 1
                tokens = torch.from_numpy(batch).to(dev)
                with tr.span("prefill", device=True):
                    logits, cache = M.prefill(self.model, self.cfg,
                                              tokens=tokens, pad_to=cap)
                toks = [list(prompts[i]) for i in wave]
                with tr.span("sample"):
                    last = self._sample(logits, gen)
                with tr.span("sync"):
                    first = last.tolist()
                done = np.zeros(len(wave), bool)
                for r, tok in enumerate(first):
                    toks[r].append(tok)
                    if tok == ecfg.eos_id:
                        done[r] = True       # EOS straight out of prefill
                for t in range(max_new - 1):
                    if done.all():
                        break
                    tr.count("decode_steps", 1)
                    with tr.span("decode_step", device=True):
                        logits, cache = self.decode_fn(
                            self.model, cache, last[:, None], plen + t)
                    with tr.span("sample"):
                        last = self._sample(logits, gen)
                    with tr.span("sync"):
                        step = last.tolist()
                    for r, tok in enumerate(step):
                        if not done[r]:
                            toks[r].append(tok)
                            if tok == ecfg.eos_id:
                                done[r] = True
                for r, i in enumerate(wave):
                    results[i] = toks[r]
        return results  # type: ignore
