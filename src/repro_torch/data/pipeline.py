"""Deterministic, stateless-seekable token pipeline (the port's copy of
``repro.data.pipeline``: numpy, so its batches are byte-identical).

``batch_at(step)`` is a pure function of (seed, step): restart/resume never
replays or skips data, any host can compute exactly its shard, and
stragglers can be re-dispatched deterministically — the data-side half of
the fault-tolerance story (trainer checkpoints carry only the step number).

Two sources:
  * ``SyntheticLM`` — a mixture of Zipfian unigrams and copy/induction
    motifs (so small models have learnable structure; loss decreases).
  * ``BinCorpus``  — memory-mapped pre-tokenized .bin shards (production
    path); documents are sliced by absolute token offset = f(step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    # host sharding (process i of n feeds rows [i*b/n, (i+1)*b/n))
    host_index: int = 0
    host_count: int = 1


class SyntheticLM:
    """Zipf unigrams + injected copy motifs, fully deterministic."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._host_rows = cfg.global_batch // cfg.host_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = self._host_rows
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
        # Zipf over the vocab (clip to range)
        toks = rng.zipf(1.3, size=(rows, cfg.seq_len + 1)).astype(np.int64)
        toks = (toks - 1) % cfg.vocab_size
        # copy motif: repeat a short window later in the sequence
        span = min(32, cfg.seq_len // 4)
        if span >= 4:
            src = rng.integers(0, cfg.seq_len // 2 - span, rows)
            dst = rng.integers(cfg.seq_len // 2, cfg.seq_len - span, rows)
            for r in range(rows):
                toks[r, dst[r]:dst[r] + span] = toks[r, src[r]:src[r] + span]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class BinCorpus:
    """Memory-mapped token shards: files of int32 tokens, concatenated."""

    def __init__(self, cfg: DataConfig, paths):
        self.cfg = cfg
        self._maps = [np.memmap(p, dtype=np.int32, mode="r") for p in paths]
        self._sizes = np.array([m.shape[0] for m in self._maps])
        self._total = int(self._sizes.sum())
        self._host_rows = cfg.global_batch // cfg.host_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        need = cfg.seq_len + 1
        rows = self._host_rows
        out = np.empty((rows, need), np.int32)
        for r in range(rows):
            gr = cfg.host_index * rows + r
            # absolute offset is a pure function of (step, row)
            off = ((step * cfg.global_batch + gr) * cfg.seq_len) \
                % max(self._total - need, 1)
            out[r] = self._gather(off, need)
        return {"tokens": out[:, :-1] % cfg.vocab_size,
                "labels": out[:, 1:] % cfg.vocab_size}

    def _gather(self, off: int, n: int) -> np.ndarray:
        chunks = []
        fi = 0
        csum = 0
        for m, sz in zip(self._maps, self._sizes):
            if off < csum + sz:
                local = off - csum
                take = min(n - sum(len(c) for c in chunks), sz - local)
                chunks.append(np.asarray(m[local:local + take]))
                off += take
            csum += sz
            if sum(len(c) for c in chunks) == n:
                break
        return np.concatenate(chunks)


def make_source(cfg: DataConfig, paths=None):
    return BinCorpus(cfg, paths) if paths else SyntheticLM(cfg)


def to_device(batch: Dict[str, np.ndarray],
              device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
