"""Deterministic fault plans: seed-reproducible chaos for the serving
stack (the port's copy of ``repro.faults.plan``: the same ``hashlib``
draws, so both packages take byte-identical decisions).

A ``FaultPlan`` is a pure *description* of the faults to inject — it
holds no state and draws every decision from a counter-mode hash keyed
by ``(seed, kind, ticket, attempt)``. That keying is the whole design:

  * **Reproducible** — the same seed and plan produce byte-identical
    fault decisions on any machine, any backend, any run.
  * **Schedule-independent** — a launch's fate depends on *its own*
    ticket and attempt number, never on which chunk the scheduler folded
    it into, how deep the dispatch pipeline ran, or how retries
    interleaved across devices. Re-planning a chunk after a quarantine
    cannot silently reshuffle who gets hit.
  * **Attempt-aware** — a retry is a fresh draw (the ``attempt`` term),
    so a transiently-corrupted launch normally succeeds on re-dispatch,
    exactly like a real SEU; a plan with rate 1.0 models a hard fault.

The fault taxonomy:

  * ``seu_rate`` — single-event upset *before* compute: one bit of the
    launch's staged memory image is flipped pre-dispatch (via the
    engine's fused ``XorBlockPatch``, one device op, off the hot path
    entirely when the rate is 0). The kernel then computes over the
    corrupted input.
  * ``seu_post_rate`` — silent data corruption *after* compute: one bit
    of the collected result is flipped. Invisible unless the request
    carries an output-checksum ``audit`` — the failure mode the
    scheduler's ChecksumError machinery exists for.
  * ``straggler_rate`` / ``straggler_delay_s`` — a dispatched chunk's
    completion is withheld for ``straggler_delay_s`` wall-clock seconds
    (the tail-latency fault hedging exists for).
  * ``stuck_devices`` / ``stuck_after`` — the named devices wedge
    permanently after ``stuck_after`` dispatches: their chunks never
    resolve, surfacing as ``DeviceTimeout`` once the executor's
    ``timeout_s`` expires (the device-loss fault eviction exists for).

All rates are probabilities in [0, 1]; a default-constructed plan (all
rates 0, no stuck devices) injects nothing and adds nothing to the
dispatch path — bit-exact-off-by-default.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple

# result words are int32; bit 31 would need an unsigned view to mask, so
# flips draw from the 31 value bits — one flipped bit is one flipped bit
_BITS = 31


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic, seed-keyed chaos description (module doc)."""
    seed: int = 0
    seu_rate: float = 0.0           # pre-dispatch staged-memory bit flips
    seu_post_rate: float = 0.0      # post-collect result bit flips (SDC)
    straggler_rate: float = 0.0     # per-chunk completion-hold probability
    straggler_delay_s: float = 0.0  # how long a straggling chunk is held
    stuck_devices: Tuple[str, ...] = ()  # device names that wedge...
    stuck_after: int = 0            # ...after this many dispatches

    @property
    def active(self) -> bool:
        """Does this plan ever inject anything?"""
        return bool(self.seu_rate or self.seu_post_rate
                    or self.straggler_rate or self.stuck_devices)

    # -- the draw primitive --------------------------------------------------

    def _digest(self, kind: str, *key) -> bytes:
        return hashlib.sha256(
            repr((self.seed, kind) + key).encode()).digest()

    def _unit(self, kind: str, *key) -> float:
        """One uniform draw in [0, 1), a pure function of (seed, kind,
        key) — the counter-mode primitive every decision reduces to."""
        return int.from_bytes(self._digest(kind, *key)[:8], "big") / 2.0**64

    def _pick(self, kind: str, n: int, *key) -> int:
        """One uniform draw in [0, n)."""
        return int.from_bytes(self._digest(kind, *key)[8:16], "big") % n

    # -- decisions (keyed per launch attempt / per dispatch) -----------------

    def seu_hit(self, ticket: int, attempt: int) -> bool:
        """Does attempt ``attempt`` of launch ``ticket`` take a
        pre-dispatch staged-memory upset?"""
        return self._unit("seu", ticket, attempt) < self.seu_rate

    def seu_flip(self, ticket: int, attempt: int,
                 msize: int) -> Tuple[int, int]:
        """The (word, bit) the upset flips, uniform over the image."""
        return (self._pick("seu-word", msize, ticket, attempt),
                self._pick("seu-bit", _BITS, ticket, attempt))

    def post_hit(self, ticket: int, attempt: int) -> bool:
        """Does this attempt's *result* take a silent corruption?"""
        return self._unit("sdc", ticket, attempt) < self.seu_post_rate

    def post_flip(self, ticket: int, attempt: int,
                  msize: int) -> Tuple[int, int]:
        return (self._pick("sdc-word", msize, ticket, attempt),
                self._pick("sdc-bit", _BITS, ticket, attempt))

    def straggler_hit(self, ticket: int, attempt: int) -> bool:
        """Is the chunk whose *first member* is (ticket, attempt) held as
        a straggler? Chunk-level on purpose: a real straggling device
        delays everything it was running, not one launch of it."""
        return self._unit("straggler", ticket, attempt) \
            < self.straggler_rate

    def stuck(self, device: str, dispatch_ordinal: int) -> bool:
        """Has ``device`` wedged by its ``dispatch_ordinal``-th dispatch?"""
        return device in self.stuck_devices \
            and dispatch_ordinal >= self.stuck_after
