"""SRAM macro timing/area/power model (65nm commercial node, calibrated);
the port's copy of ``repro.core.sram`` (pure Python).

The paper's memory compiler offers single/dual-port low-power SRAM with
16-65536 words x 2-144 bits. We model a macro's access delay as
``t0 + ta*log2(words) + tb*log2(bits)`` (wordline/bitline RC growth), its
area as ``a0 + ka*words*bits`` (a fixed per-block periphery overhead plus
linear bit-cell area — the overhead is exactly why two MxN blocks cost more
than one 2MxN block, the paper's central area trade-off), and leakage
proportional to bits with a per-block adder.

Constants are calibrated so the baseline G-GPU inventory reproduces the
paper's anchor points: 2.0 ns worst memory path (500 MHz), and the Table I
memory-area column (see ``repro_torch.core.ppa``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

# --- calibrated constants (65nm LP) ----------------------------------------
# delay = T0 + TA*sqrt(words) + TB*log2(bits): bitline RC grows with the
# word count (sqrt via hierarchical bitlines), wordline with width.
T0_NS = 0.70          # sense-amp + periphery
TA_NS = 0.0185        # bitline term per sqrt(word)
TB_NS = 0.02          # per doubling of bits
A0_MM2 = 0.0115       # per-block periphery overhead (superlinearity source)
KA_MM2_PER_BIT = 1.1375e-6
LEAK_MW_BLOCK = 0.012
LEAK_MW_PER_KBIT = 0.0024
DYN_MW_PER_GHZ_KBIT_PORT = 0.95   # activity-scaled

MIN_WORDS, MAX_WORDS = 16, 65536
MIN_BITS, MAX_BITS = 2, 144


@dataclass(frozen=True)
class Macro:
    """One SRAM block instance group.

    ``count`` physical blocks of ``words x bits`` (count > 1 after
    divisions); ``zone`` places it in the floorplan partition
    (cu | ctrl | top); ``per_cu`` scales the instance count with n_cus."""
    name: str
    words: int
    bits: int
    count: int = 1
    ports: int = 2                   # the G-GPU needs dual-port (paper)
    zone: str = "cu"
    per_cu: bool = True
    divided: int = 0                 # number of word-divisions applied

    def delay_ns(self) -> float:
        return (T0_NS + TA_NS * math.sqrt(self.words)
                + TB_NS * math.log2(self.bits))

    def area_mm2(self) -> float:
        return self.count * (A0_MM2 + KA_MM2_PER_BIT * self.words * self.bits)

    def leakage_mw(self) -> float:
        kbit = self.words * self.bits / 1024.0
        return self.count * (LEAK_MW_BLOCK + LEAK_MW_PER_KBIT * kbit)

    def dynamic_mw(self, freq_mhz: float, activity: float = 0.25) -> float:
        kbit = self.words * self.bits / 1024.0
        return (self.count * DYN_MW_PER_GHZ_KBIT_PORT * (freq_mhz / 1000.0)
                * math.sqrt(kbit) * self.ports * activity)

    def divide_words(self) -> "Macro":
        """The paper's memory-division step: split #words in two. Block
        count doubles; a MUX on the address MSB joins them (logic cost
        accounted by the planner)."""
        if self.words // 2 < MIN_WORDS:
            raise ValueError(f"{self.name}: cannot divide below {MIN_WORDS} words")
        return replace(self, words=self.words // 2, count=self.count * 2,
                       divided=self.divided + 1)

    def divide_bits(self) -> "Macro":
        """Alternative split on word size (data concat, no address MUX)."""
        if self.bits // 2 < MIN_BITS:
            raise ValueError(f"{self.name}: cannot divide below {MIN_BITS} bits")
        return replace(self, bits=self.bits // 2, count=self.count * 2,
                       divided=self.divided + 1)


# MUX levels added in front of a divided memory add logic delay; each
# division level costs one 2:1 mux stage on the read path.
MUX_DELAY_NS = 0.02


def divided_path_delay(m: Macro) -> float:
    """Access delay of a (possibly divided) macro including its MUX tree."""
    return m.delay_ns() + MUX_DELAY_NS * m.divided
