"""G-GPU PPA estimator: memory inventory + logic model -> Table I (the
port's copy of ``repro.core.ppa``, pure Python).

The baseline inventory mirrors FGPU's memory map (register files, CV
scratchpads, instruction memory and wavefront state per CU; the central
multi-port data cache, tag store, RTM and data-mover FIFOs in the memory
controller; AXI/control buffers at top). Counts are chosen to reproduce the
paper's #Memory column (42 blocks per CU + 9 fixed at the 500 MHz baseline).

Logic (FF/comb) counts and areas are linear-in-CU fits to Table I — the
paper itself reports area "grows linearly with the number of CUs".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from repro_torch.core.sram import Macro, divided_path_delay

# ---------------------------------------------------------------------------
# baseline inventory (per the FGPU architecture; counts match Table I's 51
# blocks at 1 CU: 42 per-CU + 9 fixed)
# ---------------------------------------------------------------------------

def baseline_inventory() -> List[Macro]:
    return [
        # --- per CU (42 blocks) ---
        Macro("rf_bank", 4096, 32, count=2, zone="cu"),         # register file
        Macro("cv_scratch", 2048, 32, count=8, zone="cu"),      # CV scratchpads
        Macro("instr_mem", 4096, 32, count=2, zone="cu"),
        Macro("wf_state", 512, 64, count=8, zone="cu"),         # scheduler state
        Macro("lsu_fifo", 256, 64, count=8, zone="cu"),         # LSU queues
        # --- memory controller (fixed, 6 blocks) ---
        Macro("dcache_data", 2048, 64, count=2, zone="ctrl", per_cu=False),
        Macro("dcache_tag", 1024, 24, count=2, zone="ctrl", per_cu=False),
        Macro("rtm", 1024, 32, count=2, zone="ctrl", per_cu=False),
        # --- top (3 blocks) ---
        Macro("axi_buf", 512, 64, count=3, zone="top", per_cu=False),
    ]


# --- logic model: linear fits to Table I -----------------------------------
FF_PER_CU, FF_FIXED = 104_617, 15_161          # 119778 @1CU, 852094-ish @8
COMB_PER_CU, COMB_FIXED = 83_776, 44_050
LOGIC_AREA_PER_CU_MM2, LOGIC_AREA_FIXED_MM2 = 1.23, 0.28
LOGIC_LEAK_PER_CU_MW, LOGIC_LEAK_FIXED_MW = 0.05, 0.05
LOGIC_DYN_W_PER_CU_GHZ = 3.25                  # dynamic logic power / CU / GHz
LOGIC_DYN_W_FIXED_GHZ = 0.70

# logic critical path (pipelineable); the paper pipelines "on demand"
LOGIC_PATH_NS = 1.82
PIPELINE_GAIN = 0.82          # one stage removes ~18% of the path
PIPELINE_FF_COST = 260        # registers per inserted stage
# top-level interconnect (CU <-> memory controller). NOT pipelineable (the
# paper tried and failed — Section IV); QUADRATIC in CU count: the span of
# the floorplan grows ~linearly with CUs and unbuffered RC wire delay grows
# with length^2 (this reproduces the paper's 8CU@667 -> 600 MHz derate
# while 4CU@667 still closes).
IC_BASE_NS = 1.43
IC_QUAD_NS = 0.0048


@dataclass
class GGPUVersion:
    n_cus: int
    freq_mhz: float
    inventory: List[Macro]
    pipelines: int = 0

    # --- timing ---
    def mem_path_ns(self) -> float:
        return max(divided_path_delay(m) for m in self.inventory)

    def critical_memory(self) -> Macro:
        return max(self.inventory, key=divided_path_delay)

    def logic_path_ns(self) -> float:
        return LOGIC_PATH_NS * (PIPELINE_GAIN ** self.pipelines)

    def interconnect_ns(self) -> float:
        return IC_BASE_NS + IC_QUAD_NS * (self.n_cus - 1) ** 2

    def paths(self) -> Dict[str, float]:
        return {"memory": self.mem_path_ns(), "logic": self.logic_path_ns(),
                "interconnect": self.interconnect_ns()}

    def fmax_mhz(self) -> float:
        return 1000.0 / max(self.paths().values())

    def layout_fmax_mhz(self) -> float:
        """Post-layout fmax: same model (interconnect already included);
        kept separate for reporting symmetry with the paper's flow."""
        return self.fmax_mhz()

    # --- area / power / counts ---
    def _n_inst(self, m: Macro) -> int:
        return m.count * (self.n_cus if m.per_cu else 1)

    def n_memories(self) -> int:
        return sum(self._n_inst(m) for m in self.inventory)

    def memory_area_mm2(self) -> float:
        return sum(m.area_mm2() * (self.n_cus if m.per_cu else 1)
                   for m in self.inventory)

    def logic_area_mm2(self) -> float:
        return (LOGIC_AREA_FIXED_MM2 + LOGIC_AREA_PER_CU_MM2 * self.n_cus
                + self.pipelines * PIPELINE_FF_COST * 4e-6)

    def total_area_mm2(self) -> float:
        return self.memory_area_mm2() + self.logic_area_mm2()

    def n_ff(self) -> int:
        return int(FF_FIXED + FF_PER_CU * self.n_cus
                   + self.pipelines * PIPELINE_FF_COST)

    def n_comb(self) -> int:
        extra_mux = sum(m.divided * self._n_inst(m) for m in self.inventory)
        return int(COMB_FIXED + COMB_PER_CU * self.n_cus + 64 * extra_mux)

    def leakage_mw(self) -> float:
        mem = sum(m.leakage_mw() * (self.n_cus if m.per_cu else 1)
                  for m in self.inventory)
        return mem + LOGIC_LEAK_FIXED_MW + LOGIC_LEAK_PER_CU_MW * self.n_cus

    def dynamic_w(self) -> float:
        ghz = self.freq_mhz / 1000.0
        mem = sum(m.dynamic_mw(self.freq_mhz) * (self.n_cus if m.per_cu else 1)
                  for m in self.inventory) / 1000.0
        logic = (LOGIC_DYN_W_FIXED_GHZ + LOGIC_DYN_W_PER_CU_GHZ * self.n_cus) * ghz
        return mem + logic

    def total_w(self) -> float:
        return self.leakage_mw() / 1000.0 + self.dynamic_w()

    def report(self) -> Dict:
        return {
            "n_cus": self.n_cus, "freq_mhz": self.freq_mhz,
            "total_area_mm2": round(self.total_area_mm2(), 2),
            "memory_area_mm2": round(self.memory_area_mm2(), 2),
            "n_ff": self.n_ff(), "n_comb": self.n_comb(),
            "n_memory": self.n_memories(),
            "leakage_mw": round(self.leakage_mw(), 2),
            "dynamic_w": round(self.dynamic_w(), 2),
            "total_w": round(self.total_w(), 2),
            "fmax_mhz": round(self.fmax_mhz(), 1),
            "pipelines": self.pipelines,
        }


# Table I, for calibration-error reporting in the benchmarks
PAPER_TABLE1 = {
    (1, 500): dict(area=4.19, mem_area=2.68, ff=119778, comb=127826, mem=51,
                   leak=4.62, dyn=1.97, total=2.055),
    (2, 500): dict(area=7.45, mem_area=4.64, ff=229171, comb=214243, mem=93,
                   leak=8.54, dyn=3.63, total=3.77),
    (4, 500): dict(area=13.84, mem_area=8.56, ff=437318, comb=387246, mem=177,
                   leak=16.07, dyn=6.88, total=7.14),
    (8, 500): dict(area=26.51, mem_area=16.39, ff=852094, comb=714256, mem=345,
                   leak=30.79, dyn=13.33, total=13.86),
    (1, 590): dict(area=4.66, mem_area=3.15, ff=120035, comb=128894, mem=68,
                   leak=4.73, dyn=2.57, total=2.66),
    (2, 590): dict(area=8.16, mem_area=5.34, ff=229172, comb=221946, mem=120,
                   leak=8.73, dyn=4.63, total=4.81),
    (4, 590): dict(area=15.03, mem_area=9.72, ff=436807, comb=397995, mem=224,
                   leak=16.41, dyn=8.70, total=9.02),
    (8, 590): dict(area=28.65, mem_area=18.49, ff=850559, comb=737232, mem=432,
                   leak=31.25, dyn=16.81, total=17.40),
    (1, 667): dict(area=4.77, mem_area=3.26, ff=120035, comb=130802, mem=71,
                   leak=4.65, dyn=2.62, total=2.72),
    (2, 667): dict(area=8.27, mem_area=5.45, ff=229172, comb=222028, mem=123,
                   leak=8.72, dyn=4.69, total=4.87),
    (4, 667): dict(area=15.15, mem_area=9.83, ff=436807, comb=398124, mem=227,
                   leak=16.43, dyn=8.75, total=9.07),
    (8, 667): dict(area=28.69, mem_area=18.60, ff=848511, comb=730506, mem=435,
                   leak=30.21, dyn=19.10, total=19.76),
}
# paper: the 8CU@667 layout only closes at 600 MHz (interconnect wires)
PAPER_LAYOUT_DERATE = {(8, 667): 600.0}
