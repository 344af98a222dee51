"""NeuraChip machine configurations — paper Tables 2 and 3, verbatim (copy
of ``repro.neurasim.machine``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TileConfig:
    name: str
    n_tiles: int
    neuracores_per_tile: int
    neuramems_per_tile: int
    pipelines_per_core: int
    pipeline_registers: int
    multipliers_per_core: int
    hash_engines_per_mem: int
    comparators_per_engine: int
    hashlines_per_mem: int
    accumulators_per_mem: int
    hashpad_total_mb: float
    dram_bw_gbps: float = 128.0     # 8 × 16 GB/s HBM channels (paper §3)
    freq_ghz: float = 1.0

    @property
    def total_cores(self) -> int:
        return self.n_tiles * self.neuracores_per_tile

    @property
    def total_mems(self) -> int:
        return self.n_tiles * self.neuramems_per_tile

    @property
    def total_pipelines(self) -> int:
        return self.total_cores * self.pipelines_per_core

    @property
    def total_hash_engines(self) -> int:
        return self.total_mems * self.hash_engines_per_mem

    @property
    def total_accumulators(self) -> int:
        return self.total_mems * self.accumulators_per_mem

    @property
    def peak_gflops(self) -> float:
        # 1 MAC/cycle/multiplier × 2 flops (paper Table 5 peak perf column)
        return (self.total_cores * self.multipliers_per_core
                * self.freq_ghz * 2.0)


TILE4 = TileConfig(
    name="Tile-4", n_tiles=8, neuracores_per_tile=1, neuramems_per_tile=1,
    pipelines_per_core=2, pipeline_registers=4, multipliers_per_core=2,
    hash_engines_per_mem=2, comparators_per_engine=1, hashlines_per_mem=4096,
    accumulators_per_mem=128, hashpad_total_mb=0.75)

TILE16 = TileConfig(
    name="Tile-16", n_tiles=8, neuracores_per_tile=4, neuramems_per_tile=4,
    pipelines_per_core=4, pipeline_registers=8, multipliers_per_core=4,
    hash_engines_per_mem=4, comparators_per_engine=4, hashlines_per_mem=2048,
    accumulators_per_mem=256, hashpad_total_mb=3.0)

TILE64 = TileConfig(
    name="Tile-64", n_tiles=8, neuracores_per_tile=16, neuramems_per_tile=16,
    pipelines_per_core=8, pipeline_registers=16, multipliers_per_core=8,
    hash_engines_per_mem=8, comparators_per_engine=8, hashlines_per_mem=2048,
    accumulators_per_mem=512, hashpad_total_mb=12.0)

CONFIGS = {"tile4": TILE4, "tile16": TILE16, "tile64": TILE64}

# Published SpGEMM throughput baselines (paper Table 5, GOP/s on the common
# matrix set) — used as denominators for the speedup reproduction.
PUBLISHED_GOPS = {
    "Xeon E5 (MKL)": 1.12,
    "NVIDIA H100 (cuSPARSE)": 1.86,
    "AMD MI100 (hipSPARSE)": 1.48,
    "OuterSPACE": 2.9,
    "SpArch": 10.4,
    "Gamma": 16.5,
}

PAPER_NEURACHIP_GOPS = {"tile4": 5.15, "tile16": 24.75, "tile64": 30.69}
PAPER_TILE64_DUAL_HBM = 93.17
PAPER_SPEEDUPS_TILE16 = {
    "Xeon E5 (MKL)": 22.1, "NVIDIA H100 (cuSPARSE)": 13.3,
    "AMD MI100 (hipSPARSE)": 16.7, "OuterSPACE": 6.6, "SpArch": 2.4,
    "Gamma": 1.5,
}
