"""NeuraSim — cycle-approximate performance model of the NeuraChip machine
(port of ``repro.neurasim.model``).

The paper's NeuraSim is a cycle-accurate multi-threaded C++ engine; this is
its analytic/event reduction, built around the same decoupled three-resource
occupancy picture the paper's design-space study (§4) uses:

  time = max(multiply stage, accumulate stage, DRAM stream) + drain

* multiply stage — MMH4 instructions (16 partial products each) issued over
  all pipelines; each MMH4 occupies a pipeline for ``MMH4_CYCLES``.
* accumulate stage — HACC instructions (1 pp each) over all hash engines;
  each HACC costs 1 + collision-penalty cycles, and the load across
  NeuraMems is skewed by the mapping's imbalance (max/mean over units) —
  computed by hashing the workload's row tags with the chosen mapping
  (ring / modular / drhm / random).
* DRAM — operand + writeback bytes at 128 GB/s.
* eviction policy — rolling (HACC-RE) frees a hashline at counter zero;
  barrier (HACC-BE) holds all lines until a row barrier, and demand past
  the HashPad round-trips to DRAM (the paper's Fig 15 contrast).

Calibration: the fitted constants below are the reference's.

What runs where: ``stats_from_coo`` expands the partial products,
dedups their keys and ``mapping_loads`` counts per unit as torch ops on
``device`` (the card unless the caller asks for the CPU), and the
integers and arrays they return equal the reference's.  Every draw the
reference makes from numpy (the row-tag sample, the ``random`` and
``drhm`` lookups, the CPI samples) is the same numpy ``Generator`` call on
the host, since torch has no generator that gives numpy's streams.  The
rest is the reference's scalar arithmetic in Python floats, so
``SimResult`` fields equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.neurasim.machine import TileConfig

# The reference's constants, fitted once on the Table-1 fast set against
# the paper's published Tile-4/16/64 GOP/s (5.15/24.75/30.69).
MMH4_CYCLES = 4          # 4 rows × (issue+decode overlap) per instruction
HACC_CYCLES = 1          # hash + accumulate, pipelined
COLLISION_PENALTY = 4    # probe-and-insert on tag mismatch
BYTES_PER_NNZ = 12       # value + index per stored nonzero
B_STREAM_BYTES = 1.5     # B-operand bytes/pp missing reuse, at 3MB HashPad
PAD_EXP = 1.0            # reuse-miss scaling vs HashPad size
COMP_EXP = 0.5           # probe-cost scaling vs comparators per engine
QUEUE_OVERHEAD = 1.0     # NoC/issue-queue bubbles per HACC
RHO = 0.25               # fraction of mapping skew NOT absorbed by buffers
ETA = 1.0                # global efficiency (absorbed into fitted terms)

SAMPLE_CAP = 2_000_000   # row tags kept per workload (a uniform sample)
MODULAR_GAMMA = 2654435761


@dataclasses.dataclass
class WorkloadStats:
    """Exact statistics of one SpGEMM / SpMM workload; ``row_tags`` (the
    destination row of each partial product, sampled past ``SAMPLE_CAP``)
    is an int64 tensor on the device that computed it."""
    n_rows: int
    nnz_a: int
    pp_interim: int          # interim partial products (Gustavson)
    nnz_out: int
    row_tags: torch.Tensor


def _on(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(a).to(device=dev, dtype=torch.int64)


def mapping_loads(row_tags, n_units: int, mapping: str, seed: int = 0,
                  device: DeviceLike = None) -> torch.Tensor:
    """Partial products per NeuraMem unit under a mapping policy, counted
    on ``device`` → (n_units,) int64.  The reference hashes in uint64;
    every product here stays below 2**63, so int64 gives the same units
    (``modular``: tags below 2**63 / 2654435761; ``drhm``: a 16-bit tag
    times an odd gamma below 2**32).  ``drhm`` reseeds its gamma every
    ``n // 64`` partial products, the reference's default; the
    reference's ``gamma`` (never read) and ``reseed_every`` options are
    left out."""
    dev = resolve_device(device)
    tags = _on(row_tags, dev)
    n = tags.numel()
    if mapping == "ring":
        units = tags % n_units
    elif mapping == "modular":
        if n and int(tags.max()) >= (1 << 63) // MODULAR_GAMMA:
            raise ValueError("modular mapping: a tag times 2654435761 "
                             "passes 2**63")
        units = (tags * MODULAR_GAMMA) % n_units
    elif mapping == "random":
        rng = np.random.default_rng(seed)
        lut = rng.integers(0, n_units, size=int(tags.max()) + 1)
        units = _on(lut, dev)[tags]
    elif mapping == "drhm":
        # reseed gamma after every `reseed_every` pps (≙ per-row reseed)
        reseed_every = max(1, n // 64)
        rng = np.random.default_rng(seed)
        n_seg = (n + reseed_every - 1) // reseed_every
        gammas = rng.integers(1, 2**31, size=n_seg, dtype=np.int64) * 2 + 1
        seg = torch.arange(n, device=dev) // reseed_every
        low = tags & 0xFFFF
        prod = (low * _on(gammas, dev)[seg]) & 0xFFFFFFFF
        shift = 32 - max(1, int(np.ceil(np.log2(max(n_units, 2)))))
        units = (prod >> shift) % n_units
    else:
        raise ValueError(mapping)
    return torch.bincount(units, minlength=n_units)


def imbalance_factor(loads) -> float:
    """max / mean of the per-unit loads (1.0 when all are 0), in numpy's
    float64 as the reference computes it."""
    loads = np.asarray(loads.cpu() if isinstance(loads, torch.Tensor)
                       else loads)
    mean = loads.mean()
    return float(loads.max() / mean) if mean > 0 else 1.0


@dataclasses.dataclass
class SimResult:
    cycles: float
    gops: float
    multiply_cycles: float
    accumulate_cycles: float
    dram_cycles: float
    imbalance: float
    bound: str
    hashpad_overflow_bytes: float = 0.0


def simulate_spgemm(w: WorkloadStats, cfg: TileConfig, mapping: str = "drhm",
                    eviction: str = "rolling", seed: int = 0) -> SimResult:
    """The model's cycles and GOP/s for ``w`` on ``cfg``; the mapping's
    loads are counted on the device that holds ``w.row_tags``."""
    # --- multiply stage (NeuraCores) ---
    n_mmh4 = (w.nnz_a + 3) // 4 * 4  # 4×4 tiles: ~nnz_A/4 instrs × 4 rows
    mult_cycles = (n_mmh4 / 4) * MMH4_CYCLES / cfg.total_pipelines

    # --- accumulate stage (NeuraMems) ---
    loads = mapping_loads(w.row_tags, cfg.total_mems, mapping, seed=seed,
                          device=w.row_tags.device)
    imb = imbalance_factor(loads)
    eff_imb = 1.0 + RHO * (imb - 1.0)   # on-chip buffers absorb transients
    live_rows = w.nnz_out / max(cfg.total_mems, 1)
    p_coll = min(0.5, live_rows / (cfg.hashlines_per_mem * 4.0)) \
        * (4.0 / cfg.comparators_per_engine) ** COMP_EXP
    hacc_per_engine = (w.pp_interim / cfg.total_hash_engines) * eff_imb
    acc_cycles = hacc_per_engine * QUEUE_OVERHEAD * (
        HACC_CYCLES + p_coll * COLLISION_PENALTY)

    # --- DRAM stream ---
    b_stream = B_STREAM_BYTES * (3.0 / cfg.hashpad_total_mb) ** PAD_EXP
    byts = (w.nnz_a * BYTES_PER_NNZ          # A operands
            + w.pp_interim * b_stream        # B rows (post-reuse misses)
            + w.nnz_out * BYTES_PER_NNZ)     # rolling-eviction writeback
    overflow = 0.0
    if eviction == "barrier":
        # lines held to the row barrier: live demand = whole output tile set;
        # overflow round-trips to DRAM (the paper's Fig-15 contrast)
        hashpad_bytes = cfg.hashpad_total_mb * 1e6
        demand = w.nnz_out * 16.0            # tag+data+counter per line
        overflow = max(0.0, demand - hashpad_bytes) * 2
        byts += overflow
        acc_cycles *= 1.15                   # barrier drain bubbles
    dram_cycles = byts / cfg.dram_bw_gbps    # GB/s at 1 GHz ⇒ bytes/cycle

    cycles = max(mult_cycles, acc_cycles, dram_cycles) / ETA
    terms = {"multiply": mult_cycles, "accumulate": acc_cycles,
             "dram": dram_cycles}
    gops = 2.0 * w.pp_interim / cycles  # useful flops: mul+add per pp
    return SimResult(cycles=cycles, gops=gops, multiply_cycles=mult_cycles,
                     accumulate_cycles=acc_cycles, dram_cycles=dram_cycles,
                     imbalance=imb, bound=max(terms, key=terms.get),
                     hashpad_overflow_bytes=overflow)


# ---------------------------------------------------------------------------
# Instruction-level CPI sampling (Fig 14 / Fig 15 reproductions): numpy draws
# ---------------------------------------------------------------------------

def sample_mmh_cpi(tile_rows: int, cfg: TileConfig, n: int = 20000,
                   seed: int = 0) -> np.ndarray:
    """Cycles-per-instruction samples for MMHk (k = tile_rows).

    Larger MMH tiles amortize decode but hold registers longer and raise the
    memory-response fan-in — reproducing the paper's Fig-14 sweet spot at
    MMH4."""
    rng = np.random.default_rng(seed)
    decode = 2.0
    rows = tile_rows
    # per-instruction: decode + rows×issue + wait for rows² mem responses
    mem_wait = rng.gamma(shape=rows * rows / 4.0,
                         scale=8.0 / cfg.pipelines_per_core, size=n)
    reg_pressure = np.maximum(
        0.0, rows * 2.0 - cfg.pipeline_registers) * rng.random(n) * 4.0
    return decode + rows + mem_wait / rows + reg_pressure


def sample_hacc_cpi(eviction: str, cfg: TileConfig, n: int = 20000,
                    occupancy: float = 0.5, seed: int = 0) -> np.ndarray:
    """HACC completion cycles under rolling vs barrier eviction (Fig 15)."""
    rng = np.random.default_rng(seed)
    probe = 1.0 + (rng.random(n) < min(0.5, occupancy)) * COLLISION_PENALTY
    if eviction == "rolling":
        return probe
    # barrier: line residency adds a queueing wait proportional to occupancy
    wait = rng.exponential(scale=4.0 * occupancy / (1.0001 - occupancy),
                           size=n)
    return probe + wait


# ---------------------------------------------------------------------------
# Workload builders
# ---------------------------------------------------------------------------

def _sample_tags(tags: torch.Tensor, sample_cap: int) -> torch.Tensor:
    """The reference's uniform sample of ``sample_cap`` tags (numpy's
    ``choice`` drawn on the host) taken on the tags' device."""
    if tags.numel() <= sample_cap:
        return tags
    idx = np.random.default_rng(0).choice(tags.numel(), sample_cap,
                                          replace=False)
    return tags[_on(idx, tags.device)]


def stats_from_coo(rows, cols, n: int, b_rows=None, b_cols=None,
                   m: Optional[int] = None, sample_cap: int = SAMPLE_CAP,
                   device: DeviceLike = None) -> WorkloadStats:
    """Exact Gustavson statistics for C = A@B (B defaults to A), the
    partial products expanded and their (row, col) keys deduplicated on
    ``device``.  ``rows``/``cols`` are A's COO (arrays or tensors)."""
    dev = resolve_device(device)
    rows, cols = _on(rows, dev), _on(cols, dev)
    if b_rows is None:
        b_rows, b_cols, m = rows, cols, n
    else:
        b_rows, b_cols = _on(b_rows, dev), _on(b_cols, dev)
    deg_b = torch.bincount(b_rows, minlength=m)
    lens = deg_b[cols]
    pp = int(lens.sum())
    # expand the partial products (a vectorized CSR walk) for nnz_out and
    # the row tags
    order = torch.argsort(b_rows, stable=True)
    b_cols_sorted = b_cols[order]
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    torch.cumsum(deg_b, 0, out=indptr[1:])
    starts = torch.repeat_interleave(indptr[cols], lens, output_size=pp)
    offs = torch.arange(pp, device=dev) - torch.repeat_interleave(
        torch.cumsum(lens, 0) - lens, lens, output_size=pp)
    pp_cols = b_cols_sorted[starts + offs]
    del starts, offs
    pp_rows = torch.repeat_interleave(rows, lens, output_size=pp)
    nnz_out = int(torch.unique(pp_rows * m + pp_cols).numel())
    return WorkloadStats(n_rows=n, nnz_a=rows.numel(), pp_interim=pp,
                         nnz_out=nnz_out,
                         row_tags=_sample_tags(pp_rows, sample_cap))


def stats_spmm_dense(rows, cols, n: int, d: int,
                     device: DeviceLike = None) -> WorkloadStats:
    """GCN aggregation: A (sparse) × X (n × d dense) — every nnz yields d
    pps."""
    tags = _on(rows, resolve_device(device))
    return WorkloadStats(n_rows=n, nnz_a=tags.numel(),
                         pp_interim=tags.numel() * d, nnz_out=n * d,
                         row_tags=_sample_tags(tags, SAMPLE_CAP))
