"""Roofline terms of a counted step (port of ``repro.launch.analysis``).

``launch/op_costs`` counts a step's operations, bytes and collectives per
device; this module turns collective sizes into wire bytes and the three
counts into times against one card's peaks.  Wire-byte models (ring
algorithms, g = the collective's group size):

  all-gather          ≈ out_bytes · (g−1)/g
  reduce-scatter      ≈ out_bytes · (g−1)     (= in_bytes · (g−1)/g)
  all-reduce          ≈ 2 · bytes · (g−1)/g   (RS + AG)
  all-to-all          ≈ bytes · (g−1)/g
  collective-permute  ≈ bytes

The reference parses XLA's partitioned HLO text for its collectives
(``collective_bytes``); a torch program has none, so the sizes come from
the functional collectives that ``op_costs`` sees.  The hardware is one
NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit, spec-sheet figures.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# --- NVIDIA H100 80GB HBM3 (SXM5), 700 W: data-sheet peaks, dense -------
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12                # B/s, HBM3
# B/s a GPU on the slowest hop of a 16×16 (or 2×16×16) mesh of H100s:
# eight GPUs a node, so most mesh groups cross nodes over one 400 Gb/s
# NDR InfiniBand adapter a GPU (the data sheet's NVLink is 900 GB/s
# inside a node)
LINK_BW = 50e9

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def wire_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Bytes one device sends for a collective of ``kind`` whose output
    holds ``out_bytes`` on that device, over a group of ``group``."""
    if group <= 1:
        return 0.0
    ring = (group - 1) / group
    if kind == "all-gather":
        return out_bytes * ring
    if kind == "reduce-scatter":
        return out_bytes * (group - 1)
    if kind == "all-reduce":
        return 2 * out_bytes * ring
    if kind == "all-to-all":
        return out_bytes * ring
    if kind == "collective-permute":
        return float(out_bytes)
    raise ValueError(f"unknown collective {kind!r}; one of {COLLECTIVES}")


@dataclasses.dataclass
class CollectiveStats:
    per_op: Dict[str, float]          # op kind → wire bytes (per device)
    total_bytes: float
    op_counts: Dict[str, int]

    def to_json(self):
        return dataclasses.asdict(self)


def collective_stats(per_op: Dict[str, float],
                     op_counts: Dict[str, int]) -> CollectiveStats:
    per = {k: float(per_op.get(k, 0.0)) for k in COLLECTIVES}
    return CollectiveStats(per_op=per, total_bytes=sum(per.values()),
                           op_counts={k: int(op_counts.get(k, 0))
                                      for k in COLLECTIVES})


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops: float                     # per device, counted (op_costs)
    bytes: float                     # per device, counted
    coll_bytes: float                # per device, wire bytes
    model_flops: float               # analytic 6·N·D etc. (global)
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_ratio: float              # model_flops / (flops · n_devices)
    mem_per_device: float = 0.0
    notes: str = ""

    def to_json(self):
        return dataclasses.asdict(self)


def make_roofline(arch, shape, mesh_name, n_devices, flops: float,
                  byts: float, coll_bytes: float, model_flops: float,
                  mem_per_device: float = 0.0, notes: str = "") -> Roofline:
    """flops / byts / coll_bytes are per device, each loop iteration
    counted (an eager step unrolls its loops)."""
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = byts / HBM_BW
    coll_s = coll_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops=flops, bytes=byts, coll_bytes=coll_bytes,
        model_flops=model_flops, compute_s=compute_s, memory_s=memory_s,
        collective_s=coll_s, bottleneck=max(terms, key=terms.get),
        useful_ratio=(model_flops / (flops * n_devices)) if flops else 0.0,
        mem_per_device=mem_per_device, notes=notes,
    )
