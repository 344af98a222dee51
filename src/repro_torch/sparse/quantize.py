"""Per-tile symmetric int8 quantization for the ``cuda_q8`` kernels' operands.

Port of ``repro.sparse.quantize``.  The ``cuda_q8`` path moves the
Gustavson kernels' coefficient tiles and feature/slab operands as int8 — 4×
fewer device-memory bytes than f32 — and rescales inside the kernel at fold
time.  This module owns the scheme, so the plan layer, both kernels, the
backends and the parity gates agree on one contract:

* **coefficient tiles / B slab** — one scale per dedup chunk:
  ``scale_a[k] = max|A_tile_k| / 127``, constant over chunk ``k``'s whole
  contraction, so it factors out of the fold exactly;
* **feature rows** — one scale per *feature tile* (``d_tile`` columns, the
  kernels' scale tile, ``kernels.gustavson_spmm.auto_d_tile``):
  ``scale_x[j] = max|X[:, jd:(j+1)d]| / 127``;
* all-zero tiles quantize with ``scale = 1.0`` (exact zeros);
* the kernels sum ``int8 × int8`` products in int32: every chunk sum is <
  127·127·width < 2²⁴, so it equals the reference's f32 dot exactly, and
  the only inexactness in the path is the quantization rounding itself.

That makes the **scale-derived error bound** rigorous: per-entry rounding
errors ≤ scale/2 and magnitudes ≤ 127·scale bound each partial product's
deviation by ``127·s_a·s_x``, and a row of output block ``b`` by

    bound(b, j) = Σ_{k: out_block[k]=b} terms_k · 127 · s_a[k] · s_x[j]

``aggregate_q8_bound`` / ``spgemm_q8_bound`` evaluate the max over (b, j)
and ``q8_gate`` holds a measured deviation under it.

The quantizers are plain tensor operations on the input's device and never
read a value back to the host, so a serving step that re-quantizes stays
free of device syncs.  The ``q8.*`` stats the reference records for
concrete values are recorded at plan-build time only (``record_q8_stats``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

Q8_MAX = 127.0
# int8 end-to-end envelope (copied from the reference's
# ``benchmarks/backend_sweep.py``): a model forward composes per-layer
# quantization error through nonlinearities, so model-level int8 results
# are held to this measured envelope, not to the kernel-level bound
Q8_E2E_TOL = 0.05


class QuantizedFeatures(NamedTuple):
    """Resident pre-quantized features: int8 rows + per-feature-tile scales.

    Features quantize once (``quantize_features``) instead of per aggregate
    call; the ``cuda_q8`` executor validates the scale count against the
    plan's feature tile."""

    q8: torch.Tensor          # (N, D) int8
    scale: torch.Tensor       # (ceil(D / d_tile),) f32


def quantize_features(x: torch.Tensor, d_tile: int) -> QuantizedFeatures:
    """One-time feature quantization for the resident path — ``d_tile``
    must be the plan's (``plan.ell_d_tile``, or ``auto_d_tile(D)`` when the
    plan defers)."""
    q8, scale = quantize_feature_tiles(x, d_tile)
    return QuantizedFeatures(q8=q8, scale=scale)


def _safe_scale(maxabs: torch.Tensor) -> torch.Tensor:
    """maxabs/127 with the all-zero guard: a zero tile quantizes with scale
    1.0 so dequantization returns exact zeros.

    The divisor is a tensor on ``maxabs``'s device: PyTorch's CUDA division
    by a Python number multiplies by its reciprocal, which is one ulp off
    the true quotient for some inputs, so a scale — and every int8 rounded
    with it — could differ from the CPU's and the reference's."""
    q8_max = torch.full((), Q8_MAX, dtype=torch.float32,
                        device=maxabs.device)
    scale = maxabs.to(torch.float32) / q8_max
    return torch.where(scale == 0, 1.0, scale)


def _round_clip(v: torch.Tensor) -> torch.Tensor:
    # torch.round, like jnp.round, rounds half to even
    return torch.clamp(torch.round(v), -Q8_MAX, Q8_MAX).to(torch.int8)


def quantize_chunk_tiles(a: torch.Tensor, n_chunks: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk symmetric int8 quantization of a chunk-stacked 2-D layout.

    ``a`` is ``(n_chunks · rows_per_chunk, width)`` — the Gustavson
    coefficient tiles (``rows_per_chunk = block_rows``) or the SpGEMM
    hashed slab (``rows_per_chunk = width``).  Returns ``(q8, scale)``:
    ``q8`` int8 of ``a``'s shape, ``scale`` f32 ``(n_chunks,)``.
    """
    a = a.to(torch.float32)
    if n_chunks == 0:           # empty layout (no valid edges)
        return (torch.zeros(a.shape, dtype=torch.int8, device=a.device),
                torch.zeros((0,), dtype=torch.float32, device=a.device))
    tiles = a.reshape(n_chunks, -1)
    scale = _safe_scale(tiles.abs().amax(dim=1))
    return _round_clip(tiles / scale[:, None]).reshape(a.shape), scale


def quantize_chunk_entries(vals: torch.Tensor, chunk: torch.Tensor,
                           n_chunks: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_chunk_tiles`` of a chunk-stacked layout given only its
    nonzero cells: ``vals[i]`` lies in chunk ``chunk[i]``, every other cell
    is zero.  Returns the int8 value of each cell and the per-chunk scales,
    equal to what the dense layout gives (zeros quantize to zero and do not
    move a chunk's max)."""
    maxabs = torch.zeros(n_chunks, dtype=torch.float32, device=vals.device)
    maxabs.scatter_reduce_(0, chunk.to(torch.int64), vals.abs(), "amax")
    scale = _safe_scale(maxabs)
    return _round_clip(vals / scale[chunk.to(torch.int64)]), scale


def quantize_feature_tiles(x: torch.Tensor, d_tile: int, lanes: int = 1,
                           lane_rows: Optional[int] = None,
                           lane_nodes: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-feature-tile symmetric int8 quantization of ``x (N, D)``.

    One scale per ``d_tile``-wide column block.  Returns ``(x_q8 (N, D)
    int8, scale (ceil(D/d_tile),) f32)``.

    With ``lanes`` > 1, ``x`` is a stack of serving lanes of ``lane_rows``
    rows each (an ``AggregationPlan``'s lanes): every lane gets its own
    scales from its first ``lane_nodes`` rows (default all), as the
    reference quantizes each lane of its vmapped step alone, and ``scale``
    is ``(lanes, ceil(D/d_tile))``.  The padding rows past ``lane_nodes``
    quantize with their lane's scales."""
    x = x.to(torch.float32)
    n, d = x.shape
    d_tile = int(d_tile)
    pad = (-d) % d_tile
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    d_tiles = (d + pad) // d_tile
    if lanes == 1:
        blocks = xp.reshape(n, d_tiles, d_tile)
        scale = _safe_scale(blocks.abs().amax(dim=(0, 2)))
        per_col = torch.repeat_interleave(scale, d_tile)[:d]
        return _round_clip(x / per_col[None, :]), scale
    lane_rows = int(lane_rows)
    live = lane_rows if lane_nodes is None else int(lane_nodes)
    if lanes * lane_rows != n:
        raise ValueError(f"{lanes} lanes of {lane_rows} rows for {n} rows")
    blocks = xp.reshape(lanes, lane_rows, d_tiles, d_tile)[:, :live]
    scale = _safe_scale(blocks.abs().amax(dim=(1, 3)))
    per_col = torch.repeat_interleave(scale, d_tile, dim=1)[:, :d]
    q8 = _round_clip(x.reshape(lanes, lane_rows, d) / per_col[:, None, :])
    return q8.reshape(n, d), scale


def record_q8_stats(scale: torch.Tensor) -> None:
    """The reference's ``q8.*`` stats for one quantized layout.  Reads the
    scales back to the host, so it runs at plan-build time only."""
    from repro_torch.sparse.stats import record_count, record_value
    record_count("q8.tile_quants")
    if scale.numel():
        record_value("q8.scale_max", float(scale.max()))
        record_value("q8.scale_mean", float(scale.mean()))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def aggregate_q8_bound(remaining, out_block, n_blocks: int,
                       a_scale, x_scale) -> float:
    """Worst-case |y_q8 − y_f32| over the aggregate output (host numpy).

    Per-term deviation ≤ 127·s_a[k]·s_x[j]; a row of output block ``b``
    accumulates ``remaining[k]`` live terms from every chunk routed to it.
    """
    rem = _host(remaining)
    ob = _host(out_block).astype(np.int64)
    sa = _host(a_scale)
    per_block = np.bincount(ob, weights=rem * sa, minlength=int(n_blocks))
    sx_max = float(np.max(_host(x_scale), initial=0.0))
    return float(Q8_MAX * per_block.max(initial=0.0) * sx_max)


def spgemm_q8_bound(width: int, out_block, n_blocks: int,
                    a_scale, b_scale) -> float:
    """Worst-case |c_q8 − c_f32| over the SpGEMM output (host numpy).

    Each chunk contributes ≤ ``width`` partial products per output cell;
    per-term deviation ≤ 127·s_a[k]·s_b[k].
    """
    ob = _host(out_block).astype(np.int64)
    sa = _host(a_scale)
    sb = _host(b_scale)
    per_block = np.bincount(ob, weights=sa * sb, minlength=int(n_blocks))
    return float(Q8_MAX * float(width) * per_block.max(initial=0.0))


def q8_gate(dev: float, bound: float, slack: float = 0.01,
            atol: float = 1e-6) -> bool:
    """The quantized parity predicate: measured deviation within the
    scale-derived bound (+1% f32-rounding slack).  NaN devs fail."""
    return bool(dev <= bound * (1.0 + slack) + atol)
