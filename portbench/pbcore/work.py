"""Operations and bytes counted from shapes: the yardstick of the roofline
and MFU metrics.

Nothing here asks the program what it did.  An aggregation ``Y = A·X``
with ``nnz`` stored entries is counted as one multiply-add per entry and
column, each entry's value and column index read once, each row of ``X``
it reads read once and each row of ``Y`` it writes written once, so the
count is the same whatever implements the aggregation.  Where the work
depends on the data, the count is what these inputs need: a served seed
counts the rows its answer depends on, not the rows a bucket pads to.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from pbcore.peaks import HBM_BYTES_PER_S, flops_peak

# (nnz, rows read, rows written, width) of one aggregation
Spmm = Tuple[int, int, int, int]


def spmm_work(nnz: int, rows_in: int, rows_out: int, d: int,
              elem_bytes: int = 4, index_bytes: int = 4) -> Tuple[int, int]:
    """(operations, bytes) of one aggregation."""
    flops = 2 * nnz * d
    nbytes = (nnz * (elem_bytes + index_bytes)
              + (rows_in + rows_out) * d * elem_bytes)
    return flops, nbytes


def roofline_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of operations over
    the precision's peak and bytes over the memory rate."""
    return max(flops / flops_peak(precision), nbytes / HBM_BYTES_PER_S)


def spmm_roofline_s(calls: Sequence[Tuple[Spmm, float]],
                    precision: str) -> float:
    """The least time of ``(aggregation, how many)`` pairs, each call
    bounded on its own."""
    return sum(n * roofline_s(*spmm_work(*c), precision) for c, n in calls)


def gemm_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def gcn_train_step(n_nodes: int, nnz: int,
                   dims: Sequence[int]) -> Tuple[int, List[Spmm]]:
    """One full-graph GCN training step, ``h ← Â·(h W) + b`` a layer:
    (model operations, the aggregations it needs).

    Forward: ``h W`` and ``Â·(h W)`` each layer.  Backward: ``dW`` each
    layer, ``dH`` each layer but the first (the input features take no
    gradient), and ``Âᵀ·dY`` each layer (``h W`` takes a gradient in every
    layer).  Bias, ReLU, the loss and the optimizer are elementwise and
    left out."""
    flops, calls = 0, []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        flops += gemm_flops(n_nodes, din, dout) * (2 if i == 0 else 3)
        flops += 2 * spmm_work(nnz, n_nodes, n_nodes, dout)[0]
        calls += [(nnz, n_nodes, n_nodes, dout)] * 2
    return flops, calls


def sampled_tree_work(fanouts: Sequence[int],
                      dims: Sequence[int]) -> Tuple[int, List[Spmm]]:
    """What one seed's answer needs of a sampled GraphSAGE forward over
    its fanout tree, ``h_i ← h_i W_self + mean_j h_j W_nbr + b``: (model
    operations, aggregations).

    Layer ``l`` of ``L`` is needed at the tree's levels ``0 … L-1-l``; at
    each of them every node averages its children (one entry per sampled
    edge) and both products run on the level's rows."""
    sizes = [1]
    for f in fanouts:
        sizes.append(sizes[-1] * f)
    n_layers = len(dims) - 1
    if n_layers != len(fanouts):
        raise ValueError(f"{n_layers} layers over {len(fanouts)} hops")
    flops, calls = 0, []
    for layer, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        levels = range(n_layers - layer)
        rows = sum(sizes[j] for j in levels)
        flops += 2 * gemm_flops(rows, din, dout)
        for j in levels:
            call = (sizes[j + 1], sizes[j + 1], sizes[j], din)
            flops += spmm_work(*call)[0]
            calls.append(call)
    return flops, calls
