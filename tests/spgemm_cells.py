"""Edited compact-cell inputs of the hash-pad kernels, shared by the SpGEMM
tests on the CPU and on the card.  Imports no JAX."""
import torch


def with_dead_lane_cells(plan, vals, poison):
    """Cell lists with one extra cell per chunk that has a dead lane: lane
    width-1 at the chunk's last bucket (the (bucket, lane) order holds),
    valued ``poison`` → (cell_ptr, cell_lane, cell_bucket, values) on
    ``vals``' device."""
    ptr = plan.cell_ptr.cpu().long()
    rem = plan.ell_remaining.cpu()
    cols = (plan.cell_lane.cpu(), plan.cell_bucket.cpu(), vals.cpu())
    parts = ([], [], [])
    new_ptr = [0]
    for k in range(plan.n_chunks):
        lane, bucket, v = (c[int(ptr[k]):int(ptr[k + 1])] for c in cols)
        if int(rem[k]) < plan.width and lane.numel():
            lane = torch.cat([lane, lane.new_tensor([plan.width - 1])])
            bucket = torch.cat([bucket, bucket[-1:]])
            v = torch.cat([v, v.new_tensor([poison])])
        for out, x in zip(parts, (lane, bucket, v)):
            out.append(x)
        new_ptr.append(new_ptr[-1] + lane.numel())
    dev = vals.device
    return (torch.tensor(new_ptr, dtype=torch.int32, device=dev),
            *(torch.cat(x).to(dev) for x in parts))


def drop_block_chunks(plan, b, tiles, vals, scales=()):
    """Compact inputs with block ``b``'s chunks removed (its chunk range
    empty), ``scales`` cut alike → (remaining, block_ptr, tiles, *scales,
    cell_ptr, cell_lane, cell_bucket, values) on ``tiles``' device."""
    dev = tiles.device
    bp = plan.ell_block_ptr.long()
    k0, k1 = int(bp[b]), int(bp[b + 1])
    c0, c1 = int(plan.cell_ptr[k0]), int(plan.cell_ptr[k1])
    kk = torch.cat([torch.arange(k0), torch.arange(k1, plan.n_chunks)]).to(dev)
    cc = torch.cat([torch.arange(c0), torch.arange(c1, plan.n_cells)]).to(dev)
    new_bp = torch.where(torch.arange(bp.numel(), device=dev) > b,
                         bp - (k1 - k0), bp)
    new_cp = torch.cat([plan.cell_ptr[:k0], plan.cell_ptr[k1:] - (c1 - c0)])
    w = plan.width
    return tuple(t.contiguous() for t in (
        plan.ell_remaining[kk], new_bp.to(torch.int32),
        tiles.reshape(-1, 8, w)[kk].reshape(-1, w), *(s[kk] for s in scales),
        new_cp, plan.cell_lane[cc], plan.cell_bucket[cc], vals[cc]))
