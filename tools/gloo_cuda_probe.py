#!/usr/bin/env python3
"""Which collectives torch's gloo backend carries on CUDA tensors.

    python3 tools/gloo_cuda_probe.py

For each collective the distributed executor uses, two gloo ranks share
``cuda:0`` (``launch.spmd.spawn``, one world a collective, so one that
hangs costs only its own world's 60 s); the collective runs once on
tensors staged in pinned host memory, then on the CUDA tensors, and the
script prints whether gloo ran it on the CUDA tensors (``hung`` when the
world gave no answer) and whether the result equals the staged one.
``core.distributed`` stages every collective of a gloo world whose
tensors live on a card through pinned host buffers.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def probe_rank(rank, mesh, which):
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank

    def all_gather(t):
        out = torch.empty(2 * t.numel(), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t)
        return out

    def all_reduce(t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    def reduce_scatter(t):
        out = torch.empty(t.numel() // 2, dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t)
        return out

    def all_to_all(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        return out

    def send_recv(t):
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t.contiguous(), 1 - rank),
               dist.P2POp(dist.irecv, out, 1 - rank)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    fn = {"all_gather_into_tensor": all_gather, "all_reduce": all_reduce,
          "reduce_scatter_tensor": reduce_scatter,
          "all_to_all_single": all_to_all, "send_recv": send_recv}[which]
    host = fn(x.cpu().pin_memory())
    try:
        got = fn(x)
        torch.cuda.synchronize()
        return dict(on_cuda=True, equal=bool(torch.equal(got.cpu(), host)))
    except Exception as exc:  # noqa: BLE001 — the probe's answer
        return dict(on_cuda=False,
                    error=f"{type(exc).__name__}: {exc}"[:200])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.launch import spmd
    out = {}
    for which in ("all_gather_into_tensor", "all_reduce",
                  "reduce_scatter_tensor", "all_to_all_single", "send_recv"):
        try:
            out[which] = spmd.spawn(probe_rank, 2, backend="gloo",
                                    device_type="cuda", args=(which,),
                                    timeout=60)[0]
        except RuntimeError as exc:
            out[which] = dict(on_cuda=False, hung="no result" in str(exc),
                              error=str(exc)[-200:])
    print(json.dumps({"torch": torch.__version__, "rank0": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
