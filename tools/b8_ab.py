#!/usr/bin/env python3
"""B8 (``flash_attention``) from several checkouts, in turns, on one GPU.

    python3 tools/b8_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repo (for example the parent commit
unpacked with ``git archive`` into an ignored directory, and ``.``).  The
roots run one after another, each in its own process that imports that
root's ``repro_torch`` and builds B8 from that root's source, so give
them in turns (``parent . . parent``; ``tools/in_turns.py`` runs them).
Every process times, by the same code, B8 at qwen3-0.6b's attention shape
(BH = 16 repeated heads, S = 4096, d = 128; phase 12's) and at gemma-7b's
(d = 256; phase 23's) in f32 and bf16 on the same seeded inputs, from a
replayed CUDA graph, and hashes the outputs.  Prints the card's name and
power limit first, one JSON line a process, then a JSON summary of the
medians a root and whether the outputs' bits agree across roots; exits
non-zero without a GPU or when a process fails.
"""
from __future__ import annotations

import hashlib
import pathlib
import sys

import in_turns

BH, S, DIMS = 16, 4096, (128, 256)
DTYPES = ("float32", "bfloat16")


def measure(root: pathlib.Path) -> dict:
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import chip_smoke as c
    from repro_torch.kernels.flash_attention import flash_attention
    dev = torch.device("cuda")
    out = {"root": str(root)}
    for d in DIMS:
        gen = torch.Generator(device=dev).manual_seed(12)
        flat = [torch.randn((BH, S, d), generator=gen, device=dev)
                for _ in range(3)]
        for name in DTYPES:
            q, k, v = (t.to(getattr(torch, name)) for t in flat)
            y = flash_attention(q, k, v).float().cpu().numpy()
            out[f"{name}_d{d}"] = dict(
                ms=c.graph_ms(lambda: flash_attention(q, k, v), calls=5,
                              replays=4),
                sha256=hashlib.sha256(y.tobytes()).hexdigest())
    return out


if __name__ == "__main__":
    sys.exit(in_turns.main(__file__, measure, sys.argv[1:]))
