"""LM serving driver — continuous batching over decode slots (port of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --requests 8 --slots 4 --prompt-len 64 --gen 32 [--device cpu]

``build_engine`` makes (prefill, ragged decode) step functions and hands
scheduling to ``train/serving.ContinuousBatcher``.  Requests of mixed
prompt and generation lengths join free slots as earlier ones finish.  The
prefill's attention is B8 (``--attention flash``, the default) or the
blocked attention (``--attention blocked``); B8 takes every head dim and
dtype the reference's kernel takes.  The arch runs at its reduced config,
as the reference's launcher runs it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.models.lm import transformer as T
from repro_torch.train.serving import ContinuousBatcher, Request


def build_engine(params, cfg, n_slots: int, s_max: int, eos_id=None,
                 attention: str = "flash") -> ContinuousBatcher:
    """ContinuousBatcher over (prefill, ragged decode) for ``cfg`` with the
    cache on the parameters' device; both steps run without autograd."""
    dev = params["embed"].device

    @torch.no_grad()
    def prefill(tokens):
        return T.prefill(params, cfg, tokens, attention=attention)

    @torch.no_grad()
    def decode(tokens, cache, positions):
        return T.decode_step_ragged(params, cfg, tokens, cache, positions)

    return ContinuousBatcher(
        n_slots, s_max, lambda b, s: T.init_cache(cfg, b, s, device=dev),
        prefill, decode, eos_id=eos_id)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attention", default="flash", choices=T.ATTENTION,
                    help="prefill attention: flash (B8) or blocked")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, reduced=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=dev)
    s_max = args.prompt_len + args.gen + 1
    eng = build_engine(params, cfg, args.slots, s_max,
                       attention=args.attention)

    reqs = []
    for i in range(args.requests):
        # mixed lengths: the slot pool's freed lanes re-admit waiting
        # requests mid-flight — the continuous-batching property
        p = max(4, args.prompt_len - 7 * (i % 3))
        g = max(2, args.gen - 5 * (i % 4))
        prompt = syn.token_batch(1, p, cfg.vocab, seed=args.seed + i)[0]
        req = Request(rid=i, prompt=prompt, max_new=g)
        reqs.append(req)
        eng.submit(req)

    t0 = time.time()
    steps = 0
    while eng.active or eng.queue:
        eng.step()
        steps += 1
    dt = time.time() - t0

    n_tok = sum(len(r.out) for r in reqs)
    if not all(r.done for r in reqs):
        raise RuntimeError("a request did not finish")
    if not all(0 <= t < cfg.vocab for r in reqs for t in r.out):
        raise RuntimeError("a token outside the vocabulary")
    print(f"[serve] {args.arch} (reduced) on {dev}: {args.requests} "
          f"requests on {args.slots} slots → {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.0f} tok/s, {steps} engine steps)  "
          f"sample: {reqs[0].out[:8]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
