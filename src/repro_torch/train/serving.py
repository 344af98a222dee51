"""Continuous-batching LM serving scheduler (port of
``repro.train.serving``): slot-based, vLLM-lite.

A fixed pool of ``n_slots`` decode lanes over one shared KV cache:
requests join free slots (prefill writes their prompt KV at the slot's
rows), every engine step decodes ONE token for all active slots, and
finished slots (EOS or ``max_new``) are freed at once for waiting
requests — no head-of-line blocking on long generations.

The decode step is ``transformer.decode_step_ragged`` (a cache position a
row); the scheduler is host logic, held against offline one-request-at-a-
time generation for equal tokens.  Slot bookkeeping and admission packing
are ``serve.scheduler``'s ``SlotPool``/``pack_fifo``, which the GNN
dynamic batcher schedules with too.

The cache tensors are owned by the batcher and written in place: a slot's
prompt KV goes into ``[..., i:i+1, :P]`` of each leaf.  The slots' last
tokens and positions go to the device once a step
(``device.host_to_device``), and the step's argmax tokens come back once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import host_to_device
from repro_torch.serve.scheduler import SlotPool, pack_fifo


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Engine around (prefill_fn, decode_fn) with per-slot cache state.

    prefill_fn(tokens (1, P)) -> (logits (1, V), kv tree of (..., 1, P,
    KV, hd) leaves); decode_fn(tokens (n_slots, 1), cache, positions
    (n_slots,)) -> (logits (n_slots, V), cache).  ``init_cache(n_slots,
    s_max)`` makes the cache, whose device the batcher sends its inputs
    to."""

    def __init__(self, n_slots: int, s_max: int, init_cache: Callable,
                 prefill_fn: Callable, decode_fn: Callable,
                 eos_id: Optional[int] = None):
        self.n_slots = n_slots
        self.s_max = s_max
        self.cache = init_cache(n_slots, s_max)
        self.device = tree.leaves(self.cache)[0].device
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.eos_id = eos_id
        self.pool = SlotPool(n_slots)
        self.pos = np.zeros(n_slots, np.int32)   # next cache index per slot
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.last_tok = np.zeros((n_slots, 1), np.int32)
        self.finished: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        admitted, self.queue, _ = pack_fifo(self.queue, self.pool.free_count)
        for req in admitted:
            i = self.pool.acquire(req.rid)
            logits, kv = self.prefill_fn(
                host_to_device(req.prompt[None, :], self.device))
            p = req.prompt.shape[0]
            # the prompt KV into slot i's cache rows:
            # dst (..., n_slots, s_max, KV, hd); src (..., 1, P, KV, hd)
            for dst, src in zip(tree.leaves(self.cache), tree.leaves(kv)):
                dst[..., i:i + 1, :p, :, :] = src.to(dst.dtype)
            tok = int(torch.argmax(logits[0]))
            req.out.append(tok)
            self.last_tok[i, 0] = tok
            self.pos[i] = p
            self.active[req.rid] = req

    def _finish(self, i: int):
        req = self.active.pop(self.pool.release(i))
        req.done = True
        self.finished.append(req)

    def step(self) -> int:
        """Admit + one decode step for all active slots; returns #active."""
        self._admit()
        live = self.pool.live()
        if not live:
            return 0
        logits, self.cache = self.decode_fn(
            host_to_device(self.last_tok, self.device), self.cache,
            host_to_device(self.pos, self.device))
        toks = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        for i, rid in live:
            req = self.active[rid]
            tok = int(toks[i])
            req.out.append(tok)
            self.last_tok[i, 0] = tok
            self.pos[i] += 1
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if len(req.out) >= req.max_new or hit_eos \
                    or self.pos[i] >= self.s_max - 1:
                self._finish(i)
        return len(self.active)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Step until nothing is active or queued (at most ``max_steps``
        steps); returns the requests that finished in this run, in finishing
        order (the reference's ``run`` returns an empty list)."""
        start = len(self.finished)
        for _ in range(max_steps):
            self.step()
            if not self.active and not self.queue:
                break
        return self.finished[start:]
