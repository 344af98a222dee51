"""Fault-tolerant training loop (port of ``repro.train.loop``).

* checkpoint/restart — async committed checkpoints every ``ckpt_every``
  steps and at the last; on (re)start the loop resumes from the latest
  committed step;
* failure handling — a step that raises triggers restore-from-last-commit
  and replay; after ``max_retries`` consecutive failures the loop aborts;
* straggler detection — per-step wall times feed an EWMA; steps slower
  than ``straggler_factor``× the EWMA are counted and passed to the
  ``on_straggler`` hook.

The loop is model-agnostic: it owns (params, opt_state) and a step_fn of
signature (params, opt_state, batch) → (params, opt_state, metrics).  A
step's time ends when its loss reaches the host (``float(loss)`` waits for
the device, as the reference's ``block_until_ready``).
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Any, Callable, Iterator, Optional

from repro_torch.checkpoint import store


@dataclasses.dataclass
class TrainLoopConfig:
    n_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: Optional[str] = None    # None: a new temporary directory
    keep_ckpts: int = 3
    max_retries: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def _restore(state: TrainState, cfg: TrainLoopConfig, step: int) -> None:
    (state.params, state.opt_state), _ = store.restore(
        cfg.ckpt_dir, step, (state.params, state.opt_state))
    state.step = step


def run(state: TrainState, step_fn: Callable, batches: Iterator,
        cfg: TrainLoopConfig, on_straggler: Optional[Callable] = None,
        fail_injector: Optional[Callable] = None, log: Callable = print):
    """Run to cfg.n_steps; returns (state, history dict).  A ``ckpt_dir``
    of ``None`` becomes a new temporary directory (written back into
    ``cfg``), so a run never resumes another's steps by accident."""
    if cfg.ckpt_dir is None:
        cfg.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    ckpt = store.AsyncCheckpointer(cfg.ckpt_dir)

    latest = store.latest_step(cfg.ckpt_dir)
    if latest is not None and latest > state.step:
        _restore(state, cfg, latest)
        log(f"[restore] resumed from committed step {latest}")

    history = {"loss": [], "step_s": [], "stragglers": 0, "retries": 0}
    ewma = None
    retries = 0
    while state.step < cfg.n_steps:
        batch = next(batches)
        t0 = time.perf_counter()
        try:
            if fail_injector is not None:
                fail_injector(state.step)
            params, opt_state, metrics = step_fn(state.params,
                                                 state.opt_state, batch)
            loss = float(metrics["loss"])
        except Exception as e:  # noqa: BLE001 — the node-failure path
            retries += 1
            history["retries"] += 1
            log(f"[failure] step {state.step}: {type(e).__name__}: {e}")
            if retries > cfg.max_retries:
                ckpt.wait()
                raise RuntimeError(
                    f"aborting after {retries - 1} consecutive failures") from e
            latest = store.latest_step(cfg.ckpt_dir)
            if latest is not None:
                _restore(state, cfg, latest)
                log(f"[restore] rolled back to step {latest}")
            continue
        retries = 0
        dt = time.perf_counter() - t0
        state.params, state.opt_state = params, opt_state
        state.step += 1
        history["loss"].append(loss)
        history["step_s"].append(dt)
        if ewma is not None and dt > cfg.straggler_factor * ewma:
            history["stragglers"] += 1
            if on_straggler is not None:
                on_straggler(state.step, dt, ewma)
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if state.step % cfg.log_every == 0:
            log(f"[step {state.step}] loss={loss:.4f} ({dt*1e3:.0f} ms)")
        if state.step % cfg.ckpt_every == 0 or state.step == cfg.n_steps:
            ckpt.save_async(state.step, (state.params, state.opt_state),
                            metadata={"loss": loss})
            store.gc_keep_last(cfg.ckpt_dir, cfg.keep_ckpts)
    ckpt.wait()
    return state, history
