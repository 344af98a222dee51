#!/usr/bin/env python3
"""A8c and A8d on one GPU: ``chip_smoke.py``'s phase 21 alone.

    python3 tools/a8_phase.py

Starts the dry run's jobs in the background (its two cells and their
unsharded counts; the whole script starts them with phase 20's
training), builds B2's and B6's libraries (the kernels on the phase's
path and on the DLRM step it counts), traces one training step each of qwen3-0.6b FULL, gcn-cora on
``dense`` and dlrm-rm2 at ``train_batch`` for their device times (the
whole script takes them from phases 20, 13 and 15), then drives
``chip_smoke.phase_a8``: NeuraSim at Table-1 size on the card against the
CPU, A·A through B2 against NeuraSim, gradient compression against the
CPU, counted flops against the fake count, and the dry run's records,
each per-device count between its unsharded count ÷ 256 and that count.
Prints the card's name and power limit first; exits non-zero when there
is no GPU or a check fails.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("a8_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as c
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, embedding_bag, spgemm_pad
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out_dir = pathlib.Path(tempfile.mkdtemp(prefix="dryrun-"))
    dryrun = c.start_dryrun(out_dir)
    try:
        secs = build.build([spgemm_pad.LIBRARY, embedding_bag.LIBRARY])
        dev = resolve_device("cuda")
        t0 = time.perf_counter()
        from repro_torch.models.recsys import dlrm
        params = dlrm.init_params(
            c.dlrm_train_cfg(), torch.Generator(device=dev).manual_seed(0),
            dev)
        device_ms = {
            "qwen3-0.6b": c.lm_train_breakdown(
                dev, c.lm_config())["train_device_ms_per_step"],
            "gcn-cora": c.train_step_breakdown(
                dev, "dense")["device_ms_per_step"],
            "dlrm-rm2": c.dlrm_step_breakdown(
                dev, params, RECSYS_SHAPES["train_batch"].batch)[
                    "device_ms_per_step"]}
        del params
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        a8 = c.phase_a8(dev, card, device_ms, dryrun)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"a8_phase built {secs:.1f} s, step timings "
          f"{t1 - t0:.1f} s, phase {time.perf_counter() - t1:.1f} s; "
          f"B2 launches "
          f"{json.dumps({k: v['launches'] for k, v in a8['spgemm'].items()})}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
