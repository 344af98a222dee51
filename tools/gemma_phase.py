#!/usr/bin/env python3
"""gemma-7b at full width on one GPU: ``chip_smoke.py``'s phase 23 alone.

    python3 tools/gemma_phase.py

Builds B8's library (the one kernel on the LM's path) and drives
``chip_smoke.phase_gemma`` on the card: the FULL bf16 prefill on B8 at
head_dim 256 against the blocked attention, the f32 check at depth 4,
serving through the continuous batcher (then the reduced gemma in f32
against offline decode), the readings, and B8 at gemma's attention shape
in both dtypes; every check of the phase holds, and its lines are printed
as the whole script prints them.  Prints the card's name and power limit
first; exits non-zero when there is no GPU or a check fails.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gemma_phase: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as c
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, flash_attention
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    secs = build.build([flash_attention.LIBRARY])
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    gemma = c.phase_gemma(dev)
    print(f"gemma_phase built {secs:.1f} s, phase "
          f"{time.perf_counter() - t0:.1f} s; B8 launches "
          f"{json.dumps(gemma['launches'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
