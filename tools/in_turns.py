"""The runner that ``tools/b4_ab.py`` and ``tools/b8_ab.py`` share: one
measurement from several checkouts, in turns, on one GPU.

A tool calls ``main(__file__, measure, argv)``.  Each ROOT in ``argv`` runs
in a process of its own (``TOOL --one ROOT``), one after another in the
order given, so give them in turns (``parent . . parent``); the process
imports that root's ``repro_torch`` and builds that root's kernels (two
builds of one source clash in one process).  ``measure(root)`` returns
``{"root": ..., CASE: {NAME_ms: ..., "sha256": ...}, ...}``.  Prints the
card's name and power limit first, one JSON line a process, then a JSON
summary: each case's medians a root of every ``*ms`` key, and whether its
output bits agree across roots.  Returns non-zero without a GPU, when a
process fails, or, with ``same_bits``, when the bits differ.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys


def main(tool: str, measure, argv, same_bits: bool = False) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(pathlib.Path(argv[1]).resolve())))
        return 0
    import torch
    if not torch.cuda.is_available() or not argv:
        print(f"{pathlib.Path(tool).stem}: needs a GPU and at least one "
              f"checkout root", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    runs = []
    for root in argv:
        proc = subprocess.run([sys.executable, tool, "--one", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    roots = list(dict.fromkeys(r["root"] for r in runs))
    cases = [k for k in runs[0] if k != "root"]
    median_ms = {case: {root: {
        k: statistics.median(r[case][k] for r in runs if r["root"] == root)
        for k in runs[0][case] if k.endswith("ms")} for root in roots}
        for case in cases}
    bits_equal = {case: len({r[case]["sha256"] for r in runs}) == 1
                  for case in cases}
    print(json.dumps({"median_ms": median_ms, "bits_equal": bits_equal}))
    return 1 if same_bits and not all(bits_equal.values()) else 0
