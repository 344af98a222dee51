"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3]

For each of ``--seeds`` it reads the numbers the cell compares, the program
against the reference, at the cell's own size, over a short window of
``--seconds`` (a serving cell's at its own rate).  For each of
``--control-seeds`` (among ``--seeds``) it reads them for the control,
the reference put in the program's place and computed in the nearest
precision below the configuration's (TF32 for f32 with TF32 off), and for
each fault the cell can have, planted in the reference put in the
program's place:

* training: ``half_batch`` (the loss's mean over half the labelled nodes),
  ``altered`` (one labelled node in a hundred with its label altered);
  a step that returns its state unchanged reads 1 by construction;
* serving: ``half_batch`` (each mean over the first half of a node's
  sampled children), ``altered`` (one answer row swapped with another).

Prints one JSON line a reading and a summary: the largest program reading
and the smallest control and fault readings of each number.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from pbcore import env  # noqa: E402

env.one_thread_pools()


def say(**rec):
    print(json.dumps(rec, default=float), flush=True)


def train_readings(cell, seeds, control_seeds, seconds, device):
    """Each seed's numbers: the first steps, then a window of ``seconds``
    and its last step; the control and faults on ``control_seeds`` (among
    ``seeds``), each from the same inputs and from the same state before
    that seed's last window step."""
    import torch
    drv = cell.driver()
    cfg, dev = cell.config, torch.device(device)
    s, r = drv.graph(cfg, dev)
    g, step, init_state = drv.program(cfg, s, r, dev)
    out = {"program": [], "control": [], "half_batch": [], "altered": []}
    b1 = cfg["optimizer"]["b1"]
    kept = {}
    for seed in seeds:
        x, labels, mask, params = drv.inputs(cfg, seed, dev)
        params0 = {k: v.clone() for k, v in drv.flat(params).items()}
        batch = {"x": x, "senders": g.senders, "receivers": g.receivers,
                 "edge_weight": g.edge_weight, "edge_valid": g.edge_valid,
                 "labels": labels, "label_mask": mask}
        p, o, losses, grads = drv.first_steps(step, params, init_state(params),
                                              batch, cfg["check_steps"], b1)
        got = (losses, grads, drv.flat(p))
        steps, failed, before, (p, o), loss = drv.window(step, p, o, batch,
                                                         seconds)
        before_p, before_o, after_p = drv.flat(before[0]), before[1], \
            drv.flat(p)
        del p, o, before
        want = drv.reference(cfg, s, r, x, labels, mask, params0)
        gaps = drv.compare(cfg, got, want, params0)
        want_last = drv.reference(cfg, s, r, x, labels, mask, before_p,
                                  state=before_o)
        gaps.update(drv.compare_last(loss, before_p, after_p, want_last))
        out["program"].append(gaps)
        say(kind="program", seed=seed, window_steps=steps, failed=failed,
            **gaps)
        if seed in control_seeds:
            kept[seed] = (x, labels, mask, params0, before_p, before_o,
                          want, want_last)
    for seed in control_seeds:
        x, labels, mask, params0, before_p, before_o, want, want_last = \
            kept.pop(seed)
        on = torch.nonzero(mask).flatten()
        half = mask.clone()
        half[on[1::2]] = False
        bad = labels.clone()
        pick = on[::100]
        bad[pick] = (bad[pick] + 1) % cfg["out_channels"]
        for kind, lab, msk, prec in (("control", labels, mask, "tf32"),
                                     ("half_batch", labels, half, "float32"),
                                     ("altered", bad, mask, "float32")):
            first = drv.reference(cfg, s, r, x, lab, msk, params0, prec)
            last = drv.reference(cfg, s, r, x, lab, msk, before_p, prec,
                                 state=before_o)
            gaps = drv.compare(cfg, first, want, params0)
            gaps.update(drv.compare_last(last[0][0], before_p, last[2],
                                         want_last))
            out[kind].append(gaps)
            say(kind=kind, seed=seed, **gaps)
    return out


def serve_readings(cell, seeds, control_seeds, seconds, device):
    import torch
    from pbref import sage_serve as ref
    drv = cell.driver()
    cfg, traffic, dev = cell.config, cell.traffic, torch.device(device)
    fan, key = tuple(cfg["fanouts"]), cfg["sampler_key"]
    n = cfg["graph"]["nodes"]
    indptr, indices = drv.graph(cfg, dev)
    out = {"program": [], "control": [], "half_batch": [], "altered": []}
    kept = {}
    for seed in seeds:
        x, params = drv.inputs(cfg, seed, dev)
        due, nodes = drv.schedule(traffic, seconds, seed, n)
        server = drv.program(cfg, indptr, indices, x, params, False, 0, dev)
        server.warmup(buckets=drv.ladder(cfg, traffic))
        with drv.prompt_generator():
            off = drv.offer(server, due, nodes, seconds, drv.pick_checked(
                nodes, traffic["check_requests"], seed))
            off.settle(off.t0 + seconds + traffic["settle_wait_s"],
                       server.clock)
        served = [off.kept[i] for i in sorted(off.kept)]
        got = [r.result for r in served]
        asked = [(r.rid, r.seeds) for r in served]
        unsettled = int((~off.settled).sum())
        server.close()
        del server, off
        want = ref.answers(indptr, indices, x, drv.flat(params), fan, key,
                           asked)
        gap = drv.serve_gap(got, want)
        out["program"].append({"serve_gap": gap})
        say(kind="program", seed=seed, serve_gap=gap, unsettled=unsettled,
            checked=len(asked))
        if seed in control_seeds:
            kept[seed] = (x, params, asked, want)
        else:
            del x
        gc.collect()
        torch.cuda.empty_cache()
    for seed in control_seeds:
        x, params, asked, want = kept.pop(seed)
        flat = drv.flat(params)
        tf32 = ref.answers(indptr, indices, x, flat, fan, key, asked, "tf32")
        half = []
        for rid, seeds_ in asked:
            levels, valid = ref.sampler.sample(
                indptr, indices, seeds_, fan, key,
                ref.sampler.tree_keys(rid, len(seeds_)))
            for lv, (v, f) in enumerate(zip(valid[1:], fan)):
                v = v.reshape(v.shape[0], -1, f).copy()
                v[:, :, (f + 1) // 2:] = False
                valid[lv + 1] = v.reshape(v.shape[0], -1)
            half.append(ref.forward(x, flat, levels, valid, fan))
        swapped = [w.clone() for w in want]
        big = max(range(len(swapped)), key=lambda i: swapped[i].shape[0])
        swapped[big][[0, 1]] = swapped[big][[1, 0]]
        for kind, got in (("control", tf32), ("half_batch", half),
                          ("altered", swapped)):
            gap = drv.serve_gap([g.cpu().numpy() for g in got], want)
            out[kind].append({"serve_gap": gap})
            say(kind=kind, seed=seed, serve_gap=gap)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    env.pin_caches(ROOT)
    sys.path.insert(0, str(ROOT / "src"))
    from pbcore.spec import load_cell
    cell = load_cell(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",")]
    t = time.perf_counter()
    if not set(control) <= set(seeds):
        raise SystemExit("control seeds must be among --seeds")
    if cell.traffic["driver"] == "gnn_train_full":
        out = train_readings(cell, seeds, control, args.seconds, "cuda")
    else:
        out = serve_readings(cell, seeds, control, args.seconds, "cuda")
    names = sorted(out["program"][0])
    summary = {"program_max": {k: max(r[k] for r in out["program"])
                               for k in names}}
    for kind in ("control", "half_batch", "altered"):
        summary[f"{kind}_min"] = {k: min(r[k] for r in out[kind])
                                  for k in names}
    say(kind="summary", seconds=time.perf_counter() - t, **summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
