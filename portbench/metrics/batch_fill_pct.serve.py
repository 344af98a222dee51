"""batch_fill_pct.serve: seeds served over the bucket seeds dispatched
(``GNNServer`` bucket counts) in the traced run."""


def read(run):
    if not run.work.get("bucket_seeds"):
        return None
    return 100.0 * run.work["seeds_served"] / run.work["bucket_seeds"]
