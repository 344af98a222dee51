"""serve_mfu_pct: the operations the served seeds' answers need, counted
from shapes (``pbcore.work.sampled_tree_work``), over the traced window's
wall time, as a share of the card's peak in the precision the steps run
in."""
from pbcore.readers import mfu_pct


def read(run):
    return mfu_pct(run)
