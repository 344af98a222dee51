"""train_mfu_pct: the model operations counted from shapes
(``pbcore.work.gcn_train_step``) over the traced window's wall time, as a
share of the card's peak in the precision the step runs in."""
from pbcore.readers import mfu_pct


def read(run):
    return mfu_pct(run)
