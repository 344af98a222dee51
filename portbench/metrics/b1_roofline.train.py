"""b1_roofline.train: the least time the card could take for the window's
aggregations, counted from their shapes (``pbcore.work``), over the device
time of the kernels the aggregations launch, found in the trace by the
names below."""
from pbcore.readers import b1_roofline_pct

KERNELS = ("spmm_dedup_chunks_kernel",)


def read(run):
    return b1_roofline_pct(run, KERNELS)
