"""The rank-1 cross attention's share of its roofline in an eval forward
(p = 0, forward only): its least time at [2, B, 128] (``rank1_work``)
over the device time of the kernels that compute it, named below."""

from benchmark.metrics.rank1_work import roofline_pct

KERNELS = ("rank1_fwd_kernel",)


def read(run):
    return roofline_pct(run, KERNELS, train=False)
