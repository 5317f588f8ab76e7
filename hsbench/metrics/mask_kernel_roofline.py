"""kernels: the mask kernel's share of its roofline in the profiled
slice: the least time of every compare_mask and range_mask launch (its
bytes over the card's peak bandwidth, hsbench/roofline.py) over the
device time of the ``mask_kernel`` records."""

from hsbench import roofline


def read(r):
    return roofline.kernel_share(r, "mask_kernel")
