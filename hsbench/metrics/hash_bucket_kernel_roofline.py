"""kernels: the hash-bucket kernel's share of its roofline in the
profiled slice (the bucketed join's probe side hashes its keys with it):
the least time of every hash_bucket launch (hsbench/roofline.py) over the
device time of the ``hash_bucket_kernel`` records."""

from hsbench import roofline


def read(r):
    return roofline.kernel_share(r, "hash_bucket_kernel")
