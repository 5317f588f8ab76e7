"""The byte functions give the roofline's bytes on known shapes, and the
reductions from device records and spans add up."""

import pytest
import torch

from hsbench import reduce, roofline


@pytest.mark.parametrize("dtype,itemsize", [(torch.int32, 4), (torch.float32, 4)])
def test_mask_bytes(dtype, itemsize):
    x = torch.zeros(1000, dtype=dtype)
    # compare_mask's arguments: (x ptr, dtype code, n, literal bits, op, out ptr)
    assert roofline.launch_bytes("compare_mask", x, (0, 1, 1000, 0, 4, 0)) == 1000 * (itemsize + 1)
    # range_mask's: (x ptr, dtype code, n, lo, hi, lo_incl, hi_incl, out ptr)
    assert roofline.launch_bytes("range_mask", x, (0, 1, 1000, 0, 9, 1, 1, 0)) == 5000


def test_build_kernel_bytes():
    ids = torch.zeros(60, dtype=torch.int32)
    # hash_bucket: (column ptrs, columns, n, buckets, hashes ptr or None, ids ptr)
    assert roofline.launch_bytes("hash_bucket", ids, (0, 2, 60, 32, None, 0)) == 60 * 4 * 3
    assert roofline.launch_bytes("hash_bucket", ids, (0, 2, 60, 32, 123, 0)) == 60 * 4 * 4
    # bucket_histogram: (ids ptr, n, buckets, counts ptr)
    assert roofline.launch_bytes("bucket_histogram", ids, (0, 60, 32, 0)) == 4 * (60 + 32)
    x = torch.zeros(15_000_000, dtype=torch.int32)
    # masked_minmax: (x ptr, valid ptr or None, dtype code, n, pad, out ptr)
    assert roofline.launch_bytes("masked_minmax", x, (0, None, 1, 15_000_000, 0, 0)) \
        == 60_000_000 + 16
    assert roofline.launch_bytes("masked_minmax", x, (0, 7, 1, 15_000_000, 0, 0)) \
        == 75_000_000 + 16


def test_least_time_of_a_full_column():
    # A 60M-row int32 mask: 300 MB over 3.35 TB/s, 89.6 us.
    assert roofline.least_seconds(roofline.mask_bytes(60_000_000, 4)) == pytest.approx(8.955e-5,
                                                                                      rel=1e-3)


def test_union_gaps_and_names():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (-1.0, 0.2)]
    assert reduce.union(iv, 0.0, 5.0) == [(0.0, 2.0), (3.0, 4.0)]
    assert reduce.covered(iv, 0.0, 5.0) == pytest.approx(3.0)
    assert reduce.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert reduce.kernel_name("void mask_kernel<ComparePred, int>(int const*, bool*)") \
        == "mask_kernel"
    assert reduce.kernel_name("masked_minmax_kernel") == "masked_minmax_kernel"
    assert reduce.kernel_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


class _Span:
    def __init__(self, sid, parent, name, start, end):
        self.span_id, self.parent_id, self.name = sid, parent, name
        self.start_perf, self.end_perf = start, end


def test_self_time_and_outermost():
    spans = [_Span("1", None, "query", 0.0, 10.0),
             _Span("2", "1", "exec.stage", 1.0, 9.0),
             _Span("3", "2", "exec.stage", 2.0, 5.0),
             _Span("4", "2", "io.read", 4.0, 6.0),
             _Span("5", "1", "plan.normalize", 0.0, 1.0)]
    kids = reduce.children_of(spans)
    assert reduce.self_seconds(spans[1], kids["2"]) == pytest.approx(4.0)
    assert [s.span_id for s in reduce.outermost(spans, {"exec.stage"})] == ["2"]
