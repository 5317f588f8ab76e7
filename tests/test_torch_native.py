"""The native host runtime (``hyperspace_tpu_torch/native/``) against the
JAX package's (``hyperspace_tpu/native/``), on the CPU.

Both packages build their own copy of ``hst_native.cpp`` with g++ at first
use. The same avro files go through the JAX package's ``read_avro`` (its
native route), the port's ``read_avro`` (native) and the port's
``read_avro_plain`` (the row-by-row Python decoder, the plain version):
every primitive, nullable unions in either branch order, dates, both
codecs, zero-object blocks, several blocks, and corrupt blocks with the
same message. The sketch probes' C++ loops (``HST_NATIVE_PROBE=force``,
set with monkeypatch only) and their numpy form equal the JAX package's
over seeded bloom bitsets and min/max rows: every op code, infinite and
NaN literals, int-domain literal edges and files without a sketch.
"""

import datetime
import json
import math
import zlib

import numpy as np
import pyarrow as pa
import pytest

from hyperspace_tpu import native as jnative
from hyperspace_tpu.util import avro as javro
from hyperspace_tpu_torch import native as tnative
from hyperspace_tpu_torch.schema import BOOL, DATE, FLOAT32, FLOAT64, INT32, INT64
from hyperspace_tpu_torch.util import avro as tavro
from hyperspace_tpu_torch.util.avro import _encode_bytes, _encode_long

SYNC = b"0123456789abcdef"


def ocf(path, fields, blocks, codec="null"):
    """Write an avro object container file by hand: ``fields`` the record's
    (name, type) pairs, ``blocks`` a list of (row count, encoded rows)."""
    schema = {"type": "record", "name": "R",
              "fields": [{"name": n, "type": t} for n, t in fields]}
    out = bytearray(b"Obj\x01")
    out += _encode_long(2)
    out += _encode_bytes(b"avro.schema") + _encode_bytes(json.dumps(schema).encode())
    out += _encode_bytes(b"avro.codec") + _encode_bytes(codec.encode())
    out += _encode_long(0) + SYNC
    for count, body in blocks:
        if codec == "deflate":
            body = zlib.compress(body)[2:-4]
        out += _encode_long(count) + _encode_long(len(body)) + body + SYNC
    with open(path, "wb") as f:
        f.write(bytes(out))
    return str(path)


def enc_value(prim, v):
    import struct
    return {"boolean": lambda: b"\x01" if v else b"\x00",
            "int": lambda: _encode_long(v), "long": lambda: _encode_long(v),
            "float": lambda: struct.pack("<f", v), "double": lambda: struct.pack("<d", v),
            "string": lambda: _encode_bytes(v.encode()), "bytes": lambda: _encode_bytes(v),
            "null": lambda: b""}[prim]()


# (name, avro type, primitive, null branch or None, value generator)
FIELDS = [
    ("b", "boolean", "boolean", None, lambda r, i: bool(r.integers(0, 2))),
    ("i", "int", "int", None, lambda r, i: int(r.integers(-2 ** 31, 2 ** 31))),
    ("l", "long", "long", None, lambda r, i: int(r.integers(-2 ** 62, 2 ** 62))),
    ("f", "float", "float", None, lambda r, i: float(np.float32(r.standard_normal()))),
    ("d", "double", "double", None, lambda r, i: float(r.standard_normal())),
    ("s", "string", "string", None, lambda r, i: f"s{i}é" * int(r.integers(0, 3))),
    ("y", "bytes", "bytes", None, lambda r, i: bytes(r.integers(0, 256, i % 4).tolist())),
    ("n", "null", "null", None, lambda r, i: None),
    ("dt", {"type": "int", "logicalType": "date"}, "int", None,
     lambda r, i: int(r.integers(-1000, 30000))),
    ("nl", ["null", "long"], "long", 0, lambda r, i: int(r.integers(-9, 9))),
    ("ln", ["long", "null"], "long", 1, lambda r, i: int(r.integers(-9, 9))),
    ("ns", ["string", "null"], "string", 1, lambda r, i: f"x{i}"),
    ("nd", ["null", {"type": "int", "logicalType": "date"}], "int", 0,
     lambda r, i: int(r.integers(0, 20000))),
    ("nf", ["null", "double"], "double", 0, lambda r, i: float(r.standard_normal())),
]


def rows_block(rng, start, count, fields=FIELDS):
    body = bytearray()
    for i in range(start, start + count):
        for _name, _t, prim, nb, gen in fields:
            v = gen(rng, i)
            if nb is not None:
                if rng.random() < 0.3:
                    body += _encode_long(nb)
                    continue
                body += _encode_long(1 - nb)
            body += enc_value(prim, v)
    return bytes(body)


def three_reads(path, columns=None):
    return (javro.read_avro(path, columns), tavro.read_avro(path, columns),
            tavro.read_avro_plain(path, columns))


@pytest.mark.parametrize("codec", ("null", "deflate"))
@pytest.mark.parametrize("layout", ("one", "several", "with_empty"))
def test_avro_native_equals_jax_and_plain(tmp_path, codec, layout):
    rng = np.random.default_rng(7)
    sizes = {"one": [40], "several": [13, 1, 29], "with_empty": [0, 11, 0, 0, 7, 0]}[layout]
    blocks, start = [], 0
    for n in sizes:
        blocks.append((n, rows_block(rng, start, n)))
        start += n
    path = ocf(tmp_path / "t.avro", [(n, t) for n, t, *_ in FIELDS], blocks, codec)
    jt, tn, tp = three_reads(path)
    assert tn.equals(jt) and tp.equals(jt)
    assert tn.num_rows == sum(sizes)
    assert tn.schema.field("dt").type == pa.date32() and tn.schema.field("n").type == pa.null()
    assert tn.column("nl").null_count > 0 and tn.column("ln").null_count > 0
    cols = ["ns", "i", "nd"]
    jt, tn, tp = three_reads(path, cols)
    assert tn.equals(jt) and tp.equals(jt) and tn.column_names == cols


def test_avro_only_empty_blocks_and_no_blocks(tmp_path):
    fields = [(n, t) for n, t, *_ in FIELDS]
    for blocks in ([], [(0, b""), (0, b"")]):
        path = ocf(tmp_path / f"e{len(blocks)}.avro", fields, blocks)
        jt, tn, tp = three_reads(path)
        assert tn.num_rows == 0 and tn.equals(jt) and tp.equals(jt)


def test_avro_writer_round_trip_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    n = 500
    table = pa.table({
        "k": pa.array(rng.integers(-2 ** 40, 2 ** 40, n).astype(np.int64)),
        "x": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.2),
        "s": pa.array([f"v{j}" if j % 5 else None for j in range(n)]),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32), pa.int32()).cast(pa.date32()),
    })
    path = str(tmp_path / "w.avro")
    tavro.write_avro(table, path, codec="deflate", block_rows=64)
    jt, tn, tp = three_reads(path)
    assert tn.equals(table) and tn.equals(jt) and tp.equals(jt)


def _corrupt_cases():
    one_long = [("l", "long")]
    return {
        # a varint cut off by the end of its block
        "truncated varint": (one_long, [(2, _encode_long(5) + b"\xff")]),
        # a union branch past the two a null union has
        "bad branch": ([("u", ["null", "long"])], [(1, _encode_long(2) + _encode_long(1))]),
        # a string longer than its block
        "string past end": ([("s", "string")], [(1, _encode_long(50) + b"ab")]),
        # eleven continuation bytes: a varint past 64 bits
        "varint too long": (one_long, [(1, b"\xff" * 11 + b"\x01")]),
        # a double missing its last bytes
        "short double": ([("d", "double")], [(1, b"\x00\x01")]),
    }


@pytest.mark.parametrize("case", sorted(_corrupt_cases()))
def test_avro_corrupt_block_raises_as_jax(tmp_path, case):
    fields, blocks = _corrupt_cases()[case]
    path = ocf(tmp_path / "bad.avro", fields, blocks)
    messages = []
    for read in (javro.read_avro, tavro.read_avro, tavro.read_avro_plain):
        with pytest.raises(Exception) as e:
            read(path)
        messages.append(str(e.value))
    assert messages[0] == messages[1] == messages[2]
    assert messages[1].startswith("avro: ") and messages[1].endswith(f" in {path}")


def test_avro_invalid_utf8_raises_as_jax(tmp_path):
    path = ocf(tmp_path / "u.avro", [("s", "string")], [(1, _encode_bytes(b"\xff\xfe"))])
    for read in (javro.read_avro, tavro.read_avro, tavro.read_avro_plain):
        with pytest.raises(Exception, match="utf-8|codec"):
            read(path)


def test_native_library_builds_into_the_package(tmp_path):
    lib = tnative.get_lib()
    assert tnative.library_path().startswith(tnative.BUILD_DIR)
    assert lib is tnative.get_lib()


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(tnative.NativeBuildError, match="native build failed"):
        tnative.get_lib()


# ---------------------------------------------------------------------------
# Sketch probes.
# ---------------------------------------------------------------------------

def bloom_rows(n_files, num_bits, num_hashes, seed):
    """Bitsets with the port's own bloom builder over seeded values; every
    fifth file has no sketch."""
    import torch

    from hyperspace_tpu_torch.execution.columnar import Column
    from hyperspace_tpu_torch.ops import sketches
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_files):
        if i % 5 == 4:
            rows.append(None)
            continue
        vals = torch.from_numpy(rng.integers(0, 400, 25).astype(np.int64))
        rows.append(np.asarray(sketches.bloom_build(Column(INT64, vals), num_bits,
                                                    num_hashes)).tobytes())
    return rows


@pytest.mark.parametrize("mode", ("off", "force"))
def test_bloom_probe_equals_jax(monkeypatch, mode):
    monkeypatch.setenv("HST_NATIVE_PROBE", mode)
    rows = bloom_rows(30, 512, 3, seed=11)
    kept = []
    for value in (0, 7, 57, 399, 123456, -5):
        t = tnative.bloom_probe_many(rows, value, INT64, 512, 3)
        j = jnative.bloom_probe_many(rows, value, INT64, 512, 3)
        np.testing.assert_array_equal(t, j)
        assert t[4::5].all()  # no sketch: kept
        kept.append(int(t.sum()))
    assert min(kept) < 30  # the probe prunes something


def minmax_rows(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype in (FLOAT32, FLOAT64):
        lo = rng.uniform(-50, 50, n)
        hi = lo + rng.uniform(0, 20, n)
        lo[3], hi[5] = -math.inf, math.inf
        conv = float
    elif dtype == DATE:
        base = datetime.date(1995, 1, 1)
        lo0 = rng.integers(0, 300, n)
        lo = [base + datetime.timedelta(days=int(x)) for x in lo0]
        hi = [a + datetime.timedelta(days=int(d)) for a, d in zip(lo, rng.integers(0, 60, n))]
        conv = None
    elif dtype == BOOL:
        lo = rng.integers(0, 2, n).astype(bool)
        hi = lo | rng.integers(0, 2, n).astype(bool)
        conv = bool
    else:
        lo = rng.integers(-50, 50, n)
        hi = lo + rng.integers(0, 20, n)
        lo[2], hi[4] = -2 ** 63, 2 ** 63 - 1
        conv = int
    lo = [x if conv is None else conv(x) for x in lo]
    hi = [x if conv is None else conv(x) for x in hi]
    lo[0] = hi[0] = None  # all-null file
    lo[1] = None
    return lo, hi


OPS = ("EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan", "GreaterThanOrEqual")
INT_LITERALS = (0, 5, -50, 69, 2 ** 63 - 1, -2 ** 63, 2 ** 64, -2 ** 64, 5.5, -5.5, 7.0,
                math.inf, -math.inf, math.nan, 1e30, -1e30, 2.0 ** 63, -2.0 ** 63 - 4096.0)
FLOAT_LITERALS = (0.0, 3.25, -49.5, math.inf, -math.inf, math.nan, 7, 10 ** 400, -10 ** 400)


@pytest.mark.parametrize("mode", ("off", "force"))
@pytest.mark.parametrize("dtype", (INT32, INT64, FLOAT32, FLOAT64, DATE, BOOL))
def test_minmax_prune_equals_jax(monkeypatch, mode, dtype):
    monkeypatch.setenv("HST_NATIVE_PROBE", mode)
    lo, hi = minmax_rows(dtype, 24, seed=5)
    if dtype in (FLOAT32, FLOAT64):
        literals = FLOAT_LITERALS
    elif dtype == DATE:
        literals = tuple(datetime.date(1995, 1, 1) + datetime.timedelta(days=d)
                         for d in (-1, 0, 150, 359, 400))
    elif dtype == BOOL:
        literals = (True, False)
    else:
        literals = INT_LITERALS
    for op in OPS:
        for v in literals:
            t = tnative.minmax_prune(lo, hi, op, v, dtype)
            j = jnative.minmax_prune(lo, hi, op, v, dtype)
            np.testing.assert_array_equal(t, j, err_msg=f"{op} {v!r}")
            assert t[0] and t[1]  # files without stats are kept


def test_minmax_prune_strings_have_no_array_form():
    assert tnative.minmax_prune(["a"], ["b"], "EqualTo", "a", "string") is None
    assert jnative.minmax_prune(["a"], ["b"], "EqualTo", "a", "string") is None


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("value", INT_LITERALS)
def test_int_domain_literal_equals_jax(op, value):
    assert tnative._int_domain_literal(op, value) == jnative._int_domain_literal(op, value)


@pytest.mark.parametrize("mode,n,want", [("off", 10 ** 6, False), ("on", 99_999, False),
                                         ("on", 100_000, True), ("force", 1, True),
                                         ("ON", None, True), ("bogus", 10 ** 6, False)])
def test_probe_gate_equals_jax(monkeypatch, mode, n, want):
    monkeypatch.setenv("HST_NATIVE_PROBE", mode)
    assert tnative.probe_native_enabled(n) == jnative.probe_native_enabled(n) == want


def test_probe_min_files_follows_its_variable(monkeypatch):
    monkeypatch.setenv("HST_NATIVE_PROBE", "on")
    monkeypatch.setenv("HST_NATIVE_PROBE_MIN_FILES", "10")
    assert tnative.probe_min_files() == jnative.probe_min_files() == 10
    assert tnative.probe_native_enabled(10) and not tnative.probe_native_enabled(9)
