"""Minimal Avro Object Container File reader/writer (counterpart of
``hyperspace_tpu/util/avro.py``; no external dependency). The subset of the
Avro 1.x spec that tabular data uses is implemented here directly:
records of primitives, nullable fields as ``["null", T]`` unions, the
``date`` logical type, and the null/deflate codecs. Arrays, maps, nested
records, and enums are out of scope and rejected loudly. ``read_avro``
decodes every block in one C++ pass (``native.avro_decode_block``), as the
JAX package's reader does; ``read_avro_plain`` decodes row by row in
Python and is the plain version the tests hold the native route to.

Everything converts to/from ``pyarrow.Table`` at the boundary, so the
columnar engine sees avro exactly like any other format.
"""

from __future__ import annotations

import datetime
import io
import json
import struct
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from ..exceptions import HyperspaceException

_MAGIC = b"Obj\x01"
_EPOCH = datetime.date(1970, 1, 1)

_PRIMITIVES = ("null", "boolean", "int", "long", "float", "double",
               "string", "bytes")


# ---------------------------------------------------------------------------
# Binary decoding.
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise HyperspaceException("avro: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def read_long(self) -> int:
        """Zigzag varint (avro int and long share the encoding)."""
        shift = 0
        acc = 0
        while True:
            if self.pos >= len(self.buf):
                raise HyperspaceException("avro: truncated data")
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
            if shift > 70:
                raise HyperspaceException("avro: varint too long")
        return (acc >> 1) ^ -(acc & 1)

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)


def _encode_long(n: int) -> bytes:
    n = (n << 1) ^ (n >> 63) if n < 0 else n << 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode_bytes(b: bytes) -> bytes:
    return _encode_long(len(b)) + b


# ---------------------------------------------------------------------------
# Schema handling.
# ---------------------------------------------------------------------------

def _field_plan(ftype) -> Tuple[str, Optional[int], Optional[str]]:
    """Normalize a field's avro type into (primitive, null_branch, logical)
    where null_branch is the union index of "null" (None for non-nullable
    fields — branch order matters at decode time, both ["null", T] and
    [T, "null"] are legal). Raises for shapes outside the tabular subset."""
    logical = None
    if isinstance(ftype, dict):
        logical = ftype.get("logicalType")
        ftype = ftype.get("type")
        if logical not in (None, "date"):
            logical = None  # other logical types decode as their base type
        if not isinstance(ftype, str):
            raise HyperspaceException(
                f"avro: unsupported complex type {ftype!r}")
        if ftype not in _PRIMITIVES:
            raise HyperspaceException(f"avro: unsupported type {ftype!r}")
        return ftype, None, logical
    if isinstance(ftype, str):
        if ftype not in _PRIMITIVES:
            raise HyperspaceException(f"avro: unsupported type {ftype!r}")
        return ftype, None, None
    if isinstance(ftype, list):
        branches = [t for t in ftype if t != "null"]
        if len(ftype) != 2 or len(branches) != 1:
            raise HyperspaceException(
                f"avro: only two-branch null unions supported, got {ftype!r}")
        null_branch = ftype.index("null")
        prim, _, logical = _field_plan(branches[0])
        return prim, null_branch, logical
    raise HyperspaceException(f"avro: unsupported type {ftype!r}")


def _arrow_type(prim: str, logical: Optional[str]) -> pa.DataType:
    if logical == "date":
        return pa.date32()
    return {
        "boolean": pa.bool_(), "int": pa.int32(), "long": pa.int64(),
        "float": pa.float32(), "double": pa.float64(),
        "string": pa.string(), "bytes": pa.binary(),
        "null": pa.null(),
    }[prim]


def _decoder(prim: str) -> Callable[[_Reader], Any]:
    if prim == "null":
        return lambda r: None
    if prim == "boolean":
        return lambda r: r.read(1) != b"\x00"
    if prim in ("int", "long"):
        return _Reader.read_long
    if prim == "float":
        return lambda r: struct.unpack("<f", r.read(4))[0]
    if prim == "double":
        return lambda r: struct.unpack("<d", r.read(8))[0]
    if prim == "string":
        return lambda r: r.read_bytes().decode("utf-8")
    if prim == "bytes":
        return _Reader.read_bytes
    raise HyperspaceException(f"avro: unsupported type {prim!r}")


# ---------------------------------------------------------------------------
# Reading.
# ---------------------------------------------------------------------------

def _read_header(r: _Reader, path: str) -> Tuple[Dict[str, bytes], bytes]:
    if r.read(4) != _MAGIC:
        raise HyperspaceException(f"avro: bad magic in {path}")
    meta: Dict[str, bytes] = {}
    while True:
        n = r.read_long()
        if n == 0:
            break
        if n < 0:  # block with explicit byte size
            r.read_long()
            n = -n
        for _ in range(n):
            key = r.read_bytes().decode("utf-8")
            meta[key] = r.read_bytes()
    return meta, r.read(16)


def read_avro_schema(path: str) -> pa.Schema:
    """Arrow schema from the OCF header only (no row decoding)."""
    with open(path, "rb") as fh:
        head = fh.read(65536)  # headers are tiny; schema JSON fits easily
    meta, _ = _read_header(_Reader(head), path)
    if "avro.schema" not in meta:
        raise HyperspaceException(f"avro: no schema in {path}")
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    if schema.get("type") != "record":
        raise HyperspaceException("avro: top-level schema must be a record")
    fields = []
    for f in schema.get("fields", []):
        prim, null_branch, logical = _field_plan(f["type"])
        fields.append(pa.field(f["name"], _arrow_type(prim, logical),
                               nullable=null_branch is not None))
    return pa.schema(fields)


def _open_blocks(path: str):
    """(plans, codec, reader, sync) of an OCF file, the reader just past
    the header."""
    with open(path, "rb") as fh:
        data = fh.read()
    r = _Reader(data)
    meta, sync = _read_header(r, path)
    if "avro.schema" not in meta:
        raise HyperspaceException(f"avro: no schema in {path}")
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    if codec not in ("null", "deflate"):
        raise HyperspaceException(f"avro: unsupported codec {codec!r}")
    if schema.get("type") != "record":
        raise HyperspaceException("avro: top-level schema must be a record")
    plans = [(f["name"], *_field_plan(f["type"])) for f in schema.get("fields", [])]
    return plans, codec, r, sync


def _blocks(path: str, codec: str, r: _Reader, sync: bytes):
    """Each block's (row count, inflated bytes), sync markers checked."""
    while not r.at_end():
        count = r.read_long()
        size = r.read_long()
        block = r.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        yield count, block
        if r.read(16) != sync:
            raise HyperspaceException(f"avro: sync marker mismatch in {path}")


def _project(path: str, names: List[str], arrays: List[pa.Array],
             columns: Optional[List[str]]) -> pa.Table:
    if columns is not None:
        missing = [c for c in columns if c not in names]
        if missing:
            raise HyperspaceException(
                f"avro: columns {missing} not in {path}")
        order = {n: i for i, n in enumerate(names)}
        arrays = [arrays[order[c]] for c in columns]
        names = list(columns)
    return pa.table(dict(zip(names, arrays)))


def read_avro(path: str,
              columns: Optional[List[str]] = None) -> pa.Table:
    """Read one OCF file into an arrow table (optionally projecting), each
    block decoded by the native library."""
    from .. import native

    plans, codec, r, sync = _open_blocks(path)
    native_plans = [(prim, nb) for _, prim, nb, _ in plans]
    chunks: List[Tuple[int, List]] = []  # (row count, field pieces)
    for count, block in _blocks(path, codec, r, sync):
        if count == 0:
            # Zero-object blocks are legal (writers emit them on flush) and
            # hold nothing to decode; they switch nothing off.
            continue
        try:
            chunks.append((count, native.avro_decode_block(block, count, native_plans)))
        except ValueError as e:
            raise HyperspaceException(f"avro: {e} in {path}")
    arrays, names = [], []
    for fi, (name, prim, null_branch, logical) in enumerate(plans):
        if columns is not None and name not in columns:
            continue
        if chunks:
            arr = _assemble_native(chunks, fi, prim, null_branch, logical)
        else:
            arr = pa.array([], type=_arrow_type(prim, logical))
        arrays.append(arr)
        names.append(name)
    return _project(path, names, arrays, columns)


def read_avro_plain(path: str,
                    columns: Optional[List[str]] = None) -> pa.Table:
    """``read_avro`` decoded row by row in Python: the plain version of
    the native block decoder (same table, same errors)."""
    plans, codec, r, sync = _open_blocks(path)
    cells: Dict[str, List[Any]] = {name: [] for name, *_ in plans}
    decoders = [(name, _decoder(prim), null_branch)
                for name, prim, null_branch, _ in plans]
    for count, block in _blocks(path, codec, r, sync):
        br = _Reader(block)
        try:
            for _ in range(count):
                for name, dec, null_branch in decoders:
                    if null_branch is not None:
                        branch = br.read_long()
                        if branch not in (0, 1):
                            raise HyperspaceException("avro: bad union branch")
                        cells[name].append(None if branch == null_branch else dec(br))
                    else:
                        cells[name].append(dec(br))
        except HyperspaceException as e:
            raise HyperspaceException(f"{e} in {path}")

    arrays, names = [], []
    for name, prim, null_branch, logical in plans:
        if columns is not None and name not in columns:
            continue
        at = _arrow_type(prim, logical)
        vals = cells[name]
        if logical == "date":
            arr = pa.array(
                np.array([v if v is not None else 0 for v in vals],
                         dtype="int32"),
                type=pa.int32(),
                mask=np.array([v is None for v in vals], dtype=bool)
                if null_branch is not None else None).cast(pa.date32())
        else:
            arr = pa.array(vals, type=at)
        arrays.append(arr)
        names.append(name)
    return _project(path, names, arrays, columns)


def _assemble_native(chunks: List[Tuple[int, List]], fi: int, prim: str,
                     null_branch: Optional[int], logical: Optional[str]) -> pa.Array:
    """Arrow array for field ``fi`` from the per-block native decode
    results (per-block arrays concatenated, no Python per row)."""
    parts = []
    nullable = null_branch is not None
    for count, fields in chunks:
        piece = fields[fi]
        if piece[0] == "s":
            _, offsets, data, valid = piece
            at = pa.utf8() if prim == "string" else pa.binary()
            validity_buf = None
            null_count = 0
            if nullable:
                null_count = int(count - valid.sum())
                if null_count:
                    validity_buf = pa.py_buffer(np.packbits(
                        valid.astype(bool), bitorder="little").tobytes())
            arr = pa.Array.from_buffers(
                at, count,
                [validity_buf, pa.py_buffer(offsets.tobytes()), pa.py_buffer(data)],
                null_count)
            if prim == "string":
                # from_buffers does not validate UTF-8; the plain decoder
                # raises on invalid bytes, so the native route must too.
                try:
                    arr.validate(full=True)
                except pa.lib.ArrowInvalid as e:
                    raise HyperspaceException(f"avro: invalid utf-8: {e}")
            parts.append(arr)
            continue
        _, vals, valid = piece
        mask = (valid == 0) if nullable else None
        if prim == "null":
            parts.append(pa.nulls(count))
        elif logical == "date":
            parts.append(pa.array(vals.astype(np.int32), type=pa.int32(),
                                  mask=mask).cast(pa.date32()))
        elif prim == "boolean":
            parts.append(pa.array(vals.astype(bool), mask=mask))
        elif prim == "int":
            parts.append(pa.array(vals.astype(np.int32), mask=mask))
        elif prim == "long":
            parts.append(pa.array(vals, mask=mask))
        elif prim == "float":
            parts.append(pa.array(vals.astype(np.float32), mask=mask))
        else:  # double
            parts.append(pa.array(vals, mask=mask))
    return pa.concat_arrays(parts) if len(parts) > 1 else parts[0]


# ---------------------------------------------------------------------------
# Writing (null or deflate codec; blocks of block_rows rows).
# ---------------------------------------------------------------------------

_WRITE_PLAN = {
    pa.types.is_boolean: ("boolean", lambda v: b"\x01" if v else b"\x00"),
    pa.types.is_int32: ("int", _encode_long),
    pa.types.is_int64: ("long", _encode_long),
    pa.types.is_float32: ("float", lambda v: struct.pack("<f", v)),
    pa.types.is_float64: ("double", lambda v: struct.pack("<d", v)),
    pa.types.is_string: ("string", lambda v: _encode_bytes(v.encode("utf-8"))),
    pa.types.is_binary: ("bytes", _encode_bytes),
}


def _write_plan_for(t: pa.DataType):
    if pa.types.is_date32(t):
        return ({"type": "int", "logicalType": "date"},
                lambda v: _encode_long((v - _EPOCH).days))
    for pred, plan in _WRITE_PLAN.items():
        if pred(t):
            return plan
    raise HyperspaceException(f"avro: cannot write arrow type {t}")


def write_avro(table: pa.Table, path: str, codec: str = "null",
               block_rows: int = 65536) -> None:
    """Write an arrow table as an OCF file. ``codec``: "null" | "deflate"
    (raw zlib per block, the spec's deflate). Rows are split into blocks
    of ``block_rows`` so readers can stream and deflate compresses in
    bounded windows."""
    if codec not in ("null", "deflate"):
        raise HyperspaceException(f"avro: unsupported codec {codec!r}")
    if block_rows < 1:
        raise HyperspaceException(
            f"avro: block_rows must be >= 1, got {block_rows}")
    fields = []
    encoders = []
    for f in table.schema:
        avro_t, enc = _write_plan_for(f.type)
        nullable = f.nullable
        fields.append({"name": f.name,
                       "type": ["null", avro_t] if nullable else avro_t})
        encoders.append((f.name, enc, nullable))
    schema = {"type": "record", "name": "Root", "fields": fields}
    sync = b"hyperspace_sync!"  # fixed 16-byte marker
    cols = {name: table.column(name).to_pylist() for name, _, _ in encoders}

    def encode_block(start: int, count: int) -> bytes:
        body = io.BytesIO()
        for i in range(start, start + count):
            for name, enc, nullable in encoders:
                v = cols[name][i]
                if nullable:
                    if v is None:
                        body.write(_encode_long(0))
                        continue
                    body.write(_encode_long(1))
                elif v is None:
                    raise HyperspaceException(
                        f"avro: null in non-nullable column {name}")
                body.write(enc(v))
        return body.getvalue()

    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        fh.write(_encode_long(2))
        fh.write(_encode_bytes(b"avro.schema"))
        fh.write(_encode_bytes(json.dumps(schema).encode("utf-8")))
        fh.write(_encode_bytes(b"avro.codec"))
        fh.write(_encode_bytes(codec.encode("utf-8")))
        fh.write(_encode_long(0))
        fh.write(sync)
        for start in range(0, table.num_rows, block_rows):
            count = min(block_rows, table.num_rows - start)
            block = encode_block(start, count)
            if codec == "deflate":
                block = zlib.compress(block)[2:-4]  # raw deflate
            fh.write(_encode_long(count))
            fh.write(_encode_long(len(block)))
            fh.write(block)
            fh.write(sync)
