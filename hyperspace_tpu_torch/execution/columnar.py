"""Device-resident columnar tables (counterpart of
``hyperspace_tpu/execution/columnar.py``).

Every column is a fixed-width torch tensor on the table's device.
Variable-length strings are dictionary-encoded order-preserving at the
host→device boundary (codes compare like the strings they stand for), dates
are int32 days and decimals become float64. Host↔device crossings happen
only at parquet read/write and at ``to_arrow``; a copy to a card goes from
pinned host memory, queued on the current stream.

Multi-file reads fan out over the reader pool (parallel/io.py), chunk
streams run a prefetcher ahead of their consumer, and the executor's bulk
scans and chunked filtered scans go through the buffer pool
(execution/buffer_pool.py).
"""

from __future__ import annotations

import datetime
import functools
import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import torch

from ..exceptions import HyperspaceException
from ..schema import BOOL, DATE, FLOAT32, FLOAT64, INT32, INT64, STRING, Field, Schema

DEVICE_DTYPE = {
    INT32: torch.int32,
    INT64: torch.int64,
    FLOAT32: torch.float32,
    FLOAT64: torch.float64,
    BOOL: torch.bool,
    DATE: torch.int32,
    STRING: torch.int32,  # dictionary codes.
}

_NP_DTYPE = {INT32: np.int32, INT64: np.int64, FLOAT32: np.float32,
             FLOAT64: np.float64, BOOL: np.bool_, DATE: np.int32, STRING: np.int32}
_TORCH_DTYPE = {np.int32: torch.int32, np.int64: torch.int64, np.float32: torch.float32,
                np.float64: torch.float64, np.bool_: torch.bool}


@dataclass
class Column:
    """One device column: values (or dictionary codes) + optional validity."""

    dtype: str  # logical type name from schema.py
    data: torch.Tensor
    validity: Optional[torch.Tensor] = None  # bool, True = valid; None = all valid
    dictionary: Optional[np.ndarray] = None  # sorted unique strings (host)

    def __post_init__(self):
        if self.dtype == STRING and self.dictionary is None:
            raise HyperspaceException("STRING columns require a dictionary")

    def __len__(self):
        return int(self.data.shape[0])

    @property
    def has_nulls(self) -> bool:
        return self.validity is not None

    def take(self, indices: torch.Tensor) -> "Column":
        return Column(self.dtype, self.data[indices],
                      None if self.validity is None else self.validity[indices],
                      self.dictionary)

    def slice(self, start: int, stop: int) -> "Column":
        return Column(self.dtype, self.data[start:stop],
                      None if self.validity is None else self.validity[start:stop],
                      self.dictionary)

    def to(self, device) -> "Column":
        return Column(self.dtype, self.data.to(device),
                      None if self.validity is None else self.validity.to(device),
                      self.dictionary)


@dataclass
class Table:
    """An ordered set of equal-length device columns.

    ``bucket_order`` is a physical-layout hint: ``(num_buckets, key
    columns)`` means the rows are grouped by ascending bucket id (the hash
    of the key columns) and sorted by the key columns within each bucket,
    the covering index's layout. Joins and group-bys on those keys use it
    to skip a sort. A row subsequence keeps it; a permutation drops it."""

    columns: Dict[str, Column]
    bucket_order: Optional[Tuple[int, Tuple[str, ...]]] = None

    def __post_init__(self):
        lengths = {len(c) for c in self.columns.values()}
        if len(lengths) > 1:
            raise HyperspaceException(f"Ragged table: column lengths {lengths}")

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    @property
    def device(self) -> torch.device:
        if not self.columns:
            raise HyperspaceException("A table with no columns has no device")
        return next(iter(self.columns.values())).data.device

    def column(self, name: str) -> Column:
        if name not in self.columns:
            raise HyperspaceException(
                f"Unknown column '{name}'; available: {self.names}")
        return self.columns[name]

    def schema(self) -> Schema:
        return Schema([Field(n, c.dtype, c.has_nulls)
                       for n, c in self.columns.items()])

    def select(self, names: Sequence[str]) -> "Table":
        order = self.bucket_order
        keep = order if order and all(k in names for k in order[1]) else None
        return Table({n: self.column(n) for n in names}, keep)

    def take(self, indices: torch.Tensor) -> "Table":
        return Table({n: c.take(indices) for n, c in self.columns.items()})

    def filter(self, mask: torch.Tensor) -> "Table":
        from ..ops import kernels
        if mask.shape[0] != self.num_rows:
            raise HyperspaceException(
                f"filter mask length {mask.shape[0]} != rows {self.num_rows}")
        return Table(self.take(kernels.filter_indices(mask)).columns, self.bucket_order)

    def slice(self, start: int, stop: int) -> "Table":
        return Table({n: c.slice(start, stop) for n, c in self.columns.items()},
                     self.bucket_order)

    def with_column(self, name: str, col: Column) -> "Table":
        out = dict(self.columns)
        out[name] = col
        return Table(out, self.bucket_order)

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        """Rows of schema-aligned tables, one after another; string
        dictionaries are unified (codes keep sorting like their strings).
        The bucket order is dropped, unless only one table has rows."""
        tables = [t for t in tables if t.num_rows > 0] or list(tables[:1])
        if len(tables) == 1:
            return tables[0]
        out: Dict[str, Column] = {}
        for name in tables[0].names:
            cols = [t.column(name) for t in tables]
            dtype = cols[0].dtype
            if any(c.dtype != dtype for c in cols):
                raise HyperspaceException(f"concat dtype mismatch on '{name}'")
            if dtype == STRING:
                out[name] = _concat_string_columns(cols)
                continue
            validity = None
            if any(c.validity is not None for c in cols):
                validity = torch.cat([
                    c.validity if c.validity is not None
                    else torch.ones(len(c), dtype=torch.bool, device=c.data.device)
                    for c in cols])
            out[name] = Column(dtype, torch.cat([c.data for c in cols]), validity)
        return Table(out)

    def to_host(self) -> "Table":
        """Every column moved to the CPU at once, so that later per-bucket
        slices are host slices, not device round trips."""
        return Table({n: c.to("cpu") for n, c in self.columns.items()})

    # ------------------------------------------------------------------
    # Host boundary.
    # ------------------------------------------------------------------

    def to_arrow(self) -> pa.Table:
        arrays = []
        for name, col in self.columns.items():
            np_data = col.data.cpu().numpy()
            np_valid = None if col.validity is None else col.validity.cpu().numpy()
            mask = None if np_valid is None else ~np_valid
            if col.dtype == STRING:
                codes = np_data
                safe = np.where(codes >= 0, codes, 0)
                mask = mask if mask is not None else (codes < 0)
                if len(col.dictionary):
                    # Decoded by arrow from the codes: the same strings as
                    # indexing the dictionary on the host, without a Python
                    # object a row.
                    arr = pa.DictionaryArray.from_arrays(
                        pa.array(safe, mask=mask),
                        pa.array(col.dictionary, type=pa.string())).cast(pa.string())
                else:
                    arr = pa.array(np.array([""] * len(codes), dtype=object),
                                   type=pa.string(), mask=mask)
            elif col.dtype == DATE:
                arr = pa.array(np_data.astype("int32"), type=pa.int32(), mask=mask)
                arr = arr.cast(pa.date32())
            elif col.dtype == BOOL:
                arr = pa.array(np_data.astype(bool), mask=mask)
            else:
                arr = pa.array(np_data, mask=mask)
            arrays.append((name, arr))
        return pa.table(dict(arrays))

    @staticmethod
    def from_arrow(table: pa.Table, device) -> "Table":
        return Table({name: _encode_arrow_column(table.column(name), device)
                      for name in table.column_names})


# ---------------------------------------------------------------------------
# Encoding (the JAX package's exact host-side rules, so both packages hold
# the same values).
# ---------------------------------------------------------------------------

def _encode_arrow_column(chunked: pa.ChunkedArray, device) -> Column:
    t = chunked.type
    if pa.types.is_dictionary(t):
        chunked = chunked.cast(t.value_type)
        t = t.value_type
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return _encode_string(chunked, device)
    combined = chunked.combine_chunks() if chunked.num_chunks != 1 else chunked.chunk(0)
    null_count = combined.null_count
    if pa.types.is_date32(t):
        np_data = combined.cast(pa.int32()).to_numpy(zero_copy_only=False)
        dtype = DATE
    elif pa.types.is_decimal(t):
        np_data = combined.cast(pa.float64()).to_numpy(zero_copy_only=False)
        dtype = FLOAT64
    elif pa.types.is_timestamp(t):
        np_data = combined.cast(pa.int64()).to_numpy(zero_copy_only=False)
        dtype = INT64
    elif pa.types.is_boolean(t):
        np_data = combined.to_numpy(zero_copy_only=False)
        dtype = BOOL
    elif pa.types.is_integer(t):
        # fill_null BEFORE to_numpy: the null path otherwise round-trips
        # through float64, corrupting int64 values beyond ±2^53.
        filled = combined.fill_null(0) if null_count else combined
        wide = filled.cast(pa.int64()).to_numpy(zero_copy_only=False)
        if t.bit_width <= 32:
            np_data, dtype = wide.astype(np.int32), INT32
        else:
            np_data, dtype = wide, INT64
    elif pa.types.is_floating(t):
        np_data = combined.to_numpy(zero_copy_only=False)
        dtype = FLOAT32 if t.bit_width == 32 else FLOAT64
    else:
        raise HyperspaceException(f"Unsupported arrow type: {t}")

    validity = None
    if null_count:
        valid_np = ~np.asarray(combined.is_null())
        np_data = np.where(valid_np, np.nan_to_num(np_data, nan=0)
                           if np_data.dtype.kind == "f" else np_data, 0)
        validity = _to_device(valid_np, device)
    np_data = np.ascontiguousarray(np_data).astype(_NP_DTYPE[dtype], copy=False)
    return Column(dtype, _to_device(np_data, device), validity)


# Pinned staging pieces of a host->card copy. Whole columns staged at once
# would pin as much host memory as a query reads, and torch's pinned-memory
# allocator keeps what it pinned; pieces of this size are pinned once and
# reused.
_STAGE_BYTES = 64 << 20


def _to_device(np_data: np.ndarray, device) -> torch.Tensor:
    """A 1-D host array on ``device``. To a card it goes piece by piece
    through pinned staging buffers, each copied without blocking the host on
    the current stream; torch's pinned-memory allocator hands a buffer out
    again only once its copy is done."""
    if torch.device(device).type != "cuda":
        if not np_data.flags.writeable:
            np_data = np_data.copy()
        return torch.from_numpy(np_data).to(device)
    dtype = _TORCH_DTYPE[np_data.dtype.type]
    out = torch.empty(np_data.shape, dtype=dtype, device=device)
    step = max(_STAGE_BYTES // np_data.itemsize, 1)
    for lo in range(0, np_data.shape[0], step):
        piece = np_data[lo:lo + step]
        staged = torch.empty(piece.shape, dtype=dtype, pin_memory=True)
        np.copyto(staged.numpy(), piece)
        out[lo:lo + step].copy_(staged, non_blocking=True)
    return out


def _encode_string(chunked: pa.ChunkedArray, device) -> Column:
    """Order-preserving dictionary encoding: codes sort like the strings.

    pyarrow finds, sorts and looks up the distinct strings (outside the
    GIL); only the dictionary becomes a numpy array. UTF-8 byte order is
    code point order, numpy's order for its strings, so the dictionary and
    the codes are what a numpy sort and searchsorted give, except where
    numpy's strings cannot hold a value (a trailing NUL): then numpy
    encodes, as the JAX package does."""
    combined = chunked.combine_chunks() if chunked.num_chunks != 1 else chunked.chunk(0)
    uniques = pc.unique(combined.drop_null())
    uniques = uniques.take(pc.sort_indices(uniques))
    dictionary = np.asarray(uniques).astype(str) if len(uniques) else np.array([], dtype=str)
    if len(dictionary) and not (dictionary[1:] > dictionary[:-1]).all():
        return _encode_string_numpy(combined, dictionary, device)
    if len(dictionary):
        codes = pc.index_in(combined, value_set=uniques).fill_null(-1)
        codes = codes.to_numpy(zero_copy_only=False).astype(np.int32, copy=False)
    else:
        codes = np.full(len(combined), -1 if combined.null_count else 0, np.int32)
    validity = None
    if combined.null_count:
        validity = _to_device(~np.asarray(combined.is_null()), device)
    return Column(STRING, _to_device(codes, device), validity, dictionary)


def _encode_string_numpy(combined: pa.Array, dictionary: np.ndarray, device) -> Column:
    """The numpy encoding (sort and searchsorted over Python strings)."""
    dictionary = np.sort(dictionary)
    values = np.asarray(combined.fill_null("")).astype(str)
    codes = np.searchsorted(dictionary, values).astype(np.int32)
    validity = None
    if combined.null_count:
        valid_np = ~np.asarray(combined.is_null())
        codes = np.where(valid_np, codes, -1).astype(np.int32)
        validity = _to_device(valid_np, device)
    return Column(STRING, _to_device(codes, device), validity, dictionary)


def _concat_string_columns(cols: List[Column]) -> Column:
    """One STRING column over the union of the parts' dictionaries."""
    merged = np.unique(np.concatenate([c.dictionary for c in cols])) \
        if any(len(c.dictionary) for c in cols) else np.array([], dtype=str)
    datas, validities = [], []
    for c in cols:
        if len(c.dictionary):
            remap = torch.from_numpy(
                np.searchsorted(merged, c.dictionary).astype(np.int32)).to(c.data.device)
            codes = torch.where(c.data >= 0, remap[c.data.clamp(min=0).to(torch.int64)],
                                torch.full_like(c.data, -1))
        else:
            codes = c.data
        datas.append(codes)
        validities.append(c.validity if c.validity is not None
                          else torch.ones(len(c), dtype=torch.bool, device=c.data.device))
    validity = torch.cat(validities) if any(c.validity is not None for c in cols) else None
    return Column(STRING, torch.cat(datas), validity, merged)


# ---------------------------------------------------------------------------
# Parquet IO.
# ---------------------------------------------------------------------------

def _file_size_weight(path: str) -> int:
    """A file's byte weight for the reader pool's in-flight budget (its
    decoded size is about its file size; 0 when it cannot be stat'ed)."""
    from ..index import data_store
    try:
        return int(data_store.file_stamp(path)[0])
    except OSError:
        return 0


def _read_parquet_pooled(files: Sequence[str], read_cols, filters) -> pa.Table:
    """A multi-file read fanned out over the reader pool: one contiguous
    sublist of files per thread, each read by pyarrow single-threaded (the
    pool is the parallelism; pyarrow's own pool beneath it would
    oversubscribe), then concatenated in file order, so the table equals the
    sequential read's. Sublists rather than one task a file: each task pays
    the dataset set-up once. A read whose sublists do not all fit the
    in-flight budget at once goes to pyarrow's own threads instead, as does
    everything under ``io.enabled=false``; ``io.threads=1`` is the
    single-threaded sequential read.

    pyarrow infers no partitions from the paths (``partitioning=None``):
    ``sources/partitions.py`` attaches them, and a sublist holding only a
    null partition's files would leave pyarrow nothing to infer its type
    from (the JAX package raises there; ROADMAP queue C 9).

    Files on a data store are read through its filesystem."""
    from ..index import data_store
    from ..parallel import io as pio
    p = pio.active_params()
    n = p.resolved_threads()

    def read(paths, use_threads: bool) -> pa.Table:
        fs, norm = data_store.resolve_files(paths)
        return pq.read_table(norm, columns=read_cols, filters=filters, partitioning=None,
                             use_threads=use_threads, filesystem=fs)

    if not p.enabled:
        return read(files, True)
    if len(files) > 1 and n > 1 and not pio.in_worker():
        step = (len(files) + n - 1) // n
        groups = [files[i:i + step] for i in range(0, len(files), step)]
        weights = [sum(map(_file_size_weight, g)) for g in groups]

        # The pool reads at its full width only when the in-flight budget
        # holds a sublist for every thread; narrower, it decodes on fewer
        # threads than pyarrow's own read uses (PERF.md, the read splits).
        if min(n, len(groups)) * max(weights) <= p.max_inflight_bytes:
            parts = pio.map_ordered(lambda gw: read(gw[0], False), list(zip(groups, weights)),
                                    weight=lambda gw: gw[1], params=p, label="read_parquet")
            try:
                return pa.concat_tables(parts)
            except (pa.ArrowInvalid, pa.ArrowTypeError):
                pass  # files of differing schemas: the dataset reader unifies them.
        else:
            # The same sublists read on pyarrow's threads: the read still
            # records the io.read span the JAX package's fan-out (which has
            # no budget) records.
            from ..telemetry import span_names as SN
            from ..telemetry import trace as _trace
            t0 = time.perf_counter()
            at = read(files, True)
            _trace.add_span(SN.IO_READ, start_perf=t0, label="read_parquet",
                            files=len(groups), nbytes=sum(weights),
                            threads=n, route="pyarrow")
            return at
    return read(files, n > 1 and not pio.in_worker())


def read_parquet(files: Sequence[str], columns: Optional[Sequence[str]], device,
                 filters=None, pool: bool = False, fmt: str = "parquet") -> Table:
    """Read ``files`` of format ``fmt`` onto ``device``. ``filters`` is a
    pyarrow expression: row groups whose statistics exclude it are skipped
    and the rows read are filtered by it (the device filter still runs
    after). It and ``pool`` apply to parquet only; the other formats
    (``read_format``) are read whole.

    A dotted column that is not a top-level one is a struct leaf: its root
    struct column is read, flattened until no struct is left, and the
    exact dotted leaves are selected (pyarrow's ``columns=`` would select
    a nested leaf but name it by its last part).

    ``pool=True`` (the executor's bulk scans) probes the buffer pool first
    and admits the table read on a miss; builds read around it.

    The ``scan.parquet_decode`` fault point fires on entry, before the pool
    probe, so a fault is the same with the pool on and off."""
    from ..index import data_store
    from ..robustness import fault_names as _fn
    from ..robustness import faults as _faults
    from . import buffer_pool as bp
    if not files:
        raise HyperspaceException("read_parquet: no files")
    _faults.fault_point(_fn.SCAN_PARQUET_DECODE)
    if fmt != "parquet":
        return Table.from_arrow(read_format(files, columns, fmt), device)
    pool_key = None
    if pool and bp.enabled():
        pool_key = bp.scan_key(files, columns, filters, device)
        if pool_key is not None:
            cached = bp.get_pool().get(pool_key)
            if cached is not None:
                return cached
    read_cols = list(columns) if columns else None
    flatten_select = None
    if columns:
        fs, first = data_store.fs_and_path(files[0])
        top_level = set(pq.read_schema(first, filesystem=fs).names)
        if any(c not in top_level for c in columns):
            roots: List[str] = []
            for c in columns:
                root = c if c in top_level else c.split(".", 1)[0]
                if root not in roots:
                    roots.append(root)
            read_cols, flatten_select = roots, list(columns)
    at = _read_parquet_pooled(list(files), read_cols, filters)
    if flatten_select is not None:
        while any(pa.types.is_struct(f.type) for f in at.schema):
            at = at.flatten()
        at = at.select(flatten_select)
    table = Table.from_arrow(at, device)
    if pool_key is not None:
        bp.get_pool().put(pool_key, table)
    return table


def read_format(files: Sequence[str], columns: Optional[Sequence[str]],
                fmt: str) -> pa.Table:
    """The host table of csv, json (newline-delimited), orc, text or avro
    ``files``, in file order: each file is read alone on the reader pool,
    single-threaded inside a worker (the pool is the parallelism)."""
    from ..parallel import io as pio

    if fmt == "csv":
        import pyarrow.csv as pa_csv

        def read_one(f):
            if pio.in_worker():
                return pa_csv.read_csv(f, read_options=pa_csv.ReadOptions(use_threads=False))
            return pa_csv.read_csv(f)
    elif fmt == "json":
        import pyarrow.json as pa_json

        def read_one(f):
            if pio.in_worker():
                return pa_json.read_json(f, read_options=pa_json.ReadOptions(use_threads=False))
            return pa_json.read_json(f)
    elif fmt == "orc":
        import pyarrow.orc as pa_orc

        def read_one(f):
            return pa_orc.ORCFile(f).read(columns=list(columns) if columns else None)
    elif fmt == "avro":
        from ..util.avro import read_avro

        def read_one(f):
            return read_avro(f, list(columns) if columns else None)
    elif fmt == "text":
        # One string column "value" per line. Lines end at \n, \r or \r\n,
        # as Hadoop's LineReader splits them (str.splitlines would also
        # split at \x0b, \x0c and others).
        def read_one(f):
            with open(f, encoding="utf-8", newline="") as fh:
                lines = re.split("\r\n|\r|\n", fh.read())
            if lines and lines[-1] == "":
                lines.pop()  # a trailing terminator, not an empty last line
            return pa.table({"value": pa.array(lines, type=pa.string())})
    else:
        raise HyperspaceException(f"Unsupported format: {fmt}")
    at = pa.concat_tables(pio.map_ordered(read_one, list(files), weight=_file_size_weight,
                                          label=f"read_{fmt}"))
    if columns and fmt in ("csv", "json", "text"):
        at = at.select(list(columns))
    return at


@functools.lru_cache(maxsize=65536)
def _file_row_count(path: str, size: int, mtime: int) -> int:
    from ..index import data_store
    fs, norm = data_store.fs_and_path(path)
    return pq.ParquetFile(norm, filesystem=fs).metadata.num_rows


def parquet_row_counts(files: Sequence[str]) -> List[int]:
    """Row count per file from parquet footers (no data read), memoized
    per (path, size, mtime): every filtered scan checks its budget, and
    a file rewritten in place has a new size or mtime. A file on a data
    store is stat'ed through it."""
    from ..index import data_store
    return [_file_row_count(f, *data_store.file_stamp(f)) for f in files]


def _table_nbytes_estimate(item) -> int:
    """In-flight bytes of a chunk (a table, or a (table, provenance) pair)
    crossing the prefetch queue."""
    table = item[0] if isinstance(item, tuple) else item
    total = 0
    for c in table.columns.values():
        total += c.data.nbytes
        if c.validity is not None:
            total += c.validity.nbytes
    return total


def _prefetched(source, device, label: str):
    """``source``'s chunks (tables or (table, provenance) pairs on
    ``device``) through the prefetcher, in order.

    On a card the producer copies on a stream of its own, set for each
    step of the source on whichever thread runs it; an event recorded after
    each chunk's copies travels with the chunk. The consumer's stream waits
    on it, and every tensor is marked as used on the consumer's stream
    (``record_stream``), so the caching allocator does not hand the memory
    to the copy stream again while the consumer's kernels may read it."""
    from ..parallel import io as pio
    device = torch.device(device)
    if device.type != "cuda":
        yield from pio.prefetch_iter(source, nbytes=_table_nbytes_estimate, label=label)
        return
    copy_stream = torch.cuda.Stream(device)

    def copied():
        it = iter(source)
        try:
            while True:
                with torch.cuda.stream(copy_stream):
                    item = next(it, None)
                    if item is None:
                        return
                    done = torch.cuda.Event()
                    done.record(copy_stream)
                yield item, done
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    consumer = torch.cuda.current_stream(device)
    stream = pio.prefetch_iter(copied(), nbytes=lambda x: _table_nbytes_estimate(x[0]),
                               label=label)
    try:
        for item, done in stream:
            consumer.wait_event(done)
            table = item[0] if isinstance(item, tuple) else item
            for c in table.columns.values():
                c.data.record_stream(consumer)
                if c.validity is not None:
                    c.validity.record_stream(consumer)
            yield item
    finally:
        stream.close()


def _rebatch(pieces, chunk_rows: int):
    """(arrow table, provenance) batches of ``chunk_rows`` rows (the last
    may be shorter) from (file index, arrow table) pieces, in order; the
    provenance lists (file index, rows taken from that file)."""
    batch: List[pa.Table] = []
    batch_rows = 0
    provenance: List[Tuple[int, int]] = []
    for fi, t in pieces:
        start = 0
        while start < t.num_rows:
            take = min(t.num_rows - start, chunk_rows - batch_rows)
            batch.append(t.slice(start, take))
            if provenance and provenance[-1][0] == fi:
                provenance[-1] = (fi, provenance[-1][1] + take)
            else:
                provenance.append((fi, take))
            batch_rows += take
            start += take
            if batch_rows >= chunk_rows:
                yield pa.concat_tables(batch), provenance
                batch, batch_rows, provenance = [], 0, []
    if batch:
        yield pa.concat_tables(batch), provenance


def iter_parquet_chunks(files: Sequence[str], columns: Optional[Sequence[str]],
                        chunk_rows: int, device):
    """Stream ``files`` as tables of at most ``chunk_rows`` rows on
    ``device``, row group by row group, each with its provenance: a list
    of (index into ``files``, rows taken from that file), so a caller can
    give every row its source file's id (lineage). A prefetcher decodes
    and copies the next chunks while the caller works on this one: at most
    ``prefetchDepth`` buffered chunks, one in production and one at the
    caller are alive. Order and provenance are the sequential stream's."""
    return _prefetched(_iter_parquet_chunks(files, columns, chunk_rows, device), device,
                       "parquet_chunks")


def _iter_parquet_chunks(files, columns, chunk_rows: int, device):
    from ..index import data_store
    fs, files = data_store.resolve_files(files)
    read_cols = list(columns) if columns else None
    pieces = ((fi, pf.read_row_group(rg, columns=read_cols))
              for fi, pf in enumerate(pq.ParquetFile(f, filesystem=fs) for f in files)
              for rg in range(pf.num_row_groups))
    for at, provenance in _rebatch(pieces, chunk_rows):
        yield Table.from_arrow(at, device), provenance


def iter_dataset_chunks(files: Sequence[str], columns: Optional[Sequence[str]],
                        chunk_rows: int, device, filters=None):
    """Stream ``files`` as tables of at most ``chunk_rows`` rows on
    ``device``, in file order, with the pyarrow expression ``filters``
    pushed into the scan: row groups whose statistics exclude it are never
    decoded, and the rows read are filtered by it. A prefetcher runs ahead
    of the caller, as in ``iter_parquet_chunks``.

    A stream of at most ``bufferPool.streamAdmitBytes`` goes through the
    buffer pool: a hit replays the chunk sequence, chunk for chunk, with no
    file read; a miss streams while collecting the chunks, and admits them
    only when the caller has taken the whole stream (an abandoned stream
    never leaves a truncated one behind). These entries are device-only."""
    from . import buffer_pool as bp
    pool_key = None
    if bp.enabled():
        pool_key = bp.stream_key(files, columns, filters, chunk_rows, device)
        if pool_key is not None:
            cached = bp.get_pool().get(pool_key)
            if cached is not None:
                return iter(list(cached))
    stream = _prefetched(_iter_dataset_chunks(files, columns, chunk_rows, device, filters),
                         device, "dataset_chunks")
    if pool_key is not None:
        stream = _collect_stream(pool_key, stream, bp.stream_admit_bytes())
    return stream


def _collect_stream(pool_key, stream, admit_bytes: int):
    """Pass the chunks through while keeping them for the pool; a stream
    above ``admit_bytes`` stops collecting, and only one taken to its end
    is admitted."""
    from . import buffer_pool as bp
    chunks: Optional[List[Table]] = []
    total = 0
    try:
        for chunk in stream:
            if chunks is not None:
                total += _table_nbytes_estimate(chunk)
                if total > admit_bytes:
                    chunks = None
                else:
                    chunks.append(chunk)
            yield chunk
    finally:
        stream.close()
    if chunks is not None:
        bp.get_pool().put(pool_key, chunks, nbytes=total, device_only=True)


def _iter_dataset_chunks(files, columns, chunk_rows: int, device, filters):
    import pyarrow.dataset as pa_ds

    from ..index import data_store
    fs, files = data_store.resolve_files(files)
    scanner = pa_ds.dataset(files, format="parquet", filesystem=fs).scanner(
        columns=list(columns) if columns else None, filter=filters,
        batch_size=max(chunk_rows, 1))
    pieces = ((0, pa.Table.from_batches([rb])) for rb in scanner.to_batches())
    for at, _ in _rebatch(pieces, chunk_rows):
        yield Table.from_arrow(at, device)


def write_parquet(table: Table, path: str, row_group_size: Optional[int] = None) -> None:
    """One parquet file, through the path's data store if it has one."""
    from ..index import data_store
    fs, norm = data_store.fs_and_path(path)
    pq.write_table(table.to_arrow(), norm, row_group_size=row_group_size, filesystem=fs)


def empty_table(schema: Schema, device) -> Table:
    cols = {}
    for f in schema.fields:
        dictionary = np.array([], dtype=str) if f.dtype == STRING else None
        cols[f.name] = Column(f.dtype, torch.zeros(0, dtype=DEVICE_DTYPE[f.dtype],
                                                   device=device), None, dictionary)
    return Table(cols)


def dictionaries_equal(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> bool:
    return a is b or (a is not None and b is not None
                      and len(a) == len(b) and bool(np.array_equal(a, b)))


def translate_codes(target_dictionary: np.ndarray, col: Column) -> torch.Tensor:
    """Re-map a STRING column's codes into ``target_dictionary``'s code space.
    Strings absent from the target map to -2, which equals no valid code and
    no null code (-1), so equality against translated codes is exact."""
    src = col.dictionary
    if len(src) == 0 or len(target_dictionary) == 0:
        return torch.full(col.data.shape, -2, dtype=torch.int32, device=col.data.device)
    pos = np.searchsorted(target_dictionary, src)
    pos_c = np.clip(pos, 0, len(target_dictionary) - 1)
    present = (pos < len(target_dictionary)) & (target_dictionary[pos_c] == src)
    mapping = torch.from_numpy(np.where(present, pos_c, -2).astype(np.int32)).to(
        col.data.device)
    return torch.where(col.data >= 0, mapping[col.data.clamp(min=0).to(torch.int64)],
                       torch.full_like(col.data, -2))


def literal_to_device(value, dtype: str, dictionary: Optional[np.ndarray]):
    """Encode a python literal for comparison against a device column.

    For STRING columns returns ``(lo, hi)`` searchsorted bounds into the
    dictionary: lo == searchsorted(dict, v, 'left'), hi == 'right' -- every
    comparison op can be phrased over codes with these two ints.
    """
    if dtype == STRING:
        if dictionary is None:
            raise HyperspaceException("string literal against non-string column")
        v = str(value)
        lo = int(np.searchsorted(dictionary, v, side="left"))
        hi = int(np.searchsorted(dictionary, v, side="right"))
        return lo, hi
    if dtype == DATE:
        if isinstance(value, str):
            value = datetime.date.fromisoformat(value)
        if isinstance(value, datetime.date):
            return int((value - datetime.date(1970, 1, 1)).days)
        return int(value)
    if dtype == BOOL:
        return bool(value)
    if dtype in (FLOAT32, FLOAT64):
        return float(value)
    if isinstance(value, float) and not value.is_integer():
        # Fractional literal against an int column: int() truncation would
        # change comparison semantics (5 < 5.5 but not 5 < int(5.5)); the
        # evaluator promotes the column instead.
        return value
    return int(value)
