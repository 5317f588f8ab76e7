"""Cached table and column statistics (counterpart of
``hyperspace_tpu/optimizer/stats.py``): the cost model's input.

Parquet footers hold row counts and per-column min, max and null counts,
and sketch indexes hold per-file MinMax and Bloom tables. ``StatsProvider``
harvests the footers on first request and caches them per relation, keyed
by the relation's files' (path, size, mtime), so a changed source is
harvested anew.

Everything here is planning-time host work: footer reads only (no data
pages except the bounded NDV sample), no device interaction.
"""

from __future__ import annotations

import datetime
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..schema import BOOL, DATE
from .constants import STATS_CACHE_ENTRIES, STATS_SAMPLE_ROWS


@dataclass
class ColumnStats:
    """Footer-harvested facts about one physical column."""

    dtype: str
    minimum: object = None
    maximum: object = None
    null_count: int = 0
    has_minmax: bool = False


@dataclass
class TableStats:
    """Statistics for one relation snapshot. NDV estimates are computed
    (and cached) per column on demand — row counts and min/max come free
    with the footers, distinctness may need the bounded sample read."""

    row_count: int
    files: List[str]
    file_rows: List[int]
    columns: Dict[str, ColumnStats]
    sample_rows: int = 0
    _ndv_cache: Dict[str, float] = field(default_factory=dict)

    def column(self, name: str) -> Optional[ColumnStats]:
        return self.columns.get(name)

    def null_fraction(self, name: str) -> float:
        cs = self.columns.get(name)
        if cs is None or self.row_count <= 0:
            return 0.0
        return min(1.0, cs.null_count / self.row_count)

    def ndv(self, name: str) -> Optional[float]:
        """Estimated number of distinct (non-null) values of ``name``:
        the min of the integer/date/bool min-max span bound and the
        sample-extrapolated estimate; None when neither applies."""
        if name in self._ndv_cache:
            return self._ndv_cache[name]
        cs = self.columns.get(name)
        if cs is None:
            return None
        nonnull = max(1, self.row_count - cs.null_count)
        candidates: List[float] = [float(nonnull)]
        span = _span_count(cs)
        if span is not None:
            candidates.append(span)
        sampled = self._sampled_ndv(name, nonnull)
        if sampled is not None:
            candidates.append(sampled)
        if span is None and sampled is None:
            self._ndv_cache[name] = None
            return None
        out = max(1.0, min(candidates))
        self._ndv_cache[name] = out
        return out

    def _sampled_ndv(self, name: str, nonnull: int) -> Optional[float]:
        """Distinct-ratio extrapolation over (up to) ``sample_rows`` rows
        of the first file: a saturated sample (few distincts) means the
        domain is small — report the sample's distinct count; a mostly-
        distinct sample scales linearly with the table."""
        if self.sample_rows <= 0 or not self.files:
            return None
        try:
            import pyarrow.parquet as pq
            pf = pq.ParquetFile(self.files[0])
            if name not in pf.schema_arrow.names:
                return None
            batch = next(pf.iter_batches(batch_size=self.sample_rows,
                                         columns=[name]), None)
        except Exception:
            return None
        if batch is None or batch.num_rows == 0:
            return None
        col = batch.column(0)
        s = batch.num_rows - col.null_count
        if s <= 0:
            return None
        d = len(col.drop_null().unique())
        if d <= 0:
            return None
        if s >= nonnull or d / s < 0.1:
            return float(d)
        return float(min(nonnull, d * (nonnull / s)))


def _span_count(cs: ColumnStats) -> Optional[float]:
    """Distinct-count upper bound from the min/max span of discrete
    domains (integers, dates, booleans)."""
    if not cs.has_minmax or cs.minimum is None or cs.maximum is None:
        return None
    if cs.dtype == BOOL:
        return 2.0
    lo, hi = cs.minimum, cs.maximum
    if cs.dtype == DATE or isinstance(lo, datetime.date):
        try:
            return float(hi.toordinal() - lo.toordinal() + 1)
        except AttributeError:
            return None
    if isinstance(lo, int) and isinstance(hi, int) \
            and not isinstance(lo, bool):
        return float(hi - lo + 1)
    return None


def numeric_span_fraction(cs: ColumnStats, lo, hi) -> Optional[float]:
    """Fraction of the column's [min, max] span covered by [lo, hi]
    (either bound may be None = open). Works for numerics and dates;
    None when the column has no usable min/max or is non-numeric."""
    if not cs.has_minmax or cs.minimum is None or cs.maximum is None:
        return None
    cmin = _as_number(cs.minimum)
    cmax = _as_number(cs.maximum)
    nlo = _as_number(lo) if lo is not None else cmin
    nhi = _as_number(hi) if hi is not None else cmax
    if None in (cmin, cmax, nlo, nhi):
        return None
    width = cmax - cmin
    if width <= 0:
        # Single-valued column: the range either covers it or not.
        return 1.0 if nlo <= cmin <= nhi else 0.0
    covered = min(nhi, cmax) - max(nlo, cmin)
    return max(0.0, min(1.0, covered / width))


def _as_number(v) -> Optional[float]:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, datetime.date):
        return float(v.toordinal())
    if isinstance(v, str):
        try:
            return float(datetime.date.fromisoformat(v).toordinal())
        except ValueError:
            return None
    return None


class StatsProvider:
    """Per-session lazy statistics cache. ``harvest_count`` counts
    footer-reading passes."""

    def __init__(self, session):
        self._session = session
        self._cache: "OrderedDict[Tuple, Optional[TableStats]]" = \
            OrderedDict()
        # Guards the LRU against planners on concurrent serving threads.
        self._lock = threading.Lock()
        self.harvest_count = 0

    def table_stats(self, relation) -> Optional[TableStats]:
        """Statistics for ``relation``'s current file snapshot, or None
        when the relation's physical format has no parquet footers."""
        try:
            key = (tuple(relation.root_paths), relation.file_format,
                   tuple(relation.all_file_infos()))
        except OSError:
            return None
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
        # Footer I/O outside the lock: two racing misses both harvest
        # (idempotent), the second insert wins.
        stats = self._harvest(relation)
        if stats is None:
            # Don't cache failures: a transient footer-read error would
            # otherwise pin None under the current file signature until
            # the source physically changes. Re-probing is cheap (the
            # non-parquet case is a format check, no I/O).
            return None
        with self._lock:
            self._cache[key] = stats
            while len(self._cache) > STATS_CACHE_ENTRIES:
                self._cache.popitem(last=False)
        return stats

    def _harvest(self, relation) -> Optional[TableStats]:
        if relation.data_file_format != "parquet":
            return None
        import pyarrow.parquet as pq
        self.harvest_count += 1
        files = relation.all_files()
        columns: Dict[str, ColumnStats] = {}
        for f in relation.schema.fields:
            columns[f.name] = ColumnStats(dtype=f.dtype)
        file_rows: List[int] = []
        total = 0
        # Footer opens fan out over the reader pool; any unreadable file
        # fails the whole harvest.
        from ..parallel import io as pio
        try:
            footers = pio.map_ordered(lambda p: pq.ParquetFile(p).metadata, list(files),
                                      label="stats_footer")
        except Exception:
            return None
        for md in footers:
            file_rows.append(md.num_rows)
            total += md.num_rows
            for rg in range(md.num_row_groups):
                group = md.row_group(rg)
                for ci in range(group.num_columns):
                    col = group.column(ci)
                    cs = columns.get(col.path_in_schema)
                    if cs is None:
                        continue
                    st = col.statistics
                    if st is None:
                        continue
                    if st.null_count is not None:
                        cs.null_count += st.null_count
                    if not st.has_min_max:
                        continue
                    if st.min is not None and \
                            (cs.minimum is None or st.min < cs.minimum):
                        cs.minimum = st.min
                    if st.max is not None and \
                            (cs.maximum is None or st.max > cs.maximum):
                        cs.maximum = st.max
                    if cs.minimum is not None and cs.maximum is not None:
                        cs.has_minmax = True
        return TableStats(row_count=total, files=files,
                          file_rows=file_rows, columns=columns,
                          sample_rows=STATS_SAMPLE_ROWS)

    def sketch_row_fraction(self, relation, condition) -> Optional[float]:
        """Row-weighted fraction of the relation's files an ACTIVE
        data-skipping index cannot refute for ``condition`` — an upper
        bound on the predicate's selectivity (Bloom membership /
        MinMax refutation at planning time). None when no applicable
        sketch index exists."""
        from ..index.constants import States
        from ..plan.nodes import Scan
        from ..rules.data_skipping_rule import evaluate_sketch_predicate
        from ..rules.rule_utils import _plan_signature

        try:
            entries = self._session.index_collection_manager.get_indexes(
                [States.ACTIVE])
        except Exception:
            return None
        entries = [e for e in entries
                   if e.derivedDataset.kind == "DataSkippingIndex"]
        if not entries:
            return None
        ts = self.table_stats(relation)
        scan = Scan(relation)
        all_files = relation.all_files()
        best: Optional[float] = None
        for entry in entries:
            sig = _plan_signature(entry, scan)
            recorded = entry.signature.signatures[0].value \
                if entry.signature.signatures else None
            if sig is None or recorded is None or sig != recorded:
                continue
            verdict = evaluate_sketch_predicate(entry, condition,
                                                all_files, relation.schema)
            if verdict is None:
                continue
            if ts is not None and ts.row_count > 0 \
                    and len(ts.file_rows) == len(all_files):
                kept = sum(r for r, k in zip(ts.file_rows, verdict) if k)
                frac = kept / ts.row_count
            else:
                frac = float(verdict.sum()) / max(1, len(all_files))
            best = frac if best is None else min(best, frac)
        return best


_ATTACH_LOCK = threading.Lock()


def provider_for(session) -> StatsProvider:
    """The session's (lazily created) statistics provider. Attach under
    a lock: an unlocked check-then-set on concurrent serving threads
    could hand out two providers, double-harvesting every footer."""
    provider = getattr(session, "_stats_provider", None)
    if provider is None:
        with _ATTACH_LOCK:
            provider = getattr(session, "_stats_provider", None)
            if provider is None:
                provider = StatsProvider(session)
                session._stats_provider = provider
    return provider
