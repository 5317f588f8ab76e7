"""The plain reference's view of the generated tables.

Columns are read from the generated parquet files with pyarrow alone, as
numpy arrays: dates as int32 days since 1970-01-01, strings as (codes,
dictionary). Nothing of the program is read or imported here. Derived
arrays that several answers share are kept under a key (``memo``), so a
run works each out once.
"""

from __future__ import annotations

import datetime

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

EPOCH = datetime.date(1970, 1, 1)


def day(d: datetime.date) -> int:
    return (d - EPOCH).days


class RefData:
    def __init__(self, dirs: dict):
        self.dirs = dirs
        self._memo: dict = {}

    def memo(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def load(self, table: str, names) -> None:
        """Read these columns of ``table`` in one pass (pyarrow decodes the
        columns on its threads); ``col`` and ``codes`` then find them."""
        names = [n for n in names if ("raw", table, n) not in self._memo]
        if names:
            t = pq.read_table(self.dirs[table], columns=names)
            for n in names:
                self._memo[("raw", table, n)] = t.column(n).combine_chunks()

    def _raw(self, table: str, name: str):
        self.load(table, [name])
        return self._memo[("raw", table, name)]

    def col(self, table: str, name: str) -> np.ndarray:
        def read():
            arr = self._raw(table, name)
            if pa.types.is_dictionary(arr.type):
                arr = arr.dictionary_decode()
            if pa.types.is_date32(arr.type):
                arr = arr.cast(pa.int32())
            if pa.types.is_string(arr.type) or pa.types.is_large_string(arr.type):
                return np.asarray(arr.to_pylist(), dtype=object)
            return arr.to_numpy()
        return self.memo(("col", table, name), read)

    def codes(self, table: str, name: str):
        """A string column as (int codes, numpy object dictionary)."""
        def read():
            arr = self._raw(table, name)
            if not pa.types.is_dictionary(arr.type):
                arr = pc.dictionary_encode(arr)
            return (arr.indices.to_numpy().astype(np.int64),
                    np.asarray(arr.dictionary.to_pylist(), dtype=object))
        return self.memo(("codes", table, name), read)

    def where(self, table: str, name: str, pred) -> np.ndarray:
        """Row mask of a string column where ``pred(value)`` holds,
        evaluated once per dictionary entry."""
        codes, dictionary = self.codes(table, name)
        return np.fromiter((bool(pred(v)) for v in dictionary), bool, len(dictionary))[codes]

    def strings(self, table: str, name: str, rows) -> np.ndarray:
        codes, dictionary = self.codes(table, name)
        return dictionary[codes[rows]]
