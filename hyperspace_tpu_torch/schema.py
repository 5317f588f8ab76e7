"""Columnar schema model (counterpart of ``hyperspace_tpu/schema.py``).

A flat list of typed, nullable fields with a stable JSON encoding,
convertible to/from pyarrow schemas at the IO boundary. The JSON form is
the one the index op log stores, so both packages read each other's logs.

Every logical type has a fixed-width device representation (strings become
order-preserving dictionary codes at load time, see execution/columnar.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import pyarrow as pa

# Logical type names.
INT32 = "int32"
INT64 = "int64"
FLOAT32 = "float32"
FLOAT64 = "float64"
BOOL = "bool"
STRING = "string"
DATE = "date"  # days since epoch, int32 on device.

_ALL_TYPES = (INT32, INT64, FLOAT32, FLOAT64, BOOL, STRING, DATE)

_ARROW_TO_LOGICAL = {
    pa.int8(): INT32,
    pa.int16(): INT32,
    pa.int32(): INT32,
    pa.int64(): INT64,
    pa.float32(): FLOAT32,
    pa.float64(): FLOAT64,
    pa.bool_(): BOOL,
    pa.string(): STRING,
    pa.large_string(): STRING,
    pa.date32(): DATE,
}

_LOGICAL_TO_ARROW = {
    INT32: pa.int32(),
    INT64: pa.int64(),
    FLOAT32: pa.float32(),
    FLOAT64: pa.float64(),
    BOOL: pa.bool_(),
    STRING: pa.string(),
    DATE: pa.date32(),
}


@dataclass(frozen=True)
class Field:
    name: str
    dtype: str
    nullable: bool = True

    def __post_init__(self):
        if self.dtype not in _ALL_TYPES:
            raise ValueError(f"Unsupported logical type: {self.dtype}")

    def to_json_dict(self) -> Dict:
        return {"name": self.name, "type": self.dtype, "nullable": self.nullable}

    @staticmethod
    def from_json_dict(d: Dict) -> "Field":
        return Field(d["name"], d["type"], d.get("nullable", True))


@dataclass(frozen=True)
class Schema:
    fields: tuple

    def __init__(self, fields: Sequence[Field]):
        object.__setattr__(self, "fields", tuple(fields))

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    def select(self, names: Sequence[str]) -> "Schema":
        return Schema([self.field(n) for n in names])

    def append(self, field: Field) -> "Schema":
        return Schema(list(self.fields) + [field])

    def to_json_dict(self) -> List[Dict]:
        return [f.to_json_dict() for f in self.fields]

    @staticmethod
    def from_json_dict(d: List[Dict]) -> "Schema":
        return Schema([Field.from_json_dict(x) for x in d])

    def to_arrow(self) -> pa.Schema:
        return pa.schema([pa.field(f.name, _LOGICAL_TO_ARROW[f.dtype], f.nullable)
                          for f in self.fields])

    @staticmethod
    def from_arrow(arrow_schema: pa.Schema) -> "Schema":
        """Struct fields are flattened recursively into dotted leaf names
        (``a.b.c``) — nested data never reaches the device as structs; each
        leaf is an independent flat column (parity with the reference's
        nested-field flattening, util/ResolverUtils.scala:112-162, minus its
        ``__hs_nested.`` storage prefix, which Spark needed only because
        Catalyst attribute names cannot contain dots)."""
        fields = []

        def add(prefix: str, f) -> None:
            t = f.type
            name = f"{prefix}{f.name}"
            if pa.types.is_struct(t):
                for sub in t:
                    add(f"{name}.", sub)
                return
            if pa.types.is_dictionary(t):
                t = t.value_type
            if pa.types.is_decimal(t):
                logical = FLOAT64
            elif pa.types.is_timestamp(t):
                logical = INT64
            elif t in _ARROW_TO_LOGICAL:
                logical = _ARROW_TO_LOGICAL[t]
            else:
                raise ValueError(f"Unsupported arrow type for field {name}: {t}")
            fields.append(Field(name, logical, f.nullable))

        for f in arrow_schema:
            add("", f)
        return Schema(fields)
