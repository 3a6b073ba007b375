"""SQL data types and schemas (the port's copy of `spark_tpu/types`).

Each type carries its device representation as a `torch.dtype`
(`device_dtype`) with the widths the JAX package uses under x64, plus the
numpy dtype of its host planes (`numpy_dtype`). Dates are int32 days since
the epoch; timestamps int64 microseconds since the epoch, with no session
time zone; strings and binary are int32 codes into a host dictionary of
`str` or `bytes`; arrays, maps and structs as column types are int32 codes
into a host dictionary of Python lists, dicts and dicts; decimals are int64
scaled by 10^scale, precision at most 18 (an Arrow decimal past 18 digits
raises `NotPortedError`).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field

import numpy as np
import torch

from ..errors import NotPortedError

__all__ = [
    "DataType", "NumericType", "IntegralType", "FractionalType",
    "BooleanType", "ByteType", "ShortType", "IntegerType", "LongType",
    "FloatType", "DoubleType", "DateType", "TimestampType", "NullType",
    "StringType", "BinaryType", "DecimalType", "StructField", "StructType",
    "ArrayType", "MapType",
    "boolean", "int8", "int16", "int32", "int64", "float32", "float64",
    "date", "timestamp", "string", "binary", "null_type", "common_type",
    "dict_encoded",
    "from_arrow_type", "to_arrow_type", "infer_type",
]


@dataclass(frozen=True)
class DataType:
    """Base SQL type. Subclasses are singletons."""

    _numpy = np.dtype(np.int32)
    _torch = torch.int32

    def simple_string(self) -> str:
        return type(self).__name__.replace("Type", "").lower()

    @property
    def device_dtype(self) -> torch.dtype:
        """torch dtype of the on-device representation."""
        return self._torch

    @property
    def numpy_dtype(self) -> np.dtype:
        """numpy dtype of the host representation (Arrow ingest/collect)."""
        return self._numpy

    def __repr__(self) -> str:  # pragma: no cover
        return self.simple_string()


class NullType(DataType):
    pass


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class FractionalType(NumericType):
    pass


class BooleanType(DataType):
    _numpy = np.dtype(np.bool_)
    _torch = torch.bool


class ByteType(IntegralType):
    _numpy = np.dtype(np.int8)
    _torch = torch.int8


class ShortType(IntegralType):
    _numpy = np.dtype(np.int16)
    _torch = torch.int16


class IntegerType(IntegralType):
    pass


class LongType(IntegralType):
    _numpy = np.dtype(np.int64)
    _torch = torch.int64


class FloatType(FractionalType):
    _numpy = np.dtype(np.float32)
    _torch = torch.float32


class DoubleType(FractionalType):
    _numpy = np.dtype(np.float64)
    _torch = torch.float64


class DateType(DataType):
    """Days since 1970-01-01 (matches Arrow date32)."""


class TimestampType(DataType):
    """Microseconds since 1970-01-01 00:00:00, no time zone (matches Arrow
    timestamp[us])."""

    _numpy = np.dtype(np.int64)
    _torch = torch.int64


class StringType(DataType):
    """Dictionary-encoded UTF-8 string: int32 codes on the device into a
    host dictionary (`columnar.batch.StringDict`)."""


class BinaryType(StringType):
    """Binary blobs, dictionary-encoded like strings (the dictionary holds
    `bytes`)."""


@dataclass(frozen=True, repr=False)
class DecimalType(FractionalType):
    """Fixed-point decimal stored as int64 scaled by 10^scale on the
    device; precision is capped at 18 so every value fits int64."""

    precision: int = 10
    scale: int = 0

    MAX_PRECISION = 18
    _numpy = np.dtype(np.int64)
    _torch = torch.int64

    def simple_string(self) -> str:
        return f"decimal({self.precision},{self.scale})"


@dataclass(frozen=True, repr=False)
class ArrayType(DataType):
    """An array column: ragged lists have no dense device layout, so the
    column is dictionary-encoded like a string, int32 codes on the device
    and the Python lists in the column's host dictionary."""

    element_type: DataType = field(default_factory=lambda: IntegerType())

    def simple_string(self) -> str:
        return f"array<{self.element_type.simple_string()}>"


@dataclass(frozen=True, repr=False)
class MapType(DataType):
    """A map column, dictionary-encoded like an array (Python dicts in the
    host dictionary)."""

    key_type: DataType = field(default_factory=lambda: StringType())
    value_type: DataType = field(default_factory=lambda: IntegerType())

    def simple_string(self) -> str:
        return (f"map<{self.key_type.simple_string()},"
                f"{self.value_type.simple_string()}>")


boolean = BooleanType()
int8 = ByteType()
int16 = ShortType()
int32 = IntegerType()
int64 = LongType()
float32 = FloatType()
float64 = DoubleType()
date = DateType()
timestamp = TimestampType()
string = StringType()
binary = BinaryType()
null_type = NullType()


@dataclass(frozen=True)
class StructField:
    name: str
    dataType: DataType
    nullable: bool = True

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.name}:{self.dataType.simple_string()}"


@dataclass(frozen=True)
class StructType(DataType):
    """A schema, and a struct column's type: as a column it is
    dictionary-encoded (int32 codes, Python dicts in the host
    dictionary)."""

    fields: tuple[StructField, ...] = ()

    def __init__(self, fields=()):
        object.__setattr__(self, "fields", tuple(fields))

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def field_type(self, name: str) -> "DataType | None":
        for f in self.fields:
            if f.name == name:
                return f.dataType
        return None

    def add(self, name: str, dataType: DataType,
            nullable: bool = True) -> "StructType":
        return StructType(self.fields + (StructField(name, dataType,
                                                     nullable),))

    def __getitem__(self, name: str) -> StructField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def simple_string(self) -> str:
        inner = ",".join(f"{f.name}:{f.dataType.simple_string()}" for f in self.fields)
        return f"struct<{inner}>"


# ---------------------------------------------------------------------------
# Type coercion lattice (reference: sqlcat/analysis/TypeCoercion.scala)
# ---------------------------------------------------------------------------

_NUMERIC_ORDER: list[DataType] = [int8, int16, int32, int64, float32, float64]


def _numeric_rank(dt: DataType) -> int:
    if isinstance(dt, DecimalType):
        return _NUMERIC_ORDER.index(int64)  # decimals widen like long
    for i, t in enumerate(_NUMERIC_ORDER):
        if type(dt) is type(t):
            return i
    return -1


def common_type(a: DataType, b: DataType) -> DataType | None:
    """Tightest common type both sides can be cast to, or None."""
    if a == b:
        return a
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
    if isinstance(a, DecimalType) and isinstance(b, DecimalType):
        scale = max(a.scale, b.scale)
        intd = max(a.precision - a.scale, b.precision - b.scale)
        return DecimalType(min(intd + scale, DecimalType.MAX_PRECISION), scale)
    if isinstance(a, DecimalType) and isinstance(b, IntegralType):
        return a
    if isinstance(b, DecimalType) and isinstance(a, IntegralType):
        return b
    if isinstance(a, DecimalType) and isinstance(b, FractionalType):
        return float64
    if isinstance(b, DecimalType) and isinstance(a, FractionalType):
        return float64
    ra, rb = _numeric_rank(a), _numeric_rank(b)
    if ra >= 0 and rb >= 0:
        return _NUMERIC_ORDER[max(ra, rb)]
    if isinstance(a, StringType) and isinstance(b, StringType):
        return string
    if isinstance(a, DateType) and isinstance(b, TimestampType):
        return timestamp
    if isinstance(b, DateType) and isinstance(a, TimestampType):
        return timestamp
    # string <-> other: the reference models the string side as the other
    # type (a cast of the dictionary, not ported)
    if isinstance(a, StringType):
        return b
    if isinstance(b, StringType):
        return a
    return None


def dict_encoded(dt) -> bool:
    """True for types whose columns are host-dictionary-encoded (int32
    codes on the device): strings, binary, arrays, maps and structs."""
    return isinstance(dt, (StringType, ArrayType, MapType, StructType))


# ---------------------------------------------------------------------------
# Arrow mapping
# ---------------------------------------------------------------------------

def from_arrow_type(at) -> DataType:
    import pyarrow as pa

    if pa.types.is_boolean(at):
        return boolean
    if pa.types.is_int8(at):
        return int8
    if pa.types.is_int16(at):
        return int16
    if pa.types.is_int32(at):
        return int32
    if pa.types.is_int64(at):
        return int64
    if pa.types.is_float32(at):
        return float32
    if pa.types.is_float64(at):
        return float64
    if pa.types.is_date32(at):
        return date
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return string
    if pa.types.is_binary(at) or pa.types.is_large_binary(at):
        return binary
    if pa.types.is_timestamp(at):
        # any unit or zone: ingest casts it to timestamp[us]
        return timestamp
    if pa.types.is_decimal(at):
        if at.precision > DecimalType.MAX_PRECISION:
            # the reference caps the precision and keeps int64 (values
            # past 18 digits would wrap): the port refuses instead
            raise NotPortedError(f"Arrow type {at} (decimal precision > 18)")
        return DecimalType(at.precision, at.scale)
    if pa.types.is_dictionary(at):
        return from_arrow_type(at.value_type)
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return ArrayType(from_arrow_type(at.value_type))
    if pa.types.is_map(at):
        return MapType(from_arrow_type(at.key_type),
                       from_arrow_type(at.item_type))
    if pa.types.is_struct(at):
        return StructType(tuple(
            StructField(f.name, from_arrow_type(f.type), f.nullable)
            for f in at))
    if pa.types.is_null(at):
        return null_type
    raise NotPortedError(f"Arrow type {at} (column type)")


def to_arrow_type(dt: DataType):
    import pyarrow as pa

    if isinstance(dt, BooleanType):
        return pa.bool_()
    if isinstance(dt, ByteType):
        return pa.int8()
    if isinstance(dt, ShortType):
        return pa.int16()
    if isinstance(dt, IntegerType):
        return pa.int32()
    if isinstance(dt, LongType):
        return pa.int64()
    if isinstance(dt, FloatType):
        return pa.float32()
    if isinstance(dt, DoubleType):
        return pa.float64()
    if isinstance(dt, DateType):
        return pa.date32()
    if isinstance(dt, TimestampType):
        return pa.timestamp("us")
    if isinstance(dt, BinaryType):
        return pa.binary()
    if isinstance(dt, StringType):
        return pa.string()
    if isinstance(dt, DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    if isinstance(dt, NullType):
        return pa.null()
    if isinstance(dt, ArrayType):
        return pa.list_(to_arrow_type(dt.element_type))
    if isinstance(dt, MapType):
        return pa.map_(to_arrow_type(dt.key_type),
                       to_arrow_type(dt.value_type))
    if isinstance(dt, StructType):
        return pa.struct([(f.name, to_arrow_type(f.dataType))
                          for f in dt.fields])
    raise NotPortedError(f"type {dt.simple_string()}")


def infer_type(value) -> DataType:
    """Infer a DataType from a Python literal value."""
    if value is None:
        return null_type
    if isinstance(value, bool):
        return boolean
    if isinstance(value, int):
        return int32 if -(2**31) <= value < 2**31 else int64
    if isinstance(value, float):
        return float64
    if isinstance(value, str):
        return string
    if isinstance(value, bytes):
        return binary
    if isinstance(value, datetime.datetime):
        return timestamp
    if isinstance(value, datetime.date):
        return date
    import decimal as _d

    if isinstance(value, _d.Decimal):
        sign, digits, exp = value.as_tuple()
        scale = max(0, -exp)
        return DecimalType(max(len(digits), scale), scale)
    if isinstance(value, (list, tuple)):
        return ArrayType(_common_of([infer_type(v) for v in value]))
    if isinstance(value, dict):
        return MapType(_common_of([infer_type(k) for k in value]),
                       _common_of([infer_type(v) for v in value.values()]))
    raise NotPortedError(f"literal of type {type(value).__name__}")


def _common_of(types) -> DataType:
    """The common type of a literal collection's elements (null_type when
    it is empty or all NULL)."""
    out: DataType = null_type
    for t in types:
        out = common_type(out, t) or t
    return out
