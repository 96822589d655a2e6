"""Attribute serializer registry.

The port's copy of ``janusgraph_tpu/core/attributes.py``: a registry of
binary serializers keyed by a stable small integer id, with an
*order-preserving* mode used for sort keys and composite-index keys
(byte-wise lexicographic order of the encoding == natural order of the
value). Every type id, frame and ordered key is the reference's, byte for
byte (reference: graphdb/database/serialize/StandardSerializer.java:78-132
fixed-id registrations; serialize/attribute/*).

Encodings are fixed-width big-endian where possible so the OLAP bulk
loader can decode property columns with vectorized numpy views instead of
per-value Python.

A class cell or a pickle frame names classes by module path. The port
never imports ``janusgraph_tpu`` to read one: a path of the reference's
that has a counterpart here (``_REFERENCE_CLASSES``) resolves to the port's
class, and the port writes such a class under the reference's path, so the
cells stay byte-equal; any other ``janusgraph_tpu`` path is refused.
"""

from __future__ import annotations

import struct
import uuid as _uuid
import zlib
from dataclasses import dataclass
from datetime import date as _date, datetime, time as _time, timedelta, timezone
from decimal import Decimal
from enum import Enum
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np

from janusgraph_tpu_torch.exceptions import JanusGraphTorchError


class SerializerError(JanusGraphTorchError):
    pass


class AttributeSerializer:
    """One datatype's binary codec. Subclasses set `type_id` and `py_type`."""

    type_id: int = -1
    py_type: type = object
    #: fixed encoded byte width, or None if variable
    fixed_width: Optional[int] = None

    def write(self, value) -> bytes:
        raise NotImplementedError

    def read(self, data: bytes):
        raise NotImplementedError

    # order-preserving variants default to the plain encoding when the plain
    # encoding already sorts correctly; override otherwise.
    def write_ordered(self, value) -> bytes:
        return self.write(value)

    def read_ordered(self, data: bytes):
        return self.read(data)


class BooleanSerializer(AttributeSerializer):
    type_id = 1
    py_type = bool
    fixed_width = 1

    def write(self, value) -> bytes:
        return b"\x01" if value else b"\x00"

    def read(self, data: bytes):
        return data[0] != 0


class LongSerializer(AttributeSerializer):
    """Signed 64-bit. Ordered form flips the sign bit so byte order == numeric
    order (two's-complement big-endian sorts negatives after positives
    otherwise)."""

    type_id = 2
    py_type = int
    fixed_width = 8

    def write(self, value) -> bytes:
        return struct.pack(">q", value)

    def read(self, data: bytes):
        return struct.unpack(">q", data)[0]

    def write_ordered(self, value) -> bytes:
        # struct raises on out-of-range, matching the plain write() path
        return struct.pack(">Q", value + (1 << 63))

    def read_ordered(self, data: bytes):
        return struct.unpack(">Q", data)[0] - (1 << 63)


class DoubleSerializer(AttributeSerializer):
    """IEEE-754 double. Ordered form uses the total-order trick: flip all bits
    of negatives, flip only the sign bit of non-negatives."""

    type_id = 3
    py_type = float
    fixed_width = 8

    def write(self, value) -> bytes:
        return struct.pack(">d", value)

    def read(self, data: bytes):
        return struct.unpack(">d", data)[0]

    def write_ordered(self, value) -> bytes:
        bits = struct.unpack(">Q", struct.pack(">d", value))[0]
        if bits & (1 << 63):
            bits ^= (1 << 64) - 1
        else:
            bits ^= 1 << 63
        return struct.pack(">Q", bits)

    def read_ordered(self, data: bytes):
        bits = struct.unpack(">Q", data)[0]
        if bits & (1 << 63):
            bits ^= 1 << 63
        else:
            bits ^= (1 << 64) - 1
        return struct.unpack(">d", struct.pack(">Q", bits))[0]


class StringSerializer(AttributeSerializer):
    """UTF-8 with transparent compression for long values: payload is
    [flag:1][body], flag 0 = raw utf-8, 1 = zlib(utf-8) (reference:
    serialize/attribute/StringSerializer.java:279 compresses long strings
    the same way). Ordered form stays raw + NUL terminator — compression
    would destroy byte ordering; embedded NULs are rejected there so prefix
    containment can't corrupt ordering."""

    type_id = 4
    py_type = str
    COMPRESS_THRESHOLD = 48

    def write(self, value) -> bytes:
        raw = value.encode("utf-8")
        if len(raw) > self.COMPRESS_THRESHOLD:
            z = zlib.compress(raw, 6)
            if len(z) < len(raw):
                return b"\x01" + z
        return b"\x00" + raw

    def read(self, data: bytes):
        if data[:1] == b"\x01":
            return zlib.decompress(data[1:]).decode("utf-8")
        return data[1:].decode("utf-8")

    def write_ordered(self, value) -> bytes:
        raw = value.encode("utf-8")
        if b"\x00" in raw:
            raise SerializerError("NUL not allowed in ordered (sort-key) strings")
        return raw + b"\x00"

    def read_ordered(self, data: bytes):
        if not data.endswith(b"\x00"):
            raise SerializerError("malformed ordered string")
        return data[:-1].decode("utf-8")


class BytesSerializer(AttributeSerializer):
    type_id = 5
    py_type = bytes

    def write(self, value) -> bytes:
        return bytes(value)

    def read(self, data: bytes):
        return bytes(data)


class DateSerializer(AttributeSerializer):
    """UTC datetime as epoch-micros int64 (ordered like LongSerializer)."""

    type_id = 6
    py_type = datetime
    fixed_width = 8

    _EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)

    def _to_micros(self, value: datetime) -> int:
        if value.tzinfo is None:
            value = value.replace(tzinfo=timezone.utc)
        # integer arithmetic: float timestamps lose microseconds far from epoch
        return (value - self._EPOCH) // timedelta(microseconds=1)

    def _from_micros(self, micros: int) -> datetime:
        return self._EPOCH + timedelta(microseconds=micros)

    def write(self, value) -> bytes:
        return struct.pack(">q", self._to_micros(value))

    def read(self, data: bytes):
        return self._from_micros(struct.unpack(">q", data)[0])

    def write_ordered(self, value) -> bytes:
        return LongSerializer().write_ordered(self._to_micros(value))

    def read_ordered(self, data: bytes):
        return self._from_micros(LongSerializer().read_ordered(data))


class UUIDSerializer(AttributeSerializer):
    type_id = 7
    py_type = _uuid.UUID
    fixed_width = 16

    def write(self, value) -> bytes:
        return value.bytes

    def read(self, data: bytes):
        return _uuid.UUID(bytes=bytes(data))


class FloatListSerializer(AttributeSerializer):
    """list[float] — the OLAP compute-property carrier (e.g. pagerank vectors)."""

    type_id = 8
    py_type = list

    def write(self, value) -> bytes:
        return struct.pack(f">{len(value)}d", *value)

    def read(self, data: bytes):
        n = len(data) // 8
        return list(struct.unpack(f">{n}d", data))


from janusgraph_tpu_torch.core.predicates import Geoshape


def GeoshapePoint(lat: float, lon: float) -> Geoshape:
    """Compat shim: the original minimal point type, now the full Geoshape
    vocabulary (reference: core/attribute/Geoshape.java:623)."""
    return Geoshape.point(lat, lon)


class GeoshapeSerializer(AttributeSerializer):
    """Kind-tagged binary: 0x01 point[2d], 0x02 circle[3d], 0x03 box[4d],
    0x04 polygon[count:2][2d each], 0x05 line, 0x06 multipoint (point
    lists), 0x07/0x08/0x09 multilinestring/multipolygon/collection
    ([count:2] nested length-prefixed sub-shapes) — the full Geoshape
    vocabulary (reference: Geoshape.GeoShapeSerializer binary codec,
    attribute/Geoshape.java:623)."""

    type_id = 9
    py_type = Geoshape

    _PART_TAGS = {
        "MultiLineString": b"\x07",
        "MultiPolygon": b"\x08",
        "GeometryCollection": b"\x09",
    }

    def write(self, value) -> bytes:
        if value.kind == "Point":
            return b"\x01" + struct.pack(">dd", value.lat, value.lon)
        if value.kind == "Circle":
            return b"\x02" + struct.pack(
                ">ddd", value.lat, value.lon, value.radius_km
            )
        if value.kind == "Box":
            (slat, slon), (nlat, nlon) = value.coords
            return b"\x03" + struct.pack(">dddd", slat, slon, nlat, nlon)
        tag = self._PART_TAGS.get(value.kind)
        if tag is not None:
            if len(value.parts) > 0xFFFF:
                raise SerializerError(
                    f"{value.kind} exceeds 65535 parts ({len(value.parts)})"
                )
            out = [tag, struct.pack(">H", len(value.parts))]
            for p in value.parts:
                sub = self.write(p)
                out.append(struct.pack(">I", len(sub)))
                out.append(sub)
            return b"".join(out)
        tag = {"Polygon": b"\x04", "Line": b"\x05", "MultiPoint": b"\x06"}[
            value.kind
        ]
        if len(value.coords) > 0xFFFF:
            raise SerializerError(
                f"{value.kind} exceeds 65535 points ({len(value.coords)})"
            )
        out = [tag, struct.pack(">H", len(value.coords))]
        for la, lo in value.coords:
            out.append(struct.pack(">dd", la, lo))
        return b"".join(out)

    def read(self, data: bytes):
        kind = data[0]
        if kind == 1:
            return Geoshape.point(*struct.unpack(">dd", data[1:17]))
        if kind == 2:
            return Geoshape.circle(*struct.unpack(">ddd", data[1:25]))
        if kind == 3:
            return Geoshape.box(*struct.unpack(">dddd", data[1:33]))
        if kind in (7, 8, 9):
            (n,) = struct.unpack(">H", data[1:3])
            off = 3
            parts = []
            for _ in range(n):
                (ln,) = struct.unpack(">I", data[off:off + 4])
                off += 4
                parts.append(self.read(data[off:off + ln]))
                off += ln
            if kind == 7:
                return Geoshape.multilinestring(parts)
            if kind == 8:
                return Geoshape.multipolygon(parts)
            return Geoshape.geometry_collection(parts)
        (n,) = struct.unpack(">H", data[1:3])
        pts = [
            struct.unpack(">dd", data[3 + 16 * i : 19 + 16 * i]) for i in range(n)
        ]
        if kind == 5:
            return Geoshape.line(pts)
        if kind == 6:
            return Geoshape.multipoint(pts)
        return Geoshape.polygon(pts)


# --------------------------------------------------------------------------
# Sized integer / float scalars (reference registers Java's Byte/Short/
# Integer/Float as distinct datatypes, StandardSerializer.java:78-132; the
# TPU-idiomatic Python carriers are the numpy sized scalar types, which is
# also what OLAP property arrays decode to)
# --------------------------------------------------------------------------

class _SizedIntSerializer(AttributeSerializer):
    fmt = ">q"
    bias = 1 << 63

    def write(self, value) -> bytes:
        return struct.pack(self.fmt, int(value))

    def read(self, data: bytes):
        return self.py_type(struct.unpack(self.fmt, data)[0])

    def write_ordered(self, value) -> bytes:
        # sign-bias so byte-lexicographic order == numeric order
        return struct.pack(self.fmt.upper(), int(value) + self.bias)

    def read_ordered(self, data: bytes):
        return self.py_type(struct.unpack(self.fmt.upper(), data)[0] - self.bias)


class ByteSerializer(_SizedIntSerializer):
    type_id = 10
    py_type = np.int8
    fixed_width = 1
    fmt = ">b"
    bias = 1 << 7


class ShortSerializer(_SizedIntSerializer):
    type_id = 11
    py_type = np.int16
    fixed_width = 2
    fmt = ">h"
    bias = 1 << 15


class IntSerializer(_SizedIntSerializer):
    type_id = 12
    py_type = np.int32
    fixed_width = 4
    fmt = ">i"
    bias = 1 << 31


class NumpyLongSerializer(_SizedIntSerializer):
    type_id = 13
    py_type = np.int64
    fixed_width = 8
    fmt = ">q"
    bias = 1 << 63


class FloatSerializer(AttributeSerializer):
    """IEEE-754 single; same total-order trick as DoubleSerializer."""

    type_id = 14
    py_type = np.float32
    fixed_width = 4

    def write(self, value) -> bytes:
        return struct.pack(">f", float(value))

    def read(self, data: bytes):
        return np.float32(struct.unpack(">f", data)[0])

    def write_ordered(self, value) -> bytes:
        bits = struct.unpack(">I", struct.pack(">f", float(value)))[0]
        bits = bits ^ ((1 << 32) - 1) if bits & (1 << 31) else bits ^ (1 << 31)
        return struct.pack(">I", bits)

    def read_ordered(self, data: bytes):
        bits = struct.unpack(">I", data)[0]
        bits = bits ^ (1 << 31) if bits & (1 << 31) else bits ^ ((1 << 32) - 1)
        return np.float32(struct.unpack(">f", struct.pack(">I", bits))[0])


class Char(str):
    """Single-character datatype (reference registers Character)."""

    def __new__(cls, value):
        if len(value) != 1:
            raise SerializerError("Char must be exactly one character")
        return super().__new__(cls, value)


class CharSerializer(AttributeSerializer):
    type_id = 15
    py_type = Char
    fixed_width = 4

    def write(self, value) -> bytes:
        return struct.pack(">I", ord(value))

    def read(self, data: bytes):
        return Char(chr(struct.unpack(">I", data)[0]))


# --------------------------------------------------------------------------
# Temporal types
# --------------------------------------------------------------------------

@dataclass(frozen=True, order=True)
class Instant:
    """Nanosecond-precision timestamp (reference: java.time.Instant
    registration; Python datetime caps at microseconds, so ns needs its own
    type). seconds = epoch seconds, nanos in [0, 1e9)."""

    seconds: int
    nanos: int = 0

    def __post_init__(self):
        if not (0 <= self.nanos < 1_000_000_000):
            raise SerializerError("nanos must be in [0, 1e9)")

    @staticmethod
    def of(dt: datetime) -> "Instant":
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        micros = (dt - datetime(1970, 1, 1, tzinfo=timezone.utc)) // timedelta(
            microseconds=1
        )
        sec, rem = divmod(micros, 1_000_000)
        return Instant(sec, rem * 1000)

    def to_datetime(self) -> datetime:
        return datetime(1970, 1, 1, tzinfo=timezone.utc) + timedelta(
            seconds=self.seconds, microseconds=self.nanos // 1000
        )


class InstantSerializer(AttributeSerializer):
    """[seconds:8][nanos:4]; ordered form sign-biases seconds so the whole
    12-byte encoding sorts chronologically."""

    type_id = 16
    py_type = Instant
    fixed_width = 12

    def write(self, value) -> bytes:
        return struct.pack(">qI", value.seconds, value.nanos)

    def read(self, data: bytes):
        s, n = struct.unpack(">qI", data)
        return Instant(s, n)

    def write_ordered(self, value) -> bytes:
        return struct.pack(">QI", value.seconds + (1 << 63), value.nanos)

    def read_ordered(self, data: bytes):
        s, n = struct.unpack(">QI", data)
        return Instant(s - (1 << 63), n)


class DurationSerializer(AttributeSerializer):
    type_id = 17
    py_type = timedelta
    fixed_width = 12

    def write(self, value: timedelta) -> bytes:
        micros = value // timedelta(microseconds=1)
        sec, rem = divmod(micros, 1_000_000)
        return struct.pack(">qI", sec, rem * 1000)

    def read(self, data: bytes):
        s, n = struct.unpack(">qI", data)
        return timedelta(seconds=s, microseconds=n // 1000)


class LocalDateSerializer(AttributeSerializer):
    """date as proleptic-Gregorian ordinal int32 (ordered = biased int)."""

    type_id = 18
    py_type = _date
    fixed_width = 4

    def write(self, value: _date) -> bytes:
        return struct.pack(">i", value.toordinal())

    def read(self, data: bytes):
        return _date.fromordinal(struct.unpack(">i", data)[0])

    def write_ordered(self, value) -> bytes:
        return struct.pack(">I", value.toordinal() + (1 << 31))

    def read_ordered(self, data: bytes):
        return _date.fromordinal(struct.unpack(">I", data)[0] - (1 << 31))


class LocalTimeSerializer(AttributeSerializer):
    """time-of-day as nanos-since-midnight int64 (naturally ordered)."""

    type_id = 19
    py_type = _time
    fixed_width = 8

    def write(self, value: _time) -> bytes:
        nanos = (
            (value.hour * 3600 + value.minute * 60 + value.second) * 1_000_000
            + value.microsecond
        ) * 1000
        return struct.pack(">q", nanos)

    def read(self, data: bytes):
        nanos = struct.unpack(">q", data)[0]
        micros, _ = divmod(nanos, 1000)
        sec, micro = divmod(micros, 1_000_000)
        h, rem = divmod(sec, 3600)
        m, s = divmod(rem, 60)
        return _time(h, m, s, micro)


# --------------------------------------------------------------------------
# Primitive arrays — numpy-typed (reference registers boolean[]/byte[]/
# short[]/int[]/long[]/float[]/double[]/char[]/String[] each with its own id,
# StandardSerializer.java:105-115; here each dtype gets an id and values are
# np.ndarray, which is what the OLAP path wants anyway)
# --------------------------------------------------------------------------

class NdArraySerializer(AttributeSerializer):
    """[ndim:1][dim:4 x ndim][big-endian raw data] for one fixed dtype."""

    dtype: np.dtype = None

    def write(self, value) -> bytes:
        a = np.ascontiguousarray(value, dtype=self.dtype)
        if a.ndim > 255:
            raise SerializerError("too many dimensions")
        head = struct.pack(">B", a.ndim) + b"".join(
            struct.pack(">I", d) for d in a.shape
        )
        return head + a.astype(self.dtype.newbyteorder(">")).tobytes()

    def read(self, data: bytes):
        ndim = data[0]
        shape = tuple(
            struct.unpack(">I", data[1 + 4 * i : 5 + 4 * i])[0]
            for i in range(ndim)
        )
        off = 1 + 4 * ndim
        a = np.frombuffer(data[off:], dtype=self.dtype.newbyteorder(">"))
        return a.reshape(shape).astype(self.dtype)


def _array_serializer(tid: int, np_dtype) -> NdArraySerializer:
    class _S(NdArraySerializer):
        type_id = tid
        py_type = np.ndarray
        dtype = np.dtype(np_dtype)

    _S.__name__ = f"NdArraySerializer_{np.dtype(np_dtype).name}"
    return _S()


_ARRAY_IDS = [
    (20, np.bool_), (21, np.int8), (22, np.int16), (23, np.int32),
    (24, np.int64), (25, np.float32), (26, np.float64), (27, np.uint8),
    (44, np.uint16), (45, np.uint32), (46, np.uint64), (47, np.float16),
]


# --------------------------------------------------------------------------
# Container / fallback serializers (reference: StandardSerializer.java
# registers HashMap + TraverserSet through SerializableSerializer and an
# Object fallback at id 1; the Python-idiomatic forms are a framed dict
# codec, a framed heterogeneous tuple codec, and a pickle fallback)
# --------------------------------------------------------------------------

class DictSerializer(AttributeSerializer):
    """dict with framed keys/values through the owning registry (reference:
    StandardSerializer.java:132 HashMap registration)."""

    type_id = 40
    py_type = dict

    def __init__(self, registry: "Serializer"):
        self._reg = registry

    def write_ordered(self, value) -> bytes:
        # non-canonical encoding (insertion-order-dependent) — must never
        # back a sort key or composite index row
        raise SerializerError("dict values have no order-preserving encoding")

    def write(self, value) -> bytes:
        out = [struct.pack(">I", len(value))]
        for k, v in value.items():
            for obj in (k, v):
                frame = self._reg.write_object(obj)
                out.append(struct.pack(">I", len(frame)))
                out.append(frame)
        return b"".join(out)

    def read(self, data: bytes):
        (n,) = struct.unpack(">I", data[:4])
        off = 4
        out = {}
        for _ in range(n):
            pair = []
            for _ in range(2):
                (ln,) = struct.unpack(">I", data[off:off + 4])
                off += 4
                obj, _used = self._reg.read_object(data[off:off + ln])
                pair.append(obj)
                off += ln
            out[pair[0]] = pair[1]
        return out


class TupleSerializer(AttributeSerializer):
    """Heterogeneous tuple with framed elements (covers the reference's
    boxed-array registrations — Parameter[]/char[] style fixed sequences —
    StandardSerializer.java:98-106)."""

    type_id = 41
    py_type = tuple

    def __init__(self, registry: "Serializer"):
        self._reg = registry

    def write_ordered(self, value) -> bytes:
        raise SerializerError("tuple values have no order-preserving encoding")

    def write(self, value) -> bytes:
        out = [struct.pack(">I", len(value))]
        for obj in value:
            frame = self._reg.write_object(obj)
            out.append(struct.pack(">I", len(frame)))
            out.append(frame)
        return b"".join(out)

    def read(self, data: bytes):
        (n,) = struct.unpack(">I", data[:4])
        off = 4
        out = []
        for _ in range(n):
            (ln,) = struct.unpack(">I", data[off:off + 4])
            off += 4
            obj, _used = self._reg.read_object(data[off:off + ln])
            out.append(obj)
            off += ln
        return tuple(out)


#: the reference's package and the port's: a class path under the first
#: reads as the port's counterpart, never as an import of the reference
_REFERENCE_PACKAGE = "janusgraph_tpu"
_PORT_PACKAGE = "janusgraph_tpu_torch"

#: the classes a class cell or a pickle may name under the reference's
#: module path, as (module below the package, qualname); each has its
#: counterpart at the same path below the port's package
_REFERENCE_CLASSES = frozenset({
    ("core.attributes", "BigInt"), ("core.attributes", "Char"),
    ("core.attributes", "Instant"), ("core.predicates", "Geoshape"),
    ("core.codecs", "Cardinality"), ("core.codecs", "Consistency"),
    ("core.codecs", "Direction"), ("core.codecs", "Multiplicity"),
    ("core.codecs", "RelationCategory"), ("core.codecs", "RelationIdentifier"),
    ("core.config", "Mutability"), ("core.management", "SchemaAction"),
    ("core.management", "SchemaStatus"), ("core.txlog", "LogTxStatus"),
    ("indexing.provider", "Mapping"), ("storage.idauthority", "ConflictAvoidanceMode"),
    ("util.timestamps", "TimestampProviders"),
})


def _in_package(mod: str, package: str) -> bool:
    return mod == package or mod.startswith(package + ".")


def _port_class(mod: str, qual: str) -> type:
    """The port's counterpart of a class the reference's path names."""
    rel = mod[len(_REFERENCE_PACKAGE) + 1:]
    if (rel, qual) not in _REFERENCE_CLASSES:
        raise SerializerError(
            f"class {mod}:{qual} of the reference package has no counterpart "
            "in the port"
        )
    return _resolve_class(f"{_PORT_PACKAGE}.{rel}", qual)


def _stored_path(cls) -> Tuple[str, str]:
    """The path a class is stored under: a port class with a counterpart in
    the reference under the reference's path, every other class its own."""
    mod, qual = cls.__module__, cls.__qualname__
    if _in_package(mod, _PORT_PACKAGE):
        rel = mod[len(_PORT_PACKAGE) + 1:]
        if (rel, qual) in _REFERENCE_CLASSES:
            return f"{_REFERENCE_PACKAGE}.{rel}", qual
    return mod, qual


def _resolve_class(mod: str, qual: str):
    import importlib

    try:
        obj = importlib.import_module(mod)
        for part in qual.split("."):
            obj = getattr(obj, part)
    except (ImportError, AttributeError) as e:
        raise SerializerError(f"cannot resolve class {mod}:{qual}: {e}") from e
    return obj


def _pickle_dumps(value) -> bytes:
    import pickle

    data = pickle.dumps(value, protocol=4)
    if _PORT_PACKAGE.encode() not in data:
        return data

    class _ReferencePathPickler(pickle._Pickler):
        # the pure-Python pickler, so a port class with a counterpart can
        # be written under the reference's path (the C pickler always
        # writes __module__); the opcodes are the C pickler's
        def save_global(self, obj, name=None):
            path = _stored_path(obj) if isinstance(obj, type) else None
            if path is None or path == (obj.__module__, obj.__qualname__):
                return super().save_global(obj, name)
            self.save(path[0])
            self.save(path[1])
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)

    import io

    buf = io.BytesIO()
    _ReferencePathPickler(buf, protocol=4).dump(value)
    return buf.getvalue()


def _pickle_loads(data: bytes):
    import io
    import pickle

    class _PortUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if _in_package(module, _REFERENCE_PACKAGE):
                return _port_class(module, name)
            return super().find_class(module, name)

    return _PortUnpickler(io.BytesIO(data)).load()


class PickledObjectSerializer(AttributeSerializer):
    """Arbitrary-object fallback via pickle (reference:
    StandardSerializer.java:78 ObjectSerializer / SerializableSerializer —
    the Kryo catch-all). SECURITY: pickle deserialization executes code;
    only registries opened with allow_pickle=True (the embedded graph's own
    cells, same trust domain as the reference's Kryo) will decode it — the
    network-facing registries (remote index server) refuse. A class the
    pickle names under the reference's package resolves through
    ``_REFERENCE_CLASSES``."""

    type_id = 42
    py_type = object

    def __init__(self, registry: "Serializer"):
        self._reg = registry

    def write_ordered(self, value) -> bytes:
        raise SerializerError(
            "object-fallback values have no order-preserving encoding"
        )

    def write(self, value) -> bytes:
        if not self._reg.allow_pickle:
            raise SerializerError(
                f"no serializer for {type(value).__name__} "
                "(object-pickle fallback disabled on this registry)"
            )
        try:
            return _pickle_dumps(value)
        except Exception as e:
            raise SerializerError(
                f"object fallback cannot pickle {type(value).__name__}: {e}"
            ) from e

    def read(self, data: bytes):
        if not self._reg.allow_pickle:
            raise SerializerError(
                "object-pickle payload refused (allow_pickle=False registry)"
            )
        return _pickle_loads(data)


#: importable module prefixes for ClassSerializer.read — everything else is
#: refused (a stored class name must not trigger arbitrary imports); the
#: reference's package resolves through ``_REFERENCE_CLASSES`` instead
_CLASS_IMPORT_ALLOW = ("builtins", "numpy", "datetime", "decimal", "uuid")


def _class_path_allowed(mod: str, qual: str) -> bool:
    if "<locals>" in qual:
        return False  # function-local classes can never be re-imported
    return mod in _CLASS_IMPORT_ALLOW or any(
        mod.startswith(p) for p in _CLASS_IMPORT_ALLOW if p.endswith(".")
    )


class ClassSerializer(AttributeSerializer):
    """Python type values by dotted path (reference:
    StandardSerializer.java:126 Class registration) — schema/config cells
    that record a datatype. Write-time validation mirrors read-time: a
    class that could not be decoded later is refused BEFORE it reaches a
    cell (undecodable persisted values are data loss). A port class with a
    counterpart in the reference is written under the reference's path."""

    type_id = 43
    py_type = type

    def write(self, value) -> bytes:
        mod, qual = _stored_path(value)
        if "<locals>" in qual or not (
            _class_path_allowed(mod, qual)
            or _in_package(mod, _REFERENCE_PACKAGE)
        ):
            raise SerializerError(
                f"class {mod}:{qual} not storable (module outside the "
                f"import allowlist {_CLASS_IMPORT_ALLOW}, a port class "
                "without a counterpart in the reference, or function-local)"
            )
        return f"{mod}:{qual}".encode()

    def read(self, data: bytes):
        mod, _, qual = data.decode().partition(":")
        if "<locals>" not in qual and _in_package(mod, _REFERENCE_PACKAGE):
            obj = _port_class(mod, qual)
        elif not _class_path_allowed(mod, qual):
            raise SerializerError(f"class import refused for module {mod!r}")
        else:
            obj = _resolve_class(mod, qual)
        if not isinstance(obj, type):
            raise SerializerError(f"{mod}:{qual} is not a type")
        return obj


class StringListSerializer(AttributeSerializer):
    """list[str] with per-item length framing (reference: String[])."""

    type_id = 28
    py_type = list  # dispatched via serializer_for's list special-case

    def write(self, value) -> bytes:
        out = [struct.pack(">I", len(value))]
        for s in value:
            raw = s.encode("utf-8")
            out.append(struct.pack(">I", len(raw)) + raw)
        return b"".join(out)

    def read(self, data: bytes):
        (n,) = struct.unpack(">I", data[:4])
        off = 4
        out = []
        for _ in range(n):
            (ln,) = struct.unpack(">I", data[off : off + 4])
            off += 4
            out.append(data[off : off + ln].decode("utf-8"))
            off += ln
        return out


# --------------------------------------------------------------------------
# Enums (reference registers each schema enum with a fixed id,
# StandardSerializer.java:90-104; user enums attach via register_enum)
# --------------------------------------------------------------------------

class EnumSerializer(AttributeSerializer):
    """One Enum class; encodes the member's ordinal position (stable as long
    as members are only appended, same contract as the reference)."""

    def __init__(self, enum_cls: Type[Enum], type_id: int):
        self.type_id = type_id
        self.py_type = enum_cls
        self._members = list(enum_cls)
        self.fixed_width = 2

    def write(self, value) -> bytes:
        return struct.pack(">H", self._members.index(value))

    def read(self, data: bytes):
        return self._members[struct.unpack(">H", data)[0]]


def _framework_enums():
    from janusgraph_tpu_torch.core.codecs import (
        Cardinality,
        Consistency,
        Direction,
        Multiplicity,
        RelationCategory,
    )
    from janusgraph_tpu_torch.core.config import Mutability
    from janusgraph_tpu_torch.core.management import SchemaAction, SchemaStatus
    from janusgraph_tpu_torch.core.txlog import LogTxStatus
    from janusgraph_tpu_torch.indexing.provider import Mapping as IndexMapping
    from janusgraph_tpu_torch.storage.idauthority import ConflictAvoidanceMode
    from janusgraph_tpu_torch.util.timestamps import TimestampProviders

    return [
        (30, Direction), (31, RelationCategory), (32, Cardinality),
        (33, Multiplicity), (34, SchemaAction), (35, Mutability),
        (36, LogTxStatus), (37, IndexMapping), (48, SchemaStatus),
        (49, Consistency),
        # user-visible config enums serialized into global config
        # (reference: StandardSerializer.java:90-104 registering
        # TimestampProviders + ConflictAvoidanceMode)
        (50, TimestampProviders), (51, ConflictAvoidanceMode),
    ]


class BigInt(int):
    """Schema marker for arbitrary-precision integer property keys (the
    reference's BigInteger data type, distinct from Long). Plain ints
    outside the int64 range auto-promote to this codec on write."""


class BigIntegerSerializer(AttributeSerializer):
    """Arbitrary-precision signed integer (reference: StandardSerializer
    registers BigInteger, StandardSerializer.java:78-132). Plain form:
    minimal two's-complement big-endian. Ordered form: a length-class
    prefix byte, then sign-adjusted magnitude — longer positive magnitudes
    sort after shorter ones, longer negative magnitudes before, so byte
    order == numeric order for |v| < 2**1016."""

    type_id = 38
    py_type = BigInt  # plain int dispatches here explicitly beyond int64

    def write(self, value) -> bytes:
        length = max(1, (value.bit_length() + 8) // 8)
        return value.to_bytes(length, "big", signed=True)

    def read(self, data: bytes):
        return int.from_bytes(data, "big", signed=True)

    def write_ordered(self, value) -> bytes:
        if value == 0:
            return b"\x80"
        mag = abs(value)
        m = mag.to_bytes((mag.bit_length() + 7) // 8, "big")
        if len(m) > 0x7F:
            raise SerializerError("ordered BigInteger limited to 127 bytes")
        if value > 0:
            return bytes([0x80 + len(m)]) + m
        return bytes([0x7F - len(m)]) + bytes(255 - b for b in m)

    def read_ordered(self, data: bytes):
        b0 = data[0]
        if b0 == 0x80:
            return 0
        if b0 > 0x80:
            n = b0 - 0x80
            return int.from_bytes(data[1 : 1 + n], "big")
        n = 0x7F - b0
        mag = int.from_bytes(bytes(255 - b for b in data[1 : 1 + n]), "big")
        return -mag


class DecimalSerializer(AttributeSerializer):
    """decimal.Decimal (reference BigDecimal). Plain form: the exact string
    representation (scale-preserving round trip). Ordered form: sign class
    byte, then ordered-int64 decimal exponent and 0x01+digit bytes with a
    terminator (all complemented for negatives) — byte order == numeric
    order; decoding the ordered form yields a numerically-equal Decimal in
    minimal form (trailing zeros are not preserved there)."""

    type_id = 39
    py_type = Decimal

    def write(self, value) -> bytes:
        return str(value).encode("ascii")

    def read(self, data: bytes):
        return Decimal(data.decode("ascii"))

    def write_ordered(self, value) -> bytes:
        if value.is_nan() or value.is_infinite():
            raise SerializerError("ordered Decimal must be finite")
        if value == 0:
            return b"\x80"
        # strip trailing zeros by hand: Decimal.normalize() rounds to the
        # context precision (28 digits), conflating longer values
        sign, digits, exp = value.as_tuple()
        while len(digits) > 1 and digits[-1] == 0:
            digits = digits[:-1]
            exp += 1
        # value = 0.D1D2.. * 10**E  with D1 != 0
        e = exp + len(digits)
        ekey = struct.pack(">Q", e + (1 << 63))
        dkey = bytes(1 + d for d in digits) + b"\x00"
        if sign == 0:
            return b"\xc0" + ekey + dkey
        return b"\x40" + bytes(255 - b for b in ekey + dkey)

    def read_ordered(self, data: bytes):
        from decimal import Decimal

        b0 = data[0]
        if b0 == 0x80:
            return Decimal(0)
        body = data[1:]
        neg = b0 == 0x40
        if neg:
            body = bytes(255 - b for b in body)
        e = struct.unpack(">Q", body[:8])[0] - (1 << 63)
        digits = []
        for b in body[8:]:
            if b == 0:
                break
            digits.append(b - 1)
        d = Decimal((1 if neg else 0, tuple(digits), e - len(digits)))
        return d


#: first id available to register_enum / register for user-defined types
USER_TYPE_ID_START = 100


class Serializer:
    """The registry: type-id <-> serializer <-> python type.

    Values are framed as [type_id:2 BE][payload] so heterogeneous cells are
    self-describing (reference: StandardSerializer writeObjectNotNull)."""

    def __init__(self, allow_pickle: bool = True):
        #: whether the object-pickle fallback may encode/decode on this
        #: registry (False for network-facing registries — see
        #: PickledObjectSerializer)
        self.allow_pickle = allow_pickle
        self._by_id: Dict[int, AttributeSerializer] = {}
        self._by_type: Dict[type, AttributeSerializer] = {}
        self._array_by_dtype: Dict[np.dtype, AttributeSerializer] = {}
        for cls in (
            BooleanSerializer,
            LongSerializer,
            DoubleSerializer,
            StringSerializer,
            BytesSerializer,
            DateSerializer,
            UUIDSerializer,
            FloatListSerializer,
            GeoshapeSerializer,
            ByteSerializer,
            ShortSerializer,
            IntSerializer,
            NumpyLongSerializer,
            FloatSerializer,
            CharSerializer,
            InstantSerializer,
            DurationSerializer,
            LocalDateSerializer,
            LocalTimeSerializer,
            StringListSerializer,
            BigIntegerSerializer,
            DecimalSerializer,
            ClassSerializer,
        ):
            self.register(cls())
        for cls in (DictSerializer, TupleSerializer, PickledObjectSerializer):
            self.register(cls(self))
        for tid, dt in _ARRAY_IDS:
            ser = _array_serializer(tid, dt)
            self._by_id[tid] = ser
            self._array_by_dtype[np.dtype(dt)] = ser
        self._by_type[np.ndarray] = self._array_by_dtype[np.dtype(np.float64)]
        for tid, enum_cls in _framework_enums():
            self.register_enum(enum_cls, tid)

    def register_enum(self, enum_cls: Type[Enum], type_id: int) -> None:
        """Attach an Enum datatype (user enums: type_id >= USER_TYPE_ID_START)."""
        self.register(EnumSerializer(enum_cls, type_id))

    def register(self, ser: AttributeSerializer) -> None:
        if ser.type_id in self._by_id:
            raise SerializerError(f"duplicate serializer id {ser.type_id}")
        if ser.type_id >= 0xFFFF:
            # 0xFFFF is the property-cell META marker (codecs._META_MARKER)
            # — a value frame starting with it would misparse as metas
            raise SerializerError(
                f"serializer id {ser.type_id} reserved (>= 0xFFFF)"
            )
        self._by_id[ser.type_id] = ser
        # first registration wins the python-type slot (list maps to
        # FloatListSerializer; StringListSerializer dispatches by content)
        self._by_type.setdefault(ser.py_type, ser)

    def serializer_for(self, value) -> AttributeSerializer:
        # numpy arrays dispatch on dtype (one id per element type, mirroring
        # the reference's per-primitive array registrations)
        if isinstance(value, np.ndarray):
            ser = self._array_by_dtype.get(value.dtype)
            if ser is None:
                raise SerializerError(f"no array serializer for dtype {value.dtype}")
            return ser
        # lists: numeric lists keep the legacy FloatList encoding; string
        # lists use the String[] analogue
        if isinstance(value, list):
            if value and all(isinstance(x, str) for x in value):
                return self._by_id[StringListSerializer.type_id]
            return self._by_id[FloatListSerializer.type_id]
        # ints beyond 64 bits promote to the BigInteger codec (the plain
        # int slot belongs to LongSerializer, whose struct.pack would raise)
        if (
            isinstance(value, int)
            and not isinstance(value, bool)
            and not (-(1 << 63) <= value < (1 << 63))
        ):
            return self._by_id[BigIntegerSerializer.type_id]
        # bool is a subclass of int: check exact type first, then walk MRO
        ser = self._by_type.get(type(value))
        if ser is not None:
            return ser
        for t, s in self._by_type.items():
            if isinstance(value, t) and not (
                t is int and isinstance(value, bool)
            ):
                return s
        raise SerializerError(f"no serializer for {type(value).__name__}")

    def serializer_for_type(self, py_type: type) -> AttributeSerializer:
        ser = self._by_type.get(py_type)
        if ser is None:
            raise SerializerError(f"no serializer for type {py_type.__name__}")
        return ser

    # -- framed object encoding --------------------------------------------
    def write_object(self, value) -> bytes:
        ser = self.serializer_for(value)
        return struct.pack(">H", ser.type_id) + ser.write(value)

    def read_object(self, data: bytes) -> Tuple[Any, int]:
        """Decode a framed value; returns (value, bytes_consumed). Only
        fixed-width payloads can be length-inferred mid-stream; variable-width
        payloads must be the tail of `data`."""
        (tid,) = struct.unpack(">H", data[:2])
        ser = self._by_id.get(tid)
        if ser is None:
            raise SerializerError(f"unknown serializer id {tid}")
        if ser.fixed_width is not None:
            end = 2 + ser.fixed_width
            return ser.read(data[2:end]), end
        return ser.read(data[2:]), len(data)

    # -- order-preserving encoding (sort keys / index keys) ----------------
    def write_ordered(self, value) -> bytes:
        ser = self.serializer_for(value)
        return ser.write_ordered(value)

    def data_type_id(self, py_type: type) -> int:
        return self.serializer_for_type(py_type).type_id

    def type_for_id(self, tid: int) -> type:
        ser = self._by_id.get(tid)
        if ser is None:
            raise SerializerError(f"unknown serializer id {tid}")
        return ser.py_type
