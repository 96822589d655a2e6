"""Attribute serializer registry — the part of
``janusgraph_tpu/core/attributes.py`` that the stored graph and the
traversal write and read: the framed encoding ``[type_id:2 BE][payload]``
and the codecs of bool (1), int/long (2), float/double (3), str (4),
bytes (5, what a schema definition is framed as) and ``Geoshape`` (9, the
values the traversal's geo predicates test), with the reference's type ids
and bytes.

Left out: every other datatype (dates, UUIDs, numpy scalars and arrays,
enums, dicts, pickles, ...). A cell that holds one still decodes:
``read_object`` returns an ``UnportedValue`` carrying its type id and its
raw payload, so a scan that does not ask for that value passes over it.
Writing one raises ``SerializerError``.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from janusgraph_tpu_torch.core.predicates import Geoshape
from janusgraph_tpu_torch.exceptions import JanusGraphTorchError


class SerializerError(JanusGraphTorchError):
    pass


@dataclass(frozen=True)
class UnportedValue:
    """A framed value of a datatype the port does not decode."""

    type_id: int
    payload: bytes


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


class Serializer:
    """The registry: type-id <-> serializer <-> python type.

    Values are framed as [type_id:2 BE][payload] so heterogeneous cells are
    self-describing (reference: StandardSerializer writeObjectNotNull)."""

    def __init__(self):
        self._by_id: Dict[int, AttributeSerializer] = {}
        self._by_type: Dict[type, AttributeSerializer] = {}
        for cls in (
            BooleanSerializer,
            LongSerializer,
            DoubleSerializer,
            StringSerializer,
            BytesSerializer,
            GeoshapeSerializer,
        ):
            self.register(cls())

    def register(self, ser: AttributeSerializer) -> None:
        if ser.type_id in self._by_id:
            raise SerializerError(f"duplicate serializer id {ser.type_id}")
        self._by_id[ser.type_id] = ser
        self._by_type.setdefault(ser.py_type, ser)

    def serializer_for(self, value) -> AttributeSerializer:
        if (
            isinstance(value, int)
            and not isinstance(value, bool)
            and not (-(1 << 63) <= value < (1 << 63))
        ):
            raise SerializerError("integers beyond 64 bits are not ported")
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
            raise SerializerError(f"no serializer for type {getattr(py_type, '__name__', py_type)}")
        return ser

    # -- framed object encoding --------------------------------------------
    def write_object(self, value) -> bytes:
        ser = self.serializer_for(value)
        return struct.pack(">H", ser.type_id) + ser.write(value)

    def read_object(self, data: bytes) -> Tuple[Any, int]:
        """Decode a framed value; returns (value, bytes_consumed). Only
        fixed-width payloads can be length-inferred mid-stream; variable-width
        payloads (and every unported type) must be the tail of `data`."""
        (tid,) = struct.unpack(">H", data[:2])
        ser = self._by_id.get(tid)
        if ser is None:
            return UnportedValue(tid, bytes(data[2:])), len(data)
        if ser.fixed_width is not None:
            end = 2 + ser.fixed_width
            return ser.read(data[2:end]), end
        return ser.read(data[2:]), len(data)

    # -- order-preserving encoding (sort keys / index keys) ----------------
    def write_ordered(self, value) -> bytes:
        ser = self.serializer_for(value)
        return ser.write_ordered(value)
