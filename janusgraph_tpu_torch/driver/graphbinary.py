"""GraphBinary-style compact binary serialization — the port's copy of
``janusgraph_tpu/driver/graphbinary.py``; both packages write the same
bytes for the same value.

Capability parity with the reference's GraphBinary module
(reference: janusgraph-driver .../io/binary/JanusGraphTypeSerializer.java:94 +
TP3 GraphBinary: type-code-prefixed, length-framed binary values). Same
shape here: one type-code byte, then a fixed or length-prefixed payload;
containers nest; elements serialize to their identity + label + properties.

Codes: 0x01 int64 | 0x02 double | 0x03 utf8 string | 0x04 bool | 0x05 null
       0x06 direction
       0x10 list | 0x11 map | 0x12 set
       0x20 vertex | 0x21 edge | 0x22 relation-identifier | 0x23 bytes
       0x30-0x36 framework datatypes | 0x37 geoshape
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

from janusgraph_tpu_torch.driver.relation_identifier import RelationIdentifier

_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")
_U32 = struct.Struct(">I")


def _w_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _U32.pack(len(b)) + b




def _encode(obj: Any, out: bytearray) -> None:
    from janusgraph_tpu_torch.core.codecs import Direction
    from janusgraph_tpu_torch.core.elements import Edge, Vertex

    if obj is None:
        out.append(0x05)
    elif isinstance(obj, bool):
        out.append(0x04)
        out.append(1 if obj else 0)
    elif isinstance(obj, Direction):
        # before the int branch: Direction is an IntEnum (elementMap
        # endpoint keys must round-trip typed, like GraphSON g:Direction)
        out.append(0x06)
        out.append(int(obj))
    elif isinstance(obj, int):
        out.append(0x01)
        out += _I64.pack(obj)
    elif isinstance(obj, float):
        out.append(0x02)
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        from janusgraph_tpu_torch.core.attributes import Char

        if isinstance(obj, Char):  # str subclass — must stay typed
            out.append(0x31)
            out += _w_str(str(obj))
        else:
            out.append(0x03)
            out += _w_str(obj)
    elif isinstance(obj, bytes):
        out.append(0x23)
        out += _U32.pack(len(obj)) + obj
    elif isinstance(obj, RelationIdentifier):
        out.append(0x22)
        out += _I64.pack(obj.relation_id) + _I64.pack(obj.out_vertex_id)
        out += _I64.pack(obj.type_id) + _I64.pack(obj.in_vertex_id)
    elif isinstance(obj, Vertex):
        out.append(0x20)
        out += _I64.pack(obj.id)
        out += _w_str(obj.label)
        props = [(p.key, p.value) for p in obj.properties()]
        out += _U32.pack(len(props))
        for k, v in props:
            out += _w_str(k)
            _encode(v, out)
    elif isinstance(obj, Edge):
        out.append(0x21)
        rid = obj.identifier
        out += _I64.pack(rid.relation_id) + _I64.pack(rid.out_vertex_id)
        out += _I64.pack(rid.type_id) + _I64.pack(rid.in_vertex_id)
        out += _w_str(obj.label)
        props = list(obj.property_values().items())
        out += _U32.pack(len(props))
        for k, v in props:
            out += _w_str(k)
            _encode(v, out)
    elif isinstance(obj, dict):
        out.append(0x11)
        out += _U32.pack(len(obj))
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(0x10)
        out += _U32.pack(len(obj))
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, set):
        out.append(0x12)
        out += _U32.pack(len(obj))
        for v in obj:
            _encode(v, out)
    else:
        if _encode_typed(obj, out):
            return
        try:
            import numpy as np

            if isinstance(obj, np.integer):
                return _encode(int(obj), out)
            if isinstance(obj, np.floating):
                return _encode(float(obj), out)
            if isinstance(obj, np.ndarray) and obj.dtype.kind in "biuf":
                out.append(0x36)
                out += _w_str(str(obj.dtype))
                out.append(obj.ndim)
                for d in obj.shape:
                    out += _U32.pack(d)
                raw = np.ascontiguousarray(obj).tobytes()
                out += _U32.pack(len(raw)) + raw
                return
        except ImportError:  # pragma: no cover
            pass
        _encode(str(obj), out)


def _encode_typed(obj: Any, out: bytearray) -> bool:
    """Framework + temporal datatypes (parity with the GraphSON module's
    typed registrations; reference: GraphBinary JanusGraphTypeSerializer)."""
    import datetime as _dt

    from janusgraph_tpu_torch.core.attributes import Char, Instant

    if isinstance(obj, Instant):
        out.append(0x30)
        out += _I64.pack(obj.seconds) + _U32.pack(obj.nanos)
        return True
    if isinstance(obj, Char):
        out.append(0x31)
        out += _w_str(str(obj))
        return True
    if isinstance(obj, _dt.timedelta):
        out.append(0x32)
        out += _I64.pack(obj.days) + _I64.pack(obj.seconds)
        out += _I64.pack(obj.microseconds)
        return True
    if isinstance(obj, _dt.datetime):
        out.append(0x33)
        out += _w_str(obj.isoformat())
        return True
    if isinstance(obj, _dt.date):
        out.append(0x34)
        out += _w_str(obj.isoformat())
        return True
    if isinstance(obj, _dt.time):
        out.append(0x35)
        out += _w_str(obj.isoformat())
        return True
    from janusgraph_tpu_torch.core.predicates import Geoshape

    if isinstance(obj, Geoshape):
        # reuse the storage codec: kind-tagged binary covering every shape
        # (reference: GraphBinary Geoshape serializer delegates the same way)
        from janusgraph_tpu_torch.core.attributes import GeoshapeSerializer

        raw = GeoshapeSerializer().write(obj)
        out.append(0x37)
        out += _U32.pack(len(raw)) + raw
        return True
    return False


class RemoteVertex:
    """Client-side detached vertex (reference: detached elements)."""

    def __init__(self, vid: int, label: str, properties: dict):
        self.id = vid
        self.label = label
        self.properties = properties

    def __repr__(self):
        return f"v[{self.id}]"


class RemoteEdge:
    def __init__(self, rid: RelationIdentifier, label: str, properties: dict):
        self.id = rid
        self.label = label
        self.properties = properties

    def __repr__(self):
        return f"e[{self.id}]"


def _r_str(data: bytes, pos: int) -> Tuple[str, int]:
    (n,) = _U32.unpack_from(data, pos)
    return data[pos + 4 : pos + 4 + n].decode("utf-8"), pos + 4 + n


def _decode(data: bytes, pos: int) -> Tuple[Any, int]:
    code = data[pos]
    pos += 1
    if code == 0x05:
        return None, pos
    if code == 0x04:
        return bool(data[pos]), pos + 1
    if code == 0x01:
        return _I64.unpack_from(data, pos)[0], pos + 8
    if code == 0x06:
        from janusgraph_tpu_torch.core.codecs import Direction

        return Direction(data[pos]), pos + 1
    if code == 0x02:
        return _F64.unpack_from(data, pos)[0], pos + 8
    if code == 0x03:
        return _r_str(data, pos)
    if code == 0x23:
        (n,) = _U32.unpack_from(data, pos)
        return data[pos + 4 : pos + 4 + n], pos + 4 + n
    if code == 0x22:
        vals = struct.unpack_from(">qqqq", data, pos)
        return RelationIdentifier(*vals), pos + 32
    if code == 0x30:
        from janusgraph_tpu_torch.core.attributes import Instant

        (sec,) = _I64.unpack_from(data, pos)
        (nanos,) = _U32.unpack_from(data, pos + 8)
        return Instant(sec, nanos), pos + 12
    if code == 0x31:
        from janusgraph_tpu_torch.core.attributes import Char

        s, pos = _r_str(data, pos)
        return Char(s), pos
    if code == 0x32:
        import datetime as _dt

        d, s, us = struct.unpack_from(">qqq", data, pos)
        return _dt.timedelta(days=d, seconds=s, microseconds=us), pos + 24
    if code == 0x33:
        import datetime as _dt

        s, pos = _r_str(data, pos)
        return _dt.datetime.fromisoformat(s), pos
    if code == 0x34:
        import datetime as _dt

        s, pos = _r_str(data, pos)
        return _dt.date.fromisoformat(s), pos
    if code == 0x35:
        import datetime as _dt

        s, pos = _r_str(data, pos)
        return _dt.time.fromisoformat(s), pos
    if code == 0x36:
        import numpy as np

        dtype, pos = _r_str(data, pos)
        ndim = data[pos]
        pos += 1
        shape = []
        for _ in range(ndim):
            (d,) = _U32.unpack_from(data, pos)
            shape.append(d)
            pos += 4
        (n,) = _U32.unpack_from(data, pos)
        pos += 4
        arr = np.frombuffer(data[pos : pos + n], dtype=dtype).reshape(shape)
        return arr.copy(), pos + n
    if code == 0x37:
        from janusgraph_tpu_torch.core.attributes import GeoshapeSerializer

        (n,) = _U32.unpack_from(data, pos)
        pos += 4
        return GeoshapeSerializer().read(data[pos : pos + n]), pos + n
    if code == 0x20:
        (vid,) = _I64.unpack_from(data, pos)
        pos += 8
        label, pos = _r_str(data, pos)
        (np_,) = _U32.unpack_from(data, pos)
        pos += 4
        props: dict = {}
        for _ in range(np_):
            k, pos = _r_str(data, pos)
            v, pos = _decode(data, pos)
            props.setdefault(k, []).append(v)
        return RemoteVertex(vid, label, props), pos
    if code == 0x21:
        vals = struct.unpack_from(">qqqq", data, pos)
        pos += 32
        label, pos = _r_str(data, pos)
        (np_,) = _U32.unpack_from(data, pos)
        pos += 4
        props = {}
        for _ in range(np_):
            k, pos = _r_str(data, pos)
            v, pos = _decode(data, pos)
            props[k] = v
        return RemoteEdge(RelationIdentifier(*vals), label, props), pos
    if code in (0x10, 0x12):
        (n,) = _U32.unpack_from(data, pos)
        pos += 4
        items = []
        for _ in range(n):
            v, pos = _decode(data, pos)
            items.append(v)
        return (set(items) if code == 0x12 else items), pos
    if code == 0x11:
        (n,) = _U32.unpack_from(data, pos)
        pos += 4
        out = {}
        for _ in range(n):
            k, pos = _decode(data, pos)
            v, pos = _decode(data, pos)
            out[k] = v
        return out, pos
    raise ValueError(f"unknown graphbinary type code 0x{code:02x}")


def binary_dumps(obj: Any) -> bytes:
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def binary_loads(data: bytes) -> Any:
    val, _pos = _decode(data, 0)
    return val
