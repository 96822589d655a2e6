"""Predicate vocabulary of the query engine — the port's copy of
``janusgraph_tpu/core/predicates.py``.

Capability parity with the reference's attribute predicates
(reference: janusgraph-driver/.../core/attribute/Cmp.java:224 — EQUAL..GREATER_THAN_EQUAL;
attribute/Text.java:342 — textContains/Prefix/Regex/Fuzzy and full-string
variants; attribute/Geo.java:171 — INTERSECT/DISJOINT/WITHIN/CONTAINS;
attribute/Geoshape.java:623 — point/circle/box/polygon with WKT and GeoJSON
codecs). Predicates are plain singletons with a pure
``evaluate(value, condition)``: the traversal's ``has()`` filters and the
OLAP traversal's filter masks (which vectorize ``Cmp`` over numeric
property columns through ``_fn``) use the same objects.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

_TOKEN_RE = re.compile(r"[\w\d]+", re.UNICODE)


def tokenize(text: str) -> List[str]:
    """Lowercase word tokenization (reference: Text.java tokenize — splits on
    non-alphanumerics, drops empties)."""
    return [t.lower() for t in _TOKEN_RE.findall(text)]


def fuzzy_distance(term: str) -> int:
    """Edit-distance budget by term length (reference: Text.java
    getMaxEditDistance — Elasticsearch AUTO fuzziness)."""
    if len(term) < 3:
        return 0
    if len(term) < 6:
        return 1
    return 2


def levenshtein(a: str, b: str, cap: int = 2) -> int:
    """Banded edit distance, capped (only distances <= cap matter)."""
    if abs(len(a) - len(b)) > cap:
        return cap + 1
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        best = i
        for j, cb in enumerate(b, 1):
            cost = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
            cur.append(cost)
            best = min(best, cost)
        if best > cap:
            return cap + 1
        prev = cur
    return prev[-1]


class Predicate:
    """A binary predicate value `test(stored_value, condition_value)`."""

    name: str = "predicate"

    def evaluate(self, value, condition) -> bool:
        raise NotImplementedError

    def is_valid_condition(self, condition) -> bool:
        return True

    def __repr__(self):
        return self.name


# --------------------------------------------------------------------- Cmp


class _CmpPredicate(Predicate):
    def __init__(self, name, fn, needs_order=True):
        self.name = name
        self._fn = fn
        self.needs_order = needs_order

    def evaluate(self, value, condition) -> bool:
        if value is None:
            return self.name == "neq" and condition is not None
        try:
            return self._fn(value, condition)
        except TypeError:
            return self.name == "neq"


class Cmp:
    """reference: attribute/Cmp.java:224."""

    EQUAL = _CmpPredicate("eq", lambda v, c: v == c, needs_order=False)
    NOT_EQUAL = _CmpPredicate("neq", lambda v, c: v != c, needs_order=False)
    LESS_THAN = _CmpPredicate("lt", lambda v, c: v < c)
    LESS_THAN_EQUAL = _CmpPredicate("lte", lambda v, c: v <= c)
    GREATER_THAN = _CmpPredicate("gt", lambda v, c: v > c)
    GREATER_THAN_EQUAL = _CmpPredicate("gte", lambda v, c: v >= c)


# -------------------------------------------------------------------- Text


class _TextPredicate(Predicate):
    def __init__(self, name, fn):
        self.name = name
        self._fn = fn

    def evaluate(self, value, condition) -> bool:
        if not isinstance(value, str) or condition is None:
            return False
        return self._fn(value, str(condition))

    def is_valid_condition(self, condition) -> bool:
        return isinstance(condition, str) and bool(condition)


def _text_contains(value: str, terms: str) -> bool:
    toks = set(tokenize(value))
    want = tokenize(terms)
    return bool(want) and all(t in toks for t in want)


def _text_contains_prefix(value: str, prefix: str) -> bool:
    p = prefix.lower()
    return any(t.startswith(p) for t in tokenize(value))


def _text_contains_regex(value: str, pattern: str) -> bool:
    rx = re.compile(pattern)
    return any(rx.fullmatch(t) for t in tokenize(value))


def _text_contains_fuzzy(value: str, term: str) -> bool:
    t = term.lower()
    cap = fuzzy_distance(t)
    return any(levenshtein(tok, t, cap) <= cap for tok in tokenize(value))


def _text_contains_phrase(value: str, phrase: str) -> bool:
    toks = tokenize(value)
    want = tokenize(phrase)
    if not want:
        return False
    n = len(want)
    return any(toks[i : i + n] == want for i in range(len(toks) - n + 1))


class Text:
    """reference: attribute/Text.java:342 — CONTAINS* act on the tokenized
    text (TEXT mapping); PREFIX/REGEX/FUZZY act on the whole string (STRING
    mapping)."""

    CONTAINS = _TextPredicate("textContains", _text_contains)
    CONTAINS_PREFIX = _TextPredicate("textContainsPrefix", _text_contains_prefix)
    CONTAINS_REGEX = _TextPredicate("textContainsRegex", _text_contains_regex)
    CONTAINS_FUZZY = _TextPredicate("textContainsFuzzy", _text_contains_fuzzy)
    CONTAINS_PHRASE = _TextPredicate("textContainsPhrase", _text_contains_phrase)
    PREFIX = _TextPredicate("textPrefix", lambda v, c: v.startswith(c))
    REGEX = _TextPredicate("textRegex", lambda v, c: re.fullmatch(c, v) is not None)
    FUZZY = _TextPredicate(
        "textFuzzy",
        lambda v, c: levenshtein(v.lower(), c.lower(), fuzzy_distance(c))
        <= fuzzy_distance(c),
    )


# --------------------------------------------------------------------- Geo

_EARTH_RADIUS_KM = 6371.0


def haversine_km(lat1: float, lon1: float, lat2: float, lon2: float) -> float:
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lon2 - lon1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * _EARTH_RADIUS_KM * math.asin(math.sqrt(a))


@dataclass(frozen=True)
class Geoshape:
    """Geoshape vocabulary (reference: attribute/Geoshape.java:623 — point,
    circle, box, line, polygon, multipoint, multilinestring, multipolygon,
    geometrycollection).

    kind: "Point" | "Circle" | "Box" | "Polygon" | "Line" | "MultiPoint"
          | "MultiLineString" | "MultiPolygon" | "GeometryCollection"
    coords: Point -> [(lat, lon)]; Circle -> [(lat, lon)] + radius_km;
            Box -> [(sw_lat, sw_lon), (ne_lat, ne_lon)];
            Polygon -> ring vertices; Line/MultiPoint -> point list
    parts:  MultiLineString -> Line shapes; MultiPolygon -> Polygon/Box
            shapes; GeometryCollection -> any shapes
    """

    kind: str
    coords: Tuple[Tuple[float, float], ...]
    radius_km: float = 0.0
    parts: Tuple["Geoshape", ...] = ()

    #: kinds whose geometry lives in sub-shapes
    _PART_KINDS = ("MultiLineString", "MultiPolygon", "GeometryCollection")

    # ------------------------------------------------------------- factories
    @staticmethod
    def point(lat: float, lon: float) -> "Geoshape":
        # float coercion at every factory: a stored-and-reloaded shape must
        # be indistinguishable from the constructed one (the codec reads
        # back doubles)
        return Geoshape("Point", ((float(lat), float(lon)),))

    @staticmethod
    def circle(lat: float, lon: float, radius_km: float) -> "Geoshape":
        return Geoshape(
            "Circle", ((float(lat), float(lon)),), float(radius_km)
        )

    @staticmethod
    def box(sw_lat: float, sw_lon: float, ne_lat: float, ne_lon: float) -> "Geoshape":
        return Geoshape(
            "Box",
            ((float(sw_lat), float(sw_lon)), (float(ne_lat), float(ne_lon))),
        )

    @staticmethod
    def polygon(points: Sequence[Tuple[float, float]]) -> "Geoshape":
        """Axis-aligned 4-vertex rectangles normalize to Box AT
        CONSTRUCTION so every entry point (factories, WKT, GeoJSON, the
        binary codec, the driver wire formats) agrees on the kind — the
        reference's GeoJSON reader applies the same rectangle->box
        normalization, and doing it here keeps the codecs' round trips
        mutually consistent."""
        pts = tuple((float(a), float(b)) for a, b in points)
        if len(pts) < 3:
            raise ValueError("polygon needs at least 3 points")
        if len(pts) == 4:
            lats = sorted(p[0] for p in pts)
            lons = sorted(p[1] for p in pts)
            if set(pts) == {
                (lats[0], lons[0]), (lats[0], lons[-1]),
                (lats[-1], lons[0]), (lats[-1], lons[-1]),
            }:
                return Geoshape.box(lats[0], lons[0], lats[-1], lons[-1])
        return Geoshape("Polygon", pts)

    @staticmethod
    def line(points: Sequence[Tuple[float, float]]) -> "Geoshape":
        pts = tuple((float(a), float(b)) for a, b in points)
        if len(pts) < 2:
            raise ValueError("line needs at least 2 points")
        return Geoshape("Line", pts)

    @staticmethod
    def multipoint(points: Sequence[Tuple[float, float]]) -> "Geoshape":
        pts = tuple((float(a), float(b)) for a, b in points)
        if not pts:
            raise ValueError("multipoint needs at least 1 point")
        return Geoshape("MultiPoint", pts)

    @staticmethod
    def multilinestring(lines: Sequence) -> "Geoshape":
        parts = tuple(
            ln if isinstance(ln, Geoshape) else Geoshape.line(ln)
            for ln in lines
        )
        if not parts or any(p.kind != "Line" for p in parts):
            raise ValueError("multilinestring needs Line parts")
        return Geoshape("MultiLineString", (), parts=parts)

    @staticmethod
    def multipolygon(polygons: Sequence) -> "Geoshape":
        # raw rings normalize like every other ring entry point (axis-
        # aligned rectangles become Box), so codec round trips are stable
        parts = tuple(
            p if isinstance(p, Geoshape) else _ring_to_shape(list(p))
            for p in polygons
        )
        if not parts or any(p.kind not in ("Polygon", "Box") for p in parts):
            raise ValueError("multipolygon needs Polygon/Box parts")
        return Geoshape("MultiPolygon", (), parts=parts)

    @staticmethod
    def geometry_collection(shapes: Sequence["Geoshape"]) -> "Geoshape":
        parts = tuple(shapes)
        if not parts:
            raise ValueError("geometrycollection needs at least one shape")
        return Geoshape("GeometryCollection", (), parts=parts)

    # ------------------------------------------------------------- accessors
    @property
    def lat(self) -> float:
        return self.coords[0][0]

    @property
    def lon(self) -> float:
        return self.coords[0][1]

    def bbox(self) -> Tuple[float, float, float, float]:
        """(min_lat, min_lon, max_lat, max_lon) conservative bounding box."""
        if self.kind == "Circle":
            dlat = math.degrees(self.radius_km / _EARTH_RADIUS_KM)
            dlon = dlat / max(math.cos(math.radians(self.lat)), 1e-9)
            return (
                self.lat - dlat,
                self.lon - dlon,
                self.lat + dlat,
                self.lon + dlon,
            )
        if self.kind in Geoshape._PART_KINDS:
            boxes = [p.bbox() for p in self.parts]
            return (
                min(b[0] for b in boxes), min(b[1] for b in boxes),
                max(b[2] for b in boxes), max(b[3] for b in boxes),
            )
        lats = [c[0] for c in self.coords]
        lons = [c[1] for c in self.coords]
        return (min(lats), min(lons), max(lats), max(lons))

    def _probe_points(self) -> Tuple[Tuple[float, float], ...]:
        """Representative points for conservative intersection sampling."""
        if self.kind in Geoshape._PART_KINDS:
            return tuple(pt for p in self.parts for pt in p._probe_points())
        return self.coords

    # ------------------------------------------------------------ geometry
    def contains_point(self, lat: float, lon: float) -> bool:
        if self.kind == "Point":
            return math.isclose(lat, self.lat) and math.isclose(lon, self.lon)
        if self.kind == "Circle":
            return haversine_km(lat, lon, self.lat, self.lon) <= self.radius_km
        if self.kind == "Box":
            (slat, slon), (nlat, nlon) = self.coords
            return slat <= lat <= nlat and slon <= lon <= nlon
        if self.kind == "MultiPoint":
            return any(
                math.isclose(lat, la) and math.isclose(lon, lo)
                for la, lo in self.coords
            )
        if self.kind == "Line":
            # on-segment test (planar, small-distance tolerance)
            for (y1, x1), (y2, x2) in zip(self.coords, self.coords[1:]):
                cross = (x2 - x1) * (lat - y1) - (y2 - y1) * (lon - x1)
                if abs(cross) > 1e-9:
                    continue
                if (
                    min(x1, x2) - 1e-12 <= lon <= max(x1, x2) + 1e-12
                    and min(y1, y2) - 1e-12 <= lat <= max(y1, y2) + 1e-12
                ):
                    return True
            return False
        if self.kind in Geoshape._PART_KINDS:
            return any(p.contains_point(lat, lon) for p in self.parts)
        # ray casting on the (lat, lon) plane
        inside = False
        pts = self.coords
        j = len(pts) - 1
        for i in range(len(pts)):
            yi, xi = pts[i]
            yj, xj = pts[j]
            if (yi > lat) != (yj > lat) and lon < (xj - xi) * (lat - yi) / (
                yj - yi
            ) + xi:
                inside = not inside
            j = i
        return inside

    def intersects(self, other: "Geoshape") -> bool:
        # multi-shapes: any part intersecting is enough (both sides)
        if self.kind in Geoshape._PART_KINDS:
            return any(p.intersects(other) for p in self.parts)
        if other.kind in Geoshape._PART_KINDS:
            return any(self.intersects(p) for p in other.parts)
        if other.kind == "Point":
            return self.contains_point(other.lat, other.lon)
        if self.kind == "Point":
            return other.contains_point(self.lat, self.lon)
        if other.kind == "MultiPoint":
            return any(self.contains_point(la, lo) for la, lo in other.coords)
        if self.kind == "MultiPoint":
            return any(other.contains_point(la, lo) for la, lo in self.coords)
        if self.kind == "Circle" and other.kind == "Circle":
            return (
                haversine_km(self.lat, self.lon, other.lat, other.lon)
                <= self.radius_km + other.radius_km
            )
        # conservative bbox overlap + sampled containment for the rest
        a, b = self.bbox(), other.bbox()
        if a[0] > b[2] or b[0] > a[2] or a[1] > b[3] or b[1] > a[3]:
            return False
        probes = list(other._probe_points()) + [
            ((b[0] + b[2]) / 2, (b[1] + b[3]) / 2)
        ]
        if any(self.contains_point(la, lo) for la, lo in probes):
            return True
        probes = list(self._probe_points()) + [
            ((a[0] + a[2]) / 2, (a[1] + a[3]) / 2)
        ]
        return any(other.contains_point(la, lo) for la, lo in probes)

    def within(self, other: "Geoshape") -> bool:
        if self.kind == "Point":
            return other.contains_point(self.lat, self.lon)
        if self.kind in ("MultiPoint", "Line"):
            return all(other.contains_point(la, lo) for la, lo in self.coords)
        if self.kind in Geoshape._PART_KINDS:
            return all(p.within(other) for p in self.parts)
        a = self.bbox()
        corners = [(a[0], a[1]), (a[0], a[3]), (a[2], a[1]), (a[2], a[3])]
        return all(other.contains_point(la, lo) for la, lo in corners)

    # ---------------------------------------------------------------- codecs
    def to_geojson(self) -> str:
        """reference: Geoshape GeoJSON serializer (lon, lat axis order)."""
        return json.dumps(self._geom_dict(), sort_keys=True)

    def _geom_dict(self) -> dict:
        if self.kind == "Point":
            geom = {"type": "Point", "coordinates": [self.lon, self.lat]}
        elif self.kind == "Circle":
            geom = {
                "type": "Circle",
                "coordinates": [self.lon, self.lat],
                "radius": self.radius_km,
                "properties": {"radius_units": "km"},
            }
        elif self.kind == "Box":
            (slat, slon), (nlat, nlon) = self.coords
            geom = {
                "type": "Polygon",
                "coordinates": [
                    [[slon, slat], [nlon, slat], [nlon, nlat], [slon, nlat], [slon, slat]]
                ],
            }
        elif self.kind == "Line":
            geom = {
                "type": "LineString",
                "coordinates": [[lo, la] for la, lo in self.coords],
            }
        elif self.kind == "MultiPoint":
            geom = {
                "type": "MultiPoint",
                "coordinates": [[lo, la] for la, lo in self.coords],
            }
        elif self.kind == "MultiLineString":
            geom = {
                "type": "MultiLineString",
                "coordinates": [
                    [[lo, la] for la, lo in p.coords] for p in self.parts
                ],
            }
        elif self.kind == "MultiPolygon":
            geom = {
                "type": "MultiPolygon",
                "coordinates": [
                    [p._geom_dict()["coordinates"][0]] for p in self.parts
                ],
            }
        elif self.kind == "GeometryCollection":
            geom = {
                "type": "GeometryCollection",
                "geometries": [p._geom_dict() for p in self.parts],
            }
        else:
            ring = [[lo, la] for la, lo in self.coords]
            ring.append(ring[0])
            geom = {"type": "Polygon", "coordinates": [ring]}
        return geom

    @staticmethod
    def from_geojson(text: str) -> "Geoshape":
        g = json.loads(text) if isinstance(text, str) else text
        t = g["type"]
        if t == "Point":
            lon, lat = g["coordinates"]
            return Geoshape.point(lat, lon)
        if t == "Circle":
            lon, lat = g["coordinates"]
            return Geoshape.circle(lat, lon, g["radius"])
        if t == "Polygon":
            ring = [(la, lo) for lo, la in g["coordinates"][0][:-1]]
            return _ring_to_shape(ring)
        if t == "LineString":
            return Geoshape.line([(la, lo) for lo, la in g["coordinates"]])
        if t == "MultiPoint":
            return Geoshape.multipoint(
                [(la, lo) for lo, la in g["coordinates"]]
            )
        if t == "MultiLineString":
            return Geoshape.multilinestring(
                [[(la, lo) for lo, la in line] for line in g["coordinates"]]
            )
        if t == "MultiPolygon":
            return Geoshape.multipolygon(
                [
                    _ring_to_shape([(la, lo) for lo, la in poly[0][:-1]])
                    for poly in g["coordinates"]
                ]
            )
        if t == "GeometryCollection":
            return Geoshape.geometry_collection(
                [Geoshape.from_geojson(sub) for sub in g["geometries"]]
            )
        raise ValueError(f"unsupported GeoJSON type {t}")

    def to_wkt(self) -> str:
        """reference: Geoshape WKT serializer (x=lon y=lat)."""
        if self.kind == "Point":
            return f"POINT ({self.lon} {self.lat})"
        if self.kind == "Circle":
            return f"BUFFER (POINT ({self.lon} {self.lat}), {self.radius_km})"
        if self.kind == "Line":
            inner = ", ".join(f"{lo} {la}" for la, lo in self.coords)
            return f"LINESTRING ({inner})"
        if self.kind == "MultiPoint":
            inner = ", ".join(f"({lo} {la})" for la, lo in self.coords)
            return f"MULTIPOINT ({inner})"
        if self.kind == "MultiLineString":
            inner = ", ".join(
                "(" + ", ".join(f"{lo} {la}" for la, lo in p.coords) + ")"
                for p in self.parts
            )
            return f"MULTILINESTRING ({inner})"
        if self.kind == "MultiPolygon":
            inner = ", ".join(
                p.to_wkt()[len("POLYGON "):] for p in self.parts
            )
            return f"MULTIPOLYGON ({inner})"
        if self.kind == "GeometryCollection":
            inner = ", ".join(p.to_wkt() for p in self.parts)
            return f"GEOMETRYCOLLECTION ({inner})"
        if self.kind == "Box":
            (slat, slon), (nlat, nlon) = self.coords
            ring = [
                (slon, slat),
                (nlon, slat),
                (nlon, nlat),
                (slon, nlat),
                (slon, slat),
            ]
        else:
            ring = [(lo, la) for la, lo in self.coords]
            ring.append(ring[0])
        inner = ", ".join(f"{x} {y}" for x, y in ring)
        return f"POLYGON (({inner}))"

    @staticmethod
    def from_wkt(text: str) -> "Geoshape":
        t = text.strip()
        m = re.fullmatch(r"POINT\s*\(\s*(\S+)\s+(\S+)\s*\)", t, re.I)
        if m:
            return Geoshape.point(float(m.group(2)), float(m.group(1)))
        m = re.fullmatch(
            r"BUFFER\s*\(\s*POINT\s*\(\s*(\S+)\s+(\S+)\s*\)\s*,\s*(\S+)\s*\)", t, re.I
        )
        if m:
            return Geoshape.circle(
                float(m.group(2)), float(m.group(1)), float(m.group(3))
            )
        m = re.fullmatch(r"POLYGON\s*\(\(\s*(.*?)\s*\)\)", t, re.I)
        if m:
            return _ring_to_shape(_wkt_ring(m.group(1)))
        m = re.fullmatch(r"LINESTRING\s*\(\s*(.*?)\s*\)", t, re.I)
        if m:
            return Geoshape.line(_wkt_points(m.group(1)))
        m = re.fullmatch(r"MULTIPOINT\s*\(\s*(.*?)\s*\)", t, re.I)
        if m:
            pts = [
                _wkt_points(grp.strip().strip("()"))[0]
                for grp in _split_top_level(m.group(1))
            ]
            return Geoshape.multipoint(pts)
        m = re.fullmatch(r"MULTILINESTRING\s*\(\s*(.*?)\s*\)", t, re.I)
        if m:
            return Geoshape.multilinestring(
                [
                    _wkt_points(grp.strip()[1:-1])
                    for grp in _split_top_level(m.group(1))
                ]
            )
        m = re.fullmatch(r"MULTIPOLYGON\s*\(\s*(.*?)\s*\)", t, re.I)
        if m:
            polys = []
            for grp in _split_top_level(m.group(1)):
                ring_txt = grp.strip()
                # strip the two polygon parens: ((a b, c d, ...))
                ring_txt = ring_txt[1:-1].strip()[1:-1]
                polys.append(_ring_to_shape(_wkt_ring(ring_txt)))
            return Geoshape.multipolygon(polys)
        m = re.fullmatch(r"GEOMETRYCOLLECTION\s*\(\s*(.*?)\s*\)", t, re.I)
        if m:
            return Geoshape.geometry_collection(
                [
                    Geoshape.from_wkt(grp.strip())
                    for grp in _split_top_level(m.group(1))
                ]
            )
        raise ValueError(f"unsupported WKT {text!r}")


def _wkt_points(text: str):
    """'x y, x y, ...' -> [(lat, lon), ...] (WKT axis order is lon lat)."""
    pts = []
    for pair in text.split(","):
        x, y = pair.split()
        pts.append((float(y), float(x)))
    return pts


def _wkt_ring(text: str):
    pts = _wkt_points(text)
    if pts and pts[0] == pts[-1]:
        pts = pts[:-1]
    return pts


def _split_top_level(text: str):
    """Split on commas at paren depth 0 (WKT multi-geometry separators)."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(text):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(text[start:i])
            start = i + 1
    parts.append(text[start:])
    return [p for p in (s.strip() for s in parts) if p]


def _ring_to_shape(ring) -> "Geoshape":
    """Ring -> shape; the rectangle->box normalization now lives in
    Geoshape.polygon() itself (construction-time), so this is a plain
    alias kept for the codec call sites."""
    return Geoshape.polygon(ring)


class _GeoPredicate(Predicate):
    def __init__(self, name, fn):
        self.name = name
        self._fn = fn

    def evaluate(self, value, condition) -> bool:
        if not isinstance(value, Geoshape) or not isinstance(condition, Geoshape):
            return False
        return self._fn(value, condition)

    def is_valid_condition(self, condition) -> bool:
        return isinstance(condition, Geoshape)


class Geo:
    """reference: attribute/Geo.java:171."""

    INTERSECT = _GeoPredicate("geoIntersect", lambda v, c: v.intersects(c))
    DISJOINT = _GeoPredicate("geoDisjoint", lambda v, c: not v.intersects(c))
    WITHIN = _GeoPredicate("geoWithin", lambda v, c: v.within(c))
    CONTAINS = _GeoPredicate("geoContains", lambda v, c: c.within(v))


class _ContainPredicate(Predicate):
    def __init__(self, name, fn):
        self.name = name
        self._fn = fn

    def evaluate(self, value, condition) -> bool:
        if value is None:
            return False
        return self._fn(value, condition)

    def is_valid_condition(self, condition) -> bool:
        return isinstance(condition, (tuple, list, set, frozenset))


class Contain:
    """Membership predicates (reference: attribute/Contain.java — the
    Contain.IN/NOT_IN that back Gremlin's P.within/P.without): condition
    is a finite value collection."""

    IN = _ContainPredicate("within", lambda v, c: v in c)
    NOT_IN = _ContainPredicate("without", lambda v, c: v not in c)


_BY_NAME = {}
for _cls in (Cmp, Text, Geo, Contain):
    for _attr in vars(_cls).values():
        if isinstance(_attr, Predicate):
            _BY_NAME[_attr.name] = _attr


def predicate_by_name(name: str) -> Optional[Predicate]:
    return _BY_NAME.get(name)
