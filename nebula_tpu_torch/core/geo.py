"""Geography value type + spatial predicates.

A copy of `nebula_tpu/core/geo.py`.  NebulaGraph's GEOGRAPHY type wraps
S2 geometry with WKT input/output (src/common/datatypes/Geography,
src/common/geo).  This implementation
keeps the same surface — WKT POINT/LINESTRING/POLYGON values, the ST_*
function family, spherical distance — with documented simplifications:
great-circle math is haversine on a spherical Earth (S2 uses an
ellipsoid-free sphere too), and polygon containment is planar ray
casting on lng/lat (exact for the small-extent regions queries use;
S2's geodesic edges diverge only over continental-scale polygons).
"""
from __future__ import annotations

import math
import re
from typing import List, Optional, Tuple

EARTH_RADIUS_M = 6371010.0          # mean radius, matches S2's constant


class GeoError(Exception):
    pass


class Geography:
    """kind: 'point' | 'linestring' | 'polygon'.

    point:      coords = (lng, lat)
    linestring: coords = [(lng, lat), ...]
    polygon:    coords = [ring, ...]; ring = [(lng, lat), ...] closed
                (first == last), ring 0 is the shell, rest are holes.
    """
    __slots__ = ("kind", "coords")

    def __init__(self, kind: str, coords):
        self.kind = kind
        self.coords = coords

    # -- WKT ---------------------------------------------------------------

    def wkt(self) -> str:
        def pt(c):
            return f"{_fmt(c[0])} {_fmt(c[1])}"
        if self.kind == "point":
            return f"POINT({pt(self.coords)})"
        if self.kind == "linestring":
            return ("LINESTRING(" +
                    ", ".join(pt(c) for c in self.coords) + ")")
        rings = ", ".join(
            "(" + ", ".join(pt(c) for c in ring) + ")"
            for ring in self.coords)
        return f"POLYGON({rings})"

    def __repr__(self):
        return self.wkt()

    def __eq__(self, o):
        return (isinstance(o, Geography) and self.kind == o.kind
                and self.coords == o.coords)

    def __hash__(self):
        if self.kind == "point":
            return hash(("geo", self.kind, self.coords))
        if self.kind == "linestring":
            return hash(("geo", self.kind, tuple(self.coords)))
        return hash(("geo", self.kind,
                     tuple(tuple(r) for r in self.coords)))

    def __lt__(self, o):
        return self.wkt() < (o.wkt() if isinstance(o, Geography) else "")

    # -- derived -----------------------------------------------------------

    def points(self) -> List[Tuple[float, float]]:
        if self.kind == "point":
            return [self.coords]
        if self.kind == "linestring":
            return list(self.coords)
        return [c for ring in self.coords for c in ring]

    def centroid(self) -> "Geography":
        pts = self.points()
        if self.kind == "polygon":
            pts = self.coords[0][:-1]   # shell without the closing repeat
        lng = sum(p[0] for p in pts) / len(pts)
        lat = sum(p[1] for p in pts) / len(pts)
        return Geography("point", (lng, lat))

    def is_valid(self) -> bool:
        try:
            for (lng, lat) in self.points():
                if not (-180.0 <= lng <= 180.0 and -90.0 <= lat <= 90.0):
                    return False
            if self.kind == "linestring" and len(self.coords) < 2:
                return False
            if self.kind == "polygon":
                for ring in self.coords:
                    if len(ring) < 4 or ring[0] != ring[-1]:
                        return False
            return True
        except (TypeError, IndexError):
            return False


def _fmt(x: float) -> str:
    return repr(int(x)) if float(x).is_integer() else repr(float(x))


_NUM = r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?"
_PT = re.compile(rf"\s*({_NUM})\s+({_NUM})\s*")


def _parse_pts(body: str) -> List[Tuple[float, float]]:
    pts = []
    for part in body.split(","):
        m = _PT.fullmatch(part)
        if m is None:
            raise GeoError(f"bad coordinate {part!r}")
        pts.append((float(m.group(1)), float(m.group(2))))
    return pts


def from_wkt(text: str) -> Geography:
    s = text.strip()
    up = s.upper()
    if "(" not in s or ")" not in s:
        raise GeoError(f"malformed WKT {text[:24]!r}")
    if up.startswith("POINT"):
        body = s[s.index("(") + 1:s.rindex(")")]
        pts = _parse_pts(body)
        if len(pts) != 1:
            raise GeoError("POINT takes one coordinate")
        return Geography("point", pts[0])
    if up.startswith("LINESTRING"):
        body = s[s.index("(") + 1:s.rindex(")")]
        pts = _parse_pts(body)
        if len(pts) < 2:
            raise GeoError("LINESTRING needs >= 2 points")
        return Geography("linestring", pts)
    if up.startswith("POLYGON"):
        body = s[s.index("(") + 1:s.rindex(")")]
        rings = []
        for rm in re.finditer(r"\(([^()]*)\)", body):
            ring = _parse_pts(rm.group(1))
            if len(ring) >= 3 and ring[0] != ring[-1]:
                ring.append(ring[0])
            if len(ring) < 4:
                raise GeoError("POLYGON ring needs >= 3 distinct points")
            rings.append(ring)
        if not rings:
            raise GeoError("POLYGON needs a shell ring")
        return Geography("polygon", rings)
    raise GeoError(f"unsupported WKT {text[:24]!r}")


# -- spherical math ---------------------------------------------------------


def _haversine_m(a: Tuple[float, float], b: Tuple[float, float]) -> float:
    lng1, lat1, lng2, lat2 = map(math.radians,
                                 (a[0], a[1], b[0], b[1]))
    dlat, dlng = lat2 - lat1, lng2 - lng1
    h = (math.sin(dlat / 2) ** 2
         + math.cos(lat1) * math.cos(lat2) * math.sin(dlng / 2) ** 2)
    return 2 * EARTH_RADIUS_M * math.asin(min(1.0, math.sqrt(h)))


def _pt_seg_m(p, a, b, samples: int = 32) -> float:
    """Distance point→segment: haversine against sampled points of the
    segment (documented approximation of the geodesic cross-track)."""
    best = min(_haversine_m(p, a), _haversine_m(p, b))
    for i in range(1, samples):
        t = i / samples
        q = (a[0] + (b[0] - a[0]) * t, a[1] + (b[1] - a[1]) * t)
        d = _haversine_m(p, q)
        if d < best:
            best = d
    return best


def _segments(g: Geography):
    if g.kind == "linestring":
        yield from zip(g.coords, g.coords[1:])
    elif g.kind == "polygon":
        for ring in g.coords:
            yield from zip(ring, ring[1:])


def _pt_in_polygon(p: Tuple[float, float], g: Geography) -> bool:
    """Planar even-odd ray cast over (lng, lat); holes handled by parity."""
    x, y = p
    inside = False
    for ring in g.coords:
        for (x1, y1), (x2, y2) in zip(ring, ring[1:]):
            if (y1 > y) != (y2 > y):
                xi = x1 + (y - y1) * (x2 - x1) / (y2 - y1)
                if x < xi:
                    inside = not inside
    return inside


def _seg_intersect(a, b, c, d) -> bool:
    def ccw(p, q, r):
        return (r[1] - p[1]) * (q[0] - p[0]) > (q[1] - p[1]) * (r[0] - p[0])
    return (ccw(a, c, d) != ccw(b, c, d)) and (ccw(a, b, c) != ccw(a, b, d))


def distance_m(a: Geography, b: Geography) -> float:
    if a.kind != "point" and b.kind == "point":
        return distance_m(b, a)
    if a.kind == "point" and b.kind == "point":
        return _haversine_m(a.coords, b.coords)
    if a.kind == "point":
        if b.kind == "polygon" and _pt_in_polygon(a.coords, b):
            return 0.0
        return min(_pt_seg_m(a.coords, s, e) for (s, e) in _segments(b))
    if intersects(a, b):
        return 0.0
    return min(_pt_seg_m(p, s, e)
               for p in a.points() for (s, e) in _segments(b))


def intersects(a: Geography, b: Geography) -> bool:
    if a.kind == "point" and b.kind == "point":
        return a.coords == b.coords
    if a.kind == "point":
        if b.kind == "polygon":
            return _pt_in_polygon(a.coords, b)
        return any(_pt_seg_m(a.coords, s, e) < 0.5
                   for (s, e) in _segments(b))
    if b.kind == "point":
        return intersects(b, a)
    for (s1, e1) in _segments(a):
        for (s2, e2) in _segments(b):
            if _seg_intersect(s1, e1, s2, e2):
                return True
    if a.kind == "polygon" and any(_pt_in_polygon(p, a)
                                   for p in b.points()):
        return True
    if b.kind == "polygon" and any(_pt_in_polygon(p, b)
                                   for p in a.points()):
        return True
    return False


def covers(a: Geography, b: Geography) -> bool:
    """a covers b: every point of b lies within a."""
    if a.kind == "point":
        return b.kind == "point" and a.coords == b.coords
    if a.kind == "linestring":
        return (b.kind == "point"
                and any(_pt_seg_m(b.coords, s, e) < 0.5
                        for (s, e) in _segments(a)))
    # a is polygon: all of b's points inside, no boundary crossing.
    # Segments that merely SHARE an endpoint (adjacent ring segments,
    # b's boundary touching a's) are not crossings — without the skip,
    # covers(g, g) would be false for every polygon.
    if not all(_pt_in_polygon(p, a) or _on_boundary(p, a)
               for p in b.points()):
        return False
    if b.kind != "point":
        for (s1, e1) in _segments(b):
            for (s2, e2) in _segments(a):
                if s1 in (s2, e2) or e1 in (s2, e2):
                    continue
                if _seg_intersect(s1, e1, s2, e2):
                    return False
    return True


def _on_boundary(p, g: Geography, eps_m: float = 0.5) -> bool:
    return any(_pt_seg_m(p, s, e) < eps_m for (s, e) in _segments(g))


def _interleave31(x: int, y: int) -> int:
    out = 0
    for i in range(31):
        out |= ((x >> i) & 1) << (2 * i)
        out |= ((y >> i) & 1) << (2 * i + 1)
    return out


# meters per degree of great-circle arc, derived from the SAME radius
# distance_m uses — the old hardcoded 111320 (WGS84 equatorial
# circumference / 360) exceeds it by ~0.11%, so the padded bbox
# under-covered and ST_DWithin points near the boundary got cell tokens
# OUTSIDE covering_ranges (ADVICE high: 44 misses in a 3000-trial
# fuzz); the residual filter can't recover rows the cover never
# surfaces.  A small safety factor over-covers instead — extra cells
# only cost re-checks of the exact predicate.
_M_PER_DEG = math.radians(1.0) * EARTH_RADIUS_M
_PAD_SAFETY = 1.005


def _pad_boxes(g: Geography, pad_m: float) -> List[Tuple[float, float,
                                                         float, float]]:
    """(lng_lo, lng_hi, lat_lo, lat_hi) boxes covering `g`'s bbox padded
    by pad_m meters — split in two when the pad crosses the antimeridian,
    widened to the full longitude band when it crosses a pole or the
    longitude pad degenerates near one (cos→0)."""
    pts = g.points()
    lngs = [p[0] for p in pts]
    lats = [p[1] for p in pts]
    pad_m = pad_m * _PAD_SAFETY if pad_m else 0.0
    dlat = pad_m / _M_PER_DEG if pad_m else 0.0
    lat_lo_raw, lat_hi_raw = min(lats) - dlat, max(lats) + dlat
    lat_lo, lat_hi = max(-90.0, lat_lo_raw), min(90.0, lat_hi_raw)
    dlng = 0.0
    full_lng = lat_hi_raw > 90.0 or lat_lo_raw < -90.0
    if pad_m and not full_lng:
        max_abs_lat = min(89.999, max(abs(lat_lo), abs(lat_hi)))
        dlng = pad_m / (_M_PER_DEG * math.cos(math.radians(max_abs_lat)))
        if dlng >= 180.0:
            full_lng = True
    lng_lo_raw, lng_hi_raw = min(lngs) - dlng, max(lngs) + dlng
    if full_lng or lng_hi_raw - lng_lo_raw >= 360.0:
        return [(-180.0, 180.0, lat_lo, lat_hi)]
    if lng_lo_raw < -180.0:
        return [(-180.0, lng_hi_raw, lat_lo, lat_hi),
                (lng_lo_raw + 360.0, 180.0, lat_lo, lat_hi)]
    if lng_hi_raw > 180.0:
        return [(lng_lo_raw, 180.0, lat_lo, lat_hi),
                (-180.0, lng_hi_raw - 360.0, lat_lo, lat_hi)]
    return [(lng_lo_raw, lng_hi_raw, lat_lo, lat_hi)]


def covering_cells(g: Geography, pad_m: float = 0.0,
                   max_cells: int = 64) -> List[Tuple[int, int]]:
    """Level-aligned Morton cells covering `g`'s (padded) bounding box —
    the S2RegionCoverer analog (NebulaGraph's storage geo index cover
    computation).

    Works in the same quantized lng/lat space as cell_token(): a level-L
    cell fixes the top L bits of both 31-bit axes, so each cell is one
    contiguous token interval [base, base + 4^(31-L)).  The level is
    coarsened until the boxes need <= max_cells cells; the cover is a
    bbox superset of the region, so consumers must re-check the exact
    predicate.  Returns [(base_token, level)].
    """
    boxes = _pad_boxes(g, pad_m)
    q = (1 << 31) - 1

    def qbox(b):
        lng_lo, lng_hi, lat_lo, lat_hi = b
        return (int((lng_lo + 180.0) / 360.0 * q),
                int((lng_hi + 180.0) / 360.0 * q),
                int((lat_lo + 90.0) / 180.0 * q),
                int((lat_hi + 90.0) / 180.0 * q))

    qboxes = [qbox(b) for b in boxes]
    level = 30
    while level > 0:
        shift = 31 - level
        n = sum(((xh >> shift) - (xl >> shift) + 1)
                * ((yh >> shift) - (yl >> shift) + 1)
                for xl, xh, yl, yh in qboxes)
        if n <= max_cells:
            break
        level -= 1
    shift = 31 - level
    cells = set()
    for xl, xh, yl, yh in qboxes:
        for cx in range((xl >> shift), (xh >> shift) + 1):
            for cy in range((yl >> shift), (yh >> shift) + 1):
                cells.add(_interleave31(cx << shift, cy << shift))
    return sorted((base, level) for base in cells)


def cell_width(level: int) -> int:
    """Token-interval width of one level-`level` cell."""
    return 1 << (2 * (31 - level))


def covering_ranges(g: Geography, pad_m: float = 0.0,
                    max_cells: int = 64) -> List[Tuple[int, int]]:
    """covering_cells flattened to sorted, merged, INCLUSIVE (lo, hi)
    token ranges — the query-side shape the geo index scans."""
    ranges = sorted((base, base + cell_width(level) - 1)
                    for base, level in covering_cells(g, pad_m, max_cells))
    merged = [list(ranges[0])]
    for lo, hi in ranges[1:]:
        if lo <= merged[-1][1] + 1:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def cell_token(g: Geography, level: int = 30) -> int:
    """64-bit Morton cell id of a point (lng/lat quantization) — the
    S2_CellIdFromPoint analog: equal points share ids and nearby points
    share prefixes.  NOT bit-identical to real S2 ids (no cube-face
    projection); documented as the locality-token surface."""
    if g.kind != "point":
        g = g.centroid()
    lng, lat = g.coords
    qx = int((lng + 180.0) / 360.0 * ((1 << 31) - 1))
    qy = int((lat + 90.0) / 180.0 * ((1 << 31) - 1))
    out = 0
    for i in range(31):
        out |= ((qx >> i) & 1) << (2 * i)
        out |= ((qy >> i) & 1) << (2 * i + 1)
    keep = 2 * min(level, 30)
    if keep < 62:
        out &= ~((1 << (62 - keep)) - 1)
    return out
