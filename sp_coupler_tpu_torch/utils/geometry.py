"""Host-side geometry: great-circle distance and region selection.

Copy of ``sp_coupler_tpu/utils/geometry.py``: self-contained numpy
stand-ins for the reference's haversine module and shapely (sputils.py
:37-72, spmaster.py:39-66). Runs once at initialization on the host.
"""

import json
import math

import numpy as np

EARTH_RADIUS_KM = 6371.0


def haversine(p1, p2):
    """Great-circle distance in km between (lon, lat) points in degrees.

    Argument order (lon, lat) matches the reference (haversine.py:7-12).
    """
    lon1, lat1 = p1
    lon2, lat2 = p2
    phi1, phi2 = math.radians(lat1), math.radians(lat2)
    dphi = phi2 - phi1
    dlmb = math.radians(lon2 - lon1)
    a = (math.sin(dphi / 2.0) ** 2
         + math.cos(phi1) * math.cos(phi2) * math.sin(dlmb / 2.0) ** 2)
    return 2.0 * EARTH_RADIUS_KM * math.asin(min(1.0, math.sqrt(a)))


def haversine_many(points, target):
    """Vectorized distances (km) from an array of (lon, lat) to one target."""
    pts = np.asarray(points, dtype=np.float64)
    lon, lat = np.radians(pts[:, 0]), np.radians(pts[:, 1])
    tlon, tlat = math.radians(target[0]), math.radians(target[1])
    a = (np.sin((lat - tlat) / 2.0) ** 2
         + np.cos(lat) * math.cos(tlat) * np.sin((lon - tlon) / 2.0) ** 2)
    return 2.0 * EARTH_RADIUS_KM * np.arcsin(np.minimum(1.0, np.sqrt(a)))


def find_closest_points(points, target):
    """Indices of (lon, lat) points sorted by distance to target
    (sputils.py:40-42)."""
    return np.argsort(haversine_many(points, target))


class Point:
    """Minimal shapely.geometry.Point stand-in."""

    def __init__(self, xy):
        if isinstance(xy, Point):
            self.x, self.y = xy.x, xy.y
        else:
            self.x, self.y = float(xy[0]), float(xy[1])

    def contains(self, other):
        return False


class Polygon:
    """Minimal polygon with ray-casting containment (shapely stand-in)."""

    def __init__(self, coords):
        self.coords = [(float(x), float(y)) for x, y in coords]

    def contains(self, p):
        x, y = (p.x, p.y) if isinstance(p, Point) else (p[0], p[1])
        inside = False
        n = len(self.coords)
        for i in range(n):
            x1, y1 = self.coords[i]
            x2, y2 = self.coords[(i + 1) % n]
            if (y1 > y) != (y2 > y):
                xin = (x2 - x1) * (y - y1) / (y2 - y1) + x1
                if x < xin:
                    inside = not inside
        return inside


class Box(Polygon):
    """Axis-aligned box; infinite extents mean "everything" (spmaster.py:249)."""

    def __init__(self, minx, miny, maxx, maxy):
        self.minx, self.miny, self.maxx, self.maxy = minx, miny, maxx, maxy
        super().__init__([(minx, miny), (maxx, miny), (maxx, maxy), (minx, maxy)])

    def contains(self, p):
        x, y = (p.x, p.y) if isinstance(p, Point) else (p[0], p[1])
        return self.minx <= x <= self.maxx and self.miny <= y <= self.maxy


def nearest(pts, lat, target):
    """int(np.argmin(haversine_many(pts, target))) measured over fewer
    points: pts is the [n, 2] (lon, lat) array, lat its latitudes in
    radians. A point's distance is at least R |lat - lat_target|, so no
    point further in latitude than the nearest distance among the points
    of the closest latitude can be nearer (1 mm covers the rounding). The
    candidates keep their order: a tie goes to the first, as in argmin."""
    dlat = np.abs(lat - math.radians(target[1]))
    best = haversine_many(pts[dlat == dlat.min()], target).min()
    near = np.flatnonzero(EARTH_RADIUS_KM * dlat <= best + 1e-6)
    return int(near[np.argmin(haversine_many(pts[near], target))])


def get_mask_indices(points, mask_geoms, nmax=-1):
    """Grid-column indices selected by the mask geometries.

    Mirrors sputils.get_mask_indices (sputils.py:46-72):
    - a single Point geometry selects the nmax haversine-closest columns
      (or just the closest when nmax <= 0);
    - otherwise each Point contributes its nearest column and each polygon
      contributes every contained column, testing the grid longitude both in
      [0, 360) and mapped to [-180, 180).
    """
    if nmax == 0:
        return []
    if len(mask_geoms) == 1 and isinstance(mask_geoms[0], Point):
        g = mask_geoms[0]
        order = find_closest_points(points, (g.x, g.y))
        return list(order[:nmax]) if nmax > 0 else [int(order[0])]
    result = []
    pts = lat = None
    for g in mask_geoms:
        if isinstance(g, Point):
            if pts is None:          # once, not once a Point
                pts = np.asarray(points, dtype=np.float64)
                lat = np.radians(pts[:, 1])
            result.append(nearest(pts, lat, (g.x, g.y)))
        else:
            for i, p in enumerate(points):
                if g.contains(Point(p)):
                    result.append(i)
                q = ((p[0] - 180.0) % 360.0 - 180.0, p[1])
                if g.contains(Point(q)):
                    result.append(i)
    return sorted(set(result))


def parse_lat_lons(coordinate_list):
    """CLI lat/lon pair list -> [(lon, lat), ...] with lon mapped to [0, 360).

    Mirrors spmaster.parse_lat_lons (spmaster.py:39-44), including dropping a
    trailing unpaired value.
    """
    n = len(coordinate_list)
    if n % 2:
        coordinate_list = coordinate_list[: n - 1]
    return [(float(coordinate_list[2 * i + 1]) % 360.0, float(coordinate_list[2 * i]))
            for i in range(len(coordinate_list) // 2)]


def read_poly_file(polyfile):
    """First polygon from a geoJSON file (spmaster.py:55-66)."""
    with open(polyfile) as f:
        js = json.load(f)
    for feature in js["features"]:
        geom = feature["geometry"]
        if geom["type"] == "Polygon":
            return Polygon(geom["coordinates"][0])
        if geom["type"] == "Point":
            return Point(geom["coordinates"])
    raise ValueError("no polygon found in %s" % polyfile)
