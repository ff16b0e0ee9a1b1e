"""Tile-map model and the reference's YAML map format.

Counterpart of the JAX package's ``sim/maps.py``, numpy only: the map
schema of the reference (``rightLaneDatagen/gym_duckietown/maps/*.yaml``:
a ``tiles`` grid of ``'<kind>/<orientation>'`` strings, ``tile_size``,
optional ``objects`` and ``start_tile``) and the builtin maps, which are
Python data, so the datagen path needs no map files.  PyYAML is imported
only by ``load_map``, which reads a map file.

Tile kinds: straight, curve_left, curve_right, 3way_left/right, 4way,
asphalt, grass, floor.  Orientations N/E/S/W rotate the tile texture and
its lane curves.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np

DRIVABLE_KINDS = {"straight", "curve_left", "curve_right",
                  "3way_left", "3way_right", "4way"}
ORIENTATIONS = ["N", "E", "S", "W"]


@dataclasses.dataclass
class Tile:
    kind: str
    orientation: str  # one of N/E/S/W ('N' = as-authored)
    drivable: bool


@dataclasses.dataclass
class MapObject:
    kind: str           # duckie, duckiebot, cone, barrier, ...
    pos: np.ndarray     # (x, z) in tile units
    rotate: float       # degrees
    height: float
    static: bool = True
    mesh: str | None = None  # optional OBJ path (else procedural geometry)


@dataclasses.dataclass
class Map:
    name: str
    tiles: list[list[Tile | None]]   # [row][col]
    tile_size: float
    objects: list[MapObject]
    start_tile: tuple[int, int] | None = None

    @property
    def grid_height(self) -> int:
        return len(self.tiles)

    @property
    def grid_width(self) -> int:
        return len(self.tiles[0]) if self.tiles else 0

    def drivable_tiles(self) -> list[tuple[int, int]]:
        out = []
        for j, row in enumerate(self.tiles):
            for i, t in enumerate(row):
                if t is not None and t.drivable:
                    out.append((i, j))
        return out

    def tile_at(self, i: int, j: int) -> Tile | None:
        if 0 <= j < self.grid_height and 0 <= i < self.grid_width:
            return self.tiles[j][i]
        return None


def _parse_tile(spec: str) -> Tile | None:
    spec = spec.strip()
    if spec in ("empty", "none", ""):
        return None
    if "/" in spec:
        kind, orient = spec.split("/")
        kind, orient = kind.strip(), orient.strip().upper()
    else:
        kind, orient = spec, "N"
    # reference maps use S/E/N/W suffixes after a slash
    if orient not in ORIENTATIONS:
        orient = "N"
    return Tile(kind=kind, orientation=orient, drivable=kind in DRIVABLE_KINDS)


def load_map_dict(name: str, data: dict[str, Any]) -> Map:
    tiles = [[_parse_tile(c) for c in row] for row in data["tiles"]]
    objects = []
    for obj in data.get("objects", []):
        pos = np.asarray(obj.get("pos", (0, 0)), np.float32)
        objects.append(MapObject(
            kind=obj["kind"], pos=pos[:2] if pos.size >= 2 else pos,
            rotate=float(obj.get("rotate", 0.0)),
            height=float(obj.get("height", 0.1)),
            static=bool(obj.get("static", True)),
            mesh=obj.get("mesh")))
    start = data.get("start_tile")
    return Map(name=name, tiles=tiles,
               tile_size=float(data.get("tile_size", 0.585)),
               objects=objects,
               start_tile=tuple(start) if start else None)


def load_map(path: str) -> Map:
    """A map from a reference YAML file (needs PyYAML)."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading the map file {path} needs PyYAML, which is not "
            f"installed; the builtin maps (builtin_map) need no files") from e
    with open(path) as f:
        data = yaml.safe_load(f)
    return load_map_dict(os.path.splitext(os.path.basename(path))[0], data)


# ---------------------------------------------------------------------------
# builtin maps
# ---------------------------------------------------------------------------
# Orientation letters are the reference's (simulator.py:595 + the
# maps/udem1.yaml header docs): the letter is the compass direction the
# agent is expected to drive — /N north, /E east, /S south, /W west.
# A counterclockwise ring: top edge straight/W, west column straight/S,
# bottom edge straight/E, east column straight/N, with curve_left/W,
# /S, /E, /N at the NW, SW, SE, NE corners respectively.
#
# Layouts equivalent to the reference's 11 shipped maps (gym_duckietown/
# maps/*.yaml, regress_* fixtures excluded) are authored below as Python
# data; ``zigzag`` is this repo's own extra closed course.

_TS = 0.585

# the 7x8 closed course shared by loop_empty / loop_obstacles /
# loop_pedestrians / loop_dyn_duckiebots (they differ only in objects)
_LOOP_COURSE = [
    ["floor", "floor", "floor", "floor", "floor", "floor", "floor", "floor"],
    ["floor", "curve_left/W", "straight/W", "straight/W", "straight/W",
     "straight/W", "curve_left/N", "floor"],
    ["floor", "straight/S", "floor", "floor", "floor", "floor",
     "straight/N", "floor"],
    ["floor", "straight/S", "floor", "floor", "floor", "floor",
     "straight/N", "floor"],
    ["floor", "straight/S", "floor", "floor", "curve_right/N", "straight/E",
     "curve_left/E", "floor"],
    ["floor", "curve_left/S", "straight/E", "straight/E", "curve_left/E",
     "floor", "floor", "floor"],
    ["floor", "floor", "floor", "floor", "floor", "floor", "floor", "floor"],
]

# obstacle set shared by loop_obstacles / loop_pedestrians /
# loop_dyn_duckiebots (the variants add dynamic actors on top)
_LOOP_OBSTACLES = [
    {"kind": "duckie", "pos": [3.5, 1.2], "rotate": 10, "height": 0.06},
    {"kind": "cone", "pos": [6.8, 2.5], "rotate": 90, "height": 0.08},
    {"kind": "cone", "pos": [6.6, 2.4], "rotate": 90, "height": 0.08},
    {"kind": "duckie", "pos": [1.5, 5.5], "rotate": 90, "height": 0.08},
    {"kind": "duckiebot", "pos": [4.5, 5.75], "rotate": -45, "height": 0.12},
    {"kind": "barrier", "pos": [0.9, 3], "rotate": 100, "height": 0.08},
]

BUILTIN_MAPS: dict[str, dict] = {
    "straight_road": {
        "tile_size": _TS,
        "tiles": [["straight/E"] * 36],
        "start_tile": [0, 0],
    },
    "small_loop": {
        "tile_size": _TS,
        "tiles": [
            ["curve_left/W", "straight/W", "curve_left/N"],
            ["straight/S", "asphalt", "straight/N"],
            ["curve_left/S", "straight/E", "curve_left/E"],
        ],
    },
    "small_loop_cw": {
        "tile_size": _TS,
        "tiles": [
            ["curve_right/N", "straight/E", "curve_right/E"],
            ["straight/N", "asphalt", "straight/S"],
            ["curve_right/W", "straight/W", "curve_right/S"],
        ],
    },
    "loop": {
        "tile_size": _TS,
        "tiles": [
            ["asphalt"] * 6,
            ["asphalt", "curve_left/W", "straight/W", "straight/W",
             "curve_left/N", "asphalt"],
            ["asphalt", "straight/S", "asphalt", "asphalt", "straight/N",
             "asphalt"],
            ["asphalt", "straight/S", "asphalt", "asphalt", "straight/N",
             "asphalt"],
            ["asphalt", "curve_left/S", "straight/E", "straight/E",
             "curve_left/E", "asphalt"],
            ["asphalt"] * 6,
        ],
        "start_tile": [1, 2],
    },
    "loop_empty": {
        "tile_size": _TS,
        "tiles": _LOOP_COURSE,
        "objects": [
            {"kind": "duckie", "pos": [0.5, 0.5], "rotate": 10, "height": 0.06},
            {"kind": "duckie", "pos": [0.5, 0.7], "rotate": 10, "height": 0.06},
            {"kind": "duckie", "pos": [6.5, 0.7], "rotate": 10, "height": 0.06},
            {"kind": "cone", "pos": [0, 2.5], "rotate": 90, "height": 0.08},
        ],
    },
    "loop_obstacles": {
        "tile_size": _TS,
        "tiles": _LOOP_COURSE,
        "objects": _LOOP_OBSTACLES + [
            {"kind": "duckie", "pos": [3.0, 6.0], "rotate": 90,
             "height": 0.08, "static": True},
        ],
    },
    "loop_pedestrians": {
        "tile_size": _TS,
        "tiles": _LOOP_COURSE,
        "objects": _LOOP_OBSTACLES + [
            {"kind": "duckie", "pos": [3.0, 6.25], "rotate": 90,
             "height": 0.08, "static": False},
            {"kind": "duckie", "pos": [4.0, 6.25], "rotate": 90,
             "height": 0.08, "static": False},
        ],
    },
    "loop_dyn_duckiebots": {
        "tile_size": _TS,
        "tiles": _LOOP_COURSE,
        "objects": _LOOP_OBSTACLES + [
            {"kind": "duckie", "pos": [3.0, 6.0], "rotate": 90,
             "height": 0.08, "static": True},
            {"kind": "duckiebot", "pos": [2.5, 5.75], "rotate": 0,
             "height": 0.12, "static": False},
        ],
    },
    "4way": {
        "tile_size": _TS,
        "tiles": [
            ["curve_left/W", "straight/W", "3way_left/W", "straight/W",
             "curve_left/N"],
            ["straight/S", "asphalt", "straight/N", "asphalt", "straight/N"],
            ["3way_left/S", "straight/W", "4way", "straight/E",
             "3way_left/N"],
            ["straight/S", "asphalt", "straight/S", "asphalt", "straight/N"],
            ["curve_left/S", "straight/E", "3way_left/E", "straight/E",
             "curve_left/E"],
        ],
        "objects": [
            {"kind": "trafficlight", "pos": [2.2, 2.2], "rotate": 45,
             "height": 0.4},
        ],
    },
    "udem1": {
        "tile_size": _TS,
        "tiles": [
            ["floor"] * 8,
            ["floor", "curve_left/W", "straight/W", "3way_left/W",
             "straight/W", "straight/W", "curve_left/N", "asphalt"],
            ["floor", "straight/S", "grass", "straight/N", "asphalt",
             "asphalt", "straight/N", "asphalt"],
            ["floor", "3way_left/S", "straight/W", "3way_left/N", "asphalt",
             "asphalt", "straight/N", "asphalt"],
            ["floor", "straight/S", "grass", "straight/N", "asphalt",
             "curve_right/N", "curve_left/E", "asphalt"],
            ["floor", "curve_left/S", "straight/E", "3way_left/E",
             "straight/E", "curve_left/E", "asphalt", "asphalt"],
            ["floor"] * 8,
        ],
        "objects": [
            {"kind": "tree", "pos": [2.5, 4.5], "rotate": 180, "height": 0.25},
            {"kind": "duckie", "pos": [2.5, 2.9], "rotate": -90, "height": 0.08},
            {"kind": "sign_stop", "pos": [2.08, 4.05], "rotate": 90,
             "height": 0.18},
            {"kind": "sign_left_T_intersect", "pos": [0.94, 3.96],
             "rotate": 90, "height": 0.18},
            {"kind": "sign_stop", "pos": [2.08, 2.96], "rotate": -90,
             "height": 0.18},
            {"kind": "sign_right_T_intersect", "pos": [0.94, 3.05],
             "rotate": -90, "height": 0.18},
            {"kind": "sign_stop", "pos": [0.94, 4.05], "rotate": 0,
             "height": 0.18},
            {"kind": "sign_T_intersect", "pos": [0.94, 2.96], "rotate": 0,
             "height": 0.18},
            {"kind": "house", "pos": [4.8, 2.6], "rotate": 90, "height": 0.5},
            {"kind": "truck", "pos": [1.6, 6.3], "rotate": 0, "height": 0.2},
            {"kind": "bus", "pos": [2.0, 0.5], "rotate": 0, "height": 0.18},
            {"kind": "bus", "pos": [4, 0.5], "rotate": 0, "height": 0.18},
            {"kind": "bus", "pos": [6.0, 0.5], "rotate": 0, "height": 0.18},
            {"kind": "truck", "pos": [7.5, 0.5], "rotate": 180, "height": 0.2},
        ],
    },
    "zigzag_dists": {
        "tile_size": _TS,
        "tiles": [
            ["asphalt"] * 9,
            ["asphalt", "curve_left/W", "curve_left/N", "asphalt",
             "curve_left/W", "straight/W", "straight/W", "curve_left/N",
             "asphalt"],
            ["asphalt", "straight/S", "curve_right/W", "straight/W",
             "curve_right/S", "asphalt", "curve_right/N", "curve_left/E",
             "asphalt"],
            ["asphalt", "straight/S", "asphalt", "asphalt", "asphalt",
             "asphalt", "straight/N", "asphalt", "asphalt"],
            ["asphalt", "straight/S", "asphalt", "asphalt", "curve_right/N",
             "straight/E", "curve_left/E", "asphalt", "asphalt"],
            ["asphalt", "straight/S", "asphalt", "curve_right/N",
             "curve_left/E", "asphalt", "asphalt", "asphalt", "asphalt"],
            ["asphalt", "straight/S", "asphalt", "straight/N", "asphalt",
             "asphalt", "asphalt", "asphalt", "asphalt"],
            ["asphalt", "curve_left/S", "straight/E", "curve_left/E",
             "asphalt", "asphalt", "asphalt", "asphalt", "asphalt"],
            ["asphalt"] * 9,
        ],
        "objects": [
            {"kind": "bus", "pos": [1.0, 0.5], "rotate": 10, "height": 0.18},
            {"kind": "bus", "pos": [2.4, 0.65], "rotate": -10, "height": 0.18},
            {"kind": "bus", "pos": [4.0, 0.65], "rotate": -5, "height": 0.19},
            {"kind": "bus", "pos": [6.0, 0.5], "rotate": 0, "height": 0.18},
            {"kind": "truck", "pos": [7.5, 0.5], "rotate": 180, "height": 0.2},
            {"kind": "bus", "pos": [8.3, 1.5], "rotate": 90, "height": 0.22},
            {"kind": "bus", "pos": [8.3, 3.0], "rotate": 95, "height": 0.21},
            {"kind": "truck", "pos": [0.6, 8.3], "rotate": -30, "height": 0.25},
            {"kind": "tree", "pos": [2.5, 4.5], "rotate": 180, "height": 0.25},
            {"kind": "sign_blank", "pos": [5.95, 2.4], "rotate": -20,
             "height": 0.18},
        ],
    },
    "zigzag": {
        "tile_size": _TS,
        "tiles": [
            ["curve_left/W", "straight/W", "curve_left/N", "floor", "floor"],
            ["straight/S", "grass", "curve_right/W", "straight/W",
             "curve_left/N"],
            ["straight/S", "grass", "grass", "grass", "straight/N"],
            ["curve_left/S", "straight/E", "straight/E", "straight/E",
             "curve_left/E"],
        ],
        "objects": [
            {"kind": "duckie", "pos": [2.5, 2.5], "rotate": 90, "height": 0.08},
            {"kind": "cone", "pos": [1.5, 0.6], "rotate": 0, "height": 0.08},
        ],
    },
}


def builtin_map(name: str) -> Map:
    if name not in BUILTIN_MAPS:
        raise KeyError(f"unknown builtin map {name!r}; "
                       f"available: {sorted(BUILTIN_MAPS)}")
    return load_map_dict(name, BUILTIN_MAPS[name])
