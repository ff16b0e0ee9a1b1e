"""Procedural tile shading: the texel colour computed from the in-tile uv.

Counterpart of the JAX package's ``sim/shading.py``.  The textures are
procedural (lane lines, dashes and annotation colours are closed-form
functions of the in-tile uv), so the shader computes each texel's colour
directly, with an integer hash for the asphalt and grass noise, and needs
no texture atlas.  It shares its geometry with ``textures.py``, so the
atlas and procedural paths agree on where lanes and lines are.

Tile codes (S_*): ``render.build_scene`` maps tile kinds to small ints;
rotation handling mirrors ``render._rotate_uv``.
"""
from __future__ import annotations

import numpy as np
import torch

from .textures import (ANNOT_LEFT, ANNOT_RIGHT, CENTER_LINE_W, CORNER_ZONE,
                       DASH_DUTY, DASH_PERIOD, EDGE_LINE_POS, EDGE_LINE_W,
                       FLOOR, GRASS, ROAD, ROAD_NOISE, WHITE, YELLOW,
                       rotate_tex_index)

(S_ASPHALT, S_GRASS, S_FLOOR, S_STRAIGHT, S_CURVE_L, S_CURVE_R, S_3WAY,
 S_4WAY) = 0, 1, 2, 3, 4, 5, 6, 7

KIND_TO_SHADE = {
    "asphalt": S_ASPHALT, "grass": S_GRASS, "floor": S_FLOOR,
    "straight": S_STRAIGHT, "curve_left": S_CURVE_L,
    "curve_right": S_CURVE_R,
    # 3way_right shares 3way_left's canonical geometry: the reference
    # gives both the same curve set (simulator.py:909 kind.startswith)
    "3way_left": S_3WAY, "3way_right": S_3WAY, "4way": S_4WAY,
}


def _hash_noise(ix: torch.Tensor, iy: torch.Tensor,
                amplitude: float) -> torch.Tensor:
    """Deterministic per-texel noise in [-amplitude, amplitude] from an
    int32 hash: multiplies wrap, ``>>`` is arithmetic (the JAX package's
    int32 ops, which torch's int32 ops repeat on the CPU and the card)."""
    ix, iy = ix.to(torch.int32), iy.to(torch.int32)
    h = (ix * 73856093) ^ (iy * 19349663)
    h = h ^ (h >> 13)
    h = h * 1274126177
    h = h ^ (h >> 16)
    u = (h & 0xFFFF).to(torch.float32) / 65535.0  # [0, 1]
    return (u * 2.0 - 1.0) * amplitude


def _rgb(c, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(c, np.float32), device=like.device)


def shade(code: torch.Tensor, cu: torch.Tensor, cv: torch.Tensor,
          annotated: bool) -> torch.Tensor:
    """Per-pixel tile colour: ``code`` (...) int shade codes and the
    canonical (orientation-corrected) in-tile uv ``cu``, ``cv`` (...)
    -> (..., 3) float32 RGB in [0, 255]."""
    u, v = cu, cv

    # per-texel asphalt/grass noise on a virtual 256-texel grid
    ix = torch.floor(u * 256.0).to(torch.int32)
    iy = torch.floor(v * 256.0).to(torch.int32)
    noise = _hash_noise(ix, iy, 1.0)[..., None]

    asphalt = _rgb(ROAD, u) + noise * ROAD_NOISE
    grass = _rgb(GRASS, u) + noise * 10.0
    floor = _rgb(FLOOR, u).expand_as(asphalt)
    white_c, yellow_c = _rgb(WHITE, u), _rgb(YELLOW, u)

    # ---- straight geometry (canonical: road along v, centre at u=0.5)
    white_s = ((torch.abs(u - EDGE_LINE_POS - EDGE_LINE_W / 2)
                < EDGE_LINE_W / 2)
               | (torch.abs(u - (1 - EDGE_LINE_POS - EDGE_LINE_W / 2))
                  < EDGE_LINE_W / 2))
    dash_s = torch.remainder(v, DASH_PERIOD) < DASH_PERIOD * DASH_DUTY
    yellow_s = (torch.abs(u - 0.5) < CENTER_LINE_W / 2) & dash_s
    right_s = u > 0.5

    # ---- curve geometry (annulus around a corner); the canonical right
    # lane is the OUTER half on curve_left, the INNER half on curve_right
    def curve(cu0, cv0, right_outer):
        r = torch.hypot(u - cu0, v - cv0)
        road = (r > 0.0) & (r < 1.0)
        white = ((torch.abs(r - EDGE_LINE_POS - EDGE_LINE_W / 2)
                  < EDGE_LINE_W / 2)
                 | (torch.abs(r - (1 - EDGE_LINE_POS - EDGE_LINE_W / 2))
                    < EDGE_LINE_W / 2))
        theta = torch.atan2(v - cv0, u - cu0)
        dash = torch.remainder(torch.abs(theta), 0.4) < 0.2
        yellow = (torch.abs(r - 0.5) < CENTER_LINE_W / 2) & dash
        right = (r > 0.5) if right_outer else (r < 0.5)
        return road, white, yellow, right

    road_l, white_l, yellow_l, right_l = curve(0.0, 1.0, True)
    road_r, white_r, yellow_r, right_r = curve(1.0, 1.0, False)

    # ---- intersection geometry (textures.intersection_masks).
    # Annotated == base: the reference has no _cv textures for 3way/4way
    # (it falls back to the base texture -> background labels, QUIRKS.md)
    def edge_band(x, p):
        return torch.abs(x - p - EDGE_LINE_W / 2) < EDGE_LINE_W / 2

    zone_v = (v < CORNER_ZONE) | (v > 1 - CORNER_ZONE)
    zone_u = (u < CORNER_ZONE) | (u > 1 - CORNER_ZONE)
    w_line = edge_band(u, EDGE_LINE_POS)
    e_line = edge_band(u, 1 - EDGE_LINE_POS - EDGE_LINE_W)
    n_line = edge_band(v, EDGE_LINE_POS)
    s_line = edge_band(v, 1 - EDGE_LINE_POS - EDGE_LINE_W)
    white_4w = ((w_line | e_line) & zone_v) | ((n_line | s_line) & zone_u)
    white_3w = (e_line | (w_line & zone_v)
                | ((n_line | s_line) & (u < CORNER_ZONE)))
    yellow_3w = (torch.abs(u - 0.5) < CENTER_LINE_W / 2) & dash_s & zone_v

    def inter_color(white, yellow):
        c = torch.where(white[..., None], white_c, asphalt)
        return torch.where(yellow[..., None], yellow_c, c)

    def road_color(white, yellow, right, road):
        if annotated:
            lane = torch.where(right[..., None], _rgb(ANNOT_RIGHT, u),
                               _rgb(ANNOT_LEFT, u))
            return torch.where(road[..., None], lane, grass)
        c = torch.where((white & road)[..., None], white_c, asphalt)
        c = torch.where((yellow & road)[..., None], yellow_c, c)
        return torch.where(road[..., None], c, grass)

    all_road = torch.ones_like(right_s)
    code_e = code[..., None]
    out = torch.where(code_e == S_GRASS, grass, asphalt)
    out = torch.where(code_e == S_FLOOR, floor, out)
    out = torch.where(code_e == S_STRAIGHT,
                      road_color(white_s, yellow_s, right_s, all_road), out)
    out = torch.where(code_e == S_CURVE_L,
                      road_color(white_l, yellow_l, right_l, road_l), out)
    out = torch.where(code_e == S_CURVE_R,
                      road_color(white_r, yellow_r, right_r, road_r), out)
    out = torch.where(code_e == S_3WAY, inter_color(white_3w, yellow_3w),
                      out)
    out = torch.where(code_e == S_4WAY,
                      inter_color(white_4w, torch.zeros_like(yellow_3w)),
                      out)
    return out


def build_shade_arrays(m) -> tuple[np.ndarray, np.ndarray]:
    """(shade_code, rot) (gh, gw) int32 arrays for a Map."""
    gh, gw = m.grid_height, m.grid_width
    code = np.zeros((gh, gw), np.int32)
    rot = np.zeros((gh, gw), np.int32)
    for j in range(gh):
        for i in range(gw):
            t = m.tiles[j][i]
            if t is None:
                code[j, i] = S_FLOOR
            else:
                code[j, i] = KIND_TO_SHADE.get(t.kind, S_ASPHALT)
                rot[j, i] = rotate_tex_index(t.orientation)
    return code, rot
