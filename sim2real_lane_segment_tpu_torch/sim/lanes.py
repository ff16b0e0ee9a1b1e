"""Lane geometry: signed distance and tangent of the lane-centre curve.

Counterpart of the JAX package's ``sim/lanes.py``.  The reference baked
Bezier control curves per tile and picked the curve whose chord best
aligns with the agent heading (argmax of chord . dir, simulator.py:
847-1101 ``_get_curve`` / ``closest_curve_point``).  Here each tile kind
carries an analytic curve-primitive table: lane centres are straight lines
(u = 0.25/0.75) or quarter arcs around a tile corner (r = 0.25 inner /
0.75 outer), so closest point, signed distance and tangent are closed
form, batched over agents.  Selection keeps the reference's quirk: its
chords are effectively unnormalized (one scalar norm divides all of them,
simulator.py:1043), so the table stores true chord vectors.

Canonical frames (rot 0 == orientation 'N', flow north; right-hand
traffic, a north-facing agent's lane centre is u=0.75):
- straight: road along v; northbound u=0.75, southbound u=0.25;
- curve_left: quarter annulus around corner (0,1): S-edge<->W-edge;
- curve_right: quarter annulus around corner (1,1): S-edge<->E-edge;
- 3way (both ``3way_left`` and ``3way_right``, which the reference gives
  the same curves, QUIRKS.md): N-S through road + branch WEST;
- 4way: through roads both axes + all four corner turn arcs.

Arc sign convention: s=+1 for left-turning flow, s=-1 for right-turning;
dist = (r - r_lane) * s is then positive to the agent's right for every
primitive, matching the straight-line convention dist = u - 0.75.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .maps import Map
from .textures import rotate_tex_index

# kind codes for the jit switch
K_OTHER, K_STRAIGHT, K_CURVE_L, K_CURVE_R, K_3WAY, K_4WAY = 0, 1, 2, 3, 4, 5
LANE_R = 0.75  # right-lane center (tile units)
MAX_CURVES = 12

_KIND_CODES = {"straight": K_STRAIGHT, "curve_left": K_CURVE_L,
               "curve_right": K_CURVE_R, "3way_left": K_3WAY,
               "3way_right": K_3WAY, "4way": K_4WAY}


def kind_code(kind: str) -> int:
    return _KIND_CODES.get(kind, K_OTHER)


# ---------------------------------------------------------------------------
# curve-primitive tables
# ---------------------------------------------------------------------------
# primitive row: [is_arc, a0, a1, d0, d1, r_lane, s, sel0, sel1, valid]
#   line: point (a0, a1) on the lane center, unit direction (d0, d1)
#   arc:  corner center (a0, a1), lane radius r_lane, turn sign s
#   (sel0, sel1): the curve's chord vector — selection heading, kept
#   unnormalized to reproduce the reference's selection bias.
N_FIELDS = 10


def _line(u_or_v: float, axis: str, sgn: float) -> list[float]:
    """Lane-center line along ``axis`` ('v' = north-south road)."""
    if axis == "v":   # road along v, lane at u=const, direction (0, sgn)
        p, d = (u_or_v, 0.5), (0.0, sgn)
    else:             # road along u, lane at v=const, direction (sgn, 0)
        p, d = (0.5, u_or_v), (sgn, 0.0)
    return [0.0, p[0], p[1], d[0], d[1], 0.0, 0.0, d[0], d[1], 1.0]


def _arc(cu: float, cv: float, r: float, s: float) -> list[float]:
    """Quarter arc around tile corner (cu, cv), lane radius r, turn sign s."""
    # endpoints lie on the two tile edges adjoining the corner
    ex = np.array([np.sign(0.5 - cu), 0.0])
    ez = np.array([0.0, np.sign(0.5 - cv)])
    p1 = np.array([cu, cv]) + r * ex
    p2 = np.array([cu, cv]) + r * ez
    # tangent at the arc midpoint fixes the chord direction for flow s
    m = (ex + ez) / np.sqrt(2.0)
    tan_mid = s * np.array([m[1], -m[0]])
    chord = p2 - p1
    if float(chord @ tan_mid) < 0:
        chord = -chord
    return [1.0, cu, cv, 0.0, 0.0, r, s, float(chord[0]), float(chord[1]), 1.0]


def _pad(rows: list[list[float]]) -> np.ndarray:
    out = np.zeros((MAX_CURVES, N_FIELDS), np.float32)
    if rows:
        out[:len(rows)] = np.asarray(rows, np.float32)
    return out


def _build_prim_table() -> np.ndarray:
    ns_lines = [_line(0.75, "v", -1.0), _line(0.25, "v", +1.0)]
    ew_lines = [_line(0.75, "u", +1.0), _line(0.25, "u", -1.0)]

    def corner_turns(cu, cv):
        return [_arc(cu, cv, 0.25, -1.0), _arc(cu, cv, 0.75, +1.0)]

    tables = {
        K_OTHER: [],
        K_STRAIGHT: ns_lines,
        # curve tiles: the canonical direction's right lane is the OUTER
        # r=0.75 arc on curve_left (a left turn) and the INNER r=0.25 arc
        # on curve_right (a right turn hugs its corner) — confirmed by the
        # reference's Bezier points (simulator.py:875-907) and the green
        # region of its curve_*_cv annotated textures
        K_CURVE_L: [_arc(0.0, 1.0, 0.75, +1.0), _arc(0.0, 1.0, 0.25, -1.0)],
        K_CURVE_R: [_arc(1.0, 1.0, 0.25, -1.0), _arc(1.0, 1.0, 0.75, +1.0)],
        # 3way canonical: N-S through + branch west (turns at west corners)
        K_3WAY: ns_lines + corner_turns(0.0, 0.0) + corner_turns(0.0, 1.0),
        K_4WAY: ns_lines + ew_lines + corner_turns(0.0, 0.0)
                + corner_turns(1.0, 0.0) + corner_turns(0.0, 1.0)
                + corner_turns(1.0, 1.0),
    }
    n_kinds = max(tables) + 1
    return np.stack([_pad(tables[k]) for k in range(n_kinds)])


PRIM_TABLE = _build_prim_table()   # (n_kinds, MAX_CURVES, N_FIELDS)


def build_lane_arrays(m: Map, device=None):
    """(code, rot, drivable) (gh, gw) tensors of a map on ``device``."""
    gh, gw = m.grid_height, m.grid_width
    code = np.zeros((gh, gw), np.int32)
    rot = np.zeros((gh, gw), np.int32)
    drivable = np.zeros((gh, gw), bool)
    for j in range(gh):
        for i in range(gw):
            t = m.tiles[j][i]
            if t is None:
                continue
            code[j, i] = kind_code(t.kind)
            rot[j, i] = rotate_tex_index(t.orientation)
            drivable[j, i] = t.drivable
    return tuple(torch.as_tensor(a, device=device).long() if a.dtype != bool
                 else torch.as_tensor(a, device=device)
                 for a in (code, rot, drivable))


def _pick(rot: torch.Tensor, *choices: torch.Tensor) -> torch.Tensor:
    """``choices[rot]`` elementwise (``jnp.select`` over rot == 0..3)."""
    return torch.gather(torch.stack(torch.broadcast_tensors(*choices), -1),
                        -1, rot[..., None]).squeeze(-1)


def rot_uv_fwd(u, v, rot):
    """In-tile uv rotated into the canonical frame (render's rotation)."""
    return (_pick(rot, u, v, 1 - u, 1 - v), _pick(rot, v, 1 - u, 1 - v, u))


def _rot_dir_fwd(du, dv, rot):
    """A tile-frame direction in the canonical frame (the uv rotation's
    Jacobian): rot0 (u,v); rot1 (v,1-u): d->(dv,-du); rot2 (-du,-dv);
    rot3 (1-v,u): d->(-dv,du)."""
    return (_pick(rot, du, dv, -du, -dv), _pick(rot, dv, -du, -dv, du))


def _rot_dir_bwd(du, dv, rot):
    """A canonical-frame direction back in the tile frame (inverse)."""
    return (_pick(rot, du, -dv, -du, dv), _pick(rot, dv, du, -dv, -du))


class LanePos(NamedTuple):
    dist: torch.Tensor      # signed distance (tile units) to the lane centre
    dot_dir: torch.Tensor   # heading . lane tangent
    in_lane: torch.Tensor   # bool: on a drivable tile with lane geometry
    tangent: torch.Tensor   # (..., 2) world-frame (x, z) unit tangent
    curvature: torch.Tensor  # signed lane curvature, 1/m (+ = left turn)


def lane_pos(lane_arrays, tile_size: float, pos: torch.Tensor,
             angle: torch.Tensor) -> LanePos:
    """Lane position via the reference's curve-selection rule: among the
    tile's curve primitives, pick argmax(chord . heading), then return the
    signed distance and tangent of the closest point on that curve.
    ``pos`` (..., 2), ``angle`` (...)."""
    code_g, rot_g, drivable_g = lane_arrays
    gh, gw = code_g.shape
    # x / tile_size as the JAX package's jitted rollout computes it: XLA
    # folds a division by a constant into a product with its float32
    # reciprocal
    inv = float(np.float32(1) / np.float32(tile_size))
    fx, fz = pos[..., 0] * inv, pos[..., 1] * inv
    ti = torch.floor(fx).long()
    tj = torch.floor(fz).long()
    in_grid = (ti >= 0) & (ti < gw) & (tj >= 0) & (tj < gh)
    tic = ti.clamp(0, gw - 1)
    tjc = tj.clamp(0, gh - 1)
    code = code_g[tjc, tic]
    rot = rot_g[tjc, tic]
    drivable = drivable_g[tjc, tic] & in_grid

    cu, cv = rot_uv_fwd(fx - ti.float(), fz - tj.float(), rot)
    # world: +u == +x, +v == +z; heading 0 looks along +x
    hx, hz = torch.cos(angle), -torch.sin(angle)
    hcu, hcv = _rot_dir_fwd(hx, hz, rot)

    prim = _prim_table(pos.device)[code]        # (..., MAX_CURVES, N_FIELDS)
    is_arc = prim[..., 0] > 0.5
    a0, a1 = prim[..., 1], prim[..., 2]
    d0, d1 = prim[..., 3], prim[..., 4]
    r_lane, s = prim[..., 5], prim[..., 6]
    valid = prim[..., 9] > 0.5

    # line: dist = (uv - p) . right_of(d); right_of((du,dv)) = (-dv, du)
    rel0, rel1 = cu[..., None] - a0, cv[..., None] - a1
    dist_line = rel0 * (-d1) + rel1 * d0
    # arc: e = uv - c
    r = torch.sqrt(rel0 ** 2 + rel1 ** 2) + 1e-9
    dist_arc = (r - r_lane) * s
    dists = torch.where(is_arc, dist_arc, dist_line)
    tan0 = torch.where(is_arc, rel1 * (s / r), d0)
    tan1 = torch.where(is_arc, -rel0 * (s / r), d1)

    scores = prim[..., 7] * hcu[..., None] + prim[..., 8] * hcv[..., None]
    scores = torch.where(valid, scores, torch.full_like(scores, -1e9))
    idx = torch.argmax(scores, -1, keepdim=True)

    def sel(x):
        return torch.gather(x, -1, idx).squeeze(-1)

    known = code != K_OTHER
    zero = torch.zeros_like(cu)
    dist = torch.where(known, sel(dists), zero)
    tc0 = torch.where(known, sel(tan0), zero)
    tc1 = torch.where(known, sel(tan1), zero + 1.0)
    tu, tv = _rot_dir_bwd(tc0, tc1, rot)
    dot_dir = hx * tu + hz * tv
    # signed world curvature of the selected primitive (arcs only);
    # rotations preserve handedness so no per-rot sign flip is needed
    curv = torch.where(known & sel(is_arc),
                       sel(s) / (sel(r_lane) * tile_size + 1e-9), zero)
    return LanePos(dist=dist, dot_dir=dot_dir, in_lane=drivable & known,
                   tangent=torch.stack([tu, tv], -1), curvature=curv)


@functools.cache
def _prim_table(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(PRIM_TABLE, device=device)
