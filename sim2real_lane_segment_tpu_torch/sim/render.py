"""Ray-cast renderer of the tile world, batched over frames.

Counterpart of the JAX package's ``sim/render.py``, the replacement for
the reference's pyglet/OpenGL renderer (simulator.py:1403-1614).  A batch
of camera poses renders in one pass of tensor ops on the device:

  pixel grid -> pinhole rays (pitch + heading rotation)
             -> ground-plane intersection (y=0)
             -> tile index + in-tile UV (orientation-rotated)
             -> procedural shading or a texture-atlas bilinear gather
             -> objects composited by nearest hit: vertical cylinders,
                then mesh triangles (Moller-Trumbore, ``objmesh.py``)
             -> lighting scale + camera noise (domain randomization).

Pixel-aligned (normal, annotated) pairs are structural: both frames use
the same rays, hits and DR parameters, and only the colours differ, so
``render_pair`` computes the geometry once and shades it twice (the
reference needed a ``_perturb(use_last_noise=True)`` replay for this,
simulator.py:759-781).  The fisheye distortion bends the pixel -> ray
grid once (``distortion.py``).

Randomness comes in as tensors: the DR parameters (``DRParams``, one row
per frame) and the camera noise (standard normal draws, scaled by each
frame's ``noise_sigma``), so a caller can feed any generator's draws.
The one-hot matmul lookups the JAX package uses for its tile grid (TPU
gathers are slow) are direct indexing here; the values are small
integers, so both are exact.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .maps import Map
from .objmesh import (MeshSet, load_obj, make_box_mesh, make_duckiebot_mesh,
                      nearest, nearest_hits, place_mesh, shade_mesh_hits)
from .physics import CAMERA_ANGLE, CAMERA_FORWARD_DIST, CAMERA_HEIGHT
from .shading import build_shade_arrays, shade
from .lanes import rot_uv_fwd
from .textures import (ANNOT_OBSTACLE, RES, build_atlas,
                       build_atlas_from_pack, rotate_tex_index)

CAMERA_FOV_Y = 75.0  # vertical field of view, degrees
SKY_TOP = np.array([90, 160, 220], np.float32)
SKY_HORIZON = np.array([180, 210, 235], np.float32)

# horizon variants selected by DR ``horz_mode`` (simulator.py:385-396:
# blue sky / wall color / dark grey / near-white — grey and white are
# sampled deliberately because they confuse road/lane-marking colors).
# (sky top, sky horizon) pairs; mode 0 == legacy blue.
HORZ_MODES_TOP = np.array([
    [90, 160, 220], [165, 150, 110], [35, 35, 38], [225, 225, 225],
], np.float32)
HORZ_MODES_HORIZON = np.array([
    [180, 210, 235], [200, 185, 145], [55, 55, 58], [238, 238, 238],
], np.float32)

# lighting model: far positional light (reference GL_LIGHT0 position was
# sampled in huge units, randomization config light_pos) -> effectively
# directional; lambert on the surface normal with a fixed ambient floor.
# Normalized so the DEFAULT light position renders at intensity 1.0
# (keeps un-randomized frames identical to pre-lighting renders).
LIGHT_AMBIENT = 0.35
LIGHT_DIFFUSE = 0.65
DEFAULT_LIGHT_POS = np.array([-40.0, 200.0, 100.0], np.float32)
_LIGHT_NORM = LIGHT_AMBIENT + LIGHT_DIFFUSE * (
    DEFAULT_LIGHT_POS[1] / np.linalg.norm(DEFAULT_LIGHT_POS))


class SceneArrays(NamedTuple):
    """Static device tensors describing one map."""
    atlas: torch.Tensor       # (n_slots, RES, RES, 3) uint8
    tile_slot: torch.Tensor   # (gh, gw) int64: base atlas slot per tile
    tile_rot: torch.Tensor    # (gh, gw) int64: number of 90 deg uv rotations
    shade_code: torch.Tensor  # (gh, gw) int64: procedural shading codes
    tile_size: float
    grid_hw: tuple[int, int]
    # objects: (x, z, radius, h, r, g, b, annotated, draw_cyl, hx, hz,
    #           theta): cols 0:9 drive the cylinder compositor, cols 9:12
    #           are the OBB collision footprint
    objects: torch.Tensor     # (n_obj, 12) float32 (inert row when none)
    meshes: MeshSet           # packed OBJ/box triangles (objmesh.py)

    @property
    def device(self) -> torch.device:
        return self.objects.device


OBJECT_COLORS = {
    "duckie": (240, 215, 50),
    "duckiebot": (60, 60, 170),
    "cone": (230, 120, 40),
    "barrier": (200, 50, 40),
    "sign": (180, 180, 180),
    "tree": (30, 110, 40),
    "building": (160, 140, 120),
    "house": (160, 140, 120),
    "truck": (120, 120, 130),
    "bus": (200, 180, 60),
}
OBJECT_RADII = {"duckie": 0.06, "duckiebot": 0.08, "cone": 0.05,
                "barrier": 0.15, "tree": 0.2, "building": 0.4}
# kinds rendered as box meshes (reference loaded OBJ meshes for these;
# map objects may also specify an explicit ``mesh: path.obj``)
MESH_KINDS = {"duckiebot": (0.13, 0.12, 0.18), "barrier": (0.5, 0.12, 0.1),
              "building": (0.6, 0.5, 0.6), "house": (0.6, 0.4, 0.6),
              "truck": (0.2, 0.2, 0.5), "bus": (0.2, 0.25, 0.6),
              "sign": (0.12, 0.25, 0.02)}


def build_scene(m: Map, seed: int = 0, with_layout: bool = False,
                texture_pack: str | None = None, device=None):
    """The scene tensors of map ``m`` on ``device``; with_layout also
    returns {object index: (first_triangle, n_triangles, mesh,
    rotate_deg)}.  ``texture_pack`` loads photographic tile textures
    (reference graphics.py:25-65 file layout) into the atlas instead of
    the procedural ones, for ``render_frame(procedural=False)``."""
    if texture_pack is not None:
        atlas_np, kind_index = build_atlas_from_pack(texture_pack, seed)
    else:
        atlas_np, kind_index = build_atlas(seed)
    gh, gw = m.grid_height, m.grid_width
    slot = np.zeros((gh, gw), np.int64)
    rot = np.zeros((gh, gw), np.int64)
    for j in range(gh):
        for i in range(gw):
            t = m.tiles[j][i]
            if t is None:
                slot[j, i] = kind_index["floor"]
            else:
                kind = t.kind if t.kind in kind_index else "asphalt"
                slot[j, i] = kind_index[kind]
                rot[j, i] = rotate_tex_index(t.orientation)
    objs = []
    mesh_instances = []
    layout = {}
    tri_count = 0
    for oi, o in enumerate(m.objects):
        # all sign_* variants share the generic sign geometry and colour
        okind = "sign" if o.kind.startswith("sign") else o.kind
        color = OBJECT_COLORS.get(okind, (150, 150, 150))
        radius = OBJECT_RADII.get(okind, 0.08)
        # duckies/bots/cones are "obstacles": their annotated render is
        # pure red (postprocess_v2 r>0 rule)
        annotated = 1.0 if o.kind in ("duckie", "duckiebot", "cone") else 0.0
        pos_world = (o.pos[0] * m.tile_size, o.pos[1] * m.tile_size)
        mesh = None
        if o.mesh:
            mesh = load_obj(o.mesh)
        elif okind == "duckiebot":
            # UV-textured skin + annotated texture swap (the reference's
            # duckiebot_cv mesh, objmesh.py:289-302)
            mesh = make_duckiebot_mesh()
        elif okind in MESH_KINDS:
            sx, sy, sz = MESH_KINDS[okind]
            sy = o.height or sy
            mesh = make_box_mesh(sx, sy, sz, color)
        draw_cyl = 0.0 if mesh is not None else 1.0
        # OBB collision footprint: mesh kinds use their true (sx, sz)
        # footprint; cylinder kinds a square of their radius
        if okind in MESH_KINDS:
            hx, hz = MESH_KINDS[okind][0] / 2, MESH_KINDS[okind][2] / 2
        else:
            hx = hz = radius
        theta = float(np.radians(o.rotate))
        objs.append([*pos_world, radius, o.height, *color, annotated,
                     draw_cyl, hx, hz, theta])
        if mesh is not None:
            mesh_instances.append((place_mesh(mesh, pos_world, o.rotate),
                                   mesh, annotated))
            layout[oi] = (tri_count, mesh.num_triangles, mesh, o.rotate)
            tri_count += mesh.num_triangles
    if not objs:
        objs = [[1e9, 1e9, 0.0, 0.0, 0, 0, 0, 0.0, 0.0, 0.0, 0.0, 0.0]]
    shade_code, _ = build_shade_arrays(m)

    def dev(a):
        return torch.as_tensor(a, device=device)

    scene = SceneArrays(
        atlas=dev(atlas_np), tile_slot=dev(slot), tile_rot=dev(rot),
        shade_code=dev(shade_code.astype(np.int64)), tile_size=m.tile_size,
        grid_hw=(gh, gw), objects=dev(np.asarray(objs, np.float32)),
        meshes=MeshSet.build(mesh_instances, device))
    return (scene, layout) if with_layout else scene


# ---------------------------------------------------------------------------
# rays
# ---------------------------------------------------------------------------

def make_ray_grid(height: int, width: int, fov_y: float = CAMERA_FOV_Y,
                  distortion: bool = False) -> np.ndarray:
    """(H, W, 3) camera-frame ray directions (x right, y up, z forward).

    With ``distortion`` the grid comes from the RasPi plumb-bob
    calibration the reference used (distortion.py): rays are bent once at
    build time, so distorted rendering costs nothing per frame.
    """
    if distortion:
        from .distortion import distorted_ray_grid
        return distorted_ray_grid(height, width)
    aspect = width / height
    tan_y = np.tan(np.radians(fov_y) / 2)
    ys = np.linspace(1, -1, height) * tan_y
    xs = np.linspace(-1, 1, width) * tan_y * aspect
    xx, yy = np.meshgrid(xs, ys)
    dirs = np.stack([xx, yy, np.ones_like(xx)], axis=-1)
    return (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(
        np.float32)


@functools.cache
def _ray_grid(height: int, width: int, distortion: bool,
              device: torch.device) -> torch.Tensor:
    return torch.as_tensor(make_ray_grid(height, width,
                                         distortion=distortion),
                           device=device)


def rotate_rays(rays: torch.Tensor, pitch_deg: float,
                heading: torch.Tensor) -> torch.Tensor:
    """Camera rays (H, W, 3) under a downward pitch, then each frame's yaw
    ``heading`` (B,) -> world-frame rays (B, H, W, 3).

    World frame: x east, y up, z south; heading 0 looks along +x.
    """
    p = torch.deg2rad(torch.tensor(pitch_deg, dtype=torch.float32))
    cy, sy = torch.cos(p).item(), torch.sin(p).item()
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    # pitch down about the camera x-axis
    y2 = y * cy - z * sy
    z2 = y * sy + z * cy
    # yaw: camera +z (forward) maps to heading direction (cos a, 0, -sin a)
    ca = torch.cos(heading)[:, None, None]
    sa = torch.sin(heading)[:, None, None]
    wx = z2 * ca + x * sa
    wz = -z2 * sa + x * ca
    return torch.stack([wx, y2.expand_as(wx), wz], dim=-1)


# ---------------------------------------------------------------------------
# shading
# ---------------------------------------------------------------------------

def _sample_atlas(atlas: torch.Tensor, slot: torch.Tensor, cu: torch.Tensor,
                  cv: torch.Tensor) -> torch.Tensor:
    """Bilinear gather: slot (...) int, (cu, cv) (...) in [0,1); NaN uv
    (rays that miss the ground, whose colour is discarded) read texel 0."""
    fu = torch.nan_to_num(cu, nan=0.0) * (RES - 1)
    fv = torch.nan_to_num(cv, nan=0.0) * (RES - 1)
    u0, v0 = torch.floor(fu), torch.floor(fv)
    wx, wy = (fu - u0)[..., None], (fv - v0)[..., None]
    u0, v0 = u0.long(), v0.long()
    u1, v1 = (u0 + 1).clamp(max=RES - 1), (v0 + 1).clamp(max=RES - 1)

    def g(iy, ix):
        return atlas[slot, iy, ix].to(torch.float32)

    return (g(v0, u0) * (1 - wx) * (1 - wy) + g(v0, u1) * wx * (1 - wy)
            + g(v1, u0) * (1 - wx) * wy + g(v1, u1) * wx * wy)


class DRParams(NamedTuple):
    """Domain-randomization parameters, one row per frame, drawn by
    ``randomization.Randomizer`` (the reference's JSON-config DR,
    randomization/randomizer.py:22-72)."""
    light_rgb: torch.Tensor      # (B, 3) per-channel light scale
    noise_sigma: torch.Tensor    # (B,) camera gaussian noise sigma (uint8 units)
    horizon_shift: torch.Tensor  # (B,) sky colour shift
    light_pos: torch.Tensor      # (B, 3) world light position (far -> directional)
    horz_mode: torch.Tensor      # (B,) int64 horizon/sky variant
    frame_skip: torch.Tensor     # (B,) int64 physics substeps

    @staticmethod
    def default(batch: int, device=None) -> "DRParams":
        f = dict(dtype=torch.float32, device=device)
        return DRParams(
            torch.ones(batch, 3, **f), torch.zeros(batch, **f),
            torch.zeros(batch, **f),
            torch.as_tensor(DEFAULT_LIGHT_POS, device=device).expand(batch, 3),
            torch.zeros(batch, dtype=torch.int64, device=device),
            torch.ones(batch, dtype=torch.int64, device=device))

    @staticmethod
    def sample(generator: torch.Generator, batch: int,
               randomizer=None) -> "DRParams":
        """Draw ``batch`` frames' params from a Randomizer (default: the
        reference-schema default_dr config) on the generator's device."""
        from .randomization import Randomizer
        r = randomizer if randomizer is not None else Randomizer()
        return DRParams.from_draws(r.randomize(generator, batch), batch,
                                   generator.device)

    @staticmethod
    def from_draws(d: dict, batch: int, device=None) -> "DRParams":
        """From a Randomizer draw dict ((batch, ...) per key); missing keys
        fall back to the un-randomized defaults."""
        base = DRParams.default(batch, device)

        def get(k, dflt, dtype=torch.float32):
            if k not in d:
                return dflt
            return torch.as_tensor(d[k], device=device).to(dtype)

        return DRParams(
            light_rgb=get("light_scale", base.light_rgb).reshape(
                batch, -1).expand(batch, 3),
            noise_sigma=get("camera_noise", base.noise_sigma).reshape(batch),
            horizon_shift=get("horizon_shift",
                              base.horizon_shift).reshape(batch),
            light_pos=get("light_pos", base.light_pos).reshape(
                batch, -1).expand(batch, 3),
            horz_mode=get("horz_mode", base.horz_mode, torch.int64).reshape(
                batch) % HORZ_MODES_TOP.shape[0],
            frame_skip=get("frame_skip", base.frame_skip,
                           torch.int64).reshape(batch).clamp(min=1))

    def index(self, i) -> "DRParams":
        """The rows ``i`` (an index tensor or slice) of every field."""
        return DRParams(*(f[i] for f in self))


def _const(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def render_pair(scene: SceneArrays, pos: torch.Tensor, angle: torch.Tensor,
                dr: DRParams, noise: torch.Tensor | None = None, *,
                height: int = 480, width: int = 640,
                distortion: bool = False, procedural: bool = True,
                variants=(False, True)) -> list[torch.Tensor]:
    """Pixel-aligned (normal, annotated) uint8 RGB frames (B, H, W, 3) of
    the poses ``pos`` (B, 2), ``angle`` (B,): same rays, same DR rows
    ``dr``, same camera noise ``noise`` (B, H, W, 3) standard normal draws
    (None: no noise); alignment by construction.  ``variants`` lists the
    frames to shade (False: normal, True: annotated)."""
    dev = scene.device
    rays = rotate_rays(_ray_grid(height, width, distortion, dev),
                       -CAMERA_ANGLE, angle)
    cam_x = pos[:, 0] + CAMERA_FORWARD_DIST * torch.cos(angle)
    cam_z = pos[:, 1] - CAMERA_FORWARD_DIST * torch.sin(angle)
    cam_y = torch.full_like(cam_x, CAMERA_HEIGHT)
    cam_pos = torch.stack([cam_x, cam_y, cam_z], -1)       # (B, 3)
    cx, cyy, cz = (c[:, None, None] for c in (cam_x, cam_y, cam_z))

    dy = rays[..., 1]
    hits_ground = dy < -1e-5
    inf = torch.full_like(dy, float("inf"))
    t = torch.where(hits_ground,
                    -cyy / torch.where(hits_ground, dy, -torch.ones_like(dy)),
                    inf)
    hx = cx + t * rays[..., 0]
    hz = cz + t * rays[..., 2]

    ts = scene.tile_size
    gh, gw = scene.grid_hw
    ti = torch.floor(hx / ts)
    tj = torch.floor(hz / ts)
    in_grid = (ti >= 0) & (ti < gw) & (tj >= 0) & (tj < gh)
    tic = torch.where(in_grid, ti, 0).long().clamp(0, gw - 1)
    tjc = torch.where(in_grid, tj, 0).long().clamp(0, gh - 1)
    u = torch.clamp(hx / ts - ti, 0.0, 1.0 - 1e-6)
    v = torch.clamp(hz / ts - tj, 0.0, 1.0 - 1e-6)
    cu, cv = rot_uv_fwd(u, v, scene.tile_rot[tjc, tic])

    # positional light (DR light_pos): far light -> lambert on the ground
    # normal reduces to L_y/|L|, normalized so the default position is 1.0
    l_hat = dr.light_pos / (torch.linalg.vector_norm(dr.light_pos, dim=-1,
                                                     keepdim=True) + 1e-6)
    ground_light = (LIGHT_AMBIENT + LIGHT_DIFFUSE
                    * torch.clamp(l_hat[:, 1], 0.0, 1.0)) / _LIGHT_NORM
    gl = ground_light[:, None, None, None]

    # sky: vertical gradient above the horizon; DR horz_mode picks the
    # colourway (reference horizon-texture swap analog)
    up = torch.clamp(dy, 0.0, 1.0)[..., None]
    sky_top = _const(HORZ_MODES_TOP, dev)[dr.horz_mode][:, None, None]
    sky_hor = _const(HORZ_MODES_HORIZON, dev)[dr.horz_mode][:, None, None]
    sky = sky_hor * (1 - up) + sky_top * up + dr.horizon_shift[
        :, None, None, None]
    depth = torch.where(hits_ground, t, inf)

    # ---- objects: vertical cylinders, nearest hit nearer than the ground
    obj = scene.objects
    ox, oz, radius, h_obj = (obj[:, k] for k in range(4))
    draw = obj[:, 8] > 0.5
    dxr, dyr, dzr = (rays[..., k, None] for k in range(3))  # (B, H, W, 1)
    fx = cx[..., None] - ox                                 # (B, 1, 1, N)
    fz = cz[..., None] - oz
    a = dxr * dxr + dzr * dzr
    bq = 2 * (fx * dxr + fz * dzr)
    c = fx * fx + fz * fz - radius * radius
    disc = bq * bq - 4 * a * c
    hit = disc > 0
    tq = (-bq - torch.sqrt(torch.where(hit, disc, torch.zeros_like(disc)))
          ) / (2 * a + 1e-12)
    ylevel = cyy[..., None] + tq * dyr
    valid = hit & (tq > 0) & (ylevel > 0) & (ylevel < h_obj) & draw
    tmin, j = nearest(torch.where(valid, tq, torch.full_like(tq, float(
        "inf"))))
    cyl_hit = tmin < depth
    jj = j[..., None]
    y_hit = torch.gather(ylevel, -1, jj)[..., 0]
    h_hit = h_obj[j]
    cyl_shade = (0.7 + 0.3 * torch.clamp(
        y_hit / torch.clamp(h_hit, min=1e-3), 0, 1))[..., None] * gl
    depth = torch.where(cyl_hit, tmin, depth)

    # ---- mesh hits (nearest triangle nearer than ground and cylinders)
    mesh_hits = nearest_hits(rays, cam_pos, depth, scene.meshes.vertices)

    out = []
    for annotated in variants:
        if procedural:
            code = scene.shade_code[tjc, tic]
            ground = shade(code, cu, cv, annotated)
        else:
            slot = scene.tile_slot[tjc, tic] + (1 if annotated else 0)
            ground = _sample_atlas(scene.atlas, slot, cu, cv)
        # outside the grid: dark floor
        ground = torch.where(in_grid[..., None], ground,
                             _const([60.0, 70.0, 60.0], dev))
        ground = ground * gl
        rgb = torch.where(hits_ground[..., None], ground, sky)

        color = obj[:, 4:7]
        if annotated:
            color = torch.where(obj[:, 7:8] > 0.5,
                                _const(ANNOT_OBSTACLE, dev), color)
        rgb = torch.where(cyl_hit[..., None], color[j] * cyl_shade, rgb)
        rgb = shade_mesh_hits(rgb, mesh_hits, scene.meshes, annotated,
                              ANNOT_OBSTACLE, ground_light)

        # ---- domain randomization: light scale + camera noise
        rgb = rgb * dr.light_rgb[:, None, None, :]
        if noise is not None:
            rgb = rgb + noise * dr.noise_sigma[:, None, None, None]
        out.append(torch.clamp(rgb, 0, 255).to(torch.uint8))
    return out


def render_frame(scene: SceneArrays, pos: torch.Tensor, angle: torch.Tensor,
                 dr: DRParams, noise: torch.Tensor | None = None, *,
                 height: int = 480, width: int = 640,
                 annotated: bool = False, distortion: bool = False,
                 procedural: bool = True) -> torch.Tensor:
    """One uint8 RGB frame (B, H, W, 3) per pose: ``render_pair``'s normal
    (or, with ``annotated``, annotated) frame."""
    return render_pair(scene, pos, angle, dr, noise, height=height,
                       width=width, distortion=distortion,
                       procedural=procedural, variants=(annotated,))[0]
