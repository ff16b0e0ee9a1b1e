"""OBJ/MTL mesh loading and ray-triangle rendering (reference objmesh.py).

Counterpart of the JAX package's ``sim/objmesh.py``.  The reference
loaded OBJ meshes with per-material vertex lists and textures, rendered
through OpenGL display lists, with an annotated texture swap for the
duckiebot mesh (objmesh.py:9-302, :289-302).  Here:

- ``load_obj`` parses OBJ (v/vt/f, negative indices, fan-triangulated
  polygons) and MTL diffuse colours and ``map_Kd`` textures (read by
  ``data/png.py``, resized by cv2's INTER_AREA arithmetic) into flat
  per-triangle arrays;
- ``MeshSet`` packs every mesh instance of a scene into one (T, 3, 3)
  vertex tensor with per-triangle colours, UVs and texture ids and a
  stacked texture atlas;
- ``nearest_hits`` runs the Moller-Trumbore test over chunks of
  triangles at once, keeping each pixel's nearest hit (the lowest
  triangle index among equal distances, as a sequential scan with a strict
  ``t < best`` keeps it); ``shade_mesh_hits`` then shades the hits in one
  pass: UV interpolation and one texture gather per pixel.  Annotated mode swaps
  an obstacle's texture for its annotated one (the reference's
  duckiebot_cv swap) or paints it flat obstacle red.
"""
from __future__ import annotations

import dataclasses
import os
import typing

import numpy as np
import torch

from ..data.png import read_png
from ..ops.resize import resize_area_u8

TEX_RES = 64  # all mesh textures are resampled to this resolution


@dataclasses.dataclass
class ObjMesh:
    vertices: np.ndarray   # (T, 3, 3) float32 triangles (object space)
    colors: np.ndarray     # (T, 3) float32 per-triangle diffuse RGB 0..255
    uvs: np.ndarray        # (T, 3, 2) float32 texture coords (0 when flat)
    tex_ids: np.ndarray    # (T,) int32 index into ``textures``; -1 = flat
    textures: list         # list of (TEX_RES, TEX_RES, 3) uint8 RGB
    annot_textures: list | None = None  # same length; None entries = flat red

    @property
    def num_triangles(self) -> int:
        return len(self.vertices)


_cache: dict[str, ObjMesh] = {}


def _load_texture_image(path: str) -> np.ndarray | None:
    """A ``map_Kd`` texture as (TEX_RES, TEX_RES, 3) uint8 RGB; None
    where the file is missing (cv2.imread's None)."""
    if not os.path.isfile(path):
        return None
    img = resize_area_u8(torch.from_numpy(read_png(path)), TEX_RES,
                         TEX_RES).numpy()
    return img[:, :, ::-1].copy()  # BGR -> RGB


def load_mtl(path: str) -> dict[str, dict]:
    """name -> {'Kd': rgb 0..255, 'map_Kd': image path or None}"""
    mats, cur = {}, None
    if not os.path.exists(path):
        return mats
    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl":
                cur = parts[1]
                mats[cur] = {"Kd": np.asarray([150.0, 150.0, 150.0]),
                             "map_Kd": None}
            elif parts[0] == "Kd" and cur:
                mats[cur]["Kd"] = np.asarray(
                    [float(x) for x in parts[1:4]]) * 255.0
            elif parts[0] == "map_Kd" and cur:
                mats[cur]["map_Kd"] = os.path.join(base, parts[-1])
    return mats


def load_obj(path: str, default_color=(150.0, 150.0, 150.0)) -> ObjMesh:
    """Parse an OBJ file (with optional sibling MTL incl. map_Kd textures)
    into triangle arrays.  Results are cached per path like the
    reference's mesh cache (objmesh.py:17-32)."""
    if path in _cache:
        return _cache[path]
    verts: list = []
    vts: list = []
    tris: list = []
    tri_uv: list = []
    cols: list = []
    tex_of_tri: list = []
    mats: dict = {}
    textures: list = []
    tex_index: dict[str, int] = {}
    color = np.asarray(default_color, np.float64)
    cur_tex = -1
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "mtllib":
                mats = load_mtl(os.path.join(os.path.dirname(path), parts[1]))
            elif parts[0] == "usemtl":
                m = mats.get(parts[1])
                color = m["Kd"] if m else np.asarray(default_color)
                cur_tex = -1
                if m and m["map_Kd"]:
                    tp = m["map_Kd"]
                    if tp not in tex_index:
                        img = _load_texture_image(tp)
                        if img is not None:
                            tex_index[tp] = len(textures)
                            textures.append(img)
                        else:
                            tex_index[tp] = -1
                    cur_tex = tex_index[tp]
            elif parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                vts.append([float(parts[1]), float(parts[2])])
            elif parts[0] == "f":
                idx, uvx = [], []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    i = int(comps[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                    if len(comps) > 1 and comps[1]:
                        j = int(comps[1])
                        uvx.append(j - 1 if j > 0 else len(vts) + j)
                    else:
                        uvx.append(-1)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    tris.append((idx[0], idx[k], idx[k + 1]))
                    tri_uv.append((uvx[0], uvx[k], uvx[k + 1]))
                    cols.append(color)
                    tex_of_tri.append(cur_tex if uvx[0] >= 0 else -1)
    v = np.asarray(verts, np.float32)
    vt = np.asarray(vts, np.float32) if vts else np.zeros((1, 2), np.float32)
    if tris:
        vertices = v[np.asarray(tris, np.int32)]
        uv_idx = np.asarray(tri_uv, np.int32)
        uvs = np.where((uv_idx >= 0)[..., None], vt[np.maximum(uv_idx, 0)], 0.0)
    else:
        vertices = np.zeros((0, 3, 3), np.float32)
        uvs = np.zeros((0, 3, 2), np.float32)
    mesh = ObjMesh(
        vertices=vertices,
        colors=np.asarray(cols, np.float32) if cols else
        np.zeros((0, 3), np.float32),
        uvs=uvs.astype(np.float32),
        tex_ids=np.asarray(tex_of_tri, np.int32) if tex_of_tri else
        np.zeros((0,), np.int32),
        textures=textures)
    _cache[path] = mesh
    return mesh


def make_box_mesh(sx: float, sy: float, sz: float, color) -> ObjMesh:
    """Procedural axis-aligned box mesh (stand-in geometry when no OBJ
    asset is on disk)."""
    x, y, z = sx / 2, sy, sz / 2
    p = np.array([[-x, 0, -z], [x, 0, -z], [x, 0, z], [-x, 0, z],
                  [-x, y, -z], [x, y, -z], [x, y, z], [-x, y, z]], np.float32)
    faces = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7),
             (0, 1, 5), (0, 5, 4), (1, 2, 6), (1, 6, 5),
             (2, 3, 7), (2, 7, 6), (3, 0, 4), (3, 4, 7)]
    n = len(faces)
    return ObjMesh(vertices=p[np.asarray(faces, np.int32)],
                   colors=np.tile(np.asarray(color, np.float32), (n, 1)),
                   uvs=np.zeros((n, 3, 2), np.float32),
                   tex_ids=np.full((n,), -1, np.int32), textures=[])


def _duckiebot_texture(annotated: bool) -> np.ndarray:
    """Procedural duckiebot skin: blue chassis sides, yellow top deck,
    dark wheel band.  The annotated variant is pure obstacle red — the
    reference's duckiebot_cv texture swap (objmesh.py:289-302)."""
    tex = np.zeros((TEX_RES, TEX_RES, 3), np.uint8)
    if annotated:
        tex[:] = (255, 0, 0)
        return tex
    tex[:] = (50, 60, 160)                      # chassis blue
    tex[: TEX_RES // 3] = (230, 200, 40)        # top deck yellow
    tex[2 * TEX_RES // 3:] = (25, 25, 28)       # wheel band
    yy, xx = np.mgrid[0:TEX_RES, 0:TEX_RES]
    dot = (yy - TEX_RES // 6) ** 2 + (xx - TEX_RES // 2) ** 2 < (TEX_RES // 8) ** 2
    tex[dot] = (200, 60, 40)                    # "camera" marker
    return tex


def make_duckiebot_mesh() -> ObjMesh:
    """UV-textured duckiebot (box proxy geometry, textured skin + the
    annotated texture swap).  Face UVs map the texture's deck band onto
    the top face and the chassis/wheel bands onto the sides."""
    base = make_box_mesh(0.13, 0.12, 0.18, (50, 60, 160))
    uvs = np.zeros((12, 3, 2), np.float32)
    # box face -> texture band: bottom faces (0, 1) wheel band; top (2, 3)
    # deck; sides map the full skin
    band = {0: (0.70, 0.98), 1: (0.70, 0.98), 2: (0.02, 0.30), 3: (0.02, 0.30)}
    full = (0.02, 0.98)
    corner = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]], np.float32)
    for t in range(12):
        lo, hi = band.get(t, full)
        uvs[t, :, 0] = 0.02 + corner[:, 0] * 0.96
        uvs[t, :, 1] = lo + corner[:, 1] * (hi - lo)
    return ObjMesh(vertices=base.vertices, colors=base.colors, uvs=uvs,
                   tex_ids=np.zeros((12,), np.int32),
                   textures=[_duckiebot_texture(False)],
                   annot_textures=[_duckiebot_texture(True)])


def place_mesh(mesh: ObjMesh, pos_xz, rotate_deg: float,
               scale: float = 1.0) -> np.ndarray:
    """Instance a mesh into world space: scale, yaw-rotate, translate.

    Positive rotation is counter-clockwise/leftward (the map-file and
    agent-heading convention: at 0 the mesh faces +x, heading
    (cos a, -sin a) in world (x, z))."""
    a = np.radians(rotate_deg)
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    v = mesh.vertices * scale @ rot.T
    v = v + np.asarray([pos_xz[0], 0.0, pos_xz[1]], np.float32)
    return v




class MeshSet(typing.NamedTuple):
    """All scene mesh triangles packed for the renderer, on one device."""
    vertices: torch.Tensor    # (T, 3, 3)
    colors: torch.Tensor      # (T, 3)
    annotated: torch.Tensor   # (T,) 1.0 when the owning object is an obstacle
    uvs: torch.Tensor         # (T, 3, 2)
    tex_id: torch.Tensor      # (T,) atlas index, -1 = flat colour
    tex_id_annot: torch.Tensor  # (T,) atlas index in annotated mode
    atlas: torch.Tensor       # (K, TEX_RES, TEX_RES, 3) float32

    @property
    def num_triangles(self) -> int:
        return self.vertices.shape[0]

    @staticmethod
    def empty(device=None) -> "MeshSet":
        """One triangle far away, which no ray hits."""
        far = np.full((1, 3, 3), 1e9, np.float32)
        return MeshSet._of(far, np.zeros((1, 3), np.float32),
                           np.zeros((1,), np.float32),
                           np.zeros((1, 3, 2), np.float32),
                           np.full((1,), -1, np.int64),
                           np.full((1,), -1, np.int64),
                           np.zeros((1, TEX_RES, TEX_RES, 3), np.float32),
                           device)

    @staticmethod
    def _of(*arrays_and_device) -> "MeshSet":
        *arrays, device = arrays_and_device
        return MeshSet(*(torch.as_tensor(a, device=device) for a in arrays))

    @staticmethod
    def build(instances, device=None) -> "MeshSet":
        """instances: list of (world_vertices (T,3,3), mesh: ObjMesh,
        annotated flag)."""
        if not instances:
            return MeshSet.empty(device)
        vs, cs, fl, uv, tid, tid_a = [], [], [], [], [], []
        atlas: list = []
        for world_v, mesh, flag in instances:
            n = len(world_v)
            off = len(atlas)
            atlas.extend(mesh.textures)
            ids = np.where(mesh.tex_ids >= 0, mesh.tex_ids + off, -1)
            if mesh.annot_textures is not None:
                ids_a = []
                for t in mesh.annot_textures:
                    if t is None:
                        ids_a.append(-1)
                    else:
                        ids_a.append(len(atlas))
                        atlas.append(t)
                lut = np.asarray(ids_a + [-1], np.int64)
                tri_a = np.where(mesh.tex_ids >= 0, lut[mesh.tex_ids], -1)
            else:
                tri_a = np.full((n,), -1, np.int64)
            vs.append(world_v)
            cs.append(mesh.colors)
            uv.append(mesh.uvs)
            tid.append(ids.astype(np.int64))
            tid_a.append(tri_a.astype(np.int64))
            fl.append(np.full(n, flag, np.float32))
        if not atlas:
            atlas = [np.zeros((TEX_RES, TEX_RES, 3), np.uint8)]
        return MeshSet._of(
            np.concatenate(vs).astype(np.float32),
            np.concatenate(cs).astype(np.float32),
            np.concatenate(fl), np.concatenate(uv).astype(np.float32),
            np.concatenate(tid), np.concatenate(tid_a),
            np.stack(atlas).astype(np.float32), device)


# elements (pixels x triangles) of one chunk of the triangle test: the
# chunk's intermediates take a few hundred MB each at this size
CHUNK_ELEMENTS = 1 << 26


def nearest(tm: torch.Tensor):
    """Over the last dim of ``tm`` (inf where nothing is hit): the least
    value and the lowest index holding it, which is what a scan in index
    order that replaces only on a strictly nearer hit keeps."""
    tmin = tm.min(-1).values
    order = torch.arange(tm.shape[-1], device=tm.device)
    j = torch.where(tm == tmin[..., None], order, tm.shape[-1]).min(-1).values
    return tmin, j.clamp(max=tm.shape[-1] - 1)


def nearest_hits(rays: torch.Tensor, cam_pos: torch.Tensor,
                 depth: torch.Tensor, vertices: torch.Tensor):
    """Moller-Trumbore over all triangles: per pixel the nearest hit
    closer than ``depth`` and its triangle index (-1 for none) and
    barycentrics (u, w).  ``rays`` (B, H, W, 3), ``cam_pos`` (B, 3),
    ``depth`` (B, H, W), ``vertices`` (T, 3, 3).

    Triangles go in chunks, each tested at once; a chunk's nearest hit
    with the lowest index replaces the running one where it is strictly
    nearer, which is what a scan over triangles in index order keeps."""
    n_tri = vertices.shape[0]
    pixels = depth.numel()
    chunk = max(1, min(n_tri, CHUNK_ELEMENTS // max(pixels, 1)))
    rx, ry, rz = (rays[..., k, None] for k in range(3))   # (B, H, W, 1)
    best_t = depth
    best_i = torch.full_like(depth, -1, dtype=torch.int64)
    best_u = torch.zeros_like(depth)
    best_w = torch.zeros_like(depth)
    for lo in range(0, n_tri, chunk):
        v = vertices[lo:lo + chunk]                          # (C, 3, 3)
        e1 = v[:, 1] - v[:, 0]
        e2 = v[:, 2] - v[:, 0]
        # h = rays x e2, per pixel and triangle
        hx = ry * e2[:, 2] - rz * e2[:, 1]
        hy = rz * e2[:, 0] - rx * e2[:, 2]
        hz = rx * e2[:, 1] - ry * e2[:, 0]
        a = e1[:, 0] * hx + e1[:, 1] * hy + e1[:, 2] * hz
        ok = torch.abs(a) > 1e-9
        f = 1.0 / torch.where(ok, a, torch.full_like(a, 1e-9))
        s = cam_pos[:, None, :] - v[None, :, 0]              # (B, C, 3)
        sb = s[:, None, None]                                # (B,1,1,C,3)
        u = f * (sb[..., 0] * hx + sb[..., 1] * hy + sb[..., 2] * hz)
        q = torch.cross(s, e1[None].expand_as(s), dim=-1)    # (B, C, 3)
        qb = q[:, None, None]
        w = f * (rx * qb[..., 0] + ry * qb[..., 1] + rz * qb[..., 2])
        eq = (e2[None] * q).sum(-1)                          # (B, C)
        t = f * eq[:, None, None]
        valid = ok & (u >= 0) & (w >= 0) & (u + w <= 1) & (t > 1e-4)
        tmin, j = nearest(torch.where(valid, t,
                                      torch.full_like(t, float("inf"))))
        upd = tmin < best_t
        jj = j[..., None]
        best_t = torch.where(upd, tmin, best_t)
        best_i = torch.where(upd, j + lo, best_i)
        best_u = torch.where(upd, torch.gather(u, -1, jj)[..., 0], best_u)
        best_w = torch.where(upd, torch.gather(w, -1, jj)[..., 0], best_w)
    return best_t, best_i, best_u, best_w


def shade_mesh_hits(rgb, hits, meshes: MeshSet, annotated: bool,
                    annot_color, light):
    """The mesh hits ``hits`` of ``nearest_hits`` shaded over ``rgb``
    (B, H, W, 3): per pixel the hit triangle's colour, or its texture at
    the interpolated uv (one gather), scaled by the frame's ``light``
    (B,)."""
    best_t, best_i, best_u, best_w = hits
    hit = best_i >= 0
    idx = best_i.clamp(min=0)

    # Only OBSTACLE-flagged meshes change in annotated mode (the reference
    # swaps just the duckiebot texture, objmesh.py:289-302); everything
    # else renders identically in both frames, or the pixel-diff label
    # extractor would classify the whole silhouette.
    color = meshes.colors[idx]
    if annotated:
        obstacle = meshes.annotated[idx] > 0.5
        color = torch.where(obstacle[..., None],
                            torch.as_tensor(np.asarray(annot_color,
                                                       np.float32),
                                            device=color.device), color)
        tex_id = torch.where(obstacle, meshes.tex_id_annot[idx],
                             meshes.tex_id[idx])
    else:
        tex_id = meshes.tex_id[idx]

    # UV interpolation and one atlas gather per pixel; UVs wrap
    # (GL_REPEAT, the reference GL default) so tiled vt coordinates work
    uvt = meshes.uvs[idx]                      # (B, H, W, 3, 2)
    b0 = (1.0 - best_u - best_w)[..., None]
    uv = (uvt[..., 0, :] * b0 + uvt[..., 1, :] * best_u[..., None]
          + uvt[..., 2, :] * best_w[..., None])
    uv = uv - torch.floor(uv)
    res = meshes.atlas.shape[1]
    ix = (uv[..., 0] * res).to(torch.int64).clamp(0, res - 1)
    # OBJ v-coordinate runs bottom-up; image rows run top-down
    iy = ((1.0 - uv[..., 1]) * res).to(torch.int64).clamp(0, res - 1)
    texel = meshes.atlas[tex_id.clamp(min=0), iy, ix]
    color = torch.where((tex_id >= 0)[..., None], texel, color)

    return torch.where(hit[..., None], color * light[:, None, None, None],
                       rgb)
