"""The port's simulator (``sim2real_lane_segment_tpu_torch.sim``) against
the JAX package's, on the CPU.

Maps, lane arrays, the procedural atlas, the shading hash and shade
codes, the distorted ray grid and the meshes are held exactly; one
physics step to a relative 1e-6; 32-step expert rollouts from the same
spawns to POSE_TOL m and ANGLE_TOL rad, and each of their steps taken
from JAX's own pose to STEP_POSE_TOL m and STEP_ANGLE_TOL rad; rendered
frames from the same pose, DR
draws and noise draws (JAX's, fed to the port) to RENDER_EQUAL of uint8
values equal and RENDER_NEAR within one level.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sim2real_lane_segment_tpu.sim import distortion as jdist
from sim2real_lane_segment_tpu.sim import expert as jexpert
from sim2real_lane_segment_tpu.sim import lanes as jlanes
from sim2real_lane_segment_tpu.sim import maps as jmaps
from sim2real_lane_segment_tpu.sim import objmesh as jmesh
from sim2real_lane_segment_tpu.sim import physics as jphys
from sim2real_lane_segment_tpu.sim import render as jrender
from sim2real_lane_segment_tpu.sim import rollout as jrollout
from sim2real_lane_segment_tpu.sim import shading as jshading
from sim2real_lane_segment_tpu.sim import textures as jtex

from sim2real_lane_segment_tpu_torch.sim import distortion as tdist
from sim2real_lane_segment_tpu_torch.sim import expert as texpert
from sim2real_lane_segment_tpu_torch.sim import lanes as tlanes
from sim2real_lane_segment_tpu_torch.sim import maps as tmaps
from sim2real_lane_segment_tpu_torch.sim import objmesh as tmesh
from sim2real_lane_segment_tpu_torch.sim import physics as tphys
from sim2real_lane_segment_tpu_torch.sim import randomization as trand
from sim2real_lane_segment_tpu_torch.sim import render as trender
from sim2real_lane_segment_tpu_torch.sim import rollout as trollout
from sim2real_lane_segment_tpu_torch.sim import shading as tshading
from sim2real_lane_segment_tpu_torch.sim import textures as ttex

torch.set_num_threads(2)

# measured worst cases over the cases below: 0.99991 of the values equal
# and 0.99995 within one level (a tile edge or a silhouette that flips on
# the last ulp of a ray)
RENDER_EQUAL = 0.9995
RENDER_NEAR = 0.9998
# 32 expert steps: positions to 1e-4 m; headings to 3e-4 rad (measured
# worst 6.9e-5 m and 1.5e-4 rad over 32 spawns on 4 maps): near-straight
# driving puts the centre of the ICC arc ~1e3 m away, where one ulp of a
# cosine (or XLA's fused multiply-adds) moves the pose by ~1e-5, and the
# expert's feedback carries that on
POSE_TOL = 1e-4
ANGLE_TOL = 3e-4
# one expert step from JAX's own pose
STEP_POSE_TOL = 1e-4
STEP_ANGLE_TOL = 1e-4
STEP_RTOL = 1e-6


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", sorted(jmaps.BUILTIN_MAPS))
def test_builtin_maps_match(name):
    a, b = jmaps.builtin_map(name), tmaps.builtin_map(name)
    assert (a.name, a.tile_size, a.start_tile) == (b.name, b.tile_size,
                                                  b.start_tile)
    assert [[(x.kind, x.orientation, x.drivable) if x else None for x in r]
            for r in a.tiles] == [[(x.kind, x.orientation, x.drivable)
                                   if x else None for x in r]
                                  for r in b.tiles]
    assert len(a.objects) == len(b.objects)
    for oa, ob in zip(a.objects, b.objects):
        assert (oa.kind, oa.rotate, oa.height, oa.static, oa.mesh) == (
            ob.kind, ob.rotate, ob.height, ob.static, ob.mesh)
        np.testing.assert_array_equal(oa.pos, ob.pos)
    for x, y in zip(jlanes.build_lane_arrays(a), tlanes.build_lane_arrays(b)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    for x, y in zip(jshading.build_shade_arrays(a),
                    tshading.build_shade_arrays(b)):
        np.testing.assert_array_equal(x, y)


def test_load_map_reads_yaml(tmp_path):
    pytest.importorskip("yaml")
    path = tmp_path / "two.yaml"
    path.write_text("tiles:\n- [curve_left/W, straight/W]\n- [grass, 4way]\n"
                    "tile_size: 0.6\nobjects:\n- kind: duckie\n"
                    "  pos: [1.5, 0.5]\n  rotate: 30\n")
    a, b = jmaps.load_map(str(path)), tmaps.load_map(str(path))
    assert b.name == a.name == "two" and b.tile_size == a.tile_size
    assert b.drivable_tiles() == a.drivable_tiles()
    np.testing.assert_array_equal(b.objects[0].pos, a.objects[0].pos)


def test_step_pose_and_duty():
    rng = np.random.default_rng(0)
    n = 64
    pos = rng.uniform(0, 3, (n, 2)).astype(np.float32)
    ang = rng.uniform(-3, 3, n).astype(np.float32)
    act = np.stack([rng.uniform(0, 1, n), rng.uniform(-4, 4, n)],
                   -1).astype(np.float32)
    act[:8, 1] = 0.0   # straight-line branch
    duty_j = np.asarray(jax.vmap(lambda a: jphys.wheel_duty_from_action(
        a[0], a[1]))(act))
    duty_t = tphys.wheel_duty_from_action(t(act[:, 0]), t(act[:, 1]))
    np.testing.assert_allclose(duty_t.numpy(), duty_j, rtol=STEP_RTOL)
    step_j = jax.vmap(lambda p, a, d: jphys.step_pose(
        jphys.AgentState(p, a, d), d, dt=1 / 30))(pos, ang, duty_j)
    step_t = tphys.step_pose(tphys.AgentState(t(pos), t(ang), t(duty_j)),
                             t(duty_j), dt=1 / 30)
    np.testing.assert_allclose(step_t.pos.numpy(), np.asarray(step_j.pos),
                               rtol=STEP_RTOL)
    np.testing.assert_allclose(step_t.angle.numpy(), np.asarray(step_j.angle),
                               rtol=STEP_RTOL, atol=1e-7)


@pytest.mark.parametrize("name", ["4way", "udem1", "zigzag"])
def test_lane_pos_and_expert(name):
    m = jmaps.builtin_map(name)
    la_j, la_t = jlanes.build_lane_arrays(m), tlanes.build_lane_arrays(m)
    rng = np.random.default_rng(1)
    n = 256
    pos = np.stack([rng.uniform(-0.1, m.grid_width * m.tile_size + 0.1, n),
                    rng.uniform(-0.1, m.grid_height * m.tile_size + 0.1, n)],
                   -1).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    # jitted, as the rollout runs it (XLA folds the division by the
    # constant tile size into a product with its reciprocal)
    lp_j = jax.jit(jax.vmap(lambda p, a: jlanes.lane_pos(
        la_j, m.tile_size, p, a)))(pos, ang)
    lp_t = tlanes.lane_pos(la_t, m.tile_size, t(pos), t(ang))
    np.testing.assert_array_equal(lp_t.in_lane.numpy(),
                                  np.asarray(lp_j.in_lane))
    for f in ("dist", "dot_dir", "tangent", "curvature"):
        np.testing.assert_allclose(getattr(lp_t, f).numpy(),
                                   np.asarray(getattr(lp_j, f)), atol=1e-5)
    act_j = jax.jit(jax.vmap(lambda p, a: jexpert.expert_action(
        la_j, m.tile_size, p, a)))(pos, ang)
    act_t = texpert.expert_action(la_t, m.tile_size, t(pos), t(ang))
    np.testing.assert_allclose(act_t.numpy(), np.asarray(act_j), atol=1e-4)


@pytest.mark.parametrize("seed", [0, 9])
def test_procedural_atlas_exact(seed):
    a, ia = jtex.build_atlas(seed)
    b, ib = ttex.build_atlas(seed)
    assert ia == ib
    np.testing.assert_array_equal(a, b)


def test_hash_noise_exact_and_shade():
    ix = np.arange(-300, 300, dtype=np.int32)[:, None]
    iy = np.arange(-200, 200, 3, dtype=np.int32)[None, :]
    np.testing.assert_array_equal(
        tshading._hash_noise(t(ix), t(iy), 1.0).numpy(),
        np.asarray(jshading._hash_noise(jnp.asarray(ix), jnp.asarray(iy),
                                        1.0)))
    rng = np.random.default_rng(2)
    uv = rng.uniform(0, 1, (64, 64, 2)).astype(np.float32)
    code = rng.integers(0, 8, (64, 64)).astype(np.int32)
    for annotated in (False, True):
        a = np.asarray(jshading.shade(jnp.asarray(code), jnp.asarray(uv),
                                      annotated))
        b = tshading.shade(t(code), t(uv[..., 0]), t(uv[..., 1]),
                           annotated).numpy()
        np.testing.assert_allclose(b, a, atol=1e-4)


def test_distorted_ray_grid_exact():
    for h, w in ((48, 64), (120, 160)):
        np.testing.assert_array_equal(tdist.distorted_ray_grid(h, w),
                                      jdist.distorted_ray_grid(h, w))
        np.testing.assert_array_equal(
            trender.make_ray_grid(h, w), jrender.make_ray_grid(h, w))
    for a, b in zip(tdist.undistort_maps(48, 64), jdist.undistort_maps(48, 64)):
        np.testing.assert_array_equal(a, b)


def test_meshes_and_scene_triangles():
    for a, b in ((jmesh.make_duckiebot_mesh(), tmesh.make_duckiebot_mesh()),
                 (jmesh.make_box_mesh(0.2, 0.3, 0.4, (1, 2, 3)),
                  tmesh.make_box_mesh(0.2, 0.3, 0.4, (1, 2, 3)))):
        for f in ("vertices", "colors", "uvs", "tex_ids"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(jmesh.place_mesh(a, (1.0, 2.0), 30),
                                      tmesh.place_mesh(b, (1.0, 2.0), 30))
    # triangles of the builtin scenes: two duckiebots and a barrier; a
    # duckiebot and a barrier
    counts = {}
    for name in ("loop_dyn_duckiebots", "loop_obstacles", "zigzag"):
        sj = jrender.build_scene(jmaps.builtin_map(name), 0)
        st = trender.build_scene(tmaps.builtin_map(name), 0)
        for f in sj.meshes._fields:
            np.testing.assert_array_equal(getattr(st.meshes, f).numpy(),
                                          np.asarray(getattr(sj.meshes, f)))
        for f in ("atlas", "tile_slot", "tile_rot", "shade_code", "objects"):
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(sj, f)))
        counts[name] = st.meshes.num_triangles
    assert counts == {"loop_dyn_duckiebots": 36, "loop_obstacles": 24,
                      "zigzag": 1}   # zigzag: the inert far triangle


def test_load_obj_with_texture(tmp_path):
    rng = np.random.default_rng(3)
    cv2.imwrite(str(tmp_path / "skin.png"),
                rng.integers(0, 256, (100, 90, 3), dtype=np.uint8))
    (tmp_path / "m.mtl").write_text(
        "newmtl a\nKd 0.5 0.25 1.0\nmap_Kd skin.png\nnewmtl b\nKd 1 0 0\n")
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl a\nf 1/1 2/2 3/3 4/4\n"
        "usemtl b\nf -1 -2 -3\n")
    path = str(tmp_path / "m.obj")
    a, b = jmesh.load_obj(path), tmesh.load_obj(path)
    for f in ("vertices", "colors", "uvs", "tex_ids"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(b.textures) == 1
    cv2.ipp.setUseIPP(False)   # OpenCV's own INTER_AREA, which the port repeats
    try:
        np.testing.assert_array_equal(jmesh._load_texture_image(
            str(tmp_path / "skin.png")), b.textures[0])
    finally:
        cv2.ipp.setUseIPP(True)


def _scan_hits(rays, cam, depth, verts):
    """The JAX package's sequential Moller-Trumbore scan, in numpy."""
    best_t, best_i = depth.copy(), np.full(depth.shape, -1)
    for i, v in enumerate(verts):
        e1, e2 = v[1] - v[0], v[2] - v[0]
        h = np.cross(rays, e2)
        a = (e1 * h).sum(-1)
        f = 1.0 / np.where(np.abs(a) > 1e-9, a, 1e-9)
        s = cam - v[0]
        u = f * (s * h).sum(-1)
        q = np.cross(s, e1)
        w = f * (rays * q).sum(-1)
        tt = f * (e2 * q).sum()
        ok = ((np.abs(a) > 1e-9) & (u >= 0) & (w >= 0) & (u + w <= 1)
              & (tt > 1e-4) & (tt < best_t))
        best_t = np.where(ok, tt, best_t)
        best_i = np.where(ok, i, best_i)
    return best_t, best_i


@pytest.mark.parametrize("chunk_elements", [1, 1 << 26])
def test_nearest_hits_keep_lowest_index(monkeypatch, chunk_elements):
    """Chunks of triangles give the scan's hits, and among triangles at
    the same distance the lowest index wins (a duplicate triangle)."""
    monkeypatch.setattr(tmesh, "CHUNK_ELEMENTS", chunk_elements)
    scene = trender.build_scene(tmaps.builtin_map("loop_dyn_duckiebots"), 0)
    verts = scene.meshes.vertices.numpy()
    verts = np.concatenate([verts[:5], verts[3:4], verts[5:]])  # dup of 3
    rays = trender.rotate_rays(trender._ray_grid(24, 32, False,
                                                 torch.device("cpu")),
                               -19.15, torch.tensor([2.4])).numpy()[0]
    cam = np.array([2.63, 0.108, 3.37], np.float32)
    depth = np.full((24, 32), np.inf, np.float32)
    bt, bi, _, _ = tmesh.nearest_hits(t(rays)[None], t(cam)[None],
                                      t(depth)[None], t(verts))
    rt, ri = _scan_hits(rays, cam, depth, verts)
    assert (ri >= 0).sum() > 20
    np.testing.assert_array_equal(bi[0].numpy(), ri)
    np.testing.assert_allclose(bt[0].numpy(), rt, rtol=1e-5)
    assert not (bi[0].numpy() == 5).any()   # the duplicate never wins


def test_randomizer_ranges():
    g = torch.Generator().manual_seed(0)
    d = trand.Randomizer().randomize(g, 4096)
    assert sorted(d) == sorted(trand.DEFAULT_DR_CONFIG)
    assert d["horz_mode"].min() == 0 and d["horz_mode"].max() == 3
    # the reference's exclusive int high: frame_skip (1, 2) is always 1
    assert (d["frame_skip"] == 1).all()
    for name in ("light_pos", "light_scale", "camera_noise",
                 "horizon_shift"):
        spec = trand.DEFAULT_DR_CONFIG[name]
        lo = torch.as_tensor(spec["low"], dtype=torch.float32)
        hi = torch.as_tensor(spec["high"], dtype=torch.float32)
        assert (d[name] >= lo).all() and (d[name] <= hi).all()
        assert d[name].shape[0] == 4096
    dr = trender.DRParams.sample(torch.Generator().manual_seed(1), 3)
    assert dr.light_rgb.shape == (3, 3) and dr.horz_mode.dtype == torch.int64
    dflt = trender.DRParams.from_draws(trand.Randomizer().defaults(2), 2)
    for a, b in zip(dflt, trender.DRParams.default(2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _jax_dr_noise(key, h, w):
    kd, kn = jax.random.split(key)
    dr = jrender.DRParams.sample(kd)
    return dr, kn, np.asarray(jax.random.normal(kn, (h, w, 3)))


def _port_dr(dr):
    return trender.DRParams(*(
        t(np.asarray(f))[None].to(torch.int64 if np.asarray(f).dtype.kind
                                  == "i" else torch.float32) for f in dr))


def _agree(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return (d == 0).mean(), (d <= 1).mean()


CASES = [("loop_dyn_duckiebots", 48, 64, True, True),
         ("loop_dyn_duckiebots", 120, 160, True, True),
         ("zigzag", 120, 160, True, True),
         ("zigzag", 48, 64, False, False),
         ("udem1", 48, 64, True, False),
         ("4way", 48, 64, False, True)]


@pytest.mark.parametrize("name,h,w,procedural,distortion", CASES)
def test_render_matches_jax(name, h, w, procedural, distortion):
    m = jmaps.builtin_map(name)
    sj, st = jrender.build_scene(m, 0), trender.build_scene(m, 0)
    pos, ang = jrollout.sample_spawns(m, jlanes.build_lane_arrays(m),
                                      np.random.default_rng(1), 2)
    for b in range(2):
        dr, kn, noise = _jax_dr_noise(jax.random.key(b), h, w)
        got = trender.render_pair(
            st, t(pos[b])[None], t(ang[b])[None], _port_dr(dr),
            t(noise)[None], height=h, width=w, distortion=distortion,
            procedural=procedural)
        for ann, frame in zip((False, True), got):
            ref = np.asarray(jrender.render_frame(
                sj, pos[b], ang[b], dr, kn, height=h, width=w,
                annotated=ann, distortion=distortion, procedural=procedural))
            eq, near = _agree(frame[0].numpy(), ref)
            assert eq >= RENDER_EQUAL and near >= RENDER_NEAR, (ann, eq, near)


def test_render_texture_pack_matches_jax(tmp_path):
    """A photo pack the JAX package wrote, loaded by both packages (the
    atlases equal), rendered through the atlas path."""
    pack = jtex.generate_photo_pack(str(tmp_path / "pack"), seed=9)
    a, ia = jtex.build_atlas_from_pack(pack, 9)
    b, ib = ttex.build_atlas_from_pack(pack, 9)
    assert ia == ib
    np.testing.assert_array_equal(a, b)
    m = jmaps.builtin_map("zigzag")
    sj = jrender.build_scene(m, 9, texture_pack=pack)
    st = trender.build_scene(m, 9, texture_pack=pack)
    pos, ang = jrollout.sample_spawns(m, jlanes.build_lane_arrays(m),
                                      np.random.default_rng(4), 1)
    dr, kn, noise = _jax_dr_noise(jax.random.key(7), 48, 64)
    got = trender.render_frame(st, t(pos), t(ang), _port_dr(dr), t(noise)[None],
                               height=48, width=64, distortion=True,
                               procedural=False)[0].numpy()
    ref = np.asarray(jrender.render_frame(
        sj, pos[0], ang[0], dr, kn, height=48, width=64, distortion=True,
        procedural=False))
    eq, near = _agree(got, ref)
    assert eq >= RENDER_EQUAL and near >= RENDER_NEAR, (eq, near)


def test_photo_pack_matches_jax(tmp_path):
    """The port's photo pack against the JAX package's: the same files,
    every texel within one level (the float32 INTER_CUBIC noise, which a
    cv2 with IPP sums in another order, ends in a uint8 truncation)."""
    a = jtex.generate_photo_pack(str(tmp_path / "a"), seed=9)
    b = ttex.generate_photo_pack(str(tmp_path / "b"), seed=9)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 12
    near = []
    for f in names:
        x = cv2.imread(os.path.join(a, f)).astype(np.int16)
        y = cv2.imread(os.path.join(b, f)).astype(np.int16)
        assert np.abs(x - y).max() <= 1, f
        near.append((x == y).mean())
    assert min(near) >= 0.999, near


def test_spawns_and_rollout_poses():
    """Spawns from the same numpy draws equal; 32 expert steps from them
    within POSE_TOL."""
    for name in ("loop_dyn_duckiebots", "zigzag", "4way"):
        m = jmaps.builtin_map(name)
        la_j, la_t = jlanes.build_lane_arrays(m), tlanes.build_lane_arrays(m)
        pj, aj = jrollout.sample_spawns(m, la_j, np.random.default_rng(5), 4)
        pt, at = trollout.sample_spawns(m, la_t, np.random.default_rng(5), 4)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-6)
        ref = jrollout.expert_rollout(
            jrender.build_scene(m, 0), la_j, jax.random.key(0), pj, aj,
            tile_size=m.tile_size, n_steps=32, height=4, width=4)
        pos, ang = trollout.step_poses(la_t, m.tile_size, pt, at, 32)
        np.testing.assert_allclose(pos.numpy(), np.asarray(ref.pos),
                                   atol=POSE_TOL)
        np.testing.assert_allclose(ang.numpy(), np.asarray(ref.angle),
                                   atol=ANGLE_TOL)


@pytest.mark.parametrize("name", ["loop_dyn_duckiebots", "zigzag", "4way",
                                  "udem1"])
def test_one_expert_step_from_jax_poses(name):
    """Teacher-forced: each of JAX's 32 expert steps from 8 spawns is
    taken again by the port from JAX's own pose before it, and lands
    within STEP_POSE_TOL m and STEP_ANGLE_TOL rad of JAX's.  This holds
    each single step, where the free-running gate above also holds the
    drift that the expert's feedback carries on."""
    m = jmaps.builtin_map(name)
    la_j, la_t = jlanes.build_lane_arrays(m), tlanes.build_lane_arrays(m)
    pj, aj = jrollout.sample_spawns(m, la_j, np.random.default_rng(6), 8)
    ref = jrollout.expert_rollout(
        jrender.build_scene(m, 0), la_j, jax.random.key(0), pj, aj,
        tile_size=m.tile_size, n_steps=32, height=4, width=4)
    pos_j, ang_j = np.asarray(ref.pos), np.asarray(ref.angle)  # (32, 8, ...)
    before_pos = np.concatenate([np.asarray(pj)[None], pos_j[:-1]])
    before_ang = np.concatenate([np.asarray(aj)[None], ang_j[:-1]])
    pos, ang = trollout.step_poses(la_t, m.tile_size,
                                   t(before_pos.reshape(-1, 2)),
                                   t(before_ang.reshape(-1)), 1)
    np.testing.assert_allclose(pos[0].numpy(), pos_j.reshape(-1, 2),
                               atol=STEP_POSE_TOL)
    np.testing.assert_allclose(ang[0].numpy(), ang_j.reshape(-1),
                               atol=STEP_ANGLE_TOL)


def test_rollout_batches_and_pair_alignment(monkeypatch):
    """The frames do not depend on the render batch; each frame is
    ``render_pair`` of its pose with its agent's DR row and its noise
    draw; orig and annot differ only on lane and obstacle pixels."""
    m = tmaps.builtin_map("loop_dyn_duckiebots")
    scene, la = trender.build_scene(m, 0), tlanes.build_lane_arrays(m)
    pos, ang = trollout.sample_spawns(m, la, np.random.default_rng(6), 2)
    kw = dict(tile_size=m.tile_size, n_steps=3, height=24, width=32,
              distortion=True)
    monkeypatch.setattr(trollout, "RENDER_PIXELS", 24 * 32)   # one frame
    a = trollout.expert_rollout(scene, la, torch.Generator().manual_seed(3),
                                pos, ang, **kw)
    monkeypatch.setattr(trollout, "RENDER_PIXELS", 4 * 24 * 32)
    b = trollout.expert_rollout(scene, la, torch.Generator().manual_seed(3),
                                pos, ang, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    g = torch.Generator().manual_seed(3)
    dr = trender.DRParams.sample(g, 2)
    noise = torch.randn((6, 24, 32, 3), generator=g)
    frames = trender.render_pair(scene, a.pos.reshape(6, 2),
                                 a.angle.reshape(6), dr.index(
                                     torch.arange(6) % 2), noise,
                                 height=24, width=32, distortion=True)
    np.testing.assert_array_equal(frames[0].numpy(),
                                  a.orig.reshape(6, 24, 32, 3).numpy())
    np.testing.assert_array_equal(frames[1].numpy(),
                                  a.annot.reshape(6, 24, 32, 3).numpy())
    c = trollout.expert_rollout(scene, la, torch.Generator().manual_seed(3),
                                pos, ang, domain_rand=False, **kw)
    # without noise or DR, orig and annot agree off the lanes/obstacles
    diff = (c.orig.int() - c.annot.int()).abs().sum(-1) > 0
    # annotated lanes and obstacles are pure green, blue or red, shaded
    lane_or_obstacle = (c.annot == 0).sum(-1) >= 2
    assert diff.any() and not (diff & ~lane_or_obstacle).any()
