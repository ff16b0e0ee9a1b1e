"""The port's gym-style simulator (``sim2real_lane_segment_tpu_torch.sim.
env``, ``npc``, ``wrappers``, ``multimap``, ``server``) against the JAX
package's, on the CPU at small cameras.

Both envs take the same seed, so the spawn search draws the same numpy
numbers; the port's DR draws and camera noise are JAX's, fed in through
``JaxDraws`` (the port's ``EnvDraws`` interface over JAX's keys: one key
split per reset for the DR draw and one for the episode's noise base,
folded with the step count).  Tolerances: positions POSE_TOL m and
headings ANGLE_TOL rad after 32 steps (``test_torch_sim``'s rollout
bounds: the port's lane geometry and physics agree with JAX's to float32
ulps, which the expert's feedback carries on); rewards REWARD_ATOL;
``done`` and ``info["msg"]`` equal; every frame RENDER_EQUAL of its
uint8 values equal (``test_torch_sim``'s renderer bound: a tile edge or
a silhouette flips on the last ulp of a ray; at 60x80 one flipped
silhouette pixel is 1/4800 of the values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sim2real_lane_segment_tpu.sim import env as jenv
from sim2real_lane_segment_tpu.sim import expert as jexpert
from sim2real_lane_segment_tpu.sim import lanes as jlanes
from sim2real_lane_segment_tpu.sim import multimap as jmultimap
from sim2real_lane_segment_tpu.sim import npc as jnpc
from sim2real_lane_segment_tpu.sim import randomization as jrand
from sim2real_lane_segment_tpu.sim import wrappers as jwrappers

from sim2real_lane_segment_tpu_torch.sim import env as tenv
from sim2real_lane_segment_tpu_torch.sim import lanes as tlanes
from sim2real_lane_segment_tpu_torch.sim import multimap as tmultimap
from sim2real_lane_segment_tpu_torch.sim import npc as tnpc
from sim2real_lane_segment_tpu_torch.sim import server as tserver
from sim2real_lane_segment_tpu_torch.sim import wrappers as twrappers
from sim2real_lane_segment_tpu_torch.sim.maps import builtin_map

torch.set_num_threads(2)

POSE_TOL = 1e-4
ANGLE_TOL = 3e-4
REWARD_ATOL = 1e-3
RENDER_EQUAL = 0.9995
H, W = 60, 80


class JaxDraws:
    """``EnvDraws`` over the JAX env's keys, so the port renders with the
    JAX env's DR parameters and camera noise."""

    def __init__(self, seed):
        self.key = jax.random.key(seed)

    def _next(self):
        self.key, k = jax.random.split(self.key)
        return k

    def reset(self, domain_rand, randomizer):
        d = None
        if domain_rand:
            d = {k: np.array(v) for k, v in
                 jrand.Randomizer().randomize(self._next()).items()}
        self.base = self._next()
        return d

    def noise(self, step, height, width):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(self.base, step), (height, width, 3))))[None]


def env_pair(seed, **kw):
    kw = dict(camera_width=W, camera_height=H, seed=seed, **kw)
    return (jenv.DuckietownEnv(**kw),
            tenv.DuckietownEnv(**kw, device="cpu", draws=JaxDraws(seed)))


def expert(env):
    return np.asarray(jexpert.expert_action(
        env.lane_arrays, env.map.tile_size, jnp.asarray(env.cur_pos),
        jnp.asarray(env.cur_angle)))


def agree(a, b):
    return (a == b).mean()


@pytest.mark.parametrize("name", ["loop_dyn_duckiebots", "udem1",
                                  "zigzag"])
def test_spawns_match_jax(name):
    """Ten seeds each: the same spawn position (bit for bit) and heading;
    none diverged at the in-lane or |dist| < 0.25 branches."""
    m = builtin_map(name)
    import sim2real_lane_segment_tpu.sim.maps as jmaps
    jm = jmaps.builtin_map(name)
    for seed in range(10):
        jrng, trng = (np.random.default_rng(seed) for _ in range(2))
        j = _spawn(jenv.Simulator._lane_pos, jm, jlanes.build_lane_arrays(jm),
                   jrng)
        t = _spawn(None, m, tlanes.build_lane_arrays(m), trng)
        np.testing.assert_array_equal(t[0], j[0])
        assert abs(t[1] - j[1]) < 1e-6, (seed, t[1], j[1])


def _spawn(jax_lane_pos, m, la, rng):
    """The spawn search of both envs' reset, without building a scene."""
    env = (jenv.Simulator.__new__(jenv.Simulator) if jax_lane_pos
           else tenv.Simulator.__new__(tenv.Simulator))
    env.map, env.lane_arrays, env.rng = m, la, rng
    env.accept_start_angle_deg = 60.0
    env.domain_rand = False
    env.draws = None
    captured = {}

    def render_obs(*a, **k):
        captured["pose"] = (env.cur_pos, env.cur_angle)

    env.render_obs = render_obs
    if jax_lane_pos:
        env.randomizer = jrand.Randomizer()
        env._key = jax.random.key(0)
    else:
        env.randomizer = None
        env.draws = type("NoDraws", (), {
            "reset": staticmethod(lambda dr, r: {})})()
        env.device = torch.device("cpu")
    env.reset()
    return captured["pose"]


@pytest.mark.parametrize("name,seed,dr", [("loop_dyn_duckiebots", 0, False),
                                          ("udem1", 1, True)])
def test_episode_matches_jax(name, seed, dr):
    """32 expert-driven steps: poses, rewards, endings, frames, and the
    NPCs' object rows and meshes."""
    je, te = env_pair(seed, map_name=name, domain_rand=dr)
    np.testing.assert_array_equal(te.cur_pos, je.cur_pos)
    assert abs(te.cur_angle - je.cur_angle) < 1e-6
    eq = []
    for step in range(32):
        act = expert(je)
        oj, rj, dj, ij = je.step(act)
        ot, rt, dt, it = te.step(act)
        assert (dt, it["msg"]) == (dj, ij["msg"]), step
        np.testing.assert_allclose(te.cur_pos, je.cur_pos, atol=POSE_TOL)
        assert abs(te.cur_angle - je.cur_angle) < ANGLE_TOL
        assert abs(rt - rj) < REWARD_ATOL, (step, rt, rj)
        eq.append(agree(ot, oj))
        if dj:
            break
    assert step == 31 and min(eq) >= RENDER_EQUAL, (step, min(eq))
    np.testing.assert_allclose(te.scene.objects.numpy(),
                               np.asarray(je.scene.objects), atol=1e-4)
    np.testing.assert_allclose(te.scene.meshes.vertices.numpy(),
                               np.asarray(je.scene.meshes.vertices),
                               atol=1e-4)
    # the annotated re-render and the pair share the step's noise
    orig, annot = te.render_pair()
    np.testing.assert_array_equal(orig, te.render_obs(annotated=0))
    np.testing.assert_array_equal(annot, te.render_obs(annotated=1))
    assert agree(annot, je.render_obs(annotated=1)) >= RENDER_EQUAL


def test_npcs_move_their_meshes():
    """``step_npcs`` over 32 ticks on the map with dynamic duckiebots:
    object rows within POSE_TOL of JAX's, the footprint yaw live, and
    only the NPCs' triangles moved."""
    m = builtin_map("loop_dyn_duckiebots")
    import sim2real_lane_segment_tpu.sim.maps as jmaps
    te = tenv.Simulator(map_name="loop_dyn_duckiebots", camera_width=16,
                        camera_height=12, domain_rand=False, device="cpu")
    jm = jmaps.builtin_map("loop_dyn_duckiebots")
    jl = jlanes.build_lane_arrays(jm)
    j_npcs = jenv.Simulator._build_npcs(type("E", (), {"map": jm})())
    t_npcs = te.npcs
    assert [type(n).__name__ for n in t_npcs] == \
        [type(n).__name__ for n in j_npcs]
    assert any(isinstance(n, tnpc.DuckiebotNPC) for n in t_npcs)
    jo = to = te._objects.copy()
    v0 = te.scene.meshes.vertices.clone()
    for _ in range(32):
        jo = jnpc.step_npcs(j_npcs, jo, jl, jm.tile_size)
        to = tnpc.step_npcs(t_npcs, to, te.lane_arrays, m.tile_size)
    np.testing.assert_allclose(to, jo, atol=POSE_TOL)
    for n in t_npcs:
        if isinstance(n, tnpc.DuckiebotNPC):
            assert to[n.obj_index, 11] == np.float32(n.angle)
    # through the env: the scene's rows and the bots' triangles follow
    te.reset()
    for _ in range(3):
        te.step([0.0, 0.0])
    moved = (te.scene.meshes.vertices != v0).any(-1).any(-1)
    owned = torch.zeros_like(moved)
    for n in t_npcs:
        if n.obj_index in te._mesh_layout:
            start, count, _, _ = te._mesh_layout[n.obj_index]
            owned[start:start + count] = True
    assert moved.any() and not (moved & ~owned).any()
    np.testing.assert_array_equal(te.scene.objects.numpy(), te._objects)


def test_invalid_pose_and_max_steps_endings():
    je, te = env_pair(0, map_name="small_loop", domain_rand=False)
    for env in (je, te):   # off the map
        env.cur_pos = np.array([-0.5, -0.5], np.float32)
    oj, rj, dj, ij = je.step([0.3, 0.0])
    ot, rt, dt, it = te.step([0.3, 0.0])
    assert (dt, it["msg"], rt) == (dj, ij["msg"], rj) == (
        True, "invalid-pose", -1000.0)
    assert agree(ot, oj) >= RENDER_EQUAL
    je, te = env_pair(2, map_name="small_loop", domain_rand=False,
                      max_steps=3)
    for i in range(3):
        act = expert(je)
        *_, dj, ij = je.step(act)
        *_, dt, it = te.step(act)
        assert (dt, it["msg"]) == (dj, ij["msg"])
    assert dt and it["msg"] == "max-steps-reached" and te.step_count == 3


def test_wrappers_match_jax():
    je, te = env_pair(0, map_name="small_loop", domain_rand=False)
    jr, tr = jwrappers.ResizeWrapper(je, (30, 40)), \
        twrappers.ResizeWrapper(te, (30, 40))
    np.testing.assert_array_equal(tr.reset(), jr.reset())
    for a in ([0.4, 0.1], [0.3, -0.2]):
        np.testing.assert_array_equal(tr.step(a)[0], jr.step(a)[0])
    sw = (jwrappers.SteeringToWheelVelWrapper(je, trim=0.1),
          twrappers.SteeringToWheelVelWrapper(te, trim=0.1))
    dw = (jwrappers.DiscreteWrapper(je), twrappers.DiscreteWrapper(te))
    for a in ([0.4, 0.3], [1.0, -2.0], [-0.2, 0.0]):
        np.testing.assert_array_equal(sw[1].action(a), sw[0].action(a))
    for a in range(3):
        np.testing.assert_array_equal(dw[1].action(a), dw[0].action(a))
    with pytest.raises(ValueError):
        dw[1].action(3)
    obs = twrappers.ChannelsFirstWrapper(te).observation(te.render_obs())
    assert obs.shape == (3, H, W) and obs.dtype == np.float32
    twrappers.UndistortWrapper(te)
    assert te.distortion is False


def test_multimap_order():
    t = tmultimap.MultiMapEnv(camera_width=16, camera_height=12,
                              domain_rand=False, device="cpu")
    assert t.env_names == sorted(jmultimap.BUILTIN_MAPS)
    seen = []
    for _ in range(len(t.envs) + 1):
        t.reset()
        seen.append(t.env.map.name)
    assert seen[:-1] == t.env_names[1:] + t.env_names[:1]
    assert seen[-1] == t.env_names[1]
    assert t.step([0.1, 0.0])[0].shape == (12, 16, 3)


class FakeSocket:
    """The zmq socket methods ``serve`` and ``DuckiebotEnv`` call: reads
    come from ``inbox``, writes go to ``sent``."""

    def __init__(self, inbox):
        self.inbox, self.sent = list(inbox), []

    def recv_json(self, flags=0):
        return self.inbox.pop(0)

    def recv(self, flags=0):
        return self.inbox.pop(0)

    def send_json(self, obj, flags=0):
        self.sent.append(obj)

    def send(self, data, flags=0, copy=True):
        self.sent.append(bytes(np.ascontiguousarray(data)))


def test_gym_server_and_robot_bridge():
    """``serve`` answers step/reset/close with the env's own frames, byte
    for byte; ``DuckiebotEnv`` reads those replies back."""
    kw = dict(map_name="small_loop", camera_width=32, camera_height=24,
              domain_rand=True, device="cpu")
    actions = [[0.4, 0.1], [0.3, 0.0]]
    sock = FakeSocket([{"cmd": "step", "action": actions[0]},
                       {"cmd": "step", "action": actions[1]},
                       {"cmd": "reset"}, {"cmd": "close"}])
    tserver.serve(tenv.DuckietownEnv(**kw), sock=sock)
    ref = tenv.DuckietownEnv(**kw)
    ref.reset()
    want = [ref.step(a) for a in actions] + [(ref.reset(), 0.0, False, {})]
    replies = sock.sent
    assert replies[-1] == {"ok": True} and len(replies) == 3 * 3 + 1
    for i, (obs, reward, done, _) in enumerate(want):
        meta, header, data = replies[3 * i:3 * i + 3]
        assert meta == {"reward": float(reward), "done": bool(done)}
        assert header == {"dtype": "uint8", "shape": obs.shape}
        assert data == obs.tobytes()

    robot = tserver.DuckiebotEnv(sock=FakeSocket(replies[:6]))
    obs, reward, done, meta = robot.step(actions[0])
    np.testing.assert_array_equal(obs, want[0][0])
    assert (reward, done) == (want[0][1], want[0][2])
    assert robot.sock.sent == [{"cmd": "step", "action": actions[0]}]
    np.testing.assert_array_equal(robot.reset(), want[1][0])
