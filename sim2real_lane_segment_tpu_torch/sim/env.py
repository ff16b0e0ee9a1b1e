"""Gym-style simulator environment.

Counterpart of the JAX package's ``sim/env.py``, the rebuild of the
reference ``Simulator(gym.Env)`` (simulator.py:127) and ``DuckietownEnv``
(envs/duckietown_env.py:9): reset with a spawn search over drivable tiles
(simulator.py:484-529, at most MAX_SPAWN_ATTEMPTS tries), a step of
frame_skip physics updates, a render and the reward (simulator.py:
1358-1379), reward = speed * dot_dir - 10 |dist| + 40 * col_penalty and
-1000 on an invalid pose (compute_reward :1339-1356), domain
randomization per reset, and the fork's ``annotated`` mode rendering the
recoloured world for pixel-aligned pair capture.

A fixed reference quirk (SURVEY.md section 7): the reference never
incremented ``step_count``, so ``max_steps`` was dead code
(simulator.py:1248,1390); here steps count and the episode truncates.

Where things live: the scene (tile grid, objects, meshes) and every
render are on ``device`` (default ``cuda``); the pose, the NPCs, the lane
geometry, the collision tests and the reward are float32 tensors on the
host, so a step copies one pose to the device and one frame back.  The
lane position of a step's pose is computed once and shared by the
validity test, the reward and the info dict (the JAX env evaluates it
three times, to the same values).

Randomness: the spawn search draws from ``np.random.default_rng(seed)``
exactly as the JAX env does, so a seed gives the same spawns.  The
domain-randomization draws of each reset and the camera noise of each
step come from ``draws`` (default ``EnvDraws``: one ``torch.Generator``),
which a caller may replace to feed in other draws, the JAX package's
among them.  For bulk data generation use ``sim.rollout``, which renders
batches of poses at once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.runtime import resolve_device
from . import collision, lanes, npc as npc_mod, physics, render
from .maps import Map, builtin_map
from .objmesh import place_mesh
from .randomization import Randomizer

MAX_SPAWN_ATTEMPTS = 5000
REWARD_INVALID_POSE = -1000.0
DT = 1.0 / 30.0


class EnvDraws:
    """The env's random draws from one ``torch.Generator`` on ``device``:
    each reset's domain-randomization draw and each step's camera noise
    (standard normal, one (1, H, W, 3) draw per step, shared by every
    render of that step)."""

    def __init__(self, seed: int = 0, device="cpu"):
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def reset(self, domain_rand: bool, randomizer: Randomizer):
        """A new episode: the Randomizer draw dict, or None without
        domain randomization."""
        return randomizer.randomize(self.generator, 1) if domain_rand \
            else None

    def noise(self, step: int, height: int, width: int) -> torch.Tensor:
        return torch.randn((1, height, width, 3), generator=self.generator,
                           device=self.generator.device)


class Simulator:
    """Single-agent gym-style env; obs = (camera_height, camera_width, 3)
    uint8 RGB numpy frames."""

    def __init__(self, map_name: str = "small_loop", *, seed: int = 0,
                 camera_width: int = 640, camera_height: int = 480,
                 frame_skip: int = 1, max_steps: int = 1500,
                 domain_rand: bool = True, annotated: int = 0,
                 distortion: bool = False, map_obj: Map | None = None,
                 accept_start_angle_deg: float = 60.0,
                 randomization_config_fp: str | None = None,
                 default_config_fp: str | None = None,
                 texture_pack: str | None = None, device=None,
                 draws=None):
        self.device = resolve_device(device)
        self.randomizer = Randomizer(randomization_config_fp,
                                     default_config_fp)
        self.map = map_obj if map_obj is not None else builtin_map(map_name)
        # photographic texture packs render through the atlas gather; the
        # default procedural path shades tiles in closed form
        self.texture_pack = texture_pack
        self.procedural = texture_pack is None
        self.scene, self._mesh_layout = render.build_scene(
            self.map, seed, with_layout=True, texture_pack=texture_pack,
            device=self.device)
        self._objects = self.scene.objects.cpu().numpy().copy()   # host
        self.lane_arrays = lanes.build_lane_arrays(self.map)   # host
        self.camera_width = camera_width
        self.camera_height = camera_height
        self.frame_skip = frame_skip
        self.max_steps = max_steps
        self.domain_rand = domain_rand
        self.annotated = annotated  # 0 normal, 1/2 annotated variants
        self.distortion = distortion
        self.accept_start_angle_deg = accept_start_angle_deg
        self.rng = np.random.default_rng(seed)
        self.draws = draws if draws is not None else EnvDraws(seed,
                                                              self.device)
        self.step_count = 0
        self.cur_pos = np.zeros(2, np.float32)
        self.cur_angle = 0.0
        self.speed = 0.0
        self.npcs = self._build_npcs()
        self.reset()

    def _build_npcs(self) -> list:
        """Dynamic objects of the map: non-static duckiebots become
        lane-following NPCs, non-static duckies walking pedestrians, and
        'trafficlight' objects lights (reference objects.py)."""
        npcs = []
        ts = self.map.tile_size
        for i, o in enumerate(self.map.objects):
            if o.kind == "duckiebot" and not o.static:
                npcs.append(npc_mod.DuckiebotNPC(
                    pos=np.asarray(o.pos, np.float32) * ts,
                    angle=np.radians(o.rotate), obj_index=i))
            elif o.kind == "duckie" and not o.static:
                base = np.asarray(o.pos, np.float32) * ts
                d = np.radians(o.rotate)
                offset = np.array([np.cos(d), -np.sin(d)], np.float32) * 0.2
                npcs.append(npc_mod.DuckiePedestrian(
                    start=base - offset, end=base + offset, obj_index=i))
            elif o.kind == "trafficlight":
                npcs.append(npc_mod.TrafficLight(obj_index=i))
        return npcs

    def _step_npcs(self) -> None:
        if not self.npcs:
            return
        self._objects = npc_mod.step_npcs(self.npcs, self._objects,
                                          self.lane_arrays,
                                          self.map.tile_size)
        self.scene.objects.copy_(torch.from_numpy(self._objects))
        # dynamic duckiebots own mesh triangles: re-place only those at the
        # NPC's new pose, a slice copy on the device
        verts = self.scene.meshes.vertices
        for n in self.npcs:
            if (isinstance(n, npc_mod.DuckiebotNPC)
                    and n.obj_index in self._mesh_layout):
                start, count, mesh, _ = self._mesh_layout[n.obj_index]
                verts[start:start + count].copy_(torch.from_numpy(
                    place_mesh(mesh, n.pos, np.degrees(n.angle))))

    # -- helpers ------------------------------------------------------------

    def _lane_pos(self, pos, angle) -> lanes.LanePos:
        return lanes.lane_pos(
            self.lane_arrays, self.map.tile_size,
            torch.as_tensor(np.asarray(pos, np.float32)),
            torch.tensor(angle, dtype=torch.float32))

    def _valid_pose(self, pos, angle, lp: lanes.LanePos | None = None
                    ) -> bool:
        lp = self._lane_pos(pos, angle) if lp is None else lp
        if not (bool(lp.in_lane) and abs(float(lp.dist)) < 0.5):
            return False
        return not bool(collision.collides_with_objects(
            torch.as_tensor(np.asarray(pos, np.float32)),
            torch.tensor(angle, dtype=torch.float32),
            torch.from_numpy(self._objects)))

    # -- gym API ------------------------------------------------------------

    def reset(self):
        d = self.draws.reset(self.domain_rand, self.randomizer)
        if d is None:
            d = self.randomizer.defaults(1)
        self.dr = render.DRParams.from_draws(d, 1, self.device)
        # read once per episode, so that steps need no device sync
        self._skip = int(self.dr.frame_skip[0])
        self._noisy = float(self.dr.noise_sigma[0]) != 0.0
        self._noise_at = (-1, None)

        drivable = self.map.drivable_tiles()
        if not drivable:
            raise RuntimeError("map has no drivable tiles")
        for _ in range(MAX_SPAWN_ATTEMPTS):
            if self.map.start_tile is not None:
                i, j = self.map.start_tile
            else:
                i, j = drivable[self.rng.integers(len(drivable))]
            ts = self.map.tile_size
            pos = np.array([(i + self.rng.uniform(0.2, 0.8)) * ts,
                            (j + self.rng.uniform(0.2, 0.8)) * ts], np.float32)
            # lanes are two-way: a random probe heading picks which
            # direction's lane curve the spawn aligns to
            lp = self._lane_pos(pos, self.rng.uniform(0.0, 2 * np.pi))
            if not bool(lp.in_lane):
                continue
            # face along the lane tangent +- the accept angle
            tangent = lp.tangent.numpy()
            base = float(np.arctan2(-tangent[1], tangent[0]))
            angle = base + np.radians(
                self.rng.uniform(-self.accept_start_angle_deg,
                                 self.accept_start_angle_deg))
            if abs(float(lp.dist)) < 0.25:
                break
        else:
            raise RuntimeError(
                f"could not find a valid spawn in {MAX_SPAWN_ATTEMPTS} attempts")

        self.cur_pos = pos
        self.cur_angle = angle
        self.speed = 0.0
        self.step_count = 0
        return self.render_obs()

    def update_physics(self, action):
        act = torch.as_tensor(np.asarray(action, np.float32))
        state = physics.AgentState(
            pos=torch.from_numpy(self.cur_pos),
            angle=torch.tensor(self.cur_angle, dtype=torch.float32),
            vels=act)
        new = physics.step_pose(state, act, dt=DT)
        new_pos = new.pos.numpy().astype(np.float32)
        self.speed = float(np.linalg.norm(new_pos - self.cur_pos) * 30.0)
        self.cur_pos = new_pos
        self.cur_angle = float(new.angle)

    def compute_reward(self, lp: lanes.LanePos | None = None) -> float:
        """reference compute_reward (simulator.py:1339-1356):
        speed * dot_dir - 10 |dist| + 40 col_penalty; off the lane
        40 col_penalty."""
        col = float(collision.proximity_penalty(
            torch.from_numpy(self.cur_pos),
            torch.tensor(self.cur_angle, dtype=torch.float32),
            torch.from_numpy(self._objects)))
        lp = self._lane_pos(self.cur_pos, self.cur_angle) if lp is None \
            else lp
        if not bool(lp.in_lane):
            return 40.0 * col
        return float(1.0 * self.speed * float(lp.dot_dir)
                     - 10.0 * abs(float(lp.dist)) + 40.0 * col)

    def step(self, action):
        action = np.clip(np.asarray(action, np.float32), -1, 1)
        # under domain randomization the DR draw REPLACES the configured
        # frame skip (reference simulator.py:1363-1369)
        skip = self._skip if self.domain_rand else self.frame_skip
        for _ in range(skip):
            self.update_physics(action)
        self._step_npcs()
        self.step_count += 1

        obs = self.render_obs()
        lp = self._lane_pos(self.cur_pos, self.cur_angle)
        if not self._valid_pose(self.cur_pos, self.cur_angle, lp):
            return obs, REWARD_INVALID_POSE, True, \
                {"msg": "invalid-pose", "Simulator": self._info(lp)}
        if self.step_count >= self.max_steps:
            return obs, 0.0, True, \
                {"msg": "max-steps-reached", "Simulator": self._info(lp)}
        return obs, self.compute_reward(lp), False, \
            {"msg": "in-progress", "Simulator": self._info(lp)}

    def _info(self, lp: lanes.LanePos | None = None):
        lp = self._lane_pos(self.cur_pos, self.cur_angle) if lp is None \
            else lp
        return {"robot_speed": self.speed,
                "cur_pos": self.cur_pos.tolist(),
                "cur_angle": self.cur_angle,
                "lane_dist": float(lp.dist), "dot_dir": float(lp.dot_dir)}

    def _camera_noise(self) -> torch.Tensor | None:
        """This step's noise draw on the device (None when the episode's
        noise sigma is 0): drawn once per step, so that every render of
        the step (a pair, a re-render) shares it."""
        if not self._noisy:
            return None
        if self._noise_at[0] != self.step_count:
            self._noise_at = (self.step_count, self.draws.noise(
                self.step_count, self.camera_height,
                self.camera_width).to(self.device))
        return self._noise_at[1]

    def _pose(self):
        return (torch.tensor(self.cur_pos[None], device=self.device),
                torch.tensor([self.cur_angle], dtype=torch.float32,
                             device=self.device))

    def render_obs(self, annotated: int | None = None) -> np.ndarray:
        """The camera frame at the current pose; ``annotated`` overrides
        the env's mode (the reference's render_obs(use_last_noise=True)
        re-render: same DR parameters, same noise)."""
        ann = self.annotated if annotated is None else annotated
        frame = render.render_frame(
            self.scene, *self._pose(), self.dr, self._camera_noise(),
            height=self.camera_height, width=self.camera_width,
            annotated=bool(ann), distortion=self.distortion,
            procedural=self.procedural)
        return frame[0].cpu().numpy()

    def render_pair(self) -> tuple[np.ndarray, np.ndarray]:
        """Pixel-aligned (orig, annotated) frames at the current pose."""
        orig, annot = render.render_pair(
            self.scene, *self._pose(), self.dr, self._camera_noise(),
            height=self.camera_height, width=self.camera_width,
            distortion=self.distortion, procedural=self.procedural)
        return orig[0].cpu().numpy(), annot[0].cpu().numpy()


def wheel_duty(velocity: float, steering: float, *, gain=1.0, trim=0.0,
               radius=0.0318, k=27.0, limit=1.0,
               wheel_dist=physics.WHEEL_DIST) -> np.ndarray:
    """DuckietownEnv's action conversion on one host action: (2,) float32
    duties (left, right), computed as the JAX env computes it, in Python
    floats, then clipped and rounded to float32."""
    omega_r = (velocity + 0.5 * steering * wheel_dist) / radius
    omega_l = (velocity - 0.5 * steering * wheel_dist) / radius
    u_r = np.clip(omega_r * ((gain + trim) / k), -limit, limit)
    u_l = np.clip(omega_l * ((gain - trim) / k), -limit, limit)
    return np.asarray([u_l, u_r], np.float32)


class DuckietownEnv(Simulator):
    """(velocity, steering) action interface (envs/duckietown_env.py:9-84)."""

    def __init__(self, *, gain=1.0, trim=0.0, radius=0.0318, k=27.0,
                 limit=1.0, **kw):
        self.gain, self.trim, self.radius = gain, trim, radius
        self.k, self.limit = k, limit
        super().__init__(**kw)

    def step(self, action):
        return super().step(wheel_duty(
            float(action[0]), float(action[1]), gain=self.gain,
            trim=self.trim, radius=self.radius, k=self.k, limit=self.limit))
