"""The port's collision tests (``sim2real_lane_segment_tpu_torch.sim.
collision``) against the JAX package's, on the CPU.

Seeded object tables (12-wide rows with rotated footprints, legacy 9-wide
and 8-wide rows), the fixed cases of ``tests/test_collision.py`` (the
long and rotated barriers, the diagonal yaw that a sign error mirrors)
and the placeholder row: every boolean equal, penalties within
PENALTY_ATOL.  The port tests all poses and objects at once where JAX
maps one at a time.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sim2real_lane_segment_tpu.sim import collision as J
from sim2real_lane_segment_tpu_torch.sim import collision as T

PENALTY_ATOL = 1e-6


def table(rng, n, width):
    """n object rows [x, z, radius, h, r, g, b, annot, draw_cyl, hx, hz,
    theta] (cut to ``width``) scattered around the origin."""
    rows = np.zeros((n, 12), np.float32)
    rows[:, :2] = rng.uniform(-0.5, 0.5, (n, 2))
    rows[:, 2] = rng.uniform(0.02, 0.2, n)
    rows[:, 3] = 0.1
    rows[:, 9:11] = rng.uniform(0.02, 0.3, (n, 2))
    rows[:, 11] = rng.uniform(-np.pi, np.pi, n)
    return rows[:, :width]


def poses(rng, n):
    return (rng.uniform(-0.6, 0.6, (n, 2)).astype(np.float32),
            rng.uniform(-np.pi, np.pi, n).astype(np.float32))


FIXED = [  # (pos, angle, rows): tests/test_collision.py's cases
    ((0.0, 0.0), 0.0, [[5.0, 5.0, 0.1, 0.1, 0, 0, 0, 0.0]]),
    ((0.0, 0.0), 0.0, [[0.05, 0.0, 0.1, 0.1, 0, 0, 0, 0.0]]),
    ((0.0, 0.0), 0.0, [[0.0, 0.11, 0.03, 0.1, 0, 0, 0, 0.0]]),
    ((0.0, 0.0), -np.pi / 2, [[0.0, 0.11, 0.03, 0.1, 0, 0, 0, 0.0]]),
    ((0.0, 0.0), 0.0, [[0.0, 0.2, 0.1, 0.1, 0, 0, 0, 0, 0, 0.25, 0.05, 0]]),
    ((0.2, 0.1), 0.0, [[0.0, 0.2, 0.1, 0.1, 0, 0, 0, 0, 0, 0.25, 0.05, 0]]),
    ((0.4, 0.1), 0.0, [[0.0, 0.2, 0.1, 0.1, 0, 0, 0, 0, 0, 0.25, 0.05, 0]]),
    ((0.0, 0.0), 0.0,
     [[0.3, 0.0, 0.1, 0.1, 0, 0, 0, 0, 0, 0.25, 0.05, np.pi / 2]]),
    ((0.3, 0.2), 0.0,
     [[0.3, 0.0, 0.1, 0.1, 0, 0, 0, 0, 0, 0.25, 0.05, np.pi / 2]]),
    ((0.12, -0.1), np.pi / 4,
     [[0.3, -0.25, 0.1, 0.1, 0, 0, 0, 0, 0, 0.25, 0.02, np.pi / 4]]),
    ((0.12, 0.1), -np.pi / 4,
     [[0.3, -0.25, 0.1, 0.1, 0, 0, 0, 0, 0, 0.25, 0.02, np.pi / 4]]),
    ((0.0, 0.0), 0.0, [[1e9, 1e9, 0.0, 0.0, 0, 0, 0, 0.0]]),
]


def jax_hits(pos, angle, rows):
    objs = jnp.asarray(rows)
    hit = [bool(J.collides_with_objects(jnp.asarray(p), jnp.asarray(a),
                                        objs)) for p, a in zip(pos, angle)]
    pen = [float(J.proximity_penalty(jnp.asarray(p), jnp.asarray(a), objs))
           for p, a in zip(pos, angle)]
    return np.asarray(hit), np.asarray(pen)


@pytest.mark.parametrize("width", [12, 9, 8])
def test_seeded_tables_match_jax(width):
    rng = np.random.default_rng(width)
    rows = table(rng, 16, width)
    pos, angle = poses(rng, 40)
    hit, pen = jax_hits(pos, angle, rows)
    objs = torch.from_numpy(rows)
    got_hit = T.collides_with_objects(torch.from_numpy(pos),
                                      torch.from_numpy(angle), objs)
    got_pen = T.proximity_penalty(torch.from_numpy(pos),
                                  torch.from_numpy(angle), objs)
    np.testing.assert_array_equal(got_hit.numpy(), hit)
    assert 0 < hit.sum() < len(hit)   # both outcomes occur
    np.testing.assert_allclose(got_pen.numpy(), pen, atol=PENALTY_ATOL)
    # one pose at a time, as the env calls it
    for p, a, h in zip(pos[:5], angle[:5], hit[:5]):
        assert bool(T.collides_with_objects(
            torch.from_numpy(p), torch.tensor(a), objs)) == h


@pytest.mark.parametrize("case", range(len(FIXED)))
def test_fixed_cases_match_jax(case):
    pos, angle, rows = FIXED[case]
    rows = np.asarray(rows, np.float32)
    pos = np.asarray([pos], np.float32)
    angle = np.asarray([angle], np.float32)
    hit, pen = jax_hits(pos, angle, rows)
    objs = torch.from_numpy(rows)
    got = T.collides_with_objects(torch.from_numpy(pos[0]),
                                  torch.tensor(angle[0]), objs)
    assert bool(got) == bool(hit[0])
    np.testing.assert_allclose(float(T.proximity_penalty(
        torch.from_numpy(pos[0]), torch.tensor(angle[0]), objs)), pen[0],
        atol=PENALTY_ATOL)


def test_sat_obb_circle_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(30):
        c = rng.uniform(-0.3, 0.3, 2).astype(np.float32)
        hx, hz, th = (np.float32(v) for v in rng.uniform(0.05, 0.3, 3))
        center = rng.uniform(-0.5, 0.5, 2).astype(np.float32)
        r = np.float32(rng.uniform(0.01, 0.2))
        ref = bool(J.sat_obb_circle(
            J.obb_corners(jnp.asarray(c), jnp.asarray(hx), jnp.asarray(hz),
                          jnp.asarray(th)), jnp.asarray(center),
            jnp.asarray(r)))
        corners = T.obb_corners(torch.from_numpy(c), torch.tensor(hx),
                                torch.tensor(hz), torch.tensor(th))
        np.testing.assert_allclose(corners.numpy(), np.asarray(
            J.obb_corners(jnp.asarray(c), jnp.asarray(hx), jnp.asarray(hz),
                          jnp.asarray(th))), atol=1e-6)
        assert bool(T.sat_obb_circle(corners, torch.from_numpy(center),
                                     torch.tensor(r))) == ref
