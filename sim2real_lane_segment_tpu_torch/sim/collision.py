"""Collision detection: separating-axis tests of oriented bounding boxes
in the ground plane, batched over the scene's object table.

Counterpart of the JAX package's ``sim/collision.py`` (reference
gym_duckietown/collision.py: agent_boundbox :9, tensor_sat_test :35, the
safety-circle helpers).  The agent is an OBB; every object row of
``render.build_scene``'s (n, 12) table carries its footprint's half
extents and yaw in columns 9:12, so an elongated object such as the
0.5 m barrier collides with its true rotated box.  Narrower rows (legacy
9-wide, or 8-wide in tests) fall back to a square of their radius.
``proximity_penalty`` stays circle-based: the reference's negative
safety-circle penalty, which enters the reward as ``40 * col_penalty``
(simulator.py:1339-1356).

The JAX package maps one object at a time (``vmap``); here every function
takes tensors with leading batch dims and tests all objects at once.
"""
from __future__ import annotations

import torch

# duckiebot footprint (m): length x width, rear-axle centred
AGENT_LENGTH = 0.18
AGENT_WIDTH = 0.12
AGENT_SAFETY_RADIUS = 0.12


def obb_corners(center: torch.Tensor, hx: torch.Tensor, hz: torch.Tensor,
                theta: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) corners of OBB footprints in world (x, z): ``center``
    (..., 2), half extents and yaw (...).

    ``theta`` follows the agent heading convention: world x east, z
    south, heading (cos theta, -sin theta)."""
    lx = torch.stack([hx, hx, -hx, -hx], -1)
    lz = torch.stack([hz, -hz, -hz, hz], -1)
    c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    # local @ rot.T with rot = [[c, -s], [s, c]], then z flipped south
    world = torch.stack([lx * c - lz * s, -(lx * s + lz * c)], -1)
    return world + center[..., None, :]


def agent_corners(pos: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) OBB corners of the agent footprint."""
    return obb_corners(pos, torch.full_like(angle, AGENT_LENGTH / 2),
                       torch.full_like(angle, AGENT_WIDTH / 2), angle)


def _unit(e: torch.Tensor) -> torch.Tensor:
    return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-9)


def _edge_axes(corners: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) unit axes normal to the box faces (its two edges)."""
    return torch.stack([_unit(corners[..., 1, :] - corners[..., 0, :]),
                        _unit(corners[..., 3, :] - corners[..., 0, :])], -2)


def _project(corners: torch.Tensor, axes: torch.Tensor):
    """Extent (lo, hi) (..., A) of corners (..., K, 2) along axes
    (..., A, 2)."""
    d = (corners[..., None, :, 0] * axes[..., :, None, 0]
         + corners[..., None, :, 1] * axes[..., :, None, 1])
    return d.min(-1).values, d.max(-1).values


def sat_obb_obb(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """True where two corner sets (..., 4, 2) intersect (2-D separating
    axes: the 2 + 2 edge normals are the only candidates)."""
    a, b = torch.broadcast_tensors(a, b)
    axes = torch.cat([_edge_axes(a), _edge_axes(b)], -2)
    alo, ahi = _project(a, axes)
    blo, bhi = _project(b, axes)
    return ((ahi >= blo) & (alo <= bhi)).all(-1)


def sat_obb_circle(corners: torch.Tensor, center: torch.Tensor,
                   radius: torch.Tensor) -> torch.Tensor:
    """True where the OBB (..., 4, 2) meets the circle (centre (..., 2),
    radius (...)): the box axes and the axis to its closest corner."""
    d = corners - center[..., None, :]
    near = torch.argmin((d * d).sum(-1), -1)
    closest = torch.gather(
        corners, -2, near[..., None, None].expand(*near.shape, 1, 2))
    axes = torch.cat([_edge_axes(corners), _unit(closest - center[
        ..., None, :])], -2)
    lo, hi = _project(corners, axes)
    c = (center[..., None, :] * axes).sum(-1)
    r = radius[..., None]
    return ((hi >= c - r) & (lo <= c + r)).all(-1)


def object_corners(objects: torch.Tensor) -> torch.Tensor:
    """(n, 4, 2) footprint corners of the object rows (n, >= 8).

    Rows at least 12 wide carry [hx, hz, theta] in columns 9:12; narrower
    rows fall back to a square of the radius (column 2)."""
    if objects.shape[-1] >= 12:
        hx, hz, theta = objects[:, 9], objects[:, 10], objects[:, 11]
    else:
        hx = hz = objects[:, 2]
        theta = torch.zeros_like(hx)
    return obb_corners(objects[:, :2], hx, hz, theta)


def collides_with_objects(pos: torch.Tensor, angle: torch.Tensor,
                          objects: torch.Tensor) -> torch.Tensor:
    """True where the agent OBB at ``pos`` (..., 2), ``angle`` (...) hits
    any object's footprint.  ``objects``: (n, >= 8) rows [x, z, radius, h,
    r, g, b, annot, draw_cyl, hx, hz, theta] (``render.build_scene``)."""
    corners = agent_corners(pos, angle)[..., None, :, :]   # (..., 1, 4, 2)
    return sat_obb_obb(corners, object_corners(objects)).any(-1)


def proximity_penalty(pos: torch.Tensor, angle: torch.Tensor,
                      objects: torch.Tensor) -> torch.Tensor:
    """Negative penalty growing as safety circles overlap (0 when clear):
    each object's (d - reach) / reach clipped to [-1, 0], summed, with d
    from a point a quarter length ahead of the agent (the reference's
    _proximity_penalty2)."""
    heading = torch.stack([torch.cos(angle), -torch.sin(angle)], -1)
    center = pos + heading * (AGENT_LENGTH / 4)
    d = torch.linalg.vector_norm(center[..., None, :] - objects[:, :2],
                                 dim=-1)
    reach = AGENT_SAFETY_RADIUS + objects[:, 2] * 1.5
    return torch.clamp((d - reach) / reach, -1.0, 0.0).sum(-1)
