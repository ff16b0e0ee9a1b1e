"""Filled shapes on a class mask, as cv2 paints them, in int64 tensor ops.

The real-domain labels are labelme shapes rasterised by the JAX package's
``cli/create_real_db.shapes_to_label`` through cv2; the card's machine has
no cv2, so this module repeats cv2's integer algorithms at ``shift=0``
with 8-connected lines, on the device of the mask it is given:

- ``fill_poly``: ``cv2.fillPoly`` of one contour.  Every edge is drawn as
  an 8-connected line (``cv2.line``'s Bresenham walk, left to right, after
  cv2's integer ``clipLine``), then the even-odd scanline fill of cv2's
  edge collection: x in 16.16 fixed point from the vertices, or, for an
  edge with an end outside the image, from its clipped ends (and y too,
  unless clipping left both ends on one row); slopes divided with
  truncation; each pair of crossings fills from the first pixel at or
  right of the lower one to the last pixel at or left of the higher one.
- ``fill_rectangle``: ``cv2.rectangle(..., thickness=-1)``: the box
  between two corners given in any order.
- ``fill_circle``: ``cv2.circle(..., thickness=-1)``: the midpoint walk,
  whose half-width at row offset k is ``isqrt(r*r - k*k)`` for as long
  as that is at least k.

Each returns a boolean (H, W) mask of the pixels the call paints; the
caller writes the shapes in order, later ones over earlier ones.
Coordinates are Python ints (the vertices of one shape); the work is
tensor work on ``device``.
"""
from __future__ import annotations

from typing import Sequence

import torch

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_I64 = torch.int64
FILL_DELTA = XY_ONE - 1   # a span starts at ceil(crossing)


def _floor_shift(x: torch.Tensor) -> torch.Tensor:
    """``x >> XY_SHIFT`` on int64, rounding toward minus infinity."""
    return torch.div(x, XY_ONE, rounding_mode="floor")


def _trunc_mul_div(a, b, c) -> torch.Tensor:
    """``(int64)((double)a * b / c)``: the product and quotient in double,
    truncated toward zero, as cv2's clipLine computes them."""
    c = torch.where(c == 0, torch.ones_like(c), c)
    return torch.trunc(a.double() * b.double() / c.double()).to(_I64)


def clip_lines(w: int, h: int, x1, y1, x2, y2):
    """cv2's ``clipLine(Size(w, h), pt1, pt2)`` on int64 tensors of line
    ends: the ends as cv2 leaves them and whether the line meets the
    image.  A line that misses the image may come back partly moved, as
    cv2 leaves it."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return ((x < 0).long() + (x > right).long() * 2
                + (y < 0).long() * 4 + (y > bottom).long() * 8)

    c1, c2 = code(x1, y1), code(x2, y2)
    act = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    # the ends outside the top or bottom edge move onto it
    m = act & ((c1 & 12) != 0)
    a = torch.where(c1 < 8, 0, bottom)
    x1 = torch.where(m, x1 + _trunc_mul_div(a - y1, x2 - x1, y2 - y1), x1)
    y1 = torch.where(m, a, y1)
    c1 = torch.where(m, (x1 < 0).long() + (x1 > right).long() * 2, c1)
    m = act & ((c2 & 12) != 0)
    a = torch.where(c2 < 8, 0, bottom)
    x2 = torch.where(m, x2 + _trunc_mul_div(a - y2, x2 - x1, y2 - y1), x2)
    y2 = torch.where(m, a, y2)
    c2 = torch.where(m, (x2 < 0).long() + (x2 > right).long() * 2, c2)
    # then those outside the left or right edge
    act = act & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = act & (c1 != 0)
    a = torch.where(c1 == 1, 0, right)
    y1 = torch.where(m, y1 + _trunc_mul_div(a - x1, y2 - y1, x2 - x1), y1)
    x1 = torch.where(m, a, x1)
    c1 = torch.where(m, 0, c1)
    m = act & (c2 != 0)
    a = torch.where(c2 == 1, 0, right)
    y2 = torch.where(m, y2 + _trunc_mul_div(a - x2, y2 - y1, x2 - x1), y2)
    x2 = torch.where(m, a, x2)
    c2 = torch.where(m, 0, c2)
    return x1, y1, x2, y2, (c1 | c2) == 0


def lines_mask(h: int, w: int, x1, y1, x2, y2,
               device) -> torch.Tensor:
    """The pixels of 8-connected lines between int64 ends (cv2's ``Line``:
    clipped to the image, walked from the left end, the minor axis
    stepping where Bresenham's error turns negative)."""
    mask = torch.zeros(h, w, dtype=torch.bool, device=device)
    x1, y1, x2, y2, ok = clip_lines(w, h, x1, y1, x2, y2)
    x1, y1, x2, y2 = x1[ok], y1[ok], x2[ok], y2[ok]
    if x1.numel() == 0:
        return mask
    swap = x2 < x1  # left to right
    x1, x2 = torch.where(swap, x2, x1), torch.where(swap, x1, x2)
    y1, y2 = torch.where(swap, y2, y1), torch.where(swap, y1, y2)
    dx, dy = x2 - x1, y2 - y1
    sy = torch.where(dy < 0, -1, 1)
    ady = dy.abs()
    vert = ady > dx
    major = torch.where(vert, ady, dx)
    minor = torch.where(vert, dx, ady)
    count = major + 1
    line = torch.repeat_interleave(torch.arange(len(count), device=device),
                                   count)
    first = torch.cumsum(count, 0) - count
    i = torch.arange(int(count.sum()), device=device) - first[line]
    maj, mnr = major[line], minor[line]
    # minor steps after i major steps: ceil((2*minor*i - major) / (2*major))
    s = torch.div((2 * mnr * i + maj - 1).clamp(min=0), 2 * maj.clamp(min=1),
                  rounding_mode="floor")
    v = vert[line]
    px = x1[line] + torch.where(v, s, i)
    py = y1[line] + sy[line] * torch.where(v, i, s)
    mask[py, px] = True
    return mask


def spans_mask(h: int, w: int, rows, x_lo, x_hi, device) -> torch.Tensor:
    """Pixels of the inclusive horizontal spans [x_lo, x_hi] on ``rows``,
    clipped to the image (spans wholly outside paint nothing)."""
    keep = (rows >= 0) & (rows < h) & (x_lo < w) & (x_hi >= 0)
    rows, x_lo, x_hi = rows[keep], x_lo[keep].clamp(min=0), \
        x_hi[keep].clamp(max=w - 1)
    diff = torch.zeros(h, w + 1, dtype=_I64, device=device)
    ones = torch.ones_like(rows)
    diff.index_put_((rows, x_lo), ones, accumulate=True)
    diff.index_put_((rows, x_hi + 1), -ones, accumulate=True)
    return torch.cumsum(diff, 1)[:, :w] > 0


def _points(points: Sequence[Sequence[int]], device) -> torch.Tensor:
    return torch.as_tensor([[int(x), int(y)] for x, y in points], dtype=_I64,
                           device=device).reshape(-1, 2)


def fill_poly(h: int, w: int, points: Sequence[Sequence[int]],
              device) -> torch.Tensor:
    """``cv2.fillPoly(mask, [points], v)``'s painted pixels (shift 0,
    8-connected lines, one contour)."""
    v = _points(points, device)
    x1, y1 = v.roll(1, 0).unbind(1)   # edge i runs from vertex i-1 to i
    x2, y2 = v.unbind(1)
    mask = lines_mask(h, w, x1, y1, x2, y2, device)

    # the edge collection in 16.16 fixed point: where an end lies outside
    # the image, x runs through the clipped ends, and so does y unless
    # clipping left the ends on one row
    outside = ((x1 < 0) | (x1 >= w) | (y1 < 0) | (y1 >= h)
               | (x2 < 0) | (x2 >= w) | (y2 < 0) | (y2 >= h))
    cx1, cy1, cx2, cy2, _ = clip_lines(w, h, x1, y1, x2, y2)
    moved = outside & (cy1 != cy2)
    p0x = torch.where(outside, cx1, x1) * XY_ONE
    p1x = torch.where(outside, cx2, x2) * XY_ONE
    p0y = torch.where(moved, cy1, y1)
    p1y = torch.where(moved, cy2, y2)
    e = y1 != y2   # horizontal edges are drawn, not filled
    y1, y2 = y1[e], y2[e]
    p0x, p1x, p0y, p1y = p0x[e], p1x[e], p0y[e], p1y[e]
    if len(y1) < 2:
        return mask
    slope = torch.div(p1x - p0x, p1y - p0y, rounding_mode="trunc")
    down = y1 < y2
    ey0 = torch.minimum(y1, y2)
    ey1 = torch.maximum(y1, y2)
    ex = torch.where(down, p0x + (y1 - p0y) * slope,
                     p1x + (y2 - p1y) * slope)
    ex_end = ex + (ey1 - ey0) * slope
    y_min, y_max = int(ey0.min()), int(ey1.max())
    x_min = int(torch.minimum(ex, ex_end).min())
    x_max = int(torch.maximum(ex, ex_end).max())
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= w * XY_ONE:
        return mask

    # even-odd spans: per row, the active edges' crossings in order,
    # paired first with second, third with fourth, ...
    ys = torch.arange(max(y_min, 0), min(y_max, h), device=device)
    if len(ys) == 0:
        return mask
    active = (ys[:, None] >= ey0) & (ys[:, None] < ey1)
    xs = ex + (ys[:, None] - ey0) * slope
    big = torch.iinfo(_I64).max
    xs = torch.sort(torch.where(active, xs, big), dim=1).values
    n_pairs = xs.shape[1] // 2
    lo, hi = xs[:, 0:2 * n_pairs:2], xs[:, 1:2 * n_pairs:2]
    paired = hi != big
    rows = ys[:, None].expand_as(lo)[paired]
    return mask | spans_mask(h, w, rows,
                             _floor_shift(lo[paired] + FILL_DELTA),
                             _floor_shift(hi[paired]), device)


def fill_rectangle(h: int, w: int, p1: Sequence[int], p2: Sequence[int],
                   device) -> torch.Tensor:
    """``cv2.rectangle(mask, p1, p2, v, -1)``'s painted pixels."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    (xa, ya), (xb, yb) = p1, p2
    return ((ys >= min(ya, yb)) & (ys <= max(ya, yb))
            & (xs >= min(xa, xb)) & (xs <= max(xa, xb)))


def _isqrt(n: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(n)) of non-negative int64 values, exact."""
    d = torch.floor(torch.sqrt(n.double())).to(_I64)
    d = torch.where((d + 1) * (d + 1) <= n, d + 1, d)
    return torch.where(d * d > n, d - 1, d)


def fill_circle(h: int, w: int, center: Sequence[int], radius: int,
                device) -> torch.Tensor:
    """``cv2.circle(mask, center, radius, v, -1)``'s painted pixels (shift
    0, 8-connected): the midpoint walk's rows, clipped to the image."""
    cx, cy = int(center[0]), int(center[1])
    k = torch.arange(radius + 1, device=device)
    d = _isqrt(radius * radius - k * k)
    k, d = k[d >= k], d[d >= k]   # the walk runs while dx >= dy
    rows = torch.cat([cy - k, cy + k, cy - d, cy + d])
    half = torch.cat([d, d, k, k])
    return spans_mask(h, w, rows, cx - half, cx + half, device)
