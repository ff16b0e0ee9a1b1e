"""The cotangent of the BatchNorm statistics folded into K3a's load, on the
CPU: ``models.tiramisu.stats_cotangent`` and the ``c0``, ``c1`` operands
of ``kernels.train_block.stage``.

- ``c0 + c1*y`` against ``torch.autograd.grad`` of ``batch_stats``, in
  bfloat16 and float32, growth 12 and 16, with a near-constant channel
  whose E[y^2] - mu^2 rounds below 0 (the variance clamps: its
  cotangent passes nothing) and an all-zero channel (exactly 0:
  ``torch.clamp`` passes it);
- ``stage``'s plain version with the folded operands against the same
  with the outside cotangent and autograd's term summed first, as
  ``FusedBlock`` summed them before;
- ``FusedBlock``'s outputs and gradients in a two-rank gloo world (each
  rank half the batch, in its own process, torchrun's environment)
  against one process's, growth 12 and 16;
- every ``stage`` call of a fused train step takes the folded form, and
  the CPU wrappers count no launch (``launches["stage"]`` counts launches
  on a card only).
"""
import os
import subprocess
import sys
from unittest import mock

import pytest
import torch

from sim2real_lane_segment_tpu_torch.core.dtypes import (DEFAULT_POLICY,
                                                         F32_POLICY)
from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb
from sim2real_lane_segment_tpu_torch.models.tiramisu import (
    FCDenseNet, batch_moments, batch_stats, stats_cotangent)
from sim2real_lane_segment_tpu_torch.models.tiramisu_train_fused import (
    FusedBlock, fused_apply_train)
from sim2real_lane_segment_tpu_torch.parallel import dp
from sim2real_lane_segment_tpu_torch.parallel.multihost import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
DTYPES = [torch.float32, torch.bfloat16]
GROWTHS = [12, 16]


def _col(v):
    return v[:, None, None]


def _activations(dtype, g, seed):
    """[4, g, 15, 20] in ``dtype``: channel 0 a constant but for one value
    a unit above it, whose moments round to E[y^2] - mu^2 < 0; channel 1
    all zero (exactly 0)."""
    gen = torch.Generator().manual_seed(seed)
    y = (torch.randn(4, g, 15, 20, generator=gen) * 0.7 + 0.3).to(dtype)
    y[:, 1] = 0
    for k in torch.linspace(0.1, 4.0, 400).to(dtype):
        y[:, 0] = k
        y[0, 0, 0, 0] = k * (1 + torch.finfo(dtype).eps)
        if batch_moments(y)[1][0] < 0:
            return y, gen
    raise AssertionError("no constant clamps the variance")


def _autograd_corr(y, dmu, dvar):
    yv = y.clone().requires_grad_()
    (corr,) = torch.autograd.grad(batch_stats(yv), yv, (dmu, dvar))
    return corr


def _folded(y, dmu, dvar):
    mu, diff = batch_moments(y)
    n = y.numel() // y.shape[1]
    return stats_cotangent(mu, 2.0 * (diff >= 0), dmu, dvar, n)


@pytest.mark.parametrize("g", GROWTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_folded_term_matches_autograd_of_batch_stats(dtype, g):
    """``T(c0 + c1*y)`` is autograd's cotangent of y to one unit of y's
    dtype per rounding that runs in another order: c0's numerator
    (``dmu - 2 mu v``, autograd ``(dmu - mu v) - mu v``) and the final
    sum, at the scale of the summed terms."""
    y, gen = _activations(dtype, g, g)
    dmu, dvar = torch.randn(2, g, generator=gen)
    corr = _autograd_corr(y, dmu, dvar)
    assert corr.dtype == dtype
    c0, c1 = _folded(y, dmu, dvar)
    yf = y.to(torch.float32)
    mine = (_col(c0) + _col(c1) * yf).to(dtype)
    mu, diff = batch_moments(y)
    n = y.numel() // g
    v = torch.where(diff >= 0, dvar, 0.0)
    scale = (_col((dmu.abs() + 2 * (mu * v).abs()) / n)
             + (_col(c1) * yf).abs())
    err = (mine.float() - corr.float()).abs()
    assert (err <= 2 * torch.finfo(dtype).eps * scale).all(), \
        (err / scale).max()
    # the clamped channel takes no share of the variance's cotangent
    assert diff[0] < 0 and c1[0] == 0
    torch.testing.assert_close(c0[0], dmu[0] / n, rtol=0, atol=0)
    # the all-zero channel's variance is exactly 0 and passes it
    assert diff[1] == 0 and c1[1] == 2 * dvar[1] / n


def _stage_operands(dtype, g, n_later, seed):
    gen = torch.Generator().manual_seed(seed)
    b, c, h, w = 4, 24, 15, 20

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=gen) * s

    x = r(b, c, h, w).to(dtype)
    scale, shift = torch.rand(c, generator=gen) + 0.5, r(c, s=0.3)
    weight = r(c, 9, g, s=0.3).to(dtype)
    mask = (torch.rand(b, g, generator=gen) > 0.3).float() / 0.8
    gps = [r(b, g, h, w).to(dtype) for _ in range(n_later)]
    wls = [r(g, 9, g, s=0.3).to(dtype) for _ in range(n_later)]
    scs = [torch.rand(g, generator=gen) + 0.5 for _ in range(n_later)]
    shs = [r(g, s=0.3) for _ in range(n_later)]
    return x, scale, shift, weight, mask, gps, wls, scs, shs


@pytest.mark.parametrize("n_later", [0, 3])
@pytest.mark.parametrize("g", GROWTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_stage_plain_folded_matches_summed_outside_cotangent(dtype, g,
                                                             n_later):
    """``stage_plain(..., dy, c0, c1, ...)`` against ``stage_plain`` on
    ``ext = dy + autograd's term`` (f32, zero c0 and c1): the cotangent
    ``FusedBlock`` built before the fold.  Float32 to 1e-5 of each
    output's largest value; bfloat16 to one unit of g_pre's dtype there
    (a term one unit apart can round g_pre the other way)."""
    y, gen = _activations(dtype, g, 100 + g)
    dmu, dvar = torch.randn(2, g, generator=gen)
    dy = torch.randn(y.shape, generator=gen).to(dtype)
    x, scale, shift, weight, mask, gps, wls, scs, shs = _stage_operands(
        dtype, g, n_later, g + n_later)
    c0, c1 = _folded(y, dmu, dvar)
    ext = dy.to(torch.float32) + _autograd_corr(y, dmu, dvar).float()
    later = (gps, wls, scale, shift, scs, shs, weight, mask)
    new = ktb.stage_plain(x, y, dy, c0, c1, *later)
    zero = torch.zeros(g)
    old = ktb.stage_plain(x, y, ext, zero, zero, *later)
    limit = 1e-5 if dtype == torch.float32 else torch.finfo(dtype).eps
    for i, (a, b) in enumerate(zip(new, old, strict=True)):
        assert a.dtype == b.dtype and a.shape == b.shape
        err = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert err <= limit, (i, err.item())


# ---------------------------------------------------------------------------
# FusedBlock in a data-parallel world
# ---------------------------------------------------------------------------

B, H, W, SEGS, N_LAYERS = 4, 6, 8, (8, 4), 3


def block_grads(g: int, world=None) -> dict:
    """One FusedBlock forward and backward on seeded operands at global
    batch ``B``: this rank's rows in ``world`` (None: all of them), the
    statistics' cotangents split in shares over the ranks.  Returns the
    new channels and statistics and every gradient."""
    gen = torch.Generator().manual_seed(g)
    c_in = sum(SEGS)

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=gen) * s

    def leaf(t):
        return t.requires_grad_()

    xs = [r(B, c, H, W) for c in SEGS]
    widths = [c_in + j * g for j in range(N_LAYERS)]
    params = ([leaf(torch.rand(c, generator=gen) + 0.5) for c in widths]
              + [leaf(r(c, s=0.2)) for c in widths]
              + [leaf(r(c, 9, g, s=0.3)) for c in widths]
              + [leaf(r(g, s=0.1)) for _ in widths])
    masks = [(torch.rand(B, g, generator=gen) > 0.3).float() / 0.8
             for _ in widths]
    for m in masks:
        m[:, 0] = 0  # a channel dropped for the whole batch: var exactly 0
    dbuf = r(B, c_in + N_LAYERS * g, H, W)
    d_mu, d_var = r(2, N_LAYERS * g)
    rows = slice(None) if world is None else world.rows(B)
    ranks = 1 if world is None else world.size
    segs = [leaf(x[rows].clone()) for x in xs]
    with dp.active(world):
        stats = [batch_stats(s) for s in segs]
        buf, mu_new, var_new = FusedBlock.apply(
            len(segs), N_LAYERS, *segs, torch.cat([m for m, _ in stats]),
            torch.cat([v for _, v in stats]), *params,
            *[m[rows] for m in masks])
        torch.autograd.backward((buf, mu_new, var_new),
                                (dbuf[rows], d_mu / ranks, d_var / ranks))
    return {"new": buf[:, c_in:].detach(), "mu": mu_new.detach(),
            "var": var_new.detach(), "dsegs": [s.grad for s in segs],
            "dparams": [p.grad for p in params]}


WORKER = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from sim2real_lane_segment_tpu_torch.parallel.multihost import (close_world,
                                                               init_world)
from test_torch_stats_fold import block_grads
world, _ = init_world("cpu")
torch.save(block_grads(int(sys.argv[2]), world), sys.argv[3])
close_world()
"""


@pytest.mark.parametrize("g", GROWTHS)
def test_fused_block_two_ranks_match_one_process(tmp_path, g):
    """Each rank's new channels and input cotangents are the one-process
    run's rows, both ranks read the global statistics, and the ranks'
    parameter gradients sum to the one-process ones: the statistics'
    cotangents were summed over the ranks before the fold (float32, the
    tolerance of ``test_torch_train_model``: sums in another order)."""
    port = str(free_port())
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, os.path.join(REPO, "tests"), str(g),
         outs[r]], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
        for r in range(2)]
    ref = block_grads(g)
    for r, p in enumerate(procs):
        _, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    got = [torch.load(f) for f in outs]
    tol = dict(atol=1e-5, rtol=1e-4)
    half = B // 2
    for r, res in enumerate(got):
        rows = slice(r * half, (r + 1) * half)
        torch.testing.assert_close(res["new"], ref["new"][rows], **tol)
        torch.testing.assert_close(res["mu"], ref["mu"], **tol)
        torch.testing.assert_close(res["var"], ref["var"], **tol)
        for a, b in zip(res["dsegs"], ref["dsegs"], strict=True):
            torch.testing.assert_close(a, b[rows], **tol)
    for a, b, want in zip(got[0]["dparams"], got[1]["dparams"],
                          ref["dparams"], strict=True):
        torch.testing.assert_close(a + b, want, **tol)


# ---------------------------------------------------------------------------
# engagement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", [F32_POLICY, DEFAULT_POLICY],
                         ids=["float32", "bfloat16"])
def test_every_stage_of_a_fused_step_takes_the_folded_form(policy):
    """One ``stage`` call per dense layer, each with ``c0`` and ``c1`` and
    the block cotangent's own channels in y's dtype (no f32 sum is made
    first); on the CPU the plain versions run, so no launch is counted,
    ``launches["stage"]`` included."""
    model = FCDenseNet(n_classes=4, down_blocks=(2, 2), up_blocks=(2, 2),
                       bottleneck_layers=2, growth_rate=12,
                       out_chans_first_conv=8, policy=policy)
    calls = []
    real = ktb.stage

    def stage(x, y, dy, c0, c1, *rest):
        calls.append((y, dy, c0, c1))
        return real(x, y, dy, c0, c1, *rest)

    ktb.reset_launches()
    with mock.patch.object(ktb, "stage", stage):
        out, _ = fused_apply_train(model, torch.randn(2, 3, 8, 12))
        out.square().mean().backward()
    n_dense = 2 + 2 + 2 + 2 + 2
    assert len(calls) == n_dense
    for y, dy, c0, c1 in calls:
        assert dy.dtype == y.dtype == policy.compute_dtype
        assert dy.shape == y.shape and dy._base is not None  # a slice
        assert c0.dtype == c1.dtype == torch.float32
        assert c0.shape == c1.shape == (y.shape[1],)
    assert ktb.launches["stage"] == 0
    assert not any(ktb.launches.values())
