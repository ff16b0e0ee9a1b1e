"""Plain versions of K1, K2, K3a and K3b (``kernels/train_block.py``)
against the JAX Pallas kernels they replace, run in interpret mode on the
CPU: ``_consumer_fwd``, ``_consumer_bwd_call``, ``_stage_call`` and
``_final_call`` of ``models/tiramisu_train_pallas.py``.

Float32, segments (8, 4, 4), growth 4, batch 2, at 8x16 and the odd 5x7.
The operands carry dropped channels and a z == 0 plane (a zero input
channel with zero shift), where the ReLU subgradient is 0.5.  atol 1e-5:
the two sides sum the same float32 products in another order.
"""
import numpy as np
import pytest
import torch

from test_torch_common import from_cm, to_cm, wf_rows
from torch_sites import (DENSE_SITES, DENSE_SITES_57, TD_SITES,
                         TD_SITES_57)

from sim2real_lane_segment_tpu.models.tiramisu_train_pallas import (
    _Cfg, _consumer_bwd_call, _consumer_fwd, _final_call, _FinalCfg,
    _stage_call, _StageCfg)
from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb

SEGS = (8, 4, 4)
G = 4
B = 2
SIZES = [(8, 16), (5, 7)]
TOL = dict(atol=1e-5, rtol=1e-5)


def _operands(rng, c, n, h, w, taps):
    x = (rng.normal(size=(B, c, h, w)) * 0.7).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = rng.normal(0, 0.3, c).astype(np.float32)
    x[:, 1] = 0.0   # z == 0 on the whole plane
    shift[1] = 0.0
    weight = rng.normal(0, 0.3, (c, taps, n)).astype(np.float32)
    bias = rng.normal(0, 0.1, n).astype(np.float32)
    mask = (rng.random((B, n)) > 0.3).astype(np.float32) / 0.8
    mask[0, 0] = 0.0
    mask[1, 0] = 0.0  # a channel dropped for the whole batch
    return x, scale, shift, weight, bias, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_segs(x):
    cm = to_cm(x)
    out, lo = [], 0
    for c in SEGS:
        out.append(cm[:, lo:lo + c])
        lo += c
    return tuple(out)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(kw or TOL))


@pytest.mark.parametrize("taps", [9, 1])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_consumer_fwd_and_bwd_match_jax(size, taps):
    h, w = size
    rng = np.random.default_rng(10 + taps)
    c = sum(SEGS)
    n = G if taps == 9 else c
    x, scale, shift, weight, bias, mask = _operands(rng, c, n, h, w, taps)
    dy = rng.normal(size=(B, n, h, w)).astype(np.float32)
    cfg = _Cfg(h, w, SEGS, taps, n, "float32", True)
    segs = _jax_segs(x)

    y_ref = _consumer_fwd(cfg, segs, scale[:, None], shift[:, None],
                          wf_rows(weight), bias[:, None], mask[..., None])
    y = ktb.consumer_fwd(_t(x), _t(scale), _t(shift), _t(weight), _t(bias),
                         _t(mask))
    _close(y, from_cm(y_ref, h, w))

    dseg_r, dsc_r, dsh_r, dwf_r, db_r = _consumer_bwd_call(
        cfg, segs, scale[:, None], shift[:, None], wf_rows(weight),
        mask[..., None], to_cm(dy))
    dseg, dsc, dsh, dw, db = ktb.consumer_bwd(
        _t(x), _t(scale), _t(shift), _t(weight), _t(mask), _t(dy))
    _close(dseg, from_cm(dseg_r, h, w))
    _close(dsc, np.asarray(dsc_r)[:, 0])
    _close(dsh, np.asarray(dsh_r)[:, 0])
    _close(wf_rows(dw.numpy()), dwf_r)
    _close(db, np.asarray(db_r)[:, 0])
    # the z == 0 plane takes half the cotangent, not none of it
    assert np.abs(dsh.numpy()[1]) > 0


def _later(rng, n_later, h, w, y):
    """Per later layer: stored g_pre, the y rows of its weight and its BN
    scale/shift on them (one with a z == 0 plane on a zero y channel)."""
    gps, wls, scs, shs = [], [], [], []
    for _ in range(n_later):
        gps.append(rng.normal(size=(B, G, h, w)).astype(np.float32))
        wls.append(rng.normal(0, 0.3, (G, 9, G)).astype(np.float32))
        scs.append(rng.uniform(0.5, 1.5, G).astype(np.float32))
        sh = rng.normal(0, 0.3, G).astype(np.float32)
        sh[2] = 0.0
        shs.append(sh)
    y[:, 2] = 0.0
    return gps, wls, scs, shs


@pytest.mark.parametrize("n_later", [0, 2])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_stage_matches_jax(size, n_later):
    h, w = size
    rng = np.random.default_rng(20 + n_later)
    c = sum(SEGS)
    x, scale, shift, weight, _, mask = _operands(rng, c, G, h, w, 9)
    y = rng.normal(size=(B, G, h, w)).astype(np.float32)
    dy = rng.normal(size=(B, G, h, w)).astype(np.float32)
    gps, wls, scs, shs = _later(rng, n_later, h, w, y)
    # the statistics' cotangent as c0 + c1*y; JAX takes the sum as ext
    c0, c1 = rng.normal(0, 0.1, (2, G)).astype(np.float32)
    ext = dy + (c0[:, None, None] + c1[:, None, None] * y)

    cfg = _StageCfg(h, w, SEGS, G, n_later, "float32", True)
    gp_r, dwf_r, dsc_r, dsh_r, db_r = _stage_call(
        cfg, _jax_segs(x), to_cm(y), to_cm(ext), [to_cm(g) for g in gps],
        wf_rows(weight), [wf_rows(wl) for wl in wls], scale[:, None],
        shift[:, None], [s[:, None] for s in scs], [s[:, None] for s in shs],
        mask[..., None])
    gp, dw, dsc, dsh, db = ktb.stage(
        _t(x), _t(y), _t(dy), _t(c0), _t(c1), [_t(g) for g in gps],
        [_t(wl) for wl in wls], _t(scale), _t(shift), [_t(s) for s in scs],
        [_t(s) for s in shs], _t(weight), _t(mask))
    _close(gp, from_cm(gp_r, h, w))
    _close(wf_rows(dw.numpy()), dwf_r)
    _close(dsc, np.asarray(dsc_r)[:, 0])
    _close(dsh, np.asarray(dsh_r)[:, 0])
    _close(db, np.asarray(db_r)[:, 0])


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_final_matches_jax(size):
    h, w = size
    rng = np.random.default_rng(30)
    c = sum(SEGS)
    x, *_ = _operands(rng, c, G, h, w, 9)
    n = 3
    gps = [rng.normal(size=(B, G, h, w)).astype(np.float32)
           for _ in range(n)]
    wls = [rng.normal(0, 0.3, (c, 9, G)).astype(np.float32)
           for _ in range(n)]
    scs = [rng.uniform(0.5, 1.5, c).astype(np.float32) for _ in range(n)]
    shs = [rng.normal(0, 0.3, c).astype(np.float32) for _ in range(n)]
    for sh in shs:
        sh[1] = 0.0  # x[:, 1] is zero: z == 0 for every layer
    cfg = _FinalCfg(h, w, SEGS, G, n, "float32", True)
    ref = _final_call(cfg, _jax_segs(x), [to_cm(g) for g in gps],
                      [wf_rows(wl) for wl in wls],
                      [s[:, None] for s in scs], [s[:, None] for s in shs])
    out = ktb.final(_t(x), [_t(g) for g in gps], [_t(wl) for wl in wls],
                    [_t(s) for s in scs], [_t(s) for s in shs])
    _close(out, from_cm(ref, h, w))


def test_wrappers_count_no_launch_on_cpu():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    ktb.reset_launches()
    rng = np.random.default_rng(0)
    x, scale, shift, weight, bias, mask = _operands(rng, 16, G, 5, 7, 9)
    ktb.consumer_fwd(_t(x), _t(scale), _t(shift), _t(weight), _t(bias),
                     _t(mask))
    assert all(v == 0 for v in ktb.launches.values())


def test_wgrad_splits_fill_the_card_and_stay_in_range():
    assert ktb.wgrad_splits(592, 16, 32, 120, 160) == 28
    assert ktb.wgrad_splits(48, 16, 1, 3, 5) == 1   # one item only
    assert ktb.n_tiles(120, 160) == 80


@pytest.mark.parametrize("dtype,taps,n,expect", [
    (torch.bfloat16, 1, 128, True), (torch.bfloat16, 1, 624, True),
    (torch.bfloat16, 1, 640, True), (torch.bfloat16, 1, 656, True),
    (torch.bfloat16, 9, 16, False), (torch.float32, 1, 128, False)])
def test_tensor_core_bwd_dispatch(dtype, taps, n, expect):
    """bf16 1x1 backwards of any width take the tensor-core K2, FCDenseNet103's
    656 outputs too (the C side dispatches by the same rule and sizes its
    scratch by it)."""
    assert ktb.takes_mma_bwd(dtype, taps, n) is expect


def test_tensor_core_wgrad_splits_fill_the_card():
    # the first TransitionDown at B=32: one 128x128 tile, 9,600 slices of
    # 64 of the 614,400 positions
    assert ktb.mma_wgrad_splits(128, 128, 32, 120, 160) == 264
    # the last: 16 tiles of the 448x448 cotangent, 35 slices of 2,240
    assert ktb.mma_wgrad_splits(448, 448, 32, 7, 10) == 17
    # FCDenseNet103's last: 36 tiles of the 656x656 cotangent
    assert ktb.mma_wgrad_splits(656, 656, 32, 7, 10) == 8
    assert ktb.mma_wgrad_splits(16, 16, 1, 8, 8) == 1   # one slice only
    # one 7x10 image is two slices: positions, not images, are split
    assert ktb.mma_wgrad_splits(448, 448, 1, 7, 10) == 2


def test_tensor_core_dgrad_blocks_fill_the_card():
    # 4,800 tiles of 128 positions at 120x160, B=32: at most 264 blocks
    assert ktb.mma_dgrad_blocks(128, 32, 120, 160) == 264
    # FCDenseNet103's last at B=32: 18 tiles x 6 channel chunks
    assert ktb.mma_dgrad_blocks(656, 32, 7, 10) == 108
    assert ktb.mma_dgrad_blocks(16, 1, 3, 5) == 1


# ---------------------------------------------------------------------------
# the tensor-core K1 and K3a: dispatch rules, chunks, splits and scratch
# ---------------------------------------------------------------------------

def test_fcdensenet67_site_list():
    assert len(DENSE_SITES) == 55 and len(TD_SITES) == 5
    assert DENSE_SITES[0] == (48, 120, 160) and DENSE_SITES[-1] == (272, 120,
                                                                    160)
    assert max(c for c, _, _ in DENSE_SITES) == 592
    assert [c for c, _, _ in TD_SITES] == [128, 208, 288, 368, 448]


@pytest.mark.parametrize("site", DENSE_SITES + TD_SITES,
                         ids=lambda s: "c%d_%dx%d" % s)
def test_every_fcdensenet67_site_takes_the_tensor_cores(site):
    """All 55 + 5 K1 sites and all 55 K3a sites in bfloat16; none in
    float32 (the parity control stays on the CUDA cores)."""
    c, h, w = site
    taps, n = (9, 16) if site in DENSE_SITES else (1, c)
    assert ktb.takes_mma_fwd(torch.bfloat16, taps, c, n)
    assert not ktb.takes_mma_fwd(torch.float32, taps, c, n)
    if taps == 9:
        assert ktb.takes_mma_stage(torch.bfloat16, n)
        assert not ktb.takes_mma_stage(torch.float32, n)
        chunks, units = ktb.mma_stage_chunks(c)
        assert 1 <= units <= 4 and (chunks - 1) * units * 16 < c
        assert chunks * units * 16 >= c
        splits = ktb.mma_stage_splits(c, 32, h, w)
        items = 32 * ktb.mma3_tiles(h, w)
        assert 1 <= splits <= items
        # the grid fills the 132 SMs (one block each, short of the
        # remainder of 132 over the chunks) unless the plane has fewer
        # items than that
        assert chunks * splits <= 132
        assert chunks * splits >= min(132 - chunks + 1, chunks * items)


def test_fcdensenet57_site_list():
    """Against the model's own layers: 44 + 5 sites, c_j 48 + 12 j."""
    from sim2real_lane_segment_tpu_torch.models.tiramisu import fcdensenet57
    fe = fcdensenet57(4).featureExtractor
    names = ([f"denseDown{i}" for i in range(5)] + ["bottleneck"]
             + [f"denseUp{i}" for i in range(5)])
    assert [c for c, _, _ in DENSE_SITES_57] == [
        lay.Conv_0.in_channels for n in names
        for lay in getattr(fe, n).layers()]
    assert [c for c, _, _ in TD_SITES_57] == [
        getattr(fe, f"transDown{i}").Conv_0.in_channels for i in range(5)]
    assert sum(c % 8 != 0 for c, _, _ in DENSE_SITES_57) == 22


@pytest.mark.parametrize("site", DENSE_SITES_57 + TD_SITES_57,
                         ids=lambda s: "c%d_%dx%d" % s)
def test_every_fcdensenet57_site_takes_the_tensor_cores(site):
    """All 44 + 5 K1 sites and all 44 K3a and K3b sites of FCDenseNet57 in
    bfloat16, growth 12 (half of them at c_j no multiple of 8); none in
    float32."""
    c, h, w = site
    taps, n = (9, 12) if site in DENSE_SITES_57 else (1, c)
    assert ktb.takes_mma_fwd(torch.bfloat16, taps, c, n)
    assert not ktb.takes_mma_fwd(torch.float32, taps, c, n)
    if taps == 9:
        assert ktb.takes_mma_stage(torch.bfloat16, n)
        assert not ktb.takes_mma_stage(torch.float32, n)
        chunks, units = ktb.mma_stage_chunks(c)
        assert 1 <= units <= 4 and (chunks - 1) * units * 16 < c
        assert chunks * units * 16 >= c
        assert chunks * ktb.mma_stage_splits(c, 32, h, w) <= 132


@pytest.mark.parametrize("dtype,taps,c,n,expect", [
    (torch.bfloat16, 9, 48, 16, True), (torch.bfloat16, 9, 24, 4, False),
    (torch.bfloat16, 9, 48, 12, True), (torch.bfloat16, 9, 48, 32, False),
    (torch.bfloat16, 1, 768, 768, True), (torch.bfloat16, 1, 784, 16, False),
    (torch.float32, 9, 48, 16, False), (torch.float32, 1, 128, 128, False)])
def test_tensor_core_fwd_dispatch(dtype, taps, c, n, expect):
    assert ktb.takes_mma_fwd(dtype, taps, c, n) is expect


@pytest.mark.parametrize("dtype,g,expect", [
    (torch.bfloat16, 16, True), (torch.bfloat16, 4, False),
    (torch.bfloat16, 12, True), (torch.bfloat16, 32, False),
    (torch.float32, 16, False)])
def test_tensor_core_stage_dispatch(dtype, g, expect):
    assert ktb.takes_mma_stage(dtype, g) is expect


@pytest.mark.parametrize("c,expect", [(16, (1, 1)), (48, (1, 3)),
                                      (64, (1, 4)), (80, (2, 3)),
                                      (272, (5, 4)), (592, (10, 4)),
                                      (40, (1, 3))])
def test_own_layer_chunks(c, expect):
    assert ktb.mma_stage_chunks(c) == expect


def test_own_layer_splits_and_tiles():
    assert ktb.mma3_tiles(120, 160) == 100 and ktb.mma3_tiles(3, 5) == 1
    assert ktb.mma3_tiles(15, 20) == 4
    assert ktb.mma_stage_splits(48, 32, 120, 160) == 132
    assert ktb.mma_stage_splits(592, 32, 7, 10) == 13
    assert ktb.mma_stage_splits(512, 32, 3, 5) == 16   # two items a split
    assert ktb.mma_stage_splits(1072, 32, 3, 5) == 7
    assert ktb.mma_stage_splits(48, 1, 3, 5) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_later", [0, 3])
def test_stage_results_keep_shapes_and_dtypes_on_cpu(n_later, dtype):
    rng = np.random.default_rng(40 + n_later)
    c, g, h, w = 24, 16, 5, 7
    x, scale, shift, weight, _, mask = _operands(rng, c, g, h, w, 9)
    y = rng.normal(size=(B, g, h, w)).astype(np.float32)
    dy = rng.normal(size=(B, g, h, w)).astype(np.float32)
    gps = [rng.normal(size=(B, g, h, w)).astype(np.float32)
           for _ in range(n_later)]
    wls = [rng.normal(0, 0.3, (g, 9, g)).astype(np.float32)
           for _ in range(n_later)]
    scs = [rng.uniform(0.5, 1.5, g).astype(np.float32)
           for _ in range(n_later)]
    shs = [rng.normal(0, 0.3, g).astype(np.float32) for _ in range(n_later)]
    c0, c1 = rng.normal(0, 0.1, (2, g)).astype(np.float32)

    def d(a):
        return _t(a).to(dtype)

    ktb.reset_launches()
    gp, dw, dsc, dsh, db = ktb.stage(
        d(x), d(y), d(dy), _t(c0), _t(c1), [d(v) for v in gps],
        [d(v) for v in wls], _t(scale), _t(shift), [_t(v) for v in scs],
        [_t(v) for v in shs], d(weight), _t(mask))
    assert gp.shape == (B, g, h, w) and gp.dtype == dtype
    assert dw.shape == (c, 9, g) and dw.dtype == torch.float32
    assert dsc.shape == dsh.shape == (c,) and db.shape == (g,)
    assert dsc.dtype == dsh.dtype == db.dtype == torch.float32
    assert all(torch.isfinite(t.float()).all() for t in (gp, dw, dsc, dsh, db))
    assert not any(ktb.launches.values())
    assert not any(ktb.mma_launches.values())
