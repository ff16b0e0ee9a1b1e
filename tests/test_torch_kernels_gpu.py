"""The port's CUDA kernels (K4, K1-K3b, K6, K5) against their plain
PyTorch versions, on a card, and the train step captured as a CUDA graph
against the eager step.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode).  This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py

Shapes cross the kernels' tiles with ragged remainders: K4's CUDA-core
16x16 pixel tiles and 16-channel groups, the bf16 tensor-core dense
layer's 12x16 pixel tiles, 32-channel chunks and channel-loop splits of
1-8 blocks (K4 and K1 share it; at growth 16 and at FCDenseNet57's 12,
whose input widths are rarely a multiple of 8), the bf16 TransitionDown
kernels'
128-pixel tiles and 16-channel tensor-core steps (forward and K2), K6's
int8 tensor-core 16x8 pixel tiles (halo 1, 2 and 4), 32-channel k steps
and 128-output slices, its CUDA-core 64-pixel rows and 64-channel output
groups, the classifier's 64-pixel block tiles, 16-pixel warp slices and
16-channel steps (rows that are and are not 16-byte aligned, C not a
multiple of 16), K5's 32-row strips and 32-pixel words (images smaller
than the halo, and frames wider than one 32-word column tile).  Also the
paths that put the kernels to new use: the distillation teacher through
K4, LaneNetLite's train step on the card against the CPU and as a graph
replay against the eager step, K5 under ``cli.postprocess``, and the
renderer and the env on the card against the CPU, and
``cli.make_demo_video --fused`` through K4, and the two diagnostic
variants of the tensor-core dense layer (``dense_layer(..., ablate=)``)
beside the default kernel; and the JAX package's FFV1 recording decoded
by the port's codec and labelled through K5.
"""
import ctypes

import numpy as np
import pytest
import torch

from sim2real_lane_segment_tpu_torch.core.runtime import \
    set_float32_precision
from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb

# (B, H, W, c_in, growth, n_layers); the last four give TransitionDown
# widths C = N = 128 and 208 on 15x20 and 7x10 (pixel counts not a
# multiple of the tensor-core kernel's 128-pixel tile or of 8)
CASES = [(2, 12, 16, 8, 4, 2), (3, 15, 20, 40, 16, 3), (1, 7, 33, 24, 12, 2),
         (2, 15, 20, 96, 16, 2), (2, 7, 10, 96, 16, 2),
         (2, 15, 20, 176, 16, 2), (2, 7, 10, 176, 16, 2)]
# f32: summation order only.  bf16: a different f32 sum may round to the
# neighbouring bf16 value (relative step 2^-7), and a later layer sees it.
TOLS = {torch.float32: dict(atol=1e-5, rtol=1e-5),
        torch.bfloat16: dict(atol=2e-2, rtol=2 ** -6)}
# logits are x20 (1/temperature) of the normalized features
LOGIT_ATOL = {torch.float32: 1e-4, torch.bfloat16: 0.1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    set_float32_precision()  # strict float32, as the port's CLIs
    return torch.device("cuda")


def _operands(case, dtype, device, seed=0):
    b, h, w, c, g, n = case
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    layers = []
    for j in range(n):
        k = c + j * g
        wk = t(rng.normal(0, (2 / (9 * k)) ** 0.5, (k, 9, g)), dtype)
        if kdb.takes_mma_dense(dtype, g):  # the layout fold_model makes
            wk = kdb.pad_growth(wk)
        layers.append(kdb.FoldedLayer(
            t(rng.uniform(0.5, 1.5, k)), t(rng.normal(0, 0.3, k)), wk,
            t(rng.normal(0, 0.1, g))))
    ct = c + n * g
    td = kdb.FoldedTransition(
        t(rng.uniform(0.5, 1.5, ct)), t(rng.normal(0, 0.3, ct)),
        t(rng.normal(0, (2 / ct) ** 0.5, (ct, ct)), dtype),
        t(rng.normal(0, 0.1, ct)))
    wc = np.zeros((8, ct), np.float32)
    wc[:4] = rng.normal(0, 0.3, (4, ct))
    cb = np.zeros(8, np.float32)
    cb[:4] = rng.normal(0, 0.1, 4)
    cls = kdb.FoldedClassifier(t(wc, dtype), t(cb), 1.0 / 0.05)
    x = t(rng.normal(0, 1, (b, c, h, w)), dtype)
    return x, layers, td, cls


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain(cuda, case, dtype):
    x, layers, td, cls = _operands(case, dtype, cuda)
    n = len(layers)
    kdb.reset_launches()
    out, out_td = kdb.dense_block([x], layers, c_lo=0, td=td)
    ref, ref_td = kdb.dense_block_plain([x], layers, c_lo=0, td=td)
    feat = ref.contiguous()
    # epilogues on identical features, so each is checked on its own
    td_k = kdb.transition(feat, td)
    logits = kdb.classifier(feat, cls)
    torch.cuda.synchronize()
    assert kdb.launches == {"dense_layer": n, "transition": 2,
                            "classifier": 1}
    assert kdb.mma_launches == {
        "dense_layer": n * kdb.takes_mma_dense(dtype, case[4]),
        "transition": 2 * (dtype == torch.bfloat16)}
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])
    torch.testing.assert_close(td_k.float(), ref_td.float(), **TOLS[dtype])
    torch.testing.assert_close(logits, kdb.classifier_plain(feat, cls),
                               atol=LOGIT_ATOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_new_features_and_segments(cuda, dtype):
    """c_lo = c_in (up-path blocks) over two input segments."""
    x, layers, _, _ = _operands(CASES[1], dtype, cuda, seed=1)
    segs = [x[:, :16].contiguous(), x[:, 16:].contiguous()]
    kdb.reset_launches()
    out = kdb.dense_block(segs, layers, c_lo=x.shape[1])
    ref = kdb.dense_block_plain([x], layers, c_lo=x.shape[1])
    assert kdb.mma_launches == {
        "dense_layer": len(layers) * (dtype == torch.bfloat16),
        "transition": 0}
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])


# (B, H, W, c_j) for the bf16 tensor-core dense layer: the small planes
# (3x5, 7x10, 15x20) and an odd 26x35, c_j ragged against the 32-channel
# chunk (40, 88) and the widest FCDenseNet67 site (592), batches that are
# no multiple of anything, and splits of 2, 3, 5 and 8 blocks; growth 16
MMA_DENSE_CASES = [(3, 3, 5, 592), (5, 7, 10, 88), (3, 15, 20, 40),
                   (1, 26, 35, 88), (64, 3, 5, 592), (64, 7, 10, 448),
                   (7, 15, 20, 592), (2, 120, 160, 48)]
# growth 12 (FCDenseNet57): c_j 60 and 84 (neither a multiple of 8 nor of
# 16), 228 (the widest down-path site), the odd 7x33, 15x20, a split
# plane (7x10 at B=64) and the 120x160 level
MMA_DENSE_G12_CASES = [(3, 7, 33, 60), (2, 15, 20, 84), (64, 7, 10, 84),
                       (64, 7, 10, 228), (2, 120, 160, 60), (5, 3, 5, 84)]


@pytest.mark.gpu
@pytest.mark.parametrize("g,case", [(16, c) for c in MMA_DENSE_CASES]
                         + [(12, c) for c in MMA_DENSE_G12_CASES])
def test_mma_dense_layer_matches_plain(cuda, case, g):
    """One layer on the tensor cores against the plain version, in a
    buffer wider than the layer writes; the other channels keep their
    bits, a second run gives the same bits (the split's sums are added in
    a fixed order), and the C library reports the split ``dense_splits``
    gives for this card.  Growth 12 reads its weight padded to 16 zero
    columns (``pad_growth``) and writes 12 channels."""
    b, h, w, c = case
    gen = torch.Generator().manual_seed(c + h)
    feat = torch.randn(b, c + g + 8, h, w, generator=gen).to(
        cuda, torch.bfloat16)
    lay = kdb.FoldedLayer(
        (torch.rand(c, generator=gen) + 0.5).to(cuda),
        (torch.randn(c, generator=gen) * 0.3).to(cuda),
        kdb.pad_growth((torch.randn(c, 9, g, generator=gen)
                        * (2 / (9 * c)) ** 0.5).to(cuda, torch.bfloat16)),
        (torch.randn(g, generator=gen) * 0.1).to(cuda))
    kdb.reset_launches()
    out, again, ref = feat.clone(), feat.clone(), feat.clone()
    kdb.dense_layer(out, lay)
    kdb.dense_layer(again, lay)
    kdb.dense_layer_plain(ref, lay)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = kdb.dense_splits(b, h, w, c, sms)
    assert kdb.mma_launches == {"dense_layer": 2, "transition": 0}
    assert kdb.mma_splits == {splits: 2}
    assert kdb._lib().s2r_dense_splits(b, h, w, c) == splits
    assert torch.equal(out, again)
    assert torch.equal(out[:, :c], feat[:, :c])
    assert torch.equal(out[:, c + g:], feat[:, c + g:])
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOLS[torch.bfloat16])


@pytest.mark.gpu
def test_growth12_route(cuda):
    """bf16 growth 12 reports the tensor cores in serving (K4) and in
    training (K1, K3a, K3b); float32 growth 12 does not; a bf16 growth-12
    weight that is not in the padded layout raises (no fallback)."""
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb
    b, h, w, c, g = 2, 15, 20, 60, 12
    for dtype, mma in ((torch.bfloat16, 1), (torch.float32, 0)):
        x, scale, shift, weight, bias, mask = _train_operands(
            (b, h, w, c, g), dtype, cuda, 11)
        feat = torch.zeros(b, c + g, h, w, device=cuda, dtype=dtype)
        feat[:, :c] = x
        kdb.reset_launches()
        kdb.dense_layer(feat, kdb.FoldedLayer(scale, shift, weight, bias))
        buf = feat.clone()
        ktb.reset_launches()
        ktb.consumer_fwd(buf, scale, shift, weight, bias, mask,
                         out=buf[:, c:])
        later = (torch.randn(b, g, h, w, device=cuda).to(dtype),)
        dy = torch.randn(b, g, h, w, device=cuda).to(dtype)
        c0, c1 = torch.randn(2, g, device=cuda)
        ktb.stage(buf, buf[:, c:], dy, c0, c1, later, (weight[:g],), scale,
                  shift, (scale[:g],), (shift[:g],), weight, mask)
        ktb.final(buf, later, (weight,), (scale,), (shift,))
        torch.cuda.synchronize()
        assert kdb.mma_launches == {"dense_layer": mma, "transition": 0}
        assert ktb.mma_launches == {"consumer_fwd": mma, "consumer_bwd": 0,
                                    "stage": mma, "final": mma}
        assert kdb.mma_layout(weight) == (dtype == torch.bfloat16)
    flat = weight.to(torch.bfloat16).contiguous()  # [c, 9, 12], unpadded
    feat = feat.to(torch.bfloat16)
    with pytest.raises(ValueError, match="pad_growth"):
        kdb.dense_layer(feat, kdb.FoldedLayer(scale, shift, flat, bias))
    with pytest.raises(ValueError, match="pad_growth"):
        ktb.consumer_fwd(feat, scale, shift, flat, bias, mask)


@pytest.mark.gpu
def test_time_scan_reads_a_light_call_above_its_floor(cuda):
    """``cli/serve_breakdown._time_scan`` times the device's work alone: a
    call far lighter on the card than its launch cost on the host (one
    scale of a 7x10 plane of 448 channels at B=128, as the smallest
    TransitionDown row of ``train_breakdown``) reads above its floor in
    each of ten runs of four calls."""
    from sim2real_lane_segment_tpu_torch.cli import serve_breakdown as sb

    a = torch.randn(128, 448, 7, 10, device=cuda).to(torch.bfloat16)
    for _ in range(10):
        dt, floor = sb._time_scan(lambda t: t * 2, (a,), k=2, iters=2,
                                  with_floor=True)
        assert dt > floor > 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(kdb.ABLATIONS))
@pytest.mark.parametrize("case", [(3, 15, 20, 40), (64, 7, 10, 448),
                                  (2, 120, 160, 48)])
def test_ablated_dense_layer_launches_beside_the_default(cuda, case, mode):
    """``cli/serve_breakdown --ablate``'s variants of the tensor-core
    dense layer launch (split and unsplit), give finite output near their
    plain versions, and leave the default kernel as it was: on one buffer,
    the default layer, then the variant, then the default again, whose bits
    equal the first run's."""
    b, h, w, c = case
    gen = torch.Generator().manual_seed(c + h + len(mode))
    feat = torch.randn(b, c + 16, h, w, generator=gen).to(cuda,
                                                          torch.bfloat16)
    lay = kdb.FoldedLayer(
        (torch.rand(c, generator=gen) + 0.5).to(cuda),
        (torch.randn(c, generator=gen) * 0.3).to(cuda),
        (torch.randn(c, 9, 16, generator=gen) * (2 / (9 * c)) ** 0.5).to(
            cuda, torch.bfloat16),
        (torch.randn(16, generator=gen) * 0.1).to(cuda))
    kdb.reset_launches()
    buf = feat.clone()
    kdb.dense_layer(buf, lay)
    first = buf.clone()
    kdb.dense_layer(buf, lay, ablate=mode)
    torch.cuda.synchronize()
    ablated = buf.clone()
    kdb.dense_layer(buf, lay)
    torch.cuda.synchronize()
    assert torch.equal(buf, first)
    assert kdb.ablate_launches == {m: int(m == mode) for m in kdb.ABLATIONS}
    assert kdb.mma_launches == {"dense_layer": 2, "transition": 0}
    assert torch.isfinite(ablated.float()).all()
    assert torch.equal(ablated[:, :c], feat[:, :c])
    ref = feat.clone()
    kdb.dense_layer_plain(ref, lay, ablate=mode)
    assert not torch.equal(ablated, first)
    torch.testing.assert_close(ablated.float(), ref.float(),
                               **TOLS[torch.bfloat16])


@pytest.mark.gpu
def test_ablate_raises_off_the_tensor_core_route_on_the_card(cuda):
    feat = torch.zeros(1, 40, 6, 8, device=cuda)
    lay = kdb.FoldedLayer(torch.ones(24, device=cuda),
                          torch.zeros(24, device=cuda),
                          torch.zeros(24, 9, 16, device=cuda),
                          torch.zeros(16, device=cuda))
    kdb.reset_launches()
    with pytest.raises(ValueError, match="tensor-core-route"):
        kdb.dense_layer(feat, lay, ablate="no_taps")
    assert kdb.ablate_launches == {"no_taps": 0, "no_prep": 0}


@pytest.mark.gpu
def test_wrapper_rejects_bad_operands(cuda):
    x, layers, _, _ = _operands(CASES[0], torch.float32, cuda)
    feat = torch.zeros(2, 16, 12, 16, device=cuda)
    bad = layers[0]._replace(scale=layers[0].scale.cpu())
    with pytest.raises(ValueError):
        kdb.dense_layer(feat, bad)
    with pytest.raises(ValueError):  # f64 is not a kernel dtype
        kdb.dense_layer(feat.double(), layers[0])


# the classifier: C of FCDenseNet57/67's last block among them; planes of
# one pixel, a ragged tail with rows not 16-byte aligned (5x7, 33x65), a
# ragged tail with aligned rows (7x8) and the serving plane
CLS_CHANNELS = [20, 100, 288]
CLS_PLANES = [(1, 1), (5, 7), (7, 8), (33, 65), (120, 160)]


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("plane", CLS_PLANES)
@pytest.mark.parametrize("c", CLS_CHANNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_classifier_matches_plain(cuda, dtype, c, plane, b):
    """Against the plain version, with all-zero pixels (the 1e-12 clamp)
    in the first and last image; a second run gives the same bits (the
    partial sums are added in a fixed order), and the C library's shared
    memory is the rule ``classifier_smem`` states."""
    h, w = plane
    gen = torch.Generator().manual_seed(c + h * w + b)
    feat = torch.randn(b, c, h, w, generator=gen)
    feat[0, :, 0, 0] = 0
    feat[-1, :, h // 2] = 0
    feat = feat.to(cuda, dtype)
    wc = torch.zeros(8, c)
    wc[:4] = torch.randn(4, c, generator=gen) * 0.3
    cb = torch.zeros(8)
    cb[:4] = torch.randn(4, generator=gen) * 0.1
    cls = kdb.FoldedClassifier(wc.to(cuda, dtype), cb.to(cuda), 1.0 / 0.05)
    kdb.reset_launches()
    out = kdb.classifier(feat, cls)
    again = kdb.classifier(feat, cls)
    ref = kdb.classifier_plain(feat, cls)
    torch.cuda.synchronize()
    assert kdb.launches["classifier"] == 2
    assert out.shape == (b, 8, h, w) and out.dtype == torch.float32
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, atol=LOGIT_ATOL[dtype], rtol=0)
    # the clamped pixels: (0 + b) / T exactly
    torch.testing.assert_close(out[0, :, 0, 0], cb.to(cuda) * cls.inv_temp,
                               atol=0, rtol=0)
    assert kdb._lib().s2r_classifier_smem(int(dtype == torch.bfloat16),
                                          c) == kdb.classifier_smem(c, dtype)


@pytest.mark.gpu
def test_classifier_rejects_a_buffer_too_wide(cuda):
    c = 801  # f32: one block's tiles would exceed 227 KB
    feat = torch.zeros(1, c, 2, 2, device=cuda)
    cls = kdb.FoldedClassifier(torch.zeros(8, c, device=cuda),
                               torch.zeros(8, device=cuda), 1.0)
    with pytest.raises(ValueError, match="shared memory"):
        kdb.classifier(feat, cls)


# ---------------------------------------------------------------------------
# K1, K2, K3a, K3b (kernels/train_block.py)
# ---------------------------------------------------------------------------

from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb  # noqa: E402
from torch_sites import (DENSE_SITES, DENSE_SITES_57,  # noqa: E402
                         DENSE_SITES_103, LATER, LATER_57, LATER_103,
                         TD_SITES_103)

# (B, H, W, c, g): ragged against the 16x16 tiles and 16-channel groups.
# The g = 4 case must take the CUDA-core route in both dtypes; the g = 16
# ones take the tensor-core K1 and K3a in bf16: FCDenseNet67 widths (48,
# 88, 592: one to ten own-layer chunks, ragged against 32 and 64) on the
# small planes, which cross the 12x16 pixel tile with ragged remainders.
# The g = 12 ones (FCDenseNet57) too, at c 60 and 84 (neither a multiple of
# 8 nor of 16; 84 takes two own-layer chunks) on 7x33, 15x20 and a B=64
# 7x10.
TRAIN_CASES = [(2, 15, 20, 40, 16), (3, 7, 33, 24, 4), (2, 15, 20, 48, 16),
               (2, 7, 10, 88, 16), (3, 3, 5, 592, 16), (1, 26, 35, 88, 16),
               (2, 15, 20, 60, 12), (3, 7, 33, 84, 12), (64, 7, 10, 84, 12)]
# TransitionDown widths (taps 1, n = c) on the tensor-core K2's ragged
# pixel tiles
TD_TRAIN_CASES = [(2, 15, 20, 128, 16), (2, 7, 10, 128, 16),
                  (2, 15, 20, 208, 16), (2, 7, 10, 208, 16)]
CONSUMER_CASES = ([(case, taps) for case in TRAIN_CASES for taps in (9, 1)]
                  + [(case, 1) for case in TD_TRAIN_CASES])


def _rel_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


# f32: summation order only.  bf16: outputs rounded to bf16 may land one
# step (2^-8 relative) apart; f32 sums over bf16 operands differ in order.
TRAIN_REL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}


def _train_operands(case, dtype, device, seed, taps=9, n=None):
    b, h, w, c, g = case
    n = g if n is None else n
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(device)

    x = r(b, c, h, w).to(dtype)
    x[:, 1] = 0                      # z == 0 on a whole plane
    scale = (torch.rand(c, generator=gen) + 0.5).to(device)
    shift = r(c, s=0.3)
    shift[1] = 0
    weight = r(c, taps, n, s=0.3).to(dtype)
    if taps == 9 and n < 16 and ktb.takes_mma_fwd(dtype, taps, c, n):
        weight = kdb.pad_growth(weight)  # as ktb.weight_rows lays it out
    bias = r(n, s=0.1)
    mask = ((torch.rand(b, n, generator=gen) > 0.3).float() / 0.8).to(device)
    mask[:, 0] = 0                   # dropped for the whole batch
    return x, scale, shift, weight, bias, mask


def _rows(w, dtype):
    """Weight rows [c, 9, g] in ``dtype`` as the fused block lays them out:
    padded (``pad_growth``) where the tensor-core stage reads them."""
    g = w.shape[2]
    if g < 16 and ktb.takes_mma_stage(dtype, g):
        return kdb.pad_growth(w, dtype)
    return w.to(dtype)


def _close_all(outs, refs, dtype, what):
    for i, (a, b) in enumerate(zip(outs, refs)):
        err = _rel_err(a, b)
        assert err <= TRAIN_REL[dtype], f"{what} output {i}: {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,taps", CONSUMER_CASES)
def test_consumer_kernels_match_plain(cuda, case, taps, dtype):
    b, h, w, c, g = case
    n = g if taps == 9 else c
    x, scale, shift, weight, bias, mask = _train_operands(
        case, dtype, cuda, 3, taps, n)
    dy = torch.randn(b, n, h, w, device=cuda).to(dtype)
    ktb.reset_launches()
    y = ktb.consumer_fwd(x, scale, shift, weight, bias, mask)
    # K2's 3x3 kernels take contiguous rows
    outs = ktb.consumer_bwd(x, scale, shift, weight.contiguous(), mask, dy)
    torch.cuda.synchronize()
    assert ktb.launches["consumer_fwd"] == 1
    assert ktb.launches["consumer_bwd"] == 1
    assert ktb.mma_launches["consumer_fwd"] == int(
        dtype == torch.bfloat16 and (taps == 1 or n in (12, 16)))
    _close_all([y], [ktb.consumer_fwd_plain(x, scale, shift, weight, bias,
                                            mask)], dtype, "K1")
    _close_all(outs, ktb.consumer_bwd_plain(x, scale, shift, weight, mask,
                                            dy), dtype, "K2")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_later", [0, 2, 4, 5])
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_stage_and_final_kernels_match_plain(cuda, case, n_later, dtype):
    b, h, w, c, g = case
    x, scale, shift, weight, _, mask = _train_operands(case, dtype, cuda, 4)
    # a feature buffer: the layer reads [0, c) and its output sits after
    buf = torch.randn(b, c + g, h, w, device=cuda).to(dtype)
    buf[:, :c] = x
    buf[:, c + 2] = 0
    y = buf[:, c:]
    # the outside cotangent: a channel slice of the block's, in y's dtype,
    # and the statistics' term c0 + c1*y
    dy = torch.randn(b, c + g, h, w, device=cuda).to(dtype)[:, c:]
    c0, c1 = torch.randn(2, g, device=cuda) * 0.5
    gps = [torch.randn(b, g, h, w, device=cuda).to(dtype)
           for _ in range(n_later)]
    # the later layers' y_j rows: slices of their padded rows at growth 12
    wls = [_rows(torch.randn(g + c, 9, g, device=cuda) * 0.3, dtype)[c:]
           for _ in range(n_later)]
    scs = [torch.rand(g, device=cuda) + 0.5 for _ in range(n_later)]
    shs = [torch.randn(g, device=cuda) * 0.3 for _ in range(n_later)]
    for sh in shs:
        sh[2] = 0
    args = (buf, y, dy, c0, c1, gps, wls, scale, shift, scs, shs, weight,
            mask)
    ktb.reset_launches()
    outs = ktb.stage(*args)
    torch.cuda.synchronize()
    assert ktb.mma_launches["stage"] == int(dtype == torch.bfloat16
                                            and g in (12, 16))
    assert ktb.launches["stage"] == 1
    _close_all(outs, ktb.stage_plain(*args), dtype, "K3a")
    again = ktb.stage(*args)  # fixed-order sums: the same bits
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs, again))

    n = 3 + n_later  # up to eight layers: more than are staged at once
    gps = [torch.randn(b, g, h, w, device=cuda).to(dtype) for _ in range(n)]
    wls = [_rows(torch.randn(c + g, 9, g, device=cuda) * 0.3, dtype)[:c]
           for _ in range(n)]
    scs = [torch.rand(c, device=cuda) + 0.5 for _ in range(n)]
    shs = [torch.randn(c, device=cuda) * 0.3 for _ in range(n)]
    for sh in shs:
        sh[1] = 0
    ktb.reset_launches()
    out = ktb.final(buf, gps, wls, scs, shs)
    torch.cuda.synchronize()
    assert ktb.mma_launches["final"] == int(dtype == torch.bfloat16
                                            and g in (12, 16))
    _close_all([out], [ktb.final_plain(buf, gps, wls, scs, shs)], dtype,
               "K3b")


def _stage_site_args(c, g, b, h, w, n_later, device, gen,
                     dtype=torch.bfloat16):
    """K3a's operands at one dense-layer site, seeded from ``gen``: the
    layer's input as channels [0, c) of its block buffer, z == 0 planes
    (a zero shift, and a y channel of the later layers), a channel
    dropped for the whole batch, ``n_later`` later layers."""
    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(device)

    buf = r(b, c + g, h, w).to(dtype)
    buf[:, 1] = 0
    buf[:, c + 2] = 0
    dy = r(b, c + g, h, w).to(dtype)[:, c:]
    c0, c1 = r(2, g, s=0.5)
    scale = (torch.rand(c, generator=gen) + 0.5).to(device)
    shift = r(c, s=0.3)
    shift[1] = 0
    weight = _rows(r(c, 9, g, s=0.3), dtype)
    mask = ((torch.rand(b, g, generator=gen) > 0.3).float() / 0.8).to(device)
    mask[:, 0] = 0
    gps = [r(b, g, h, w).to(dtype) for _ in range(n_later)]
    wls = [_rows(r(c + g, 9, g, s=0.3), dtype)[c:] for _ in range(n_later)]
    scs = [(torch.rand(g, generator=gen) + 0.5).to(device)
           for _ in range(n_later)]
    shs = [r(g, s=0.3) for _ in range(n_later)]
    for sh in shs:
        sh[2] = 0
    return (buf, buf[:, c:], dy, c0, c1, gps, wls, scale, shift, scs, shs,
            weight, mask)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", ["67", "57", "103"])
def test_folded_stage_at_every_dense_site(cuda, model, dtype):
    """K3a with the statistics' cotangent folded into its load at every
    dense-layer site of FCDenseNet67 (55), FCDenseNet57 (44) and
    FCDenseNet103 (91: up to 14 later layers, three rounds of the staged
    sum), B=4, with as many later layers as the site has in its block,
    against its plain version; and K3b, which runs the same sum kernel
    with no outside cotangent, bit for bit against K3a's sum of the same
    later layers from a zero ``dy``, zero ``c0``, ``c1`` and a unit
    mask."""
    sites, later, g = {"67": (DENSE_SITES, LATER, 16),
                       "57": (DENSE_SITES_57, LATER_57, 12),
                       "103": (DENSE_SITES_103, LATER_103, 16)}[model]
    b = 4
    gen = torch.Generator().manual_seed(int(model))
    ktb.reset_launches()
    calls = 0
    for i, ((c, h, w), n_later) in enumerate(zip(sites, later)):
        args = _stage_site_args(c, g, b, h, w, n_later, cuda, gen, dtype)
        buf, y, dy, _, _, gps, wls, scale, shift, scs, shs, weight, _ = args
        _close_all(ktb.stage(*args), ktb.stage_plain(*args), dtype,
                   f"K3a site {i} c{c} {h}x{w}")
        calls += 1
        if n_later:
            zero = torch.zeros(g, device=cuda)
            k3a = ktb.stage(buf, y, torch.zeros_like(dy), zero, zero, gps,
                            wls, scale, shift, scs, shs, weight,
                            torch.ones(b, g, device=cuda))[0]
            assert torch.equal(k3a, ktb.final(y, gps, wls, scs, shs)), i
            calls += 1
    torch.cuda.synchronize()
    assert ktb.launches["stage"] == calls
    assert ktb.mma_launches["stage"] == calls * (dtype == torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["67", "57", "103"])
def test_own_layer_ring_at_every_site_at_the_trained_batch(cuda, model):
    """K3a in bf16 at every dense-layer site of FCDenseNet67 (55), 57 (44)
    and 103 (91) at the trained batch, B=32, with the site's later layers,
    against its plain version: the own-layer kernel's ring over TMA boxes
    at 120x160-30x40 and over the producer warp's copies at 15x20-3x5,
    inputs up to 1,072 channels; and its items on ``stage_items``."""
    sites, later, g = {"67": (DENSE_SITES, LATER, 16),
                       "57": (DENSE_SITES_57, LATER_57, 12),
                       "103": (DENSE_SITES_103, LATER_103, 16)}[model]
    b = 32
    gen = torch.Generator().manual_seed(100 + int(model))
    ktb.reset_launches()
    items = prefetched = 0
    for i, ((c, h, w), n_later) in enumerate(zip(sites, later)):
        args = _stage_site_args(c, g, b, h, w, n_later, cuda, gen)
        _close_all(ktb.stage(*args), ktb.stage_plain(*args), torch.bfloat16,
                   f"K3a site {i} c{c} {h}x{w}")
        n, p = ktb.stage_item_counts(c, b, h, w)
        items += n
        prefetched += p
    torch.cuda.synchronize()
    assert ktb.mma_launches["stage"] == len(sites)
    assert ktb.stage_items == {"items": items, "prefetched": prefetched}
    assert prefetched >= 0.8 * items


# (c, B, H, W) of the own-layer kernel: one item a block (one 3x5 image),
# two (1,072 channels: 17 chunks over 7 splits of 14 images), many (25 a
# block at 120x160); channels no multiple of 64 (48, 200) or of 16 (40,
# 100) on the TMA planes (30x40, 60x80) and on the producer warp's 4-byte
# pairs (15x20, 7x10) and plain copies (3x5, 9x13: odd widths)
RING_CASES = [(48, 1, 3, 5), (1072, 14, 3, 5), (48, 32, 120, 160),
              (40, 3, 30, 40), (200, 4, 60, 80), (100, 5, 15, 20),
              (1072, 6, 7, 10), (24, 2, 9, 13)]


@pytest.mark.gpu
@pytest.mark.parametrize("g", [16, 12])
@pytest.mark.parametrize("case", RING_CASES, ids=lambda s: "c%d_b%d_%dx%d" % s)
def test_own_layer_ring_blocks_and_graph(cuda, case, g):
    """K3a in bf16 against its plain version where the own-layer kernel's
    blocks walk one, two or many items; the same bits on a second call
    (fixed-order sums); its items on ``stage_items``; and a CUDA-graph
    capture of the call, replayed three times, equal to the eager call."""
    c, b, h, w = case
    gen = torch.Generator().manual_seed(c + b)
    args = _stage_site_args(c, g, b, h, w, 2, cuda, gen)
    ktb.reset_launches()
    eager = ktb.stage(*args)
    torch.cuda.synchronize()
    assert ktb.mma_launches["stage"] == 1
    items, prefetched = ktb.stage_item_counts(c, b, h, w)
    assert ktb.stage_items == {"items": items, "prefetched": prefetched}
    _close_all(eager, ktb.stage_plain(*args), torch.bfloat16,
               f"K3a c{c} B={b} {h}x{w}")
    again = ktb.stage(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, e) for a, e in zip(again, eager))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ktb.stage(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ktb.stage(*args)
    for _ in range(3):
        for o in captured:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, e) for a, e in zip(captured, eager))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [TRAIN_CASES[0], TRAIN_CASES[3],
                                  TRAIN_CASES[6], TRAIN_CASES[8]])
def test_consumer_fwd_writes_in_place(cuda, case, dtype):
    """K1 as the dense block calls it: the input is channels [0, c) of a
    wider buffer and the output its channels [c, c + g)."""
    b, h, w, c, g = case
    x, scale, shift, weight, bias, mask = _train_operands(case, dtype, cuda, 6)
    buf = torch.full((b, c + g + 8, h, w), 7.0, device=cuda).to(dtype)
    buf[:, :c] = x
    ref = ktb.consumer_fwd_plain(buf, scale, shift, weight, bias, mask)
    out = ktb.consumer_fwd(buf, scale, shift, weight, bias, mask,
                           out=buf[:, c:c + g])
    torch.cuda.synchronize()
    assert out.data_ptr() == buf[:, c:].data_ptr()
    _close_all([buf[:, c:c + g]], [ref], dtype, "K1 in place")
    assert torch.equal(buf[:, :c], x) and bool((buf[:, c + g:] == 7).all())


@pytest.mark.gpu
def test_train_wrappers_reject_bad_operands(cuda):
    x, scale, shift, weight, bias, mask = _train_operands(
        TRAIN_CASES[0], torch.float32, cuda, 5)
    with pytest.raises(ValueError):
        ktb.consumer_fwd(x, scale.cpu(), shift, weight, bias, mask)
    with pytest.raises(ValueError):  # channels are not contiguous planes
        ktb.consumer_fwd(x.transpose(2, 3), scale, shift, weight, bias, mask)


# (B, H, W, C, N, spare) for the bf16 TransitionDown kernels, serving's
# forward, K1 with one tap and K2, whose tiles run over the B*H*W positions
# of all images: C and N not multiples of 16 (40 -> 24, 88 -> 60), H*W
# not a multiple of 8 (7x10, 15x20, and an odd 3x5 and 7x33), H*W < 128
# with B > 1 (a tile spans images), FCDenseNet67's last site at B=64 and
# FCDenseNet103's (656) beside the old cap (624), and the first site's
# 120x160.  The planes with H*W % 8 == 0 (8x16, 30x40, 60x80, 120x160;
# C ragged against the 64-channel slices) take the TMA kernel, the others
# the flat one.  spare: channels the buffer holds past C (x is a channel
# view with a wider batch stride).
TD_CASES = [(2, 15, 20, 40, 24, 0), (3, 7, 10, 88, 60, 8),
            (5, 3, 5, 20, 36, 0), (2, 7, 33, 128, 208, 16),
            (64, 7, 10, 448, 448, 0), (32, 7, 10, 656, 656, 0),
            (2, 15, 20, 624, 624, 0), (4, 7, 10, 656, 656, 16),
            (2, 120, 160, 128, 128, 0), (2, 8, 16, 40, 24, 0),
            (3, 30, 40, 208, 208, 0), (2, 60, 80, 96, 96, 8),
            (2, 30, 40, 656, 656, 0)]
# and every TransitionDown site of FCDenseNet103 at B=8
TD_CASES += [(8, h, w, c, c, 0) for c, h, w in TD_SITES_103]


def _td_operands(case, device, seed):
    b, h, w, c, n, spare = case
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=gen) * s

    buf = r(b, c + spare, h, w)
    buf[:, 1] = 0                    # z == 0 on a whole plane
    shift = r(c, s=0.3)
    shift[1] = 0
    mask = (torch.rand(b, n, generator=gen) > 0.3).float() / 0.7
    mask[:, 0] = 0                   # dropped for the whole batch
    ops = dict(buf=buf.to(torch.bfloat16),
               scale=torch.rand(c, generator=gen) + 0.5, shift=shift,
               weight=r(c, n, s=(2 / c) ** 0.5).to(torch.bfloat16),
               bias=r(n, s=0.1), mask=mask,
               dy=r(b, n, h, w).to(torch.bfloat16))
    ops = {k: v.to(device) for k, v in ops.items()}
    ops["x"] = ops["buf"][:, :c]
    return ops


@pytest.mark.gpu
@pytest.mark.parametrize("case", TD_CASES, ids=lambda c: "b%d_%dx%d_c%d_n%d_s%d" % c)
def test_transition_down_kernels_match_plain(cuda, case):
    """Serving's TransitionDown (T(T(sum) + T(bias))), K1 with one tap
    (T((sum + bias) * mask)) and K2 against their plain versions, each
    launch on the tensor-core route as the C library reports it, and K2's
    sums the same bits over two runs (fixed order, no atomics)."""
    o = _td_operands(case, cuda, 21)
    x, w3 = o["x"], o["weight"][:, None, :]
    td = kdb.FoldedTransition(o["scale"], o["shift"], o["weight"], o["bias"])
    fwd = (x, o["scale"], o["shift"], w3, o["bias"], o["mask"])
    bwd = (x, o["scale"], o["shift"], w3, o["mask"], o["dy"])
    kdb.reset_launches()
    ktb.reset_launches()
    serving = kdb.transition(x.contiguous(), td)
    y = ktb.consumer_fwd(*fwd)
    outs = ktb.consumer_bwd(*bwd)
    again = ktb.consumer_bwd(*bwd)
    torch.cuda.synchronize()
    assert kdb.mma_launches["transition"] == 1
    assert ktb.mma_launches["consumer_fwd"] == 1
    assert ktb.mma_launches["consumer_bwd"] == 2
    errs = {"serving": [_rel_err(serving, kdb.transition_plain(x.contiguous(),
                                                               td))],
            "K1": [_rel_err(y, ktb.consumer_fwd_plain(*fwd))],
            "K2": [_rel_err(a, b) for a, b in
                   zip(outs, ktb.consumer_bwd_plain(*bwd))]}
    assert all(e <= TRAIN_REL[torch.bfloat16] for v in errs.values()
               for e in v), errs
    assert all(torch.equal(a, b) for a, b in zip(outs, again))


# ---------------------------------------------------------------------------
# K6 (kernels/int8_body.py) and K5 (kernels/labelgen.py)
# ---------------------------------------------------------------------------

from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY  # noqa: E402
from sim2real_lane_segment_tpu_torch.kernels import int8_body as kib  # noqa: E402
from sim2real_lane_segment_tpu_torch.kernels import labelgen as klg  # noqa: E402
from sim2real_lane_segment_tpu_torch.models.lanenet_fused import (  # noqa: E402
    fold_body, stem_rows)
from sim2real_lane_segment_tpu_torch.models.lanenet_int8 import \
    quantize_lanenet  # noqa: E402
from sim2real_lane_segment_tpu_torch.models.lanenet_lite import \
    LaneNetLite  # noqa: E402

# (stem, body, H, W): a small net, and the full widths at 120x160 (30x40
# rows: 19 tiles of 64 pixels, the last ragged; 96 outputs: 64 + 32)
LITE_CASES = [((8, 16), ((16, 1), (16, 2), (32, 4)), 26, 34),
              ((32, 64), ((64, 1), (64, 1), (96, 2), (96, 4), (128, 1)),
               120, 160)]


def _random_lite(stem, body, device, seed):
    gen = torch.Generator().manual_seed(seed)
    model = LaneNetLite(4, stem=stem, body=body, policy=F32_POLICY)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / fan_in) ** 0.5)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                                 generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape,
                                               generator=gen) + 0.5)
    return model.to(device).eval()


@pytest.mark.gpu
@pytest.mark.parametrize("case", LITE_CASES)
def test_int8_body_matches_plain(cuda, case):
    """Every conv site's input codes equal; logits within the head's f32
    reordering (rtol 1e-5, atol 1e-4, as the JAX kernel's own gate)."""
    stem, body, h, w = case
    model = _random_lite(stem, body, cuda, 6)
    gen = torch.Generator().manual_seed(7)
    calib = torch.randn(4, h, w, 3, generator=gen).to(cuda)
    qn = quantize_lanenet(model, calib)
    rows, hh, ww = stem_rows(qn, torch.randn(3, h, w, 3, generator=gen).to(
        cuda))
    folded = fold_body(qn)
    kib.reset_launches()
    codes, codes_plain = {}, {}
    out = kib.int8_body(rows, folded, hh, ww, record=codes)
    ref = kib.int8_body_plain(rows, folded, hh, ww, record=codes_plain)
    torch.cuda.synchronize()
    n_short = sum(s is not None for _, _, s in folded.blocks)
    assert kib.launches == {"quant": 1, "conv": 2 * len(body) + n_short,
                            "head": 1}
    specs = [s for blk in folded.blocks for s in blk if s is not None]
    assert kib.mma_launches == {"conv": sum(kib.takes_imma(
        s.w_rows.shape[0] // s.taps, s.w_rows.shape[1], s.taps, s.dilation)
        for s in specs)}
    assert codes.keys() == codes_plain.keys() and len(codes) == 2 * len(body)
    for name, q in codes.items():
        assert q.dtype == torch.int8
        assert torch.equal(q, codes_plain[name]), name
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


# (taps, dilation, cin, cout, zp, H, W) of one conv site: the int8
# tensor cores at dilations 1, 2 and 4, cin 32-128, both zero points,
# planes ragged against the 16x8 pixel tile, one and two halo tiles in
# shared memory, the 1x1 shortcut, 136 outputs (two 128-output slices);
# and on the CUDA cores a 16-channel site and one whose weights do not fit
IMMA_CASES = [(9, 1, 32, 32, 128, 13, 19), (9, 2, 64, 96, 128, 30, 40),
              (9, 4, 96, 96, 0, 30, 40), (9, 4, 128, 128, 128, 17, 9),
              (1, 1, 64, 96, 128, 30, 40), (9, 1, 128, 64, 0, 5, 3),
              (9, 2, 32, 136, 128, 11, 12), (9, 1, 128, 128, 0, 30, 40),
              (9, 1, 16, 32, 128, 13, 19), (9, 1, 256, 96, 128, 7, 9)]


# (B, taps, dilation, cin, cout, zp, H, W): more (image, tile) items than
# the card has persistent blocks, so each block walks several and stages
# the next in the other halo buffer (2 tiles: 64 -> 64 at 30x40) or
# restages its one buffer (1 tile: 128 -> 128 at dilation 4)
IMMA_PERSISTENT_CASES = [(16, 9, 1, 64, 64, 128, 30, 40),
                         (64, 9, 4, 128, 128, 128, 17, 9)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", IMMA_CASES)
def test_int8_conv_site_matches_plain(cuda, case):
    """One conv launch with the residual, f32 output and requant: the f32
    outputs and the next codes bit-equal to the plain version."""
    _check_conv_site(cuda, 3, *case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", IMMA_PERSISTENT_CASES)
def test_int8_conv_site_persistent_blocks(cuda, case):
    """As above where every block walks several items: bit-equal, on the
    tensor cores with the halo buffers ``imma_tiles`` gives."""
    b, taps, dil, cin, cout, zp, h, w = case
    th, tw = kib.IMMA_TILE
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert b * -(-h // th) * -(-w // tw) > sms
    _check_conv_site(cuda, b, taps, dil, cin, cout, zp, h, w)
    tiles = kib.imma_tiles(cin, cout, taps, dil)
    assert kib.imma_buffers == {1: int(tiles == 1), 2: int(tiles == 2)}


def _check_conv_site(cuda, b, taps, dil, cin, cout, zp, h, w):
    rng = np.random.default_rng(cin + cout + dil)
    k = 3 if taps == 9 else 1
    w_q = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    site = dict(
        w_q=torch.from_numpy(w_q).to(cuda),
        w_scale=torch.from_numpy(rng.uniform(1e-3, 1e-2, cout).astype(
            np.float32)).to(cuda),
        w_colsum=torch.from_numpy(w_q.astype(np.int64).sum((0, 1, 2)).astype(
            np.float32)).to(cuda),
        bias=torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32)).to(
            cuda),
        act_scale=torch.tensor(np.float32(0.02), device=cuda), zp=zp,
        dilation=dil, relu=taps == 9)
    spec = kib.conv_spec("site", site)
    nxt = spec._replace(act_scale=torch.tensor(np.float32(0.03), device=cuda),
                        act=float(np.float32(0.03)), zp=128)
    q = torch.from_numpy(rng.integers(-128, 128, (b, h * w, cin)).astype(
        np.int8)).to(cuda)
    res = torch.from_numpy(rng.normal(0, 1, (b, h * w, cout)).astype(
        np.float32)).to(cuda)
    kib.reset_launches()
    y, codes = kib._conv(q, spec, h, w, res=res, out_f=True, nxt=nxt)
    torch.cuda.synchronize()
    y_ref = torch.clamp(kib._conv_plain(q, spec, h, w) + res, min=0.0)
    assert kib.mma_launches == {"conv": int(kib.takes_imma(cin, cout, taps,
                                                           dil))}
    assert kib._lib().s2r_i8_imma_tiles(taps, dil, cin, cout) == \
        kib.imma_tiles(cin, cout, taps, dil)
    assert torch.equal(y, y_ref)
    assert torch.equal(codes, kib.quantize_plain(y_ref, nxt.act_scale, 128))


@pytest.mark.gpu
def test_int8_body_rejects_bad_operands(cuda):
    stem, body, h, w = LITE_CASES[0]
    qn = quantize_lanenet(_random_lite(stem, body, cuda, 8),
                          torch.randn(2, h, w, 3, device=cuda))
    bd = fold_body(qn)
    x = torch.randn(2, (h // 4 + 1) * (w // 4 + 1), 16, device=cuda)
    with pytest.raises(ValueError):  # f64 is not the kernel's dtype
        kib.int8_body(x.double(), bd, h // 4 + 1, w // 4 + 1)
    with pytest.raises(ValueError):  # rows do not match h*w
        kib.int8_body(x, bd, h // 4, w // 4)


def _label_pairs(n, h, w, seed):
    """Seeded uint8 frame pairs with regions of every class rule, noise,
    and runs thinner than the 5x5 window."""
    rng = np.random.default_rng(seed)
    orig = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    delta = np.zeros((n, h, w, 3), np.int64)
    # per-channel deltas that make each rule fire alone or together
    kinds = np.array([(0, 60, 0), (60, 0, 0), (0, 0, 60), (-60, 0, 0),
                      (0, -60, 0), (60, 60, -60), (0, 60, -60)])
    for _ in range(10):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        dy, dx = rng.integers(1, h // 3 + 2), rng.integers(1, w // 3 + 2)
        delta[:, y0:y0 + dy, x0:x0 + dx] += kinds[rng.integers(len(kinds))]
    noise = rng.random(orig.shape) < 0.03
    delta += noise * rng.integers(-30, 31, orig.shape)
    annot = np.clip(orig.astype(np.int64) + delta, 0, 255).astype(np.uint8)
    return torch.from_numpy(orig), torch.from_numpy(annot)


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["bgr", "rgb"])
@pytest.mark.parametrize("shape", [(3, 120, 160), (2, 100, 70), (4, 5, 7),
                                   (1, 33, 65)])
def test_labelgen_matches_plain(cuda, shape, order):
    """Bit-exact: strips ragged against the 32 rows and words ragged
    against the 32 pixels, images smaller than one block's 8-row halo."""
    orig, annot = _label_pairs(*shape, seed=sum(shape))
    ref = klg.process_classes_plain(orig, annot, order)
    klg.reset_launches()
    out = klg.process_classes(orig.to(cuda), annot.to(cuda), order)
    torch.cuda.synchronize()
    assert klg.launches["labelgen"] == 1
    assert out.dtype == torch.uint8 and out.shape == ref.shape
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(klg.process_classes_plain(orig.to(cuda),
                                                 annot.to(cuda), order).cpu(),
                       ref)
    if shape[1] >= 100:
        assert len(torch.unique(ref)) == 4


def _check_labels(cuda, orig, annot, order):
    """K5 bit-exact against plain, twice (the same bits), one launch each."""
    ref = klg.process_classes_plain(orig, annot, order)
    klg.reset_launches()
    out = klg.process_classes(orig.to(cuda), annot.to(cuda), order)
    again = klg.process_classes(orig.to(cuda), annot.to(cuda), order)
    torch.cuda.synchronize()
    assert klg.launches["labelgen"] == 2
    assert out.dtype == torch.uint8 and out.shape == ref.shape
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), ref)
    return ref


# widths across the 32-pixel words and 16-byte rows, the model's and the
# simulator's widths, and frames of two and three column tiles; heights
# below the 32-row strip and not a multiple of it
LABEL_WIDTHS = [1, 31, 32, 33, 63, 64, 65, 160, 640, 1100, 2100]
LABEL_HEIGHTS = [5, 45]


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["bgr", "rgb"])
@pytest.mark.parametrize("h", LABEL_HEIGHTS)
@pytest.mark.parametrize("w", LABEL_WIDTHS)
def test_labelgen_widths_and_heights(cuda, w, h, order):
    orig, annot = _label_pairs(2, h, w, seed=w + h)
    _check_labels(cuda, orig, annot, order)
    g = (ctypes.c_int * 6)()
    klg._lib().s2r_labelgen_geometry(h, w, g)
    assert tuple(g) == tuple(klg.geometry(h, w))


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["bgr", "rgb"])
@pytest.mark.parametrize("fill", [0, 255])
def test_labelgen_uniform_masks(cuda, fill, order):
    """Every pixel in one class (fill 255: obstacle, whose erosion must
    keep the image border) or none (fill 0), on 16-byte rows and not."""
    for h, w in ((40, 64), (37, 70)):
        orig = torch.zeros(1, h, w, 3, dtype=torch.uint8)
        annot = torch.full((1, h, w, 3), fill, dtype=torch.uint8)
        ref = _check_labels(cuda, orig, annot, order)
        assert torch.equal(ref, torch.full_like(ref, 3 if fill else 0))


@pytest.mark.gpu
def test_labelgen_unaligned_frames(cuda):
    """Frames whose storage does not start on 16 bytes take the byte
    loads and stores: the same bits."""
    orig, annot = _label_pairs(2, 40, 64, seed=3)
    ref = klg.process_classes_plain(orig, annot)
    n = orig.numel()
    o = torch.empty(n + 1, dtype=torch.uint8, device=cuda)[1:]
    a = torch.empty(n + 1, dtype=torch.uint8, device=cuda)[1:]
    o.copy_(orig.reshape(-1))
    a.copy_(annot.reshape(-1))
    out = klg.process_classes(o.view(orig.shape), a.view(annot.shape))
    assert out.data_ptr() % 16 == 0 and o.data_ptr() % 16 == 1
    assert torch.equal(out.cpu(), ref)


# ---------------------------------------------------------------------------
# the training regimes on the card: augmentation and the MME step
# ---------------------------------------------------------------------------

import contextlib  # noqa: E402
from unittest import mock  # noqa: E402

from sim2real_lane_segment_tpu_torch.models.tiramisu import (  # noqa: E402
    DenseLayer, FCDenseNet, drop_masks)
from sim2real_lane_segment_tpu_torch.ops import augment as aug  # noqa: E402
from sim2real_lane_segment_tpu_torch.train.mme import MMETrainer  # noqa: E402

TRAIN_WRAPPERS = ("consumer_fwd", "consumer_bwd", "stage", "final")
# growth 16: the bf16 sites take the tensor-core routes
SMALL_MME_NET = dict(n_classes=4, down_blocks=(2, 2), up_blocks=(2, 2),
                     bottleneck_layers=2, growth_rate=16,
                     out_chans_first_conv=16)


@pytest.mark.gpu
@pytest.mark.parametrize("src", [(120, 160), (61, 83)])
def test_augment_batch_on_the_card_matches_the_cpu(cuda, src):
    """The same draws on the card and on the CPU: the same crops (labels
    equal) and images within float32 reordering (normalized values)."""
    cfg = aug.AugmentConfig(height=48, width=64, min_crop_height=24,
                            max_crop_height=192)
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.integers(0, 256, (6, *src, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 4, (6, *src), dtype=np.uint8))
    draws = aug.draw_augment(torch.Generator().manual_seed(1), 6, cfg, "cpu")
    x, y = aug.augment_batch(images, labels, cfg, draws)
    xc, yc = aug.augment_batch(images.to(cuda), labels.to(cuda), cfg,
                               draws.to(cuda))
    assert torch.equal(yc.cpu(), y)
    torch.testing.assert_close(xc.cpu(), x, atol=1e-4, rtol=0)
    on_card = aug.draw_augment(torch.Generator().manual_seed(1), 6, cfg,
                               cuda)
    assert all(t.device == xc.device for t in on_card)


def _mme_trainer(cuda, seed):
    torch.manual_seed(seed)
    model = FCDenseNet(**SMALL_MME_NET, policy=F32_POLICY)
    return MMETrainer(num_cls=4, height=32, width=48, model=model,
                      augment=True, pallas_train=True, device=cuda)


def _mme_operands(trainer, cuda):
    rng = np.random.default_rng(3)
    lab = rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)
    y = rng.integers(0, 4, (2, 40, 56), dtype=np.uint8)
    unl = rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)
    gen = torch.Generator().manual_seed(4)
    kw = dict(draws_l=aug.draw_augment(gen, 2, trainer.cfg, cuda),
              draws_u=aug.draw_augment(gen, 2, trainer.cfg, cuda),
              masks_g=drop_masks(gen, trainer.model, 2, cuda),
              masks_f=drop_masks(gen, trainer.model, 2, cuda))
    return (lab, y, unl, 3e-3, 1e-2, 1e-3), kw


@pytest.mark.gpu
def test_mme_step_kernels_match_plain(cuda):
    """One augmented float32 MME step through K1-K3b against the same step
    through their plain versions: both losses, both optimizers' first
    moments (phase G's and phase F's gradients) and the running
    statistics, each within 1e-3 of its scale (floored at 1e-2 of the
    largest, as a gradient that is zero in exact arithmetic is noise)."""
    steps = []
    for plain in (False, True):
        trainer = _mme_trainer(cuda, 0)
        args, kw = _mme_operands(trainer, cuda)
        ktb.reset_launches()
        with (mock.patch.multiple(ktb, **{k: getattr(ktb, f"{k}_plain")
                                          for k in TRAIN_WRAPPERS})
              if plain else contextlib.nullcontext()):
            logs = trainer.mme_train_step(*args, **kw)
        torch.cuda.synchronize()
        if not plain:
            assert all(ktb.launches[k] > 0 for k in TRAIN_WRAPPERS)
        steps.append((logs, trainer))
    (logs, tk), (ref, tp) = steps
    for k in ("tr_loss_adent", "tr_loss"):
        assert _rel_err(logs[k], ref[k]) <= 1e-4, k
    for name, a, b in (("sgd", tk.opt_g.trace, tp.opt_g.trace),
                       ("adam", tk.opt.mu, tp.opt.mu)):
        big = max(t.abs().max().item() for t in b)
        for i, (x, r) in enumerate(zip(a, b)):
            err = (x - r).abs().max().item() / max(r.abs().max().item(),
                                                   1e-2 * big)
            assert err <= 1e-3, (name, i, err)
    for (k, x), r in zip(tk.model.state_dict().items(),
                         tp.model.state_dict().values()):
        if "running" in k:
            assert _rel_err(x, r) <= 1e-4, k


@pytest.mark.gpu
def test_mme_pallas_train_never_runs_the_plain_step(cuda):
    """``MMETrainer(pallas_train=True)`` on a card: both phases launch the
    kernels and neither the plain module nor a plain kernel version runs."""
    trainer = _mme_trainer(cuda, 1)
    args, kw = _mme_operands(trainer, cuda)

    def refuse(*a, **k):
        raise AssertionError("a plain path ran")

    ktb.reset_launches()
    with mock.patch.multiple(ktb, **{f"{k}_plain": refuse
                                     for k in TRAIN_WRAPPERS}), \
            mock.patch.object(FCDenseNet, "forward", refuse), \
            mock.patch.object(type(trainer.model.featureExtractor),
                              "forward", refuse):
        logs = trainer.mme_train_step(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.isfinite(v) for v in logs.values())
    # two train-mode passes, each over 2 + 2 + 2 + 2 + 2 dense layers and
    # two TransitionDowns
    assert ktb.launches["consumer_fwd"] == 2 * (10 + 2)
    assert ktb.launches["consumer_bwd"] == 2 * 2
    assert ktb.launches["stage"] == 2 * 10
    assert ktb.launches["final"] == 2 * 5


# ---------------------------------------------------------------------------
# the multi-step dispatch: the step captured as a CUDA graph
# ---------------------------------------------------------------------------

from sim2real_lane_segment_tpu_torch.core.dtypes import \
    DEFAULT_POLICY  # noqa: E402
from sim2real_lane_segment_tpu_torch.data.device_cache import \
    DeviceCachedView  # noqa: E402
from sim2real_lane_segment_tpu_torch.train import graphs  # noqa: E402
from sim2real_lane_segment_tpu_torch.train.supervised import \
    SupervisedTrainer  # noqa: E402


def _graph_trainers(cuda, regime, fused, augment, worlds=(None, None),
                    **kw):
    """Two identical trainers (bf16, growth 16: the tensor-core routes);
    ``worlds``: each one's data-parallel world; ``kw``: the model's
    (``remat``) and the trainers' (``fast_train``) options."""
    out = []
    remat = kw.pop("remat", False)
    for world in worlds:
        torch.manual_seed(5)
        model = FCDenseNet(**SMALL_MME_NET, policy=DEFAULT_POLICY,
                           remat=remat)
        cls = MMETrainer if regime == "mme" else SupervisedTrainer
        out.append(cls(num_cls=4, height=32, width=48, model=model,
                       augment=augment, pallas_train=fused, world=world,
                       device=cuda, **kw))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("regime,fused,augment", [
    ("sim", True, True), ("mme", True, True), ("sim", False, False),
    ("mme", False, True)])
def test_graphed_steps_equal_eager_steps(cuda, regime, fused, augment):
    """Three steps of ``run_scan_chunk`` (captured once, replayed three
    times) against three eager steps on the same gathered rows and the
    same generator: logged values, weights, running statistics and
    optimizer state equal, bit for bit, at B=4; through the kernels and
    through the plain module, with and without augmentation."""
    _check_graphed_vs_eager(cuda, regime,
                            *_graph_trainers(cuda, regime, fused, augment))


def _check_graphed_vs_eager(cuda, regime, graphed, eager):
    rng = np.random.default_rng(9)
    views = [DeviceCachedView.from_arrays(
        rng.integers(0, 256, (10, 40, 56, 3), dtype=np.uint8),
        rng.integers(0, 4, (10, 40, 56), dtype=np.uint8), cuda)]
    arrays = (views[0].images, views[0].labels)
    idx = rng.integers(0, 10, (3, 4))
    if regime == "mme":
        views.append(DeviceCachedView.from_arrays(
            rng.integers(0, 256, (12, 40, 56, 3), dtype=np.uint8), None,
            cuda))
        arrays = arrays + (views[1].images,)
        idx = np.stack([idx, rng.integers(0, 12, (3, 4))], axis=1)
    graphs.reset_counts()
    ktb.reset_launches()
    logs = graphed.run_scan_chunk(arrays, idx, torch.Generator().manual_seed(
        2), 1)
    assert graphs.counts == {"captures": 1, "replays": 3}
    # the kernels launch at the capture only (its warm-up steps and the
    # captured one): one K3a a dense layer a pass
    dense = sum(isinstance(m, DenseLayer) for m in graphed.model.modules())
    passes = 2 if regime == "mme" else 1
    k3a = (dense * passes * (graphs.WARMUP_STEPS + 1)
           if graphed.pallas_train else 0)
    assert ktb.launches["stage"] == k3a
    gen = torch.Generator().manual_seed(2)
    ref = []
    for row in idx:
        if regime == "mme":
            lab, unl = torch.from_numpy(row).to(cuda)
            out = eager.mme_train_step(
                arrays[0][lab], arrays[1][lab], arrays[2][unl],
                *eager.lrs_at(1), generator=gen)
        else:
            r = torch.from_numpy(row).to(cuda)
            out = eager.train_step(arrays[0][r], arrays[1][r],
                                   eager.lr_at(1), generator=gen)
        ref.append(torch.stack(list(out.values())))
    ref = torch.stack(ref)
    torch.cuda.synchronize()
    got = torch.stack(list(logs.values()), 1)
    assert torch.equal(got, ref), (got, ref)
    for (k, a), b in zip(graphed.model.state_dict().items(),
                         eager.model.state_dict().values()):
        assert torch.equal(a, b), k
    opts = [(graphed.opt, eager.opt)]
    if regime == "mme":
        opts.append((graphed.opt_g, eager.opt_g))
    for a, b in opts:
        for x, y in zip(a.tensors(), b.tensors(), strict=True):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the trainer's surface: --fast_train, 67r (remat), --dp
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one(cuda):
    """A one-rank NCCL world on the card, ended after the test."""
    from sim2real_lane_segment_tpu_torch.parallel import multihost

    world, owned = multihost.init_world(cuda)
    yield world
    if owned:
        multihost.close_world()


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fast", "remat"])
@pytest.mark.parametrize("regime", ["sim", "mme"])
def test_graphed_fast_and_remat_steps_equal_eager_steps(cuda, regime, route):
    """``--fast_train`` and ``67r``'s checkpointed blocks inside the CUDA
    graph: three replays equal three eager steps bit for bit."""
    kw = {"fast": dict(fast_train=True), "remat": dict(remat=True)}[route]
    _check_graphed_vs_eager(cuda, regime, *_graph_trainers(
        cuda, regime, False, True, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("regime,fused", [("sim", False), ("sim", True),
                                          ("mme", True)])
def test_one_rank_nccl_graphed_equals_dp_off_eager(world_of_one, regime,
                                                   fused):
    """``--dp`` in a world of one: the steps' all-reduces captured in the
    CUDA graph, three replays bit-equal to three eager steps without a
    world (``--dp off``)."""
    cuda = world_of_one.device
    _check_graphed_vs_eager(cuda, regime, *_graph_trainers(
        cuda, regime, fused, True, worlds=(world_of_one, None)))


@pytest.mark.gpu
def test_remat_pallas_train_is_the_kernel_step(cuda):
    """Under ``--pallas_train`` the kernels run their own backward and
    ``67r``'s checkpointing does not apply: the same launches and the
    same step, bit for bit, as without it."""
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (4, 32, 48, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (4, 32, 48), dtype=np.uint8)
    runs = []
    for remat in (False, True):
        torch.manual_seed(5)
        model = FCDenseNet(**SMALL_MME_NET, policy=DEFAULT_POLICY,
                           remat=remat)
        tr = SupervisedTrainer(num_cls=4, height=32, width=48, model=model,
                               pallas_train=True, device=cuda)
        ktb.reset_launches()
        logs = tr.train_step(images, labels, 1e-3,
                             generator=torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        runs.append((dict(ktb.launches), logs, tr.model.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert l0 == l1 and all(v > 0 for v in l0.values())
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


@pytest.mark.gpu
def test_remat_lowers_peak_memory_and_keeps_the_step(cuda):
    """The plain step of the small FC-DenseNet at B=8, 96x128, with and
    without checkpointed blocks: losses within 1e-5 (relative; cuDNN's
    backward may sum in another order) and a lower peak of allocated
    memory with them."""
    rng = np.random.default_rng(12)
    images = rng.integers(0, 256, (8, 96, 128, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (8, 96, 128), dtype=np.uint8)
    peaks, losses = [], []
    for remat in (False, True):
        torch.manual_seed(5)
        model = FCDenseNet(**SMALL_MME_NET, policy=DEFAULT_POLICY,
                           remat=remat)
        tr = SupervisedTrainer(num_cls=4, height=96, width=128, model=model,
                               device=cuda)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        logs = tr.train_step(images, labels, 1e-3,
                             generator=torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        losses.append(float(logs["tr_loss"]))
        del tr, model
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    assert peaks[1] < peaks[0], peaks


# ---------------------------------------------------------------------------
# distillation (the teacher through K4) and LaneNetLite's train step
# ---------------------------------------------------------------------------

from sim2real_lane_segment_tpu_torch.train.distill import \
    DistillTrainer  # noqa: E402

LITE_SMALL = dict(stem=(8, 16), body=((16, 1), (16, 2), (24, 1)))
# the whole-network logits of the bf16 teacher: ``chip_smoke.py`` phase 3's
# bfloat16 logit tolerance and argmax agreement; float32: its 1e-3
TEACHER_ATOL = {torch.float32: 1e-3, torch.bfloat16: 0.25}


@pytest.mark.gpu
@pytest.mark.parametrize("policy", [F32_POLICY, DEFAULT_POLICY],
                         ids=["float32", "bfloat16"])
def test_distill_teacher_logits_through_k4_match_plain(cuda, policy):
    """A distillation step's teacher on the card runs through K4 (every
    dense layer, TransitionDown and the classifier, each launched once a
    step), and its logits equal the plain teacher's on the same x."""
    torch.manual_seed(11)
    teacher = FCDenseNet(**SMALL_MME_NET, policy=policy)
    tr = DistillTrainer(teacher=teacher, num_cls=4, height=32, width=48,
                        augment=True, student_model=LaneNetLite(
                            4, **LITE_SMALL), device=cuda)
    rng = np.random.default_rng(12)
    images = rng.integers(0, 256, (3, 40, 56, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (3, 40, 56), dtype=np.uint8)
    gen = torch.Generator().manual_seed(13)
    x, _ = tr._prepare(images, labels, tr._draw(gen, 3, None))
    kdb.reset_launches()
    got = tr.teacher_logits(x)
    with torch.no_grad():
        ref = teacher(x, use_softmax=False)
    torch.cuda.synchronize()
    assert kdb.launches == {"dense_layer": 10, "transition": 2,
                            "classifier": 1}
    assert (got - ref).abs().max().item() <= TEACHER_ATOL[policy.compute_dtype]
    assert (got.argmax(1) == ref.argmax(1)).float().mean().item() >= 0.99
    kdb.reset_launches()
    logs = tr.train_step(images, labels, 1e-3, generator=gen)
    torch.cuda.synchronize()
    assert kdb.launches["dense_layer"] == 10
    assert all(torch.isfinite(v) for v in logs.values())


def _lite_step(device, policy):
    """One augmented SupervisedTrainer step of a small LaneNetLite on
    ``device``, on draws made on the CPU."""
    torch.manual_seed(14)
    model = LaneNetLite(4, policy=policy, **LITE_SMALL)
    tr = SupervisedTrainer(num_cls=4, height=32, width=48, model=model,
                           augment=True, device=device)
    rng = np.random.default_rng(15)
    images = rng.integers(0, 256, (4, 40, 56, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (4, 40, 56), dtype=np.uint8)
    draws = aug.draw_augment(torch.Generator().manual_seed(16), 4, tr.cfg,
                             "cpu")
    logs = tr.train_step(images, labels, 1e-3, draws=draws)
    return tr, {k: float(v) for k, v in logs.items()}


@pytest.mark.gpu
def test_lite_train_step_on_the_card_matches_the_cpu(cuda):
    """A float32 LaneNetLite step on the card against the same step on the
    CPU: the loss within 1e-5 relative, Adam's first moment (the
    gradient) per parameter within 1e-3 of its scale (floored at 1e-2 of
    the largest: a gradient that is zero in exact arithmetic is noise),
    the running statistics within 1e-4 relative (cuDNN and the CPU sum
    the convolutions in another order; TF32 off)."""
    card, logs = _lite_step(cuda, F32_POLICY)
    cpu, ref = _lite_step("cpu", F32_POLICY)
    assert abs(logs["tr_loss"] - ref["tr_loss"]) <= 1e-5 * abs(ref["tr_loss"])
    big = max(t.abs().max().item() for t in cpu.opt.mu)
    for i, (a, b) in enumerate(zip(card.opt.mu, cpu.opt.mu, strict=True)):
        err = (a.cpu() - b).abs().max().item() / max(b.abs().max().item(),
                                                     1e-2 * big)
        assert err <= 1e-3, (i, err)
    for (k, a), b in zip(card.model.state_dict().items(),
                         cpu.model.state_dict().values()):
        if "running" in k:
            assert _rel_err(a.cpu(), b) <= 1e-4, k


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["sim", "mme"])
def test_graphed_lite_steps_equal_eager_steps(cuda, regime):
    """``test_graphed_steps_equal_eager_steps`` for LaneNetLite (bf16,
    augmented): three replays against three eager steps, bit for bit."""
    rng = np.random.default_rng(17)
    views = [DeviceCachedView.from_arrays(
        rng.integers(0, 256, (10, 40, 56, 3), dtype=np.uint8),
        rng.integers(0, 4, (10, 40, 56), dtype=np.uint8), cuda)]
    arrays = (views[0].images, views[0].labels)
    idx = rng.integers(0, 10, (3, 4))
    if regime == "mme":
        views.append(DeviceCachedView.from_arrays(
            rng.integers(0, 256, (12, 40, 56, 3), dtype=np.uint8), None,
            cuda))
        arrays = arrays + (views[1].images,)
        idx = np.stack([idx, rng.integers(0, 12, (3, 4))], axis=1)
    trainers = []
    for _ in range(2):
        torch.manual_seed(18)
        model = LaneNetLite(4, policy=DEFAULT_POLICY, **LITE_SMALL)
        cls = MMETrainer if regime == "mme" else SupervisedTrainer
        trainers.append(cls(num_cls=4, height=32, width=48, model=model,
                            augment=True, device=cuda))
    graphed, eager = trainers
    graphs.reset_counts()
    logs = graphed.run_scan_chunk(arrays, idx,
                                  torch.Generator().manual_seed(19), 1)
    assert graphs.counts == {"captures": 1, "replays": 3}
    gen = torch.Generator().manual_seed(19)
    ref = []
    for row in idx:
        if regime == "mme":
            lab, unl = torch.from_numpy(row).to(cuda)
            out = eager.mme_train_step(arrays[0][lab], arrays[1][lab],
                                       arrays[2][unl], *eager.lrs_at(1),
                                       generator=gen)
        else:
            r = torch.from_numpy(row).to(cuda)
            out = eager.train_step(arrays[0][r], arrays[1][r],
                                   eager.lr_at(1), generator=gen)
        ref.append(torch.stack(list(out.values())))
    torch.cuda.synchronize()
    assert torch.equal(torch.stack(list(logs.values()), 1), torch.stack(ref))
    for (k, a), b in zip(graphed.model.state_dict().items(),
                         eager.model.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.gpu
def test_render_on_the_card_matches_the_cpu(cuda):
    """``sim.render.render_pair`` at 120x160 (loop_dyn_duckiebots, the
    fisheye, DR and noise drawn on the CPU) on the card against the CPU,
    at the CPU tests' agreement bounds."""
    from sim2real_lane_segment_tpu_torch.sim import lanes, render, rollout
    from sim2real_lane_segment_tpu_torch.sim.maps import builtin_map

    m = builtin_map("loop_dyn_duckiebots")
    pos, ang = rollout.sample_spawns(m, lanes.build_lane_arrays(m),
                                     np.random.default_rng(0), 3)
    g = torch.Generator().manual_seed(0)
    dr = render.DRParams.sample(g, 3)
    noise = torch.randn((3, 120, 160, 3), generator=g)
    kw = dict(height=120, width=160, distortion=True)
    cpu = render.render_pair(render.build_scene(m, 0), pos, ang, dr, noise,
                             **kw)
    gpu = render.render_pair(render.build_scene(m, 0, device=cuda),
                             pos.to(cuda), ang.to(cuda),
                             render.DRParams(*(f.to(cuda) for f in dr)),
                             noise.to(cuda), **kw)
    for a, b in zip(gpu, cpu):
        d = (a.cpu().short() - b.short()).abs()
        assert (d == 0).float().mean() >= 0.9995
        assert (d <= 1).float().mean() >= 0.9998


@pytest.mark.gpu
def test_postprocess_on_the_card_launches_k5(cuda, tmp_path):
    """``cli.datagen`` then ``cli.postprocess`` on the card: one K5 launch
    a batch of at most 32 pairs, and the label videos equal the ones the
    CPU (the plain version) writes from the same recordings."""
    import random

    from sim2real_lane_segment_tpu_torch.cli import datagen, postprocess
    from sim2real_lane_segment_tpu_torch.data import videoio
    from sim2real_lane_segment_tpu_torch.kernels import labelgen as klg

    rec = str(tmp_path / "rec")
    datagen.main(["--map-name", "zigzag", "--episodes", "1", "--steps",
                  "40", "--chunk", "20", "--height", "48", "--width", "64",
                  "--output_dir", rec], device=cuda)
    klg.reset_launches()
    random.seed(0)
    assert postprocess.main(["-id", rec, "-od", str(tmp_path / "gpu")],
                            device=cuda) == 1
    assert klg.launches["labelgen"] == 2
    random.seed(0)
    postprocess.main(["-id", rec, "-od", str(tmp_path / "cpu")],
                     device="cpu")
    for kind in ("input", "label"):
        a, b = (np.concatenate(list(videoio.read_frames(
            str(tmp_path / d / kind / "000000.avi")))) for d in ("gpu", "cpu"))
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_jax_ffv1_fixture_decodes_and_labels_on_the_card(cuda, tmp_path):
    """The JAX package's committed FFV1 recording (``scripts/
    make_ffv1_fixture.py``) decodes on the card's machine, which has no
    cv2, to cv2's digests; ``cli.postprocess`` labels it through K5 (one
    launch for its 16 pairs) into the input and label videos the JAX
    postprocess wrote, by their digests."""
    import hashlib
    import json
    import pathlib
    import shutil

    from sim2real_lane_segment_tpu_torch.cli import postprocess
    from sim2real_lane_segment_tpu_torch.data import videoio
    from sim2real_lane_segment_tpu_torch.kernels import labelgen as klg

    fixture = (pathlib.Path(__file__).resolve().parents[1]
               / "sim2real_lane_segment_tpu_torch" / "data" / "assets"
               / "ffv1")
    want = json.loads((fixture / "digests.json").read_text())

    def digests(path):
        return [hashlib.sha256(f.tobytes()).hexdigest() for f in
                np.concatenate(list(videoio.read_frames(str(path))))]

    rec = tmp_path / "rec"
    rec.mkdir()
    for name, frames in want["recording"].items():
        assert digests(fixture / name) == frames
        shutil.copyfile(fixture / name, rec / name)
    klg.reset_launches()
    assert postprocess.main(["-id", str(rec), "-od", str(tmp_path / "out")],
                            device=cuda) == 1
    assert klg.launches["labelgen"] == 1
    for kind in ("input", "label"):
        assert digests(tmp_path / "out" / kind / "000000.avi") == \
            want["postprocess"][kind]


@pytest.mark.gpu
def test_make_demo_video_fused_launches_k4(cuda, tmp_path):
    """``cli.make_demo_video --fused`` (FCDenseNet67, seeded weights) on a
    short rendered video: K4 launches 55/5/1 a batch, no plain version
    runs, and the masks agree with the run without ``--fused`` on at
    least 98% of the pixels (the served-mask bound)."""
    from unittest import mock

    from sim2real_lane_segment_tpu_torch.cli import make_demo_video
    from sim2real_lane_segment_tpu_torch.cli.test import build_model
    from sim2real_lane_segment_tpu_torch.data import videoio
    from sim2real_lane_segment_tpu_torch.sim import lanes, render, rollout
    from sim2real_lane_segment_tpu_torch.sim.maps import builtin_map

    m = builtin_map("zigzag")
    la = lanes.build_lane_arrays(m, cuda)
    pos, ang = rollout.sample_spawns(m, la, np.random.default_rng(0), 2,
                                     cuda)
    batch = rollout.expert_rollout(
        render.build_scene(m, 0, device=cuda), la,
        torch.Generator(cuda).manual_seed(0), pos, ang,
        tile_size=m.tile_size, n_steps=5, height=240, width=320)
    src = str(tmp_path / "in.avi")
    with videoio.VideoWriter(src, (320, 240)) as wr:
        wr.write(batch.orig.reshape(-1, 240, 320, 3).flip(-1).cpu().numpy())
    torch.manual_seed(0)
    weights = str(tmp_path / "w.pt")
    torch.save(build_model("67", 4).state_dict(), weights)
    plain = {"n": 0}

    def counting(fn):
        def f(*a, **kw):
            plain["n"] += 1
            return fn(*a, **kw)
        return f

    argv = ["-t", "baseline", "--checkpointPath", weights, "--arch", "67",
            "-b", "4", "--videoIns", src]
    with mock.patch.multiple(kdb, **{
            name: counting(getattr(kdb, name)) for name in (
                "dense_block_plain", "dense_layer_plain",
                "transition_plain", "classifier_plain")}):
        kdb.reset_launches()
        assert make_demo_video.main(argv + ["--fused", "--videoOuts", str(
            tmp_path / "fused.avi")], device=cuda)["frames"] == 10
        assert plain["n"] == 0
    batches = 3   # 10 frames, 4 a batch
    assert kdb.launches == {"dense_layer": 55 * batches,
                            "transition": 5 * batches,
                            "classifier": batches}
    make_demo_video.main(argv + ["--videoOuts", str(tmp_path / "plain.avi")],
                         device=cuda)
    a, b = (np.concatenate(list(videoio.read_frames(str(tmp_path / n))))
            for n in ("fused.avi", "plain.avi"))
    assert a.shape == (10, 120, 160, 3)
    assert (a == b).all(-1).mean() >= 0.98


@pytest.mark.gpu
def test_env_step_on_the_card_matches_the_cpu(cuda):
    """``DuckietownEnv`` (loop_dyn_duckiebots, DR on, 120x160) on the card
    and on the CPU from one seed and the same draws (a CPU generator):
    equal poses (the pose is computed on the host either way), frames
    with at least 0.9995 of their values equal, NPC meshes moved alike."""
    from sim2real_lane_segment_tpu_torch.sim.env import (DuckietownEnv,
                                                         EnvDraws)
    from sim2real_lane_segment_tpu_torch.sim.expert import expert_action

    envs = [DuckietownEnv(map_name="loop_dyn_duckiebots", seed=3,
                          camera_width=160, camera_height=120,
                          domain_rand=True, device=d, draws=EnvDraws(3))
            for d in (cuda, "cpu")]
    for _ in range(6):
        act = expert_action(envs[1].lane_arrays, envs[1].map.tile_size,
                            torch.from_numpy(envs[1].cur_pos),
                            torch.tensor(envs[1].cur_angle,
                                         dtype=torch.float32)).numpy()
        (og, rg, dg, _), (oc, rc, dc, _) = (e.step(act) for e in envs)
        np.testing.assert_array_equal(envs[0].cur_pos, envs[1].cur_pos)
        assert (rg, dg) == (rc, dc)
        assert (og == oc).mean() >= 0.9995
    torch.testing.assert_close(envs[0].scene.meshes.vertices.cpu(),
                               envs[1].scene.meshes.vertices)


# ---------------------------------------------------------------------------
# AdamW's multi-tensor update: captured, and launches a step
# ---------------------------------------------------------------------------

from test_torch_optim import LRS, per_tensor_step, shapes  # noqa: E402

from sim2real_lane_segment_tpu_torch.train.optim import AdamW  # noqa: E402


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The most units in the last place between two float32 tensors."""
    if torch.equal(a, b):
        return 0
    ia, ib = (t.view(torch.int32).long() for t in (a, b))
    # one line of integers across zero: negative floats below positive
    ia, ib = (torch.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
    return int((ia - ib).abs().max())


@pytest.mark.gpu
def test_adamw_captured_replays_match_the_per_tensor_loop(cuda):
    """``AdamW.step`` over FCDenseNet103's 398 parameter tensors captured
    in a CUDA graph and replayed three times, new gradients copied into
    its static buffers and a new rate set before each replay: parameters
    and moments within 1 ulp of the eager per-tensor loop (a compiled
    multi-tensor kernel may contract a multiply-add otherwise).  Prints
    whether they were bit-equal."""
    dims = shapes("103")
    gen = torch.Generator().manual_seed(0)

    def draw():
        return [torch.randn(s, generator=gen).to(cuda) for s in dims]

    params = draw()
    ref = [p.clone() for p in params]
    mu, nu = ([torch.zeros_like(p) for p in params] for _ in range(2))
    opt = AdamW(params, 1e-4)
    static = [torch.zeros_like(p) for p in params]
    # the kernels loaded before the capture, by a throwaway optimizer
    AdamW([p.clone() for p in params], 1e-4).step(static, 1e-3)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.step(static)
    for k, lr in enumerate(LRS):
        grads = draw()
        for s, g in zip(static, grads):
            s.copy_(g)
        opt.set_lr(lr)
        graph.replay()
        per_tensor_step(ref, grads, mu, nu, k + 1, lr, 1e-4)
    torch.cuda.synchronize()
    assert opt.count == len(LRS)
    ulps = {name: max(_ulps(a, b) for a, b in zip(got, want, strict=True))
            for name, got, want in (("params", params, ref),
                                    ("mu", opt.mu, mu), ("nu", opt.nu, nu))}
    print(f"\nAdamW, {len(dims)} tensors, {len(LRS)} replays against the "
          f"per-tensor loop: most ulps apart {ulps}, bit-equal "
          f"{not any(ulps.values())}")
    for got, want in ((params, ref), (opt.mu, mu), (opt.nu, nu)):
        for a, b in zip(got, want, strict=True):
            torch.testing.assert_close(a, b, rtol=1.2e-7, atol=0)


@pytest.mark.gpu
def test_adamw_eager_step_launches_few_kernels(cuda):
    """One eager step over FCDenseNet103's 398 parameter tensors launches
    at most 200 kernels (the per-tensor loop: 13 a tensor, 5,174): every
    multi-tensor call took the fast route, which mixed dtypes or devices
    would leave for a per-tensor loop of its own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dims = shapes("103")
    gen = torch.Generator().manual_seed(1)
    params, grads = ([torch.randn(s, generator=gen).to(cuda) for s in dims]
                     for _ in range(2))
    opt = AdamW(params, 1e-4)
    opt.step(grads, 1e-3)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.step(grads)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    print(f"\nAdamW, {len(dims)} tensors: {len(kernels)} kernels a step, "
          f"{sum('multi_tensor' in k for k in kernels)} multi-tensor")
    # at least one kernel an operation: the profiler saw the card
    assert 13 <= len(kernels) <= 200
