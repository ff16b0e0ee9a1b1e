"""The port's int8 LaneNetLite (``models/lanenet_int8``), the K6 body's
plain version (``kernels/int8_body.int8_body_plain``) and the int8 serve
paths against the JAX package, on the CPU.

Inputs come from numpy seeds.  Where the JAX path is exact (int8 codes,
integer sums, the epilogues), the port must be bit-exact on the same
sites; calibrated scales may differ by a few ulp (the float32 calibration
forwards sum in another order).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_variables, load_port, unflatten

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.models import lanenet_int8 as J8
from sim2real_lane_segment_tpu.models.lanenet_lite import \
    LaneNetLite as JaxLite
from sim2real_lane_segment_tpu.models.lanenet_pallas import (
    pallas_int8_forward, pallas_int8_serve)
from sim2real_lane_segment_tpu.ops.augment import AugmentConfig as JaxCfg
from sim2real_lane_segment_tpu.ops.augment import eval_batch as jax_eval_batch
from sim2real_lane_segment_tpu_torch.cli import serve as port_serve
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.kernels import int8_body as kib
from sim2real_lane_segment_tpu_torch.models import lanenet_int8 as P8
from sim2real_lane_segment_tpu_torch.models.lanenet_fused import (
    fold_body, fused_int8_forward, fused_int8_serve, stem_rows)
from sim2real_lane_segment_tpu_torch.models.lanenet_lite import LaneNetLite
from sim2real_lane_segment_tpu_torch.ops.augment import AugmentConfig

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                   "lanenet_lite_sim.msgpack")
# dilations 1/2/4 and one channel-changing block reach every body path
SMALL = dict(stem=(8, 16), body=((16, 1), (16, 2), (32, 4)))
H, W = 24, 32
# the f32 head (and upsample) sum in another order: the JAX kernel's gate
HEAD_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def nets():
    """(JAX model, variables, JAX QuantizedLaneNet, port model, port
    QuantizedLaneNet from its own calibration, port QuantizedLaneNet
    holding JAX's sites)."""
    jm = JaxLite(n_classes=4, policy=JAX_F32, **SMALL)
    flat = jax_variables(jm, (1, H, W, 3), seed=3)
    var = unflatten(flat)
    pm = load_port(LaneNetLite(4, policy=F32_POLICY, **SMALL), flat)
    calib = np.random.default_rng(1).normal(size=(4, H, W, 3)).astype(
        np.float32) * 0.5
    jq = J8.quantize_lanenet(jm, var, calib)
    pq = P8.quantize_lanenet(pm, torch.from_numpy(calib))
    return jm, var, jq, pm, pq, port_qn(jq, pm)


def port_qn(jq, model) -> P8.QuantizedLaneNet:
    """JAX's quantized sites as the port's (numpy -> torch)."""
    sites = {name: {k: torch.from_numpy(np.array(v)) if hasattr(v, "shape")
                    else v for k, v in s.items()}
             for name, s in jq.sites.items()}
    return P8.QuantizedLaneNet(model, sites,
                               torch.from_numpy(np.array(jq.head_kernel)),
                               torch.from_numpy(np.array(jq.head_bias)))


def rand_x(seed, n=3, h=H, w=W):
    return np.random.default_rng(seed).normal(size=(n, h, w, 3)).astype(
        np.float32) * 0.7


def test_quantize_matches_jax(nets):
    """Same int8 codes and zero points.  The first site's scale, read from
    the very input, is equal; later scales read activations of a float32
    forward that sums in another order, 0-2 ulp apart here (limit 4)."""
    _, _, jq, _, pq, _ = nets
    assert list(pq.sites) == list(jq.sites)
    assert len(jq.sites) == 2 + 2 * 3 + 1
    for name, js in jq.sites.items():
        ps = pq.sites[name]
        np.testing.assert_array_equal(ps["w_q"].numpy(),
                                      np.asarray(js["w_q"]), err_msg=name)
        np.testing.assert_array_equal(ps["w_colsum"].numpy(),
                                      np.asarray(js["w_colsum"]))
        assert (ps["zp"], ps["stride"], ps["dilation"], ps["relu"]) == (
            js["zp"], js["stride"], js["dilation"], js["relu"]), name
        assert ps["act_scale"].dtype == torch.float32
        np.testing.assert_array_max_ulp(ps["act_scale"].numpy(),
                                        np.asarray(js["act_scale"]), 4)
        # folded weights: rsqrt and the fold's product may round apart
        np.testing.assert_array_max_ulp(ps["w_scale"].numpy(),
                                        np.asarray(js["w_scale"]), 4)
        # folded bias: rsqrt and the fold's products may round apart
        np.testing.assert_allclose(ps["bias"].numpy(), np.asarray(js["bias"]),
                                   rtol=1e-6, atol=1e-6)
    assert pq.sites["ConvBN_0"]["act_scale"].numpy() == np.asarray(
        jq.sites["ConvBN_0"]["act_scale"])
    assert pq.sites["ConvBN_0"]["zp"] == 0
    assert all(s["zp"] == 128 for n, s in pq.sites.items() if n != "ConvBN_0")
    # the shortcut reads its block's conv1 codes
    assert torch.equal(pq.sites["ResBlock_2/short"]["act_scale"],
                       pq.sites["ResBlock_2/conv1"]["act_scale"])


@pytest.mark.parametrize("n", [928, 1000, 1047, 4097, 123_457])
def test_percentile_matches_jnp(n):
    a = np.abs(np.random.default_rng(n).normal(size=n)).astype(np.float32)
    ref = float(jnp.percentile(jnp.asarray(a), 99.95))
    np.testing.assert_array_max_ulp(
        np.float32(P8.percentile_f32(torch.from_numpy(a), 99.95)),
        np.float32(ref), 1)


def test_float_shadow_matches_flax(nets):
    """The folded float graph equals the Flax features (BN folding)."""
    jm, var, _, pm, _, _ = nets
    x = rand_x(5)
    ref = np.asarray(jm.apply(var, x, train=False, method=lambda m, x, train:
                              m.featureExtractor(x, train=train)))
    with torch.no_grad():
        feats = P8._float_forward(pm, P8._collect_float_layers(pm),
                                  torch.from_numpy(x))
    np.testing.assert_allclose(feats.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["ConvBN_0", "ConvBN_1", "ResBlock_0/conv1",
                                  "ResBlock_1/conv2", "ResBlock_2/conv1",
                                  "ResBlock_2/short"])
def test_conv_i8_and_quant_bit_exact(nets, name):
    """One site on JAX's own codes and scales: the exact int sums, the
    epilogue and the requant, bit for bit (stride 2 with asymmetric
    padding, dilations 1/2/4, the 1x1 shortcut)."""
    jm, _, jq, _, _, pq = nets
    cin = jq.sites[name]["w_q"].shape[2]
    size = {"ConvBN_0": (H, W), "ConvBN_1": (12, 16)}.get(name, (6, 8))
    rng = np.random.default_rng(len(name))
    q = rng.integers(-128, 128, (2, *size, cin)).astype(np.int8)
    ref = np.asarray(J8._conv_i8(jnp.asarray(q), jq.sites[name]))
    out = P8._conv_i8(torch.from_numpy(q), pq.sites[name]).numpy()
    np.testing.assert_array_equal(out, ref)
    nxt = jq.sites["ResBlock_1/conv2"]
    np.testing.assert_array_equal(
        P8._quant(torch.from_numpy(out), pq.sites["ResBlock_1/conv2"]).numpy(),
        np.asarray(J8._quant(jnp.asarray(ref), nxt)))


def test_int8_apply_matches_jax(nets):
    """JAX's sites in both: scores within the head's f32 reordering, the
    same argmax."""
    _, _, jq, _, _, pq = nets
    x = rand_x(6)
    ref = np.asarray(J8.int8_apply(jq, x))
    out = P8.int8_apply(pq, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (3, H, W, 4)
    np.testing.assert_allclose(out, ref, **HEAD_TOL)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
    soft = P8.int8_apply(pq, torch.from_numpy(x), use_softmax=True).numpy()
    np.testing.assert_allclose(soft.sum(-1), 1.0, rtol=1e-5)


def test_int8_body_plain_matches_pallas_kernel(nets):
    """K6's plain version against ``_body_kernel`` in interpret mode, fed
    JAX's own quantized sites."""
    _, _, jq, _, _, pq = nets
    x = rand_x(7, n=2)
    ref = np.asarray(pallas_int8_forward(jq, x, interpret=True))
    out = fused_int8_forward(pq, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 4, H // 4, W // 4)
    np.testing.assert_allclose(out, ref, **HEAD_TOL)


def test_int8_body_wrapper_takes_cpu_tensors_to_plain(nets):
    """On CPU tensors ``int8_body`` is its plain version (no launch)."""
    _, _, _, _, _, pq = nets
    rows, hh, ww = stem_rows(pq, torch.from_numpy(rand_x(8, n=2)))
    kib.reset_launches()
    a, b = {}, {}
    out = kib.int8_body(rows, fold_body(pq), hh, ww, record=a)
    ref = kib.int8_body_plain(rows, fold_body(pq), hh, ww, record=b)
    assert torch.equal(out, ref)
    assert all(v == 0 for v in kib.launches.values())
    assert list(a) == [f"ResBlock_{i}/conv{j}" for i in range(3)
                       for j in (1, 2)]
    assert all(torch.equal(a[k], b[k]) and a[k].dtype == torch.int8
               for k in a)


def test_fold_body_packs_words(nets):
    """Each int32 word holds four consecutive weight rows, little-endian,
    as ``__dp4a`` reads them; the fold is cached."""
    _, _, _, _, _, pq = nets
    body = fold_body(pq)
    assert fold_body(pq) is body
    c1 = body.blocks[0][0]
    rows = c1.w_rows.to(torch.int64)
    words = c1.w_words.to(torch.int64) & 0xFFFFFFFF
    for k in range(4):
        byte = ((words >> (8 * k)) & 0xFF).to(torch.int8)
        assert torch.equal(byte, rows[k::4].to(torch.int8))
    assert c1.w_rows.shape == (9 * 16, 16) and body.blocks[2][2].taps == 1
    assert [s is None for _, _, s in body.blocks] == [True, True, False]


def test_fused_serve_matches_pallas_serve(nets):
    """uint8 frames -> class maps through the body, on JAX's sites."""
    _, _, jq, _, _, pq = nets
    u8 = np.random.default_rng(9).integers(0, 255, (2, H, W, 3),
                                           dtype=np.uint8)
    ref = np.asarray(pallas_int8_serve(jq, jnp.asarray(u8),
                                       cfg=JaxCfg(height=H, width=W),
                                       interpret=True))
    out = fused_int8_serve(pq, torch.from_numpy(u8),
                           cfg=AugmentConfig(height=H, width=W)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.fixture(scope="module")
def student_jax():
    """The committed student, its JAX quantization calibrated as the JAX
    serve CLI does without --calib_dir, at 48x64."""
    from flax import serialization

    with open(ART, "rb") as f:
        d = serialization.msgpack_restore(f.read())
    variables = jax.tree_util.tree_map(jnp.asarray, {
        "params": {"featureExtractor": {k: v for k, v in d["params"].items()
                                        if k != "head"},
                   "classifier": {"head": d["params"]["head"]}},
        "batch_stats": {"featureExtractor": d["batch_stats"]}})
    model = JaxLite(n_classes=4)
    cfg = JaxCfg(height=48, width=64)
    frames = np.random.default_rng(0).integers(0, 255, (16, 48, 64, 3),
                                               dtype=np.uint8)
    calib_x, _ = jax_eval_batch(jnp.asarray(frames), None, cfg,
                                with_labels=False)
    return J8.quantize_lanenet(model, variables, calib_x), cfg


@pytest.mark.parametrize("fused", [False, True])
def test_serve_int8_predict_fn_matches_jax(student_jax, fused):
    """``cli.serve --int8 [--fused]`` on the CPU against JAX's
    ``int8_apply`` argmax and ``pallas_int8_serve`` on the same seeded
    calibration: at least 99.9% of pixels agree (calibrated scales may
    differ by 1 ulp, which can move a code at a rounding boundary)."""
    jq, cfg = student_jax
    args = port_serve.parse_args(["--checkpointPath", ART, "--height", "48",
                                  "--width", "64", "--int8",
                                  *(["--fused"] if fused else [])])
    predict, h, w = port_serve.build_predict_fn(args, device="cpu")
    u8 = np.random.default_rng(11).integers(0, 255, (3, 48, 64, 3),
                                            dtype=np.uint8)
    out = predict(u8)
    assert (h, w) == (48, 64) and out.dtype == np.uint8
    if fused:
        ref = np.asarray(pallas_int8_serve(jq, jnp.asarray(u8), cfg=cfg,
                                           interpret=True))
    else:
        x, _ = jax_eval_batch(jnp.asarray(u8), None, cfg, with_labels=False)
        ref = np.asarray(jnp.argmax(J8.int8_apply(jq, x), -1))
    assert out.shape == ref.shape == (3, 48, 64)
    assert (out == ref).mean() >= 0.999


# ---------------------------------------------------------------------------
# the int8 tensor-core route's dispatch rule
# ---------------------------------------------------------------------------

# the student's full widths (PERF.md §4): 10 conv sites and 2 shortcuts
FULL = dict(stem=(32, 64), body=((64, 1), (64, 1), (96, 2), (96, 4),
                                 (128, 1)))


@pytest.fixture(scope="module")
def full_body():
    """The full-width body, folded from seeded weights calibrated on a
    few 32x32 noise frames (only the sites' shapes matter here)."""
    torch.manual_seed(0)
    model = LaneNetLite(4, policy=F32_POLICY, **FULL).eval()
    return fold_body(P8.quantize_lanenet(model, torch.randn(2, 32, 32, 3)))


def _site_specs(body):
    return [s for blk in body.blocks for s in blk if s is not None]


@pytest.mark.parametrize("i", range(12))
def test_takes_imma_at_every_full_width_site(full_body, i):
    """Every conv site of the full-width student takes the int8 tensor
    cores; ``w_cols`` holds its weights as [tap][cout][cin]."""
    specs = _site_specs(full_body)
    assert len(specs) == 12
    s = specs[i]
    rows, cout = s.w_rows.shape
    cin = rows // s.taps
    assert kib.takes_imma(cin, cout, s.taps, s.dilation)
    assert kib.imma_tiles(cin, cout, s.taps, s.dilation) == 2
    assert s.w_cols.shape == (s.taps * cout, cin)
    assert torch.equal(s.w_cols.reshape(s.taps, cout, cin).transpose(1, 2)
                       .reshape(rows, cout), s.w_rows)


def test_takes_imma_on_the_small_net(nets):
    """The 8/16-channel test net mixes both routes: only its 32-channel
    conv2 takes the tensor cores."""
    _, _, _, _, _, pq = nets
    routes = [kib.takes_imma(s.w_rows.shape[0] // s.taps, s.w_rows.shape[1],
                             s.taps, s.dilation)
              for s in _site_specs(fold_body(pq))]
    assert routes == [False] * 5 + [True, False]


@pytest.mark.parametrize("cin,cout,taps,dil,tiles", [
    (32, 8, 9, 1, 2), (64, 64, 9, 2, 2), (96, 96, 9, 4, 2),
    (128, 128, 9, 1, 2), (128, 128, 9, 4, 1), (288, 64, 9, 1, 1),
    (256, 96, 9, 1, 0), (256, 96, 1, 1, 2), (288, 64, 9, 4, 0),
    (16, 32, 9, 1, 2), (48, 64, 1, 1, 2), (64, 12, 9, 1, 2)])
def test_takes_imma_rule(cin, cout, taps, dil, tiles):
    """Whole 32-byte k steps, whole 8-output tiles, and every tap's weights
    (for up to 128 outputs) beside one or two halo tiles in 227 KB."""
    assert kib.imma_tiles(cin, cout, taps, dil) == tiles
    assert kib.takes_imma(cin, cout, taps, dil) == (
        cin % 32 == 0 and cout % 8 == 0 and tiles > 0)
