"""The port's kernel diagnostics (``cli/serve_breakdown.py``,
``cli/train_breakdown.py``) against the JAX package's, on the CPU.

- The harness ``_time_scan``: its floor API; net time that grows with the
  chained work inside ``fn`` (2 against 16 chained matmuls: more than
  2.5x); a heavy output against a one-element slice of the input (as
  ``tests/test_breakdown_harness.py`` holds the JAX harness).
- ``--ablate``: a dense layer off the tensor-core route (float32, or a
  growth other than 16) raises ``ValueError``; on it (bfloat16, growth 16)
  the CPU runs the variants' plain versions.
- The serving levels: the dense blocks that one ``fused_apply`` forward
  hands its ``block_fn`` against those JAX's ``pallas_apply`` hands
  ``fused_dense_block_cm`` (interpret mode, the tiny FCDenseNet at
  48x64): the same (h, w, c_in, n, growth, TD, classifier) in order and
  equal FLOPs per level.
- The train consumers: ``Consumer.apply``'s sites in one
  ``fused_apply_train`` against JAX ``_consumer``'s in
  ``pallas_apply_train``: (h, w, c_in, taps, g_out) and FLOPs.
- Both CLIs end to end at FCDenseNet67's widths on a small plane:
  11 level rows, 5 consumer rows, finite times, the H100 peaks as
  defaults, and no device share reported off a card.

Torch runs on 2 threads.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_model
from test_torch_common import jax_variables, load_port, unflatten

from sim2real_lane_segment_tpu.models import tiramisu_pallas as tp
from sim2real_lane_segment_tpu.models import tiramisu_train_pallas as ttp
from sim2real_lane_segment_tpu_torch.cli import serve_breakdown as sb
from sim2real_lane_segment_tpu_torch.cli import train_breakdown as tb
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
from sim2real_lane_segment_tpu_torch.models import tiramisu_train_fused as ttf
from sim2real_lane_segment_tpu_torch.models.tiramisu import (FCDenseNet,
                                                             dropout_sites)
from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import fused_apply

TINY = dict(n_classes=4, down_blocks=(2, 2), up_blocks=(2, 2),
            bottleneck_layers=2, growth_rate=4, out_chans_first_conv=8)
B, H, W = 2, 48, 64


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

def test_time_scan_floor_api():
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 64)).astype(np.float32))

    def f(x):
        return torch.relu(x @ x.T)

    dt = sb._time_scan(f, (a,), k=2, iters=2)
    assert dt > 0
    dt2, floor = sb._time_scan(f, (a,), k=2, iters=2, with_floor=True)
    assert dt2 > 0 and floor >= 0


def test_time_scan_work_scales_with_chain_length():
    """Eight times the chained work in ``fn`` must show as more than 2.5
    times the net time: the calls are neither skipped nor merged."""
    n = 512
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, n)) / math.sqrt(n))
                         .astype(np.float32))

    def chain(reps):
        def f(x):
            y = x
            for _ in range(reps):
                y = torch.relu(y @ w) + 1e-3
            return y
        return f

    # the host's allocator and thread pool settle over the first runs
    sb._time_scan(chain(16), (a,), k=4, iters=2, with_floor=True)
    t1, f1 = sb._time_scan(chain(2), (a,), k=4, iters=2, with_floor=True)
    t2, f2 = sb._time_scan(chain(16), (a,), k=4, iters=2, with_floor=True)
    net1, net2 = max(t1 - f1, 1e-9), max(t2 - f2, 1e-9)
    assert net2 / net1 > 2.5, (net1, net2)


def test_time_scan_output_not_dead_coded():
    """A heavy output costs far more than a one-element slice of the same
    input: every output is consumed and paid for."""
    n = 768
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, n)) / math.sqrt(n))
                         .astype(np.float32))

    def heavy(x):
        y = x
        for _ in range(8):
            y = torch.relu(y @ w)
        return y

    def light(x):
        return x[:1, :1]

    sb._time_scan(heavy, (a,), k=4, iters=2, with_floor=True)  # settle
    th, fh = sb._time_scan(heavy, (a,), k=4, iters=2, with_floor=True)
    tl, fl = sb._time_scan(light, (a,), k=4, iters=2, with_floor=True)
    assert max(th - fh, 1e-9) > 3 * max(tl - fl, 1e-9), (th, fh, tl, fl)


def test_time_scan_consumes_every_output_leaf(monkeypatch):
    seen = []
    real = sb._consume

    def spy(tree):
        seen.append([tuple(t.shape) for t in sb._leaves(tree)])
        return real(tree)

    monkeypatch.setattr(sb, "_consume", spy)
    x = torch.ones(3, 4)
    sb._time_scan(lambda t: (t * 2, [t[0], {"s": t.sum()}]), (x,), k=1,
                  iters=1)
    assert [(3, 4), (4,), ()] in seen
    # every element, each row weighted by its position plus one
    assert real((x * 2, [x[0], {"s": x.sum()}])).item() == \
        2 * 4 * (1 + 2 + 3) + (1 + 2 + 3 + 4) + 12


def _layer(dtype, g, c=24, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return kdb.FoldedLayer(torch.rand(c, generator=gen) + 0.5,
                           torch.randn(c, generator=gen),
                           (torch.randn(c, 9, g, generator=gen) * 0.1)
                           .to(dtype), torch.randn(g, generator=gen))


@pytest.mark.parametrize("mode", ["no_taps", "no_prep"])
@pytest.mark.parametrize("dtype,g", [(torch.float32, 16),
                                     (torch.bfloat16, 4),
                                     (torch.float32, 4)])
def test_ablate_raises_off_the_tensor_core_route(mode, dtype, g):
    feat = torch.randn(1, 24 + g, 6, 8).to(dtype)
    with pytest.raises(ValueError, match="tensor-core-route diagnostic"):
        kdb.dense_layer(feat, _layer(dtype, g), ablate=mode)
    with pytest.raises(ValueError, match="tensor-core-route diagnostic"):
        sb.ablated_block([feat[:, :24].contiguous()], [_layer(dtype, g)],
                         mode, c_lo=0)


def test_ablate_rejects_an_unknown_mode():
    feat = torch.randn(1, 40, 6, 8).to(torch.bfloat16)
    with pytest.raises(ValueError, match="not one of"):
        kdb.dense_layer(feat, _layer(torch.bfloat16, 16), ablate="no_bias")


def test_ablate_plain_versions_on_the_route():
    """On the CPU the variants run their plain versions: the centre tap
    alone is a 1x1 conv of the activation; without BN + ReLU the 3x3 conv
    reads x itself; channels below c_j are left as they were."""
    gen = torch.Generator().manual_seed(4)
    feat = torch.randn(2, 40, 6, 8, generator=gen).to(torch.bfloat16)
    lay = _layer(torch.bfloat16, 16)
    w = lay.weight.float().reshape(24, 3, 3, 16).permute(3, 0, 1, 2)
    act = kdb.bn_relu_plain(feat, lay.scale, lay.shift).float()
    refs = {
        "no_taps": torch.nn.functional.conv2d(act, w[:, :, 1:2, 1:2]),
        "no_prep": torch.nn.functional.conv2d(feat[:, :24].float(), w,
                                              padding=1)}
    for mode, ref in refs.items():
        out = feat.clone()
        kdb.dense_layer(out, lay, ablate=mode)
        want = (ref + lay.bias[:, None, None]).to(torch.bfloat16)
        assert torch.equal(out[:, 24:], want), mode
        assert torch.equal(out[:, :24], feat[:, :24]), mode
    assert kdb.ablate_launches == {"no_taps": 0, "no_prep": 0}


# ---------------------------------------------------------------------------
# serving levels and train consumers against the JAX package
# ---------------------------------------------------------------------------

def _jax_cost(kw, c_in, b):
    """The JAX CLI's FLOPs of one fused block (cli/serve_breakdown.py)."""
    h, w, n, g = kw["h"], kw["w"], kw["n_layers"], kw["growth"]
    pix = h * w
    flops = sum(2 * 9 * g * (c_in + j * g) * pix for j in range(n)) * b
    c_t = c_in + n * g
    if kw.get("transition") is not None:
        flops += 2 * c_t * c_t * pix * b
    if kw.get("classifier") is not None:
        flops += 2 * 8 * c_t * pix * b
    return flops


@pytest.fixture(scope="module")
def tiny_weights():
    return jax_variables(tiny_model(), (1, H, W, 3), seed=0)


def test_serving_levels_match_pallas_apply(tiny_weights, monkeypatch):
    x = np.random.default_rng(5).normal(size=(B, H, W, 3)).astype(np.float32)
    jax_calls = []
    real = tp.fused_dense_block_cm

    def recorder(segments, folded, **kw):
        jax_calls.append((sum(s.shape[1] for s in segments), dict(kw)))
        return real(segments, folded, **kw)

    monkeypatch.setattr(tp, "fused_dense_block_cm", recorder)
    variables = unflatten(tiny_weights)
    tp.pallas_apply(tiny_model(), variables, jnp.asarray(x),
                    use_softmax=False, interpret=True)

    port = load_port(FCDenseNet(**TINY, policy=F32_POLICY), tiny_weights)
    port_calls = []

    def port_recorder(segments, layers, **kw):
        port_calls.append(sb.level_cost(list(segments), layers, kw, B))
        return kdb.dense_block(segments, layers, **kw)

    fused_apply(port, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                use_softmax=False, block_fn=port_recorder)

    jax_rows = [(kw["h"], kw["w"], c_in, kw["n_layers"], kw["growth"],
                 kw.get("transition") is not None,
                 kw.get("classifier") is not None, _jax_cost(kw, c_in, B))
                for c_in, kw in jax_calls]
    port_rows = [(c["h"], c["w"], c["c_in"], c["n"], c["growth"], c["td"],
                  c["cls"], c["flops"]) for c in port_calls]
    assert len(port_rows) == 2 * len(TINY["down_blocks"]) + 1
    assert port_rows == jax_rows


def test_train_consumers_match_pallas_apply_train(tiny_weights, monkeypatch):
    x = np.random.default_rng(6).normal(size=(B, H, W, 3)).astype(np.float32)
    jax_sites = []
    real = ttp._consumer

    def recorder(cfg, *a):
        jax_sites.append((cfg.h, cfg.w, sum(cfg.seg_chans), cfg.taps,
                          cfg.g_out))
        return real(cfg, *a)

    monkeypatch.setattr(ttp, "_consumer", recorder)
    variables = unflatten(tiny_weights)
    ttp.pallas_apply_train(tiny_model(), variables, jnp.asarray(x),
                           jax.random.key(1), use_softmax=False,
                           interpret=True)

    port = load_port(FCDenseNet(**TINY, policy=F32_POLICY), tiny_weights)
    port_sites = []
    real_apply = ttf.Consumer.apply

    def port_recorder(*a):
        xin, weight = a[0], a[3]
        c_in, taps, g_out = weight.shape
        port_sites.append((xin.shape[2], xin.shape[3], c_in, taps, g_out))
        return real_apply(*a)

    masks = [torch.ones(B, c) for c in dropout_sites(port)]
    with torch.no_grad():
        ttf.fused_apply_train(port, torch.from_numpy(x).permute(0, 3, 1, 2)
                              .contiguous(), masks, use_softmax=False,
                              consumer_fn=port_recorder)
    assert len(port_sites) == len(TINY["down_blocks"])
    assert all(s[3] == 1 for s in port_sites)
    assert port_sites == jax_sites

    def flops(s):
        h, w, c_in, taps, g = s
        return 2 * taps * g * c_in * h * w * B
    assert [flops(s) for s in port_sites] == [flops(s) for s in jax_sites]


# ---------------------------------------------------------------------------
# the CLIs end to end on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def small(monkeypatch):
    """32x32 frames and one call a timed run: the CLIs' constants."""
    for mod in (sb, tb):
        for name, value in (("HEIGHT", 32), ("WIDTH", 32), ("K", 1),
                            ("ITERS", 1)):
            monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(tb, "K_FULL", 1)


def test_peaks_default_to_the_h100():
    for parser in (sb.build_parser(), tb.build_parser()):
        args = parser.parse_args([])
        assert args.peak_tflops == 989.0
    assert sb.build_parser().parse_args([]).peak_gbps == 3350.0
    assert sb.build_parser().parse_args([]).batch_size == 256
    assert tb.build_parser().parse_args([]).batch_size == 128


def test_serve_breakdown_cli_on_cpu(capsys, small):
    res = sb.main(["--arch", "67", "-b", "1", "--ablate", "32x32"],
                  device="cpu")
    rows = res["levels"]
    assert len(rows) == 11
    assert [r["level"].split()[0] for r in rows] == [
        "32x32", "16x16", "8x8", "4x4", "2x2", "1x1", "2x2", "4x4", "8x8",
        "16x16", "32x32"]
    assert rows[0]["level"] == "32x32 c_in=48 n=5 +TD"
    assert rows[-1]["level"].endswith("+cls")
    for r in rows:
        assert math.isfinite(r["ms"]) and r["ms"] > 0
        assert r["mxu_pct"] is None and r["hbm_pct"] is None
        assert r["bound_ms"] > 0
    assert "no_taps_ms" in rows[0] and "no_prep_ms" in rows[0]
    assert "no_taps_ms" in rows[-1] and "no_taps_ms" not in rows[1]
    assert math.isfinite(res["full_ms"]) and res["fps"] > 0
    assert res["card"].startswith("cpu")
    out = capsys.readouterr().out
    table = [ln for ln in out.splitlines()
             if " c_in=" in ln and not ln.startswith("{")]
    assert len(table) == 11 and all(res["card"] in ln for ln in table)


def test_serve_breakdown_57_skips_ablation_with_its_reason(capsys, small):
    """FCDenseNet57's bf16 growth-12 layers take the tensor cores, so their
    levels are ablated now; a level off that route (float32 here) is still
    skipped, with the reason the wrapper gives."""
    res = sb.main(["--arch", "57", "-b", "1", "--ablate", "32x32"],
                  device="cpu")
    assert "no_taps_ms" in res["levels"][0]
    assert "no_prep_ms" in res["levels"][0]
    assert "ablate skipped" not in capsys.readouterr().out
    seg = torch.zeros(1, 8, 4, 6)
    with pytest.raises(ValueError, match="runs on the CUDA cores"):
        sb.ablated_block([seg], [_layer(torch.float32, 12, c=8)], "no_taps",
                         c_lo=0)


def test_level_bytes_are_the_ports_traffic():
    """One block's bytes: the concat copied in, each layer reading c_j and
    writing g, the TransitionDown reading and writing c_total, weights
    once (bf16)."""
    seg = torch.zeros(2, 8, 4, 6, dtype=torch.bfloat16)
    layers = [_layer(torch.bfloat16, 16, c=8 + 16 * j) for j in range(2)]
    td = kdb.FoldedTransition(torch.ones(40), torch.zeros(40),
                              torch.zeros(40, 40, dtype=torch.bfloat16),
                              torch.zeros(40))
    cost = sb.level_cost([seg], layers, {"td": td, "c_lo": 0}, 2)
    px = 2 * 4 * 6
    dense = sum(px * (c + 16) * 2 + c * 9 * 16 * 2 + 8 * c + 4 * 16
                for c in (8, 24))
    assert cost["dense_bytes"] == dense
    assert cost["bytes"] == (dense + 2 * px * 8 * 2
                             + px * 80 * 2 + 40 * 40 * 2 + 8 * 40 + 4 * 40)
    assert cost["name"] == "4x6 c_in=8 n=2 +TD"


def test_train_breakdown_cli_on_cpu(small):
    res = tb.main(["--arch", "67", "-b", "1"], device="cpu")
    rows = res["levels"]
    assert [r["level"] for r in rows] == [
        "32x32 c_in=128 taps=1 g=128", "16x16 c_in=208 taps=1 g=208",
        "8x8 c_in=288 taps=1 g=288", "4x4 c_in=368 taps=1 g=368",
        "2x2 c_in=448 taps=1 g=448"]
    for r in rows:
        assert r["fwd_ms"] > 0 and r["vjp_ms"] > 0
        assert r["fwd_mxu_pct"] is None
    for k in ("full_fwd_ms", "full_fwd_bwd_ms", "step_ms", "img_s"):
        assert math.isfinite(res[k]) and res[k] > 0


def test_every_jax_cli_has_a_port_namesake():
    """After the diagnostics and the real-domain CLIs, every CLI module of
    the JAX package has a namesake in the port."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    jax_cli = {p.name for p in (root / "sim2real_lane_segment_tpu" / "cli")
               .glob("*.py")}
    port_cli = {p.name for p in (root / "sim2real_lane_segment_tpu_torch"
                                 / "cli").glob("*.py")}
    assert jax_cli - port_cli == set()
