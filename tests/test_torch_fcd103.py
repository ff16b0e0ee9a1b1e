"""FCDenseNet103 (blocks of 4, 5, 7, 10 and 12 layers, a 15-layer
bottleneck, growth 16) through the port on the CPU, against the
benchmark's plain float32 reference (``portbench/reference``): three
``run_scan_chunk`` steps and the fused forward's logits at a small frame;
K3a and K3b over the bottleneck's 15 layers against autograd; and the
small-plane rule at FCDenseNet67's and 103's layouts.  Imports neither
JAX nor the JAX package."""
import importlib
import itertools
import os
from collections import deque

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_sites import (DENSE_SITES, DENSE_SITES_103, LATER, LATER_103,
                         TD_SITES, TD_SITES_103)

from portbench import harness, inputs
from portbench.reference import augment as ref_aug
from portbench.reference import compare
from portbench.reference import train as ref_train
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb
from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import fused_apply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the benchmark's configuration at a 64x96 frame: five pools leave a 2x3
# bottleneck (at 32x32 its BatchNorms would see two values a channel)
CFG = dict(harness.read_json(os.path.join(
    ROOT, "portbench", "configs", "fcdensenet103.json")), height=64, width=96)
# the benchmark's train traffic at two images a step
TRAFFIC = dict(harness.read_json(os.path.join(
    ROOT, "portbench", "traffic", "train_sup_b32.json")), batch=2,
    scan_chunk=2, split_frames=16, draw_pool_steps=4)


@pytest.fixture
def f32_program(monkeypatch):
    """The program's models built with its float32 policy."""
    ct = importlib.import_module(f"{harness.PORT}.cli.test")
    real = ct.build_model
    monkeypatch.setattr(ct, "build_model", lambda arch, n, policy=None:
                        real(arch, n, F32_POLICY))
    return real


def test_the_configuration_is_fcdensenet103():
    assert CFG["arch"] == "103"
    assert (CFG["down_blocks"], CFG["bottleneck_layers"], CFG["up_blocks"]) \
        == ([4, 5, 7, 10, 12], 15, [12, 10, 7, 5, 4])
    bench = harness.benchmark()
    entry = harness.find(bench["configs"], "fcdensenet103", "configuration")
    assert entry["reduced"] == []
    cell = harness.find(bench["workloads"], "fcd103.train_sup", "workload")
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("fcdensenet103", "train_sup_b32", 1)
    # no loss limit: the unchanged state's least loss gap on the card is
    # under three times the program's most
    limits = compare.limits("fcdensenet103")
    assert set(limits) == {"grad1_gap", "delta3_gap", "stats1_gap",
                           "stats3_gap"}


def test_training_steps_match_the_reference(f32_program):
    ctx = harness.Ctx({"name": "fcd103.train_sup"}, CFG, TRAFFIC,
                      2 ** 35 + 11, 1.0, False, "cpu", {})
    cell = harness.driver("train_scan").Cell(ctx)
    cell.setup()
    cell.release()
    got = compare.train_numbers(cell.prog, cell.reference())
    # wider than the tiny network's (1e-5, 1e-4, 1e-3): over 91 layers a
    # conv bias that only BatchNorms and dropout follow has a gradient of
    # cancelling terms, whose float32 round-off reads 4e-4 to 4e-3 of the
    # median leaf (four seeds; the bf16 program on a card reads 0.05 to
    # 0.09), and Adam carries it into the later losses (4e-6 to 1.5e-5)
    assert got["loss_gap"] < 1e-4
    assert got["grad1_gap"] < 2e-2
    assert got["stats1_gap"] < 1e-5
    assert got["stats3_gap"] < 1e-2
    # Adam moves elements whose gradient is round-off by a full step of
    # either sign, so the change's norms agree less closely
    assert got["delta3_gap"] < 0.05


def test_fused_forward_matches_the_reference_logits(f32_program):
    weights = inputs.weights(CFG, 13, "cpu")
    model = f32_program("103", 4, F32_POLICY)
    model.load_state_dict(weights)
    frames = inputs.frames(3, CFG["height"], CFG["width"], 13, "pool", "cpu")
    got = fused_apply(model.eval(), ref_aug.eval_input(frames),
                      use_softmax=False)
    want = ref_train.serve_logits(CFG, weights, frames)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


def _later_sum(v, gps, ws, scs, shs):
    """Autograd's cotangent of ``v`` through sum_l <conv(relu(v*sc_l +
    sh_l), W_l), gp_l>, the later layers' part of a dense-block sweep."""
    v = v.detach().requires_grad_()
    total = sum((F.conv2d(torch.relu(v * sc[:, None, None]
                                     + sh[:, None, None]),
                          ktb.conv_weight(w), padding=1) * gp).sum()
                for gp, w, sc, sh in zip(gps, ws, scs, shs))
    return torch.autograd.grad(total, v)[0]


@pytest.mark.parametrize("n_layers", [15])
def test_stage_and_final_over_the_bottleneck_match_autograd(n_layers):
    """K3a with 15 later layers and K3b over 15 layers (the 103
    bottleneck's count; at most ``MAX_LAYERS`` a launch) against
    autograd of the layers they sweep, in float32."""
    assert n_layers < ktb.MAX_LAYERS
    gen = torch.Generator().manual_seed(103)

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=gen) * s

    b, c, g, h, w = 2, 40, 16, 3, 5
    x, y, dy = r(b, c, h, w), r(b, g, h, w), r(b, g, h, w)
    c0, c1 = r(2, g, s=0.5)
    scale, shift = torch.rand(c, generator=gen) + 0.5, r(c, s=0.3)
    weight = r(c, 9, g, s=0.3)
    mask = (torch.rand(b, g, generator=gen) > 0.3).float() / 0.8
    gps = [r(b, g, h, w) for _ in range(n_layers)]
    # the later layers' rows on y (K3a) and on x (K3b), BN on them
    wys = [r(g, 9, g, s=0.3) for _ in range(n_layers)]
    scys = [torch.rand(g, generator=gen) + 0.5 for _ in range(n_layers)]
    shys = [r(g, s=0.3) for _ in range(n_layers)]
    wxs = [r(c, 9, g, s=0.3) for _ in range(n_layers)]
    scxs = [torch.rand(c, generator=gen) + 0.5 for _ in range(n_layers)]
    shxs = [r(c, s=0.3) for _ in range(n_layers)]

    gp, dw, dscale, dshift, dbias = ktb.stage(
        x, y, dy, c0, c1, gps, wys, scale, shift, scys, shys, weight, mask)
    gpre = (dy + c0[:, None, None] + c1[:, None, None] * y
            + _later_sum(y, gps, wys, scys, shys)) * mask[:, :, None, None]
    leaves = [t.clone().requires_grad_() for t in (ktb.conv_weight(weight),
                                                   scale, shift)]
    own = F.conv2d(torch.relu(x * leaves[1][:, None, None]
                              + leaves[2][:, None, None]), leaves[0],
                   padding=1)
    dw4, dsc, dsh = torch.autograd.grad((own * gpre).sum(), leaves)
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gp, gpre, **tol)
    torch.testing.assert_close(dw, dw4.permute(1, 2, 3, 0).reshape(c, 9, g),
                               **tol)
    torch.testing.assert_close(dscale, dsc, **tol)
    torch.testing.assert_close(dshift, dsh, **tol)
    torch.testing.assert_close(dbias, gpre.sum((0, 2, 3)), **tol)

    dx = ktb.final(x, gps, wxs, scxs, shxs)
    torch.testing.assert_close(dx, _later_sum(x, gps, wxs, scxs, shxs),
                               **tol)


def _step_small_planes(dense, later, td) -> int:
    """The small-plane launches of one train step: K1 and K3a at every
    dense layer, K1 and K2 at every TransitionDown, K3b once a block."""
    small = [ktb.small_plane(h, w) for _, h, w in dense]
    firsts = [s for s, n, m in zip(small, later, [0] + later[:-1])
              if n >= m]  # a block's first layer has the most after it
    return (2 * sum(small) + firsts.count(True)
            + 2 * sum(ktb.small_plane(h, w) for _, h, w in td))


@pytest.mark.parametrize("arch,dense,later,td,want", [
    ("67", DENSE_SITES, LATER, TD_SITES, (55, 25, 59)),
    ("103", DENSE_SITES_103, LATER_103, TD_SITES_103, (91, 59, 127))])
def test_small_planes_by_the_rule(arch, dense, later, td, want):
    """Planes whose pixels fill under half of their 12x16 tiles: 15x20,
    7x10 and 3x5 of 120x160 frames; 59 of FCDenseNet103's 91 dense
    layers and 127 of its step's 203 K1-K3b launches (67: 25 of 55, 59
    of 131)."""
    planes = [(120 >> i, 160 >> i) for i in range(6)]
    assert [p for p in planes if ktb.small_plane(*p)] == [(15, 20), (7, 10),
                                                          (3, 5)]
    n, small_dense, small_step = want
    assert len(dense) == n
    assert sum(ktb.small_plane(h, w) for _, h, w in dense) == small_dense
    assert _step_small_planes(dense, later, td) == small_step
    # eleven blocks, each one K3b launch
    starts = [i for i, k in enumerate(later) if i == 0 or k >= later[i - 1]]
    assert len(starts) == 11


def test_small_plane_launches_reset_with_the_others():
    ktb.launches.update(stage=4, final=1)
    ktb.small_plane_launches["stage"] = 3
    assert ktb.step_launches() == {"launches": 5, "small_plane_launches": 3,
                                   "stage_items": 0, "stage_prefetched": 0}
    ktb.reset_launches()
    assert ktb.small_plane_launches == dict.fromkeys(ktb.launches, 0)
    assert ktb.step_launches() == {"launches": 0, "small_plane_launches": 0,
                                   "stage_items": 0, "stage_prefetched": 0}


def test_step_graph_counts_the_capture_alone(monkeypatch):
    """``StepGraph(body, state, counters)`` puts on its ``train.capture``
    span what the captured call of ``body`` moved of ``counters()``, not
    what the warm-up calls before it moved.  The card's calls are stubbed:
    the capture runs ``body`` once more on the CPU."""
    import contextlib

    from sim2real_lane_segment_tpu_torch.core import tracing
    from sim2real_lane_segment_tpu_torch.train import graphs

    class Stream:
        def wait_stream(self, other):
            pass

    cuda = torch.cuda
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(cuda, name, lambda: None)
    monkeypatch.setattr(cuda, "memory_reserved", lambda: 0)
    monkeypatch.setattr(cuda, "Stream", Stream)
    monkeypatch.setattr(cuda, "current_stream", Stream)
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "CUDAGraph", object)
    calls = {"k": 0, "small": 0}

    def body():
        calls["k"] += 3
        calls["small"] += 2
        return torch.zeros(1)

    def counters():
        return {"launches": calls["k"], "small_plane_launches":
                calls["small"]}

    g = graphs.StepGraph(body, [torch.ones(2)], counters)
    assert calls == {"k": 3 * (graphs.WARMUP_STEPS + 1),
                     "small": 2 * (graphs.WARMUP_STEPS + 1)}
    assert g.counted == {"launches": 3, "small_plane_launches": 2}
    span = [s for s in tracing.spans() if s.name == "train.capture"][-1]
    assert span.attrs == g.counted
    # without counters the span carries nothing
    graphs.StepGraph(body, [torch.ones(2)])
    assert [s for s in tracing.spans()
            if s.name == "train.capture"][-1].attrs == {}


def test_the_small_plane_metric_reads_the_capture_span(monkeypatch):
    """``ktrain.small_plane_launches`` reads the attribute of the last
    ``train.capture`` span before the window, and nothing where the span
    lacks it (a program without the counter)."""
    tracing = importlib.import_module(f"{harness.PORT}.core.tracing")
    # a ring of its own: spans that earlier tests of this process closed
    # may have overflowed the shared one, and nothing is read from a
    # ring that dropped spans
    monkeypatch.setattr(tracing, "_ring", deque(maxlen=tracing.RING))
    monkeypatch.setattr(tracing, "_closed", itertools.count(1))
    metric = harness.reader("ktrain.small_plane_launches")
    with tracing.span("train.capture", launches=203,
                      small_plane_launches=127):
        pass
    with tracing.span("train.capture"):
        pass
    t_open = tracing.spans()[-1].t1 * 1e-9 + 1.0
    rec = {"kind": "train", "chunks": [(t_open, t_open + 1.0, False)]}
    assert metric.read(rec) is None
    with tracing.span("train.capture", launches=203,
                      small_plane_launches=127):
        pass
    t_open = tracing.spans()[-1].t1 * 1e-9 + 1.0
    rec = {"kind": "train", "chunks": [(t_open, t_open + 1.0, False)]}
    assert metric.read(rec) == 127


@pytest.mark.parametrize("site", DENSE_SITES_103 + TD_SITES_103,
                         ids=lambda s: "c%d_%dx%d" % s)
def test_every_fcdensenet103_site_takes_the_tensor_cores(site):
    """All 91 + 5 K1 sites and all 91 K3a sites of FCDenseNet103 in
    bfloat16 (inputs up to 1,072 channels, TransitionDowns up to 656);
    none in float32."""
    c, h, w = site
    taps, n = (9, 16) if site in DENSE_SITES_103 else (1, c)
    assert ktb.takes_mma_fwd(torch.bfloat16, taps, c, n)
    assert not ktb.takes_mma_fwd(torch.float32, taps, c, n)
    if taps == 1:
        assert ktb.takes_mma_bwd(torch.bfloat16, taps, n)
        return
    assert ktb.takes_mma_stage(torch.bfloat16, n)
    chunks, units = ktb.mma_stage_chunks(c)
    assert 1 <= units <= 4 and (chunks - 1) * units * 16 < c
    assert chunks * units * 16 >= c
    splits = ktb.mma_stage_splits(c, 32, h, w)
    assert 1 <= splits <= 32 * ktb.mma3_tiles(h, w)
    assert chunks * splits <= 132
