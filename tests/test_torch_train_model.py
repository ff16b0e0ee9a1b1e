"""The port's train-mode FC-DenseNet against the JAX package.

- ``Consumer`` and ``FusedBlock`` gradients against ``jax.vjp`` of the JAX
  custom-VJP primitives ``_consumer`` and ``_fused_block`` (interpret mode).
- ``fused_apply_train`` (one ``FusedBlock`` per dense block) and the plain
  train forward
  ``model(x, train=True)`` against ``pallas_apply_train(interpret=True)``
  and ``fast_apply_train``, with the JAX path's own dropout masks: outputs,
  new batch statistics and every parameter gradient, at atol 5e-4 and rtol
  5e-3, the JAX package's own gate between its train paths.

Float32 throughout (``F32_POLICY`` on both sides), but for one check
that the plain train forward runs wholly in float64 under ``F64_POLICY``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_model
from test_torch_common import (flat_numpy, from_cm, jax_drop_masks,
                               jax_variables, load_port, nchw_to_nhwc,
                               nhwc_to_nchw, to_cm, torch_grad_like,
                               unflatten, wf_rows)

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.models.tiramisu import \
    FCDenseNet as JaxFCDenseNet
from sim2real_lane_segment_tpu.models.tiramisu_fast import fast_apply_train
from sim2real_lane_segment_tpu.models.tiramisu_train_pallas import (
    _BlkCfg, _Cfg, _consumer, _fused_block, _seg_stats_cm,
    pallas_apply_train)
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.models.tiramisu import (
    FCDenseNet, batch_stats, dropout_sites)
from sim2real_lane_segment_tpu_torch.models.tiramisu_train_fused import (
    Consumer, FusedBlock, fused_apply_train)

GATE = dict(atol=5e-4, rtol=5e-3)
TOL = dict(atol=1e-5, rtol=1e-4)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.requires_grad_(grad)


def _masks(rng, b, g):
    m = (rng.random((b, g)) > 0.3).astype(np.float32) / 0.8
    m[:, 0] = 0.0
    return m


@pytest.mark.parametrize("taps", [9, 1])
def test_consumer_grads_match_jax_vjp(taps):
    rng = np.random.default_rng(taps)
    b, h, w, segs = 2, 8, 16, (8, 4)
    c = sum(segs)
    n = 4 if taps == 9 else c
    x = rng.normal(size=(b, c, h, w)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = rng.normal(0, 0.3, c).astype(np.float32)
    weight = rng.normal(0, 0.3, (c, taps, n)).astype(np.float32)
    bias = rng.normal(0, 0.1, n).astype(np.float32)
    mask = _masks(rng, b, n)
    dy = rng.normal(size=(b, n, h, w)).astype(np.float32)

    cfg = _Cfg(h, w, segs, taps, n, "float32", True)
    cm = to_cm(x)
    y_ref, vjp = jax.vjp(
        lambda s0, s1, sc, sh, wf, bi: _consumer(cfg, (s0, s1), sc, sh, wf,
                                                 bi, jnp.asarray(mask)[..., None]),
        cm[:, :8], cm[:, 8:], scale[:, None], shift[:, None],
        wf_rows(weight), bias[:, None])
    ds0, ds1, dsc, dsh, dwf, db = vjp(to_cm(dy))

    args = [_t(a, True) for a in (x, scale, shift, weight, bias)]
    y = Consumer.apply(*args, _t(mask))
    np.testing.assert_allclose(y.detach().numpy(), from_cm(y_ref, h, w), **TOL)
    y.backward(_t(dy))
    dx = np.concatenate([from_cm(ds0, h, w), from_cm(ds1, h, w)], axis=1)
    np.testing.assert_allclose(args[0].grad.numpy(), dx, **TOL)
    np.testing.assert_allclose(args[1].grad.numpy(), np.asarray(dsc)[:, 0],
                               **TOL)
    np.testing.assert_allclose(args[2].grad.numpy(), np.asarray(dsh)[:, 0],
                               **TOL)
    np.testing.assert_allclose(wf_rows(args[3].grad.numpy()), dwf, **TOL)
    np.testing.assert_allclose(args[4].grad.numpy(), np.asarray(db)[:, 0],
                               **TOL)


def _check_fused_block(stats_cotangent):
    """FusedBlock against ``jax.vjp`` of ``_fused_block``; with
    ``stats_cotangent`` the new channels' batch statistics (FusedBlock's
    second and third outputs) get a random cotangent as well."""
    rng = np.random.default_rng(7)
    b, h, w, segs, g, n = 2, 8, 16, (8, 4), 4, 3
    c_in = sum(segs)
    xs = [rng.normal(size=(b, c, h, w)).astype(np.float32) for c in segs]
    gammas = [rng.uniform(0.5, 1.5, c_in + j * g).astype(np.float32)
              for j in range(n)]
    betas = [rng.normal(0, 0.2, c_in + j * g).astype(np.float32)
             for j in range(n)]
    weights = [rng.normal(0, 0.3, (c_in + j * g, 9, g)).astype(np.float32)
               for j in range(n)]
    biases = [rng.normal(0, 0.1, g).astype(np.float32) for _ in range(n)]
    masks = [_masks(rng, b, g) for _ in range(n)]
    dys = [rng.normal(size=(b, g, h, w)).astype(np.float32)
           for _ in range(n)]
    d_st = (rng.normal(size=(2, n * g)).astype(np.float32) if stats_cotangent
            else np.zeros((2, n * g), np.float32))

    cfg = _BlkCfg(h, w, segs, n, g, "float32", True)
    cms = tuple(to_cm(x) for x in xs)

    def blk(cms, gammas, betas, wfs, biases):
        mu_var = [_seg_stats_cm(s, h, w) for s in cms]
        ys = _fused_block(cfg, cms, tuple(m for m, _ in mu_var),
                          tuple(v for _, v in mu_var), gammas, betas, wfs,
                          biases, tuple(jnp.asarray(m)[..., None]
                                        for m in masks))
        st = [_seg_stats_cm(y, h, w) for y in ys]
        return ys, (jnp.concatenate([m for m, _ in st]),
                    jnp.concatenate([v for _, v in st]))

    (ys_ref, _), vjp = jax.vjp(blk, cms, tuple(gammas), tuple(betas),
                               tuple(wf_rows(wt) for wt in weights),
                               tuple(bi[:, None] for bi in biases))
    d_cms, d_gam, d_bet, d_wf, d_b = vjp(
        (tuple(to_cm(d) for d in dys), (d_st[0], d_st[1])))

    segs_t = [_t(x, True) for x in xs]
    params = [[_t(a, True) for a in group]
              for group in (gammas, betas, weights, biases)]
    stats = [batch_stats(s) for s in segs_t]
    buf, mu_new, var_new = FusedBlock.apply(
        len(segs), n, *segs_t, torch.cat([m for m, _ in stats]),
        torch.cat([v for _, v in stats]),
        *[p for group in params for p in group], *[_t(m) for m in masks])
    ys = [from_cm(y, h, w) for y in ys_ref]
    np.testing.assert_allclose(buf[:, c_in:].detach().numpy(),
                               np.concatenate(ys, axis=1), **TOL)
    mu_ref, var_ref = batch_stats(buf[:, c_in:].detach())
    np.testing.assert_allclose(mu_new.detach().numpy(), mu_ref.numpy(), **TOL)
    np.testing.assert_allclose(var_new.detach().numpy(), var_ref.numpy(),
                               **TOL)
    dbuf = np.concatenate([np.zeros((b, c_in, h, w), np.float32)] + dys,
                          axis=1)
    torch.autograd.backward((buf, mu_new, var_new),
                            (_t(dbuf), _t(d_st[0]), _t(d_st[1])))
    for s, d in zip(segs_t, d_cms):
        np.testing.assert_allclose(s.grad.numpy(), from_cm(d, h, w), **TOL)
    for j in range(n):
        np.testing.assert_allclose(params[0][j].grad.numpy(), d_gam[j], **TOL)
        np.testing.assert_allclose(params[1][j].grad.numpy(), d_bet[j], **TOL)
        np.testing.assert_allclose(wf_rows(params[2][j].grad.numpy()),
                                   d_wf[j], **TOL)
        np.testing.assert_allclose(params[3][j].grad.numpy(),
                                   np.asarray(d_b[j])[:, 0], **TOL)


def test_fused_block_grads_match_jax_vjp():
    _check_fused_block(stats_cotangent=False)


def test_fused_block_stats_outputs_grads_match_jax_vjp():
    _check_fused_block(stats_cotangent=True)


def _run_jax(jax_model, flat, x, key, apply_fn, **kw):
    """(output NCHW, new batch stats flat, param grads flat) of the JAX
    train forward under the loss mean(out**2)."""
    v = unflatten(flat)

    def loss(params):
        out, bs = apply_fn(jax_model, {"params": params,
                                       "batch_stats": v["batch_stats"]},
                           x, key, use_softmax=False, **kw)
        return jnp.mean(out ** 2), (out, bs)

    (_, (out, bs)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    return (np.transpose(np.asarray(out), (0, 3, 1, 2)),
            flat_numpy({"batch_stats": bs}), flat_numpy({"params": grads}))


def _check_port(port, forward, x, ref):
    out_ref, bs_ref, grads_ref = ref
    port.zero_grad()
    out, updates = forward(port, nhwc_to_nchw(x))
    np.testing.assert_allclose(out.detach().numpy(), out_ref, **GATE)
    assert len(updates) == len(bs_ref) // 2
    for path, arr in bs_ref.items():
        key, _ = torch_grad_like(path, arr)
        mod, leaf = key.rsplit(".", 1)
        got = updates[mod]["mean" if leaf == "running_mean" else "var"]
        np.testing.assert_allclose(got.numpy(), arr, atol=1e-5, rtol=1e-4,
                                   err_msg=path)
    (out ** 2).mean().backward()
    named = dict(port.named_parameters())
    assert len(grads_ref) == len(named)
    for path, arr in grads_ref.items():
        key, want = torch_grad_like(path, arr)
        np.testing.assert_allclose(named[key].grad.numpy(), want, **GATE,
                                   err_msg=path)


FORWARDS = {
    "plain": lambda m, x, masks: m(x, train=True, masks=masks,
                                   use_softmax=False),
    "fused": lambda m, x, masks: fused_apply_train(m, x, masks,
                                                   use_softmax=False),
}


@pytest.fixture(scope="module")
def small_case():
    kw = dict(n_classes=4, down_blocks=(1,), up_blocks=(1,),
              bottleneck_layers=2, growth_rate=4, out_chans_first_conv=8)
    jax_model = JaxFCDenseNet(**kw, policy=JAX_F32, dropout_rate=0.2)
    flat = jax_variables(jax_model, (2, 8, 16, 3), seed=3)
    x = np.random.default_rng(4).normal(size=(2, 8, 16, 3)).astype(np.float32)
    key = jax.random.key(5)
    ref = _run_jax(jax_model, flat, x, key, pallas_apply_train,
                   interpret=True)
    return kw, flat, x, key, ref


@pytest.mark.parametrize("route", list(FORWARDS))
def test_train_forward_matches_pallas_apply_train(small_case, route):
    kw, flat, x, key, ref = small_case
    port = load_port(FCDenseNet(**kw, policy=F32_POLICY), flat)
    masks = jax_drop_masks(key, dropout_sites(port), 0.2, x.shape[0])
    _check_port(port, lambda m, xt: FORWARDS[route](m, xt, masks), x, ref)


LADDERS = {
    "tiny_24x32": (dict(down_blocks=(2, 2), up_blocks=(2, 2)), (2, 24, 32)),
    "odd_30x40": (dict(down_blocks=(2, 2, 2), up_blocks=(2, 2, 2)),
                  (1, 30, 40)),
}


@pytest.mark.parametrize("ladder", list(LADDERS))
def test_train_forward_matches_fast_apply_train(ladder):
    """The tiny model's ladders against the segment-wise XLA train path
    (no Pallas), plain and fused routes, with dropout 0.2."""
    blocks, (b, h, w) = LADDERS[ladder]
    jax_model = tiny_model().clone(**blocks)
    flat = jax_variables(jax_model, (b, h, w, 3), seed=8)
    x = np.random.default_rng(9).normal(size=(b, h, w, 3)).astype(np.float32)
    key = jax.random.key(10)
    ref = _run_jax(jax_model, flat, x, key, fast_apply_train)
    for route in ("plain", "fused"):
        port = load_port(FCDenseNet(
            n_classes=4, bottleneck_layers=2, growth_rate=4,
            out_chans_first_conv=8, policy=F32_POLICY, **blocks), flat)
        masks = jax_drop_masks(key, dropout_sites(port), 0.2, b)
        _check_port(port, lambda m, xt: FORWARDS[route](m, xt, masks), x,
                    ref)


def test_dropout_sites_follow_the_jax_order():
    port = FCDenseNet(n_classes=4, down_blocks=(2, 2), up_blocks=(2, 2),
                      bottleneck_layers=2, growth_rate=4,
                      out_chans_first_conv=8)
    # down0: 2 layers + TD(16); down1: 2 layers + TD(24); bottleneck; up
    assert dropout_sites(port) == [4, 4, 16, 4, 4, 24, 4, 4, 4, 4, 4, 4]


def test_fused_output_is_finite_with_nchw_shape():
    port = FCDenseNet(n_classes=4, down_blocks=(1,), up_blocks=(1,),
                      bottleneck_layers=1, growth_rate=4,
                      out_chans_first_conv=8).eval()
    out, upd = fused_apply_train(port, torch.randn(1, 3, 6, 10))
    assert out.shape == (1, 4, 6, 10) and torch.isfinite(out).all()
    torch.testing.assert_close(out.sum(1), torch.ones(1, 6, 10))
    assert set(upd) == {n for n, m in port.named_modules()
                        if isinstance(m, torch.nn.BatchNorm2d)}


def test_plain_train_forward_runs_in_float64():
    """With ``F64_POLICY`` and float64 weights the plain train forward,
    its batch statistics, the loss and the gradients stay float64 (the
    reference the card's gradient check reads the float32 paths against),
    and agree with the float32 run."""
    from sim2real_lane_segment_tpu_torch.core.dtypes import F64_POLICY
    from sim2real_lane_segment_tpu_torch.train.losses import \
        weighted_cross_entropy

    torch.manual_seed(0)
    m32 = FCDenseNet(n_classes=4, down_blocks=(2,), up_blocks=(2,),
                     bottleneck_layers=2, growth_rate=4,
                     out_chans_first_conv=8, policy=F32_POLICY)
    m64 = FCDenseNet(n_classes=4, down_blocks=(2,), up_blocks=(2,),
                     bottleneck_layers=2, growth_rate=4,
                     out_chans_first_conv=8, policy=F64_POLICY)
    m64.load_state_dict(m32.state_dict())
    m64.double()
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(2, 3, 8, 16)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, (2, 8, 16)))
    masks = [torch.from_numpy(_masks(rng, 2, c))
             for c in dropout_sites(m32)]
    res = {}
    for model, xin in ((m32, x), (m64, x.double())):
        out, upd = model(xin, train=True, masks=masks)
        loss = weighted_cross_entropy(out, y, 4)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        res[model.policy.compute_dtype] = (out, upd, loss, grads)
    out, upd, loss, grads = res[torch.float64]
    assert out.dtype == loss.dtype == torch.float64
    assert all(s.dtype == torch.float64 for st in upd.values()
               for s in st.values())
    assert all(g.dtype == torch.float64 for g in grads)
    out32, upd32, loss32, grads32 = res[torch.float32]
    np.testing.assert_allclose(out.detach().numpy(), out32.detach().numpy(),
                               **GATE)
    np.testing.assert_allclose(float(loss.detach()), float(loss32.detach()),
                               rtol=1e-5)
    for k, st in upd.items():
        for s in ("mean", "var"):
            np.testing.assert_allclose(st[s].numpy(), upd32[k][s].numpy(),
                                       **GATE)
    for g, g32 in zip(grads, grads32):
        np.testing.assert_allclose(g.numpy(), g32.numpy(), **GATE)
