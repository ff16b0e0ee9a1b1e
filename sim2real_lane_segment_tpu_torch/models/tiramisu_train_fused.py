"""FC-DenseNet train-mode forward and backward on fused consumer kernels
(K1, K2, K3a, K3b).

Counterpart of the JAX package's ``models/tiramisu_train_pallas.py``
(``pallas_apply_train``), in NCHW with the zero padding applied after BN
and ReLU.  Every consumer layer (a DenseLayer's BN -> ReLU -> 3x3 conv ->
+bias -> Dropout2d, or a TransitionDown's with a 1x1 conv) runs as one
kernel over the virtual concat of its input segments:

- ``Consumer``: one layer as an autograd Function, K1 forward and K2
  backward.  TransitionDown always takes it; with
  ``fused_block_bwd=False`` every DenseLayer does too.
- ``FusedBlock``: a whole dense block as one autograd Function.  The
  forward runs K1 per layer into one feature buffer ``[B, c_in + n*g, H,
  W]`` (layer j reads channels [0, c_j) and writes [c_j, c_j + g)); the
  backward is the fused reverse sweep: K3a per layer (each stage rebuilds
  its dy_j from the later layers' stored g_pre), then K3b for the block
  input.

The BatchNorm statistics stay differentiable glue outside the kernels, as
in JAX: batch statistics (``tiramisu.batch_stats``, over the global
batch in a data-parallel step), the fold to a per-channel affine
(``fold_affine``) and their gradients are PyTorch autograd.  Inside
``FusedBlock.backward`` the fold's and the statistics' vector-Jacobian
products come from ``torch.autograd.grad``; no BatchNorm backward is
written by hand.  Dropout masks are operands (``tiramisu.drop_masks``).
Other glue stays plain PyTorch, as XLA ran it outside the Pallas kernels:
the first conv, the 2x2 max-pool (``tiramisu.max_pool2``), the
stride-2 transposed conv and the L2-normalized classifier head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import train_block as ktb
from ..kernels.dense_block import MMA_WIDTH, pad_growth
from ..parallel import dp
from .tiramisu import (EPS, DenseBlock, FCDenseNet, batch_stats,
                       dropout_sites, grad_reverse, max_pool2, running_update,
                       transition_up)


# ---------------------------------------------------------------------------
# differentiable glue
# ---------------------------------------------------------------------------

def fold_affine(gamma, beta, mu, var) -> tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm with batch statistics as a per-channel f32 affine."""
    scale = gamma * torch.rsqrt(var + EPS)
    return scale, beta - mu * scale


class _PadGrowth(torch.autograd.Function):
    """``pad_growth(rows, dtype)``, whose backward hands the [c, taps, g]
    cotangent back cast to the rows' dtype: one launch, as the cast of the
    copy it replaces (autograd's own would also scatter it into a padded
    buffer and slice it out again)."""

    @staticmethod
    def forward(ctx, rows, dtype):
        ctx.rows_dtype = rows.dtype
        return pad_growth(rows, dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.rows_dtype), None


def conv_weight_rows(conv: torch.nn.Conv2d, dtype) -> torch.Tensor:
    """OIHW conv weight -> the kernels' [c_in, taps, c_out] in ``dtype``:
    contiguous, or where the consumer takes a tensor-core 3x3 kernel
    (``ktb.takes_mma_fwd``) in the padded layout those read
    (``pad_growth``; growth 16 is contiguous already)."""
    w = conv.weight
    o, c, kh, kw = w.shape
    rows = w.permute(1, 2, 3, 0).reshape(c, kh * kw, o)
    if kh * kw == 9 and o < MMA_WIDTH and ktb.takes_mma_fwd(dtype, 9, c, o):
        return _PadGrowth.apply(rows, dtype)
    return rows.to(dtype).contiguous()


def head(model: FCDenseNet, feats: torch.Tensor,
         use_softmax: bool = True) -> torch.Tensor:
    """L2 norm + 1x1 classifier + temperature, NCHW.  The norm is clamped
    at 1e-24 before the sqrt; the product runs in the features' dtype and
    is divided by the norm in f32."""
    f = feats.to(torch.float32)
    norm = torch.sqrt(torch.clamp((f * f).sum(1, keepdim=True), min=1e-24))
    conv = model.classifier.finalConv
    logits = F.conv2d(feats, conv.weight.to(feats.dtype))
    logits = logits.to(torch.float32) / norm + conv.bias[:, None, None]
    logits = logits / model.classifier.temperature
    return torch.softmax(logits, dim=1) if use_softmax else logits


# ---------------------------------------------------------------------------
# one consumer: K1 forward, K2 backward
# ---------------------------------------------------------------------------

class Consumer(torch.autograd.Function):
    """``T((conv(T(relu(x*scale + shift)), W) + bias) * mask)`` over all
    channels of ``x``; ``weight`` is [c, taps, n] in ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, scale, shift, weight, bias, mask):
        ctx.save_for_backward(x, scale, shift, weight, mask)
        return ktb.consumer_fwd(x, scale, shift, weight, bias, mask)

    @staticmethod
    def backward(ctx, dy):
        x, scale, shift, weight, mask = ctx.saved_tensors
        # K2's 3x3 kernels read contiguous rows, not the padded layout
        dseg, dscale, dshift, dw, dbias = ktb.consumer_bwd(
            x, scale, shift, weight.contiguous(), mask, dy.contiguous())
        return dseg, dscale, dshift, dw.to(weight.dtype), dbias, None


# ---------------------------------------------------------------------------
# a whole dense block: K1 per layer forward, K3a/K3b backward
# ---------------------------------------------------------------------------

def _split(seq, sizes):
    out, i = [], 0
    for n in sizes:
        out.append(seq[i:i + n])
        i += n
    return out


class FusedBlock(torch.autograd.Function):
    """``apply(n_seg, n_layers, *segs, mu_in, var_in, *gammas, *betas,
    *weights, *biases, *masks)`` -> ``(buf, mu_new, var_new)``: the block's
    feature buffer ``[B, c_in + n*g, H, W]`` (the input segments, then each
    layer's g channels) and the batch statistics ``[n*g]`` of the new
    channels, computed once here and differentiable.  ``mu_in``/``var_in``
    are the batch statistics of the input channels; weights are [c_j, 9,
    g] in the segments' dtype."""

    @staticmethod
    def forward(ctx, n_seg, n, *args):
        segs = args[:n_seg]
        mu_in, var_in = args[n_seg], args[n_seg + 1]
        gammas, betas, weights, biases, masks = _split(args[n_seg + 2:],
                                                       [n] * 5)
        b, _, h, w = segs[0].shape
        c_in = sum(s.shape[1] for s in segs)
        g = weights[0].shape[2]
        buf = torch.empty(b, c_in + n * g, h, w, dtype=segs[0].dtype,
                          device=segs[0].device)
        off = 0
        for s in segs:  # the virtual concat
            buf[:, off:off + s.shape[1]].copy_(s)
            off += s.shape[1]
        mus, vars_ = [mu_in], [var_in]
        for j in range(n):
            c_j = c_in + j * g
            scale, shift = fold_affine(gammas[j], betas[j], torch.cat(mus),
                                       torch.cat(vars_))
            y = ktb.consumer_fwd(buf, scale, shift, weights[j], biases[j],
                                 masks[j], out=buf[:, c_j:c_j + g])
            mu, var = batch_stats(y)
            mus.append(mu)
            vars_.append(var)
        mu_all, var_all = torch.cat(mus), torch.cat(vars_)
        ctx.seg_chans = [s.shape[1] for s in segs]
        ctx.n = n
        # the data-parallel world of the statistics, for the backward's
        # (autograd may run it on a thread of its own)
        ctx.world = dp.current()
        ctx.save_for_backward(buf, mu_all, var_all, *gammas, *betas,
                              *weights, *masks)
        return buf, mu_all[c_in:], var_all[c_in:]

    @staticmethod
    def backward(ctx, dbuf, dmu_new, dvar_new):
        with dp.active(ctx.world):
            return FusedBlock._backward(ctx, dbuf, dmu_new, dvar_new)

    @staticmethod
    def _backward(ctx, dbuf, dmu_new, dvar_new):
        n = ctx.n
        buf, mu_all, var_all, *rest = ctx.saved_tensors
        gammas, betas, weights, masks = _split(rest, [n] * 4)
        c_in = sum(ctx.seg_chans)
        g = weights[0].shape[2]
        ys = [buf[:, c_in + j * g:c_in + (j + 1) * g] for j in range(n)]

        # the folds, recomputed with their graphs for the vjps
        folds, fold_in = [], []
        with torch.enable_grad():
            for j in range(n):
                c_j = c_in + j * g
                leaves = [gammas[j].detach().requires_grad_(),
                          betas[j].detach().requires_grad_(),
                          mu_all[:c_j].detach().requires_grad_(),
                          var_all[:c_j].detach().requires_grad_()]
                folds.append(fold_affine(*leaves))
                fold_in.append(leaves)
        scales = [f[0].detach() for f in folds]
        shifts = [f[1].detach() for f in folds]

        # cotangents of every channel's statistics: those of the new
        # channels' outputs, then what later layers' folds add
        zeros = torch.zeros(c_in, dtype=torch.float32, device=buf.device)
        acc_dmu = torch.cat([zeros, dmu_new.to(torch.float32)])
        acc_dvar = torch.cat([zeros, dvar_new.to(torch.float32)])
        g_pres = [None] * n
        dgammas, dbetas, dweights, dbiases = ([None] * n for _ in range(4))
        for j in reversed(range(n)):
            lo = c_in + j * g
            # the statistics of y_j: their cotangents pull back into a
            # [B, g, H, W] term
            with torch.enable_grad():
                yv = ys[j].detach().requires_grad_()
                mu, var = batch_stats(yv)
                (corr,) = torch.autograd.grad(
                    (mu, var), yv, (acc_dmu[lo:lo + g], acc_dvar[lo:lo + g]))
            ext = dbuf[:, lo:lo + g].to(torch.float32) + corr.to(torch.float32)
            later = range(j + 1, n)
            gp, dw, dsc, dsh, db = ktb.stage(
                buf, ys[j], ext.contiguous(), [g_pres[l] for l in later],
                [weights[l][lo:lo + g] for l in later], scales[j], shifts[j],
                [scales[l][lo:lo + g] for l in later],
                [shifts[l][lo:lo + g] for l in later], weights[j], masks[j])
            g_pres[j] = gp
            dweights[j] = dw.to(weights[j].dtype)
            dbiases[j] = db
            dg, dbt, dmu, dvar = torch.autograd.grad(
                folds[j], fold_in[j], (dsc, dsh))
            dgammas[j], dbetas[j] = dg, dbt
            acc_dmu[:lo] += dmu
            acc_dvar[:lo] += dvar

        dx = ktb.final(buf, g_pres, [weights[l][:c_in] for l in range(n)],
                       [scales[l][:c_in] for l in range(n)],
                       [shifts[l][:c_in] for l in range(n)])
        dx = dx + dbuf[:, :c_in]  # the inputs pass through into the buffer
        dsegs, off = [], 0
        for c in ctx.seg_chans:
            dsegs.append(dx[:, off:off + c])
            off += c
        return (None, None, *dsegs, acc_dmu[:c_in], acc_dvar[:c_in],
                *dgammas, *dbetas, *dweights, *dbiases, *([None] * n))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _cat(ts):
    return ts[0] if len(ts) == 1 else torch.cat(ts, dim=1)


def _block_train(block: DenseBlock, segs, stats, masks, updates, prefix,
                 fused_block_bwd, consumer_fn):
    """A train-mode dense block over the segments ``segs`` with per-segment
    batch ``stats``.  Returns (concat, its (mu, var), new features, their
    (mu, var))."""
    dtype = segs[0].dtype
    layers = block.layers()
    n = len(layers)
    lmasks = [next(masks) for _ in range(n)]
    mu_in = torch.cat([s[0] for s in stats])
    var_in = torch.cat([s[1] for s in stats])
    c_in = mu_in.shape[0]
    g = layers[0].Conv_0.out_channels
    weights = [conv_weight_rows(lay.Conv_0, dtype) for lay in layers]
    if fused_block_bwd:
        buf, mu_new, var_new = FusedBlock.apply(
            len(segs), n, *segs, mu_in, var_in,
            *[lay.BatchNorm_0.weight for lay in layers],
            *[lay.BatchNorm_0.bias for lay in layers], *weights,
            *[lay.Conv_0.bias for lay in layers], *lmasks)
        mu_all, var_all = torch.cat([mu_in, mu_new]), torch.cat([var_in,
                                                                 var_new])
    else:
        cur = list(segs)
        mus, vars_ = [mu_in], [var_in]
        for j, lay in enumerate(layers):
            scale, shift = fold_affine(lay.BatchNorm_0.weight,
                                       lay.BatchNorm_0.bias, torch.cat(mus),
                                       torch.cat(vars_))
            y = consumer_fn(_cat(cur), scale, shift, weights[j],
                            lay.Conv_0.bias, lmasks[j])
            cur.append(y)
            mu, var = batch_stats(y)
            mus.append(mu)
            vars_.append(var)
        buf = torch.cat(cur, dim=1)
        mu_all, var_all = torch.cat(mus), torch.cat(vars_)
    for j, lay in enumerate(layers):
        c_j = c_in + j * g
        updates[f"{prefix}.DenseLayer_{j}.BatchNorm_0"] = running_update(
            lay.BatchNorm_0, mu_all[:c_j], var_all[:c_j])
    return (buf, (mu_all, var_all), buf[:, c_in:],
            (mu_all[c_in:], var_all[c_in:]))


def fused_apply_train(model: FCDenseNet, x: torch.Tensor, masks=None, *,
                      use_softmax: bool = True,
                      fused_block_bwd: bool = True,
                      reverse_features: bool = False,
                      consumer_fn=Consumer.apply):
    """Train-mode forward of an ``FCDenseNet`` through the fused consumer
    kernels, differentiable by autograd.

    x: (N, 3, H, W) float32.  ``masks``: the Dropout2d masks in site order
    (``tiramisu.drop_masks``; None: no dropout).  Returns ``(output,
    new_batch_stats)`` like ``model(x, train=True, masks=masks)``.
    ``fused_block_bwd=False`` runs every dense layer as its own
    ``Consumer`` (K2 backward) instead of the fused block sweep.
    ``reverse_features`` puts MME's ``grad_reverse`` on the features that
    enter the head: the JAX path reverses each segment of that concat,
    which is the same.  ``consumer_fn`` runs each ``Consumer`` site (a
    TransitionDown, and each dense layer without ``fused_block_bwd``), as
    ``Consumer.apply`` does; ``cli/train_breakdown`` records them so.
    """
    if model.kernel_size != 1:
        raise NotImplementedError("the fused train head takes a 1x1 "
                                  "classifier only")
    dtype = model.policy.compute_dtype
    fe = model.featureExtractor
    b = x.shape[0]
    if masks is None:
        masks = [torch.ones(b, c, device=x.device)
                 for c in dropout_sites(model)]
    masks = iter(masks)
    updates: dict = {}

    fc = fe.firstconv
    y = F.conv2d(x.to(dtype), fc.weight.to(dtype), padding=1)
    y = y + fc.bias.to(dtype)[:, None, None]
    segs, stats = [y], [batch_stats(y)]

    def block(name, segs, stats):
        return _block_train(getattr(fe, name), segs, stats, masks, updates,
                            f"featureExtractor.{name}", fused_block_bwd,
                            consumer_fn)

    skips = []
    for i in range(len(model.down_blocks)):
        cat, cat_st, _, _ = block(f"denseDown{i}", segs, stats)
        skips.append((cat, cat_st))
        td = getattr(fe, f"transDown{i}")
        bn = td.BatchNorm_0
        scale, shift = fold_affine(bn.weight, bn.bias, *cat_st)
        updates[f"featureExtractor.transDown{i}.BatchNorm_0"] = \
            running_update(bn, *cat_st)
        t = consumer_fn(cat, scale, shift, conv_weight_rows(td.Conv_0, dtype),
                        td.Conv_0.bias, next(masks))
        t = max_pool2(t)
        segs, stats = [t], [batch_stats(t)]

    _, _, new, new_st = block("bottleneck", segs, stats)
    feats = new
    for i in range(len(model.up_blocks)):
        skip, skip_st = skips.pop()
        up = transition_up(feats, getattr(fe, f"transUp{i}").ConvTranspose_0,
                           skip.shape[2], skip.shape[3], dtype)
        cat, _, new, _ = block(f"denseUp{i}", [up, skip],
                               [batch_stats(up), skip_st])
        feats = cat if i == len(model.up_blocks) - 1 else new
    if reverse_features:
        feats = grad_reverse(feats)
    return head(model, feats, use_softmax), updates
