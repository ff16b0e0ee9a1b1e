"""Segment-wise FC-DenseNet forward: conv(concat) == sum of per-segment
convs.

Counterpart of the JAX package's ``models/tiramisu_fast.py``
(``fast_apply``, ``fast_apply_train``; ``cli.train --fast_train``).  The
dense-concat topology re-materializes a growing concatenation before
every DenseLayer, but every op between two concats distributes over the
channel partition:

  BN(concat(a, b))      = concat(BN_a(a), BN_b(b))      (per-channel affine)
  relu(concat(a, b))    = concat(relu(a), relu(b))
  conv(concat(a, b), W) = conv(a, W[:, :Ca]) + conv(b, W[:, Ca:])

so a dense block keeps its features as a list of segments (the block
input and each layer's output) and every consumer sums per-segment
convolutions.  TransitionDown's 1x1 conv and the head's L2 norm and 1x1
classifier split the same way; TransitionUp runs one transposed conv over
the concatenated segments, as in JAX.

These are plain functions over the port's ``FCDenseNet`` parameters in
NCHW, differentiable by autograd (no kernel of their own).
``fast_apply`` is the eval form (running statistics).
``fast_apply_train`` is the train form: a segment's batch statistics do
not change once it is produced, so they are computed once, there
(``tiramisu.batch_stats``, over the global batch in a data-parallel
step), and every consumer normalizes its slice with them and records its
own running-statistics update; Dropout2d is applied once, where a
segment is produced.  The masks are operands in ``dropout_sites`` order,
as for ``model(x, train=True, masks=...)``: the JAX module's own fold-in
key chain is not reproduced.
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from .tiramisu import (EPS, FCDenseNet, batch_stats, dropout2d, grad_reverse,
                       max_pool2, running_update, transition_up)


def _offsets(segs) -> list[tuple[int, int]]:
    offs, lo = [], 0
    for s in segs:
        offs.append((lo, lo + s.shape[1]))
        lo += s.shape[1]
    return offs


def _bn_relu_seg(seg, bn, lo, hi, mu, var, dtype):
    """The slice [lo, hi) of a BatchNorm over the virtual concat, then
    ReLU: ``seg * scale + shift`` in float32 with the running statistics
    (``mu``/``var`` None) or the segment's batch statistics."""
    if mu is None:
        mu, var = bn.running_mean[lo:hi], bn.running_var[lo:hi]
    scale = bn.weight[lo:hi] * torch.rsqrt(var + EPS)
    shift = bn.bias[lo:hi] - mu * scale
    y = seg.to(torch.float32) * scale[:, None, None] + shift[:, None, None]
    return torch.relu(y).to(dtype)


def _conv_sum(segs, conv, *, bn=None, stats=None, padding=0, dtype):
    """``sum_i conv(bn_relu(seg_i), W[:, lo_i:hi_i]) + bias`` in
    ``dtype``; ``stats`` (per-segment (mu, var)) selects batch-statistics
    BN, ``bn`` alone running-statistics BN."""
    w = conv.weight.to(dtype)
    out = None
    for i, (seg, (lo, hi)) in enumerate(zip(segs, _offsets(segs))):
        if bn is None:
            z = seg.to(dtype)
        else:
            mu, var = stats[i] if stats is not None else (None, None)
            z = _bn_relu_seg(seg, bn, lo, hi, mu, var, dtype)
        y = F.conv2d(z, w[:, lo:hi], padding=padding)
        out = y if out is None else out + y
    return out + conv.bias.to(dtype)[:, None, None]


def _transition_up(segs, tu, skip, dtype):
    """One transposed conv over the concatenated segments, cropped to the
    skip's size."""
    x = torch.cat([s.to(dtype) for s in segs], dim=1)
    return transition_up(x, tu.ConvTranspose_0, skip.shape[2],
                         skip.shape[3], dtype)


def _head(model: FCDenseNet, segs, dtype, use_softmax: bool):
    """Per-segment L2 norm + classifier + temperature (+ softmax).  A 1x1
    classifier is per-pixel linear, so it runs on the unnormalized
    segments and is divided by the norm afterwards."""
    norm2 = None
    for seg in segs:
        sq = (seg.to(torch.float32) ** 2).sum(1, keepdim=True)
        norm2 = sq if norm2 is None else norm2 + sq
    norm = torch.clamp(torch.sqrt(norm2), min=1e-12)
    cls = model.classifier
    conv = cls.finalConv
    if cls.kernel_size == 1:
        w = conv.weight.to(dtype)
        logits = None
        for seg, (lo, hi) in zip(segs, _offsets(segs)):
            y = F.conv2d(seg.to(dtype), w[:, lo:hi])
            logits = y if logits is None else logits + y
        logits = logits.to(torch.float32) / norm + conv.bias[:, None, None]
    else:
        feats = (torch.cat([s.to(torch.float32) for s in segs], 1)
                 / norm).to(dtype)
        logits = F.conv2d(feats, conv.weight.to(dtype),
                          padding=cls.kernel_size // 2)
        logits = logits.to(torch.float32) + conv.bias[:, None, None]
    logits = logits / cls.temperature
    return torch.softmax(logits, dim=1) if use_softmax else logits


def _dense_block(block, segs, dtype):
    cur, new = list(segs), []
    for lay in block.layers():
        out = _conv_sum(cur, lay.Conv_0, bn=lay.BatchNorm_0, padding=1,
                        dtype=dtype)
        cur.append(out)
        new.append(out)
    return cur, new


def fast_apply(model: FCDenseNet, x: torch.Tensor, *,
               use_softmax: bool = True) -> torch.Tensor:
    """Eval-mode forward of an ``FCDenseNet`` without concats: the values
    of ``model(x, use_softmax=...)``.  x: (N, 3, H, W) float32."""
    dtype = model.policy.compute_dtype
    fe = model.featureExtractor
    fc = fe.firstconv
    segs = [F.conv2d(x.to(dtype), fc.weight.to(dtype), fc.bias.to(dtype),
                     padding=1)]
    skips = []
    for i in range(len(model.down_blocks)):
        segs, _ = _dense_block(getattr(fe, f"denseDown{i}"), segs, dtype)
        skips.append(segs)
        td = getattr(fe, f"transDown{i}")
        t = _conv_sum(segs, td.Conv_0, bn=td.BatchNorm_0, dtype=dtype)
        segs = [F.max_pool2d(t, 2)]
    _, segs = _dense_block(fe.bottleneck, segs, dtype)
    for i in range(len(model.up_blocks)):
        skip = skips.pop()
        up = _transition_up(segs, getattr(fe, f"transUp{i}"), skip[0], dtype)
        all_segs, new = _dense_block(getattr(fe, f"denseUp{i}"),
                                     [up] + skip, dtype)
        segs = all_segs if i == len(model.up_blocks) - 1 else new
    return _head(model, segs, dtype, use_softmax)


def _dense_block_train(block, segs, stats, masks, updates, prefix, dtype):
    """A train-mode dense block over segments with per-segment batch
    ``stats``.  Returns (all segments, their stats, new segments, their
    stats)."""
    cur, cur_st = list(segs), list(stats)
    for j, lay in enumerate(block.layers()):
        bn = lay.BatchNorm_0
        out = _conv_sum(cur, lay.Conv_0, bn=bn, stats=cur_st, padding=1,
                        dtype=dtype)
        out = dropout2d(out, next(masks))
        updates[f"{prefix}.DenseLayer_{j}.BatchNorm_0"] = running_update(
            bn, torch.cat([s[0] for s in cur_st]),
            torch.cat([s[1] for s in cur_st]))
        cur.append(out)
        cur_st.append(batch_stats(out))
    n = len(segs)
    return cur, cur_st, cur[n:], cur_st[n:]


def fast_apply_train(model: FCDenseNet, x: torch.Tensor, masks=None, *,
                     use_softmax: bool = True,
                     reverse_features: bool = False):
    """Train-mode forward of an ``FCDenseNet`` without concats: returns
    ``(output, new_batch_stats)`` as ``model(x, train=True, masks=masks)``
    does (batch-statistics BN and the running updates; the same masks in
    the same sites).  ``reverse_features`` puts MME's ``grad_reverse`` on
    every segment that enters the head, which reverses the same
    cotangents as reversing their concat."""
    dtype = model.policy.compute_dtype
    fe = model.featureExtractor
    masks = iter(masks) if masks is not None else itertools.repeat(None)
    updates: dict = {}

    fc = fe.firstconv
    y = F.conv2d(x.to(dtype), fc.weight.to(dtype), fc.bias.to(dtype),
                 padding=1)
    segs, stats = [y], [batch_stats(y)]
    skips = []
    for i in range(len(model.down_blocks)):
        prefix = f"featureExtractor.denseDown{i}"
        segs, stats, _, _ = _dense_block_train(
            getattr(fe, f"denseDown{i}"), segs, stats, masks, updates,
            prefix, dtype)
        skips.append((segs, stats))
        td = getattr(fe, f"transDown{i}")
        t = _conv_sum(segs, td.Conv_0, bn=td.BatchNorm_0, stats=stats,
                      dtype=dtype)
        t = max_pool2(dropout2d(t, next(masks)))
        updates[f"featureExtractor.transDown{i}.BatchNorm_0"] = \
            running_update(td.BatchNorm_0, torch.cat([s[0] for s in stats]),
                           torch.cat([s[1] for s in stats]))
        segs, stats = [t], [batch_stats(t)]

    _, _, segs, stats = _dense_block_train(
        fe.bottleneck, segs, stats, masks, updates,
        "featureExtractor.bottleneck", dtype)
    for i in range(len(model.up_blocks)):
        skip, skip_st = skips.pop()
        up = _transition_up(segs, getattr(fe, f"transUp{i}"), skip[0], dtype)
        all_segs, all_st, new, new_st = _dense_block_train(
            getattr(fe, f"denseUp{i}"), [up] + skip,
            [batch_stats(up)] + skip_st, masks, updates,
            f"featureExtractor.denseUp{i}", dtype)
        last = i == len(model.up_blocks) - 1
        segs, stats = (all_segs, all_st) if last else (new, new_st)
    if reverse_features:
        segs = [grad_reverse(s) for s in segs]
    return _head(model, segs, dtype, use_softmax), updates
