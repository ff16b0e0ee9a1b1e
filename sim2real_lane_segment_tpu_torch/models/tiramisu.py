"""FC-DenseNet ("Tiramisu") segmentation CNN, eval forward, NCHW.

Counterpart of ``sim2real_lane_segment_tpu.models.tiramisu``.  Submodules
carry the Flax module names (``featureExtractor.denseDown0.DenseLayer_0.
BatchNorm_0`` ...) so that ``models.flax_import`` maps a Flax tree onto
the state dict by path.

Architecture semantics (reference layers.py:5-86):
- DenseLayer     = BN -> ReLU -> 3x3 conv(bias) [-> Dropout2d in training].
- DenseBlock     = concat growth; the ``upsample`` variant returns only the
  newly produced features.
- TransitionDown = BN -> ReLU -> 1x1 conv -> 2x2 maxpool (floor).
- TransitionUp   = 3x3 stride-2 VALID transposed conv -> floor center-crop
  to the skip's size -> concat with the skip.

Rounding follows the Flax modules: BatchNorm runs in float32, the conv
operands and output are in the policy's compute dtype, and the bias is
added in that dtype.

Train mode (``model(x, train=True, masks=...)``) follows
``model.apply(train=True, mutable=["batch_stats"])``: BatchNorm normalizes
with the batch statistics (mean and the biased ``max(E[x^2] - mu^2, 0)``
in f32 over N, H, W) and returns the running-statistics update ``0.9 * old
+ 0.1 * batch`` instead of writing it.  Dropout2d takes its masks as an
operand (``drop_masks``), one ``[B, C]`` tensor per dropout site in the
JAX site order (``dropout_sites``), already scaled by 1/(1-rate); the
2x2 max-pool is an ``amax`` over the window, whose gradient splits evenly
among tied maxima as the JAX train paths' does.  ``grad_reverse`` is
MME's gradient reversal: the identity forward, the negated gradient
backward.
"""
from __future__ import annotations

import itertools
from typing import Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..core.dtypes import DEFAULT_POLICY, DTypePolicy, at_least_f32
from ..parallel import dp

EPS = 1e-5


def batch_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``batch_stats`` before the clamp: (mu, E[x^2] - mu^2)."""
    xf = at_least_f32(x)
    mu, sq = xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))
    if dp.current() is not None:
        mu, sq = dp.all_mean(torch.stack([mu, sq])).unbind()
    return mu, sq - mu * mu


def batch_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel batch mean and biased variance over (N, H, W), f32:
    ``max(E[x^2] - mu^2, 0)``, Flax's train-mode formula.  In a
    data-parallel step (``parallel.dp``) the batch is the global one: the
    ranks' means of x and x^2 are averaged."""
    mu, d = batch_moments(x)
    return mu, torch.clamp(d, min=0.0)


def stats_cotangent(mu: torch.Tensor, pass2: torch.Tensor,
                    dmu: torch.Tensor, dvar: torch.Tensor,
                    count: int) -> torch.Tensor:
    """``batch_stats``' vector-Jacobian product as a per-channel affine map
    of its input: the cotangents ``dmu``, ``dvar`` of (mu, var) pull back
    onto x as ``c0 + c1 * x``.  Returns the rows (c0, c1), [2, C].

    ``pass2``: twice the variance clamp's pass mask (2 where ``E[x^2] -
    mu^2 >= 0``, ``torch.clamp``'s rule, else 0); ``count``: the values of
    a channel that this rank's means are over.  With ``v = dvar`` where
    the clamp passed: E[x^2] takes v and mu takes ``dmu - 2 mu v``, and
    each mean hands its cotangent to every value over ``count``.  In a
    data-parallel step the ranks' cotangents are summed first, as
    ``all_mean``'s backward sums them (one collective)."""
    coef = mu.new_empty((2, mu.shape[0]))
    torch.mul(dvar, pass2, out=coef[1])                       # 2 v
    torch.addcmul(dmu, coef[1], mu, value=-1.0, out=coef[0])  # dmu - 2 mu v
    world = dp.current()
    if world is not None:
        coef = dp.all_sum(coef)
        count *= world.size
    return coef.div_(count)


def running_update(bn: nn.BatchNorm2d, mu: torch.Tensor,
                   var: torch.Tensor) -> dict:
    """The Flax momentum-0.9 update of the running statistics, with the
    biased batch variance (``nn.BatchNorm2d`` would use the unbiased)."""
    return {"mean": 0.9 * bn.running_mean + 0.1 * mu.detach(),
            "var": 0.9 * bn.running_var + 0.1 * var.detach()}


def bn_train(bn: nn.BatchNorm2d, x: torch.Tensor, updates: dict,
             name: str) -> torch.Tensor:
    """Batch-stat BatchNorm in float32 (Flax's ``(x - mu) * (rsqrt(var +
    eps) * scale) + bias``); records the running update under ``name``."""
    mu, var = batch_stats(x)
    updates[name] = running_update(bn, mu, var)
    mul = torch.rsqrt(var + EPS) * bn.weight
    y = (at_least_f32(x) - mu[:, None, None]) * mul[:, None, None]
    return y + bn.bias[:, None, None]


def bn_relu_train(bn: nn.BatchNorm2d, x: torch.Tensor, updates: dict,
                  name: str) -> torch.Tensor:
    """``bn_train``, then ReLU."""
    return torch.relu(bn_train(bn, x, updates, name))


def dropout2d(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Channelwise dropout with a given [B, C] mask (0 or 1/(1-rate))."""
    if mask is None:
        return x
    return x * mask.to(x.dtype)[:, :, None, None]


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, floor division.  ``amax`` over the window axes: the
    values of ``F.max_pool2d``, with the gradient split evenly among
    tied maxima (as the JAX train paths' reshape + max)."""
    b, c, h, w = x.shape
    ho, wo = h // 2, w // 2
    y = x[:, :, :ho * 2, :wo * 2].reshape(b, c, ho, 2, wo, 2)
    return y.amax(dim=(3, 5))


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def grad_reverse(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; negated gradient backward (GradReverse)."""
    return _GradReverse.apply(x)


def bn_relu(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Running-stat BatchNorm in float32, then ReLU."""
    y = F.batch_norm(x.to(torch.float32), bn.running_mean, bn.running_var,
                     bn.weight, bn.bias, False, 0.0, bn.eps)
    return torch.relu(y)


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.BatchNorm_0 = nn.BatchNorm2d(in_channels, eps=EPS)
        self.Conv_0 = nn.Conv2d(in_channels, growth_rate, 3, padding=1)

    def forward(self, x: torch.Tensor, train: dict | None = None,
                name: str = "", mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        """``train``: the running-update dict of a train-mode forward."""
        cd = self.policy.compute_dtype
        a = (bn_relu(self.BatchNorm_0, x) if train is None else
             bn_relu_train(self.BatchNorm_0, x, train,
                           f"{name}.BatchNorm_0")).to(cd)
        y = F.conv2d(a, self.Conv_0.weight.to(cd), self.Conv_0.bias.to(cd),
                     padding=1)
        return y if train is None else dropout2d(y, mask)


class DenseBlock(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, n_layers: int,
                 upsample: bool = False,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.upsample = upsample
        self.n_layers = n_layers
        for j in range(n_layers):
            self.add_module(f"DenseLayer_{j}", DenseLayer(
                in_channels + j * growth_rate, growth_rate, policy))

    def layers(self) -> list[DenseLayer]:
        return [getattr(self, f"DenseLayer_{j}") for j in range(self.n_layers)]

    def forward(self, x: torch.Tensor, train: dict | None = None,
                name: str = "", masks=None) -> torch.Tensor:
        """``masks``: an iterator over the layers' dropout masks."""
        new_features = []
        for j, layer in enumerate(self.layers()):
            out = (layer(x) if train is None else
                   layer(x, train, f"{name}.DenseLayer_{j}", next(masks)))
            x = torch.cat([x, out.to(x.dtype)], dim=1)
            new_features.append(out)
        if self.upsample:
            return torch.cat(new_features, dim=1)
        return x


class TransitionDown(nn.Module):
    def __init__(self, channels: int, policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.BatchNorm_0 = nn.BatchNorm2d(channels, eps=EPS)
        self.Conv_0 = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, train: dict | None = None,
                name: str = "", mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        cd = self.policy.compute_dtype
        if train is None:
            a = bn_relu(self.BatchNorm_0, x).to(cd)
        else:
            a = bn_relu_train(self.BatchNorm_0, x, train,
                              f"{name}.BatchNorm_0").to(cd)
        y = F.conv2d(a, self.Conv_0.weight.to(cd), self.Conv_0.bias.to(cd))
        if train is None:
            return F.max_pool2d(y, 2)  # floor division, as Flax's VALID pool
        return max_pool2(dropout2d(y, mask))


def center_crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Crop (N, C, H, W) to (N, C, h, w) around the center (floor offsets)."""
    y0 = (x.shape[2] - h) // 2
    x0 = (x.shape[3] - w) // 2
    return x[:, :, y0:y0 + h, x0:x0 + w]


def transition_up(x: torch.Tensor, conv: nn.ConvTranspose2d, h: int, w: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """stride-2 VALID 3x3 transposed conv in ``dtype`` (+bias in ``dtype``)
    -> center-crop to (h, w)."""
    y = F.conv_transpose2d(x.to(dtype), conv.weight.to(dtype), stride=2)
    y = y + conv.bias.to(dtype)[:, None, None]
    return center_crop(y, h, w)


class TransitionUp(nn.Module):
    def __init__(self, features: int, policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.ConvTranspose_0 = nn.ConvTranspose2d(features, features, 3,
                                                  stride=2)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y = transition_up(x, self.ConvTranspose_0, skip.shape[2],
                          skip.shape[3], self.policy.compute_dtype)
        return torch.cat([y, skip.to(y.dtype)], dim=1)


def _remat_block(block: DenseBlock, x: torch.Tensor, updates: dict,
                 name: str, masks: list) -> torch.Tensor:
    """``block`` in train mode under ``torch.utils.checkpoint`` (the
    counterpart of Flax's ``nn.remat``): the backward recomputes the block
    from its input instead of keeping its activations.  The recompute
    takes the same dropout masks (operands, never drawn again) and runs in
    the data-parallel world of the forward (autograd may run it on another
    thread); its running-statistics updates are dropped, the forward's
    kept.  Nothing in it draws random numbers, so no generator state is
    saved, which also lets a CUDA graph capture it."""
    world = dp.current()

    def run(x, *masks):
        upd: dict = {}
        with dp.active(world):
            out = block(x, upd, name, iter(masks))
        return out, upd

    out, upd = torch.utils.checkpoint.checkpoint(
        run, x, *masks, use_reentrant=False, preserve_rng_state=False)
    updates.update(upd)
    return out


class FCDenseNetFeatureExtractor(nn.Module):
    def __init__(self, down_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 up_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 bottleneck_layers: int = 5, growth_rate: int = 16,
                 out_chans_first_conv: int = 48,
                 policy: DTypePolicy = DEFAULT_POLICY, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.down_blocks = tuple(down_blocks)
        self.up_blocks = tuple(up_blocks)
        self.bottleneck_layers = bottleneck_layers
        self.growth_rate = growth_rate
        self.policy = policy
        g = growth_rate
        self.firstconv = nn.Conv2d(3, out_chans_first_conv, 3, padding=1)
        # channel bookkeeping mirrors reference tiramisu.py:27-87
        cur = out_chans_first_conv
        skips = []
        for i, n in enumerate(self.down_blocks):
            self.add_module(f"denseDown{i}",
                            DenseBlock(cur, g, n, False, policy))
            cur += g * n
            skips.insert(0, cur)
            self.add_module(f"transDown{i}", TransitionDown(cur, policy))
        self.bottleneck = DenseBlock(cur, g, bottleneck_layers, True, policy)
        prev = g * bottleneck_layers
        for i, n in enumerate(self.up_blocks):
            self.add_module(f"transUp{i}", TransitionUp(prev, policy))
            last = i == len(self.up_blocks) - 1
            self.add_module(f"denseUp{i}", DenseBlock(
                prev + skips[i], g, n, not last, policy))
            # the last up block returns its whole concat, the others only
            # their new features
            prev = prev + skips[i] + g * n if last else g * n
        self.feature_channels = prev

    def forward(self, x: torch.Tensor, train: dict | None = None,
                masks=None) -> torch.Tensor:
        """x: (N, 3, H, W) float32 -> L2-normalized features, float32.

        ``train``: a dict that collects the running-statistics updates of
        a train-mode forward (None: eval mode); ``masks``: an iterator
        over the dropout masks in site order.  With ``remat`` a train-mode
        forward that records gradients checkpoints every dense block
        (``_remat_block``)."""
        cd = self.policy.compute_dtype
        fc = self.firstconv
        out = F.conv2d(x.to(cd), fc.weight.to(cd), fc.bias.to(cd), padding=1)

        def run(name, *args):
            mod = getattr(self, name)
            if train is None:
                return mod(*args)
            key = f"featureExtractor.{name}"
            if not isinstance(mod, DenseBlock):
                return mod(*args, train, key, next(masks))
            if self.remat and torch.is_grad_enabled():
                return _remat_block(mod, *args, train, key,
                                    [next(masks) for _ in range(mod.n_layers)])
            return mod(*args, train, key, masks)

        skips = []
        for i in range(len(self.down_blocks)):
            out = run(f"denseDown{i}", out)
            skips.append(out)
            out = run(f"transDown{i}", out)
        out = run("bottleneck", out)
        for i in range(len(self.up_blocks)):
            out = getattr(self, f"transUp{i}")(out, skips.pop())
            out = run(f"denseUp{i}", out)
        # per-pixel L2 normalization (reference tiramisu.py:105,
        # F.normalize: x / max(||x||_2, 1e-12))
        out = at_least_f32(out)
        norm = torch.sqrt(torch.sum(out * out, dim=1, keepdim=True))
        return out / torch.clamp(norm, min=1e-12)


class FCDenseNetClassifier(nn.Module):
    def __init__(self, in_channels: int, n_classes: int,
                 temperature: float = 0.05, kernel_size: int = 1,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.temperature = temperature
        self.kernel_size = kernel_size
        self.policy = policy
        self.finalConv = nn.Conv2d(in_channels, n_classes, kernel_size,
                                   padding=kernel_size // 2)

    def forward(self, x: torch.Tensor, *,
                use_softmax: bool = True) -> torch.Tensor:
        cd = self.policy.compute_dtype
        c = self.finalConv
        x = F.conv2d(x.to(cd), c.weight.to(cd), c.bias.to(cd),
                     padding=self.kernel_size // 2)
        x = at_least_f32(x) / self.temperature
        if use_softmax:
            x = torch.softmax(x, dim=1)
        return x


class FCDenseNet(nn.Module):
    """Feature extractor + classifier, reference tiramisu.py:128-147.

    ``forward`` takes (N, 3, H, W) float32 and returns (N, n_classes, H, W)
    float32 probabilities (or logits with ``use_softmax=False``).  With
    ``train=True`` it returns ``(output, new_batch_stats)``: the
    running-statistics update of every BatchNorm, keyed by its state-dict
    prefix (``featureExtractor.denseDown0.DenseLayer_0.BatchNorm_0``), as
    ``{"mean": ..., "var": ...}``.  ``masks`` are the dropout masks of
    ``dropout_sites`` (None: no dropout).  ``remat`` (arch ``67r``)
    recomputes each dense block in the backward of a train-mode forward;
    the fused train path (``tiramisu_train_fused``) runs its own
    backward through the kernels and does not read it.
    """

    def __init__(self, n_classes: int = 12,
                 down_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 up_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 bottleneck_layers: int = 5, growth_rate: int = 16,
                 out_chans_first_conv: int = 48, kernel_size: int = 1,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 dropout_rate: float = 0.2, remat: bool = False):
        super().__init__()
        self.n_classes = n_classes
        self.dropout_rate = dropout_rate
        self.down_blocks = tuple(down_blocks)
        self.up_blocks = tuple(up_blocks)
        self.bottleneck_layers = bottleneck_layers
        self.growth_rate = growth_rate
        self.kernel_size = kernel_size
        self.policy = policy
        self.featureExtractor = FCDenseNetFeatureExtractor(
            down_blocks, up_blocks, bottleneck_layers, growth_rate,
            out_chans_first_conv, policy, remat)
        self.classifier = FCDenseNetClassifier(
            self.featureExtractor.feature_channels, n_classes,
            kernel_size=kernel_size, policy=policy)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                use_softmax: bool = True, masks=None):
        if not train:
            return self.classifier(self.featureExtractor(x),
                                   use_softmax=use_softmax)
        updates: dict = {}
        it = iter(masks) if masks is not None else itertools.repeat(None)
        x = self.featureExtractor(x, updates, it)
        return self.classifier(x, use_softmax=use_softmax), updates


def dropout_sites(model: nn.Module, size=None) -> list[int]:
    """The mask elements per sample of each dropout site, in the JAX site
    order.  FC-DenseNet: the channels of each Dropout2d site (per down
    block its layers then its TransitionDown, the bottleneck's layers, the
    up blocks' layers).  A model with elementwise dropout (EncDecNet)
    states its own for an input of ``size`` (h, w) (``dropout_elements``);
    LaneNetLite has none."""
    if hasattr(model, "dropout_elements"):
        return model.dropout_elements(size)
    if not isinstance(model, FCDenseNet):
        return []
    g = model.growth_rate
    cur = model.featureExtractor.firstconv.out_channels
    sites = []
    for n in model.down_blocks:
        sites += [g] * n
        cur += g * n
        sites.append(cur)
    sites += [g] * model.bottleneck_layers
    for n in model.up_blocks:
        sites += [g] * n
    return sites


def draw_drop_masks(generator: torch.Generator, model: nn.Module,
                    batch: int, pin: bool = False, size=None) -> torch.Tensor:
    """Every Dropout2d mask of one step, flat, site after site (one f32
    [batch, C] block per site: keep with probability 1 - rate, kept
    channels scaled by 1/(1 - rate)), drawn on the generator's device.
    ``pin``: in pinned memory, for one asynchronous copy to a card;
    ``size``: the input's (h, w), for elementwise sites."""
    sites = dropout_sites(model, size)
    rate = model.dropout_rate if sites else 0.0
    u = torch.empty(batch * sum(sites), device=generator.device)
    if rate == 0.0:
        u.fill_(1.0)
    else:
        off = 0
        for c in sites:  # the per-site draws, in site order
            torch.rand(batch, c, generator=generator,
                       out=u[off:off + batch * c].view(batch, c))
            off += batch * c
        u = (u >= rate).to(torch.float32) / (1.0 - rate)
    return u.pin_memory() if pin and not u.is_pinned() else u


def split_masks(flat: torch.Tensor, model: nn.Module, batch: int,
                size=None) -> list[torch.Tensor]:
    """``draw_drop_masks``'s flat buffer as one [batch, C] view per site."""
    out, off = [], 0
    for c in dropout_sites(model, size):
        out.append(flat[off:off + batch * c].view(batch, c))
        off += batch * c
    return out


def drop_masks(generator: torch.Generator, model: nn.Module, batch: int,
               device=None) -> list[torch.Tensor]:
    """One f32 [batch, C] Dropout2d mask per site (``draw_drop_masks``),
    moved to ``device`` in one copy (from pinned memory to a card)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    flat = draw_drop_masks(generator, model, batch,
                           pin=device.type == "cuda")
    return split_masks(flat.to(device, non_blocking=True), model, batch)


@torch.no_grad()
def apply_batch_stats(model: nn.Module, updates: dict) -> None:
    """Write a train-mode forward's running-statistics updates into the
    model's BatchNorm buffers."""
    for name, st in updates.items():
        bn = model.get_submodule(name)
        bn.running_mean.copy_(st["mean"])
        bn.running_var.copy_(st["var"])


# ---------------------------------------------------------------------------
# factories (reference tiramisu.py:150-194)
# ---------------------------------------------------------------------------

def fcdensenet57(n_classes, kernel_size=1, policy=DEFAULT_POLICY):
    return FCDenseNet(n_classes=n_classes, down_blocks=(4,) * 5,
                      up_blocks=(4,) * 5, bottleneck_layers=4,
                      growth_rate=12, out_chans_first_conv=48,
                      kernel_size=kernel_size, policy=policy)


def fcdensenet67(n_classes, policy=DEFAULT_POLICY, remat=False):
    return FCDenseNet(n_classes=n_classes, down_blocks=(5,) * 5,
                      up_blocks=(5,) * 5, bottleneck_layers=5,
                      growth_rate=16, out_chans_first_conv=48, policy=policy,
                      remat=remat)


def fcdensenet103(n_classes, policy=DEFAULT_POLICY):
    return FCDenseNet(n_classes=n_classes, down_blocks=(4, 5, 7, 10, 12),
                      up_blocks=(12, 10, 7, 5, 4), bottleneck_layers=15,
                      growth_rate=16, out_chans_first_conv=48, policy=policy)
