"""FC-DenseNet (Jegou et al. 2017, arXiv:1611.09326) in plain PyTorch.

The benchmark's own reference: it imports nothing of the program under
test. It computes in float32 (or float64), with TF32 off, and follows
the published architecture together with the lane-segmentation
reference's choices:

- DenseLayer: BN -> ReLU -> 3x3 conv (bias) [-> Dropout2d in training].
- DenseBlock: each layer's output concatenated to its input; a block of
  the up path other than the last returns only its new features.
- TransitionDown: BN -> ReLU -> 1x1 conv [-> Dropout2d] -> 2x2 max-pool
  (floor); in training the pool's gradient splits evenly among tied
  maxima.
- TransitionUp: 3x3 stride-2 VALID transposed conv (bias), centre-cropped
  (floor offsets) to the skip's size, concatenated before the skip.
- Head: per-pixel L2 normalisation of the features, a 1x1 conv (bias),
  divided by the temperature 0.05 (a cosine classifier).
- BatchNorm in training: batch mean and the biased variance
  max(E[x^2] - mu^2, 0) over (N, H, W), eps 1e-5, and the running
  statistics 0.9 * old + 0.1 * batch (Flax's momentum, biased variance).

Submodules carry the state-dict names the program's checkpoints use
(``featureExtractor.denseDown0.DenseLayer_0.BatchNorm_0.weight`` ...), so
one state dict made by the benchmark loads into both sides.

``conv``: every convolution goes through ``Convs`` so that the control
can run the same network with its operands rounded to a lower precision.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-5


class Convs:
    """The network's convolutions in the operands' own precision."""

    def conv2d(self, x, w, b, padding=0):
        return F.conv2d(x, w, b, padding=padding)

    def conv_transpose2d(self, x, w, b):
        return F.conv_transpose2d(x, w, b, stride=2)


def bn_train(bn: nn.BatchNorm2d, x, stats: dict, name: str):
    mu = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mu * mu, min=0.0)
    stats[name] = (0.9 * bn.running_mean + 0.1 * mu.detach(),
                   0.9 * bn.running_var + 0.1 * var.detach())
    scale = torch.rsqrt(var + EPS) * bn.weight
    return (x - mu[:, None, None]) * scale[:, None, None] \
        + bn.bias[:, None, None]


def bn_eval(bn: nn.BatchNorm2d, x):
    scale = torch.rsqrt(bn.running_var + EPS) * bn.weight
    return (x - bn.running_mean[:, None, None]) * scale[:, None, None] \
        + bn.bias[:, None, None]


class _Unit(nn.Module):
    """BN -> ReLU -> conv, the body of a DenseLayer and a TransitionDown."""

    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__()
        self.BatchNorm_0 = nn.BatchNorm2d(c_in, eps=EPS)
        self.Conv_0 = nn.Conv2d(c_in, c_out, k, padding=k // 2)

    def run(self, x, convs: Convs, stats: dict | None, name: str, mask):
        a = torch.relu(bn_eval(self.BatchNorm_0, x) if stats is None
                       else bn_train(self.BatchNorm_0, x, stats,
                                     f"{name}.BatchNorm_0"))
        k = self.Conv_0.kernel_size[0]
        y = convs.conv2d(a, self.Conv_0.weight, self.Conv_0.bias, k // 2)
        if mask is not None:
            y = y * mask[:, :, None, None]
        return y


class DenseBlock(nn.Module):
    def __init__(self, c_in: int, growth: int, n: int, upsample: bool):
        super().__init__()
        self.n, self.upsample = n, upsample
        for j in range(n):
            self.add_module(f"DenseLayer_{j}",
                            _Unit(c_in + j * growth, growth, 3))

    def run(self, x, convs, stats, name, masks):
        new = []
        for j in range(self.n):
            out = getattr(self, f"DenseLayer_{j}").run(
                x, convs, stats, f"{name}.DenseLayer_{j}",
                None if masks is None else next(masks))
            x = torch.cat([x, out], 1)
            new.append(out)
        return torch.cat(new, 1) if self.upsample else x


class TransitionUp(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(c, c, 3, stride=2)


def max_pool2(x):
    """2x2 floor max-pool as an ``amax`` (ties share the gradient)."""
    b, c, h, w = x.shape
    ho, wo = h // 2, w // 2
    return x[:, :, :ho * 2, :wo * 2].reshape(b, c, ho, 2, wo, 2).amax((3, 5))


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        g = cfg["growth_rate"]
        self.down, self.up = cfg["down_blocks"], cfg["up_blocks"]
        self.firstconv = nn.Conv2d(3, cfg["out_chans_first_conv"], 3,
                                   padding=1)
        cur, skips = cfg["out_chans_first_conv"], []
        for i, n in enumerate(self.down):
            self.add_module(f"denseDown{i}", DenseBlock(cur, g, n, False))
            cur += g * n
            skips.insert(0, cur)
            self.add_module(f"transDown{i}", _Unit(cur, cur, 1))
        self.bottleneck = DenseBlock(cur, g, cfg["bottleneck_layers"], True)
        prev = g * cfg["bottleneck_layers"]
        for i, n in enumerate(self.up):
            last = i == len(self.up) - 1
            self.add_module(f"transUp{i}", TransitionUp(prev))
            self.add_module(f"denseUp{i}",
                            DenseBlock(prev + skips[i], g, n, not last))
            prev = prev + skips[i] + g * n if last else g * n
        self.channels = prev


class FCDenseNet(nn.Module):
    """``cfg``: the configuration file's dict."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.temperature = cfg["temperature"]
        self.featureExtractor = FeatureExtractor(cfg)
        self.classifier = nn.Module()
        self.classifier.finalConv = nn.Conv2d(
            self.featureExtractor.channels, cfg["n_classes"], 1)

    def logits(self, x, convs: Convs = Convs(), stats: dict | None = None,
               masks=None):
        """x: normalised (N, 3, H, W) -> logits.  ``stats``: a dict that
        collects the running-statistics updates (None: eval mode);
        ``masks``: an iterator over the Dropout2d masks in site order."""
        fe = self.featureExtractor
        out = convs.conv2d(x, fe.firstconv.weight, fe.firstconv.bias, 1)
        skips = []
        for i in range(len(fe.down)):
            name = f"featureExtractor.denseDown{i}"
            out = getattr(fe, f"denseDown{i}").run(out, convs, stats, name,
                                                   masks)
            skips.append(out)
            td = getattr(fe, f"transDown{i}")
            out = max_pool2(td.run(
                out, convs, stats, f"featureExtractor.transDown{i}",
                None if masks is None else next(masks)))
        out = fe.bottleneck.run(out, convs, stats,
                                "featureExtractor.bottleneck", masks)
        for i in range(len(fe.up)):
            skip = skips.pop()
            tu = getattr(fe, f"transUp{i}").ConvTranspose_0
            y = convs.conv_transpose2d(out, tu.weight, tu.bias)
            y0 = (y.shape[2] - skip.shape[2]) // 2
            x0 = (y.shape[3] - skip.shape[3]) // 2
            y = y[:, :, y0:y0 + skip.shape[2], x0:x0 + skip.shape[3]]
            out = getattr(fe, f"denseUp{i}").run(
                torch.cat([y, skip], 1), convs, stats,
                f"featureExtractor.denseUp{i}", masks)
        norm = torch.sqrt((out * out).sum(1, keepdim=True))
        out = out / torch.clamp(norm, min=1e-12)
        c = self.classifier.finalConv
        return convs.conv2d(out, c.weight, c.bias, 0) / self.temperature


def dropout_sites(cfg: dict) -> list[int]:
    """Channels of each Dropout2d site, in the order the masks are taken:
    per down block its layers then its TransitionDown, the bottleneck's
    layers, the up blocks' layers."""
    g, cur, sites = cfg["growth_rate"], cfg["out_chans_first_conv"], []
    for n in cfg["down_blocks"]:
        sites += [g] * n
        cur += g * n
        sites.append(cur)
    sites += [g] * cfg["bottleneck_layers"]
    for n in cfg["up_blocks"]:
        sites += [g] * n
    return sites


def split_masks(flat, cfg: dict, batch: int) -> list:
    out, off = [], 0
    for c in dropout_sites(cfg):
        out.append(flat[off:off + batch * c].view(batch, c))
        off += batch * c
    return out
