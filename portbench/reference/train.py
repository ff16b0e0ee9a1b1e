"""Reference training steps and serving forward, plain PyTorch.

A supervised step of the lane-segmentation reference: augmentation, the
train-mode forward with the given Dropout2d masks, softmax, the
class-weighted cross entropy applied to the softmax output (the
reference's double softmax), gradients, AdamW in optax's order
(bias-corrected moments, ``u = m_hat / (sqrt(v_hat) + eps) + wd * p``,
``p -= lr * u``) and the running statistics.

What a step reports for the comparison: its loss, per leaf the norm of
the first step's gradient, and after the last step per leaf the norm of
the parameters' and the running statistics' change.
"""
from __future__ import annotations

import contextlib

import torch

from . import augment as aug
from .fcdensenet import Convs, FCDenseNet, split_masks

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def build(cfg: dict, weights: dict, device) -> FCDenseNet:
    """The reference network holding ``weights`` (copied, float32)."""
    model = FCDenseNet(cfg)
    model.load_state_dict({k: v.detach().to("cpu") for k, v in
                           weights.items()})
    return model.to(device)


def weighted_ce(probs, y, n_cls: int):
    """Inverse-frequency weighted cross entropy of ``log_softmax(probs)``."""
    counts = torch.stack([(y == c).sum() for c in range(n_cls)]).float()
    cw = torch.where(counts > 0, 1.0 / torch.clamp(counts, min=1.0),
                     torch.zeros_like(counts))
    logp = torch.log_softmax(probs, 1)
    nll = -logp.gather(1, y[:, None])[:, 0]
    w = cw[y]
    return (w * nll).sum() / torch.clamp(w.sum(), min=1e-12)


def train_steps(cfg: dict, weights: dict, images, labels, rows, draws,
                masks, lr: float, decay: float, convs: Convs = Convs()
                ) -> dict:
    """``len(rows)`` steps from ``weights``: step k on the rows
    ``rows[k]`` of the uint8 split (images, labels), with its draws and
    flat masks.  Returns ``loss`` (list), ``grad1``, ``stats1`` (after
    the first step), ``delta`` and ``stats`` ({leaf: norm})."""
    device = images.device
    with exact_float32():
        model = build(cfg, weights, device)
        params = dict(model.named_parameters())
        start = {k: v.detach().clone() for k, v in
                 model.state_dict().items()}
        mu = {k: torch.zeros_like(p) for k, p in params.items()}
        nu = {k: torch.zeros_like(p) for k, p in params.items()}
        out = {"loss": []}
        for t, idx in enumerate(rows, start=1):
            x, y = aug.augment(images[idx], labels[idx].to(torch.int64),
                               draws[t - 1], cfg["height"], cfg["width"])
            stats: dict = {}
            m = split_masks(masks[t - 1], cfg, len(idx))
            probs = torch.softmax(model.logits(x, convs, stats, iter(m)), 1)
            loss = weighted_ce(probs, y, cfg["n_classes"])
            grads = torch.autograd.grad(loss, list(params.values()))
            out["loss"].append(float(loss.detach()))
            c1 = torch.tensor(1.0 - B1 ** t, dtype=torch.float32)
            c2 = torch.tensor(1.0 - B2 ** t, dtype=torch.float32)
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    mu[k].mul_(B1).add_(g, alpha=1.0 - B1)
                    nu[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                    u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
                    p.sub_(lr * (u + decay * p))
                for name, (rm, rv) in stats.items():
                    bn = model.get_submodule(name)
                    bn.running_mean.copy_(rm)
                    bn.running_var.copy_(rv)
            if t == 1:
                out["grad1"] = {k: float(g.norm()) for k, g in
                                zip(params, grads)}
                out["stats1"] = stats_change(model.state_dict(), start)
            del grads, loss, probs, x, stats
        now = model.state_dict()
        out["delta"] = {k: float((params[k].detach() - start[k]).norm())
                        for k in params}
        out["stats"] = stats_change(now, start)
    return out


def stats_change(now: dict, start: dict) -> dict:
    """Per running-statistics buffer, the norm of its change."""
    return {k: float((now[k] - start[k]).norm()) for k in now
            if k.endswith(("running_mean", "running_var"))}


@torch.no_grad()
def serve_logits(cfg: dict, weights: dict, frames_u8, convs: Convs = Convs(),
                 block: int = 64) -> torch.Tensor:
    """Eval-mode logits (N, n_classes, H, W) of uint8 frames, ``block``
    frames at a time."""
    with exact_float32():
        model = build(cfg, weights, frames_u8.device)
        return torch.cat([model.logits(aug.eval_input(frames_u8[i:i + block]),
                                       convs)
                          for i in range(0, len(frames_u8), block)])
