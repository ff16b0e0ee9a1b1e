"""The control: the reference network computed in float8 (e4m3) where
the program computes in bfloat16, the precision that the configurations
state; float8 is the step below it.

Each tensor is scaled per tensor so that its largest magnitude lands on
e4m3's largest finite value (448), rounded, and scaled back: the
per-tensor scaling that float8 training and serving use. Float8 takes
bfloat16's place wherever the program computes in bfloat16: a
convolution's operands and its output (the activations the program
stores), and in training the gradient that reaches a convolution's
output and the one it hands back to its input. Weight gradients,
BatchNorm and the rest stay float32, as they do in the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .fcdensenet import Convs

E4M3_MAX = 448.0


def round_e4m3(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().clamp(min=1e-30)
    s = E4M3_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).to(t.dtype) / s


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, x, w, b):
        xq, wq = round_e4m3(x), round_e4m3(w)
        ctx.op = op
        ctx.save_for_backward(xq, wq, b)
        return round_e4m3(op(xq, wq, b))

    @staticmethod
    def backward(ctx, dy):
        xq, wq, b = ctx.saved_tensors
        with torch.enable_grad():
            xs, ws, bs = (t.detach().requires_grad_() for t in (xq, wq, b))
            y = ctx.op(xs, ws, bs)
            dx, dw, db = torch.autograd.grad(y, (xs, ws, bs),
                                             round_e4m3(dy))
        return None, round_e4m3(dx), dw, db


class Float8Convs(Convs):
    def conv2d(self, x, w, b, padding=0):
        return _Rounded.apply(lambda a, k, c: F.conv2d(a, k, c,
                                                       padding=padding),
                              x, w, b)

    def conv_transpose2d(self, x, w, b):
        return _Rounded.apply(lambda a, k, c: F.conv_transpose2d(a, k, c,
                                                                 stride=2),
                              x, w, b)
