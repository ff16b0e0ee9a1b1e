"""The port's ``AdamW`` (one multi-tensor call an operation) against the
per-tensor loop it replaced, kept here as the reference: bit for bit on
the CPU over the parameters of FCDenseNet57, 67 and 103; the operation
count a step issues, the same small number for every model; the state's
reset and round trip; and the benchmark's ``train.optim_ops`` reader.
Imports neither JAX nor the JAX package, so the card's tests reuse the
reference."""
import importlib
import itertools
from collections import deque

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import harness
from sim2real_lane_segment_tpu_torch.models.tiramisu import (fcdensenet57,
                                                             fcdensenet67,
                                                             fcdensenet103)
from sim2real_lane_segment_tpu_torch.train import optim
from sim2real_lane_segment_tpu_torch.train.optim import AdamW

MODELS = {"57": fcdensenet57, "67": fcdensenet67, "103": fcdensenet103}
# two rates, as a schedule gives them
LRS = (1e-3, 2.5e-4, 1e-3)


def per_tensor_step(params, grads, mu, nu, count: int, lr: float,
                    wd: float, b1=0.9, b2=0.999, eps=1e-8) -> None:
    """The update ``AdamW.step`` made before its multi-tensor calls, one
    tensor at a time, at step ``count`` (from 1)."""
    device = params[0].device
    count = torch.tensor(float(count), dtype=torch.float64, device=device)
    lr = torch.tensor(lr, dtype=torch.float32, device=device)
    wd = torch.tensor(wd, dtype=torch.float32, device=device)
    c1 = (1.0 - torch.pow(b1, count)).to(torch.float32)
    c2 = (1.0 - torch.pow(b2, count)).to(torch.float32)
    for p, g, m, v in zip(params, grads, mu, nu, strict=True):
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        u = u + wd * p
        p.sub_(lr * u)


def shapes(arch: str) -> list[torch.Size]:
    return [p.shape for p in MODELS[arch](4).parameters()]


def random_params(shapes, seed: int, device="cpu", dtypes=None):
    gen = torch.Generator().manual_seed(seed)
    dtypes = dtypes or [torch.float32] * len(shapes)
    return [torch.randn(s, generator=gen).to(device, dt)
            for s, dt in zip(shapes, dtypes, strict=True)]


def run_both(shapes, steps, wd, dtypes=None, **betas):
    """``steps`` updates of ``AdamW`` and of the per-tensor loop from the
    same start on the same gradients: (optimizer, its parameters, the
    loop's parameters, mu, nu)."""
    params = random_params(shapes, 0, dtypes=dtypes)
    ref = [p.clone() for p in params]
    mu = [torch.zeros_like(p) for p in ref]
    nu = [torch.zeros_like(p) for p in ref]
    opt = AdamW(params, wd, **betas)
    for k, lr in enumerate(steps):
        grads = random_params(shapes, k + 1, dtypes=dtypes)
        opt.step(grads, lr)
        with torch.no_grad():
            per_tensor_step(ref, grads, mu, nu, k + 1, lr, wd, **betas)
    return opt, params, ref, mu, nu


def assert_bit_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_adamw_equals_the_per_tensor_loop(arch):
    """Three steps at two rates with decay over a model's parameters:
    parameters and both moments bit-equal to the per-tensor loop."""
    opt, params, ref, mu, nu = run_both(shapes(arch), LRS, 1e-4)
    assert opt.count == 3
    assert_bit_equal(params, ref)
    assert_bit_equal(opt.mu, mu)
    assert_bit_equal(opt.nu, nu)


def test_adamw_equals_the_loop_at_cyclegans_betas():
    """CycleGAN's optimizers: b1 = 0.5 and no decay."""
    opt, params, ref, mu, nu = run_both(shapes("57")[:40], LRS, 0.0, b1=0.5,
                                        b2=0.999)
    assert_bit_equal(params, ref)
    assert_bit_equal(opt.mu + opt.nu, mu + nu)


def test_mixed_dtypes_take_one_group_each():
    """Parameters of two dtypes: one multi-tensor call an operation a
    group, each group as the loop updates it."""
    dims = [(3, 4), (5,), (2, 2, 3), (7,)]
    dtypes = [torch.float32, torch.float64, torch.float32, torch.float64]
    optim.reset_counts()
    opt, params, ref, mu, nu = run_both(dims, LRS[:1], 1e-2, dtypes=dtypes)
    assert opt._groups == [[0, 2], [1, 3]]
    assert optim.counts["optim_ops"] == 4 + 13 * 2
    assert_bit_equal(params, ref)
    assert_bit_equal(opt.mu + opt.nu, mu + nu)


class _Ops(TorchDispatchMode):
    """The operators called at the top of the dispatcher, views left out
    (a multi-tensor call is one)."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_a_step_counts_its_operations(arch):
    """``optim_ops`` after one step at the rate set (as the captured
    train step calls it): every operation the step called, the same
    number for every model (57, 67, 103: 210, 254, 398 tensors), at most
    20; the per-tensor loop issued 13 a tensor."""
    params = random_params(shapes(arch), 0)
    opt = AdamW(params, 1e-4)
    opt.set_lr(1e-3)
    grads = random_params(shapes(arch), 1)
    optim.reset_counts()
    with _Ops() as ops:
        opt.step(grads)
    assert optim.counts["optim_ops"] == len(ops.names) == 17
    assert sum(n.startswith("aten._foreach_") for n in ops.names) == 13


def test_reset_and_state_dict_round_trip():
    dims = shapes("57")[:12]
    opt = AdamW(random_params(dims, 0), 1e-4)
    for k, lr in enumerate(LRS):
        opt.step(random_params(dims, k + 1), lr)
    state = opt.state_dict()
    assert state["count"] == 3
    assert all(t.device.type == "cpu" for t in state["mu"] + state["nu"])
    other = AdamW([p.clone() for p in opt.params], 1e-4)
    other.load_state_dict(state)
    assert other.count == 3
    assert_bit_equal(other.tensors(), opt.tensors())
    # both go on alike
    grads = random_params(dims, 9)
    opt.step(grads, 5e-4)
    other.step(grads, 5e-4)
    assert_bit_equal(other.params, opt.params)
    assert_bit_equal(other.tensors(), opt.tensors())
    opt.reset()
    assert opt.count == 0
    assert all(not t.any() for t in opt.mu + opt.nu)
    # a reset optimizer steps as a fresh one
    fresh = AdamW([p.clone() for p in opt.params], 1e-4)
    opt.step(grads, 1e-3)
    fresh.step(grads, 1e-3)
    assert_bit_equal(opt.params, fresh.params)
    assert_bit_equal(opt.tensors(), fresh.tensors())


def test_the_optim_ops_metric_reads_the_capture_span(monkeypatch):
    """``train.optim_ops`` reads the attribute of the last
    ``train.capture`` span before the window, and nothing where the span
    lacks it (a program without the counter)."""
    tracing = importlib.import_module(f"{harness.PORT}.core.tracing")
    # a ring of its own: spans that earlier tests of this process closed
    # may have overflowed the shared one, and nothing is read from a
    # ring that dropped spans
    monkeypatch.setattr(tracing, "_ring", deque(maxlen=tracing.RING))
    monkeypatch.setattr(tracing, "_closed", itertools.count(1))
    metric = harness.reader("train.optim_ops")
    with tracing.span("train.capture", launches=203, optim_ops=17):
        pass
    with tracing.span("train.capture", launches=203):
        pass
    t_open = tracing.spans()[-1].t1 * 1e-9 + 1.0
    rec = {"kind": "train", "chunks": [(t_open, t_open + 1.0, False)]}
    assert metric.read(rec) is None
    with tracing.span("train.capture", launches=203, optim_ops=17):
        pass
    t_open = tracing.spans()[-1].t1 * 1e-9 + 1.0
    rec = {"kind": "train", "chunks": [(t_open, t_open + 1.0, False)]}
    assert metric.read(rec) == 17


def test_the_trainers_step_counts_carry_the_optimizers():
    """What ``StepGraph`` reads around a capture (the trainer's
    counters): K1-K3b's launches, K3a's own-layer items and the
    optimizer's operations."""
    from sim2real_lane_segment_tpu_torch.train import supervised

    dims = shapes("57")[:5]
    opt = AdamW(random_params(dims, 0), 1e-4)
    before = supervised._step_counts()
    assert set(before) == {"launches", "small_plane_launches", "stage_items",
                           "stage_prefetched", "optim_ops"}
    opt.step(random_params(dims, 1), 1e-3)
    after = supervised._step_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "launches": 0, "small_plane_launches": 0, "stage_items": 0,
        "stage_prefetched": 0, "optim_ops": 17}
