"""The CycleGAN regime's networks and trainer (``models.cyclegan``,
``models.flax_import.cyclegan_state_dict_from_flax``, ``train.cyclegan``)
against the JAX package on the CPU, weights carried from Flax.

Tolerances (float32 on both sides):
- forwards: max|err| <= FWD_ATOL on outputs in [-1, 1] (tanh) or O(1)
  patch scores: the same products summed in another order;
- one ``train_step``: the five losses within LOSS_RTOL; the gradients,
  read as Adam's first moment, per parameter max|err| <= GRAD_RTOL *
  max(max|ref|, 1e-2 * the largest gradient of that network), as the
  port's other step gates hold them; the parameters: Adam's first step
  moves each element by about lr * sign(g), so an element whose gradient
  is float noise (the conv biases that feed an InstanceNorm have a zero
  gradient in exact arithmetic) may step the other way.  Every element
  lies within 2 * lr + 1e-6 of JAX's, and one more than 1e-6 away only
  where |g| <= NOISE_G * the network's largest gradient (measured: at
  most 5e-5);
- ``fit_cyclegan``, 1 epoch of 2 steps: those opposite steps move the
  second step's losses, so these are held within FIT_LOSS_RTOL (measured:
  7.4e-4, the GAN loss), the parameters within 2 * (2 * lr) + 1e-6.
"""
import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.models import cyclegan as jax_cg
from sim2real_lane_segment_tpu.models import torch_import
from sim2real_lane_segment_tpu.train import cyclegan as jax_train
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.models import cyclegan as port_cg
from sim2real_lane_segment_tpu_torch.models.flax_import import (
    _flax_conv_order, conv_weight, cyclegan_state_dict_from_flax)
from sim2real_lane_segment_tpu_torch.train import cyclegan as port_train

from test_torch_common import flat_numpy

torch.set_num_threads(2)

FWD_ATOL = 5e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
NOISE_G = 2e-4
FIT_LOSS_RTOL = 3e-3
LR = 2e-4
H, W = 32, 32


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def carried(module, variables):
    module.load_state_dict(cyclegan_state_dict_from_flax(
        flat_numpy(variables), module))
    return module.eval()


# -- part 1: the networks ----------------------------------------------------

@pytest.mark.parametrize("blocks,shape", [(1, (2, 24, 32, 3)),
                                          (2, (1, 32, 48, 3))])
def test_generator_matches_flax(blocks, shape):
    x = np.random.default_rng(blocks).uniform(-1, 1, shape).astype(
        np.float32)
    g = jax_cg.GeneratorResNet(num_residual_blocks=blocks, policy=JAX_F32)
    v = g.init(jax.random.key(blocks), x)
    want = np.asarray(g.apply(v, x))
    port = carried(port_cg.GeneratorResNet(num_residual_blocks=blocks,
                                           policy=F32_POLICY), v)
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 48, 64, 3), (1, 64, 64, 3)])
def test_discriminator_matches_flax(shape):
    x = np.random.default_rng(shape[1]).uniform(-1, 1, shape).astype(
        np.float32)
    d = jax_cg.Discriminator(policy=JAX_F32)
    v = d.init(jax.random.key(3), x)
    want = np.asarray(d.apply(v, x))
    port = carried(port_cg.Discriminator(policy=F32_POLICY), v)
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    assert got.shape == want.shape == (shape[0], shape[1] // 16,
                                       shape[2] // 16, 1)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)


def test_full_generator_parameter_count():
    with torch.device("meta"):
        g = port_cg.GeneratorResNet(num_residual_blocks=9)
    assert sum(p.numel() for p in g.parameters()) == 11_378_179


# -- part 2: a reference-layout state dict loads directly ---------------------

class RefResidualBlock(nn.Module):
    """The reference repository's ResidualBlock, as it builds it."""

    def __init__(self, f):
        super().__init__()
        self.block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(f, f, 3), nn.InstanceNorm2d(f),
            nn.ReLU(inplace=True), nn.ReflectionPad2d(1), nn.Conv2d(f, f, 3),
            nn.InstanceNorm2d(f))

    def forward(self, x):
        return x + self.block(x)


class RefGeneratorResNet(nn.Module):
    """The reference repository's GeneratorResNet (sim2real_convert.py)."""

    def __init__(self, channels=3, num_residual_blocks=9):
        super().__init__()
        f = 64
        model = [nn.ReflectionPad2d(channels), nn.Conv2d(channels, f, 7),
                 nn.InstanceNorm2d(f), nn.ReLU(inplace=True)]
        for _ in range(2):
            model += [nn.Conv2d(f, 2 * f, 3, stride=2, padding=1),
                      nn.InstanceNorm2d(2 * f), nn.ReLU(inplace=True)]
            f *= 2
        model += [RefResidualBlock(f) for _ in range(num_residual_blocks)]
        for _ in range(2):
            model += [nn.Upsample(scale_factor=2),
                      nn.Conv2d(f, f // 2, 3, stride=1, padding=1),
                      nn.InstanceNorm2d(f // 2), nn.ReLU(inplace=True)]
            f //= 2
        model += [nn.ReflectionPad2d(channels), nn.Conv2d(f, channels, 7),
                  nn.Tanh()]
        self.model = nn.Sequential(*model)

    def forward(self, x):
        return self.model(x)


def _flax_tree_from_torch(sd, template):
    """The reference state dict as a Flax tree, by application order."""
    flat = flat_numpy(template)
    paths = sorted({k.removeprefix("params/").rsplit("/", 1)[0]
                    for k in flat})
    weights = [k for k in sd if k.endswith(".weight")]
    tree = {}
    for path, key in zip(_flax_conv_order(paths), weights):
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node["kernel"] = jnp.asarray(np.transpose(sd[key].numpy(),
                                                  (2, 3, 1, 0)))
        node["bias"] = jnp.asarray(sd[key[:-6] + "bias"].numpy())
    return {"params": tree}


@pytest.mark.parametrize("blocks", [0, 2])
def test_reference_state_dict_loads_directly(tmp_path, blocks):
    """A reference generator's ``torch.save``d state dict: the port loads
    it with ``load_state_dict`` and computes the reference module's
    function, and JAX's.  JAX's ``import_cyclegan_state_dict`` assigns the
    convs in the sorted order of the Flax names, which puts the residual
    blocks last: it loads a generator without residual blocks and raises
    on one with them."""
    torch.manual_seed(blocks)
    ref = RefGeneratorResNet(num_residual_blocks=blocks).eval()
    path = str(tmp_path / "G_AB.pth")
    torch.save(ref.state_dict(), path)
    port = port_cg.GeneratorResNet(num_residual_blocks=blocks,
                                   policy=F32_POLICY)
    port.load_state_dict(torch.load(path, weights_only=True))
    x = np.random.default_rng(blocks).uniform(-1, 1, (2, 24, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
        want_ref = nhwc(ref(nchw(x)))
    np.testing.assert_allclose(got, want_ref, atol=FWD_ATOL, rtol=0)

    g = jax_cg.GeneratorResNet(num_residual_blocks=blocks, policy=JAX_F32)
    template = g.init(jax.random.key(0), x)
    if blocks == 0:
        tree = {"params": torch_import.import_cyclegan_state_dict(
            path, template["params"])}
    else:
        with pytest.raises(ValueError, match="shape mismatch"):
            torch_import.import_cyclegan_state_dict(path, template["params"])
        tree = _flax_tree_from_torch(ref.state_dict(), template)
    np.testing.assert_allclose(got, np.asarray(g.apply(tree, x)),
                               atol=FWD_ATOL, rtol=0)
    # and back: the Flax tree carried onto a fresh port module
    again = carried(port_cg.GeneratorResNet(num_residual_blocks=blocks,
                                            policy=F32_POLICY), tree)
    for (k, a), b in zip(port.state_dict().items(),
                         again.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)


# -- part 3: the replay pool ---------------------------------------------------

@pytest.mark.parametrize("size,seed", [(4, 0), (3, 5), (0, 1)])
def test_image_pool_decisions_equal_jax(size, seed):
    rng = np.random.default_rng(seed)
    jp = jax_train.ImagePool(size=size, seed=seed)
    pp = port_train.ImagePool(size=size, seed=seed)
    for step in range(6):
        fakes = rng.normal(size=(3, 2, 2, 1)).astype(np.float32)
        want = jp.query(fakes)
        got = pp.query(torch.from_numpy(fakes)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")


# -- parts 4 and 5: the train step and the fit loop -------------------------

def toy_domains(n, seed):
    """Domain A: red-shifted noise; domain B: blue-shifted noise (BGR)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.3, 0.3, (2 * n, H, W, 3)).astype(np.float32)
    a, b = base[:n].copy(), base[n:].copy()
    a[..., 2] += 0.5
    b[..., 0] += 0.5
    return np.clip(a, -1, 1), np.clip(b, -1, 1)


NETS = ("g_ab", "g_ba", "d_a", "d_b")


@pytest.fixture(scope="module")
def jax_trainer():
    """One JAX trainer, so its jitted step compiles once for the file."""
    return jax_train.CycleGANTrainer(num_residual_blocks=1)


def port_from_jax(state):
    tr = port_train.CycleGANTrainer(num_residual_blocks=1, device="cpu")
    for name in NETS:
        net = getattr(tr, name)
        net.load_state_dict(cyclegan_state_dict_from_flax(
            flat_numpy({"params": getattr(state, name)}), net))
    return tr


def assert_params_close(tr, state, atol):
    for name in NETS:
        net = getattr(tr, name)
        want = cyclegan_state_dict_from_flax(
            flat_numpy({"params": getattr(state, name)}), net)
        for k, v in net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=atol, err_msg=f"{name}.{k}")


def assert_first_step_close(tr, state):
    """Adam's first moment after the first step is (1 - b1) * grad: hold
    the gradients, then the parameters they moved."""
    for nets, opt, tree in ((("g_ab", "g_ba"), tr.opt_g, state.opt_g[0].mu),
                            (("d_a", "d_b"), tr.opt_d, state.opt_d[0].mu)):
        got, want, params, names = [], [], [], []
        for name in nets:
            net = getattr(tr, name)
            mu = cyclegan_state_dict_from_flax(
                flat_numpy({"params": tree[name]}), net)
            new = cyclegan_state_dict_from_flax(
                flat_numpy({"params": getattr(state, name)}), net)
            for k, p in net.named_parameters():
                want.append(mu[k].numpy())
                params.append((p.detach().numpy(), new[k].numpy()))
                names.append(f"{name}.{k}")
        got = [m.numpy() for m in opt.mu]
        largest = max(np.abs(w).max() for w in want)
        for name, g, w, (p, p_ref) in zip(names, got, want, params):
            err = np.abs(g - w).max()
            assert err <= GRAD_RTOL * max(np.abs(w).max(), 1e-2 * largest), \
                name
            moved = np.abs(p - p_ref)
            assert moved.max() <= 2 * LR + 1e-6, name
            assert (np.abs(w[moved > 1e-6]) <= NOISE_G * largest
                    ).all(), name


def test_train_step_matches_jax(jax_trainer):
    a, b = toy_domains(2, seed=1)
    state = jax_trainer.init_state(jax.random.key(0), H, W)
    pa, pb = toy_domains(2, seed=2)
    new, (fa, fb), logs = jax_trainer.train_step(state, a, b, pa, pb)
    tr = port_from_jax(state)
    (pfa, pfb), plogs = tr.train_step(nchw(a), nchw(b), nchw(pa), nchw(pb))
    for k, v in logs.items():
        np.testing.assert_allclose(float(plogs[k]), float(v), rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(nhwc(pfa), np.asarray(fa), atol=FWD_ATOL)
    np.testing.assert_allclose(nhwc(pfb), np.asarray(fb), atol=FWD_ATOL)
    assert_first_step_close(tr, new)


def test_fit_cyclegan_matches_jax(jax_trainer):
    a, b = toy_domains(4, seed=3)
    state = jax_trainer.init_state(jax.random.key(1), H, W)
    tr = port_from_jax(state)
    new, hist = jax_train.fit_cyclegan(jax_trainer, state, a, b, epochs=1,
                                       batch_size=2, seed=0)
    phist = port_train.fit_cyclegan(tr, a, b, epochs=1, batch_size=2,
                                    seed=0)
    assert len(phist) == len(hist) == 1 and phist[0]["epoch"] == 0
    for k, v in hist[0].items():
        np.testing.assert_allclose(phist[0][k], v, rtol=FIT_LOSS_RTOL,
                                   err_msg=k)
    assert_params_close(tr, new, 2 * (2 * LR) + 1e-6)
