"""The port's learning demos (``sim2real_lane_segment_tpu_torch.learning``)
against the JAX package's Flax/optax versions, on the CPU at the
published 60x80 observations (where Flax's SAME padding is asymmetric:
the 15-row plane pads 1 above and 2 below).

Weights cross through ``models.flax_import.policy_state_dict_from_flax``.
Tolerances: forwards FWD_RTOL relative (FWD_ATOL absolute near zero);
the losses of two train steps within LOSS_RTOL; after them every
parameter within SGD_ATOL (SGD with momentum), or ADAM_ATOL (DDPG's Adam
steps and soft updates): float32 sums in another order move a gradient
by ulps, and Adam's step lr * g / (|g| + eps) turns an absolute error d
of a gradient near zero into lr * d / eps, which ADAM_ATOL allows up to
1% of lr (measured worst 2.0e-6 at lr 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from sim2real_lane_segment_tpu.learning import ddpg as jddpg
from sim2real_lane_segment_tpu.learning import imitation as jimit

from sim2real_lane_segment_tpu_torch.learning import ddpg as tddpg
from sim2real_lane_segment_tpu_torch.learning import imitation as timit
from sim2real_lane_segment_tpu_torch.learning import load_policy
from sim2real_lane_segment_tpu_torch.models.flax_import import \
    policy_state_dict_from_flax

torch.set_num_threads(2)

HW = (60, 80)
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
SGD_ATOL = 2e-6
DDPG_LR = 1e-3
ADAM_ATOL = 1e-2 * DDPG_LR
LOSS_RTOL = 1e-5


def flat(params) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.device_get(params), sep="/").items()}


def port(module, params):
    module.load_state_dict(policy_state_dict_from_flax(flat(params), module))
    return module


def assert_params(module, params, atol):
    sd = policy_state_dict_from_flax(flat(params), module)
    for k, v in module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), sd[k].numpy(), atol=atol,
                                   err_msg=k)


def batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, *HW, 3), dtype=np.uint8),
            rng.uniform(-1, 1, (b, 2)).astype(np.float32))


def test_forwards_match_jax():
    obs, act = batch(0)
    key = jax.random.key(1)
    x0 = jnp.zeros((1, *HW, 3))
    for jm, tm, extra in (
            (jimit.PolicyCNN(), timit.PolicyCNN(obs_hw=HW), ()),
            (jddpg.ActorCNN(), tddpg.ActorCNN(obs_hw=HW), ()),
            (jddpg.CriticCNN(), tddpg.CriticCNN(obs_hw=HW), (act,))):
        params = jm.init(key, x0, *(jnp.zeros((1, 2)) for _ in extra)
                         )["params"]
        ref = np.asarray(jm.apply({"params": params}, jnp.asarray(obs),
                                  *map(jnp.asarray, extra)))
        got = port(tm, params)(torch.from_numpy(obs),
                               *map(torch.from_numpy, extra))
        np.testing.assert_allclose(got.detach().numpy(), ref,
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
    # the planes really were 15 -> 8 rows (asymmetric SAME padding)
    assert tm.Dense_0.in_features == 8 * 10 * 64 + 2


def test_imitation_step_matches_jax():
    obs, act = batch(2, b=8)
    jl = jimit.ImitationLearner(lr=1e-2, obs_hw=HW)
    state = jl.init_state(jax.random.key(3))
    tl = timit.ImitationLearner(lr=1e-2, obs_hw=HW, device="cpu")
    port(tl.model, state.params)
    for _ in range(2):   # the second step runs on the momentum trace
        state, jloss = jl.train_step(state, jnp.asarray(obs),
                                     jnp.asarray(act))
        tloss = tl.train_step(torch.from_numpy(obs), torch.from_numpy(act))
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=LOSS_RTOL)
    assert_params(tl.model, state.params, SGD_ATOL)
    np.testing.assert_allclose(
        tl.predict(torch.from_numpy(obs)).numpy(),
        np.asarray(jl.predict(state, jnp.asarray(obs))), rtol=FWD_RTOL,
        atol=FWD_ATOL)


def test_ddpg_step_matches_jax():
    obs, act = batch(4, b=8)
    nobs, _ = batch(5, b=8)
    rng = np.random.default_rng(6)
    reward = rng.normal(0, 1, 8).astype(np.float32)
    done = (rng.uniform(size=8) < 0.3).astype(np.float32)
    jd = jddpg.DDPG(obs_hw=HW, lr=DDPG_LR, tau=0.1)
    state = jd.init_state(jax.random.key(7))
    td = tddpg.DDPG(obs_hw=HW, lr=DDPG_LR, tau=0.1, device="cpu")
    for net, tgt, params in ((td.actor, td.actor_target, state.actor),
                             (td.critic, td.critic_target, state.critic)):
        port(net, params)
        port(tgt, params)
    args = (obs, act, reward, nobs, done)
    for _ in range(2):
        state, jl = jd.train_step(state, *map(jnp.asarray, args))
        tl = td.train_step(*map(torch.from_numpy, args))
        for k in ("critic_loss", "actor_loss"):
            np.testing.assert_allclose(float(tl[k]), float(jl[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
    for net, params in ((td.actor, state.actor), (td.critic, state.critic),
                        (td.actor_target, state.actor_target),
                        (td.critic_target, state.critic_target)):
        assert_params(net, params, ADAM_ATOL)
    np.testing.assert_allclose(
        td.select_action(torch.from_numpy(obs)).numpy(),
        np.asarray(jd.select_action(state, jnp.asarray(obs))),
        rtol=FWD_RTOL, atol=FWD_ATOL)


def test_replay_buffer_matches_jax():
    jb, tb = jddpg.ReplayBuffer(max_size=6, seed=3), \
        tddpg.ReplayBuffer(max_size=6, seed=3)
    rng = np.random.default_rng(8)
    for i in range(10):   # past max_size: random eviction
        item = (rng.integers(0, 256, (3, 4, 3), dtype=np.uint8),
                rng.uniform(-1, 1, 2).astype(np.float32), float(i),
                rng.integers(0, 256, (3, 4, 3), dtype=np.uint8),
                float(i % 3 == 0))
        jb.add(*item)
        tb.add(*item)
    assert len(tb) == len(jb) == 6
    for _ in range(3):
        for a, b in zip(tb.sample(5), jb.sample(5)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["imitation", "actor"])
def test_msgpack_weights_load(tmp_path, kind):
    """The JAX CLIs' ``serialization.to_bytes(params)`` files load into
    the port's modules; a ``.pt`` of the port loads the same."""
    jm, tm = ((jimit.PolicyCNN(), timit.PolicyCNN(obs_hw=HW))
              if kind == "imitation"
              else (jddpg.ActorCNN(), tddpg.ActorCNN(obs_hw=HW)))
    params = jm.init(jax.random.key(9), jnp.zeros((1, *HW, 3)))["params"]
    path = tmp_path / "w.msgpack"
    path.write_bytes(serialization.to_bytes(jax.device_get(params)))
    load_policy(str(path), tm)
    obs, _ = batch(10)
    np.testing.assert_allclose(
        tm(torch.from_numpy(obs)).detach().numpy(),
        np.asarray(jm.apply({"params": params}, jnp.asarray(obs))),
        rtol=FWD_RTOL, atol=FWD_ATOL)
    torch.save(tm.state_dict(), tmp_path / "w.pt")
    again = load_policy(str(tmp_path / "w.pt"), type(tm)(obs_hw=HW))
    for a, b in zip(again.state_dict().values(), tm.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises((KeyError, ValueError)):   # another network
        load_policy(str(path), tddpg.CriticCNN(obs_hw=HW))


def test_flax_init_statistics():
    """Parameters start as Flax's do: zero biases, LeCun-normal kernels
    (truncated at two deviations) seeded by ``seed``."""
    a = timit.ImitationLearner(seed=4, device="cpu").model
    b = timit.ImitationLearner(seed=4, device="cpu").model
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w)
        if k.endswith("bias"):
            assert not v.any()
        else:
            std = (1.0 / v[0].numel()) ** 0.5
            assert v.abs().max() <= 2 * std / 0.8796 + 1e-6
            assert 0.8 * std < v.std() < 1.2 * std, k


@pytest.mark.parametrize("learner", [timit.ImitationLearner, tddpg.DDPG])
def test_learners_need_a_card_unless_cpu(learner):
    """Like the trainers, the learners run on the card by default and
    raise when there is none; the CPU is taken only when asked for."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        learner(obs_hw=HW)
    assert learner(obs_hw=HW, device="cpu").device == torch.device("cpu")
