"""K4 port: the dense block's plain PyTorch version against the JAX
package's Pallas kernel (``fused_dense_block_cm`` in interpret mode).
The CUDA kernel is held against the plain version on a card in
``test_torch_kernels_gpu.py``.

Shapes: 12x16 pixels, c=8 input channels, growth g=4, n=2 layers, float32.
Tolerance 1e-5: both sides sum the same float32 products in another order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_common import jax_variables, load_port

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.models.tiramisu import \
    DenseBlock as JaxDenseBlock
from sim2real_lane_segment_tpu.models.tiramisu import \
    TransitionDown as JaxTransitionDown
from sim2real_lane_segment_tpu.models.tiramisu_pallas import (
    _fold_block_params, _fold_transition, fused_dense_block_cm)
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
from sim2real_lane_segment_tpu_torch.models.tiramisu import (DenseBlock,
                                                             TransitionDown)
from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import (
    fold_block_params, fold_transition)

B, H, W, C, G, N = 2, 12, 16, 8, 4, 2
C_TOTAL = C + N * G
TOL = dict(atol=1e-5, rtol=1e-5)


def _unflat(flat, prefix):
    """{prefix + "a/b/c": v} -> nested dict under the prefix."""
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = tree
        *path, leaf = k[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


@pytest.fixture(scope="module")
def block():
    """Shared weights: a DenseBlock, a TransitionDown and a classifier."""
    rng = np.random.default_rng(7)
    blk_flat = jax_variables(
        JaxDenseBlock(growth_rate=G, n_layers=N, policy=JAX_F32),
        (1, H, W, C), seed=1, train=False)
    td_flat = jax_variables(JaxTransitionDown(policy=JAX_F32),
                            (1, H, W, C_TOTAL), seed=2, train=False)
    jax_folded = _fold_block_params(
        _unflat(blk_flat, "params/"), _unflat(blk_flat, "batch_stats/"),
        N, G, C + (N - 1) * G, jnp.float32)
    jax_td = _fold_transition(_unflat(td_flat, "params/"),
                              _unflat(td_flat, "batch_stats/"))
    port_blk = load_port(DenseBlock(C, G, N, policy=F32_POLICY), blk_flat)
    port_td = load_port(TransitionDown(C_TOTAL, F32_POLICY), td_flat)
    wct = np.zeros((8, C_TOTAL), np.float32)
    wct[:4] = rng.normal(0, 0.3, (4, C_TOTAL))
    cb = np.zeros((8,), np.float32)
    cb[:4] = rng.normal(0, 0.1, 4)
    x = rng.normal(0, 1, (B, C, H, W)).astype(np.float32)
    return dict(
        jax_folded=jax_folded, jax_td=jax_td,
        jax_cls=(jnp.asarray(wct), jnp.asarray(cb[:, None]), 0.05),
        layers=fold_block_params(port_blk, torch.float32),
        td=fold_transition(port_td, torch.float32),
        cls=kdb.FoldedClassifier(torch.from_numpy(wct), torch.from_numpy(cb),
                                 1.0 / 0.05),
        x=x)


def _cm(x):
    """[B, C, H, W] numpy -> JAX channel-major [B, C, H*W]."""
    return jnp.asarray(x.reshape(x.shape[0], x.shape[1], -1))


def _jax(block, segments, **kw):
    return fused_dense_block_cm([_cm(s) for s in segments],
                                block["jax_folded"], n_layers=N, growth=G,
                                h=H, w=W, interpret=True, **kw)


def _np(t):
    return np.asarray(t).reshape(*np.asarray(t).shape[:2], H, W)


@pytest.mark.parametrize("c_lo", [0, C])
def test_dense_block_plain_matches_jax(block, c_lo):
    ref = _jax(block, [block["x"]], c_lo=c_lo)
    out = kdb.dense_block_plain([torch.from_numpy(block["x"])],
                                block["layers"], c_lo=c_lo)
    assert out.shape == (B, C_TOTAL - c_lo, H, W)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_dense_block_plain_two_segments(block):
    """The up-path virtual concat: segments [4 channels, 4 channels]."""
    segs = [block["x"][:, :4], block["x"][:, 4:]]
    ref = _jax(block, segs, c_lo=0)
    out = kdb.dense_block_plain([torch.from_numpy(np.ascontiguousarray(s))
                                 for s in segs], block["layers"], c_lo=0)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_dense_block_plain_transition_epilogue(block):
    ref, ref_td = _jax(block, [block["x"]], c_lo=0,
                       transition=block["jax_td"])
    out, td = kdb.dense_block_plain([torch.from_numpy(block["x"])],
                                    block["layers"], c_lo=0, td=block["td"])
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)
    assert td.shape == (B, C_TOTAL, H, W)
    np.testing.assert_allclose(td.numpy(), _np(ref_td), **TOL)


def test_dense_block_plain_classifier_epilogue(block):
    ref = _jax(block, [block["x"]], c_lo=0, classifier=block["jax_cls"])
    out = kdb.dense_block_plain([torch.from_numpy(block["x"])],
                                block["layers"], c_lo=0, cls=block["cls"])
    assert out.shape == (B, 8, H, W) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-4, rtol=1e-5)


def test_cpu_wrappers_take_the_plain_versions(block):
    """On CPU tensors the dispatching wrappers are the plain versions and
    launch nothing."""
    kdb.reset_launches()
    segs = [torch.from_numpy(block["x"])]
    a, a_td = kdb.dense_block(segs, block["layers"], c_lo=0, td=block["td"])
    b, b_td = kdb.dense_block_plain(segs, block["layers"], c_lo=0,
                                    td=block["td"])
    assert torch.equal(a, b) and torch.equal(a_td, b_td)
    assert torch.equal(kdb.dense_block(segs, block["layers"], c_lo=0,
                                       cls=block["cls"]),
                       kdb.dense_block_plain(segs, block["layers"], c_lo=0,
                                             cls=block["cls"]))
    assert kdb.launches == {"dense_layer": 0, "transition": 0,
                            "classifier": 0}
