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
from sim2real_lane_segment_tpu_torch.models.tiramisu import (
    DenseBlock, TransitionDown, fcdensenet57, fcdensenet67, fcdensenet103)
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


# ---------------------------------------------------------------------------
# the tensor-core dense layer's dispatch rule and channel-loop split
# ---------------------------------------------------------------------------

ARCHS = {"57": fcdensenet57, "67": fcdensenet67, "103": fcdensenet103}
N_SITES = {"57": 44, "67": 55, "103": 91}
H100_SMS = 132  # an H100 SXM
SM_SMEM = 233_472  # shared memory of one SM, 1 KB of it reserved per block


def _dense_sites(arch, h=120, w=160):
    """(plane, c_j, growth) of every dense layer of the arch's forward on
    h x w frames, in forward order."""
    fe = ARCHS[arch](4).featureExtractor
    n = len(fe.down_blocks)
    planes = []
    for _ in range(n):
        planes.append((h, w))
        h, w = h // 2, w // 2
    blocks = ([(f"denseDown{i}", planes[i]) for i in range(n)]
              + [("bottleneck", (h, w))]
              + [(f"denseUp{i}", planes[n - 1 - i]) for i in range(n)])
    return [(plane, lay.Conv_0.in_channels, lay.Conv_0.out_channels)
            for name, plane in blocks for lay in getattr(fe, name).layers()]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_takes_mma_dense_at_every_site(arch, dtype):
    """bf16 takes the tensor cores at every site of all three archs
    (growth 12 in 57, 16 in 67 and 103); float32 (the parity control)
    never, nor another growth."""
    sites = _dense_sites(arch)
    assert len(sites) == N_SITES[arch]
    want = dtype == torch.bfloat16
    assert all(kdb.takes_mma_dense(dtype, g) == want for _, _, g in sites)
    assert {g for _, _, g in sites} == {12 if arch == "57" else 16}
    assert not kdb.takes_mma_dense(dtype, G)


@pytest.mark.parametrize("b", [1, 8, 32, 64])
@pytest.mark.parametrize("arch", ["57", "67", "103"])
def test_dense_splits_fill_the_card(arch, b):
    """The split is the least that gives two blocks per SM, within one
    portable cluster and at least one 32-channel chunk per block."""
    th, tw = kdb.MMA_TILE
    fill = kdb.BLOCKS_PER_SM * H100_SMS
    for (h, w), c, _ in _dense_sites(arch):
        s = kdb.dense_splits(b, h, w, c, H100_SMS)
        blocks = b * -(-h // th) * -(-w // tw)
        cap = min(kdb.MAX_SPLITS, -(-c // kdb.MMA_CHUNK))
        assert 1 <= s <= cap
        assert s == cap or s * blocks >= fill
        assert s == 1 or (s - 1) * blocks < fill


def test_dense_splits_of_a_b64_forward():
    """FCDenseNet67 at B=64 on an H100 SXM: the three large planes run
    unsplit, the small ones split their channel loop; a card with fewer
    SMs splits less."""
    got, fewer = {}, {}
    for plane, c, _ in _dense_sites("67"):
        got.setdefault(plane, set()).add(
            kdb.dense_splits(64, *plane, c, H100_SMS))
        fewer.setdefault(plane, set()).add(kdb.dense_splits(64, *plane, c, 114))
    assert got == {(120, 160): {1}, (60, 80): {1}, (30, 40): {1},
                   (15, 20): {2}, (7, 10): {5}, (3, 5): {5}}
    assert fewer == {(120, 160): {1}, (60, 80): {1}, (30, 40): {1},
                     (15, 20): {1}, (7, 10): {4}, (3, 5): {4}}


# ---------------------------------------------------------------------------
# the classifier's tile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_classifier_tile_at_the_last_block(arch, dtype):
    """The classifier stages all of the last block's channels for
    CLS_PIXELS pixels in one block: it fits, several blocks share an SM
    (six or more in bf16, the serving dtype), and a B=64 120x160 forward
    gives many waves of blocks."""
    c = ARCHS[arch](4).classifier.finalConv.in_channels
    assert c == {"57": 192, "67": 288, "103": 256}[arch]
    item = torch.empty((), dtype=dtype).element_size()
    smem = kdb.classifier_smem(c, dtype)
    assert c * kdb.CLS_PIXELS * item <= smem <= kdb.CLS_SMEM_MAX
    per_sm = min(2048 // (32 * kdb.CLS_WARPS), SM_SMEM // (smem + 1024))
    assert per_sm >= (6 if dtype == torch.bfloat16 else 2)
    blocks = 64 * -(-120 * 160 // kdb.CLS_PIXELS)
    assert blocks >= 10 * per_sm * H100_SMS


@pytest.mark.parametrize("dtype,widest", [(torch.bfloat16, 1808),
                                          (torch.float32, 800)])
def test_classifier_widest_buffer(dtype, widest):
    """The widest feature buffer one classifier block holds."""
    assert kdb.classifier_smem(widest, dtype) <= kdb.CLS_SMEM_MAX
    assert kdb.classifier_smem(widest + 1, dtype) > kdb.CLS_SMEM_MAX
    assert SM_SMEM // (kdb.classifier_smem(widest, dtype) + 1024) == 1
