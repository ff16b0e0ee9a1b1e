"""K4 CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode).  This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py

Shapes cross the kernel's 16x16 pixel tiles, its 16-channel input
stages and its 16-channel output groups with ragged remainders.
"""
import numpy as np
import pytest
import torch

from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb

# (B, H, W, c_in, growth, n_layers)
CASES = [(2, 12, 16, 8, 4, 2), (3, 15, 20, 40, 16, 3), (1, 7, 33, 24, 12, 2)]
# f32: summation order only.  bf16: a different f32 sum may round to the
# neighbouring bf16 value (relative step 2^-7), and a later layer sees it.
TOLS = {torch.float32: dict(atol=1e-5, rtol=1e-5),
        torch.bfloat16: dict(atol=2e-2, rtol=2 ** -6)}
# logits are x20 (1/temperature) of the normalized features
LOGIT_ATOL = {torch.float32: 1e-4, torch.bfloat16: 0.1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(case, dtype, device, seed=0):
    b, h, w, c, g, n = case
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    layers = []
    for j in range(n):
        k = c + j * g
        layers.append(kdb.FoldedLayer(
            t(rng.uniform(0.5, 1.5, k)), t(rng.normal(0, 0.3, k)),
            t(rng.normal(0, (2 / (9 * k)) ** 0.5, (k, 9, g)), dtype),
            t(rng.normal(0, 0.1, g))))
    ct = c + n * g
    td = kdb.FoldedTransition(
        t(rng.uniform(0.5, 1.5, ct)), t(rng.normal(0, 0.3, ct)),
        t(rng.normal(0, (2 / ct) ** 0.5, (ct, ct)), dtype),
        t(rng.normal(0, 0.1, ct)))
    wc = np.zeros((8, ct), np.float32)
    wc[:4] = rng.normal(0, 0.3, (4, ct))
    cb = np.zeros(8, np.float32)
    cb[:4] = rng.normal(0, 0.1, 4)
    cls = kdb.FoldedClassifier(t(wc, dtype), t(cb), 1.0 / 0.05)
    x = t(rng.normal(0, 1, (b, c, h, w)), dtype)
    return x, layers, td, cls


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain(cuda, case, dtype):
    x, layers, td, cls = _operands(case, dtype, cuda)
    n = len(layers)
    kdb.reset_launches()
    out, out_td = kdb.dense_block([x], layers, c_lo=0, td=td)
    ref, ref_td = kdb.dense_block_plain([x], layers, c_lo=0, td=td)
    feat = ref.contiguous()
    # epilogues on identical features, so each is checked on its own
    td_k = kdb.transition(feat, td)
    logits = kdb.classifier(feat, cls)
    torch.cuda.synchronize()
    assert kdb.launches == {"dense_layer": n, "transition": 2,
                            "classifier": 1}
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])
    torch.testing.assert_close(td_k.float(), ref_td.float(), **TOLS[dtype])
    torch.testing.assert_close(logits, kdb.classifier_plain(feat, cls),
                               atol=LOGIT_ATOL[dtype], rtol=0)


@pytest.mark.gpu
def test_new_features_and_segments(cuda):
    """c_lo = c_in (up-path blocks) over two input segments."""
    x, layers, _, _ = _operands(CASES[1], torch.float32, cuda, seed=1)
    segs = [x[:, :16].contiguous(), x[:, 16:].contiguous()]
    out = kdb.dense_block(segs, layers, c_lo=x.shape[1])
    ref = kdb.dense_block_plain([x], layers, c_lo=x.shape[1])
    torch.testing.assert_close(out, ref, **TOLS[torch.float32])


@pytest.mark.gpu
def test_wrapper_rejects_bad_operands(cuda):
    x, layers, _, _ = _operands(CASES[0], torch.float32, cuda)
    feat = torch.zeros(2, 16, 12, 16, device=cuda)
    bad = layers[0]._replace(scale=layers[0].scale.cpu())
    with pytest.raises(ValueError):
        kdb.dense_layer(feat, bad)
    with pytest.raises(ValueError):  # f64 is not a kernel dtype
        kdb.dense_layer(feat.double(), layers[0])
