"""The dense-layer and TransitionDown sites of FCDenseNet67, FCDenseNet57
and FCDenseNet103 on 120x160 frames, read from the port's models, for the
kernel tests.  Imports neither JAX nor the JAX package, so the card's
tests read it too."""
from sim2real_lane_segment_tpu_torch.cli.test import build_model


def _sites(arch, h=120, w=160):
    """(c_j, H, W) of the dense layers, (c, H, W) of the TransitionDowns,
    and each dense layer's count of later layers in its block, in forward
    order: five levels down, the bottleneck, five up."""
    fe = build_model(arch, 4).featureExtractor
    n = len(fe.down_blocks)
    planes = [(h >> i, w >> i) for i in range(n + 1)]
    blocks = ([(f"denseDown{i}", i) for i in range(n)] + [("bottleneck", n)]
              + [(f"denseUp{i}", n - 1 - i) for i in range(n)])
    dense, later = [], []
    for name, level in blocks:
        layers = getattr(fe, name).layers()
        dense += [(lay.Conv_0.in_channels, *planes[level]) for lay in layers]
        later += [len(layers) - 1 - j for j in range(len(layers))]
    td = [(getattr(fe, f"transDown{i}").Conv_0.in_channels, *planes[i])
          for i in range(n)]
    return dense, td, later


# FCDenseNet67: 55 dense layers (growth 16, five a block), 5 TDs
DENSE_SITES, TD_SITES, LATER = _sites("67")
# FCDenseNet57: 44 dense layers (growth 12, four a block), 5 TDs
DENSE_SITES_57, TD_SITES_57, LATER_57 = _sites("57")
# FCDenseNet103: 91 dense layers (growth 16; blocks of 4, 5, 7, 10 and 12
# down, a 15-layer bottleneck, 12, 10, 7, 5 and 4 up), 5 TDs
DENSE_SITES_103, TD_SITES_103, LATER_103 = _sites("103")
