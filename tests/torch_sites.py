"""The dense-layer and TransitionDown sites of FCDenseNet67 and
FCDenseNet57 on 120x160 frames, for the kernel tests.  Imports neither JAX
nor the JAX package, so the card's tests read it too."""


def _sites(growth, per_block, first, up_first):
    """(c_j, H, W) of the dense layers and (c, H, W) of the
    TransitionDowns, in forward order: five levels down, the bottleneck at
    3x5, five up; a down block adds ``per_block`` layers of ``growth``
    channels to its input, an up block's first layer reads the
    TransitionUp's ``up_first`` channels beside the skip."""
    res = [(120, 160), (60, 80), (30, 40), (15, 20), (7, 10)]
    dense, td, c, skips = [], [], first, []
    for h, w in res:
        dense += [(c + growth * j, h, w) for j in range(per_block)]
        c += growth * per_block
        skips.append(c)
        td.append((c, h, w))
    dense += [(c + growth * j, 3, 5) for j in range(per_block)]
    for (h, w), skip in zip(reversed(res), reversed(skips)):
        dense += [(up_first + skip + growth * j, h, w)
                  for j in range(per_block)]
    return dense, td


# FCDenseNet67: 55 dense layers (growth 16, five a block), 5 TDs
DENSE_SITES, TD_SITES = _sites(16, 5, 48, 80)
# FCDenseNet57: 44 dense layers (growth 12, four a block), 5 TDs
DENSE_SITES_57, TD_SITES_57 = _sites(12, 4, 48, 48)
