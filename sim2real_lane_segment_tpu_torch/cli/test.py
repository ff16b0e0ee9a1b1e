"""Model construction and weight loading for the evaluation and serving
CLIs.

Counterpart of ``build_model`` and ``load_trainer_and_state`` in the JAX
package's ``cli/test.py``.  The FC-DenseNet archs (67, 57, 103, tiny) and
LaneNetLite (``lite``) are ported; ``67r``, ``encdec`` and the ``mme``
module type are not yet, and raise.  The evaluation ``main`` belongs to a
later slice.
"""
from __future__ import annotations

from ..core.dtypes import DEFAULT_POLICY, DTypePolicy

PORTED_ARCHES = ("67", "57", "103", "tiny", "lite")


def build_model(arch: str, num_cls: int,
                policy: DTypePolicy = DEFAULT_POLICY):
    from ..models.lanenet_lite import LaneNetLite
    from ..models.tiramisu import (FCDenseNet, fcdensenet57, fcdensenet67,
                                   fcdensenet103)
    if arch not in PORTED_ARCHES:
        raise NotImplementedError(
            f"--arch {arch} is not yet ported to PyTorch "
            f"(ported: {', '.join(PORTED_ARCHES)})")
    return {"67": lambda: fcdensenet67(num_cls, policy),
            "57": lambda: fcdensenet57(num_cls, policy=policy),
            "103": lambda: fcdensenet103(num_cls, policy),
            "lite": lambda: LaneNetLite(n_classes=num_cls, policy=policy),
            "tiny": lambda: FCDenseNet(
                n_classes=num_cls, down_blocks=(2, 2), up_blocks=(2, 2),
                bottleneck_layers=2, growth_rate=4,
                out_chans_first_conv=8, policy=policy)}[arch]()


def load_trainer_and_state(module_type: str, checkpoint_path: str,
                           num_cls: int = 4, arch: str = "67",
                           height: int = 120, width: int = 160,
                           device=None, policy: DTypePolicy = DEFAULT_POLICY):
    """A ``SupervisedTrainer`` on ``device`` (default ``cuda``) holding the
    weights at ``checkpoint_path`` (``.pt``, ``.msgpack`` or ``.npz``).  The
    model holds the weights, so the trainer is the whole state."""
    from ..train.checkpoint import load_weights
    from ..train.supervised import SupervisedTrainer

    if module_type == "mme":
        raise NotImplementedError("-t mme is not yet ported to PyTorch")
    if module_type not in ("baseline", "sandt", "hm", "CycleGAN"):
        raise RuntimeError(f"Cannot recognize module type {module_type}")
    model = build_model(arch, num_cls, policy)
    load_weights(checkpoint_path, model)
    return SupervisedTrainer(num_cls=num_cls, model=model, height=height,
                             width=width, device=device)
