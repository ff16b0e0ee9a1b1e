"""Supervised segmentation trainer: the inference steps.

Counterpart of ``sim2real_lane_segment_tpu.train.supervised``.  This slice
ports ``predict_step`` and ``predict_step_fused``; the train and eval
steps (augmentation, losses, optimizer) belong to the training slice.
The model holds its own weights, so the steps take the frames alone.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import DEFAULT_POLICY, DTypePolicy
from ..core.runtime import resolve_device
from ..models.tiramisu import FCDenseNet, fcdensenet67
from ..models.tiramisu_fused import FoldedModel, fold_model, fused_apply
from ..ops.augment import AugmentConfig, eval_batch


class SupervisedTrainer:
    """Owns the model (on ``device``) and the eval transform config.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``device="cpu"`` to run the plain PyTorch path on the CPU.
    """

    def __init__(self, *, num_cls: int = 4, height: int = 120,
                 width: int = 160, gray: bool = False,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 model: FCDenseNet | None = None, device=None):
        self.num_cls = num_cls
        self.device = resolve_device(device)
        self.cfg = AugmentConfig(height=height, width=width, gray=gray,
                                 min_crop_height=height // 2,
                                 max_crop_height=height * 4)
        model = model if model is not None else fcdensenet67(num_cls, policy)
        self.model = model.to(self.device).eval()
        self._folded: FoldedModel | None = None

    def _input(self, images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        x, _ = eval_batch(images.to(self.device), None, self.cfg,
                          with_labels=False)
        return x.permute(0, 3, 1, 2)  # NHWC -> NCHW, once, at the model

    @torch.inference_mode()
    def predict_step(self, images) -> torch.Tensor:
        """uint8 (N, H, W, 3) frames -> (N, height, width) uint8 class map,
        on the trainer's device, through the plain module."""
        out = self.model(self._input(images), use_softmax=False)
        return torch.argmax(out, dim=1).to(torch.uint8)

    @torch.inference_mode()
    def predict_step_fused(self, images) -> torch.Tensor:
        """``predict_step`` through the fused dense-block forward
        (``models.tiramisu_fused``).  The kernel operands are folded from
        the model's weights at the first call and kept."""
        if self._folded is None:
            self._folded = fold_model(self.model)
        out = fused_apply(self.model, self._input(images), self._folded,
                          use_softmax=False)
        return torch.argmax(out, dim=1).to(torch.uint8)
