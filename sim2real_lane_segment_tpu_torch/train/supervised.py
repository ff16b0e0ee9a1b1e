"""Supervised segmentation trainer (regimes ``sim`` and ``st``): train,
eval and predict steps.

Counterpart of ``sim2real_lane_segment_tpu.train.supervised``.  The
trainer owns the model (weights and running statistics) and the AdamW
state on its device, so the steps take batches alone:

- ``train_step``: ``augment_batch`` (with ``augment``) or ``eval_batch``,
  the train-mode forward, the class-weighted cross entropy on the softmax
  output, gradients, AdamW at this step's learning rate, and the running
  statistics update.  With ``pallas_train`` the forward is
  ``models.tiramisu_train_fused.fused_apply_train`` (kernels K1, K2, K3a,
  K3b on CUDA tensors), else the plain module with autograd.
- ``eval_step``: the plain module in eval mode, unweighted cross entropy
  and the batch metrics.
- ``predict_step``/``predict_step_fused``: uint8 frames to class maps.
  The trainer also holds a LaneNetLite (``--arch lite``) for the predict
  and eval steps; its train mode is not ported yet.

The random draws are operands: the augmentation's (``ops.augment.
AugmentDraws``) and the Dropout2d masks (``models.tiramisu.drop_masks``).
When a step is not given them it draws them from an explicit
``torch.Generator``, augmentation first, then dropout (the JAX step's
``k_aug, k_drop`` order).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.dtypes import DEFAULT_POLICY, DTypePolicy
from ..core.runtime import resolve_device
from ..models.tiramisu import (FCDenseNet, apply_batch_stats, drop_masks,
                               fcdensenet67)
from ..models.tiramisu_fused import FoldedModel, fold_model, fused_apply
from ..models.tiramisu_train_fused import fused_apply_train
from ..ops.augment import (AugmentConfig, AugmentDraws, augment_batch,
                           draw_augment, eval_batch)
from ..ops.metrics import accuracy, evaluate_outputs
from .losses import cross_entropy, weighted_cross_entropy
from .optim import AdamW
from .schedules import cosine_annealing


class SupervisedTrainer:
    """Owns the model and optimizer (on ``device``) and the steps.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``device="cpu"`` to run the plain PyTorch path on the CPU.
    """

    def __init__(self, *, num_cls: int = 4, lr: float = 1e-3,
                 decay: float = 1e-4, lr_ratio: float = 1e3,
                 height: int = 120, width: int = 160, gray: bool = False,
                 augment: bool = False,
                 policy: DTypePolicy = DEFAULT_POLICY,
                 model: nn.Module | None = None, pallas_train: bool = False,
                 device=None):
        self.num_cls = num_cls
        self.lr = lr
        self.decay = decay
        self.lr_ratio = lr_ratio
        self.augment = augment
        self.device = resolve_device(device)
        self.cfg = AugmentConfig(height=height, width=width, gray=gray,
                                 min_crop_height=height // 2,
                                 max_crop_height=height * 4)
        model = model if model is not None else fcdensenet67(num_cls, policy)
        if pallas_train and not isinstance(model, FCDenseNet):
            raise NotImplementedError(
                f"--pallas_train takes an FCDenseNet, not "
                f"{type(model).__name__}")
        self.model = model.to(self.device).eval()
        self.pallas_train = pallas_train
        self.params = list(self.model.parameters())
        self.opt = AdamW(self.params, decay)
        self._folded: FoldedModel | None = None

    # -- state ----------------------------------------------------------

    def lr_at(self, epoch: int) -> float:
        return cosine_annealing(self.lr, self.lr / self.lr_ratio, 25, epoch)

    def state_dict(self) -> dict:
        """Model and optimizer state, copied to the CPU."""
        return {"model": {k: v.to("cpu", copy=True)
                          for k, v in self.model.state_dict().items()},
                "optimizer": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])
        self._folded = None

    # -- inputs ---------------------------------------------------------

    def _to_device(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device)

    def _batch(self, images, labels, draws: AugmentDraws | None = None):
        """uint8 NHWC frames (+ labels) -> NCHW float32 input, int64 labels;
        through ``augment_batch`` when ``draws`` are given."""
        images = self._to_device(images)
        labels = None if labels is None else self._to_device(labels)
        if draws is None:
            x, y = eval_batch(images, labels, self.cfg,
                              with_labels=labels is not None)
        else:
            x, y = augment_batch(images, labels, self.cfg,
                                 draws.to(self.device),
                                 with_labels=labels is not None)
        x = x.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW, once
        return x, (None if y is None else y.to(torch.int64))

    def _train_input(self, images, labels, draws, generator):
        """``_batch`` for a train step: augmented with ``draws``, drawn
        from ``generator`` when not given, if the trainer augments."""
        if self.augment and draws is None:
            draws = draw_augment(generator, len(images), self.cfg,
                                 self.device)
        return self._batch(images, labels, draws if self.augment else None)

    # -- steps ----------------------------------------------------------

    def _require_trainable(self) -> None:
        if not isinstance(self.model, FCDenseNet):
            raise NotImplementedError(
                f"training {type(self.model).__name__} is not yet ported to "
                f"PyTorch")

    def train_step(self, images, labels, lr: float, *,
                   draws: AugmentDraws | None = None, masks=None,
                   generator: torch.Generator | None = None) -> dict:
        """One AdamW step on a uint8 batch.  ``draws``: the augmentation's
        draws (used with ``augment``); ``masks``: the Dropout2d masks in
        site order; each drawn from ``generator`` when not given.  Returns
        ``{"tr_loss", "tr_acc"}`` as 0-d tensors on the device."""
        self._require_trainable()
        generator = generator if generator is not None else torch.Generator()
        x, y = self._train_input(images, labels, draws, generator)
        if masks is None:
            masks = drop_masks(generator, self.model, x.shape[0],
                               self.device)
        if self.pallas_train:
            out, new_bs = fused_apply_train(self.model, x, masks)
        else:
            out, new_bs = self.model(x, train=True, masks=masks)
        loss = weighted_cross_entropy(out, y, self.num_cls)
        grads = torch.autograd.grad(loss, self.params)
        self.opt.step(grads, lr)
        apply_batch_stats(self.model, new_bs)
        self._folded = None
        pred = torch.argmax(out.detach(), dim=1)
        return {"tr_loss": loss.detach(), "tr_acc": accuracy(pred, y) * 100.0}

    def default_step_fn(self, batch, generator: torch.Generator,
                        epoch: int) -> dict:
        """The fit loop's per-batch step."""
        images, labels = batch
        return self.train_step(images, labels, self.lr_at(epoch),
                               generator=generator)

    @torch.inference_mode()
    def eval_step(self, images, labels) -> dict:
        """Unweighted cross entropy and metrics of the plain module in eval
        mode, each pre-multiplied by the batch size."""
        x, y = self._batch(images, labels)
        out = self.model(x)
        return evaluate_outputs(out, y, cross_entropy(out, y), self.num_cls)

    def _input(self, images) -> torch.Tensor:
        return self._batch(images, None)[0]

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
        the model's weights at the first call after a weight change.

        Models without a fused forward (LaneNetLite) run ``predict_step``,
        as the JAX ``predict_step_fused`` does: no kernel stands behind
        ``--arch lite --fused`` without ``--int8``, in either package."""
        if not isinstance(self.model, FCDenseNet):
            return self.predict_step(images)
        if self._folded is None:
            self._folded = fold_model(self.model)
        out = fused_apply(self.model, self._input(images), self._folded,
                          use_softmax=False)
        return torch.argmax(out, dim=1).to(torch.uint8)
