"""MME semi-supervised domain adaptation: both optimizer phases in one step.

Counterpart of ``sim2real_lane_segment_tpu.train.mme``.  The reference
(MMETrainingModule.py:14-38) let Lightning alternate two optimizers per
batch:

- phase G: SGD (momentum 0.9, Nesterov; the feature extractor at lr/3,
  the classifier at lr) on the adversarial entropy of the *unlabelled*
  batch, routed featureExtractor -> grad_reverse -> classifier, lambda 0.1;
  torch's SGD adds ``wd * p`` to the gradient before the momentum;
- phase F: AdamW on the class-weighted cross entropy of the *labelled*
  batch, at the parameters phase G left; AdamW adds ``wd * p`` to the
  update after the moments.

Both optimizers cover all parameters (an inheritance quirk the reference
kept, QUIRKS.md); all three learning rates follow CosineAnnealingLR(T_max
25, eta_min = lr * 1e-3) per epoch, where eta_min is absolute, so the
feature extractor anneals lr/3 -> lr*1e-3.  Both phases run train-mode
forwards, so the running statistics move twice per step: phase G's update
is written into the model before phase F's forward, which starts from it.
With ``pallas_train`` both phases run through the fused consumer kernels
(K1, K2, K3a, K3b); phase G's cotangent reaches them negated, through
``grad_reverse`` on the head's input.
"""
from __future__ import annotations

import torch

from ..models.tiramisu import apply_batch_stats, drop_masks, grad_reverse
from ..models.tiramisu_train_fused import fused_apply_train
from ..ops.augment import AugmentDraws
from .checkpoint import load_weights
from .losses import adentropy, weighted_cross_entropy
from .optim import AdamW, SGDNesterov, lr_factors
from .schedules import cosine_annealing
from .supervised import SupervisedTrainer


class MMETrainer(SupervisedTrainer):
    """``SupervisedTrainer`` with MME's two-phase step.  ``opt`` is phase
    F's AdamW, ``opt_g`` phase G's SGD; both cover every parameter."""

    def __init__(self, *, lamda: float = 0.1, **kw):
        super().__init__(**kw)
        self.lamda = lamda
        # 1 on the feature extractor's parameters, 0 on the classifier's
        self.lr_mask_fe = lr_factors(
            self.model.named_parameters(),
            lambda name: name.startswith("featureExtractor."))
        self.opt_g = SGDNesterov(self.params, self.decay)

    # -- state ----------------------------------------------------------

    def lrs_at(self, epoch: int) -> tuple[float, float, float]:
        """(SGD lr of the feature extractor, SGD lr of the classifier,
        AdamW lr)."""
        eta_min = self.lr * 1e-3
        return (cosine_annealing(self.lr / 3, eta_min, 25, epoch),
                cosine_annealing(self.lr, eta_min, 25, epoch),
                cosine_annealing(self.lr, eta_min, 25, epoch))

    def from_pretrained(self, path: str) -> None:
        """Start from baseline weights (``.pt``, ``.msgpack`` or ``.npz``;
        reference train.py:58) with both optimizers fresh."""
        load_weights(path, self.model)
        self.opt = AdamW(self.params, self.decay)
        self.opt_g = SGDNesterov(self.params, self.decay)
        self._folded = None

    def state_dict(self) -> dict:
        """The model and both optimizers' states, copied to the CPU."""
        sd = super().state_dict()
        sd["optimizer"] = {"g": self.opt_g.state_dict(),
                           "f": sd["optimizer"]}
        return sd

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.opt_g.load_state_dict(state["optimizer"]["g"])
        self.opt.load_state_dict(state["optimizer"]["f"])
        self._folded = None

    # -- the step -------------------------------------------------------

    def default_step_fn(self, batch, generator: torch.Generator,
                        epoch: int) -> dict:
        (images_lab, labels), images_unl = batch
        return self.mme_train_step(images_lab, labels, images_unl,
                                   *self.lrs_at(epoch), generator=generator)

    def _forward_g(self, x: torch.Tensor, masks):
        """Phase G's forward: probabilities of the unlabelled batch with
        the gradient reversed between the feature extractor and the
        classifier, and the running-statistics updates."""
        if self.pallas_train:
            return fused_apply_train(self.model, x, masks,
                                     reverse_features=True)
        updates: dict = {}
        feats = self.model.featureExtractor(x, updates, iter(masks))
        return self.model.classifier(grad_reverse(feats),
                                     use_softmax=True), updates

    def _forward_f(self, x: torch.Tensor, masks):
        if self.pallas_train:
            return fused_apply_train(self.model, x, masks)
        return self.model(x, train=True, masks=masks)

    def mme_train_step(self, images_lab, labels, images_unl, lr_g_fe: float,
                       lr_g_cls: float, lr_f: float, *,
                       draws_l: AugmentDraws | None = None,
                       draws_u: AugmentDraws | None = None,
                       masks_g=None, masks_f=None,
                       generator: torch.Generator | None = None) -> dict:
        """One MME step on uint8 batches.  The draws (augmentation of each
        batch, each phase's Dropout2d masks) are taken from ``generator``
        where not given, in the JAX step's key order: ``draws_l``,
        ``draws_u``, ``masks_g``, ``masks_f``.  Returns ``{"tr_loss_adent",
        "tr_loss"}`` as 0-d tensors on the device."""
        self._require_trainable()
        generator = generator if generator is not None else torch.Generator()
        x_lab, y = self._train_input(images_lab, labels, draws_l, generator)
        x_unl, _ = self._train_input(images_unl, None, draws_u, generator)
        if masks_g is None:
            masks_g = drop_masks(generator, self.model, x_unl.shape[0],
                                 self.device)
        if masks_f is None:
            masks_f = drop_masks(generator, self.model, x_lab.shape[0],
                                 self.device)

        # phase G: entropy of the unlabelled batch through grad_reverse
        probs, upd_g = self._forward_g(x_unl, masks_g)
        loss_g = adentropy(probs, self.lamda)
        grads = torch.autograd.grad(loss_g, self.params)
        del probs
        self.opt_g.step(grads, [lr_g_fe * m + lr_g_cls * (1.0 - m)
                                for m in self.lr_mask_fe])
        del grads
        apply_batch_stats(self.model, upd_g)

        # phase F: weighted cross entropy of the labelled batch, at the
        # post-G parameters and running statistics
        out, upd_f = self._forward_f(x_lab, masks_f)
        loss_f = weighted_cross_entropy(out, y, self.num_cls)
        grads = torch.autograd.grad(loss_f, self.params)
        self.opt.step(grads, lr_f)
        apply_batch_stats(self.model, upd_f)
        self._folded = None
        return {"tr_loss_adent": loss_g.detach(), "tr_loss": loss_f.detach()}
