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
``grad_reverse`` on the head's input.  With ``fast_train`` both run the
segment-wise forward (``models.tiramisu_fast``).  Otherwise phase G runs
the model's ``featureExtractor``, ``grad_reverse`` and its
``classifier`` (an FC-DenseNet or a LaneNetLite; EncDecNet has no such
split and is refused, as the JAX trainer fails on it).  With a ``world``
both phases are data-parallel (``SupervisedTrainer``).

``run_scan_chunk`` (``SupervisedTrainer``'s) runs K MME steps over the
device-resident splits, the counterpart of the JAX
``mme_train_steps_scan``: on a card one CUDA graph holds both phases and
the running-statistics write between them, replayed once a step.
"""
from __future__ import annotations

import torch

from ..models.tiramisu import apply_batch_stats
from ..ops.augment import AugmentDraws
from ..parallel import dp
from .checkpoint import load_weights
from .losses import adentropy, weighted_cross_entropy
from .optim import SGDNesterov, lr_factors
from .schedules import cosine_annealing
from .supervised import SupervisedTrainer


class MMETrainer(SupervisedTrainer):
    """``SupervisedTrainer`` with MME's two-phase step.  ``opt`` is phase
    F's AdamW, ``opt_g`` phase G's SGD; both cover every parameter."""

    def __init__(self, *, lamda: float = 0.1, **kw):
        super().__init__(**kw)
        if not hasattr(self.model, "featureExtractor"):
            raise ValueError(
                f"MME reverses the gradient between a featureExtractor and "
                f"a classifier; {type(self.model).__name__} has none")
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

    def optimizers(self) -> list:
        return [self.opt_g, self.opt]

    def from_pretrained(self, path: str) -> None:
        """Start from baseline weights (``.pt``, ``.msgpack`` or ``.npz``;
        reference train.py:58) with both optimizers fresh."""
        load_weights(path, self.model)
        self.reset_optimizers()
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

    def _mme_step(self, images_lab, labels, images_unl, draws_l, draws_u,
                  masks_g, masks_f) -> torch.Tensor:
        """One MME step, at the rates set in both optimizers, on uint8
        batches on the device; masks flat.  Returns [tr_loss_adent,
        tr_loss]."""
        with dp.active(self.world):
            x_lab, y = self._batch(images_lab, labels, draws_l)
            x_unl, _ = self._batch(images_unl, None, draws_u)

            # phase G: entropy of the unlabelled batch through
            # grad_reverse
            probs, upd_g = self._forward(
                x_unl, self._masks(masks_g, x_unl.shape[0]),
                reverse_features=True)
            loss_g = adentropy(probs, self.lamda)
            grads = dp.reduce_grads(torch.autograd.grad(loss_g,
                                                        self.params))
            del probs
            self.opt_g.step(grads)
            del grads
            apply_batch_stats(self.model, upd_g)

            # phase F: weighted cross entropy of the labelled batch, at
            # the post-G parameters and running statistics
            out, upd_f = self._forward(x_lab,
                                       self._masks(masks_f, x_lab.shape[0]))
            loss_f = weighted_cross_entropy(out, y, self.num_cls)
            grads = dp.reduce_grads(torch.autograd.grad(loss_f,
                                                        self.params))
            self.opt.step(grads)
            apply_batch_stats(self.model, upd_f)
            return dp.all_sum(torch.stack([loss_g.detach(),
                                           loss_f.detach()]))

    def _mme_draw(self, generator, n_lab: int, n_unl: int, draws_l, draws_u,
                  masks_g, masks_f) -> tuple:
        """The step's draws in the JAX key order: ``draws_l``, ``draws_u``,
        ``masks_g``, ``masks_f``, each where not given."""
        draws_l = self._draw_augment(generator, n_lab, draws_l)
        draws_u = self._draw_augment(generator, n_unl, draws_u)
        masks_g = self._draw_masks(generator, n_unl, masks_g)
        return (draws_l, draws_u, masks_g,
                self._draw_masks(generator, n_lab, masks_f))

    def _set_rates(self, lr_g_fe: float, lr_g_cls: float,
                   lr_f: float) -> None:
        self.opt_g.set_lrs([lr_g_fe * m + lr_g_cls * (1.0 - m)
                            for m in self.lr_mask_fe])
        self.opt.set_lr(lr_f)

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
        generator = generator if generator is not None else torch.Generator()
        inputs = self._mme_draw(generator, len(images_lab), len(images_unl),
                                draws_l, draws_u, masks_g, masks_f)
        self._set_rates(lr_g_fe, lr_g_cls, lr_f)
        logs = self._mme_step(self._to_device(images_lab),
                              self._to_device(labels),
                              self._to_device(images_unl), *inputs)
        self._folded = None
        return dict(zip(self.scan_logs, logs.unbind()))

    # -- the multi-step dispatch (SupervisedTrainer.run_scan_chunk) -----

    scan_logs = ("tr_loss_adent", "tr_loss")

    def _set_epoch_rates(self, epoch: int) -> None:
        self._set_rates(*self.lrs_at(epoch))

    def _scan_draw(self, generator, b: int, given: dict):
        return self._mme_draw(generator, b, b, given.get("draws_l"),
                              given.get("draws_u"), given.get("masks_g"),
                              given.get("masks_f"))

    def _scan_step(self, arrays, idx: torch.Tensor, inputs) -> torch.Tensor:
        """One step on labelled rows ``idx[0]`` and unlabelled rows
        ``idx[1]`` of ``arrays`` = (labelled images, labels, unlabelled
        images)."""
        lab_img, lab_lab, unl_img = arrays
        return self._mme_step(lab_img.index_select(0, idx[0]),
                              lab_lab.index_select(0, idx[0]),
                              unl_img.index_select(0, idx[1]), *inputs)

    def _written(self) -> list[torch.Tensor]:
        return [*super()._written(), *self.opt_g.tensors()]
