"""Knowledge distillation: a frozen teacher -> the LaneNetLite student.

Counterpart of ``sim2real_lane_segment_tpu.train.distill``.  One step:
the batch augmented on the device, the teacher's eval-mode logits
(frozen, no gradient), the student's train-mode forward, and

    loss = alpha * KD + (1 - alpha) * weighted CE(student[:n_lab], y)
    KD   = -mean over pixels of sum over classes of
           softmax(t / T) * log_softmax(s / T), times T^2

(the class axis is dim 1, NCHW), then AdamW at the step's rate and the
student's running statistics.

``train_step_unl`` takes the MME-style batch ``((x_lab, y), x_unl)``
(``data.modules.TwoDomainMMEDataModule``): one train-mode student forward
over ``[x_lab; x_unl]``, so the batch statistics span both halves; KD
covers every row and CE the labelled rows only.  That distills an adapted
teacher on target-looking frames (the JAX module's docstring has why).

The teacher: on a card an FC-DenseNet runs the fused inference forward
(``models.tiramisu_fused.fused_apply``, kernel K4), its weights folded
once when the trainer is built; a K4 that does not build or launch
raises.  On the CPU, and for a LaneNetLite teacher (no kernel computes a
float LaneNetLite forward), the teacher is its plain eval module.

The augmentation's draws are tensors (``ops.augment.AugmentDraws``),
drawn from an explicit ``torch.Generator`` where a step is not given
them: the labelled half's, then the unlabelled half's.  There is no
multi-step dispatch (``run_scan_chunk``), as in JAX: ``train.loop.fit``
runs the per-batch loop for this trainer.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.dtypes import DEFAULT_POLICY, DTypePolicy
from ..core.runtime import resolve_device
from ..models.lanenet_lite import LaneNetLite
from ..models.tiramisu import FCDenseNet, apply_batch_stats
from ..models.tiramisu_fused import fold_model, fused_apply
from ..ops.augment import AugmentConfig, AugmentDraws, draw_augment
from ..ops.metrics import evaluate_outputs
from .losses import cross_entropy, weighted_cross_entropy
from .optim import AdamW
from .schedules import cosine_annealing
from .supervised import model_batch, to_device


class DistillTrainer:
    """Owns the frozen teacher, the student and its AdamW state (on
    ``device``, which defaults to ``cuda`` and raises without a card)."""

    def __init__(self, *, teacher: nn.Module, num_cls: int = 4,
                 lr: float = 1e-3, decay: float = 1e-4,
                 lr_ratio: float = 1e3, temperature: float = 2.0,
                 alpha: float = 0.7, height: int = 120, width: int = 160,
                 augment: bool = True, policy: DTypePolicy = DEFAULT_POLICY,
                 student_model: nn.Module | None = None, t_max: int = 25,
                 device=None):
        self.device = resolve_device(device)
        self.teacher = teacher.to(self.device).eval()
        self.student = (student_model if student_model is not None else
                        LaneNetLite(n_classes=num_cls, policy=policy)
                        ).to(self.device).eval()
        self.num_cls = num_cls
        self.lr, self.decay, self.lr_ratio = lr, decay, lr_ratio
        self.t_max = t_max
        self.temperature, self.alpha = temperature, alpha
        self.augment = augment
        self.cfg = AugmentConfig(height=height, width=width,
                                 min_crop_height=height // 2,
                                 max_crop_height=height * 4)
        self.params = list(self.student.parameters())
        self.opt = AdamW(self.params, decay)
        # the teacher never changes: K4's operands are folded once
        self._folded = (fold_model(self.teacher)
                        if self.device.type == "cuda"
                        and isinstance(self.teacher, FCDenseNet) else None)

    # -- state ----------------------------------------------------------

    def lr_at(self, epoch: int) -> float:
        """torch's CosineAnnealingLR with ``t_max``: past it the rate rises
        again, so ``t_max`` should be the fit's epochs."""
        return cosine_annealing(self.lr, self.lr / self.lr_ratio,
                                self.t_max, epoch)

    def state_dict(self) -> dict:
        """The student and its optimizer state, copied to the CPU."""
        return {"model": {k: v.to("cpu", copy=True)
                          for k, v in self.student.state_dict().items()},
                "optimizer": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.student.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])

    # -- steps ----------------------------------------------------------

    def _prepare(self, images, labels, draws):
        return model_batch(to_device(images, self.device),
                           to_device(labels, self.device), self.cfg, draws)

    def _draw(self, generator, n: int, draws):
        if not self.augment:
            return None
        return (draw_augment(generator, n, self.cfg, self.device)
                if draws is None else draws)

    @torch.no_grad()
    def teacher_logits(self, x: torch.Tensor) -> torch.Tensor:
        """The frozen teacher's eval-mode logits of NCHW ``x``."""
        if self._folded is not None:
            return fused_apply(self.teacher, x, self._folded,
                               use_softmax=False)
        return self.teacher(x, use_softmax=False)

    def _step(self, x: torch.Tensor, y: torch.Tensor, n_lab: int) -> dict:
        t = self.temperature
        t_soft = torch.softmax(self.teacher_logits(x) / t, dim=1)
        out, new_bs = self.student(x, train=True, use_softmax=False)
        s_logp = torch.log_softmax(out / t, dim=1)
        kd = -torch.mean(torch.sum(t_soft * s_logp, dim=1)) * t * t
        ce = weighted_cross_entropy(out[:n_lab], y, self.num_cls)
        loss = self.alpha * kd + (1.0 - self.alpha) * ce
        grads = torch.autograd.grad(loss, self.params)
        self.opt.step(grads)
        apply_batch_stats(self.student, new_bs)
        return {"tr_loss": loss.detach(), "tr_kd": kd.detach(),
                "tr_ce": ce.detach()}

    def train_step(self, images, labels, lr: float, *,
                   draws: AugmentDraws | None = None,
                   generator: torch.Generator | None = None) -> dict:
        """One step on a labelled uint8 batch; ``draws`` (used with
        ``augment``) from ``generator`` where not given.  Returns
        ``{"tr_loss", "tr_kd", "tr_ce"}`` as 0-d tensors on the device."""
        generator = generator if generator is not None else torch.Generator()
        draws = self._draw(generator, len(images), draws)
        self.opt.set_lr(lr)
        x, y = self._prepare(images, labels, draws)
        return self._step(x, y, x.shape[0])

    def train_step_unl(self, images, labels, images_unl, lr: float, *,
                       draws_l: AugmentDraws | None = None,
                       draws_u: AugmentDraws | None = None,
                       generator: torch.Generator | None = None) -> dict:
        """KD over ``[labelled; unlabelled]``, CE over the labelled rows;
        the draws of the labelled half, then the unlabelled half's."""
        generator = generator if generator is not None else torch.Generator()
        draws_l = self._draw(generator, len(images), draws_l)
        draws_u = self._draw(generator, len(images_unl), draws_u)
        self.opt.set_lr(lr)
        x_lab, y = self._prepare(images, labels, draws_l)
        x_unl, _ = self._prepare(images_unl, None, draws_u)
        return self._step(torch.cat([x_lab, x_unl]), y, x_lab.shape[0])

    def default_step_fn(self, batch, generator: torch.Generator,
                        epoch: int) -> dict:
        """The fit loop's per-batch step: ``(x, y)``, or the MME-style
        ``((x_lab, y), x_unl)`` through ``train_step_unl``."""
        if len(batch) == 2 and isinstance(batch[0], tuple):
            (images, labels), images_unl = batch
            return self.train_step_unl(images, labels, images_unl,
                                       self.lr_at(epoch),
                                       generator=generator)
        images, labels = batch
        return self.train_step(images, labels, self.lr_at(epoch),
                               generator=generator)

    @torch.inference_mode()
    def eval_step(self, images, labels) -> dict:
        """The student's softmax output, scored as ``SupervisedTrainer.
        eval_step`` scores its model."""
        x, y = self._prepare(images, labels, None)
        out = self.student(x)
        return evaluate_outputs(out, y, cross_entropy(out, y), self.num_cls)
