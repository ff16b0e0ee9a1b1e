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
  K3b on CUDA tensors); with ``fast_train`` (and not ``pallas_train``)
  the segment-wise ``models.tiramisu_fast.fast_apply_train``; else the
  plain module with autograd.
- ``eval_step``: the plain module in eval mode, unweighted cross entropy
  and the batch metrics.
- ``predict_step``/``predict_step_fused``: uint8 frames to class maps.

The model is an FC-DenseNet, a LaneNetLite (``--arch lite``) or an
EncDecNet (``--arch encdec``), whose train modes share the FC-DenseNet's
call interface; ``pallas_train`` takes an FC-DenseNet only, and
``fast_train`` applies to an FC-DenseNet only, as in JAX.

With a ``world`` (``core.mesh.World``) the steps are data-parallel over
its ranks (``parallel.dp``): each rank steps on its rows of the global
batch, with the global batch's statistics, losses and summed gradients,
and its rows of the global batch's draws; the logged values are the
global batch's.  ``eval_step`` splits each batch over the ranks and
gathers the outputs, so its metrics are the whole batch's.

The random draws are operands: the augmentation's (``ops.augment.
AugmentDraws``) and the Dropout2d masks (``models.tiramisu.drop_masks``;
none for LaneNetLite).
When a step is not given them it draws them from an explicit
``torch.Generator``, augmentation first, then dropout (the JAX step's
``k_aug, k_drop`` order).

``run_scan_chunk`` is the multi-step dispatch over a device-resident split
(``data.device_cache``), the counterpart of the JAX ``train_steps_scan``:
K steps, step k on the rows ``idx[k]`` gathered on the device, with the
same batches, draws and values as K ``train_step`` calls.  On a card the
whole step (gather, augmentation, forward, loss, gradients, optimizer,
running statistics) is captured once as a CUDA graph (``train.graphs``)
and replayed once a step; the draws are made outside it, in the same
order, and written into its static buffers.  A failed capture or replay
raises.  On the CPU the same steps run eagerly.

Spans (``core.tracing``): ``run_scan_chunk`` is one ``train.chunk``, and
each of its steps a ``train.draw`` (the step's draws) then, on a card,
``train.stage`` (its indices and draws written into the graph's static
buffers) and ``train.replay`` (the replay's enqueue), or on the CPU
``train.step``; each carries the step's index (``steps_run`` at its
start).  ``predict_step_fused`` is ``serve.upload`` (the frames to the
device) and ``serve.launch`` (normalisation, the fused forward and the
argmax, enqueued).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.dtypes import DEFAULT_POLICY, DTypePolicy
from ..core.runtime import resolve_device
from ..core.tracing import span
from ..data.device_cache import to_device_index
from ..kernels import train_block
from ..models.tiramisu import (FCDenseNet, apply_batch_stats,
                               draw_drop_masks, fcdensenet67, grad_reverse,
                               split_masks)
from ..models.tiramisu_fast import fast_apply_train
from ..models.tiramisu_fused import FoldedModel, fold_model, fused_apply
from ..models.tiramisu_train_fused import fused_apply_train
from ..ops.augment import (AugmentConfig, AugmentDraws, augment_batch,
                           draw_augment, eval_batch)
from ..ops.metrics import accuracy, evaluate_outputs
from ..parallel import dp
from ..parallel.sharding import gather_rows, rank_rows, replicate_
from . import optim
from .graphs import StepGraph
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
                 fast_train: bool = False, world=None, device=None):
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
        self.fast_train = (fast_train and not pallas_train
                           and isinstance(model, FCDenseNet))
        self.world = world
        if world is not None:
            replicate_(self.model, world)
        self.params = list(self.model.parameters())
        self.opt = AdamW(self.params, decay)
        self._folded: FoldedModel | None = None
        # the step run_scan_chunk captured on a card, its static inputs,
        # and what it was captured over
        self.graph: StepGraph | None = None
        self._static = None
        self._graph_key = None
        self.steps_run = 0  # steps run through run_scan_chunk

    # -- state ----------------------------------------------------------

    def lr_at(self, epoch: int) -> float:
        return cosine_annealing(self.lr, self.lr / self.lr_ratio, 25, epoch)

    def optimizers(self) -> list:
        return [self.opt]

    def set_decay(self, decay: float) -> None:
        """The weight decay of every optimizer: a device operand, so a
        captured step replays with the value set since."""
        self.decay = decay
        for opt in self.optimizers():
            opt.set_weight_decay(decay)

    def reset_optimizers(self) -> None:
        """Every optimizer's state to its initial values, in place (a
        captured step stays valid)."""
        for opt in self.optimizers():
            opt.reset()

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

    def _to_device(self, a) -> torch.Tensor | None:
        return to_device(a, self.device)

    def _batch(self, images, labels, draws: AugmentDraws | None = None):
        return model_batch(images, labels, self.cfg, draws)

    def _global(self, n: int) -> int:
        """The global batch of ``n`` rows a rank."""
        return n * (self.world.size if self.world is not None else 1)

    def _draw_augment(self, generator, n: int, draws):
        """The augmentation's draws (None without ``augment``), from
        ``generator`` where not given (a rank's rows of the global
        batch's)."""
        if not self.augment:
            return None
        if draws is not None:
            return draws
        draws = draw_augment(generator, self._global(n), self.cfg,
                             self.device)
        if self.world is None:
            return draws
        return AugmentDraws(*(rank_rows(t, self.world) for t in draws))

    def _draw_masks(self, generator, n: int, masks) -> torch.Tensor:
        """The flat Dropout2d masks (``draw_drop_masks``, pinned for a
        card), from ``generator`` where not given (a rank's rows of the
        global batch's)."""
        pin = self.device.type == "cuda"
        if masks is None:
            size = (self.cfg.height, self.cfg.width)
            flat = draw_drop_masks(generator, self.model, self._global(n),
                                   pin=pin and self.world is None, size=size)
            if self.world is None:
                return flat
            masks = [rank_rows(m, self.world) for m in split_masks(
                flat, self.model, self._global(n), size)]
        elif isinstance(masks, torch.Tensor):
            return masks
        flat = torch.cat([m.reshape(-1) for m in masks])
        return flat.pin_memory() if pin and self.world is not None else flat

    def _draw(self, generator, n: int, draws, masks) -> tuple:
        """A step's draws: augmentation first, then dropout."""
        draws = self._draw_augment(generator, n, draws)
        return draws, self._draw_masks(generator, n, masks)

    def _masks(self, flat: torch.Tensor, n: int) -> list[torch.Tensor]:
        return split_masks(flat.to(self.device, non_blocking=True),
                           self.model, n, (self.cfg.height, self.cfg.width))

    # -- steps ----------------------------------------------------------

    def _forward(self, x: torch.Tensor, masks, reverse_features=False):
        """The train-mode forward: (output, running-statistics updates).
        ``reverse_features`` (MME's phase G) reverses the gradient between
        the features and the classifier."""
        if self.pallas_train:
            return fused_apply_train(self.model, x, masks,
                                     reverse_features=reverse_features)
        if self.fast_train:
            return fast_apply_train(self.model, x, masks,
                                    reverse_features=reverse_features)
        if not reverse_features:
            return self.model(x, train=True, masks=masks)
        updates: dict = {}
        feats = self.model.featureExtractor(x, updates, iter(masks))
        return self.model.classifier(grad_reverse(feats),
                                     use_softmax=True), updates

    def _step(self, images, labels, draws, masks) -> torch.Tensor:
        """One AdamW step, at the rate set in ``opt``, on uint8 batches on
        the device; ``masks`` flat.  Returns [tr_loss, tr_acc]."""
        with dp.active(self.world):
            x, y = self._batch(images, labels, draws)
            masks = self._masks(masks, x.shape[0])
            out, new_bs = self._forward(x, masks)
            loss = weighted_cross_entropy(out, y, self.num_cls)
            grads = dp.reduce_grads(torch.autograd.grad(loss, self.params))
            self.opt.step(grads)
            apply_batch_stats(self.model, new_bs)
            pred = torch.argmax(out.detach(), dim=1)
            return dp.all_sum(torch.stack(
                [loss.detach(), dp.share(accuracy(pred, y)) * 100.0]))

    def train_step(self, images, labels, lr: float, *,
                   draws: AugmentDraws | None = None, masks=None,
                   generator: torch.Generator | None = None) -> dict:
        """One AdamW step on a uint8 batch.  ``draws``: the augmentation's
        draws (used with ``augment``); ``masks``: the Dropout2d masks in
        site order; each drawn from ``generator`` when not given.  Returns
        ``{"tr_loss", "tr_acc"}`` as 0-d tensors on the device."""
        generator = generator if generator is not None else torch.Generator()
        inputs = self._draw(generator, len(images), draws, masks)
        self.opt.set_lr(lr)
        logs = self._step(self._to_device(images), self._to_device(labels),
                          *inputs)
        self._folded = None
        return dict(zip(self.scan_logs, logs.unbind()))

    def default_step_fn(self, batch, generator: torch.Generator,
                        epoch: int) -> dict:
        """The fit loop's per-batch step."""
        images, labels = batch
        return self.train_step(images, labels, self.lr_at(epoch),
                               generator=generator)

    # -- the multi-step dispatch over a device-resident split -----------

    scan_logs = ("tr_loss", "tr_acc")

    def _set_epoch_rates(self, epoch: int) -> None:
        self.opt.set_lr(self.lr_at(epoch))

    def _scan_draw(self, generator, b: int, given: dict):
        return self._draw(generator, b, given.get("draws"),
                          given.get("masks"))

    def _scan_step(self, arrays, idx: torch.Tensor, inputs) -> torch.Tensor:
        """One step on the rows ``idx`` ([B]) of ``arrays`` = (images,
        labels)."""
        images, labels = arrays
        return self._step(images.index_select(0, idx),
                          labels.index_select(0, idx), *inputs)

    def _written(self) -> list[torch.Tensor]:
        """Every tensor a step writes in place."""
        return [*self.params, *self.model.buffers(), *self.opt.tensors()]

    def run_scan_chunk(self, arrays, idx_chunk, generator: torch.Generator,
                       epoch: int, draws=None) -> dict:
        """K steps over the device-resident split ``arrays`` (images,
        labels; MME: labelled images, labels, unlabelled images): step k
        on the rows ``idx_chunk[k]`` ([K, B]; MME [K, 2, B]), at epoch
        ``epoch``'s rates, its draws from ``generator`` in the per-batch
        order.  ``draws``: per step, a dict of the step's draw keywords to
        use instead (``draws``/``masks``; MME ``draws_l``, ``draws_u``,
        ``masks_g``, ``masks_f``).  On a card every step is one replay of
        the captured step.  Returns ``{name: [K] tensor}`` on the device,
        one column of one [K, n] tensor per logged scalar."""
        with span("train.chunk", step=self.steps_run, steps=len(idx_chunk)):
            self._set_epoch_rates(epoch)
            idx = to_device_index(idx_chunk, self.device)
            logs = torch.empty(len(idx), len(self.scan_logs),
                               device=self.device)
            for k in range(len(idx)):
                step = self.steps_run
                with span("train.draw", step=step):
                    inputs = self._scan_draw(
                        generator, idx.shape[-1],
                        draws[k] if draws is not None else {})
                if self.device.type == "cuda":
                    logs[k].copy_(self._replay(arrays, idx[k], inputs, step))
                else:
                    with span("train.step", step=step):
                        logs[k] = self._scan_step(arrays, idx[k], inputs)
                self.steps_run += 1
            self._folded = None
            return dict(zip(self.scan_logs, logs.unbind(1)))

    def _replay(self, arrays, idx: torch.Tensor, inputs,
                step: int) -> torch.Tensor:
        """Write a step's inputs into the graph's static buffers and
        replay it; capture it first if there is none for these arrays,
        this batch and these optimizers."""
        # what the graph reads (held, so that it outlives the graph) and
        # the batch's shape
        key = (*arrays, self.opt, getattr(self, "opt_g", None),
               tuple(idx.shape))
        if not _same(key, self._graph_key):
            self.graph = self._static = self._graph_key = None
            static_idx = idx.clone()
            static = _to_static(inputs, self.device)
            self.graph = StepGraph(
                lambda: self._scan_step(arrays, static_idx, static),
                self._written(), _step_counts)
            self._static, self._graph_key = (static_idx, static), key
        static_idx, static = self._static
        with span("train.stage", step=step):
            static_idx.copy_(idx)
            _copy_static(static, inputs)
        with span("train.replay", step=step):
            return self.graph.replay()

    @torch.inference_mode()
    def eval_step(self, images, labels) -> dict:
        """Unweighted cross entropy and metrics of the plain module in eval
        mode, each pre-multiplied by the batch size."""
        x, y = self._batch(self._to_device(images), self._to_device(labels))
        world = self.world
        if world is None or len(x) % world.size:
            out = self.model(x)  # a batch that does not split: every rank
        else:
            out = gather_rows(self.model(rank_rows(x, world)), world)
        return evaluate_outputs(out, y, cross_entropy(out, y), self.num_cls)

    def _input(self, images) -> torch.Tensor:
        return self._batch(self._to_device(images), None)[0]

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
        with span("serve.upload"):
            images = self._to_device(images)
        with span("serve.launch"):
            out = fused_apply(self.model, self._batch(images, None)[0],
                              self._folded, use_softmax=False)
            return torch.argmax(out, dim=1).to(torch.uint8)


def to_device(a, device) -> torch.Tensor | None:
    """A numpy array or tensor (or None) as a tensor on ``device``."""
    if a is None:
        return None
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device)


def model_batch(images, labels, cfg: AugmentConfig,
                draws: AugmentDraws | None = None):
    """uint8 NHWC frames (+ labels) on the device -> NCHW float32 input,
    int64 labels; through ``augment_batch`` when ``draws`` are given."""
    if draws is None:
        x, y = eval_batch(images, labels, cfg, with_labels=labels is not None)
    else:
        x, y = augment_batch(images, labels, cfg, draws.to(images.device),
                             with_labels=labels is not None)
    x = x.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW, once
    return x, (None if y is None else y.to(torch.int64))


def _step_counts() -> dict:
    """What a step's launches move (``StepGraph`` puts what its capture
    moved on its span): K1-K3b's launches, all and at small planes, K3a's
    own-layer items, all and prefetched, and the optimizers' operations."""
    return {**train_block.step_launches(), **optim.counts}


def _to_static(inputs, device) -> tuple:
    """A device copy of a step's inputs (None, tensors, AugmentDraws), the
    graph's static buffers."""
    return tuple(None if t is None
                 else AugmentDraws(*(f.to(device, copy=True) for f in t))
                 if isinstance(t, AugmentDraws)
                 else t.to(device, copy=True) for t in inputs)


def _copy_static(static: tuple, inputs) -> None:
    """Write a step's inputs into the static buffers (host-pinned masks
    asynchronously: the pinned block is not reused before its copy ran)."""
    for dst, src in zip(static, inputs, strict=True):
        if dst is None:
            continue
        for d, s in zip(dst if isinstance(dst, AugmentDraws) else (dst,),
                        src if isinstance(src, AugmentDraws) else (src,),
                        strict=True):
            d.copy_(s, non_blocking=True)


def _same(key: tuple, other: tuple | None) -> bool:
    """Whether a graph captured over ``other`` serves ``key``: the same
    objects, and equal shapes."""
    return other is not None and len(key) == len(other) and all(
        a == b if isinstance(a, tuple) else a is b
        for a, b in zip(key, other))
