#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout, one card

Drives the port's main paths and holds every kernel of those paths
against its plain PyTorch version: FCDenseNet67 at full width (3,461,220
parameters, 120x160 frames, random weights made from a seed) serving
(``cli.serve.build_predict_fn --arch 67 --fused`` behind
``serving.BatchingEngine``, kernel K4), training (``cli.train.main
--trainType sim --arch 67 --pallas_train``, kernels K1, K2, K3a, K3b),
the two-domain regimes with augmentation (``--trainType st`` and ``mme``
``--augment --pallas_train``; MME runs K1-K3b twice a step, phase G on a
reversed cotangent) and evaluation (``cli.test.main -t mme --fused``);
LaneNetLite serving from the committed student
(``artifacts/lanenet_lite_sim.msgpack``, ``--arch lite [--int8
[--fused]]``, kernel K6); and label extraction
(``ops.labelgen.process_classes_batch`` on CUDA tensors, kernel K5);
and the HM and CycleGAN regimes (``cli.hist_match``,
``cli.train_cyclegan``, ``cli.sim2real_convert``, then ``--trainType st
--pallas_train`` and ``cli.test --fused``) and ``cli.domain_study``;
and data generation at the recording size (``cli.datagen`` rendering
expert rollouts on the card, ``cli.postprocess`` labelling them through
K5, ``cli.preprocess_db``, then ``cli.train`` on the rendered tree, and
the study rendering its missing domains); and the interactive simulator
(``sim.env.DuckietownEnv`` at 640x480 with NPCs), the learning demos and
the video CLIs (``cli.make_demo_video --fused`` through K4,
``cli.comparison``); and the kernel diagnostics (``cli.serve_breakdown``,
``cli.train_breakdown``, ``cli.train_benchmark``) and the real-domain
ingestion path (``cli.create_real_db``, ``cli.preprocess_db --dbType
real``, an MME step on the real target; ``cli.get_real_data``,
``cli.plot_lr``); and the JAX package's FFV1 recordings through the
port's own FFV1 codec (``data/ffv1.py`` over ``csrc/ffv1.cpp``, host
code) into ``cli.postprocess`` (K5).
Phases:

1. device: requires CUDA, prints the card's name and power limit;
2. build: builds the four kernel sources from ``csrc/`` with nvcc and the
   FFV1 codec (``csrc/ffv1.cpp``) with the host's C++ compiler, at once;
   prints ptxas's registers and spills per kernel (the classifier's and
   K5's on a line of their own, and on another those of the kernels of
   the shared 3x3 body: serving's, K1's and the two ``--ablate``
   variants, each at growth 16 and 12) and counts the tensor-core
   instructions of the tensor-core kernels (HGMMA, HMMA: the bf16 dense
   layer and its two variants, TransitionDown, classifier, K1, K2, K3a
   and K3b, the dense-layer ones per growth; IMMA: K6's conv);
3. K4 against plain: all 11 dense blocks at their real widths (B=8,
   120x160), in float32 (TF32 off) and in bfloat16; every bfloat16 dense
   layer must take the tensor-core route, no float32 one (the routes as
   the C library reports them with each launch);
4. serve: 4 client threads x 8 requests of 1-16 frames through the engine
   (max_batch=64); checks every reply, the kernels' launch counts (every
   dense layer on the tensor cores), and pixel agreement with the plain
   module on the card;
5. K4 timing: the bfloat16 dense layers of all 11 blocks at B=64 against
   plain again (the block chain and each layer alone, at phase 3's
   tolerances), where the small planes split their channel loop; CUDA
   events around a B=64 fused forward and around each kernel's launches,
   beside the plain versions, the cuDNN yardsticks and the least time the
   card could take (bound); the dense layer per resolution with the splits
   the launches reported; the classifier against plain at B=64 on every
   block's features (a seeded classifier of the block's width, the real one
   on the last block) and on a buffer with all-zero pixels (LOGIT_ATOL),
   and its device time by torch.profiler; fails if the dense layer or the
   classifier exceeds MAX_FWD_MS;
6. K1-K3b against plain: every call of one fused train step (B=4; all 60
   consumer sites, 55 stages, 11 block inputs) in float32 and bfloat16,
   with a channel of every dropout site dropped for the whole batch and
   zero BN shifts, so z == 0 planes occur; every bfloat16 site must take
   the tensor-core route, no float32 one;
7. gradients: plain autograd and ``fused_apply_train`` (both backward
   routes) in float32 against the plain train forward plus autograd in
   float64, whole model, B=4, with the bfloat16 fused step as a control;
8. train: two epochs of ``cli.train.main --pallas_train -b 32`` on a
   synthetic PNG tree written from the seed (96/32/32 frames); checks the
   losses, the launch counts per step, that no plain version ran, serves
   ``best_weights.pt`` and resumes at epoch 2;
9. train timing: every kernel call of one B=32 train step against its
   plain version (bfloat16; K3a twice, bit-equal), the B=32 step against
   the plain autograd step, and each train kernel's time per step beside
   its plain version, a cuDNN yardstick and its bound (K1 also split into
   its 3x3 and 1x1 launches); fails if K3a or K1 exceeds MAX_STEP_MS;
10. K6 against plain: the student's int8 body at full width, B=8 and
    B=64 (more (image, tile) items than persistent blocks), calibrated as
    ``cli.serve --int8`` does; every conv site's int8 codes equal, logits
    within the f32 head's reordering, all 12 conv sites on the int8 tensor
    cores;
11. serve LaneNetLite: float, ``--int8`` and ``--int8 --fused`` behind the
    engine (4 clients x 8 requests of 1-16 frames); checks every reply,
    K6's launches (1/12/1 per batch, the 12 on the tensor cores), that its
    plain version never ran, and fused vs plain int8 pixel agreement
    (>= 99.9%);
12. K5 against plain: ``process_classes_batch`` on B=32 seeded pairs at
    480x640 and 120x160 in both channel orders, bit-exact; then (after the
    launch count) two 1080x1920 pairs, two column tiles a strip;
13. timing: K6 per B=64 forward (fails above MAX_FWD_MS) and K5 per B=32
    480x640 batch (fails if its device time exceeds MAX_LABEL_MS) beside
    their plain versions and bounds, the device time of K5, K6 and the
    classifier by torch.profiler beside their event readings, and the
    whole LaneNetLite forwards (int8 through K6, plain int8, float bf16)
    at B=64;
14. the MME step: one augmented step of FCDenseNet67 at B=32 (both
    batches augmented on the card, each phase's masks with channel 0 of
    every site dropped) in float32 and bfloat16, through the plain
    versions with every K1, K2, K3a and K3b call of both phases also run
    through its kernel and held against the plain result (phase G's
    negated entropy cotangent included), then through the kernels alone
    from the same state, draws and masks: the launches (120/10/110/22 per
    step, all on the tensor-core route in bfloat16), both losses, both
    stages of the running statistics, both optimizers' gradients and the
    updated parameters against the plain step (MME_STEP_TOL);
15. the two-domain CLIs: ``--trainType st`` and then ``mme`` (from
    phase 8's ``best_weights.pt``), ``--augment --pallas_train -b 32``, one
    epoch each on a synthetic tree (source 64, target/train 32,
    target/test 32, target/unlabelled 96); checks the steps, finite
    losses, the launches (one and two passes a step) and that no plain
    version ran; then ``cli.test.main -t mme --fused`` on the MME run's
    weights (metrics, the confusion matrix, K4's launches);
16. timing: the B=32 MME step through the kernels against the plain step
    (CUDA events, medians of REPS steps in turns), its device busy time
    and idle share (torch.profiler), and ``augment_batch`` and
    ``draw_augment`` at B=32 from 120x160 and 480x640 sources;
17. ``--device_cache``: ``cli.train.main --augment --pallas_train -b 32``
    with and without it, 2 epochs of 4 steps each for ``sim``, ``st``
    and ``mme`` (from phase 8's weights): every logged row and the final
    weights, running statistics and optimizer state bit-equal, one graph
    replay a step, captured once, the kernels launched (all on the
    tensor-core route) only while capturing; then a 1,536-frame 480x640
    split uploaded through ``DeviceCachedView`` (time, bytes), the
    graphed supervised step against the eager step over the same cache
    and over host batches, the graphed MME step against the eager one
    (medians of 20, in turns), one replay's kernels against one eager
    step's by name (torch.profiler), and each graph's device busy time,
    idle share and private pool;
18. the HM and CycleGAN regimes and the domain study: (a) the cv2-free
    resamplers (``resize_cubic_u8`` 480x640 -> 120x160,
    ``resize_lanczos4_u8`` back) at B=16 on the card, bit-equal to the
    CPU; (b) ``cli.hist_match.main`` on 48 + 48 seeded 480x640 frames,
    every matched frame equal to ``match_histograms_batch`` on the CPU,
    matched frames/s on the card and through the CLI; (c) the CycleGAN
    generator at full width (11,378,179 parameters, B=4, float32) against
    itself in float64 on the card, and one ``CycleGANTrainer.train_step``
    against the same step on the CPU; (d) ``cli.train_cyclegan.main``, 2
    epochs on 64/64 frames at B=4, the B=4 step's median time and idle
    share, then ``cli.sim2real_convert.main`` over 32 frames (frames/s,
    every frame rewritten at 480x640); (e) a two-domain tree
    histogram-matched and restyled, then one epoch of ``--trainType st
    --pallas_train --augment`` and ``cli.test --fused`` on each, with
    phase 15's launch checks; (f) ``cli.domain_study.main --arch 67`` with
    all five regimes over seeded trees, then a second call that resumes
    without training.
19. the serving student's life, each part's seconds printed: (a)
    ``cli.train --arch lite --augment -b 32`` at full width (bf16),
    ``--trainType sim`` then ``mme``, 2 epochs each without and with
    ``--device_cache`` (rows and final state bit-equal, one replay a
    step), and the B=32 step eager against graphed; (b) ``cli.distill``
    from the seeded FCDenseNet67 (``.pt``) into a full-width student, the
    teacher through K4 (55/5/1 launches a step, on the tensor cores, no
    plain version), its logits against the plain module on one augmented
    batch (float32 gated, bfloat16 by argmax agreement), K4's launches in
    one step by torch.profiler, one ``train_step_unl`` (the teacher at
    B=64) and the steps' times; (c) the student through ``cli.serve
    --arch lite --int8 --fused --calib_dir`` on 480x640 PNGs (LANCZOS4):
    the calibration frames and scales on the card against the CPU, K6
    against plain on its sites, 32 requests behind the engine (1/12/1
    launches a batch, no plain version) against plain int8; (d) the
    montage of ``cli.test --trainDataPath --realDataPath`` from 480x640
    PNGs; (e) ``cli.domain_study`` with its default ``--arch lite`` and
    ``--distill --device_cache``, ``baseline`` and ``mme``.
20. the trainer's surface, at FCDenseNet67's widths (120x160, B=32, bf16,
    augmented), each part's seconds printed: (a) ``cli.train --arch 67r
    --pallas_train`` against ``--arch 67 --pallas_train`` (phase 8's
    launch checks; rows and final state equal); (b) ``--arch 67r``
    against ``--arch 67`` through plain autograd (train losses within
    REMAT_RTOL, no train kernel launched); (c) ``--fast_train`` against
    (b)'s plain run (within FAST_RTOL); (d) ``--dp auto`` in a one-rank
    NCCL world, with and without ``--device_cache``, against ``--dp off``
    (``--pallas_train``; rows and final state bit-equal, the cached run's
    all-reduces inside its graph); (e) ``cli.tune --device_cache``, three
    trials over rungs of 1 and 2 epochs, one graph capture for the sweep,
    ``trials.json`` and ``best.json`` valid, seconds per trial-epoch; (f)
    ``cli.test --arch 67r --fused`` through K4 and ``cli.test --arch
    encdec``; then the B=32 step of ``67``, ``67r``, ``--fast_train`` and
    ``--pallas_train`` by CUDA events with each one's peak of allocated
    memory (67r's must be lower), and the ``--pallas_train`` step in a
    one-rank NCCL world against none, eager and graphed.
21. data generation at 480x640, each part's seconds printed: (a)
    ``sim.render.render_pair`` on the card against the CPU from the same
    poses, DR rows and noise draws (loop_dyn_duckiebots and zigzag with
    the fisheye, zigzag through a generated photo pack), at the CPU tests'
    agreement bounds (DG_RENDER_EQUAL, DG_RENDER_NEAR), and the pairs'
    alignment; (b) ``cli.datagen`` (2 episodes x 64 steps x 2 agents, 256
    pairs, FFV1: every recording's fourcc and frame count checked),
    ``cli.postprocess`` (K5 once a batch of <= 32
    pairs: 8 launches by its count and by torch.profiler, every batch's
    masks equal to the plain version on the card), ``cli.preprocess_db
    --dbType sim`` and one epoch of ``cli.train --arch 67 --pallas_train
    -b 32`` on the rendered tree (phase 15's checks); (c)
    ``cli.domain_study`` in empty workdirs, rendering both domains (1
    episode of 24 steps) and training ``baseline``, procedural and with
    ``--target_texture_pack auto``; (d) rendered pairs/s of a B=2 x 32-step
    rollout and its device time split between ground, cylinders and
    meshes (by subtraction), datagen's render and encode seconds,
    postprocess frames/s with K5's device time, preprocess_db seconds.
22. the interactive simulator, learning/ and the video CLIs, each part's
    seconds printed: (a) ``DuckietownEnv(map_name="loop_dyn_duckiebots",
    domain_rand=True)`` at 640x480 on the card: load, 10 resets and 200
    expert-driven steps timed (steps/s), the NPCs' mesh triangles moved on
    the device, no NaN, ``max_steps`` truncating; then the same env on the
    card and on the CPU from one seed and one CPU generator's draws for 16
    steps (poses within SIM_POSE_TOL m and SIM_ANGLE_TOL rad, frames
    DG_RENDER_EQUAL equal); (b) ``cli.sim_benchmark`` at its defaults
    (its JSON line); (c) ``cli.train_imitation`` at its defaults (4
    episodes x 64 steps at 60x80, 10 epochs, B=32: finite losses, the
    last epoch's below the first's), then ``cli.enjoy imitation --out``
    (as many frames as steps); (d) ``cli.train_reinforcement`` at its
    defaults (500 timesteps, finite losses, the actor saved), then ``cli.
    enjoy reinforcement``; (e) ``cli.basic_control --out`` (120 frames)
    and ``cli.free_camera --orbit`` (8 PNGs); (f) ``cli.make_demo_video
    -t baseline --arch 67 --fused -b 64`` with phase 8's weights on a
    rendered 128-frame 480x640 FFV1 video: K4 launches 55/5/1 a batch,
    every dense layer on the tensor cores, no plain version, the class
    maps against the run without ``--fused`` over all pixels
    (MIN_PIXEL_AGREEMENT) and over the painted ones
    (MIN_PAINTED_AGREEMENT), frames/s
    and the split of host decode, device and encode seconds; (g)
    ``cli.comparison --showCount 4`` over five seeded 2-class FCDenseNet57
    ``.pt`` files: the 504x960 BGRA PNG read back, its header the port's
    header function's.
23. the kernel diagnostics and the real-domain path, each part's seconds
    printed: (a) ``cli.serve_breakdown --arch 67 -b 256 --ablate`` on the
    first level: 11 level rows, K4 at 55 + 5 + 1 launches a forward (every
    dense layer on the tensor cores, no plain version), both ``--ablate``
    variants launched, every row finite with its MXU and HBM shares at or
    below 100%, the levels' sum within the full forward plus its spread,
    the dense layers' bound four times phase 5's; (b) ``cli.
    train_breakdown --arch 67 -b 128``: 5 TransitionDown rows, the full
    forward, backward and step, K1-K3b launched on the tensor-core route,
    no plain version; (c) ``cli.train_benchmark --archs 67 lite -b 64``
    (graph replays), with ``--pallas_train`` (K1-K3b launched at the
    warm-ups and the capture, no plain version) and with ``--stages``;
    (d) ``cli.create_real_db`` on the committed labelme fixtures on the
    card, byte-equal to a CPU run, ``cli.preprocess_db --dbType real``, one
    ``--trainType mme --augment --pallas_train`` step of FCDenseNet67 on a
    synthetic source plus the real target (phase 15's checks, two passes),
    ``cli.get_real_data --imitate`` and ``cli.plot_lr``'s values (the
    card's machine has no matplotlib); (e) the two ``--ablate`` variants
    against their plain versions on all 55 layers of a B=64 forward, and
    their times beside plain, cuDNN and their bounds.
24. the JAX package's FFV1 recordings, each part's seconds printed: (a)
    the committed JAX-written pair (``data/assets/ffv1/``, from
    ``scripts/make_ffv1_fixture.py``: 16 frames at 160x120 a video, a
    keyframe at 0 and 12) decodes to cv2's per-frame SHA-256 digests; (b)
    ``cli.postprocess`` on it on the card, K5's count set to 0 just before
    and read just after (1 launch), its input and label videos equal to
    the JAX postprocess's by digest; (c) 128 rendered 480x640 pairs
    through ``data/ffv1``'s encoder and decoder, byte-equal, keyframes
    every 12 frames; (d) ms per 480x640 frame of FFV1 encode and decode
    (4 slice threads) beside MPNG's (PNG, Sub, one thread; and Paeth's
    decode) on the host, and kB a frame.
25. FCDenseNet57, whose growth-12 dense layers take the tensor cores in
    bfloat16 (their weights padded to 16 zero columns): (a) K4 against
    plain on all 11 blocks at B=8, f32 and bf16, each of the 44 bf16
    dense layers on the tensor-core route and no f32 one; (b) one fused
    train step at B=4 with every site against plain (49 K1, 5 K2, 44 K3a
    and 11 K3b; a dropped channel at every dropout site, zero BN shifts),
    every bf16 one on the tensor-core route; (c) ``cli.train --arch 57
    --pallas_train`` (two B=32 steps on a 64/32/32 PNG tree), then
    ``cli.test --arch 57 --fused`` on its test split and ``cli.serve
    --arch 57 --fused`` behind the engine, the counts set to 0 just
    before each and read just after (49/5/44/11 a step, 44/5/1 a
    forward), no plain version called, served masks against the plain
    module; (d) K4's dense layers per B=64 forward (per plane) and K1's
    3x3, K2, K3a and K3b per B=32 step, each call against plain and
    timed alone beside plain, cuDNN and the bound
    (``growth_timing``; ``scripts/torch_growth_timing.py`` runs it on
    another tree).  Its rows join the kernels line as ``*_g12``.

It prints the seconds of each phase, one JSON line of per-kernel numbers,
then, as its last line,
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
the last line.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np

SEED = 0
ARCH = "67"
N_CLS = 4
H, W = 120, 160
CHECK_BATCH = 8
TIME_BATCH = 64
REPS = 10
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3.
# The kernels' operands are bf16 on the main path.  A card with a lower
# power limit runs below them.
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12
REPLACES = "sim2real_lane_segment_tpu/models/tiramisu_pallas.py:701"
SOURCE = "sim2real_lane_segment_tpu_torch/csrc/dense_block.cu"
TRAIN_SOURCE = "sim2real_lane_segment_tpu_torch/csrc/train_block.cu"
_TP = "sim2real_lane_segment_tpu/models/tiramisu_train_pallas.py"
# wrapper name -> (summary name, the TPU kernel's pallas_call)
TRAIN_KERNELS = {"consumer_fwd": ("k1_consumer_fwd", f"{_TP}:187"),
                 "consumer_bwd": ("k2_consumer_bwd", f"{_TP}:328"),
                 "stage": ("k3a_stage", f"{_TP}:759"),
                 "final": ("k3b_final", f"{_TP}:854")}
# LaneNetLite serving (K6) and label extraction (K5)
LITE_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "artifacts", "lanenet_lite_sim.msgpack")
LITE_MODES = {"float": [], "int8": ["--int8"],
              "int8_fused": ["--int8", "--fused"]}
# K6 logits: every step but the f32 head is bit-exact; the head sums 128
# products in another order (the JAX kernel's own gate)
INT8_LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
MIN_INT8_AGREEMENT = 0.999    # served masks: K6 vs the plain int8 path
LABEL_BATCH = 32
LABEL_SIZES = ((480, 640), (120, 160))
LABEL_WIDE = (2, 1080, 1920)  # (B, H, W): frames of two column tiles
PEAK_INT8_OPS = 1979e12       # dense int8 tensor cores
PEAK_F32_OPS = 67e12          # float32 outside the tensor cores
_CSRC = "sim2real_lane_segment_tpu_torch/csrc"
K6_SOURCE = f"{_CSRC}/int8_body.cu"
K6_REPLACES = "sim2real_lane_segment_tpu/models/lanenet_pallas.py:260"
K5_SOURCE = f"{_CSRC}/labelgen.cu"
K5_REPLACES = "sim2real_lane_segment_tpu/ops/labelgen_pallas.py:107"
TRAIN_CHECK_BATCH = 4
TRAIN_BATCH = 32
TRAIN_SPLITS = (("train", 96), ("valid", 32), ("test", 32))
# per launch of FCDenseNet67's fused train step: 55 dense + 5 TD forwards,
# 5 TD backwards, 55 stages, 11 block inputs
TRAIN_LAUNCHES_PER_STEP = {"consumer_fwd": 60, "consumer_bwd": 5,
                           "stage": 55, "final": 11}
# train kernels against plain, max|err| / max|ref| per output.  float32:
# sums of up to 10^5 products in another order.  bfloat16: a rounded
# output may land one bf16 step (2^-8) away, and a stage's rounded g_pre
# feeds its own sums.
TRAIN_REL_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}
# whole-model gradients of the float32 routes against the plain step in
# float64: per parameter max|err| <= GRAD_RTOL * max(max|ref|, 1e-2 * the
# largest gradient).  Float32 rounding alone comes near 3e-3 on an H100:
# plain autograd's first-conv weight gradient, a sum over 76,800 pixels
# that largely cancels, after ~130 backward layers.  The bfloat16 fused
# step, the control, reads about 1.6e-1 (PERF.md).  The limit sits between.
GRAD_RTOL = 5e-3
# float32: the kernel and the plain version sum the same float32 products
# in another order.  bfloat16: one rounding of a different f32 sum may land
# on the neighbouring bf16 value (relative step 2^-7), and later layers of
# a block see it, so the chained block gets 4 steps.
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2 ** -5, atol=2 ** -5)}
ISOLATED_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
                "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}
LOGIT_ATOL = {"float32": 1e-3, "bfloat16": 0.25}
MIN_ARGMAX_AGREEMENT = 0.99   # fused bf16 logits: kernel vs plain
MIN_PIXEL_AGREEMENT = 0.98    # served masks: fused kernels vs plain module
# make_demo_video's masks again over the pixels either route paints
# (class > 0), so that a route painting no class fails however small the
# painted share; the plain run must paint at least MIN_PAINTED_SHARE
MIN_PAINTED_AGREEMENT = MIN_PIXEL_AGREEMENT
MIN_PAINTED_SHARE = 0.01


# the bf16 kernels on the tensor cores: the TransitionDown forward's two
# (serving, and K1 with one tap) and K2's dgrad (wgmma), K2's wgrad, the
# 3x3 dense layer of serving and of K1, K3a's two kernels, K3b and the
# classifier's bf16 instance (mma.sync); and K6's int8 conv (IMMA).  The
# dense-layer kernels have one instance per growth (12: FCDenseNet57; 16:
# 67 and 103).
GROWTH_KERNELS = ("dense3x3_mma_kernel", "fwd3x3_mma_kernel",
                  "sum_dgrad_mma_kernel", "stage_own_mma_kernel",
                  "dense3x3_no_taps_kernel", "dense3x3_no_prep_kernel")
MMA_KERNELS = (("td_fwd_small_kernel", "td_fwd_mma_kernel",
                "bwd1x1_dgrad_mma_kernel", "bwd1x1_wgrad_mma_kernel",
                "classifier_kernel")
               + tuple(f"{k}<{g}>" for k in GROWTH_KERNELS for g in (16, 12)))
# the serving dense layer's two diagnostic variants (cli/serve_breakdown
# --ablate) and K1's 3x3 forward, which shares their body: their ptxas
# lines are printed on one line of their own
SHARED_BODY = tuple(f"{k}<{g}>" for k in (
    "dense3x3_mma_kernel", "dense3x3_no_taps_kernel",
    "dense3x3_no_prep_kernel", "fwd3x3_mma_kernel") for g in (16, 12))
IMMA_KERNELS = ("conv_i8_mma_kernel",)
# dense layers of one FCDenseNet67 forward, all bf16 growth 16; conv sites
# of the full-width LaneNetLite body, all on the int8 tensor cores
DENSE_LAYERS = 55
K6_CONVS = 12
# launches per bf16 train step that must take the tensor-core route: every
# K1, K2, K3a and K3b site of FCDenseNet67
TRAIN_MMA_PER_STEP = {"consumer_fwd": 60, "consumer_bwd": 5, "stage": 55,
                      "final": 11}
# per B=32 step, ms: half of what the CUDA-core kernels took (93.574 and
# 41.201 on an H100 at 700 W), a guard that the tensor-core kernels are
# the code that ran, not a target
MAX_STEP_MS = {"stage": 47.0, "consumer_fwd": 21.0}
# per B=64 forward, ms: half of what the first kernels took (53.9, 2.997
# and 0.982 on an H100 at 700 W), the same kind of guard
MAX_FWD_MS = {"k4_dense_layer": 27.0, "k6_int8_body": 1.5,
              "k4_classifier": 0.5}
# per B=32 480x640 batch, ms of device time: half of what the first K5
# took (0.278 on an H100 at 700 W)
MAX_LABEL_MS = 0.14
# kernels whose registers and spills phase 2 also prints on a line of its own
REDESIGNED = ("classifier_kernel", "labelgen_kernel")
# phases 14-16: MME's step (two train-mode passes, each through every K1,
# K2, K3a and K3b site) at B=32, the two-domain PNG tree of the st and mme
# CLIs (labelled 64 + 32 <= unlabelled 96), augmentation's source sizes
MME_BATCH = 32
MME_SPLITS = (("source", 64), ("target/train", 32), ("target/test", 32),
              ("target/unlabelled", 96))
AUG_SOURCES = ((120, 160), (480, 640))
# one whole MME step through the kernels against the same step through
# their plain versions: the losses and both stages of the running
# statistics as max|err| / max|ref|; the gradients (SGD's momentum after
# phase G, Adam's first moment after phase F) per parameter as max|err| /
# max(max|ref|, 1e-2 * the largest), as phase 7 holds them.  float32: sums
# in another order (phase 7's limits).  bfloat16: a site's output may
# round one bf16 step (2^-8) apart and later sites see it.
MME_STEP_TOL = {"float32": {"loss": 1e-4, "stats": 1e-3, "grad": GRAD_RTOL},
                "bfloat16": {"loss": 2 ** -6, "stats": 2 ** -6,
                             "grad": 2 ** -4}}
# phase 17: --device_cache.  The CLI trees give 4 steps of B=32 an epoch
# (sim: train 128; st and mme: source 80 + target/train 48, unlabelled
# 128; 8 steps before phase 20 came); the timed split is 1,536 frames at
# 480x640, the simulator's render size (1.416 GB of images, 0.472 GB of
# labels on the card)
CACHE_SIM_SPLITS = (("train", 128), ("valid", 32), ("test", 32))
CACHE_MME_SPLITS = (("source", 80), ("target/train", 48),
                    ("target/test", 32), ("target/unlabelled", 128))
CACHE_STEPS = CACHE_SIM_SPLITS[0][1] // TRAIN_BATCH
CACHE_FRAMES, CACHE_SIZE = 1536, (480, 640)
CACHE_TIMED_STEPS = 20   # per mode, in two turns of 10
CACHE_PROFILED_REPLAYS = 10


# phase 18: the HM and CycleGAN regimes.  Frames at the simulator's render
# size; the CycleGAN generator at full width (9 residual blocks).  Float32
# against float64 on the card: measured 3.9e-5 on a CPU.  One CycleGAN step
# on the card against the CPU: the losses as relative errors; the gradients
# (Adam's first moment) per parameter as max|err| / max(max|ref|, 1e-2 *
# the largest): float32 itself strays up to 3.2e-2 from a float64 step on
# a CPU (the first conv of a residual block, whose gradient the
# InstanceNorm after it nearly cancels, and the discriminator's deepest
# conv), and the card and the CPU each stray so; but for the conv biases
# an InstanceNorm follows, whose
# gradient is zero in exact arithmetic and float noise on either side (at
# most CG_NOISE_G of the largest); the parameters within Adam's first step
# of each other (an element whose gradient is noise may step the other
# way).
FRAME_SIZE = (480, 640)
RESAMPLE_BATCH = 16
HM_FRAMES = 48
HM_BATCH = 16
CG_BATCH = 4
CG_TREE = 64
CG_PARAMS = 11_378_179
CG_LR = 2e-4
CONVERT_FRAMES = 32
GEN_F64_ATOL = 5e-4
CG_LOSS_RTOL = 1e-4
CG_GRAD_RTOL = 0.1
CG_NOISE_G = 1e-2
# the study's trees: baseline 1 step of B=32, st/hm/cyclegan 2, mme 2
# (labelled 32 + 32 <= unlabelled 32 + 32)
STUDY_SPLITS = (("train", 32), ("valid", 32), ("test", 32))
# phase 19: LaneNetLite's trees at 120x160 (LITE_STEPS steps of B=32 an
# epoch: sim train 64; mme labelled 32 + 32 <= unlabelled 64; the
# distillation's train 64), 480x640 PNGs for the calibration and the
# montage, the timed split on the card.  The int8 calibration scales on the
# card against the CPU route: percentiles of float32 forwards that sum in
# another order (measured 0-2 ulp apart between two packages on a CPU),
# held relatively
LITE_SIM_SPLITS = (("train", 64), ("valid", 32), ("test", 32))
LITE_MME_SPLITS = (("source", 32), ("target/train", 32), ("target/test", 32),
                   ("target/unlabelled", 64))
LITE_STEPS = 2
LITE_TIMED_FRAMES = 512
LITE_TIMED_STEPS = 10
FULL_SPLITS = (("train", 16), ("real", 16))
CALIB_RTOL = 1e-4
MONTAGE_ROWS = 3
# phase 20: the trainer's surface at FCDenseNet67's widths, 120x160, B=32.
# The CLI trees give 2 steps an epoch (sim: train 64; the sweep's
# labelled 32 + 32 <= unlabelled 64); the timed split is 256 frames.
# Train losses of --arch 67r against 67, both plain autograd: the
# checkpointed blocks recompute the same values, so only cuDNN's backward
# summing in another order can part them.  --fast_train against the plain
# step: the bf16 per-segment convolutions round and sum otherwise (on a
# CPU, the tiny net's four bf16 steps part by 1.6e-4), over 2 steps.
SURFACE_SPLITS = (("train", 64), ("valid", 32), ("test", 32))
SURFACE_MME_SPLITS = (("source", 32), ("target/train", 32),
                      ("target/test", 32), ("target/unlabelled", 64))
REMAT_RTOL = 1e-3
FAST_RTOL = 2e-2
TUNE_TRIALS = 3
SURFACE_TIMED_FRAMES = 256
SURFACE_TIMED = 5


# phase 21: data generation at the recording size (480x640): the renderer
# on the card against the CPU at the CPU tests' agreement bounds (uint8
# values equal / within one level), the datagen -> postprocess (K5) ->
# preprocess_db -> train chain, and the study's render of missing domains
DG_SIZE = (480, 640)
DG_RENDER_EQUAL = 0.9995
DG_RENDER_NEAR = 0.9998
DG_CHECK_POSES = 4
DG_ARGS = ["--map-name", "loop_dyn_duckiebots", "--episodes", "2",
           "--steps", "64", "--agents", "2", "--chunk", "32", "--distortion"]
DG_PAIRS = 2 * 64 * 2
DG_RECORDINGS = 4
DG_LABEL_BATCH = 32
DG_SPLITS = (179, 39, 38)   # 256 frames, 70/15/15
DG_TIMED = 3
DG_STUDY_ARGS = ["--episodes", "1", "--steps", "24", "--regimes",
                 "baseline", "--epochs", "1", "-b", "8"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_label() -> str:
    """The card's name and power limit as nvidia-smi gives them
    (``core.runtime.device_label``); fails if nvidia-smi gave none."""
    import torch

    from sim2real_lane_segment_tpu_torch.core.runtime import (UNREAD,
                                                              device_label)
    label = device_label(torch.device("cuda", 0))
    check(UNREAD not in label, f"nvidia-smi failed: {label}")
    return label


def _entry_name(mangled: str) -> str:
    """The plain name of a kernel in one of this repo's anonymous
    namespaces: the second length-prefixed name after ``_ZN``; for the
    dense-layer kernels (GROWTH_KERNELS) with their growth, the integer
    template argument: ``fwd3x3_mma_kernel<12>``."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    name = rest[m.end():m.end() + int(m.group(1))]
    arg = re.match(r"ILi(\d+)EE", rest[m.end() + int(m.group(1)):])
    return (f"{name}<{arg.group(1)}>" if arg and name in GROWTH_KERNELS
            else name)


def ptxas_report(log: str) -> list:
    """[(kernel, "registers ...; spills ...")] from an nvcc -Xptxas -v log,
    one entry per compiled __global__ (template instances in order)."""
    out, name, parts = [], None, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            if name:
                out.append((name, "; ".join(parts)))
            name, parts = _entry_name(line.split("'")[1]), []
        elif name and ("spill" in line or "registers" in line):
            parts.append(line.split(":", 1)[-1].strip())
    if name:
        out.append((name, "; ".join(parts)))
    return out


def tensor_core_instructions(build):
    """Tensor-core instructions (HMMA for bf16 mma.sync, HGMMA for wgmma,
    IMMA for int8 mma.sync) in each tensor-core kernel's SASS (cuobjdump
    beside nvcc), or None without cuobjdump."""
    from pathlib import Path

    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    counts = {}
    for src in ("dense_block", "train_block", "int8_body"):
        sass = subprocess.run([str(tool), "-sass", str(build._target(src))],
                              capture_output=True, text=True, timeout=300)
        check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-500:]}")
        name = None
        for line in sass.stdout.splitlines():
            if "Function :" in line:
                name = _entry_name(line.split("Function :", 1)[1].strip())
            elif ((name in MMA_KERNELS and ("HMMA" in line or "HGMMA" in line))
                  or (name in IMMA_KERNELS and "IMMA" in line)):
                counts[name] = counts.get(name, 0) + 1
    return {k: counts.get(k, 0) for k in MMA_KERNELS + IMMA_KERNELS}


# ---------------------------------------------------------------------------
# inputs and weights, from SEED
# ---------------------------------------------------------------------------

def synthetic_frames(rng: np.random.Generator, n: int) -> np.ndarray:
    """uint8 (n, H, W, 3) frames with structure at several scales."""
    import torch
    import torch.nn.functional as F

    base = torch.from_numpy(rng.uniform(0, 255, (n, 3, 6, 8)).astype(
        np.float32))
    x = F.interpolate(base, size=(H, W), mode="bilinear", align_corners=False)
    x = x + torch.from_numpy(rng.normal(0, 16, (n, 3, H, W)).astype(
        np.float32))
    return x.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy().copy()


def seeded_state_dict(device, arch=ARCH) -> dict:
    """FCDenseNet``arch`` weights (default 67) from SEED: He-normal convs, random BatchNorm
    affine, and running statistics calibrated on synthetic frames (each
    BatchNorm gets the mean and variance of its input in one forward), so
    activations keep their scale through all 11 blocks."""
    import torch
    from torch import nn

    from sim2real_lane_segment_tpu_torch.cli.test import build_model
    from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
    from sim2real_lane_segment_tpu_torch.models.tiramisu import (
        DenseLayer, TransitionDown)
    from sim2real_lane_segment_tpu_torch.ops.augment import (AugmentConfig,
                                                             eval_batch)

    gen = torch.Generator().manual_seed(SEED)
    model = build_model(arch, N_CLS, F32_POLICY)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                k = m.weight.shape[2] * m.weight.shape[3]
                fan_in = (m.weight.shape[1] * k if isinstance(m, nn.Conv2d)
                          else m.weight.shape[0] * k / 4)  # stride-2 scatter
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / fan_in) ** 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.05)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.2)
    model = model.to(device).eval()

    def calibrate(module, args):
        x = args[0].float()
        bn = module.BatchNorm_0
        bn.running_mean.copy_(x.mean((0, 2, 3)))
        bn.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, (DenseLayer, TransitionDown))]
    frames = synthetic_frames(np.random.default_rng(SEED), 16)
    x, _ = eval_batch(torch.from_numpy(frames).to(device), None,
                      AugmentConfig(height=H, width=W), with_labels=False)
    with torch.no_grad():
        model(x.permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    return {k: v.cpu() for k, v in model.state_dict().items()}


def make_model(sd, policy, device, arch=ARCH):
    from sim2real_lane_segment_tpu_torch.cli.test import build_model

    model = build_model(arch, N_CLS, policy)
    model.load_state_dict(sd)
    return model.to(device).eval()


def model_input(frames: np.ndarray, device):
    import torch

    from sim2real_lane_segment_tpu_torch.ops.augment import (AugmentConfig,
                                                             eval_batch)
    x, _ = eval_batch(torch.from_numpy(frames).to(device), None,
                      AugmentConfig(height=H, width=W), with_labels=False)
    return x.permute(0, 3, 1, 2).contiguous()


def capture_blocks(model, x, folded):
    """Run the fused forward through the plain blocks and record each
    block's inputs: [(name, segments, layers, kwargs)] in forward order."""
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
    from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import \
        fused_apply

    order = ([f"denseDown{i}" for i in range(5)] + ["bottleneck"]
             + [f"denseUp{i}" for i in range(5)])
    calls = []

    def record(segments, layers, **kw):
        calls.append((order[len(calls)], [s.clone() for s in segments],
                      layers, kw))
        return kdb.dense_block_plain(segments, layers, **kw)

    fused_apply(model, x, folded, use_softmax=False, block_fn=record)
    return calls


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def compare_blocks(sd, device, dtype_name, card, arch=ARCH,
                   dense_layers=DENSE_LAYERS):
    """Phase 3 for one dtype: every block, kernel chain against plain
    chain, and each entry point on identical inputs.  Returns the largest
    isolated error per entry point.  ``arch``'s forward runs
    ``dense_layers`` dense layers (phase 25: FCDenseNet57's 44)."""
    import torch

    from sim2real_lane_segment_tpu_torch.core.dtypes import (DEFAULT_POLICY,
                                                             F32_POLICY)
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
    from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import \
        fold_model

    policy = F32_POLICY if dtype_name == "float32" else DEFAULT_POLICY
    model = make_model(sd, policy, device, arch)
    folded = fold_model(model)
    frames = synthetic_frames(np.random.default_rng(SEED + 1), CHECK_BATCH)
    calls = capture_blocks(model, model_input(frames, device), folded)
    check(len(calls) == 11, f"expected 11 dense blocks, saw {len(calls)}")
    errs = {"dense_layer": 0.0, "transition": 0.0, "classifier": 0.0}
    kdb.reset_launches()
    for name, segs, layers, kw in calls:
        out = kdb.dense_block(segs, layers, **kw)
        ref = kdb.dense_block_plain(segs, layers, **kw)
        torch.cuda.synchronize()
        if kw.get("td") is not None:
            pairs = [("features", out[0], ref[0]), ("td", out[1], ref[1])]
        else:
            pairs = [("logits" if kw.get("cls") is not None else "features",
                      out, ref)]
        for what, a, b in pairs:
            a, b = a.float(), b.float()
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            if what == "logits":
                am, bm = a[:, :N_CLS].argmax(1), b[:, :N_CLS].argmax(1)
                agree = (am == bm).float().mean().item()
                print(f"  {dtype_name} {name:10s} logits   max|err| {err:.3e} "
                      f"(max|ref| {scale:.3e}), argmax agreement "
                      f"{agree:.6f}  [{card}]")
                check(agree >= MIN_ARGMAX_AGREEMENT,
                      f"{dtype_name} {name} argmax agreement {agree}")
                if dtype_name == "float32":
                    check(err <= LOGIT_ATOL[dtype_name],
                          f"float32 {name} logits differ by {err}")
            else:
                print(f"  {dtype_name} {name:10s} {what:8s} max|err| "
                      f"{err:.3e} (max|ref| {scale:.3e})  [{card}]")
                torch.testing.assert_close(a, b, **TOL[dtype_name],
                                           msg=f"{dtype_name} {name} {what}")
        # each entry point on the plain chain's own buffer: same inputs
        feat = kdb.dense_block_plain(segs, layers, c_lo=0)
        for lay in layers:
            k, _, g = lay.weight.shape
            buf = feat.clone()
            kdb.dense_layer(buf, lay)
            a, b = buf[:, k:k + g].float(), feat[:, k:k + g].float()
            torch.testing.assert_close(a, b, **ISOLATED_TOL[dtype_name],
                                       msg=f"{name} layer at c={k}")
            errs["dense_layer"] = max(errs["dense_layer"],
                                      (a - b).abs().max().item())
        if kw.get("td") is not None:
            a = kdb.transition(feat, kw["td"]).float()
            b = kdb.transition_plain(feat, kw["td"]).float()
            torch.testing.assert_close(a, b, **ISOLATED_TOL[dtype_name],
                                       msg=f"{name} transition")
            errs["transition"] = max(errs["transition"],
                                     (a - b).abs().max().item())
        if kw.get("cls") is not None:
            a = kdb.classifier(feat, kw["cls"])
            b = kdb.classifier_plain(feat, kw["cls"])
            err = (a - b).abs().max().item()
            check(err <= LOGIT_ATOL[dtype_name],
                  f"{name} classifier on identical features: {err}")
            errs["classifier"] = max(errs["classifier"], err)
    torch.cuda.synchronize()
    print(f"  {dtype_name} isolated entry points max|err|: "
          f"{json.dumps(errs)}  [{card}]")
    # each layer twice: in the block chain and on its own
    expect = 2 * dense_layers * (dtype_name == "bfloat16")
    print(f"  {dtype_name} dense layers on the tensor-core route "
          f"{kdb.mma_launches['dense_layer']} of "
          f"{kdb.launches['dense_layer']}, expected {expect}")
    check(kdb.launches["dense_layer"] == 2 * dense_layers
          and kdb.mma_launches["dense_layer"] == expect,
          f"{dtype_name}: dense layers {kdb.launches['dense_layer']}, on the "
          f"tensor cores {kdb.mma_launches['dense_layer']}")
    return errs


def client_requests(rng) -> list:
    """4 clients x 8 requests of 1-16 synthetic frames."""
    return [[synthetic_frames(rng, int(rng.integers(1, 17)))
             for _ in range(8)] for _ in range(4)]


def drive_engine(predict_fn, requests):
    """The predictor behind ``BatchingEngine`` (max_batch 64), one client
    thread per request list.  Checks that every request was answered and
    every frame served; returns (replies, engine stats, wall seconds)."""
    from sim2real_lane_segment_tpu_torch.serving import BatchingEngine

    replies = [[None] * len(reqs) for reqs in requests]
    errors = []

    def client(i):
        try:
            for j, frames in enumerate(requests[i]):
                replies[i][j] = engine.predict(frames, timeout=300)
        except Exception as e:  # reported below; the phase then fails
            errors.append(repr(e))

    engine = BatchingEngine(predict_fn, height=H, width=W, max_batch=64,
                            max_wait_ms=4.0)
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        engine.close()
    check(not errors, f"engine requests failed: {errors}")
    check(not any(t.is_alive() for t in threads), "client threads hung")
    stats = engine.stats
    n_frames = sum(f.shape[0] for reqs in requests for f in reqs)
    check(stats["frames"] == n_frames,
          f"engine served {stats['frames']} of {n_frames} frames")
    for reqs, outs in zip(requests, replies):
        for frames, out in zip(reqs, outs):
            check(isinstance(out, np.ndarray) and out.dtype == np.uint8
                  and out.shape == frames.shape[:3] and out.max() < N_CLS,
                  f"bad reply {type(out)} {getattr(out, 'shape', None)}")
    return replies, stats, wall


def serve_phase(sd, device, card):
    """Phase 4: the CLI predictor behind the engine, driven by 4 client
    threads.  Returns (launches, frames/s, batches)."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import serve
    from sim2real_lane_segment_tpu_torch.cli.test import \
        load_trainer_and_state
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fcdensenet67_seeded.pt")
        torch.save(sd, path)
        args = serve.parse_args(["--checkpointPath", path, "--arch", "67",
                                 "--num_cls", str(N_CLS), "--height", str(H),
                                 "--width", str(W), "--fused"])
        predict_fn, h, w = serve.build_predict_fn(args)
        plain = load_trainer_and_state("baseline", path, num_cls=N_CLS,
                                       arch="67", height=H, width=W)
    check((h, w) == (H, W), f"predictor size {(h, w)}")

    requests = client_requests(np.random.default_rng(SEED + 2))
    kdb.reset_launches()
    replies, stats, wall = drive_engine(predict_fn, requests)
    launches = dict(kdb.launches)
    mma = kdb.mma_launches["dense_layer"]
    n_frames = sum(f.shape[0] for reqs in requests for f in reqs)
    batches = stats["batches"]
    expect = {"dense_layer": 55 * batches, "transition": 5 * batches,
              "classifier": batches}
    print(f"serve: {n_frames} frames in 32 requests, {batches} batches "
          f"(mean {n_frames / batches:.2f} frames), wall {wall:.3f} s, "
          f"{n_frames / wall:.1f} frames/s  [{card}]")
    print(f"serve: kernel launches {json.dumps(launches)}, expected "
          f"{json.dumps(expect)} (55/5/1 per batch)")
    check(launches == expect, "launch counts differ from 55/5/1 per batch")
    print(f"serve: dense layers on the tensor-core route {mma}, expected "
          f"{DENSE_LAYERS * batches}")
    check(mma == DENSE_LAYERS * batches,
          "a served dense layer left the tensor-core route")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the path was never launched")

    same = total = 0
    for reqs, outs in zip(requests, replies):
        for frames, out in zip(reqs, outs):
            ref = plain.predict_step(frames).cpu().numpy()
            same += int((ref == out).sum())
            total += out.size
    agreement = same / total
    print(f"serve: pixel agreement fused kernels vs plain module (bf16) "
          f"{agreement:.6f} over {total} pixels")
    check(agreement >= MIN_PIXEL_AGREEMENT,
          f"pixel agreement {agreement} < {MIN_PIXEL_AGREEMENT}")
    return launches, n_frames / wall


def _time_ms(fn, reps=REPS):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _device_ms(fn, match, reps=REPS):
    """Device time per launch of ``fn``'s CUDA kernel whose name holds
    ``match`` (one a call), by torch.profiler over ``reps`` calls (0.0 if
    the profiler saw none)."""
    rows = [(n, ms) for k, n, ms in _device_rows(fn, reps) if match in k]
    n = sum(r[0] for r in rows)
    return sum(r[1] for r in rows) / n if n else 0.0


def _device_rows(fn, reps=1) -> list:
    """[(kernel name, launches, device ms)] over ``reps`` calls of ``fn``
    by torch.profiler, device-side entries only (a CPU op's row repeats
    its kernels' time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count, getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0))
             / 1e3)
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU]


def port_kernel_names() -> set:
    """The names of the ``__global__`` functions in the port's CUDA
    sources."""
    import glob

    here = os.path.dirname(os.path.abspath(__file__))
    names = set()
    for path in glob.glob(os.path.join(here, _CSRC, "*.cu*")):
        with open(path) as f:
            names |= set(re.findall(
                r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(?:void\s+)?(\w+)\s*\(", f.read()))
    return names


def port_kernel(key: str, names: set) -> str | None:
    """The port's kernel name behind a profiler row's key, or None for a
    kernel of PyTorch's or a library's."""
    path = key.replace("(anonymous namespace)::", "")
    path = path[5:] if path.startswith("void ") else path
    path = re.split(r"[(<]", path, maxsplit=1)[0]
    base = path.rsplit("::", 1)[-1]
    return base if base in names and "at::" not in path else None


def _seeded_classifier(c, device, seed):
    """A classifier tail of width ``c`` from ``seed``: 4 classes padded to
    8 rows, temperature 0.05, bf16 weights."""
    import torch

    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb

    gen = torch.Generator().manual_seed(seed)
    w = torch.zeros(8, c)
    w[:N_CLS] = torch.randn(N_CLS, c, generator=gen) * 0.3
    b = torch.zeros(8)
    b[:N_CLS] = torch.randn(N_CLS, generator=gen) * 0.1
    return kdb.FoldedClassifier(w.to(device, torch.bfloat16), b.to(device),
                                1.0 / 0.05)


def timing_phase(sd, device, card, launches, errs):
    """Phase 5: B=64.  Returns the kernels line entries and the
    classifier's (events ms, device ms by the profiler, bound ms)."""
    import torch
    import torch.nn.functional as F

    from sim2real_lane_segment_tpu_torch.core.dtypes import DEFAULT_POLICY
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
    from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import (
        fold_model, fused_apply)

    model = make_model(sd, DEFAULT_POLICY, device)
    folded = fold_model(model)
    x = model_input(synthetic_frames(np.random.default_rng(SEED + 3),
                                     TIME_BATCH), device)
    with torch.no_grad():
        fwd_ms = _time_ms(lambda: fused_apply(model, x, folded,
                                              use_softmax=False))
        lib_ms = _time_ms(lambda: model(x, use_softmax=False))
    print(f"timing: fused forward B={TIME_BATCH} {fwd_ms:.3f} ms "
          f"({TIME_BATCH / fwd_ms * 1e3:.1f} frames/s); plain nn.Module "
          f"forward through cuDNN {lib_ms:.3f} ms  [{card}]")

    calls = capture_blocks(model, x, folded)
    it = 2  # bf16
    t = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
             "ops": 0.0} for k in ("dense_layer", "transition", "classifier")}
    # (h, w) -> [layers, kernel ms, cuDNN ms, GFLOP, c_j seen, splits taken]
    planes = {}
    chain_err = 0.0
    cls_err = {}  # block -> the classifier's max|err| against plain
    for i, (name, segs, layers, kw) in enumerate(calls):
        feat = kdb.dense_block_plain(segs, layers, c_lo=0)
        b, _, h, w = feat.shape
        hw = h * w
        acts = []
        plane = planes.setdefault((h, w), [0, 0.0, 0.0, 0.0, [], set()])
        # the dense layers against plain at B=64, where the small planes
        # split their channel loop: the block chain and each layer alone
        kdb.reset_launches()
        out = kdb.dense_block(segs, layers, c_lo=0)
        torch.testing.assert_close(out.float(), feat.float(), **TOL["bfloat16"],
                                   msg=f"B={TIME_BATCH} {name} features")
        chain_err = max(chain_err, (out.float() - feat.float()).abs().max()
                        .item())
        del out
        for lay in layers:
            k, _, g = lay.weight.shape
            buf = feat.clone()
            kdb.dense_layer(buf, lay)
            a, r = buf[:, k:k + g].float(), feat[:, k:k + g].float()
            torch.testing.assert_close(a, r, **ISOLATED_TOL["bfloat16"],
                                       msg=f"B={TIME_BATCH} {name} layer at "
                                       f"c={k}")
            errs["dense_layer"] = max(errs["dense_layer"],
                                      (a - r).abs().max().item())
            del buf
        check(kdb.mma_launches["dense_layer"] == 2 * len(layers),
              f"B={TIME_BATCH} {name}: {kdb.mma_launches['dense_layer']} of "
              f"{2 * len(layers)} dense layers on the tensor cores")
        plane[5].update(kdb.mma_splits)
        for lay in layers:
            k, _, g = lay.weight.shape
            acts.append((kdb.bn_relu_plain(feat, lay.scale, lay.shift),
                         lay.weight.reshape(k, 3, 3, g).permute(3, 0, 1, 2)
                         .contiguous()))
            t["dense_layer"]["bytes"] += (b * hw * (k + g) * it
                                          + k * 9 * g * it + 8 * k + 4 * g)
            t["dense_layer"]["ops"] += 2.0 * b * hw * k * 9 * g
            plane[0] += 1
            plane[3] += 2.0 * b * hw * k * 9 * g / 1e9
            plane[4].append(k)
        d = t["dense_layer"]
        ms = _time_ms(lambda: [kdb.dense_layer(feat, lay) for lay in layers])
        lib_ms = _time_ms(lambda: [F.conv2d(a, wo, padding=1)
                                   for a, wo in acts])
        d["ms"] += ms
        d["plain_ms"] += _time_ms(lambda: [kdb.dense_layer_plain(feat, lay)
                                           for lay in layers])
        d["library_ms"] += lib_ms
        plane[1] += ms
        plane[2] += lib_ms
        td, cls = kw.get("td"), kw.get("cls")
        if td is not None:
            c, n = td.weight.shape
            e = t["transition"]
            e["bytes"] += b * hw * (c + n) * it + c * n * it + 8 * c + 4 * n
            e["ops"] += 2.0 * b * hw * c * n
            a = kdb.bn_relu_plain(feat, td.scale, td.shift)
            wo = td.weight.t()[:, :, None, None].contiguous()
            e["ms"] += _time_ms(lambda: kdb.transition(feat, td))
            e["plain_ms"] += _time_ms(lambda: kdb.transition_plain(feat, td))
            e["library_ms"] += _time_ms(lambda: F.conv2d(a, wo))
        # the classifier against plain on this block's features at B=64
        held = cls if cls is not None else _seeded_classifier(
            feat.shape[1], device, SEED + 50 + i)
        err = (kdb.classifier(feat, held)
               - kdb.classifier_plain(feat, held)).abs().max().item()
        check(err <= LOGIT_ATOL["bfloat16"],
              f"B={TIME_BATCH} {name} classifier differs by {err}")
        cls_err[name] = err
        if cls is not None:
            # and on the same features with all-zero pixels: the 1e-12 clamp
            zeroed = feat.clone()
            zeroed[:, :, ::7] = 0
            zeroed[::3, :, :, 5] = 0
            err = (kdb.classifier(zeroed, cls)
                   - kdb.classifier_plain(zeroed, cls)).abs().max().item()
            check(err <= LOGIT_ATOL["bfloat16"],
                  f"B={TIME_BATCH} classifier with all-zero pixels differs "
                  f"by {err}")
            cls_err["zero pixels"] = err
            del zeroed
            c = cls.weight.shape[1]
            e = t["classifier"]
            e["bytes"] += b * hw * c * it + b * 8 * hw * 4 + 8 * c * it + 32
            e["ops"] += b * hw * (2.0 * c + 2.0 * 8 * c)
            e["ms"] += _time_ms(lambda: kdb.classifier(feat, cls))
            e["plain_ms"] += _time_ms(lambda: kdb.classifier_plain(feat, cls))
            e["library_ms"] = None  # no single PyTorch call computes it
            cls_device_ms = _device_ms(lambda: kdb.classifier(feat, cls),
                                       "classifier_kernel")
    print(f"timing: k4_dense_layer per resolution, B={TIME_BATCH} (CUDA "
          f"events; cuDNN conv on the activated operands)  [{card}]")
    for (h, w), (n, ms, lib_ms, gflop, cs, splits) in planes.items():
        print(f"  {h:3d}x{w:<3d} {n:2d} layers, c_j {min(cs)}-{max(cs)}, "
              f"split {sorted(splits)}, {gflop:8.1f} GFLOP: kernel "
              f"{ms:8.3f} ms, cuDNN {lib_ms:8.3f} ms, {gflop / ms:6.1f} "
              f"TFLOP/s")
    split = sorted(set().union(*(p[5] for p in planes.values())))
    print(f"timing: B={TIME_BATCH} dense layers against plain, splits "
          f"{split} as the launches reported: block chains max|err| "
          f"{chain_err:.3e}, each layer alone max|err| "
          f"{errs['dense_layer']:.3e} (phase 3 and here)  [{card}]")
    check(max(split) > 1, f"no B={TIME_BATCH} dense layer split its "
          f"channel loop: {split}")
    errs["classifier"] = max(errs["classifier"], *cls_err.values())
    print(f"timing: B={TIME_BATCH} classifier against plain on every "
          f"block's features, max|err| (limit {LOGIT_ATOL['bfloat16']}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in cls_err.items())
          + f"  [{card}]")
    kernels = []
    for name, e in t.items():
        t_bytes = e["bytes"] / PEAK_BYTES * 1e3
        t_ops = e["ops"] / PEAK_BF16_OPS * 1e3
        entry = {
            "name": f"k4_{name}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[name],
            "max_abs_err": errs[name], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": e["library_ms"]}
        kernels.append(entry)
        lib = ("n/a" if e["library_ms"] is None
               else f"{e['library_ms']:.3f} ms")
        print(f"timing: k4_{name} per B={TIME_BATCH} forward: kernel "
              f"{e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms, cuDNN conv "
              f"alone {lib}, bound {entry['bound_ms']:.3f} ms "
              f"({entry['bound_by']}; {e['ops'] / 1e9:.1f} GFLOP, "
              f"{e['bytes'] / 1e9:.3f} GB)  [{card}]")
    gflop = sum(e["ops"] for e in t.values()) / TIME_BATCH / 1e9
    print(f"timing: kernels' work {gflop:.3f} GFLOP per frame; their bound "
          f"for one B={TIME_BATCH} forward "
          f"{sum(k['bound_ms'] for k in kernels):.3f} ms  [{card}]")
    for name in ("dense_layer", "classifier"):
        limit = MAX_FWD_MS[f"k4_{name}"]
        check(t[name]["ms"] <= limit,
              f"k4_{name} took {t[name]['ms']:.3f} ms per B={TIME_BATCH} "
              f"forward, above {limit} ms")
    return kernels, (t["classifier"]["ms"], cls_device_ms,
                     kernels[-1]["bound_ms"])


# ---------------------------------------------------------------------------
# training path (K1, K2, K3a, K3b)
# ---------------------------------------------------------------------------

def train_masks(model, batch, device, seed):
    """Dropout masks from ``seed``, with channel 0 of every site dropped
    for the whole batch (so its output plane is exactly zero)."""
    import torch

    from sim2real_lane_segment_tpu_torch.models.tiramisu import drop_masks

    masks = drop_masks(torch.Generator().manual_seed(seed), model, batch)
    for m in masks:
        m[:, 0] = 0.0
    return [m.to(device) for m in masks]


def train_batch(rng, n, device):
    """(NCHW model input, int64 labels) for a train-mode forward."""
    import torch

    x = model_input(synthetic_frames(rng, n), device)
    y = torch.from_numpy(rng.integers(0, N_CLS, (n, H, W))).to(device)
    return x, y


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def _hold_site(label, outs, refs, tol, card) -> float:
    """Print one call's kernel outputs against the plain ones and fail if
    one differs by more than ``tol`` of its scale.  Returns the largest
    max|err|."""
    rels = [_rel(a, b) for a, b in zip(outs, refs)]
    abss = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(outs, refs)]
    print(f"  {label}: max|err|/max|ref| {max(rels):.2e} max|err| "
          f"{max(abss):.2e}  [{card}]")
    check(max(rels) <= tol, f"{label}: relative errors {rels} > {tol}")
    return max(abss)


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def compare_train_kernels(sd, device, dtype_name, card, arch=ARCH,
                          per_step=TRAIN_LAUNCHES_PER_STEP):
    """Phase 6 for one dtype: one fused train step at B=4 through the plain
    versions; at every call, the kernel runs on the same operands and is
    held against the plain result.  Returns the largest max|err| per
    kernel.  ``per_step``: ``arch``'s sites a step, every one of them on
    the tensor cores in bfloat16."""
    import torch

    from sim2real_lane_segment_tpu_torch.core.dtypes import (DEFAULT_POLICY,
                                                             F32_POLICY)
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb
    from sim2real_lane_segment_tpu_torch.models.tiramisu_train_fused import \
        fused_apply_train
    from sim2real_lane_segment_tpu_torch.train.losses import \
        weighted_cross_entropy

    policy = F32_POLICY if dtype_name == "float32" else DEFAULT_POLICY
    model = make_model(sd, policy, device, arch)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.zero_()  # dropped planes then give z == 0
    rng = np.random.default_rng(SEED + 4)
    x, y = train_batch(rng, TRAIN_CHECK_BATCH, device)
    masks = train_masks(model, TRAIN_CHECK_BATCH, device, SEED + 5)
    errs = {k: 0.0 for k in TRAIN_KERNELS}
    sites = {k: 0 for k in TRAIN_KERNELS}
    tol = TRAIN_REL_TOL[dtype_name]
    kernel = {k: getattr(ktb, k) for k in TRAIN_KERNELS}
    plain = {k: getattr(ktb, f"{k}_plain") for k in TRAIN_KERNELS}

    def hold(name, outs, refs, shape):
        sites[name] += 1
        label = (f"{dtype_name} {TRAIN_KERNELS[name][0]:16s} site "
                 f"{sites[name]:2d} {shape}")
        errs[name] = max(errs[name], _hold_site(label, outs, refs, tol, card))

    def consumer_fwd(x, scale, shift, weight, bias, mask, out=None):
        k = kernel["consumer_fwd"](x, scale, shift, weight, bias, mask)
        p = plain["consumer_fwd"](x, scale, shift, weight, bias, mask, out)
        hold("consumer_fwd", [k], [p], tuple(weight.shape))
        return p

    def consumer_bwd(*args):
        k = kernel["consumer_bwd"](*args)
        p = plain["consumer_bwd"](*args)
        hold("consumer_bwd", k, p, tuple(args[3].shape))
        return p

    def stage(*args):
        k = kernel["stage"](*args)
        p = plain["stage"](*args)
        hold("stage", k, p, (tuple(args[9].shape), len(args[3])))
        return p

    def final(*args):
        k = kernel["final"](*args)
        p = plain["final"](*args)
        hold("final", [k], [p], (tuple(args[2][0].shape), len(args[1])))
        return p

    ktb.reset_launches()
    with mock.patch.multiple(ktb, consumer_fwd=consumer_fwd,
                             consumer_bwd=consumer_bwd, stage=stage,
                             final=final):
        out, _ = fused_apply_train(model, x, masks)
        weighted_cross_entropy(out, y, N_CLS).backward()
    torch.cuda.synchronize()
    expect = {k: v * (dtype_name == "bfloat16") for k, v in per_step.items()}
    print(f"  {dtype_name} sites on the tensor-core route "
          f"{json.dumps(ktb.mma_launches)}, expected {json.dumps(expect)}")
    check(ktb.mma_launches == expect,
          f"{dtype_name}: tensor-core route taken at {ktb.mma_launches}")
    check(sites == dict(per_step),
          f"{dtype_name}: compared sites {sites}, expected {per_step}")
    print(f"  {dtype_name} train kernels max|err|: {json.dumps(errs)}  "
          f"[{card}]")
    return errs


def check_model_grads(sd, device, card):
    """Phase 7: whole-model outputs, batch statistics and gradients, B=4,
    against the plain train forward plus autograd in float64.  The float32
    routes (plain autograd, ``fused_apply_train`` with the fused block sweep
    and with the per-consumer route) are held to GRAD_RTOL; the bfloat16
    fused step is the control reading that the limit must stay below."""
    import torch

    from sim2real_lane_segment_tpu_torch.core.dtypes import (DEFAULT_POLICY,
                                                             F32_POLICY,
                                                             F64_POLICY)
    from sim2real_lane_segment_tpu_torch.models.tiramisu_train_fused import \
        fused_apply_train
    from sim2real_lane_segment_tpu_torch.train.losses import \
        weighted_cross_entropy

    rng = np.random.default_rng(SEED + 6)
    x, y = train_batch(rng, TRAIN_CHECK_BATCH, device)
    routes = {
        "float64 plain": (F64_POLICY, lambda m, mk: m(
            x.double(), train=True, masks=mk)),
        "plain autograd": (F32_POLICY, lambda m, mk: m(x, train=True,
                                                       masks=mk)),
        "fused block": (F32_POLICY, lambda m, mk: fused_apply_train(m, x, mk)),
        "per consumer": (F32_POLICY, lambda m, mk: fused_apply_train(
            m, x, mk, fused_block_bwd=False)),
        "fused block bf16": (DEFAULT_POLICY, lambda m, mk: fused_apply_train(
            m, x, mk))}
    res = {}
    for name, (policy, fwd) in routes.items():
        model = make_model(sd, policy, device)
        if policy is F64_POLICY:
            model.double()
        masks = train_masks(model, TRAIN_CHECK_BATCH, device, SEED + 7)
        out, upd = fwd(model, masks)
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(weighted_cross_entropy(out, y, N_CLS),
                                    list(params.values()))
        res[name] = (out.detach(), upd, dict(zip(params, grads)))
    torch.cuda.synchronize()
    ref_out, ref_upd, ref_g = res["float64 plain"]
    big = max(g.abs().max().item() for g in ref_g.values())

    def grad_errs(gr, ref):
        """Per parameter max|err| / max(max|ref|, 1e-2 * the largest
        gradient), sorted."""
        return sorted(((gr[k].double() - g.double()).abs().max().item()
                       / max(g.abs().max().item(), 1e-2 * big), k)
                      for k, g in ref.items())

    worst = {}
    for name in list(routes)[1:]:
        out, upd, gr = res[name]
        e_out = _rel(out, ref_out)
        e_st = max(max(_rel(upd[k][s], ref_upd[k][s]) for s in ("mean",
                                                              "var"))
                   for k in ref_upd)
        rel = grad_errs(gr, ref_g)
        worst[name] = rel[-1][0]
        print(f"grads: {name} vs float64 plain autograd (B="
              f"{TRAIN_CHECK_BATCH}): output {e_out:.2e}, batch stats "
              f"{e_st:.2e}, gradients over {len(ref_g)} parameters: median "
              f"{rel[len(rel) // 2][0]:.2e}, worst "
              f"{', '.join(f'{e:.2e} ({k})' for e, k in rel[-3:])}  "
              f"[{card}]")
        if name.endswith("bf16"):
            continue
        check(e_out <= 1e-3 and e_st <= 1e-3,
              f"{name}: output {e_out} or batch stats {e_st} differ")
        check(worst[name] <= GRAD_RTOL, f"{name}: gradient of {rel[-1][1]} "
              f"differs from float64 by {worst[name]} of its scale")
    e_fp = grad_errs(res["fused block"][2], res["plain autograd"][2])[-1]
    e_routes = grad_errs(res["fused block"][2], res["per consumer"][2])[-1]
    print(f"grads: fused block vs float32 plain autograd, worst {e_fp[0]:.2e} "
          f"({e_fp[1]}); fused block vs per consumer, worst {e_routes[0]:.2e}"
          f" ({e_routes[1]}); limit {GRAD_RTOL:.1e}, bf16 control "
          f"{worst['fused block bf16']:.2e}  [{card}]")
    check(e_routes[0] <= GRAD_RTOL, f"the two backward routes differ: "
          f"{e_routes}")
    check(worst["fused block bf16"] > GRAD_RTOL, "the gradient limit does "
          "not separate float32 rounding from the bfloat16 control")


def write_png_tree(root: str, splits=TRAIN_SPLITS, seed: int = SEED,
                   unlabelled=(), scale: int = 1) -> None:
    """A synthetic Duckietown-like PNG tree from ``seed``: BGR frames with a
    right lane (class 1), a left lane (2) and, on every third frame, an
    obstacle (3), written by the port's own PNG writer, ``scale`` times
    the model's size by pixel repetition (labels too).  The
    ``unlabelled`` splits get no ``label/`` directory."""
    from sim2real_lane_segment_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    for split, n in splits:
        subs = ("input",) if split in unlabelled else ("input", "label")
        for sub in subs:
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
        frames = synthetic_frames(rng, n)
        for i in range(n):
            img, lab = frames[i].copy(), np.zeros((H, W), np.uint8)
            xr, xl = int(rng.integers(95, 135)), int(rng.integers(20, 60))
            img[60:, xr:xr + 8], lab[60:, xr:xr + 8] = (40, 210, 220), 1
            img[60:, xl:xl + 6], lab[60:, xl:xl + 6] = (235, 235, 235), 2
            if i % 3 == 0:
                y0, x0 = int(rng.integers(20, 70)), int(rng.integers(60, 90))
                img[y0:y0 + 20, x0:x0 + 24] = (30, 30, 200)
                lab[y0:y0 + 20, x0:x0 + 24] = 3
            if scale > 1:
                img = img.repeat(scale, 0).repeat(scale, 1)
                lab = lab.repeat(scale, 0).repeat(scale, 1)
            write_png(os.path.join(root, split, "input", f"{i:06d}.png"), img)
            if "label" in subs:
                write_png(os.path.join(root, split, "label",
                                       f"{i:06d}.png"), lab)


def train_phase(card, keep_dir: str):
    """Phase 8: the training CLI on the card.  Returns the kernels' launch
    counts over the run, the number of train steps and the run's
    ``best_weights.pt``, copied into ``keep_dir``."""
    import shutil

    import torch

    from sim2real_lane_segment_tpu_torch.cli import train as train_cli
    from sim2real_lane_segment_tpu_torch.cli.test import \
        load_trainer_and_state
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb
    from sim2real_lane_segment_tpu_torch.train.checkpoint import \
        load_train_state

    plain_calls = {k: 0 for k in TRAIN_KERNELS}

    def counting(name):
        fn = getattr(ktb, f"{name}_plain")

        def wrapper(*a, **kw):
            plain_calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "simData")
        t0 = time.perf_counter()
        write_png_tree(root)
        print(f"train: wrote {sum(n for _, n in TRAIN_SPLITS)} PNG frames in "
              f"{time.perf_counter() - t0:.1f} s")
        args = ["--trainType", "sim", "--dataPath", root, "--arch", ARCH,
                "--pallas_train", "--max_epochs", "2", "-b",
                str(TRAIN_BATCH), "--default_root_dir", tmp, "--log_every",
                "1", "--seed", str(SEED)]
        with mock.patch.multiple(ktb, **{f"{k}_plain": counting(k)
                                         for k in TRAIN_KERNELS}):
            ktb.reset_launches()
            t0 = time.perf_counter()
            res = train_cli.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ktb.launches)
            mma_launches = dict(ktb.mma_launches)
        run = res["out_dir"]
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [r["train/tr_loss"] for r in rows if "train/tr_loss" in r]
        steps = len(losses)
        n_train = TRAIN_SPLITS[0][1]
        check(steps == 2 * (n_train // TRAIN_BATCH),
              f"{steps} train steps logged")
        check(bool(np.isfinite(losses).all()), f"losses {losses}")
        print(f"train: 2 epochs, {steps} steps of B={TRAIN_BATCH} in "
              f"{wall:.1f} s (with validation, test and checkpoints); "
              f"losses {[round(v, 4) for v in losses]}, best val_iou "
              f"{res['best_iou']:.3f}  [{card}]")
        expect = {k: v * steps for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
        print(f"train: kernel launches {json.dumps(launches)}, expected "
              f"{json.dumps(expect)}; plain versions called "
              f"{json.dumps(plain_calls)}")
        check(launches == expect, "train launch counts differ")
        expect = {k: v * steps for k, v in TRAIN_MMA_PER_STEP.items()}
        print(f"train: of these on the tensor-core route "
              f"{json.dumps(mma_launches)}, expected {json.dumps(expect)}")
        check(mma_launches == expect,
              "a train kernel launch left the tensor-core route")
        check(not any(plain_calls.values()), "a plain version ran")

        trainer = load_trainer_and_state(
            "baseline", os.path.join(run, "best_weights.pt"),
            num_cls=N_CLS, arch=ARCH, height=H, width=W)
        frames = synthetic_frames(np.random.default_rng(SEED + 8), 8)
        pred = trainer.predict_step_fused(frames).cpu().numpy()
        check(pred.shape == (8, H, W) and pred.max() < N_CLS,
              f"served {pred.shape}")
        print(f"train: best_weights.pt served 8 frames through the fused "
              f"forward, classes {np.bincount(pred.ravel(), minlength=4)}")

        train_cli.main(args + ["--max_epochs", "3", "--resume"])
        latest = load_train_state(os.path.join(
            run, "checkpoints_latest", "latest.pt"))["epoch"]
        with open(os.path.join(run, "metrics.jsonl")) as f:
            n_logged = sum("train/tr_loss" in json.loads(line) for line in f)
        check(latest == 2 and n_logged == steps + steps // 2,
              f"resume: latest epoch {latest}, {n_logged} steps logged")
        print(f"train: --resume continued at epoch 2 ({n_logged} steps "
              f"logged in all)")
        best = shutil.copy(os.path.join(run, "best_weights.pt"),
                           os.path.join(keep_dir, "sim_best_weights.pt"))
    return launches, steps, best


def _bn_act(x, scale, shift):
    """T(relu(x*scale + shift)) in x's dtype: the kernels' conv operand."""
    z = x.float() * scale[:, None, None] + shift[:, None, None]
    return z.clamp(min=0).to(x.dtype)


def _train_cost(name, args, out):
    """(bytes, operations) that one call must move and do at least: every
    input read once, every output written once."""
    import torch

    def nb(t):
        return t.numel() * t.element_size()

    if name == "consumer_fwd":
        x, scale, shift, weight, bias, mask = args[:6]
        b, _, h, w = x.shape
        c, taps, n = weight.shape
        moved = (b * c * h * w * x.element_size() + nb(weight) + nb(scale)
                 + nb(shift) + nb(bias) + nb(mask) + nb(out))
        return moved, 2.0 * b * h * w * c * taps * n
    if name == "consumer_bwd":
        x, scale, shift, weight, mask, dy = args
        b, _, h, w = x.shape
        c, taps, n = weight.shape
        moved = (b * c * h * w * x.element_size() + nb(weight) + nb(scale)
                 + nb(shift) + nb(mask) + nb(dy) + sum(nb(t) for t in out))
        return moved, 4.0 * b * h * w * c * taps * n
    if name == "stage":
        (x, y, ext, gps, wls, scale, shift, scs, shs, weight, mask) = args
        b, _, h, w = x.shape
        c, _, g = weight.shape
        moved = (b * c * h * w * x.element_size() + nb(y) + nb(ext)
                 + sum(nb(t) for t in list(gps) + list(wls) + list(scs)
                       + list(shs)) + nb(scale) + nb(shift) + nb(weight)
                 + nb(mask) + sum(nb(t) for t in out))
        ops = (2.0 * b * h * w * 9 * g * g * len(gps)
               + 4.0 * b * h * w * c * 9 * g)
        return moved, ops
    x, gps, wls, scs, shs = args
    b, _, h, w = x.shape
    c, _, g = wls[0].shape
    moved = (b * c * h * w * x.element_size()
             + sum(nb(t) for t in list(gps) + list(wls) + list(scs)
                   + list(shs)) + nb(out))
    return moved, 2.0 * b * h * w * c * 9 * g * len(gps)


def _train_library(name, args):
    """One cuDNN call on the already-activated operands, as a yardstick
    (None for K3b: no single call computes it)."""
    import torch
    import torch.nn.functional as F

    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb

    if name == "final":
        return None
    if name == "stage":
        x, scale, shift, weight, mask = args[0], args[5], args[6], args[9], \
            args[10]
        g = ktb.stage(*args)[0]
    else:
        x, scale, shift, weight, mask = args[:5] if name == "consumer_bwd" \
            else (args[0], args[1], args[2], args[3], args[5])
        g = None
    c, taps, n = weight.shape
    a = _bn_act(x[:, :c], scale, shift)
    w4 = ktb.conv_weight(weight).to(x.dtype).contiguous()
    pad = 1 if taps == 9 else 0
    if name == "consumer_fwd":
        return lambda: F.conv2d(a, w4, padding=pad)
    if g is None:  # K2: the rounded g_pre
        g = (args[5].float() * mask[:, :, None, None]).to(x.dtype)
    return lambda: torch.ops.aten.convolution_backward(
        g, a, w4, None, [1, 1], [pad, pad], [1, 1], False, [0, 0], 1,
        [True, True, False])


def train_timing(sd, device, card, launches, errs):
    """Phase 9: B=32.  Returns the kernels line entries of K1-K3b."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli.test import build_model
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb
    from sim2real_lane_segment_tpu_torch.train.supervised import \
        SupervisedTrainer

    rng = np.random.default_rng(SEED + 9)
    images = synthetic_frames(rng, TRAIN_BATCH)
    labels = rng.integers(0, N_CLS, (TRAIN_BATCH, H, W)).astype(np.uint8)
    trainers = {}
    for fused in (True, False):
        model = build_model(ARCH, N_CLS)
        model.load_state_dict(sd)
        trainers[fused] = SupervisedTrainer(num_cls=N_CLS, model=model,
                                            pallas_train=fused)
    masks = train_masks(trainers[True].model, TRAIN_BATCH, device, SEED + 10)

    def step(fused):
        return lambda: trainers[fused].train_step(images, labels, 1e-3,
                                                  masks=masks)

    reps = 3
    t = {True: [], False: []}
    for fused in (False, True, True, False):  # in turns
        t[fused].append(_time_ms(step(fused), reps))
    fused_ms, plain_ms = (sum(t[True]) / 2, sum(t[False]) / 2)
    print(f"timing: train step B={TRAIN_BATCH} --pallas_train "
          f"{fused_ms:.3f} ms ({TRAIN_BATCH / fused_ms * 1e3:.1f} frames/s) "
          f"{t[True]}; plain step (autograd through cuDNN) {plain_ms:.3f} ms "
          f"({TRAIN_BATCH / plain_ms * 1e3:.1f} frames/s) {t[False]}  "
          f"[{card}]")

    calls = []
    real = {k: getattr(ktb, k) for k in TRAIN_KERNELS}

    def recording(name):
        def wrapper(*a, **kw):
            out = real[name](*a, **kw)
            calls.append((name, a, kw, out))
            return out
        return wrapper

    ktb.reset_launches()
    with mock.patch.multiple(ktb, **{k: recording(k)
                                     for k in TRAIN_KERNELS}):
        step(True)()
    torch.cuda.synchronize()
    k1_split = {9: [0, 0.0, 0.0], 1: [0, 0.0, 0.0]}  # taps: calls, ms, cuDNN
    e = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
             "ops": 0.0, "calls": 0, "err": 0.0} for k in TRAIN_KERNELS}
    with torch.no_grad():
        # every call of the B=32 step, kernel against plain on the same
        # operands (as they stand after the step), before any timing
        for name, a, kw, _ in calls:
            kw = {k: v for k, v in kw.items() if k != "out"}
            d = e[name]
            d["calls"] += 1
            label = (f"bfloat16 B={TRAIN_BATCH} {TRAIN_KERNELS[name][0]:16s} "
                     f"site {d['calls']:2d}")
            outs = _as_list(real[name](*a, **kw))
            d["err"] = max(d["err"], _hold_site(
                label, outs,
                _as_list(getattr(ktb, f"{name}_plain")(*a, **kw)),
                TRAIN_REL_TOL["bfloat16"], card))
            if name == "stage":  # fixed-order sums: a second run, same bits
                check(all(torch.equal(o, p) for o, p in zip(
                    outs, real[name](*a, **kw))),
                    f"{label}: two runs differ (a sum in no fixed order)")
        torch.cuda.synchronize()
        expect = {k: 2 * v for k, v in TRAIN_MMA_PER_STEP.items()}
        expect["stage"] += TRAIN_MMA_PER_STEP["stage"]
        print(f"  bfloat16 B={TRAIN_BATCH} launches on the tensor-core route "
              f"(the step, then each site again; K3a twice) "
              f"{json.dumps(ktb.mma_launches)}, expected {json.dumps(expect)}")
        check(ktb.mma_launches == expect,
              "a B=32 train kernel site left the tensor-core route")
        # K1 rewrites its block buffer in place
        for name, a, kw, out in calls:
            d = e[name]
            moved, ops = _train_cost(name, a, out)
            d["bytes"] += moved
            d["ops"] += ops
            ms = _time_ms(lambda: real[name](*a, **kw), 2)
            d["ms"] += ms
            d["plain_ms"] += _time_ms(
                lambda: getattr(ktb, f"{name}_plain")(*a, **kw), 2)
            lib = _train_library(name, a)
            if lib is None:
                d["library_ms"] = None
            else:
                lib_ms = _time_ms(lib, 2)
                d["library_ms"] += lib_ms
                if name == "consumer_fwd":
                    cell = k1_split[a[3].shape[1]]
                    cell[0] += 1
                    cell[1] += ms
                    cell[2] += lib_ms
    kernels = []
    for name, d in e.items():
        check(d["calls"] == TRAIN_LAUNCHES_PER_STEP[name],
              f"{name}: {d['calls']} calls in one step")
        t_bytes = d["bytes"] / PEAK_BYTES * 1e3
        t_ops = d["ops"] / PEAK_BF16_OPS * 1e3
        label, replaces = TRAIN_KERNELS[name]
        entry = {"name": label, "route": "cuda", "source": TRAIN_SOURCE,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": max(errs[name], d["err"]), "ms": d["ms"],
                 "plain_ms": d["plain_ms"], "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": d["library_ms"]}
        kernels.append(entry)
        lib = ("n/a" if d["library_ms"] is None
               else f"{d['library_ms']:.3f} ms")
        print(f"timing: {label} per B={TRAIN_BATCH} train step "
              f"({d['calls']} launches): kernel {d['ms']:.3f} ms, plain "
              f"{d['plain_ms']:.3f} ms, cuDNN yardstick {lib}, bound "
              f"{entry['bound_ms']:.3f} ms ({entry['bound_by']}; "
              f"{d['ops'] / 1e9:.1f} GFLOP, {d['bytes'] / 1e9:.3f} GB)  "
              f"[{card}]")
    print("timing: k1_consumer_fwd split: " + "; ".join(
        f"{'3x3' if taps == 9 else '1x1'} {n} launches {ms:.3f} ms (cuDNN "
        f"yardstick {lib:.3f} ms)" for taps, (n, ms, lib) in k1_split.items())
        + f"  [{card}]")
    for name, limit in MAX_STEP_MS.items():
        check(e[name]["ms"] <= limit,
              f"{TRAIN_KERNELS[name][0]} took {e[name]['ms']:.3f} ms per "
              f"B={TRAIN_BATCH} step, above {limit} ms")
    total = sum(d["ms"] for d in e.values())
    print(f"timing: train kernels {total:.3f} ms of the {fused_ms:.3f} ms "
          f"step; their bound {sum(k['bound_ms'] for k in kernels):.3f} ms  "
          f"[{card}]")
    return kernels


# ---------------------------------------------------------------------------
# LaneNetLite serving (K6) and label extraction (K5)
# ---------------------------------------------------------------------------

def lite_args(*flags):
    from sim2real_lane_segment_tpu_torch.cli import serve

    return serve.parse_args(["--checkpointPath", LITE_CKPT, "--height",
                             str(H), "--width", str(W), *flags])


def lite_quantized(device):
    """The committed student on the card and its int8 network, calibrated
    as ``cli.serve --int8`` calibrates without --calib_dir."""
    from sim2real_lane_segment_tpu_torch.cli import serve
    from sim2real_lane_segment_tpu_torch.cli.test import \
        load_trainer_and_state
    from sim2real_lane_segment_tpu_torch.models.lanenet_int8 import \
        quantize_lanenet

    trainer = load_trainer_and_state("baseline", LITE_CKPT, arch="lite",
                                     height=H, width=W)
    calib = model_input(serve.calibration_frames(lite_args("--int8"),
                                                 "cpu").numpy(),
                        device).permute(0, 2, 3, 1)
    return trainer, quantize_lanenet(trainer.model, calib)


def stem_rows(qn, frames, device):
    """uint8 frames -> (K6's input: f32 stem output [B, h*w, C], h, w)."""
    import torch

    from sim2real_lane_segment_tpu_torch.models import lanenet_fused

    with torch.no_grad():
        return lanenet_fused.stem_rows(
            qn, model_input(frames, device).permute(0, 2, 3, 1))


def compare_int8_body(qn, device, card) -> float:
    """Phase 10: K6 against its plain version at full width on the
    committed student's sites, at B=8 (on an H100 no more (image, tile)
    items than persistent blocks) and at B=64 (each block walks several,
    staging the next in its other halo buffer): every conv site's codes equal,
    logits within the head's f32 reordering.  Returns the logits' largest
    max|err|."""
    import torch

    from sim2real_lane_segment_tpu_torch.kernels import int8_body as kib
    from sim2real_lane_segment_tpu_torch.models.lanenet_fused import \
        fold_body

    body = fold_body(qn)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    worst = 0.0
    for b in (CHECK_BATCH, TIME_BATCH):
        x, hh, ww = stem_rows(qn, synthetic_frames(
            np.random.default_rng(SEED + 11), b), device)
        codes, codes_plain = {}, {}
        kib.reset_launches()
        with torch.no_grad():
            out = kib.int8_body(x, body, hh, ww, record=codes)
            ref = kib.int8_body_plain(x, body, hh, ww, record=codes_plain)
        torch.cuda.synchronize()
        check(list(codes) == list(codes_plain) and len(codes) == 10,
              f"compared sites {list(codes)}")
        th, tw = kib.IMMA_TILE
        items = b * -(-hh // th) * -(-ww // tw)
        print(f"  K6 B={b}: conv launches {kib.launches['conv']}, on the int8 "
              f"tensor cores {kib.mma_launches['conv']} (by halo buffers "
              f"{json.dumps(kib.imma_buffers)}), expected {K6_CONVS}; "
              f"{items} (image, tile) items a launch over {sms} SMs")
        check(kib.launches["conv"] == K6_CONVS
              and kib.mma_launches["conv"] == K6_CONVS,
              f"B={b}: a full-width K6 conv site left the int8 tensor-core "
              f"route")
        for name, q in codes.items():
            diff = int((q != codes_plain[name]).sum())
            print(f"  K6 B={b} site {name:18s} codes {tuple(q.shape)}: {diff} "
                  f"differ, mean code {q.float().mean().item():+.2f}  [{card}]")
            check(diff == 0, f"K6 B={b} {name}: {diff} int8 codes differ "
                  f"from plain")
        err = (out - ref).abs().max().item()
        print(f"  K6 logits [B={b}, {hh * ww}, {out.shape[2]}] max|err| "
              f"{err:.3e} (max|ref| {ref.abs().max().item():.3e}), argmax "
              f"agreement {(out.argmax(2) == ref.argmax(2)).float().mean():.6f}"
              f"  [{card}]")
        torch.testing.assert_close(out, ref, **INT8_LOGIT_TOL,
                                   msg=f"B={b}: K6 logits differ from plain")
        worst = max(worst, err)
    check(TIME_BATCH * -(-hh // th) * -(-ww // tw) > sms,
          f"B={TIME_BATCH} gives no more K6 items than SMs")
    return worst


def lite_serve_phase(card):
    """Phase 11: ``cli.serve --arch lite`` float, ``--int8`` and ``--int8
    --fused`` behind the engine, each on the same requests, once to warm
    up and once counted and timed.  Returns K6's launch counts in the
    fused run and the frames/s per mode."""
    from sim2real_lane_segment_tpu_torch.cli import serve
    from sim2real_lane_segment_tpu_torch.kernels import int8_body as kib

    requests = client_requests(np.random.default_rng(SEED + 12))
    n_frames = sum(f.shape[0] for reqs in requests for f in reqs)
    plain_calls = []
    real_plain = kib.int8_body_plain

    def counting(*a, **kw):
        plain_calls.append(1)
        return real_plain(*a, **kw)

    masks, fps, launches = {}, {}, {}
    for mode, flags in LITE_MODES.items():
        predict_fn, _, _ = serve.build_predict_fn(lite_args(*flags))
        drive_engine(predict_fn, requests)  # warm-up: first-call costs
        with mock.patch.object(kib, "int8_body_plain", counting):
            kib.reset_launches()
            replies, stats, wall = drive_engine(predict_fn, requests)
            launches[mode] = dict(kib.launches)
            mma = kib.mma_launches["conv"]
        masks[mode] = np.concatenate([o for outs in replies for o in outs])
        fps[mode] = n_frames / wall
        print(f"serve lite {mode:10s}: {n_frames} frames in 32 requests, "
              f"{stats['batches']} batches, wall {wall:.3f} s, "
              f"{fps[mode]:.1f} frames/s; K6 launches "
              f"{json.dumps(launches[mode])}  [{card}]")
        if mode == "int8_fused":
            b = stats["batches"]
            expect = {"quant": b, "conv": K6_CONVS * b, "head": b}
            check(launches[mode] == expect,
                  f"K6 launches {launches[mode]}, expected {expect} "
                  f"(1/12/1 per batch)")
            check(mma == K6_CONVS * b, f"K6 conv launches on the int8 tensor "
                  f"cores {mma}, expected {K6_CONVS * b}")
        else:
            check(not any(launches[mode].values()),
                  f"{mode}: K6 launched off its path")
    check(not plain_calls, f"K6's plain version ran {len(plain_calls)} times")
    agree = {k: float((masks[a] == masks[b]).mean()) for k, (a, b) in {
        "int8_fused_vs_int8": ("int8_fused", "int8"),
        "int8_vs_float": ("int8", "float"),
        "int8_fused_vs_float": ("int8_fused", "float")}.items()}
    print(f"serve lite: pixel agreement over {masks['float'].size} pixels "
          f"{json.dumps(agree)}; classes (float) "
          f"{np.bincount(masks['float'].ravel(), minlength=N_CLS).tolist()}"
          f"  [{card}]")
    check(agree["int8_fused_vs_int8"] >= MIN_INT8_AGREEMENT,
          f"fused vs plain int8 agreement {agree['int8_fused_vs_int8']}")
    return launches["int8_fused"], fps


def label_pairs(rng, n, h, w):
    """Seeded uint8 (orig, annot) pairs: noise frames, and annotated
    regions whose channel deltas fire each rule alone and mixed, with
    sparse noise in the annotation."""
    orig = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    delta = np.zeros((n, h, w, 3), np.int16)
    kinds = np.array([(0, 60, 0), (60, 0, 0), (0, 0, 60), (-60, 0, 0),
                      (0, -60, 0), (60, 60, -60), (0, 60, -60)], np.int16)
    for i in range(n):
        for _ in range(12):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            dy, dx = rng.integers(2, h // 3 + 2), rng.integers(2, w // 3 + 2)
            delta[i, y0:y0 + dy, x0:x0 + dx] += kinds[rng.integers(len(kinds))]
    noise = rng.random((n, h, w, 3), dtype=np.float32) < 0.02
    delta += (noise * rng.integers(-30, 31, (n, h, w, 3))).astype(np.int16)
    annot = np.clip(orig + delta, 0, 255).astype(np.uint8)
    return orig, annot


def labelgen_phase(device, card):
    """Phase 12: ``ops.labelgen.process_classes_batch`` on the card (K5) at
    B=32, 480x640 and 120x160, both channel orders, bit-exact against the
    plain version.  Returns (K5 launches in the run, the pairs at
    480x640)."""
    import torch

    from sim2real_lane_segment_tpu_torch.kernels import labelgen as klg
    from sim2real_lane_segment_tpu_torch.ops.labelgen import \
        process_classes_batch

    rng = np.random.default_rng(SEED + 13)
    pairs = {hw: tuple(torch.from_numpy(a).to(device)
                       for a in label_pairs(rng, LABEL_BATCH, *hw))
             for hw in LABEL_SIZES}
    outs = {}
    klg.reset_launches()
    for hw, (orig, annot) in pairs.items():
        for order in ("bgr", "rgb"):
            outs[hw, order] = process_classes_batch(orig, annot, order)
    torch.cuda.synchronize()
    launches = dict(klg.launches)
    check(launches == {"labelgen": 2 * len(LABEL_SIZES)},
          f"K5 launches {launches}")
    for (hw, order), out in outs.items():
        ref = klg.process_classes_plain(*pairs[hw], order)
        diff = int((out != ref).sum())
        print(f"  K5 B={LABEL_BATCH} {hw[0]}x{hw[1]} {order}: {diff} of "
              f"{ref.numel()} pixels differ; classes "
              f"{torch.bincount(ref.flatten().long(), minlength=4).tolist()}"
              f"  [{card}]")
        check(diff == 0, f"K5 {hw} {order}: {diff} pixels differ from plain")
    # frames of two column tiles a strip (after the launch count)
    n, h, w = LABEL_WIDE
    wide = tuple(torch.from_numpy(a).to(device)
                 for a in label_pairs(rng, n, h, w))
    for order in ("bgr", "rgb"):
        diff = int((klg.process_classes(*wide, order)
                    != klg.process_classes_plain(*wide, order)).sum())
        print(f"  K5 B={n} {h}x{w} {order} ({klg.geometry(h, w).tiles} "
              f"column tiles): {diff} pixels differ  [{card}]")
        check(diff == 0, f"K5 {h}x{w} {order}: {diff} pixels differ")
    return launches["labelgen"], pairs[LABEL_SIZES[0]]


def _body_cost(body, b, p) -> tuple[float, float, float]:
    """(bytes, int8 ops, f32 head ops) one K6 body call must move and do:
    the f32 stem rows in, the logits out, every weight once."""
    int8_ops = 0.0
    weights = 0
    for specs in body.blocks:
        for s in specs:
            if s is None:
                continue
            int8_ops += 2.0 * b * p * s.w_rows.numel()
            weights += s.w_rows.numel() + 12 * s.w_rows.shape[1]
    c, n = body.head_w.shape
    first = body.blocks[0][0]
    c_in = first.w_rows.shape[0] // first.taps
    moved = b * p * (c_in + n) * 4 + weights + 4 * (c * n + n)
    return moved, int8_ops, 2.0 * b * p * c * n


def lite_timing(trainer, qn, pairs, device, card, k6_launches, k6_err,
                k5_launches, cls_times):
    """Phase 13: K6 per B=64 forward and K5 per B=32 480x640 batch, beside
    their plain versions and bounds; the whole int8-fused, int8-plain and
    float forwards at B=64; K5's, K6's and the classifier's
    (``cls_times``, from phase 5) device time by torch.profiler beside
    their event readings.
    Returns the kernels line entries of K5, K6."""
    import torch

    from sim2real_lane_segment_tpu_torch.kernels import int8_body as kib
    from sim2real_lane_segment_tpu_torch.kernels import labelgen as klg
    from sim2real_lane_segment_tpu_torch.models.lanenet_fused import (
        fold_body, fused_int8_serve)
    from sim2real_lane_segment_tpu_torch.models.lanenet_int8 import \
        int8_apply
    from sim2real_lane_segment_tpu_torch.ops.augment import (AugmentConfig,
                                                             eval_batch)

    body = fold_body(qn)
    frames = synthetic_frames(np.random.default_rng(SEED + 14), TIME_BATCH)
    x, hh, ww = stem_rows(qn, frames, device)
    frames_dev = torch.from_numpy(frames).to(device)
    with torch.no_grad():
        k6_ms = _time_ms(lambda: kib.int8_body(x, body, hh, ww))
        k6_plain = _time_ms(lambda: kib.int8_body_plain(x, body, hh, ww))
        xn = model_input(frames, device)
        cudnn_fwd = _time_ms(lambda: trainer.model(xn, use_softmax=False))
        cfg = AugmentConfig(height=H, width=W)
        whole = {
            "int8_fused": _time_ms(lambda: fused_int8_serve(qn, frames_dev)),
            "int8_plain": _time_ms(lambda: torch.argmax(int8_apply(
                qn, eval_batch(frames_dev, None, cfg, with_labels=False)[0]),
                dim=-1)),
            "float_bf16": _time_ms(lambda: trainer.predict_step(frames_dev))}
    moved, ops8, ops32 = _body_cost(body, TIME_BATCH, hh * ww)
    t_bytes = moved / PEAK_BYTES * 1e3
    t_ops = (ops8 / PEAK_INT8_OPS + ops32 / PEAK_F32_OPS) * 1e3
    k6 = {"name": "k6_int8_body", "route": "cuda", "source": K6_SOURCE,
          "replaces": K6_REPLACES, "launches": sum(k6_launches.values()),
          "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain,
          "bound_ms": max(t_bytes, t_ops),
          "bound_by": "bytes" if t_bytes >= t_ops else "operations",
          "library_ms": None}
    print(f"timing: k6_int8_body per B={TIME_BATCH} forward (14 launches): "
          f"kernel {k6_ms:.3f} ms, plain (float64 sums) {k6_plain:.3f} ms, "
          f"library n/a (yardstick: the whole float LaneNetLite forward "
          f"through cuDNN in bf16 {cudnn_fwd:.3f} ms), bound "
          f"{k6['bound_ms']:.4f} ms ({k6['bound_by']}; "
          f"{ops8 / 1e9:.1f} G int8 ops, {moved / 1e6:.2f} MB), "
          f"{ops8 / k6_ms / 1e9:.1f} TOP/s  [{card}]")
    print(f"timing: lite frames -> masks at B={TIME_BATCH}: "
          + ", ".join(f"{k} {v:.3f} ms ({TIME_BATCH / v * 1e3:.1f} frames/s)"
                      for k, v in whole.items()) + f"  [{card}]")
    check(k6_ms <= MAX_FWD_MS["k6_int8_body"],
          f"k6_int8_body took {k6_ms:.3f} ms per B={TIME_BATCH} forward, "
          f"above {MAX_FWD_MS['k6_int8_body']} ms")

    orig, annot = pairs
    k5_ms = _time_ms(lambda: klg.process_classes(orig, annot))
    k5_plain = _time_ms(lambda: klg.process_classes_plain(orig, annot))
    px = orig.shape[0] * orig.shape[1] * orig.shape[2]
    k5_bound = 7.0 * px / PEAK_BYTES * 1e3
    k5 = {"name": "k5_labelgen", "route": "cuda", "source": K5_SOURCE,
          "replaces": K5_REPLACES, "launches": k5_launches,
          "max_abs_err": 0.0, "ms": k5_ms, "plain_ms": k5_plain,
          "bound_ms": k5_bound, "bound_by": "bytes", "library_ms": None}
    print(f"timing: k5_labelgen per B={orig.shape[0]} {orig.shape[1]}x"
          f"{orig.shape[2]} batch: kernel {k5_ms:.3f} ms, plain "
          f"{k5_plain:.3f} ms, library n/a, bound {k5_bound:.4f} ms (bytes; "
          f"{7 * px / 1e6:.1f} MB)  [{card}]")
    k5_device = _device_ms(lambda: klg.process_classes(orig, annot),
                           "labelgen_kernel")
    # K6's 14 kernels a forward, by name from csrc/
    names = port_kernel_names()
    with torch.no_grad():
        k6_device = sum(ms for key, _, ms in _device_rows(
            lambda: kib.int8_body(x, body, hh, ww), REPS)
            if port_kernel(key, names) is not None) / REPS
    for name, (ev, dev, bound) in (("k4_classifier", cls_times),
                                   ("k5_labelgen",
                                    (k5_ms, k5_device, k5_bound)),
                                   ("k6_int8_body",
                                    (k6_ms, k6_device, k6["bound_ms"]))):
        seen = (f"{dev:.4f} ms ({dev / bound:.2f}x the bound, "
                f"{bound / dev:.1%} of its rate)" if dev > 0
                else "not measured (the profiler saw no device time)")
        print(f"timing: {name} by torch.profiler {seen}; by CUDA events "
              f"around the wrapper {ev:.4f} ms; bound {bound:.4f} ms  "
              f"[{card}]")
    # the kernel's own time: the wrapper's host time a call is as long as
    # the kernel, so the events read the host; they stand in only where the
    # profiler saw nothing
    k5_guard = k5_device if k5_device > 0 else k5_ms
    check(k5_guard <= MAX_LABEL_MS,
          f"k5_labelgen took {k5_guard:.3f} ms per B={orig.shape[0]} "
          f"{orig.shape[1]}x{orig.shape[2]} batch, above {MAX_LABEL_MS} ms")
    return [k5, k6]



# ---------------------------------------------------------------------------
# the MME step (K1, K2, K3a, K3b twice a step), the st and mme CLIs
# ---------------------------------------------------------------------------

def mme_trainer(sd, policy, device, fused=True):
    from sim2real_lane_segment_tpu_torch.train.mme import MMETrainer

    return MMETrainer(num_cls=N_CLS, model=make_model(sd, policy, device),
                      augment=True, pallas_train=fused, device=device)


def mme_operands(trainer, device):
    """Labelled frames, labels and unlabelled frames from SEED, and the
    step's draws: both batches' augmentation, each phase's masks (channel
    0 of every site dropped, as in phase 6)."""
    import torch

    from sim2real_lane_segment_tpu_torch.ops.augment import draw_augment

    rng = np.random.default_rng(SEED + 14)
    frames = (synthetic_frames(rng, MME_BATCH),
              rng.integers(0, N_CLS, (MME_BATCH, H, W)).astype(np.uint8),
              synthetic_frames(rng, MME_BATCH))
    gen = torch.Generator().manual_seed(SEED + 15)
    kw = dict(draws_l=draw_augment(gen, MME_BATCH, trainer.cfg, device),
              draws_u=draw_augment(gen, MME_BATCH, trainer.cfg, device),
              masks_g=train_masks(trainer.model, MME_BATCH, device,
                                  SEED + 16),
              masks_f=train_masks(trainer.model, MME_BATCH, device,
                                  SEED + 17))
    return frames, kw


def run_mme_step(trainer, frames, kw):
    """One MME step; returns its logs and both stages of the running
    statistics (phase G's update, then phase F's)."""
    import torch

    from sim2real_lane_segment_tpu_torch.train import mme

    stages = []
    real = mme.apply_batch_stats

    def keep(model, updates):
        stages.append({k: {s: t.clone() for s, t in v.items()}
                       for k, v in updates.items()})
        real(model, updates)

    with mock.patch.object(mme, "apply_batch_stats", keep):
        logs = trainer.mme_train_step(*frames, *trainer.lrs_at(0), **kw)
    torch.cuda.synchronize()
    return logs, stages


def _scaled_errs(got, ref) -> list:
    """Per tensor max|err| / max(max|ref|, 1e-2 * the largest |ref|)."""
    big = max(r.abs().max().item() for r in ref)
    return [(a.double() - r.double()).abs().max().item()
            / max(r.abs().max().item(), 1e-2 * big)
            for a, r in zip(got, ref)]


def compare_mme_step(sd, device, dtype_name, card):
    """Phase 14 for one dtype: one augmented MME step of FCDenseNet67,
    B=32, 120x160, (b) through the kernels' plain versions, each call also
    run through its kernel on the same operands and held against the plain
    result (phase G's reversed cotangent included), then (a) through the
    kernels alone from the same state, draws and masks; (a) is held
    against (b).  Returns the largest max|err| per kernel."""
    import torch

    from sim2real_lane_segment_tpu_torch.core.dtypes import (DEFAULT_POLICY,
                                                             F32_POLICY)
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb

    policy = F32_POLICY if dtype_name == "float32" else DEFAULT_POLICY
    site_tol = TRAIN_REL_TOL[dtype_name]
    errs = {k: 0.0 for k in TRAIN_KERNELS}
    worst = {(p, k): (0.0, 0) for p in "GF" for k in TRAIN_KERNELS}
    sites = {k: 0 for k in TRAIN_KERNELS}
    kernel = {k: getattr(ktb, k) for k in TRAIN_KERNELS}

    def holding(name):
        plain = getattr(ktb, f"{name}_plain")

        def wrapper(*a, **kw):
            outs = _as_list(kernel[name](*a, **{k: v for k, v in kw.items()
                                                if k != "out"}))
            ref = plain(*a, **kw)
            sites[name] += 1
            phase = "G" if sites[name] <= TRAIN_LAUNCHES_PER_STEP[name] \
                else "F"
            rels = [_rel(o, r) for o, r in zip(outs, _as_list(ref))]
            check(max(rels) <= site_tol,
                  f"{dtype_name} MME phase {phase} {TRAIN_KERNELS[name][0]} "
                  f"site {sites[name]}: relative errors {rels} > {site_tol}")
            errs[name] = max(errs[name], max(
                (o.float() - r.float()).abs().max().item()
                for o, r in zip(outs, _as_list(ref))))
            if max(rels) >= worst[phase, name][0]:
                worst[phase, name] = (max(rels), sites[name])
            return ref
        return wrapper

    plain_run = mme_trainer(sd, policy, device)
    frames, kw = mme_operands(plain_run, device)
    with mock.patch.multiple(ktb, **{k: holding(k) for k in TRAIN_KERNELS}):
        ref_logs, ref_stages = run_mme_step(plain_run, frames, kw)
    check(sites == {k: 2 * v for k, v in TRAIN_LAUNCHES_PER_STEP.items()},
          f"{dtype_name} MME: compared sites {sites}")
    for (phase, name), (rel, site) in worst.items():
        print(f"  {dtype_name} MME phase {phase} {TRAIN_KERNELS[name][0]:16s}"
              f" {TRAIN_LAUNCHES_PER_STEP[name]:2d} sites: worst max|err|/"
              f"max|ref| {rel:.2e} (site {site})  [{card}]")

    kernel_run = mme_trainer(sd, policy, device)
    ktb.reset_launches()
    logs, stages = run_mme_step(kernel_run, frames, kw)
    launches, mma = dict(ktb.launches), dict(ktb.mma_launches)
    expect = {k: 2 * v for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    expect_mma = {k: 2 * v * (dtype_name == "bfloat16")
                  for k, v in TRAIN_MMA_PER_STEP.items()}
    print(f"  {dtype_name} MME step launches {json.dumps(launches)}, "
          f"expected {json.dumps(expect)}; on the tensor-core route "
          f"{json.dumps(mma)}, expected {json.dumps(expect_mma)}")
    check(launches == expect, f"{dtype_name} MME launch counts differ")
    check(mma == expect_mma, f"{dtype_name} MME: tensor-core routes differ")

    tol = MME_STEP_TOL[dtype_name]
    e_loss = {k: _rel(logs[k], ref_logs[k]) for k in ref_logs}
    e_stats = [max(_rel(st[k][s], ref[k][s]) for k in ref for s in ref[k])
               for st, ref in zip(stages, ref_stages, strict=True)]
    e_g = _scaled_errs(kernel_run.opt_g.trace, plain_run.opt_g.trace)
    e_f = _scaled_errs(kernel_run.opt.mu, plain_run.opt.mu)
    lr_f = kernel_run.lrs_at(0)[2]
    dp = max((a - b).abs().max().item() for a, b in zip(
        kernel_run.params, plain_run.params)) / lr_f
    print(f"  {dtype_name} MME step, kernels vs plain (B={MME_BATCH}): losses "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in e_loss.items()})}"
          f" (values {float(logs['tr_loss_adent']):.5f}, "
          f"{float(logs['tr_loss']):.5f}); running statistics, phase G "
          f"{e_stats[0]:.2e}, phase F {e_stats[1]:.2e}; gradients over "
          f"{len(e_g)} parameters, phase G worst {max(e_g):.2e}, phase F "
          f"worst {max(e_f):.2e}; parameters max|diff| {dp:.3f} x Adam's lr"
          f"  [{card}]")
    check(max(e_loss.values()) <= tol["loss"], f"{dtype_name} MME losses "
          f"{e_loss} > {tol['loss']}")
    check(max(e_stats) <= tol["stats"], f"{dtype_name} MME running "
          f"statistics {e_stats} > {tol['stats']}")
    check(max(e_g + e_f) <= tol["grad"], f"{dtype_name} MME gradients "
          f"{max(e_g)}, {max(e_f)} > {tol['grad']}")
    # Adam's first step is about +-lr per element whatever the gradient's
    # size, so a gradient that is float noise may step either way
    check(dp <= 2.0 + tol["grad"], f"{dtype_name} MME parameters differ by "
          f"{dp} x lr")
    return errs


def train_cli_checked(label, argv, passes, n_lab, card, batch=TRAIN_BATCH):
    """``cli.train.main(argv)`` (``--pallas_train``, ``--log_every 1``, one
    epoch, ``-b batch``) with K1-K3b's counts set to 0 just before and read
    just after: checks the logged steps (``n_lab // batch``), finite losses,
    ``passes`` fused passes a step, every launch on the tensor-core route
    and that no plain version ran.  Returns (result, launches, steps)."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import train as train_cli
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb

    plain_calls = {k: 0 for k in TRAIN_KERNELS}

    def counting(name):
        fn = getattr(ktb, f"{name}_plain")

        def wrapper(*a, **kw):
            plain_calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    with mock.patch.multiple(ktb, **{f"{k}_plain": counting(k)
                                     for k in TRAIN_KERNELS}):
        ktb.reset_launches()
        t0 = time.perf_counter()
        res = train_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ktb.launches)
        mma = dict(ktb.mma_launches)
    with open(os.path.join(res["out_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    logged = [r for r in rows if "train/tr_loss" in r]
    keys = [k for k in logged[0] if k.startswith("train/")] if logged else []
    values = [r[k] for r in logged for k in keys]
    steps = len(logged)
    check(steps == n_lab // batch, f"{label}: {steps} train steps logged")
    check(bool(np.isfinite(values).all()), f"{label}: {values}")
    expect = {k: v * passes * steps
              for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    expect_mma = {k: v * passes * steps
                  for k, v in TRAIN_MMA_PER_STEP.items()}
    print(f"{label}: --augment --pallas_train, 1 epoch, {steps} steps of "
          f"B={batch} in {wall:.1f} s (with validation, test and "
          f"checkpoints); {', '.join(k[6:] for k in keys)} "
          f"{[round(v, 4) for v in values]}, best val_iou "
          f"{res['best_iou']:.3f}  [{card}]")
    print(f"{label}: kernel launches {json.dumps(launches)}, expected "
          f"{json.dumps(expect)} ({passes} pass(es) a step); tensor-core "
          f"route {json.dumps(mma)}; plain versions called "
          f"{json.dumps(plain_calls)}")
    check(launches == expect, f"{label}: launch counts differ")
    check(mma == expect_mma, f"{label}: a launch left the tensor-core route")
    check(not any(plain_calls.values()), f"{label}: a plain version ran")
    return res, launches, steps


def eval_fused_checked(label, module_type, weights, test_dir, n_test, card,
                       arch=ARCH, per_forward=None):
    """``cli.test.main --fused`` on ``test_dir`` with K4's counts set to 0
    just before and read just after: the metrics, the confusion matrix's
    pixel count and K4's launches per batch (``per_forward``, default
    FCDenseNet67's 55/5/1)."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import test as test_cli
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb

    kdb.reset_launches()
    res = test_cli.main(["-t", module_type, "--checkpointPath", weights,
                         "--testDataPath", test_dir, "--arch", arch,
                         "--height", str(H), "--width", str(W), "--fused",
                         "--batch_size", str(TRAIN_BATCH)])
    torch.cuda.synchronize()
    check({"acc", "dice", "iou", "loss", "confusion"} <= set(res),
          f"{label}: cli.test returned {sorted(res)}")
    check(int(res["confusion"].sum()) == n_test * H * W,
          f"{label}: confusion matrix counts {res['confusion'].sum()} "
          f"pixels")
    batches = -(-n_test // TRAIN_BATCH)
    expect = {k: v * batches
              for k, v in (per_forward or K4_PER_FORWARD).items()}
    check(dict(kdb.launches) == expect,
          f"{label}: cli.test --fused: K4 launches {kdb.launches}, "
          f"expected {expect}")
    print(f"{label}: cli.test -t {module_type} --arch {arch} --fused on "
          f"{n_test} "
          f"target/test frames: acc {res['acc']:.4f}, dice "
          f"{res['dice']:.4f}, iou {res['iou']:.4f}; K4 launches "
          f"{json.dumps(kdb.launches)}  [{card}]")
    return res


def two_domain_phase(card, sim_weights):
    """Phase 15: ``cli.train.main --trainType st`` then ``mme`` (from phase
    8's weights), both ``--augment --pallas_train``, one epoch each on a
    two-domain PNG tree, then ``cli.test.main -t mme --fused`` on the MME
    run's weights.  Returns the MME run's launches and steps."""
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "simRealData")
        t0 = time.perf_counter()
        write_png_tree(root, MME_SPLITS, SEED + 18,
                       unlabelled=("target/unlabelled",))
        print(f"two-domain: wrote {sum(n for _, n in MME_SPLITS)} PNG frames "
              f"({', '.join(f'{s} {n}' for s, n in MME_SPLITS)}) in "
              f"{time.perf_counter() - t0:.1f} s")
        n_lab = MME_SPLITS[0][1] + MME_SPLITS[1][1]
        for regime, extra, passes in (
                ("st", [], 1),
                ("mme", ["--pretrained_path", sim_weights], 2)):
            res, launches, steps = train_cli_checked(
                f"two-domain: {regime}", st_args(root, tmp, regime) + extra,
                passes, n_lab, card)
        eval_fused_checked("two-domain", "mme",
                           os.path.join(res["out_dir"], "best_weights.pt"),
                           os.path.join(root, "target", "test"),
                           MME_SPLITS[2][1], card)
    return launches, steps


def st_args(root, out_root, regime):
    """``cli.train`` arguments of one augmented ``--pallas_train`` epoch of
    ``regime`` on the two-domain tree ``root``."""
    return ["--trainType", regime, "--model_name", regime, "--dataPath",
            root, "--arch", ARCH, "--pallas_train", "--augment", "--height",
            str(H), "--width", str(W), "--max_epochs", "1", "-b",
            str(TRAIN_BATCH), "--default_root_dir", out_root, "--log_every",
            "1", "--seed", str(SEED)]


def mme_timing(sd, device, card):
    """Phase 16: the augmented B=32 MME step through the kernels against
    the plain step (autograd through cuDNN), CUDA events per step, medians
    of REPS steps taken in turns; the step's device busy time and idle
    share by torch.profiler; ``augment_batch`` and ``draw_augment`` at
    B=32 from each source size in AUG_SOURCES."""
    import torch

    from sim2real_lane_segment_tpu_torch.core.dtypes import DEFAULT_POLICY
    from sim2real_lane_segment_tpu_torch.ops.augment import (augment_batch,
                                                             draw_augment)

    trainers = {fused: mme_trainer(sd, DEFAULT_POLICY, device, fused)
                for fused in (True, False)}
    frames, _ = mme_operands(trainers[True], device)
    gens = {fused: torch.Generator().manual_seed(SEED + 19)
            for fused in trainers}

    def step(fused):
        t = trainers[fused]
        t.mme_train_step(*frames, *t.lrs_at(0), generator=gens[fused])

    def one_ms(fused):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        step(fused)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1)

    for fused in trainers:  # warm-up
        step(fused)
    torch.cuda.synchronize()
    t = {True: [], False: []}
    for fused in (False, True, True, False):  # in turns
        t[fused] += [one_ms(fused) for _ in range(REPS // 2)]
    med = {k: float(np.median(v)) for k, v in t.items()}
    print(f"timing: MME step B={MME_BATCH} --augment --pallas_train "
          f"{med[True]:.3f} ms (median of {len(t[True])}, range "
          f"{min(t[True]):.3f}-{max(t[True]):.3f}); plain step (autograd "
          f"through cuDNN) {med[False]:.3f} ms (range {min(t[False]):.3f}-"
          f"{max(t[False]):.3f})  [{card}]")

    rows = _device_rows(lambda: step(True))
    busy = sum(ms for _, _, ms in rows)
    names = port_kernel_names()
    ours = [(n, ms) for k, n, ms in rows if port_kernel(k, names)]
    print(f"timing: MME step device busy {busy:.3f} ms of {med[True]:.3f} "
          f"(idle share {max(0.0, 1 - busy / med[True]):.3f}) in "
          f"{sum(n for _, n, _ in rows)} device launches; the port's kernels "
          f"{sum(ms for _, ms in ours):.3f} ms in {sum(n for n, _ in ours)} "
          f"launches  [{card}]")
    check(busy > 0, "torch.profiler saw no device time in the MME step")

    cfg = trainers[True].cfg
    rng = np.random.default_rng(SEED + 20)
    gen = torch.Generator().manual_seed(SEED + 21)
    for src in AUG_SOURCES:
        images = torch.from_numpy(rng.integers(
            0, 256, (MME_BATCH, *src, 3), dtype=np.uint8)).to(device)
        labels = torch.from_numpy(rng.integers(
            0, N_CLS, (MME_BATCH, *src), dtype=np.uint8)).to(device)
        draws = draw_augment(gen, MME_BATCH, cfg, device)
        aug_ms = _time_ms(lambda: augment_batch(images, labels, cfg, draws))
        draw_ms = _time_ms(lambda: draw_augment(gen, MME_BATCH, cfg, device))
        rows = _device_rows(lambda: augment_batch(images, labels, cfg,
                                                  draws))
        print(f"timing: augment_batch B={MME_BATCH} {src[0]}x{src[1]} -> "
              f"{H}x{W} {aug_ms:.3f} ms (device busy "
              f"{sum(ms for _, _, ms in rows):.3f} ms in "
              f"{sum(n for _, n, _ in rows)} launches), draw_augment "
              f"{draw_ms:.3f} ms  [{card}]")


def _train_state(run_dir):
    """(model state dict, optimizer tensors by name) of a run's latest
    checkpoint."""
    from sim2real_lane_segment_tpu_torch.train.checkpoint import \
        load_train_state

    ck = load_train_state(os.path.join(run_dir, "checkpoints_latest",
                                       "latest.pt"))
    opt = ck["optimizer"]
    opts = {"f": opt["f"], "g": opt["g"]} if "g" in opt else {"f": opt}
    tensors = {f"{o}.{k}[{i}]": t for o, st in opts.items()
               for k, ts in st.items() if k != "count"
               for i, t in enumerate(ts)}
    counts = {o: st.get("count") for o, st in opts.items()}
    return ck["model"], tensors, counts


def _state_errs(a: dict, b: dict) -> dict:
    """max|a - b| / max|b| per kind of tensor (weights, running statistics,
    optimizer state), over every tensor of the kind."""
    out = {}
    for k, t in b.items():
        kind = ("stats" if "running" in k or "num_batches" in k
                else "optimizer" if "[" in k else "weights")
        err = _rel(a[k], t) if t.numel() else 0.0
        out[kind] = max(out.get(kind, 0.0), err)
    return out


def cache_equivalence(card, sim_weights):
    """Phase 17, part 1: ``cli.train.main`` with and without
    ``--device_cache`` from the same seed, ``--augment --pallas_train -b
    32 --log_every 1``, 2 epochs of CACHE_STEPS steps: ``sim``, ``st``, and
    ``mme``
    from phase 8's weights.  Every logged row, the final weights, running
    statistics and optimizer state must agree, bit for bit; the cached run
    must replay one graph per step, captured once, and launch the kernels
    only while capturing (the warm-up steps and the capture)."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import train as train_cli
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb
    from sim2real_lane_segment_tpu_torch.train import graphs

    plain_calls = {k: 0 for k in TRAIN_KERNELS}

    def counting(name):
        fn = getattr(ktb, f"{name}_plain")

        def wrapper(*a, **kw):
            plain_calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sim_root = os.path.join(tmp, "simData")
        two_root = os.path.join(tmp, "simRealData")
        write_png_tree(sim_root, CACHE_SIM_SPLITS, SEED + 23)
        write_png_tree(two_root, CACHE_MME_SPLITS, SEED + 24,
                       unlabelled=("target/unlabelled",))
        print(f"cache: wrote {sum(n for _, n in CACHE_SIM_SPLITS)} + "
              f"{sum(n for _, n in CACHE_MME_SPLITS)} PNG frames in "
              f"{time.perf_counter() - t0:.1f} s")
        for regime, root, extra, passes in (
                ("sim", sim_root, [], 1), ("st", two_root, [], 1),
                ("mme", two_root, ["--pretrained_path", sim_weights], 2)):
            runs = {}
            for cache in (False, True):
                args = ["--trainType", regime, "--dataPath", root, "--arch",
                        ARCH, "--pallas_train", "--augment", "--height",
                        str(H), "--width", str(W), "--max_epochs", "2", "-b",
                        str(TRAIN_BATCH), "--default_root_dir", tmp,
                        "--log_every", "1", "--seed", str(SEED),
                        "--model_name", f"{regime}_{int(cache)}", *extra,
                        *(["--device_cache"] if cache else [])]
                with mock.patch.multiple(ktb, **{f"{k}_plain": counting(k)
                                                 for k in TRAIN_KERNELS}):
                    ktb.reset_launches()
                    graphs.reset_counts()
                    t0 = time.perf_counter()
                    res = train_cli.main(args)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    runs[cache] = (res["out_dir"], wall, dict(ktb.launches),
                                   dict(ktb.mma_launches),
                                   dict(graphs.counts))
            rows = {}
            for cache, (out, *_) in runs.items():
                with open(os.path.join(out, "metrics.jsonl")) as f:
                    rows[cache] = [json.loads(line) for line in f]
            logged = [r for r in rows[True] if "train/tr_loss" in r]
            steps = len(logged)
            check(steps == 2 * CACHE_STEPS,
                  f"{regime}: {steps} train steps logged")
            same_rows = rows[True] == rows[False]
            (m0, o0, c0), (m1, o1, c1) = (_train_state(runs[c][0])
                                          for c in (False, True))
            errs = _state_errs({**m1, **o1}, {**m0, **o0})
            bit_equal = (same_rows and c0 == c1
                         and all(torch.equal(m1[k], v) for k, v in m0.items())
                         and all(torch.equal(o1[k], v)
                                 for k, v in o0.items()))
            counts = runs[True][4]
            per_step = {k: v * passes
                        for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
            at_capture = {k: v * (graphs.WARMUP_STEPS + 1)
                          for k, v in per_step.items()}
            mma_at_capture = {k: v * passes * (graphs.WARMUP_STEPS + 1)
                              for k, v in TRAIN_MMA_PER_STEP.items()}
            keys = [k for k in logged[0] if k.startswith("train/")]
            print(f"cache: --trainType {regime}: 2 epochs of {CACHE_STEPS} "
                  f"steps, "
                  f"{runs[False][1]:.1f} s without --device_cache, "
                  f"{runs[True][1]:.1f} s with it (validation, test and "
                  f"checkpoints included); {counts['replays']} graph "
                  f"replays, {counts['captures']} capture(s); logged "
                  f"{', '.join(k[6:] for k in keys)} equal: {same_rows}; "
                  f"final state bit-equal: {bit_equal} (max rel err "
                  f"{json.dumps(errs)})  [{card}]")
            print(f"cache: {regime} kernel launches with --device_cache "
                  f"{json.dumps(runs[True][2])} (warm-up and capture, "
                  f"expected {json.dumps(at_capture)}); tensor-core route "
                  f"{json.dumps(runs[True][3])}; without it "
                  f"{json.dumps(runs[False][2])}; plain versions called "
                  f"{json.dumps(plain_calls)}")
            check(counts == {"captures": 1, "replays": steps},
                  f"{regime}: the cached run took {counts}, not one replay "
                  f"a step")
            check(runs[True][2] == at_capture,
                  f"{regime}: launches at capture differ")
            check(runs[True][3] == mma_at_capture,
                  f"{regime}: a launch left the tensor-core route")
            check(runs[False][2] == {k: v * steps
                                     for k, v in per_step.items()},
                  f"{regime}: eager launch counts differ")
            check(not any(plain_calls.values()), "a plain version ran")
            check(bit_equal, f"{regime}: the cached run differs from the "
                  f"uncached one: rows equal {same_rows}, {errs}")


def cache_timing(sd, device, card):
    """Phase 17, part 2: a 1,536-frame 480x640 split uploaded through
    ``DeviceCachedView`` (time, bytes), then B=32 ``--augment
    --pallas_train`` steps over it: the graphed supervised step, the eager
    step over the same cache and over host batches, the graphed and the
    eager MME step, medians of CACHE_TIMED_STEPS each in turns (CUDA
    events between steps: the host is not synchronized, so a host-paced
    step reads the host's time); the kernels of one replay against one
    eager step by name (torch.profiler); each graph's device busy time and
    idle share over CACHE_PROFILED_REPLAYS replays and its private pool."""
    import torch

    from sim2real_lane_segment_tpu_torch.core.dtypes import DEFAULT_POLICY
    from sim2real_lane_segment_tpu_torch.data.device_cache import \
        DeviceCachedView
    from sim2real_lane_segment_tpu_torch.train import graphs
    from sim2real_lane_segment_tpu_torch.train.supervised import \
        SupervisedTrainer

    rng = np.random.default_rng(SEED + 25)
    t0 = time.perf_counter()
    n, (h, w) = CACHE_FRAMES, CACHE_SIZE
    images = np.frombuffer(bytearray(rng.bytes(n * h * w * 3)),
                           np.uint8).reshape(n, h, w, 3)
    labels = (np.frombuffer(rng.bytes(n * h * w), np.uint8) % N_CLS
              ).reshape(n, h, w)
    made = time.perf_counter() - t0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    view = DeviceCachedView.from_arrays(images, labels, device,
                                        name="train480")
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - before
    print(f"cache: {n} seeded frames at {h}x{w} (made in {made:.1f} s) "
          f"uploaded through DeviceCachedView in {up_s:.3f} s "
          f"({view.images.numel()} bytes of images, {view.labels.numel()} "
          f"of labels; torch.cuda.memory_allocated +{held} bytes, "
          f"{view.nbytes / up_s / 1e9:.2f} GB/s)  [{card}]")
    check(held >= view.nbytes, f"the cache holds {held} bytes")

    def sup():
        return SupervisedTrainer(num_cls=N_CLS, augment=True,
                                 pallas_train=True, device=device,
                                 model=make_model(sd, DEFAULT_POLICY, device))

    trainers = {"graphed": sup(), "eager_cache": sup(), "eager_host": sup(),
                "mme_graphed": mme_trainer(sd, DEFAULT_POLICY, device),
                "mme_eager": mme_trainer(sd, DEFAULT_POLICY, device)}
    gens = {k: torch.Generator().manual_seed(SEED + 26) for k in trainers}
    total = 2 + 2 * CACHE_TIMED_STEPS + 2 * CACHE_PROFILED_REPLAYS
    idx = rng.integers(0, n, (total, MME_BATCH))
    idx2 = np.stack([idx, rng.integers(0, n, (total, MME_BATCH))], 1)
    dev_idx = torch.from_numpy(idx2).to(device)
    sup_arrays = (view.images, view.labels)
    mme_arrays = (view.images, view.labels, view.images)
    pos = {k: 0 for k in trainers}

    def step(mode):
        t, k = trainers[mode], pos[mode]
        pos[mode] += 1
        gen = gens[mode]
        if mode == "graphed":
            t.run_scan_chunk(sup_arrays, idx[k:k + 1], gen, 0)
        elif mode == "mme_graphed":
            t.run_scan_chunk(mme_arrays, idx2[k:k + 1], gen, 0)
        elif mode == "eager_cache":
            r = dev_idx[k, 0]
            t.train_step(view.images[r], view.labels[r], t.lr_at(0),
                         generator=gen)
        elif mode == "eager_host":
            t.train_step(images[idx[k]], labels[idx[k]], t.lr_at(0),
                         generator=gen)
        else:
            lab, unl = dev_idx[k]
            t.mme_train_step(view.images[lab], view.labels[lab],
                             view.images[unl], *t.lrs_at(0), generator=gen)

    def times(mode, reps):
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        evs[0].record()
        for i in range(reps):
            step(mode)
            evs[i + 1].record()
        torch.cuda.synchronize()
        return [evs[i].elapsed_time(evs[i + 1]) for i in range(reps)]

    for mode in trainers:  # captures, and the eager paths' warm-up
        step(mode)
    torch.cuda.synchronize()
    graphs.reset_counts()
    t = {k: [] for k in trainers}
    half = CACHE_TIMED_STEPS // 2
    for mode in ("graphed", "eager_cache", "eager_host", "eager_host",
                 "eager_cache", "graphed", "mme_graphed", "mme_eager",
                 "mme_eager", "mme_graphed"):
        t[mode] += times(mode, half)
    check(graphs.counts["replays"] == 4 * half,
          f"{graphs.counts['replays']} replays timed")
    med = {k: float(np.median(v)) for k, v in t.items()}
    for mode, v in t.items():
        print(f"timing: B={MME_BATCH} {mode} step over the {h}x{w} cache "
              f"{med[mode]:.3f} ms (median of {len(v)}, range "
              f"{min(v):.3f}-{max(v):.3f})  [{card}]")

    # the port's kernels of one replay against one eager step, by name
    names = port_kernel_names()

    def ours(rows):
        out = {}
        for k, c, _ in rows:
            name = port_kernel(k, names)
            if name:
                out[name] = out.get(name, 0) + c
        return out

    for graphed, eager in (("graphed", "eager_cache"),
                           ("mme_graphed", "mme_eager")):
        got = ours(_device_rows(lambda: step(graphed)))
        ref = ours(_device_rows(lambda: step(eager)))
        print(f"cache: {graphed} one replay launched {sum(got.values())} "
              f"kernels of the port's, one eager step {sum(ref.values())}; "
              f"by name equal: {got == ref}; {json.dumps(got)}  [{card}]")
        check(got and got == ref, f"{graphed}: a replay launches other "
              f"kernels than an eager step: {got} against {ref}")

    for mode, arrays, ix in (("graphed", sup_arrays, idx),
                             ("mme_graphed", mme_arrays, idx2)):
        tr = trainers[mode]
        k = pos[mode]
        pos[mode] += 2 * CACHE_PROFILED_REPLAYS
        chunks = iter((ix[k:k + CACHE_PROFILED_REPLAYS],
                       ix[k + CACHE_PROFILED_REPLAYS:
                          k + 2 * CACHE_PROFILED_REPLAYS]))
        rows = _device_rows(lambda: tr.run_scan_chunk(
            arrays, next(chunks), gens[mode], 0))
        busy = sum(ms for _, _, ms in rows) / CACHE_PROFILED_REPLAYS
        port = sum(ms for k, _, ms in rows if port_kernel(k, names)
                   ) / CACHE_PROFILED_REPLAYS
        print(f"timing: {mode} step device busy {busy:.3f} ms of "
              f"{med[mode]:.3f} (idle share "
              f"{max(0.0, 1 - busy / med[mode]):.3f}) over "
              f"{CACHE_PROFILED_REPLAYS} replays, "
              f"{sum(c for _, c, _ in rows) // CACHE_PROFILED_REPLAYS} "
              f"device launches a step, the port's kernels {port:.3f} ms of "
              f"it; the graph's private pool {tr.graph.pool_bytes} bytes  "
              f"[{card}]")
        check(busy > 0, f"torch.profiler saw no device time in {mode}")
        check(tr.graph.pool_bytes > 0, f"{mode}: pool {tr.graph.pool_bytes}")
    rows = _device_rows(lambda: step("eager_cache"))
    busy = sum(ms for _, _, ms in rows)
    print(f"timing: eager_cache step device busy {busy:.3f} ms of "
          f"{med['eager_cache']:.3f} (idle share "
          f"{max(0.0, 1 - busy / med['eager_cache']):.3f})  [{card}]")
    del trainers, view


# ---------------------------------------------------------------------------
# phase 18: the HM and CycleGAN regimes, and the domain study
# ---------------------------------------------------------------------------

def frames_480(rng: np.random.Generator, n: int) -> np.ndarray:
    """uint8 (n, 480, 640, 3) frames at the simulator's render size:
    low-frequency colour fields with pixel noise."""
    import torch
    import torch.nn.functional as F

    base = torch.from_numpy(rng.uniform(0, 255, (n, 3, 6, 8)).astype(
        np.float32))
    x = F.interpolate(base, size=FRAME_SIZE, mode="bilinear",
                      align_corners=False)
    x = x + torch.from_numpy(rng.normal(0, 6, (n, 3, *FRAME_SIZE)).astype(
        np.float32))
    return x.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy().copy()


def write_frames(directory: str, frames: np.ndarray) -> None:
    from sim2real_lane_segment_tpu_torch.data.png import write_png

    os.makedirs(directory, exist_ok=True)
    for i, img in enumerate(frames):
        write_png(os.path.join(directory, f"{i:06d}.png"), img)


def read_frames(directory: str) -> np.ndarray:
    from sim2real_lane_segment_tpu_torch.data.png import read_png

    return np.stack([read_png(os.path.join(directory, f))
                     for f in sorted(os.listdir(directory))])


def resample_check(device, card):
    """Phase 18a: both resamplers on the card, bit-equal to the CPU."""
    import torch

    from sim2real_lane_segment_tpu_torch.ops.resize import (
        resize_cubic_u8, resize_lanczos4_u8)

    rng = np.random.default_rng(SEED + 30)
    for fn, src, dst in ((resize_cubic_u8, FRAME_SIZE, (H, W)),
                         (resize_lanczos4_u8, (H, W), FRAME_SIZE)):
        x = torch.from_numpy(rng.integers(0, 256, (RESAMPLE_BATCH, *src, 3),
                                          dtype=np.uint8))
        xd = x.to(device)
        got = fn(xd, *dst).cpu()
        want = fn(x, *dst)
        diff = int((got != want).sum())
        ms = _time_ms(lambda: fn(xd, *dst))
        print(f"resample: {fn.__name__} B={RESAMPLE_BATCH} {src[0]}x{src[1]} "
              f"-> {dst[0]}x{dst[1]}: {diff} values differ from the CPU; "
              f"{ms:.3f} ms a batch  [{card}]")
        check(diff == 0, f"{fn.__name__} on the card differs from the CPU")


def hist_match_phase(device, card, tmp):
    """Phase 18b: ``cli.hist_match.main`` on HM_FRAMES source and reference
    frames at 480x640; every matched frame against
    ``match_histograms_batch`` on the CPU; matched frames/s on the card."""
    import random

    import torch

    from sim2real_lane_segment_tpu_torch.cli import hist_match
    from sim2real_lane_segment_tpu_torch.ops.histmatch import \
        match_histograms_batch

    rng = np.random.default_rng(SEED + 31)
    src = frames_480(rng, HM_FRAMES)
    ref = (frames_480(rng, HM_FRAMES).astype(np.uint16) ** 2 // 255).astype(
        np.uint8)
    t0 = time.perf_counter()
    write_frames(os.path.join(tmp, "hm_src", "input"), src)
    write_frames(os.path.join(tmp, "hm_ref", "input"), ref)
    print(f"hist_match: wrote {2 * HM_FRAMES} PNG frames at 480x640 in "
          f"{time.perf_counter() - t0:.1f} s")
    random.seed(SEED)
    t0 = time.perf_counter()
    n = hist_match.main(["--ds_source", os.path.join(tmp, "hm_src"),
                         "--ds_reference", os.path.join(tmp, "hm_ref"),
                         "--batch_size", str(HM_BATCH)])
    wall = time.perf_counter() - t0
    random.seed(SEED)
    order = list(range(HM_FRAMES))
    random.shuffle(order)
    want = match_histograms_batch(torch.from_numpy(src),
                                  torch.from_numpy(ref[order])).numpy()
    got = read_frames(os.path.join(tmp, "hm_src", "input"))
    diff = int((got != want).sum())
    check(n == HM_FRAMES and diff == 0,
          f"hist_match: {n} frames, {diff} values differ from the CPU")
    xs = torch.from_numpy(src[:HM_BATCH]).to(device)
    xr = torch.from_numpy(ref[:HM_BATCH]).to(device)
    ms = _time_ms(lambda: match_histograms_batch(xs, xr))
    print(f"hist_match: cli.hist_match matched {n} frames (batches of "
          f"{HM_BATCH}) in {wall:.2f} s with its PNG reads and writes "
          f"({n / wall:.1f} frames/s), every frame equal to the CPU's; "
          f"match_histograms_batch B={HM_BATCH} 480x640 {ms:.3f} ms on the "
          f"card ({HM_BATCH / ms * 1e3:.1f} matched frames/s)  [{card}]")


def _cg_state(tr) -> dict:
    return {f"{name}.{k}": v.detach().cpu().clone()
            for name in ("g_ab", "g_ba", "d_a", "d_b")
            for k, v in getattr(tr, name).state_dict().items()}


def _norm_fed_biases(net) -> set:
    """Names of the conv biases an InstanceNorm follows: the norm removes
    them, so their gradient is zero in exact arithmetic."""
    from torch import nn

    from sim2real_lane_segment_tpu_torch.models.cyclegan import InstanceNorm

    out = set()
    for prefix, mod in net.named_modules():
        if isinstance(mod, nn.Sequential):
            kids = list(mod.named_children())
            for (name, m), (_, nxt) in zip(kids, kids[1:]):
                if isinstance(m, nn.Conv2d) and isinstance(nxt, InstanceNorm):
                    out.add(f"{prefix}.{name}.bias".lstrip("."))
    return out


def cyclegan_checks(device, card):
    """Phase 18c: the full-width generator (f32, TF32 off) against itself
    in float64 on the card; one ``CycleGANTrainer.train_step`` on the card
    against the same step on the CPU from the same weights and inputs."""
    import torch

    from sim2real_lane_segment_tpu_torch.core.dtypes import (F32_POLICY,
                                                             F64_POLICY)
    from sim2real_lane_segment_tpu_torch.models.cyclegan import \
        GeneratorResNet
    from sim2real_lane_segment_tpu_torch.train.cyclegan import \
        CycleGANTrainer

    torch.manual_seed(SEED + 32)
    gen = GeneratorResNet(policy=F32_POLICY)
    n_params = sum(p.numel() for p in gen.parameters())
    check(n_params == CG_PARAMS, f"generator has {n_params} parameters")
    gen64 = GeneratorResNet(policy=F64_POLICY)
    gen64.load_state_dict(gen.state_dict())
    gen, gen64 = gen.to(device).eval(), gen64.double().to(device).eval()
    rng = np.random.default_rng(SEED + 33)
    x = torch.from_numpy(rng.uniform(-1, 1, (CG_BATCH, 3, H, W)).astype(
        np.float32)).to(device)
    with torch.no_grad():
        y, y64 = gen(x), gen64(x.double())
    err = float((y.double() - y64).abs().max())
    print(f"cyclegan: GeneratorResNet (9 residual blocks, {n_params:,} "
          f"parameters) B={CG_BATCH} {H}x{W} float32 against float64 on the "
          f"card: max|err| {err:.3e} (limit {GEN_F64_ATOL:g})  [{card}]")
    check(bool(torch.isfinite(y).all()) and err <= GEN_F64_ATOL,
          "the float32 generator strays from float64")

    inputs = [torch.from_numpy(rng.uniform(-1, 1, (CG_BATCH, 3, H, W))
                               .astype(np.float32)) for _ in range(4)]
    trainers = {}
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        torch.manual_seed(SEED + 34)  # the same initial weights
        trainers[side] = CycleGANTrainer(device=dev)
    logs = {}
    for side, tr in trainers.items():
        _, out = tr.train_step(*(t.to(tr.device) for t in inputs))
        logs[side] = {k: float(v) for k, v in out.items()}
    loss_err = max(abs(logs["card"][k] - v) / abs(v)
                   for k, v in logs["cpu"].items())
    check(loss_err <= CG_LOSS_RTOL, f"cyclegan step losses {logs}")
    worst_g, worst_name, worst_noise = 0.0, "", 0.0
    for opt, nets in (("opt_g", ("g_ab", "g_ba")), ("opt_d", ("d_a", "d_b"))):
        mus = [getattr(trainers[side], opt).mu for side in ("card", "cpu")]
        names = [(net, n) for net in nets
                 for n, _ in getattr(trainers["cpu"], net).named_parameters()]
        largest = max(float(m.abs().max()) for m in mus[1])
        for (net, name), g, w in zip(names, *mus):
            if name in _norm_fed_biases(getattr(trainers["cpu"], net)):
                # zero in exact arithmetic: float noise on both sides
                worst_noise = max(worst_noise, float(g.abs().max()) / largest,
                                  float(w.abs().max()) / largest)
                continue
            err = float((g.cpu() - w).abs().max()) / max(
                float(w.abs().max()), 1e-2 * largest)
            if err > worst_g:
                worst_g, worst_name = err, f"{net}.{name}"
    after = {side: _cg_state(tr) for side, tr in trainers.items()}
    worst_moved = max(float((after["card"][k] - v).abs().max())
                      for k, v in after["cpu"].items())
    print(f"cyclegan: one train_step B={CG_BATCH} card against CPU: losses "
          f"{ {k: round(v, 6) for k, v in logs['card'].items()} }, max rel "
          f"err {loss_err:.2e} (limit {CG_LOSS_RTOL:g}); gradients (Adam's "
          f"first moment) max scaled err {worst_g:.2e} at {worst_name} "
          f"(limit {CG_GRAD_RTOL:g}); the biases that feed an InstanceNorm "
          f"(zero gradient) at most {worst_noise:.2e} of the largest "
          f"gradient (limit {CG_NOISE_G:g}); parameters max|diff| "
          f"{worst_moved:.3e} (limit 2 lr = {2 * CG_LR:g})  [{card}]")
    check(worst_g <= CG_GRAD_RTOL, "cyclegan step gradients differ")
    check(worst_noise <= CG_NOISE_G, "cyclegan step: a bias that feeds an "
          "InstanceNorm has more than noise for a gradient")
    check(worst_moved <= 2 * CG_LR + 1e-6, "cyclegan step parameters differ")


def cyclegan_training(device, card, tmp, source_dir, target_dir):
    """Phase 18d: ``cli.train_cyclegan.main`` for 2 epochs at B=4; the B=4
    step's median time by CUDA events and idle share by torch.profiler;
    then ``cli.sim2real_convert.main`` over CONVERT_FRAMES frames at
    480x640.  Returns the run's ``g_ab.pt``."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import (sim2real_convert,
                                                     train_cyclegan)
    from sim2real_lane_segment_tpu_torch.train.cyclegan import \
        CycleGANTrainer

    out = os.path.join(tmp, "cyclegan")
    t0 = time.perf_counter()
    res = train_cyclegan.main(["--source_dir", source_dir, "--target_dir",
                               target_dir, "--out", out, "--epochs", "2",
                               "-b", str(CG_BATCH), "--max_images",
                               str(CG_TREE)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "history.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    values = [v for r in rows for k, v in r.items() if k != "epoch"]
    check(len(rows) == 2 and bool(np.isfinite(values).all()),
          f"train_cyclegan history {rows}")
    g_ab = os.path.join(out, "g_ab.pt")
    sim2real_convert.load_generator(g_ab)
    print(f"cyclegan: cli.train_cyclegan 2 epochs x {CG_TREE // CG_BATCH} "
          f"steps of B={CG_BATCH} on {CG_TREE}/{CG_TREE} frames in "
          f"{wall:.1f} s (with the PNG reads and the bicubic resize); last "
          f"losses {rows[-1]}; g_ab.pt loads into sim2real_convert  "
          f"[{card}]")

    torch.manual_seed(SEED + 35)
    tr = CycleGANTrainer(device=device)
    rng = np.random.default_rng(SEED + 36)
    batch = [torch.from_numpy(rng.uniform(-1, 1, (CG_BATCH, 3, H, W)).astype(
        np.float32)).to(device) for _ in range(4)]

    def step():
        tr.train_step(*batch)

    def one_ms():
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        step()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1)

    step()
    torch.cuda.synchronize()
    times = [one_ms() for _ in range(REPS)]
    med = float(np.median(times))
    rows = _device_rows(step)
    busy = sum(ms for _, _, ms in rows)
    print(f"cyclegan: train_step B={CG_BATCH} {H}x{W} float32 {med:.3f} ms "
          f"(median of {REPS}, range {min(times):.3f}-{max(times):.3f}); "
          f"device busy {busy:.3f} ms (idle share "
          f"{max(0.0, 1 - busy / med):.3f}) in "
          f"{sum(n for _, n, _ in rows)} device launches; the largest: "
          + "; ".join(f"{k[:60]} {ms:.3f} ms ({n})" for k, n, ms in
                      sorted(rows, key=lambda r: -r[2])[:6])
          + f"  [{card}]")
    check(busy > 0, "torch.profiler saw no device time in the CycleGAN step")

    db = os.path.join(tmp, "convert_db")
    frames = frames_480(np.random.default_rng(SEED + 37), CONVERT_FRAMES)
    write_frames(os.path.join(db, "input"), frames)
    t0 = time.perf_counter()
    n = sim2real_convert.main(["--dataPath", db, "--modelWeightsPath",
                               g_ab])
    wall = time.perf_counter() - t0
    got = read_frames(os.path.join(db, "input"))
    rewritten = int(sum(g.shape != f.shape or (g != f).any()
                        for g, f in zip(got, frames)))
    check(n == CONVERT_FRAMES
          and got.shape == (n, *sim2real_convert.OUT_SIZE, 3)
          and rewritten == n, f"sim2real_convert: {n} frames, shape "
          f"{got.shape}, {rewritten} rewritten")
    model = sim2real_convert.load_generator(g_ab)
    x = torch.from_numpy(frames[:16, :H, :W]).to(device)
    ms = _time_ms(lambda: sim2real_convert.generate(model, x))
    print(f"cyclegan: cli.sim2real_convert restyled {n} frames at 480x640 "
          f"in {wall:.2f} s with its PNG reads and writes ({n / wall:.1f} "
          f"frames/s), all rewritten at 480x640x3 uint8; the generator "
          f"(bf16) B=16 {H}x{W} {ms:.3f} ms  [{card}]")
    return g_ab


def regimes_phase(card, tmp, root, g_ab):
    """Phase 18e: the HM and CycleGAN chains through the kernels: the
    two-domain tree ``root`` histogram-matched (one copy) and restyled
    (another), then one epoch of ``--trainType st --pallas_train
    --augment`` and ``cli.test --fused`` on each."""
    import shutil

    from sim2real_lane_segment_tpu_torch.cli import (hist_match,
                                                     sim2real_convert)

    trees = {"hm": os.path.join(tmp, "srd_hm"),
             "cyclegan": os.path.join(tmp, "srd_cg")}
    for tree in trees.values():
        shutil.copytree(root, tree)
    hist_match.main(["--ds_source", os.path.join(trees["hm"], "source"),
                     "--ds_reference", os.path.join(trees["hm"], "target",
                                                    "unlabelled")])
    sim2real_convert.main(["--dataPath", os.path.join(trees["cyclegan"],
                                                      "source"),
                           "--modelWeightsPath", g_ab])
    n_lab = MME_SPLITS[0][1] + MME_SPLITS[1][1]
    for regime, tree in trees.items():
        res, _, _ = train_cli_checked(
            f"regimes: {regime}", st_args(tree, tree, "st"), 1, n_lab, card)
        eval_fused_checked(f"regimes: {regime}", "sandt",
                           os.path.join(res["out_dir"], "best_weights.pt"),
                           os.path.join(tree, "target", "test"),
                           MME_SPLITS[2][1], card)


def study_phase(card, tmp):
    """Phase 18f: ``cli.domain_study.main`` over seeded trees (the study
    skips rendering), five rows, then a second call that resumes without
    training."""
    from sim2real_lane_segment_tpu_torch.cli import domain_study
    from sim2real_lane_segment_tpu_torch.train import loop

    work = os.path.join(tmp, "study")
    for dom, seed in (("sourceData", SEED + 40), ("targetData", SEED + 41)):
        write_png_tree(os.path.join(work, dom), STUDY_SPLITS, seed,
                       scale=FRAME_SIZE[0] // H)
    regimes = ["baseline", "st", "hm", "cyclegan", "mme"]
    argv = ["--workdir", work, "--arch", ARCH, "--epochs", "1",
            "--cg_epochs", "1", "-b", str(TRAIN_BATCH), "--regimes",
            *regimes]
    t0 = time.perf_counter()
    res = domain_study.main(argv)
    wall = time.perf_counter() - t0
    with open(os.path.join(work, "study_summary.json")) as f:
        summary = json.load(f)
    check(list(res) == regimes and summary == res,
          f"study rows {list(res)}")
    check(all(np.isfinite(v) for row in res.values() for v in row.values()),
          f"study rows {res}")

    def no_fit(*a, **kw):
        raise AssertionError("the resumed study trained")

    t0 = time.perf_counter()
    with mock.patch.object(loop, "fit", no_fit):
        again = domain_study.main(argv)
    resumed = time.perf_counter() - t0
    check(again == res, "the resumed study changed its rows")
    print(f"study: cli.domain_study --arch {ARCH} --epochs 1 --cg_epochs 1, "
          f"five regimes in {wall:.1f} s; target-test iou "
          f"{ {k: round(v['iou'], 4) for k, v in res.items()} }; resumed in "
          f"{resumed:.1f} s without training  [{card}]")


def regimes_study_phase(device, card):
    """Phase 18: the HM and CycleGAN regimes and the domain study."""
    with tempfile.TemporaryDirectory() as tmp:
        resample_check(device, card)
        hist_match_phase(device, card, tmp)
        cyclegan_checks(device, card)
        root = os.path.join(tmp, "simRealData")
        write_png_tree(root, MME_SPLITS, SEED + 38,
                       unlabelled=("target/unlabelled",),
                       scale=FRAME_SIZE[0] // H)
        g_ab = cyclegan_training(
            device, card, tmp, os.path.join(root, "source", "input"),
            os.path.join(root, "target", "unlabelled", "input"))
        regimes_phase(card, tmp, root, g_ab)
        study_phase(card, tmp)


# ---------------------------------------------------------------------------
# phase 19: the serving student's life: LaneNetLite trained through the
# CLIs, distilled from FCDenseNet67 (its frozen forward through K4),
# calibrated on full-size PNGs and served in int8 through K6
# ---------------------------------------------------------------------------

def _plain_counting(module, names, calls):
    """``mock.patch.multiple`` keywords that count the calls of
    ``module``'s plain versions ``names`` into ``calls``."""
    def counting(name):
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper
    return {n: counting(n) for n in names}


def lite_train_phase(card, tmp):
    """Phase 19a: ``cli.train --arch lite --augment -b 32`` at full width
    (bf16), ``--trainType sim`` and then ``mme`` (from the sim run's
    weights), 2 epochs of LITE_STEPS steps each, without and with
    ``--device_cache``: every logged row and the final weights, running
    statistics and optimizer state bit-equal, one graph replay a step,
    captured once.  Returns the uncached sim run's ``best_weights.pt``."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import train as train_cli
    from sim2real_lane_segment_tpu_torch.train import graphs

    sim_root = os.path.join(tmp, "liteSim")
    two_root = os.path.join(tmp, "liteSimReal")
    write_png_tree(sim_root, LITE_SIM_SPLITS, SEED + 50)
    write_png_tree(two_root, LITE_MME_SPLITS, SEED + 51,
                   unlabelled=("target/unlabelled",))
    weights = None
    for regime, root in (("sim", sim_root), ("mme", two_root)):
        runs = {}
        for cache in (False, True):
            argv = ["--trainType", regime, "--dataPath", root, "--arch",
                    "lite", "--augment", "--height", str(H), "--width",
                    str(W), "--max_epochs", "2", "-b", str(TRAIN_BATCH),
                    "--default_root_dir", tmp, "--log_every", "1",
                    "--seed", str(SEED), "--model_name",
                    f"lite_{regime}_{int(cache)}",
                    *(["--pretrained_path", weights] if regime == "mme"
                      else []),
                    *(["--device_cache"] if cache else [])]
            graphs.reset_counts()
            t0 = time.perf_counter()
            res = train_cli.main(argv)
            torch.cuda.synchronize()
            runs[cache] = (res["out_dir"], time.perf_counter() - t0,
                           dict(graphs.counts))
        if regime == "sim":
            weights = os.path.join(runs[False][0], "best_weights.pt")
        rows = {}
        for cache, (out, *_) in runs.items():
            with open(os.path.join(out, "metrics.jsonl")) as f:
                rows[cache] = [json.loads(line) for line in f]
        logged = [r for r in rows[True] if any(k.startswith("train/")
                                                for k in r)]
        values = [v for r in logged for k, v in r.items()
                  if k.startswith("train/")]
        steps = len(logged)
        check(steps == 2 * LITE_STEPS, f"lite {regime}: {steps} steps logged")
        check(bool(np.isfinite(values).all()), f"lite {regime}: {values}")
        same_rows = rows[True] == rows[False]
        (m0, o0, c0), (m1, o1, c1) = (_train_state(runs[c][0])
                                      for c in (False, True))
        errs = _state_errs({**m1, **o1}, {**m0, **o0})
        bit_equal = (same_rows and c0 == c1
                     and all(torch.equal(m1[k], v) for k, v in m0.items())
                     and all(torch.equal(o1[k], v) for k, v in o0.items()))
        counts = runs[True][2]
        print(f"lite train: cli.train --trainType {regime} --arch lite "
              f"--augment, 2 epochs of {LITE_STEPS} steps of B={TRAIN_BATCH}"
              f": {runs[False][1]:.1f} s without --device_cache, "
              f"{runs[True][1]:.1f} s with it; {counts['replays']} replays, "
              f"{counts['captures']} capture(s); rows equal {same_rows}; "
              f"final state bit-equal {bit_equal} (max rel err "
              f"{json.dumps(errs)})  [{card}]")
        check(counts == {"captures": 1, "replays": steps},
              f"lite {regime}: the cached run took {counts}")
        check(runs[False][2] == {"captures": 0, "replays": 0},
              f"lite {regime}: the uncached run replayed a graph")
        check(bit_equal, f"lite {regime}: the cached run differs from the "
              f"uncached one: rows equal {same_rows}, {errs}")
    return weights


def lite_step_timing(device, card):
    """Phase 19a, timing: the full-width LaneNetLite B=32 train step
    (bf16, augmented) eager against one graph replay a step, over a
    LITE_TIMED_FRAMES-frame split on the card (CUDA events over
    LITE_TIMED_STEPS steps, in two turns)."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli.test import build_model
    from sim2real_lane_segment_tpu_torch.data.device_cache import \
        DeviceCachedView
    from sim2real_lane_segment_tpu_torch.train.supervised import \
        SupervisedTrainer

    rng = np.random.default_rng(SEED + 52)
    view = DeviceCachedView.from_arrays(
        synthetic_frames(rng, LITE_TIMED_FRAMES),
        rng.integers(0, N_CLS, (LITE_TIMED_FRAMES, H, W), dtype=np.uint8),
        device)
    arrays = (view.images, view.labels)
    torch.manual_seed(SEED)
    trainer = SupervisedTrainer(model=build_model("lite", N_CLS),
                                augment=True, height=H, width=W,
                                device=device)
    gen = torch.Generator().manual_seed(SEED)

    def chunk():
        return rng.integers(0, LITE_TIMED_FRAMES,
                            (LITE_TIMED_STEPS, TRAIN_BATCH))

    def eager(idx):
        lr = trainer.lr_at(0)
        for row in torch.from_numpy(idx).to(device):
            trainer.train_step(arrays[0][row], arrays[1][row], lr,
                               generator=gen)

    def graphed(idx):
        trainer.run_scan_chunk(arrays, idx, gen, 0)

    times = {"eager": [], "graphed": []}
    for name, fn in (("eager", eager), ("graphed", graphed)) * 2:
        fn(chunk()[:3])  # warm-up (the graph's capture)
        idx = chunk()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn(idx)
        t1.record()
        torch.cuda.synchronize()
        times[name].append(t0.elapsed_time(t1) / LITE_TIMED_STEPS)
    print(f"lite train timing: B={TRAIN_BATCH} {H}x{W} bf16 augmented step "
          f"over a {LITE_TIMED_FRAMES}-frame split on the card, ms a step "
          f"(two turns of {LITE_TIMED_STEPS}): eager "
          f"{json.dumps([round(t, 3) for t in times['eager']])}, graphed "
          f"{json.dumps([round(t, 3) for t in times['graphed']])}  [{card}]")
    return {k: min(v) for k, v in times.items()}


def distill_phase(sd, device, card, tmp):
    """Phase 19b: ``cli.distill`` from the seeded FCDenseNet67 (saved to
    ``.pt``) into a full-width LaneNetLite, ``--augment -b 32``, one epoch
    with K4's counts set to 0 just before and read just after (55/5/1 a
    step, every dense layer on the tensor cores, no plain version); then,
    on a trainer built as the CLI builds it, the teacher's logits through
    K4 against the plain module on one augmented batch (f32, gated; bf16,
    printed with its argmax agreement), K4's launches in one step by
    torch.profiler, one ``train_step_unl`` (the teacher at B=64), and the
    steps' times beside the teacher's.  Returns the student's
    ``best_weights.pt``."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import distill as distill_cli
    from sim2real_lane_segment_tpu_torch.cli.test import build_model
    from sim2real_lane_segment_tpu_torch.core.dtypes import (DEFAULT_POLICY,
                                                             F32_POLICY)
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
    from sim2real_lane_segment_tpu_torch.train.distill import DistillTrainer

    teacher_pt = os.path.join(tmp, "fcdensenet67_seeded.pt")
    torch.save(sd, teacher_pt)
    root = os.path.join(tmp, "distillData")
    write_png_tree(root, LITE_SIM_SPLITS, SEED + 53)
    plain = {}
    names = ("dense_layer_plain", "transition_plain", "classifier_plain")
    with mock.patch.multiple(kdb, **_plain_counting(kdb, names, plain)):
        kdb.reset_launches()
        t0 = time.perf_counter()
        res = distill_cli.main(
            ["--dataPath", root, "--teacherPath", teacher_pt,
             "--teacher_arch", ARCH, "--augment", "-b", str(TRAIN_BATCH),
             "--max_epochs", "1", "--height", str(H), "--width", str(W),
             "--default_root_dir", tmp, "--seed", str(SEED)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, mma = dict(kdb.launches), kdb.mma_launches["dense_layer"]
    expect = {"dense_layer": 55 * LITE_STEPS, "transition": 5 * LITE_STEPS,
              "classifier": LITE_STEPS}
    weights = os.path.join(res["out_dir"], "best_weights.pt")
    print(f"distill: cli.distill --teacher_arch {ARCH} --augment, 1 epoch of "
          f"{LITE_STEPS} steps of B={TRAIN_BATCH} in {wall:.1f} s (with "
          f"validation, test and checkpoints), best val_iou "
          f"{res['best_iou']:.4f}; K4 launches {json.dumps(launches)}, "
          f"expected {json.dumps(expect)}; dense layers on the tensor "
          f"cores {mma}; plain versions called {json.dumps(plain)}  [{card}]")
    check(launches == expect, "distill: K4 launches differ from 55/5/1 a "
          "step")
    check(mma == DENSE_LAYERS * LITE_STEPS,
          "distill: a teacher dense layer left the tensor-core route")
    check(not plain, "distill: a plain version of K4 ran")
    check(os.path.exists(weights) and np.isfinite(res["best_iou"]),
          f"distill: {res}")

    rng = np.random.default_rng(SEED + 54)
    images = synthetic_frames(rng, TRAIN_BATCH)
    labels = rng.integers(0, N_CLS, (TRAIN_BATCH, H, W), dtype=np.uint8)
    unl = synthetic_frames(rng, TRAIN_BATCH)
    for policy, name in ((F32_POLICY, "float32"),
                         (DEFAULT_POLICY, "bfloat16")):
        torch.manual_seed(SEED)
        tr = DistillTrainer(teacher=make_model(sd, policy, device),
                            student_model=build_model("lite", N_CLS),
                            height=H, width=W, augment=True, device=device)
        draws = tr._draw(torch.Generator().manual_seed(SEED), TRAIN_BATCH,
                         None)
        x, _ = tr._prepare(images, labels, draws)
        kdb.reset_launches()
        got = tr.teacher_logits(x)
        with torch.no_grad():
            ref = tr.teacher(x, use_softmax=False)
        torch.cuda.synchronize()
        check(kdb.launches["dense_layer"] == 55, f"{name} teacher: K4 "
              f"launches {kdb.launches}")
        err = (got - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
        print(f"distill: {name} teacher logits [{x.shape[0]}, {N_CLS}, {H}, "
              f"{W}] through K4 against the plain module: max|err| "
              f"{err:.3e}, max relative err {rel:.3e}, argmax agreement "
              f"{agree:.6f}  [{card}]")
        check(agree >= MIN_ARGMAX_AGREEMENT, f"{name} teacher argmax "
              f"agreement {agree}")
        if name == "float32":
            check(err <= LOGIT_ATOL[name], f"float32 teacher logits through "
                  f"K4 differ from plain by {err}")
    # the bf16 trainer (as the CLI builds it): launches, times, the B=64 step
    lr = tr.lr_at(0)
    gen = torch.Generator().manual_seed(SEED + 1)
    step = {"lab": lambda: tr.train_step(images, labels, lr, generator=gen),
            "unl": lambda: tr.train_step_unl(images, labels, unl, lr,
                                             generator=gen)}
    names = port_kernel_names()
    k4_names = {"dense3x3_mma_kernel", "td_fwd_small_kernel",
                "td_fwd_mma_kernel", "classifier_kernel",
                "conv_bnrelu_kernel"} & names
    x64 = torch.cat([x, x])
    ms = {"lab": _time_ms(step["lab"]), "unl": _time_ms(step["unl"]),
          "teacher32": _time_ms(lambda: tr.teacher_logits(x)),
          "teacher64": _time_ms(lambda: tr.teacher_logits(x64))}
    rows = _device_rows(step["lab"])
    k4_rows = [(port_kernel(k, names), n, ms) for k, n, ms in rows
               if port_kernel(k, names) in k4_names]
    k4_launches = sum(n for _, n, _ in k4_rows)
    k4_dev = sum(ms for _, _, ms in k4_rows)
    busy = sum(ms for _, _, ms in rows)
    kdb.reset_launches()
    out = step["unl"]()
    torch.cuda.synchronize()
    check(dict(kdb.launches) == {"dense_layer": 55, "transition": 5,
                                 "classifier": 1},
          f"distill train_step_unl: K4 launches {kdb.launches}")
    check(all(torch.isfinite(v) for v in out.values()),
          f"distill train_step_unl: {out}")
    print(f"distill: one B={TRAIN_BATCH} step by torch.profiler: "
          f"{k4_launches} K4 kernel launches "
          f"({json.dumps({k: n for k, n, _ in k4_rows})}), K4 device "
          f"{k4_dev:.3f} ms of {busy:.3f} ms busy (device idle "
          f"{1 - busy / ms['lab']:.3f} of the step); train_step_unl: the "
          f"teacher at B={2 * TRAIN_BATCH}, K4 wrapper launches "
          f"55/5/1, losses "
          f"{ {k: round(float(v), 4) for k, v in out.items()} }  [{card}]")
    print(f"distill timing (ms, CUDA events, mean of {REPS}): train_step "
          f"B={TRAIN_BATCH} {ms['lab']:.3f}, train_step_unl "
          f"B={TRAIN_BATCH}+{TRAIN_BATCH} {ms['unl']:.3f}; the teacher "
          f"through K4 alone B={TRAIN_BATCH} {ms['teacher32']:.3f}, "
          f"B={2 * TRAIN_BATCH} {ms['teacher64']:.3f} (share of the step "
          f"{ms['teacher32'] / ms['lab']:.2f}, "
          f"{ms['teacher64'] / ms['unl']:.2f})  [{card}]")
    return weights


def student_serve_phase(device, card, tmp, weights):
    """Phase 19c: the distilled student through ``cli.serve --arch lite
    --int8 --fused --calib_dir`` on FULL_SPLITS' 480x640 PNGs (resized
    with LANCZOS4): the calibration frames and scales on the card against
    the plain CPU route, K6 against its plain version on the student's
    sites (phase 10's gates), then 32 requests behind the engine with K6's
    counts set to 0 just before and read just after (1/12/1 a batch, no
    plain version), and the masks against plain int8 on the card.
    Returns K6's launches per batch."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import serve
    from sim2real_lane_segment_tpu_torch.kernels import int8_body as kib
    from sim2real_lane_segment_tpu_torch.models import lanenet_int8
    from sim2real_lane_segment_tpu_torch.models.lanenet_fused import \
        fused_int8_serve

    root = os.path.join(tmp, "fullSize")
    write_png_tree(root, FULL_SPLITS, SEED + 55, unlabelled=("real",),
                   scale=FRAME_SIZE[0] // H)
    calib = os.path.join(root, "train", "input")
    flags = ["--checkpointPath", weights, "--arch", "lite", "--height",
             str(H), "--width", str(W), "--int8", "--calib_dir", calib]
    frames_card = serve.calibration_frames(serve.parse_args(flags), device)
    frames_cpu = serve.calibration_frames(serve.parse_args(flags), "cpu")
    diff = int((frames_card.cpu() != frames_cpu).sum())
    print(f"serve student: {frames_cpu.shape[0]} calibration PNGs "
          f"{FRAME_SIZE[0]}x{FRAME_SIZE[1]} -> {H}x{W} (LANCZOS4): {diff} "
          f"values differ between the card and the CPU  [{card}]")
    check(diff == 0, "calibration frames differ between the card and the "
          "CPU")
    qns = {}
    real_q = lanenet_int8.quantize_lanenet

    def spy(tag):
        def f(*a, **kw):
            qns[tag] = real_q(*a, **kw)
            return qns[tag]
        return f

    with mock.patch.object(lanenet_int8, "quantize_lanenet", spy("card")):
        predict_fn, _, _ = serve.build_predict_fn(
            serve.parse_args(flags + ["--fused"]))
    with mock.patch.object(lanenet_int8, "quantize_lanenet", spy("cpu")):
        serve.build_predict_fn(serve.parse_args(flags), device="cpu")
    with mock.patch.object(lanenet_int8, "quantize_lanenet", spy("plain")):
        plain_fn, _, _ = serve.build_predict_fn(serve.parse_args(flags))
    rels = {}
    for name, site in qns["cpu"].sites.items():
        a = qns["card"].sites[name]["act_scale"].item()
        b = site["act_scale"].item()
        rels[name] = abs(a - b) / b
    worst = max(rels.values())
    print(f"serve student: int8 activation scales on the card against the "
          f"CPU route, {len(rels)} sites, max relative difference "
          f"{worst:.3e} (limit {CALIB_RTOL:.0e})  [{card}]")
    check(worst <= CALIB_RTOL, f"calibration scales differ: {rels}")
    compare_int8_body(qns["card"], device, card)

    requests = client_requests(np.random.default_rng(SEED + 56))
    plain_calls = {}
    with mock.patch.multiple(kib, **_plain_counting(
            kib, ("int8_body_plain",), plain_calls)):
        kib.reset_launches()
        replies, stats, wall = drive_engine(predict_fn, requests)
        launches = dict(kib.launches)
    b = stats["batches"]
    expect = {"quant": b, "conv": K6_CONVS * b, "head": b}
    n_frames = sum(f.shape[0] for reqs in requests for f in reqs)
    print(f"serve student: --int8 --fused, {n_frames} frames in 32 requests, "
          f"{b} batches, {n_frames / wall:.1f} frames/s; K6 launches "
          f"{json.dumps(launches)}, expected {json.dumps(expect)}; plain "
          f"version called {json.dumps(plain_calls)}  [{card}]")
    check(launches == expect, "serve student: K6 launches differ from "
          "1/12/1 a batch")
    check(not plain_calls, "serve student: K6's plain version ran")
    same = total = 0
    for reqs, outs in zip(requests, replies):
        for frames, out in zip(reqs, outs):
            ref = plain_fn(frames)
            same += int((ref == out).sum())
            total += out.size
    agree = same / total
    print(f"serve student: K6 masks against plain int8 on the card "
          f"{agree:.6f} of {total} pixels agree  [{card}]")
    check(agree >= MIN_INT8_AGREEMENT, f"serve student: agreement {agree}")
    x = torch.from_numpy(synthetic_frames(np.random.default_rng(SEED + 57),
                                          TIME_BATCH)).to(device)
    ms = _time_ms(lambda: fused_int8_serve(qns["card"], x))
    print(f"serve student timing: frames -> masks through K6 at "
          f"B={TIME_BATCH}, {ms:.3f} ms ({TIME_BATCH / ms * 1e3:.1f} "
          f"frames/s)  [{card}]")
    return (launches["quant"] + launches["conv"] + launches["head"]) // b


def montage_phase(card, tmp, weights):
    """Phase 19d: ``cli.test --trainDataPath --realDataPath -c 3`` on
    FULL_SPLITS' 480x640 PNGs with the distilled student: the montage's
    shape, its first frame against the LANCZOS4 resize of the path JAX's
    rule draws, and every overlaid pixel one of the class colours."""
    import glob
    import random

    import torch

    from sim2real_lane_segment_tpu_torch.cli import test as test_cli
    from sim2real_lane_segment_tpu_torch.data.png import read_png
    from sim2real_lane_segment_tpu_torch.ops.resize import resize_lanczos4_u8

    root = os.path.join(tmp, "fullSize")
    train_dir = os.path.join(root, "train", "input")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        res = test_cli.main(["-t", "baseline", "--checkpointPath", weights,
                             "--arch", "lite", "--height", str(H),
                             "--width", str(W), "--trainDataPath",
                             train_dir, "--realDataPath",
                             os.path.join(root, "real", "input"), "-c",
                             str(MONTAGE_ROWS)])
        montage = read_png(res["montage"])
    finally:
        os.chdir(cwd)
    random.seed(42)
    first = random.sample(glob.glob(os.path.join(train_dir, "*.png")),
                          MONTAGE_ROWS)[0]
    want = resize_lanczos4_u8(torch.from_numpy(read_png(first)), H,
                              W).numpy()
    colours = np.array(list(test_cli.OVERLAY_BGR.values()))
    painted = bad = 0
    for r in range(MONTAGE_ROWS):
        row = montage[r * H:(r + 1) * H]
        for c in (0, 2):
            img, over = row[:, c * W:(c + 1) * W], row[:, (c + 1) * W:
                                                          (c + 2) * W]
            moved = (img != over).any(-1)
            hit = (over[moved][:, None] == colours[None]).all(-1).any(-1)
            painted += int(moved.sum())
            bad += int((~hit).sum())
    print(f"montage: cli.test -c {MONTAGE_ROWS} from {FRAME_SIZE[0]}x"
          f"{FRAME_SIZE[1]} PNGs: {montage.shape}, {painted} pixels painted, "
          f"{bad} in another colour than a class's  [{card}]")
    check(montage.shape == (MONTAGE_ROWS * H, 4 * W, 3),
          f"montage shape {montage.shape}")
    check(np.array_equal(montage[:H, :W], want),
          "the montage's first frame is not the LANCZOS4 resize of the "
          "path drawn")
    check(bad == 0, f"{bad} overlaid pixels in another colour")


def study_defaults_phase(card, tmp):
    """Phase 19e: ``cli.domain_study`` with its defaults (``--arch lite``)
    and ``--distill --device_cache``, ``baseline`` and ``mme``, one epoch
    each, over STUDY_SPLITS trees at 480x640: four finite rows, the
    students distilled from LaneNetLite teachers (plain eval forward)."""
    from sim2real_lane_segment_tpu_torch.cli import domain_study

    work = os.path.join(tmp, "studyDefaults")
    for dom, seed in (("sourceData", SEED + 58), ("targetData", SEED + 59)):
        write_png_tree(os.path.join(work, dom), STUDY_SPLITS, seed,
                       scale=FRAME_SIZE[0] // H)
    t0 = time.perf_counter()
    res = domain_study.main(["--workdir", work, "--epochs", "1", "-b",
                             str(TRAIN_BATCH), "--regimes", "baseline",
                             "mme", "--distill", "--device_cache"])
    wall = time.perf_counter() - t0
    rows = ["baseline", "mme", "student_baseline", "student_mme"]
    print(f"study defaults: cli.domain_study (--arch lite) --distill "
          f"--device_cache --epochs 1, rows {list(res)} in {wall:.1f} s; "
          f"target-test iou { {k: round(v['iou'], 4) for k, v in res.items()} }"
          f"  [{card}]")
    check(list(res) == rows, f"study rows {list(res)}")
    check(all(np.isfinite(v) for row in res.values() for v in row.values()),
          f"study rows {res}")


def lifecycle_phase(sd, device, card):
    """Phase 19: the serving student's life, each part timed."""
    seconds, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (
                ("train", lambda: lite_train_phase(card, tmp)),
                ("train timing", lambda: lite_step_timing(device, card)),
                ("distill", lambda: distill_phase(sd, device, card, tmp)),
                ("serve", lambda: student_serve_phase(device, card, tmp,
                                                      out["distill"])),
                ("montage", lambda: montage_phase(card, tmp,
                                                  out["distill"])),
                ("study", lambda: study_defaults_phase(card, tmp))):
            t0 = time.perf_counter()
            out[name] = fn()
            seconds[name] = round(time.perf_counter() - t0, 1)
    print(f"lifecycle: seconds per part {json.dumps(seconds)}; K6 launches "
          f"per served batch of the student {out['serve']}  [{card}]",
          flush=True)


# ---------------------------------------------------------------------------
# phase 20: the trainer's surface (--fast_train, 67r, --dp, cli.tune,
# cli.test --arch 67r --fused and --arch encdec)
# ---------------------------------------------------------------------------

def _rows(run_dir) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _train_values(rows, key="train/") -> list:
    return [v for r in rows for k, v in r.items() if k.startswith(key)]


def _max_rel(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))


def _surface_args(root, tmp, name, arch, *extra):
    """One augmented epoch of ``--trainType sim`` on ``root``."""
    return ["--trainType", "sim", "--dataPath", root, "--arch", arch,
            "--augment", "--height", str(H), "--width", str(W),
            "--max_epochs", "1", "-b", str(TRAIN_BATCH), "--default_root_dir",
            tmp, "--log_every", "1", "--seed", str(SEED), "--model_name",
            name, *extra]


def _run_quiet(label, argv, card):
    """``cli.train.main(argv)``, its K1-K3b counts set to 0 just before
    and read after: every one must stay 0 (the plain or segment-wise
    step).  Returns the run's directory."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import train as train_cli
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb

    ktb.reset_launches()
    t0 = time.perf_counter()
    res = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not any(ktb.launches.values()),
          f"{label}: the train kernels ran: {ktb.launches}")
    values = _train_values(_rows(res["out_dir"]))
    check(len(values) == 2 * (SURFACE_SPLITS[0][1] // TRAIN_BATCH)
          and bool(np.isfinite(values).all()), f"{label}: logged {values}")
    print(f"surface: {label}: 1 epoch, {len(values) // 2} steps of "
          f"B={TRAIN_BATCH} in {wall:.1f} s (with validation, test and "
          f"checkpoints); tr_loss, tr_acc {[round(v, 4) for v in values]}  "
          f"[{card}]")
    return res["out_dir"]


def surface_cli_phase(card, tmp):
    """Phase 20 (a)-(d): ``cli.train`` at full width (FCDenseNet67's
    widths, 120x160, B=32, bf16, augmented), one epoch of
    SURFACE_SPLITS: (a) ``--arch 67r --pallas_train`` against ``--arch 67
    --pallas_train`` (K1-K3b as in phase 8; rows and weights equal: the
    kernels run their own backward, remat does not apply); (b) ``--arch
    67r`` against ``--arch 67`` without kernels (rows within
    REMAT_RTOL); (c) ``--fast_train`` against (b)'s plain run (rows within
    FAST_RTOL); (d) ``--dp auto`` (a one-rank NCCL world) with and without
    ``--device_cache`` against ``--dp off``, ``--pallas_train``: rows and
    final state bit-equal, the cached run one replay a step.  Returns the
    67r run's ``best_weights.pt`` and the tree's test split."""
    import torch
    import torch.distributed as dist

    from sim2real_lane_segment_tpu_torch.cli import train as train_cli
    from sim2real_lane_segment_tpu_torch.train import graphs

    root = os.path.join(tmp, "surfaceSim")
    write_png_tree(root, SURFACE_SPLITS, SEED + 60)
    n_train = SURFACE_SPLITS[0][1]

    # (a) 67r and 67 through the kernels
    runs = {}
    for arch in ("67", "67r"):
        res, launches, _ = train_cli_checked(
            f"surface (a): --arch {arch}", _surface_args(
                root, tmp, f"a{arch}", arch, "--pallas_train"), 1, n_train,
            card)
        runs[arch] = res["out_dir"]
    (m0, o0, _), (m1, o1, _) = (_train_state(runs[a]) for a in ("67", "67r"))
    same = (_rows(runs["67"]) == _rows(runs["67r"])
            and all(torch.equal(m1[k], v) for k, v in m0.items())
            and all(torch.equal(o1[k], v) for k, v in o0.items()))
    print(f"surface (a): --arch 67r --pallas_train against --arch 67: rows "
          f"and final state equal {same}  [{card}]")
    check(same, "67r --pallas_train differs from 67 --pallas_train")

    # (b) 67r and 67 without kernels, (c) --fast_train
    plain = _run_quiet("(b) --arch 67, plain autograd",
                       _surface_args(root, tmp, "b67", "67"), card)
    remat = _run_quiet("(b) --arch 67r, plain autograd",
                       _surface_args(root, tmp, "b67r", "67r"), card)
    fast = _run_quiet("(c) --arch 67 --fast_train",
                      _surface_args(root, tmp, "c67", "67", "--fast_train"),
                      card)
    ref = _train_values(_rows(plain), "train/tr_loss")
    for label, run, bound in (("67r", remat, REMAT_RTOL),
                              ("--fast_train", fast, FAST_RTOL)):
        err = _max_rel(_train_values(_rows(run), "train/tr_loss"), ref)
        print(f"surface (b, c): {label} against the plain 67 run: train "
              f"losses within {err:.3e} (relative; limit {bound})  [{card}]")
        check(err <= bound, f"{label}: train losses {err} apart")

    # (d) --dp auto: a world of one on the card
    dp_runs = {}
    for name, extra in (("off", []), ("auto", ["--dp", "auto"]),
                        ("auto_cache", ["--dp", "auto", "--device_cache"])):
        graphs.reset_counts()
        t0 = time.perf_counter()
        res = train_cli.main(_surface_args(root, tmp, f"d{name}", "67",
                                           "--pallas_train", *extra))
        torch.cuda.synchronize()
        dp_runs[name] = (res["out_dir"], time.perf_counter() - t0,
                         dict(graphs.counts))
        check(not dist.is_initialized(), f"--dp {name}: the world outlived "
              f"the CLI")
    m0, o0, c0 = _train_state(dp_runs["off"][0])
    rows0 = _rows(dp_runs["off"][0])
    for name in ("auto", "auto_cache"):
        m1, o1, c1 = _train_state(dp_runs[name][0])
        same = (_rows(dp_runs[name][0]) == rows0 and c0 == c1
                and all(torch.equal(m1[k], v) for k, v in m0.items())
                and all(torch.equal(o1[k], v) for k, v in o0.items()))
        print(f"surface (d): --dp {name.replace('_', ' --device_')} (one "
              f"NCCL rank) against --dp off: {dp_runs[name][1]:.1f} s "
              f"against {dp_runs['off'][1]:.1f} s; graphs "
              f"{json.dumps(dp_runs[name][2])}; rows and final state "
              f"bit-equal {same}  [{card}]")
        check(same, f"--dp {name} differs from --dp off")
    steps = n_train // TRAIN_BATCH
    check(dp_runs["auto_cache"][2] == {"captures": 1, "replays": steps},
          f"--dp auto --device_cache took {dp_runs['auto_cache'][2]}")
    return (os.path.join(runs["67r"], "best_weights.pt"),
            os.path.join(root, "test"))


def surface_tune_phase(card, tmp):
    """Phase 20 (e): ``cli.tune`` end to end at full width on a two-domain
    tree (2 steps of B=32 an epoch), ``--device_cache``: TUNE_TRIALS
    trials, rungs at 1 and 2 epochs (reduction factor 2), one graph
    capture for the whole sweep; ``trials.json`` and ``best.json`` valid;
    seconds per trial-epoch."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import tune
    from sim2real_lane_segment_tpu_torch.train import graphs

    root = os.path.join(tmp, "surfaceSimReal")
    write_png_tree(root, SURFACE_MME_SPLITS, SEED + 61,
                   unlabelled=("target/unlabelled",))
    out = os.path.join(tmp, "tune")
    graphs.reset_counts()
    t0 = time.perf_counter()
    res = tune.main(["--dataPath", root, "--num_samples", str(TUNE_TRIALS),
                     "--num_epochs", "2", "--grace_period", "1",
                     "--reduction_factor", "2", "--arch", ARCH, "-b",
                     str(TRAIN_BATCH), "--height", str(H), "--width", str(W),
                     "--device_cache", "--out_dir", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "trials.json")) as f:
        trials = json.load(f)
    with open(os.path.join(out, "best.json")) as f:
        best = json.load(f)
    epochs = sum(t["epochs"] for t in trials)
    steps = epochs * (SURFACE_MME_SPLITS[0][1] + SURFACE_MME_SPLITS[1][1]) \
        // TRAIN_BATCH
    print(f"surface (e): cli.tune --arch {ARCH} --device_cache, "
          f"{TUNE_TRIALS} trials, rungs 1, 2: {epochs} trial-epochs in "
          f"{wall:.1f} s, {wall / epochs:.2f} s a trial-epoch (the first "
          f"with the capture); graphs {json.dumps(graphs.counts)}; trials "
          f"{json.dumps([(t['id'], t['epochs'], round(t['best_iou'], 3), t['pruned']) for t in trials])}; "
          f"best {json.dumps(best)}  [{card}]")
    check(sorted(t["epochs"] for t in trials) == [1, 2, 2]
          and sum(t["pruned"] for t in trials) == 1
          and all(np.isfinite(t["best_iou"]) for t in trials),
          f"trials.json: {trials}")
    check(best["best_iou"] == res["best_iou"] == max(
        t["best_iou"] for t in trials), f"best.json: {best}")
    check(graphs.counts == {"captures": 1, "replays": steps},
          f"the sweep took {graphs.counts}, not one capture and a replay "
          f"a step")


def surface_test_phase(card, tmp, weights_67r, test_dir):
    """Phase 20 (f): ``cli.test --arch 67r --fused`` through K4 (phase
    15's launch checks) and ``cli.test --arch encdec`` (no kernel) on the
    surface tree's test split."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import test as test_cli

    n_test = SURFACE_SPLITS[2][1]
    eval_fused_checked("surface (f)", "baseline", weights_67r, test_dir,
                       n_test, card, arch="67r")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        weights = os.path.join(tmp, "encdec.pt")
        torch.save(test_cli.build_model("encdec", N_CLS).state_dict(),
                   weights)
    res = test_cli.main(["-t", "baseline", "--checkpointPath", weights,
                         "--testDataPath", test_dir, "--arch", "encdec",
                         "--height", str(H), "--width", str(W),
                         "--batch_size", str(TRAIN_BATCH)])
    check(int(res["confusion"].sum()) == n_test * H * W
          and all(np.isfinite(res[k]) for k in ("acc", "dice", "iou",
                                                 "loss")),
          f"cli.test --arch encdec: {res}")
    print(f"surface (f): cli.test --arch encdec (seeded weights) on "
          f"{n_test} frames: acc {res['acc']:.4f}, iou {res['iou']:.4f}  "
          f"[{card}]")


def surface_timing(sd, device, card):
    """Phase 20 timing: the augmented B=32 step of FCDenseNet67 (bf16,
    120x160) over a split on the card, CUDA events over SURFACE_TIMED
    steps in two turns, and the peak of allocated memory in one step:
    plain autograd (``67``), checkpointed blocks (``67r``),
    ``--fast_train`` and ``--pallas_train``; then ``--pallas_train`` in a
    one-rank NCCL world against no world, eager and as graph replays."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli.test import build_model
    from sim2real_lane_segment_tpu_torch.data.device_cache import \
        DeviceCachedView
    from sim2real_lane_segment_tpu_torch.parallel import multihost
    from sim2real_lane_segment_tpu_torch.train.supervised import \
        SupervisedTrainer

    rng = np.random.default_rng(SEED + 62)
    n = SURFACE_TIMED_FRAMES
    view = DeviceCachedView.from_arrays(
        synthetic_frames(rng, n),
        rng.integers(0, N_CLS, (n, H, W), dtype=np.uint8), device)
    arrays = (view.images, view.labels)

    def trainer(arch, world=None, **kw):
        model = build_model(arch, N_CLS)
        model.load_state_dict(sd)
        return SupervisedTrainer(model=model, augment=True, height=H,
                                 width=W, world=world, device=device, **kw)

    def timed(tr, graphed):
        gen = torch.Generator().manual_seed(SEED)

        def run(idx):
            if graphed:
                tr.run_scan_chunk(arrays, idx, gen, 0)
                return
            for row in torch.from_numpy(idx).to(device):
                tr.train_step(arrays[0][row], arrays[1][row], tr.lr_at(0),
                              generator=gen)

        out = []
        for _ in range(2):
            run(rng.integers(0, n, (3, TRAIN_BATCH)))  # warm-up, capture
            idx = rng.integers(0, n, (SURFACE_TIMED, TRAIN_BATCH))
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            run(idx)
            t1.record()
            torch.cuda.synchronize()
            out.append(round(t0.elapsed_time(t1) / SURFACE_TIMED, 3))
        return out

    def peak_mb(tr):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        row = torch.arange(TRAIN_BATCH, device=device)
        tr.train_step(arrays[0][row], arrays[1][row], tr.lr_at(0),
                      generator=torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        return round((torch.cuda.max_memory_allocated() - base) / 2 ** 20, 1)

    times, peaks = {}, {}
    for name, arch, kw in (("67", "67", {}), ("67r", "67r", {}),
                           ("fast_train", "67", {"fast_train": True}),
                           ("pallas_train", "67", {"pallas_train": True})):
        tr = trainer(arch, **kw)
        peaks[name] = peak_mb(tr)
        times[name] = timed(tr, graphed=False)
        del tr
        torch.cuda.empty_cache()
    print(f"surface timing: B={TRAIN_BATCH} {H}x{W} bf16 augmented eager "
          f"step, ms (two turns of {SURFACE_TIMED}) {json.dumps(times)}; "
          f"peak allocated MB in one step {json.dumps(peaks)}  [{card}]")
    check(peaks["67r"] < peaks["67"], f"67r's peak {peaks['67r']} MB is "
          f"not below 67's {peaks['67']} MB")

    world, owned = multihost.init_world(device)
    try:
        dp = {}
        for name, w, graphed in (("off", None, False), ("dp", world, False),
                                 ("off_graphed", None, True),
                                 ("dp_graphed", world, True)):
            dp[name] = timed(trainer("67", world=w, pallas_train=True),
                             graphed)
    finally:
        if owned:
            multihost.close_world()
    print(f"surface timing: --pallas_train B={TRAIN_BATCH} step, ms (two "
          f"turns of {SURFACE_TIMED}), --dp off against a one-rank NCCL "
          f"world: {json.dumps(dp)}  [{card}]")


def surface_phase(sd, device, card):
    """Phase 20: the trainer's surface, each part's seconds printed."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        weights_67r, test_dir = surface_cli_phase(card, tmp)
        t1 = time.perf_counter()
        surface_tune_phase(card, tmp)
        t2 = time.perf_counter()
        surface_test_phase(card, tmp, weights_67r, test_dir)
        t3 = time.perf_counter()
    surface_timing(sd, device, card)
    t4 = time.perf_counter()
    print(f"surface: phase 20 seconds: (a-d) {t1 - t0:.1f}, (e) "
          f"{t2 - t1:.1f}, (f) {t3 - t2:.1f}, timing {t4 - t3:.1f}  "
          f"[{card}]", flush=True)


def _dg_poses(m, la, n, seed):
    """``n`` spawns of map ``m`` moved 5 expert steps on, on the CPU."""
    from sim2real_lane_segment_tpu_torch.sim import rollout

    pos, ang = rollout.sample_spawns(m, la, np.random.default_rng(seed), n)
    pos, ang = rollout.step_poses(la, m.tile_size, pos, ang, 5)
    return pos[-1], ang[-1]


def _agreement(a, b) -> tuple[float, float]:
    """Shares of uint8 values of ``a`` and ``b`` equal / within one."""
    d = (a.cpu().short() - b.cpu().short()).abs()
    return (float((d == 0).float().mean()), float((d <= 1).float().mean()))


def render_check(device, card, tmp):
    """Phase 21a: ``sim.render.render_pair`` at 480x640 on the card against
    the CPU from the same poses, DR rows and noise draws (loop_dyn_duckiebots
    and zigzag procedural, zigzag through a generated photo pack; all with
    the fisheye), at the CPU tests' agreement bounds; then, for the
    procedural scenes, pair alignment without DR or noise: orig and annot
    differ only where annot holds a shaded pure green, blue or red (lanes
    and obstacles)."""
    import torch

    from sim2real_lane_segment_tpu_torch.sim import lanes, render
    from sim2real_lane_segment_tpu_torch.sim.maps import builtin_map
    from sim2real_lane_segment_tpu_torch.sim.textures import \
        generate_photo_pack

    h, w = DG_SIZE
    pack = generate_photo_pack(os.path.join(tmp, "pack"), seed=9)
    cases = (("loop_dyn_duckiebots", None), ("zigzag", None),
             ("zigzag", pack))
    for k, (name, tex) in enumerate(cases):
        m = builtin_map(name)
        pos, ang = _dg_poses(m, lanes.build_lane_arrays(m), DG_CHECK_POSES,
                             SEED + 70 + k)
        g = torch.Generator().manual_seed(SEED + 80 + k)
        dr = render.DRParams.sample(g, DG_CHECK_POSES)
        noise = torch.randn((DG_CHECK_POSES, h, w, 3), generator=g)
        kw = dict(height=h, width=w, distortion=True,
                  procedural=tex is None)
        cpu = render.render_pair(render.build_scene(m, 9, texture_pack=tex),
                                 pos, ang, dr, noise, **kw)
        scene = render.build_scene(m, 9, texture_pack=tex, device=device)
        gpu = render.render_pair(scene, pos.to(device), ang.to(device),
                                 render.DRParams(*(f.to(device) for f in dr)),
                                 noise.to(device), **kw)
        for label, a, b in zip(("orig", "annot"), gpu, cpu):
            eq, near = _agreement(a, b)
            print(f"  render {name}{' (photo pack)' if tex else ''} {label} "
                  f"x{DG_CHECK_POSES} {h}x{w}: card vs CPU {eq:.6f} of "
                  f"values equal, {near:.6f} within one level  [{card}]")
            check(eq >= DG_RENDER_EQUAL and near >= DG_RENDER_NEAR,
                  f"render {name} {label}: card vs CPU {eq}, {near}")
        if tex is not None:
            continue   # bilinear texels mix colours along painted edges
        o, a = render.render_pair(scene, pos.to(device), ang.to(device),
                                  render.DRParams.default(DG_CHECK_POSES,
                                                          device), None, **kw)
        diff = (o != a).any(-1)
        marked = (a == 0).sum(-1) >= 2
        stray = int((diff & ~marked).sum())
        print(f"  pairs {name}: {int(diff.sum())} pixels differ between orig "
              f"and annot, {stray} of them off the lanes and obstacles")
        check(bool(diff.any()) and stray == 0,
              f"render {name}: orig and annot misaligned ({stray} pixels)")


def render_timing(device, card) -> dict:
    """Phase 21d (renderer): rendered pairs/s of ``expert_rollout`` at
    480x640, B=2 agents x 32 steps a call (datagen's batch), and the split
    of its device time by subtraction: the scene with neither cylinders nor
    meshes (ground and sky), with cylinders only, and whole (CUDA events,
    medians of DG_TIMED calls)."""
    import torch

    from sim2real_lane_segment_tpu_torch.sim import lanes, render, rollout
    from sim2real_lane_segment_tpu_torch.sim.maps import builtin_map
    from sim2real_lane_segment_tpu_torch.sim.objmesh import MeshSet

    m = builtin_map("loop_dyn_duckiebots")
    la = lanes.build_lane_arrays(m, device)
    full = render.build_scene(m, 0, device=device)
    inert = full.objects[:1].clone()
    inert[0] = torch.tensor([1e9, 1e9] + [0.0] * 10)
    scenes = {"ground": full._replace(objects=inert,
                                      meshes=MeshSet.empty(device)),
              "cylinders": full._replace(meshes=MeshSet.empty(device)),
              "whole": full}
    pos, ang = rollout.sample_spawns(m, la, np.random.default_rng(SEED),
                                     2, device)
    h, w = DG_SIZE
    ms = {}
    for name, scene in scenes.items():
        g = torch.Generator(device=device).manual_seed(SEED)

        def call():
            rollout.expert_rollout(scene, la, g, pos, ang,
                                   tile_size=m.tile_size, n_steps=32,
                                   height=h, width=w, distortion=True)
        ms[name] = float(np.median([_time_ms(call, reps=1)
                                    for _ in range(DG_TIMED)]))
    pairs = 64
    split = {"ground": ms["ground"],
             "cylinders": ms["cylinders"] - ms["ground"],
             "meshes": ms["whole"] - ms["cylinders"]}
    print(f"timing: expert_rollout 2 agents x 32 steps at {h}x{w} "
          f"(loop_dyn_duckiebots, {full.meshes.num_triangles} triangles, "
          f"{full.objects.shape[0]} objects): {ms['whole']:.1f} ms a call, "
          f"{pairs / ms['whole'] * 1e3:.1f} pairs/s; by subtraction ground "
          f"{split['ground']:.1f} ms, cylinders {split['cylinders']:.1f} ms, "
          f"meshes {split['meshes']:.1f} ms  [{card}]")
    return {"pairs_per_s": pairs / ms["whole"] * 1e3, **split}


def datagen_chain(device, card, tmp) -> dict:
    """Phase 21b: ``cli.datagen`` (2 episodes x 64 steps x 2 agents, chunks
    of 32, fisheye: 256 pairs at 480x640), ``cli.postprocess`` with K5's
    count set to 0 just before and read just after (one launch a batch of
    at most 32 pairs of a recording, by the wrapper's count and by
    torch.profiler; every batch's masks against the plain version on the
    card), ``cli.preprocess_db --dbType sim``, then one epoch of
    ``cli.train --trainType sim --arch 67 --pallas_train -b 32`` on the
    rendered tree (phase 15's launch checks).  Returns the launch counts
    and times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sim2real_lane_segment_tpu_torch.cli import (datagen, postprocess,
                                                     preprocess_db)
    from sim2real_lane_segment_tpu_torch.data import videoio
    from sim2real_lane_segment_tpu_torch.kernels import labelgen as klg
    from sim2real_lane_segment_tpu_torch.ops import labelgen as olg

    rec, data = os.path.join(tmp, "recordings"), os.path.join(tmp, "simData")
    stats = datagen.run(DG_ARGS + ["--output_dir", rec])
    check(stats.n_frames == DG_PAIRS, f"datagen wrote {stats.n_frames}")
    avis = sorted(os.listdir(rec))
    codecs = {videoio.codec_of(os.path.join(rec, a)) for a in avis}
    check(len(avis) == 2 * DG_RECORDINGS
          and all(videoio.frame_count(os.path.join(rec, a)) == 64
                  for a in avis), f"recordings {avis}")
    check(codecs == {"FFV1"}, f"recordings coded as {codecs}")
    print(f"datagen: {stats.n_frames} pairs at {DG_SIZE[0]}x{DG_SIZE[1]} in "
          f"{stats.seconds:.1f} s ({stats.n_frames / stats.seconds:.1f} "
          f"pairs/s): rendering {stats.render_seconds:.1f} s, FFV1 encoding "
          f"{stats.encode_seconds:.1f} s of writer-thread time (4 threads); "
          f"{sum(os.path.getsize(os.path.join(rec, a)) for a in avis) / 1e6:.0f}"
          f" MB of video  [{card}]", flush=True)

    batches, diffs = [], []
    real = olg.process_classes_batch

    def held(orig, annot, *a):
        out = real(orig, annot, *a)
        batches.append(orig.shape[0])
        diffs.append(int((out != klg.process_classes_plain(
            orig, annot, *a)).sum()))
        return out

    klg.reset_launches()
    with mock.patch.object(olg, "process_classes_batch", held), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = postprocess.main(["-id", rec, "-od", data])
        torch.cuda.synchronize()
        post_s = time.perf_counter() - t0
    launches = klg.launches["labelgen"]
    rows = [(e.count, getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0)) / 1e3)
            for e in prof.key_averages() if "labelgen_kernel" in e.key
            and e.device_type != torch.autograd.DeviceType.CPU]
    prof_launches = sum(r[0] for r in rows)
    k5_ms = sum(r[1] for r in rows)
    expect = DG_RECORDINGS * -(-64 // DG_LABEL_BATCH)
    print(f"postprocess: {done} recordings, {sum(batches)} pairs in "
          f"{post_s:.1f} s under the profiler ({sum(batches) / post_s:.1f} "
          f"frames/s); K5 launches {launches} (profiler {prof_launches}, "
          f"expected {expect}), {k5_ms:.2f} ms of K5 device time "
          f"({k5_ms / max(prof_launches, 1):.3f} ms a batch); masks against "
          f"plain: {sum(diffs)} pixels differ  [{card}]", flush=True)
    check(done == DG_RECORDINGS and sum(batches) == DG_PAIRS,
          f"postprocess: {done} recordings, {sum(batches)} pairs")
    labelled = [os.path.join(data, kind, f"{i:06d}.avi")
                for kind in ("input", "label") for i in range(DG_RECORDINGS)]
    check(all(videoio.codec_of(p) == "FFV1" and videoio.frame_count(p) == 64
              for p in labelled), "postprocess wrote other than 64-frame "
          "FFV1 videos")
    check(launches == expect == prof_launches == len(batches),
          f"K5 launches {launches}, profiler {prof_launches}")
    check(max(batches) <= DG_LABEL_BATCH and sum(diffs) == 0,
          f"postprocess masks differ from plain: {diffs}")

    t0 = time.perf_counter()
    postprocess.main(["-id", rec, "-od", os.path.join(tmp, "again")])
    torch.cuda.synchronize()
    post_plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    preprocess_db.main(["--dbType", "sim", "--dataPath", data])
    prep_s = time.perf_counter() - t0
    sizes = tuple(len(os.listdir(os.path.join(data, s, "input")))
                  for s in ("train", "valid", "test"))
    print(f"postprocess (no profiler): {post_plain_s:.1f} s, "
          f"{DG_PAIRS / post_plain_s:.1f} frames/s; preprocess_db: "
          f"{prep_s:.1f} s for {DG_PAIRS} pairs, splits {sizes}  [{card}]",
          flush=True)
    check(sizes == DG_SPLITS, f"preprocess_db splits {sizes}")

    argv = ["--trainType", "sim", "--dataPath", data, "--arch", ARCH,
            "--pallas_train", "--max_epochs", "1", "-b", str(TRAIN_BATCH),
            "--default_root_dir", os.path.join(tmp, "train"), "--log_every",
            "1", "--seed", str(SEED)]
    _, train_launches, _ = train_cli_checked(
        "train (rendered tree)", argv, 1, DG_SPLITS[0], card)
    return {"k5_launches": launches, "train_launches": train_launches,
            "datagen": stats, "postprocess_s": post_plain_s,
            "k5_device_ms": k5_ms, "preprocess_s": prep_s}


def study_render_phase(card, tmp) -> None:
    """Phase 21c: ``cli.domain_study`` in empty workdirs renders both
    domains (1 episode of 24 steps each) and trains ``baseline`` one epoch;
    once procedural, once with ``--target_texture_pack auto``."""
    from sim2real_lane_segment_tpu_torch.cli import domain_study

    for label, extra in (("procedural", []),
                         ("photo pack", ["--target_texture_pack", "auto"])):
        work = os.path.join(tmp, f"study_{len(extra)}")
        t0 = time.perf_counter()
        res = domain_study.main(["--workdir", work, *DG_STUDY_ARGS, *extra])
        wall = time.perf_counter() - t0
        sizes = {d: tuple(len(os.listdir(os.path.join(work, d, s, "input")))
                          for s in ("train", "valid", "test"))
                 for d in ("sourceData", "targetData")}
        print(f"study render ({label}): both domains rendered {sizes}, "
              f"baseline iou {res['baseline']['iou']:.4f}, in {wall:.1f} s"
              f"  [{card}]", flush=True)
        check(all(v == (17, 3, 4) for v in sizes.values()),
              f"study trees {sizes}")
        check(list(res) == ["baseline"] and all(
            np.isfinite(v) for v in res["baseline"].values()),
            f"study rows {res}")
        if extra:
            check(os.path.isdir(os.path.join(work, "photo_pack")),
                  "no photo pack was generated")


def datagen_phase(device, card) -> dict:
    """Phase 21: data generation on the card, each part's seconds
    printed."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        render_check(device, card, tmp)
        print(f"datagen: 21a in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        out = datagen_chain(device, card, tmp)
        print(f"datagen: 21b in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        study_render_phase(card, tmp)
        print(f"datagen: 21c in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        out["render"] = render_timing(device, card)
        print(f"datagen: 21d in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 22: the interactive simulator, learning/ and the video CLIs
# ---------------------------------------------------------------------------

SIM_MAP = "loop_dyn_duckiebots"
SIM_SIZE = (480, 640)   # DuckietownEnv's default camera
SIM_BENCH_ARGS: list = []   # the CLIs' defaults (a CPU rehearsal cuts them)
IMITATION_ARGS: list = []
DDPG_ARGS: list = []
SIM_RESETS = 10
SIM_STEPS = 200
SIM_CHECK_STEPS = 16
SIM_TRUNCATE = 5
SIM_TRUNCATE_TRIES = 50   # spawns whose first step is an invalid pose
SIM_POSE_TOL, SIM_ANGLE_TOL = 1e-4, 3e-4   # the CPU tests' bounds
DEMO_AGENTS, DEMO_STEPS = 2, 64            # a 128-frame input video
DEMO_BATCH = 64
COMPARISON_SHOW = 4


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _expert(env):
    """The expert's (velocity, steering) at the env's pose (host)."""
    import torch

    from sim2real_lane_segment_tpu_torch.sim.expert import expert_action

    return expert_action(env.lane_arrays, env.map.tile_size,
                         torch.from_numpy(env.cur_pos),
                         torch.tensor(env.cur_angle,
                                      dtype=torch.float32)).numpy()


def env_check(device, card) -> dict:
    """Phase 22a: ``DuckietownEnv`` at 640x480 with domain randomization on
    the map whose duckiebots drive: resets, expert-driven steps, the NPCs'
    meshes on the device, truncation, and the card against the CPU."""
    import torch

    from sim2real_lane_segment_tpu_torch.sim.env import (DuckietownEnv,
                                                         EnvDraws)

    t0 = time.perf_counter()
    kw = dict(map_name=SIM_MAP, domain_rand=True, seed=SEED,
              camera_height=SIM_SIZE[0], camera_width=SIM_SIZE[1])
    env = DuckietownEnv(**kw, device=device)
    _sync(device)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(SIM_RESETS):
        obs = env.reset()
    reset_ms = (time.perf_counter() - t0) / SIM_RESETS * 1e3
    verts0 = env.scene.meshes.vertices.clone()
    step_s, rewards, msgs, ends = 0.0, [], {}, 0
    for _ in range(SIM_STEPS):
        act = _expert(env)
        t0 = time.perf_counter()
        obs, reward, done, info = env.step(act)
        step_s += time.perf_counter() - t0
        rewards.append(reward)
        msgs[info["msg"]] = msgs.get(info["msg"], 0) + 1
        if done:
            ends += 1
            env.reset()
    moved = int((env.scene.meshes.vertices != verts0).any(-1).any(-1)
                .sum())
    t0 = time.perf_counter()   # the render's share of a step
    for _ in range(SIM_RESETS):
        env.render_obs()
    render_ms = (time.perf_counter() - t0) / SIM_RESETS * 1e3
    print(f"env: {SIM_MAP} {SIM_SIZE[0]}x{SIM_SIZE[1]} DR: load {load_s * 1e3:.1f} ms, reset "
          f"{reset_ms:.2f} ms, step {step_s / SIM_STEPS * 1e3:.2f} ms "
          f"({SIM_STEPS / step_s:.1f} steps/s) over {SIM_STEPS} expert "
          f"steps, of which one frame rendered and copied to the host "
          f"{render_ms:.2f} ms; endings {json.dumps(msgs)}, {moved} NPC "
          f"triangles moved on {env.scene.meshes.vertices.device}  [{card}]",
          flush=True)
    check(obs.shape == (*SIM_SIZE, 3) and obs.dtype == np.uint8,
          f"observation {obs.shape} {obs.dtype}")
    check(np.isfinite(rewards).all() and np.isfinite(env.cur_pos).all()
          and bool(torch.isfinite(env.scene.meshes.vertices).all()),
          "a NaN in the rewards, the pose or the meshes")
    check(moved > 0 and env.scene.meshes.vertices.device.type
          == device.type, "no NPC mesh triangle moved on the device")

    # truncation: episodes of at most SIM_TRUNCATE steps, until one is
    # not cut short by an invalid pose
    env.max_steps = SIM_TRUNCATE
    endings = []
    for _ in range(SIM_TRUNCATE_TRIES):
        env.reset()
        for n in range(1, SIM_TRUNCATE + 1):
            _, _, done, info = env.step(_expert(env))
            if done:
                break
        endings.append((info["msg"], n))
        if info["msg"] == "max-steps-reached":
            break
    print(f"env: max_steps={SIM_TRUNCATE}: episodes ended {endings}  "
          f"[{card}]")
    check(endings[-1] == ("max-steps-reached", SIM_TRUNCATE) and all(
        n < SIM_TRUNCATE for m, n in endings[:-1]),
        f"max_steps={SIM_TRUNCATE}: endings {endings}")

    envs = [DuckietownEnv(**kw, device=d, draws=EnvDraws(SEED))
            for d in (device, "cpu")]
    worst = [0.0, 0.0, 1.0]
    for _ in range(SIM_CHECK_STEPS):
        act = _expert(envs[1])
        (og, _, dg, ig), (oc, _, dc, ic) = (e.step(act) for e in envs)
        check((dg, ig["msg"]) == (dc, ic["msg"]),
              f"card and CPU ended differently: {ig['msg']}, {ic['msg']}")
        if dg:
            for e in envs:
                e.reset()
        worst = [max(worst[0], float(np.abs(envs[0].cur_pos
                                            - envs[1].cur_pos).max())),
                 max(worst[1], abs(envs[0].cur_angle - envs[1].cur_angle)),
                 min(worst[2], float((og == oc).mean()))]
    print(f"env: card against CPU over {SIM_CHECK_STEPS} steps, same seed "
          f"and draws: max |pos| {worst[0]:.3e} m, max |angle| "
          f"{worst[1]:.3e} rad, frames equal >= {worst[2]:.6f} (limits "
          f"{SIM_POSE_TOL}, {SIM_ANGLE_TOL}, {DG_RENDER_EQUAL})  [{card}]")
    check(worst[0] <= SIM_POSE_TOL and worst[1] <= SIM_ANGLE_TOL
          and worst[2] >= DG_RENDER_EQUAL, "the env on the card disagrees "
          "with the CPU")
    return {"load_ms": load_s * 1e3, "reset_ms": reset_ms,
            "step_ms": step_s / SIM_STEPS * 1e3, "render_ms": render_ms,
            "steps_per_s": SIM_STEPS / step_s}


def learning_check(device, card, tmp) -> None:
    """Phases 22b-e: ``cli.sim_benchmark`` at its defaults; imitation and
    DDPG at their defaults, each then rolled out by ``cli.enjoy``;
    ``cli.basic_control --out`` and ``cli.free_camera --orbit``."""
    from sim2real_lane_segment_tpu_torch.cli import (basic_control, enjoy,
                                                     free_camera,
                                                     sim_benchmark,
                                                     train_imitation,
                                                     train_reinforcement)
    from sim2real_lane_segment_tpu_torch.data import videoio
    from sim2real_lane_segment_tpu_torch.data.png import read_png

    bench = sim_benchmark.main(SIM_BENCH_ARGS, device=device)
    print(f"sim_benchmark: {json.dumps(bench)}  [{card}]", flush=True)

    t0 = time.perf_counter()
    res = train_imitation.main(["--out", os.path.join(tmp, "bc.pt"),
                                *IMITATION_ARGS], device=device)
    wall = time.perf_counter() - t0
    losses = res["epoch_losses"]
    print(f"train_imitation: {res['frames']} frames, epoch losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}, {wall:.1f} s  [{card}]",
          flush=True)
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"imitation losses {losses}")
    avi = os.path.join(tmp, "enjoy_bc.avi")
    out = enjoy.main(["imitation", "--weights", res["out"], "--out", avi],
                     device=device)
    n = videoio.frame_count(avi)
    print(f"enjoy imitation: return {out['mean_return']:.2f} over "
          f"{out['steps']} steps, {n} frames written  [{card}]")
    check(n == out["steps"] > 0, f"{n} frames for {out['steps']} steps")

    t0 = time.perf_counter()
    res = train_reinforcement.main(["--out", os.path.join(tmp, "ddpg.pt"),
                                    *DDPG_ARGS], device=device)
    wall = time.perf_counter() - t0
    cl, al = res["critic_losses"], res["actor_losses"]
    print(f"train_reinforcement: {len(cl)} DDPG steps, critic loss "
          f"{cl[0]:.4f} -> {cl[-1]:.4f}, actor loss {al[0]:.4f} -> "
          f"{al[-1]:.4f}, evals {res['evals']}, {wall:.1f} s  [{card}]",
          flush=True)
    check(len(cl) > 0 and np.isfinite(cl + al).all()
          and os.path.exists(res["out"]), "DDPG losses or actor")
    out = enjoy.main(["reinforcement", "--weights", res["out"]],
                     device=device)
    print(f"enjoy reinforcement: return {out['mean_return']:.2f} over "
          f"{out['steps']} steps  [{card}]")

    avi = os.path.join(tmp, "basic.avi")
    t0 = time.perf_counter()
    total = basic_control.main(["--out", avi], device=device)
    n = videoio.frame_count(avi)
    print(f"basic_control: 120 steps, total reward {total:.2f}, {n} frames "
          f"in {time.perf_counter() - t0:.1f} s  [{card}]")
    check(n == 120 and np.isfinite(total), f"basic_control wrote {n}")
    orbit = os.path.join(tmp, "orbit")
    check(free_camera.main(["--orbit", "--out_dir", orbit], device=device)
          == 8, "free_camera --orbit")
    shapes = {read_png(os.path.join(orbit, f)).shape
              for f in os.listdir(orbit)}
    check(len(os.listdir(orbit)) == 8 and shapes == {(240, 320, 3)},
          f"orbit frames {shapes}")


def demo_video_check(device, card, tmp, weights) -> dict:
    """Phase 22f: ``cli.make_demo_video -t baseline --arch 67 --fused -b
    64`` with phase 8's weights on a rendered 128-frame 480x640 video: K4's
    launches (55/5/1 a batch, every dense layer on the tensor cores), no
    plain version, the class maps against the run without ``--fused``: all
    pixels (MIN_PIXEL_AGREEMENT) and the pixels either run paints
    (MIN_PAINTED_AGREEMENT), so that a route painting no class fails."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import make_demo_video
    from sim2real_lane_segment_tpu_torch.data import videoio
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
    from sim2real_lane_segment_tpu_torch.sim import lanes, render, rollout
    from sim2real_lane_segment_tpu_torch.sim.maps import builtin_map

    m = builtin_map(SIM_MAP)
    la = lanes.build_lane_arrays(m, device)
    pos, ang = rollout.sample_spawns(m, la, np.random.default_rng(SEED),
                                     DEMO_AGENTS, device)
    batch = rollout.expert_rollout(
        render.build_scene(m, SEED, device=device), la,
        torch.Generator(device).manual_seed(SEED), pos, ang,
        tile_size=m.tile_size, n_steps=DEMO_STEPS, height=SIM_SIZE[0],
        width=SIM_SIZE[1])
    frames = batch.orig.transpose(0, 1).reshape(-1, *SIM_SIZE, 3).flip(-1)
    src = os.path.join(tmp, "drive.avi")
    with videoio.VideoWriter(src, SIM_SIZE[::-1]) as wr:
        wr.write(frames.cpu().numpy())
    n_in = len(frames)

    plain_calls = []

    def counting(name):
        fn = getattr(kdb, name)

        def f(*a, **kw):
            plain_calls.append(name)
            return fn(*a, **kw)
        return f

    maps = {}
    predict_video = make_demo_video.predict_video

    def recording(key):
        """``predict_video`` keeping the class maps it paints as ``key``."""
        def run(vin, vout, trainer, batch_size, predict):
            out = maps.setdefault(key, [])

            def kept(x):
                pred = predict(x)
                out.append(pred.cpu())
                return pred
            return predict_video(vin, vout, trainer, batch_size, kept)
        return run

    argv = ["-t", "baseline", "--checkpointPath", weights, "--arch", ARCH,
            "-b", str(DEMO_BATCH), "--videoIns", src, "--videoOuts"]
    fused = os.path.join(tmp, "demo_fused.avi")
    with mock.patch.multiple(kdb, **{n: counting(n) for n in (
            "dense_block_plain", "dense_layer_plain", "transition_plain",
            "classifier_plain", "bn_relu_plain")}):
        kdb.reset_launches()
        st = make_demo_video.main(argv + [fused, "--fused"], device=device)
        launches = dict(kdb.launches)
        mma = kdb.mma_launches["dense_layer"]
        with mock.patch.object(make_demo_video, "predict_video",
                               recording("fused")):
            again = make_demo_video.main(argv + [fused, "--fused"],
                                         device=device)
    batches = -(-n_in // DEMO_BATCH)
    expect = {"dense_layer": 55 * batches, "transition": 5 * batches,
              "classifier": batches}
    print(f"make_demo_video --fused: K4 launches {json.dumps(launches)}, "
          f"expected {json.dumps(expect)}; tensor-core dense layers {mma}; "
          f"plain versions run {len(plain_calls)}  [{card}]")
    check(launches == expect and mma == DENSE_LAYERS * batches,
          "make_demo_video's K4 launches")
    check(not plain_calls, f"a plain version ran: {sorted(set(plain_calls))}")
    plain = os.path.join(tmp, "demo_plain.avi")
    with mock.patch.object(make_demo_video, "predict_video",
                           recording("plain")):
        st_plain = make_demo_video.main(argv + [plain], device=device)
    a, b = (np.concatenate(list(videoio.read_frames(p)))
            for p in (fused, plain))
    pixels = float((a == b).all(-1).mean())
    mf, mp = (torch.cat(maps[k]).numpy() for k in ("fused", "plain"))
    agreement = float((mf == mp).mean())
    either = (mf != 0) | (mp != 0)
    painted = float(((mf == mp) & either).sum() / max(either.sum(), 1))
    shares = [float((m != 0).mean()) for m in (mf, mp)]
    for label, s in (("--fused, first run", st), ("--fused, again", again),
                     ("plain module", st_plain)):
        fps = s["frames"] / s["seconds"]
        print(f"make_demo_video ({label}): {s['frames']} frames 480x640 -> "
              f"160x120 in {s['seconds']:.2f} s, {fps:.1f} frames/s; host "
              f"decode {s['decode_s']:.2f} s (reader "
              f"thread), device {s['device_s']:.2f} s, encode "
              f"{s['encode_s']:.2f} s (writer thread)  [{card}]")
    print(f"make_demo_video: fused against plain, class maps equal "
          f"{agreement:.6f} (limit {MIN_PIXEL_AGREEMENT}); of the pixels "
          f"either paints {painted:.6f} (limit {MIN_PAINTED_AGREEMENT}); "
          f"painted share {shares[0]:.6f} fused, {shares[1]:.6f} plain "
          f"(at least {MIN_PAINTED_SHARE}); output pixels equal "
          f"{pixels:.6f}  [{card}]")
    check(st["frames"] == n_in and a.shape == (n_in, H, W, 3),
          f"{st['frames']} frames of {a.shape[1:]}")
    check(mf.shape == mp.shape == (n_in, H, W), f"class maps {mf.shape}")
    check(agreement >= MIN_PIXEL_AGREEMENT,
          f"fused and plain masks agree on {agreement}")
    check(shares[1] >= MIN_PAINTED_SHARE,
          f"the plain run paints {shares[1]} of its pixels: the weights "
          "cannot show a route that paints nothing")
    check(painted >= MIN_PAINTED_AGREEMENT,
          f"fused and plain agree on {painted} of the painted pixels")
    return {"launches": launches, "fps": again["frames"] / again["seconds"]}


def comparison_check(device, card, tmp) -> None:
    """Phase 22g: ``cli.comparison --showCount 4`` over five seeded 2-class
    FCDenseNet57 weights and 480x640 PNGs; the PNG read back."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import comparison
    from sim2real_lane_segment_tpu_torch.cli.test import build_model
    from sim2real_lane_segment_tpu_torch.data.png import read_png

    data = os.path.join(tmp, "compare")
    write_frames(data, frames_480(np.random.default_rng(SEED + 22), 6))
    argv = ["--dataPath", data, "--showCount", str(COMPARISON_SHOW),
            "--resultPath", os.path.join(tmp, "comparison.png")]
    for i, flag in enumerate(("--baselinePath", "--sandtPath", "--hmPath",
                              "--cycleganPath", "--mmePath")):
        torch.manual_seed(SEED + i)
        path = os.path.join(tmp, f"fcdensenet57_{i}.pt")
        torch.save(build_model("57", 2).state_dict(), path)
        argv += [flag, path]
    t0 = time.perf_counter()
    out = read_png(comparison.main(argv, device=device), color=None)
    rows = 24 + COMPARISON_SHOW * 120
    print(f"comparison: {out.shape} montage in "
          f"{time.perf_counter() - t0:.1f} s  [{card}]")
    check(out.shape == (rows, 960, 4), f"montage {out.shape}")
    check(np.array_equal(out[:24], comparison.header()),
          "the montage's header is not the header function's")
    check((out[24:, :, 3] == 255).all(), "montage rows not opaque")


def sim_learning_video_phase(device, card, weights) -> dict:
    """Phase 22, each part's seconds printed."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out["env"] = env_check(device, card)
        print(f"sim: 22a in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        learning_check(device, card, tmp)
        print(f"sim: 22b-e in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        out["demo"] = demo_video_check(device, card, tmp, weights)
        print(f"sim: 22f in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        comparison_check(device, card, tmp)
        print(f"sim: 22g in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 23: the kernel diagnostics and the real-domain ingestion path
# ---------------------------------------------------------------------------

BREAKDOWN_BATCH = 256
BREAKDOWN_ARGS = ["--arch", ARCH, "-b", str(BREAKDOWN_BATCH)]
# the breakdown CLIs' harness constants, cut for this run (calls a timed
# run and runs; the widths stay full)
BREAKDOWN_TIMING = {"K": 4, "ITERS": 2}
ABLATE_LEVEL = "120x160 c_in=48"   # one level: the first block
K4_PER_FORWARD = {"dense_layer": DENSE_LAYERS, "transition": 5,
                  "classifier": 1}
TRAIN_BREAKDOWN_ARGS = ["--arch", ARCH, "-b", "128"]
TRAIN_BREAKDOWN_TIMING = {"K": 2, "K_FULL": 2, "ITERS": 2}
TRAIN_BENCH_ARGS = ["--archs", ARCH, "lite", "-b", "64", "--steps", "4",
                    "--iters", "2"]
REAL_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "fixtures", "labelme_frames")
REAL_MME_BATCH = 3   # 1 source + 2 target/train frames, 3 unlabelled


def _finite(*vals) -> bool:
    return all(v is not None and np.isfinite(v) for v in vals)


def serve_breakdown_check(card, dense_bound_b64: float) -> dict:
    """Phase 23a: ``cli.serve_breakdown --arch 67 -b 256 --ablate`` one
    level, K4's counts (and the variants') set to 0 just before and read
    just after: 11 level rows, 55/5/1 launches a forward, every dense layer
    on the tensor cores, both variants launched, no plain version, every
    row finite and within the card's peaks, the levels' sum within the full
    forward and its spread, and the dense layers' bound at B=256 four times
    phase 5's at B=64.  Returns the launch counts."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import serve_breakdown
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb

    plain = {}
    with mock.patch.multiple(kdb, **_plain_counting(
            kdb, ("dense_layer_plain", "transition_plain",
                  "classifier_plain"), plain)), \
            mock.patch.multiple(serve_breakdown, **BREAKDOWN_TIMING):
        kdb.reset_launches()
        t0 = time.perf_counter()
        res = serve_breakdown.main(BREAKDOWN_ARGS + ["--ablate",
                                                     ABLATE_LEVEL])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, mma = dict(kdb.launches), dict(kdb.mma_launches)
        ablated = dict(kdb.ablate_launches)
    rows = res["levels"]
    print(f"serve_breakdown: B={BREAKDOWN_BATCH} in {wall:.1f} s; "
          f"{len(rows)} levels, sum {res['sum_ms']:.3f} ms, full forward "
          f"{res['full_ms']:.3f} ms (spread {res['full_spread_ms']:.3f} ms, "
          f"{res['fps']:.1f} frames/s), glue {res['glue_ms']:.3f} ms; dense "
          f"layers' bound {res['dense_layer_bound_ms']:.3f} ms; K4 launches "
          f"{json.dumps(launches)} ({json.dumps(res['launches_per_forward'])}"
          f" a forward), tensor-core {json.dumps(mma)}, --ablate "
          f"{json.dumps(ablated)}, plain versions {json.dumps(plain)}  "
          f"[{card}]", flush=True)
    check(len(rows) == 11, f"serve_breakdown: {len(rows)} level rows")
    check(res["launches_per_forward"] == K4_PER_FORWARD,
          f"serve_breakdown: {res['launches_per_forward']} a forward")
    check(all(launches[k] > 0 for k in K4_PER_FORWARD)
          and mma["dense_layer"] == launches["dense_layer"],
          f"serve_breakdown: launches {launches}, tensor-core {mma}")
    check(all(ablated.values()), f"serve_breakdown: --ablate {ablated}")
    check(not any(plain.values()), f"serve_breakdown: a plain version ran "
          f"{plain}")
    abl = [r for r in rows if ABLATE_LEVEL in r["level"]]
    check(len(abl) == 1 and _finite(abl[0].get("no_taps_ms"),
                                    abl[0].get("no_prep_ms")),
          f"serve_breakdown: the --ablate level {abl}")
    for r in rows:
        ok = _finite(r["ms"], r["mxu_pct"], r["hbm_pct"]) and r["ms"] > 0
        check(ok, f"serve_breakdown: row {r}")
        check(ok and r["mxu_pct"] <= 100 and r["hbm_pct"] <= 100,
              f"serve_breakdown: {r['level']} above the card's peak "
              f"({r['mxu_pct']}% MXU, {r['hbm_pct']}% HBM)")
    check(res["sum_ms"] <= res["full_ms"] + res["full_spread_ms"],
          f"serve_breakdown: the levels' sum {res['sum_ms']:.3f} ms exceeds "
          f"the full forward {res['full_ms']:.3f} + "
          f"{res['full_spread_ms']:.3f} ms")
    want = dense_bound_b64 * BREAKDOWN_BATCH / TIME_BATCH
    check(abs(res["dense_layer_bound_ms"] - want) <= 0.01 * want,
          f"serve_breakdown: dense layers' bound "
          f"{res['dense_layer_bound_ms']:.3f} ms, phase 5's scaled {want:.3f}")
    return {"launches": launches, "ablated": ablated, "result": res}


def train_breakdown_check(card) -> dict:
    """Phase 23b: ``cli.train_breakdown --arch 67 -b 128`` with K1-K3b's
    counts set to 0 just before and read just after: 5 TransitionDown rows
    (one tap), the full forward, forward and backward and step, all finite,
    every kernel launched, on the tensor-core route, no plain version."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import train_breakdown
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb

    plain = {}
    with mock.patch.multiple(ktb, **_plain_counting(
            ktb, [f"{k}_plain" for k in TRAIN_KERNELS], plain)), \
            mock.patch.multiple(train_breakdown, **TRAIN_BREAKDOWN_TIMING):
        ktb.reset_launches()
        t0 = time.perf_counter()
        res = train_breakdown.main(TRAIN_BREAKDOWN_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, mma = dict(ktb.launches), dict(ktb.mma_launches)
    rows = res["levels"]
    print(f"train_breakdown: B=128 in {wall:.1f} s; {len(rows)} consumers, "
          f"fwd {res['fwd_sum_ms']:.3f} ms, vjp {res['vjp_sum_ms']:.3f} ms; "
          f"full fwd {res['full_fwd_ms']:.3f} ms, fwd+bwd "
          f"{res['full_fwd_bwd_ms']:.3f} ms, step {res['step_ms']:.3f} ms "
          f"({res['img_s']:.1f} img/s); K1-K3b launches "
          f"{json.dumps(launches)}, tensor-core {json.dumps(mma)}, plain "
          f"versions {json.dumps(plain)}  [{card}]", flush=True)
    check(len(rows) == 5 and all(r["taps"] == 1 for r in rows),
          f"train_breakdown: rows {[r['level'] for r in rows]}")
    for r in rows:
        check(_finite(r["fwd_ms"], r["vjp_ms"], r["fwd_mxu_pct"])
              and r["fwd_mxu_pct"] <= 100, f"train_breakdown: row {r}")
    check(_finite(res["full_fwd_ms"], res["full_fwd_bwd_ms"], res["step_ms"]),
          f"train_breakdown: {res}")
    check(all(launches.values()) and mma == launches,
          f"train_breakdown: launches {launches}, tensor-core {mma}")
    check(not any(plain.values()), f"train_breakdown: a plain version ran "
          f"{plain}")
    return launches


def train_benchmark_check(card) -> dict:
    """Phase 23c: ``cli.train_benchmark --archs 67 lite -b 64``, then with
    ``--pallas_train`` (K1-K3b's counts set to 0 just before and read just
    after: the two warm-up steps and the capture of FCDenseNet67's step, no
    plain version), then ``--stages``.  The headline lines go through the
    CUDA-graph replay; every number finite."""
    import gc

    import torch

    from sim2real_lane_segment_tpu_torch.cli import train_benchmark
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb
    from sim2real_lane_segment_tpu_torch.train import graphs

    t0 = time.perf_counter()
    rows = train_benchmark.main(TRAIN_BENCH_ARGS)
    plain = {}
    with mock.patch.multiple(ktb, **_plain_counting(
            ktb, [f"{k}_plain" for k in TRAIN_KERNELS], plain)):
        gc.collect()
        torch.cuda.empty_cache()
        ktb.reset_launches()
        graphs.reset_counts()
        prows = train_benchmark.main(TRAIN_BENCH_ARGS + ["--pallas_train"])
        torch.cuda.synchronize()
        launches = dict(ktb.launches)
        replays = dict(graphs.counts)
    gc.collect()
    torch.cuda.empty_cache()
    srows = train_benchmark.main(TRAIN_BENCH_ARGS + ["--stages"])
    wall = time.perf_counter() - t0
    for r in rows + prows:
        print(f"train_benchmark: {r['metric']} {r['value']:.1f} "
              f"{r['unit']} ({r['step_ms']:.3f} ms a B={r['batch']} step, "
              f"{r['dispatch']}), final loss {r['final_loss']:.4f}  [{card}]")
    for r in srows:
        print(f"train_benchmark: {r['metric']} (ms a step, eager) "
              + ", ".join(f"{k} {r[k]:.3f}" for k in train_benchmark.STAGES)
              + f"  [{card}]")
    print(f"train_benchmark: 3 runs in {wall:.1f} s; --pallas_train K1-K3b "
          f"launches {json.dumps(launches)}, graphs {json.dumps(replays)}, "
          f"plain versions {json.dumps(plain)}  [{card}]", flush=True)
    names = [r["metric"] for r in rows + prows]
    check(names == [f"train_images_per_sec_{ARCH}", "train_images_per_sec_lite",
                    f"train_images_per_sec_{ARCH}_pallas",
                    "train_images_per_sec_lite"],
          f"train_benchmark: metrics {names}")
    check(all(r["dispatch"] == "cuda_graph" and r["value"] > 0
              and _finite(r["value"], r["final_loss"]) for r in rows + prows),
          f"train_benchmark: {rows + prows}")
    once = graphs.WARMUP_STEPS + 1   # eager warm-ups, then the capture
    check(launches == {k: v * once for k, v in
                       TRAIN_LAUNCHES_PER_STEP.items()},
          f"train_benchmark --pallas_train: launches {launches}")
    check(replays["captures"] == 2, f"train_benchmark: graphs {replays}")
    check(not any(plain.values()), f"train_benchmark: a plain version ran "
          f"{plain}")
    check(all(_finite(*(r[k] for k in train_benchmark.STAGES)) for r in srows),
          f"train_benchmark --stages: {srows}")
    return launches


def real_domain_check(sd, device, card, tmp) -> dict:
    """Phase 23d: ``cli.create_real_db`` on the committed labelme fixtures
    on the card, its masks byte-equal to a run on the CPU (and each
    fixture's mask from ``shapes_to_label`` on both devices);
    ``cli.preprocess_db --dbType real``; one ``--trainType mme --augment
    --pallas_train`` step of FCDenseNet67 (seeded weights) on a synthetic
    source plus the real target (phase 15's launch checks, two passes);
    then ``cli.get_real_data --imitate`` and ``plot_lr``'s values."""
    import shutil

    import torch

    from sim2real_lane_segment_tpu_torch.cli import (create_real_db,
                                                     get_real_data, plot_lr,
                                                     preprocess_db)
    from sim2real_lane_segment_tpu_torch.data.png import read_png

    real, on_cpu = os.path.join(tmp, "realData"), os.path.join(tmp, "cpu")
    t0 = time.perf_counter()
    res = create_real_db.main(["--imgPath", REAL_FIXTURES, "--targetPath",
                               real])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    res_cpu = create_real_db.main(["--imgPath", REAL_FIXTURES,
                                   "--targetPath", on_cpu], device="cpu")
    check(res == res_cpu == {"labelled": 3, "unlabelled": 3},
          f"create_real_db: {res}, on the CPU {res_cpu}")
    diff = 0
    for name in sorted(os.listdir(os.path.join(real, "label"))):
        a = read_png(os.path.join(real, "label", name), color=False)
        b = read_png(os.path.join(on_cpu, "label", name), color=False)
        diff += int((a != b).sum()) + int(a.shape != b.shape)
    masks = 0
    for path in sorted(os.listdir(REAL_FIXTURES)):
        if not path.endswith(".json"):
            continue
        with open(os.path.join(REAL_FIXTURES, path)) as f:
            shapes = json.load(f)["shapes"]
        img = read_png(os.path.join(REAL_FIXTURES, path[:-5] + ".png"))
        m = create_real_db.shapes_to_label(
            img.shape, shapes, create_real_db.LABEL_NAME_TO_VALUE, device)
        check(m.device.type == "cuda", "shapes_to_label ran off the card")
        ref = create_real_db.shapes_to_label(
            img.shape, shapes, create_real_db.LABEL_NAME_TO_VALUE, "cpu")
        diff += int((m.cpu() != ref).sum())
        masks += 1
    label0 = read_png(os.path.join(real, "label", "000000.png"), color=False)
    print(f"create_real_db: {res} on the card in {card_s:.2f} s; masks "
          f"against the CPU run: {diff} pixels differ over 3 label PNGs and "
          f"{masks} fixture masks; classes {sorted(np.unique(label0))}  "
          f"[{card}]", flush=True)
    check(diff == 0 and masks == 3, f"create_real_db: {diff} pixels differ")
    check(set(np.unique(label0)) == {0, 1, 2, 3},
          f"create_real_db: classes {np.unique(label0)}")

    preprocess_db.main(["--dbType", "real", "--dataPath", real,
                        "--train_ratio", "0.67"])
    sizes = tuple(len(os.listdir(os.path.join(real, s, "input")))
                  for s in ("train", "test", "unlabelled"))
    check(sizes == (2, 1, 3), f"preprocess_db --dbType real: {sizes}")
    root = os.path.join(tmp, "simRealData")
    write_png_tree(root, splits=(("source", 1),))
    shutil.copytree(real, os.path.join(root, "target"))
    weights = os.path.join(tmp, "pretrained.pt")
    torch.save(sd, weights)
    argv = ["--trainType", "mme", "--dataPath", root, "--pretrained_path",
            weights, "--arch", ARCH, "--augment", "--pallas_train",
            "--max_epochs", "1", "-b", str(REAL_MME_BATCH),
            "--default_root_dir", os.path.join(tmp, "mme"), "--log_every",
            "1", "--seed", str(SEED)]
    _, mme_launches, _ = train_cli_checked(
        "train (MME, real target)", argv, 2, REAL_MME_BATCH, card,
        batch=REAL_MME_BATCH)

    got = get_real_data.main(["--imitate"])
    check(got == {"videos": 0, "frames": 0, "urls": 78},
          f"get_real_data --imitate: {got}")
    lrs = plot_lr.schedules(1e-3, 1000, 175)
    flat = [v for series in lrs.values() for v in series]
    check(all(len(v) == 175 for v in lrs.values()) and _finite(*flat)
          and lrs["adamw"][0] == 1e-3 and min(flat) > 0,
          f"plot_lr: {[(k, v[:2]) for k, v in lrs.items()]}")
    print(f"get_real_data --imitate: {got['urls']} URLs, no network; "
          f"plot_lr: {len(lrs)} schedules x 175 epochs, AdamW "
          f"{lrs['adamw'][0]:.3g} -> {min(lrs['adamw']):.3g} (the card's "
          f"machine has no matplotlib: values only)  [{card}]", flush=True)
    return mme_launches


def ablation_entries(sd, device, card, ablated) -> list:
    """Phase 23e: the two --ablate variants of the tensor-core dense layer
    against their plain versions on all 55 layers of a B=64 forward (each
    layer alone), then each variant's time per B=64 forward beside its
    plain version, the cuDNN conv of the same function and its bound.
    Returns their kernels-line entries (``launches``: phase 23a's)."""
    import torch
    import torch.nn.functional as F

    from sim2real_lane_segment_tpu_torch.core.dtypes import DEFAULT_POLICY
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
    from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import \
        fold_model

    model = make_model(sd, DEFAULT_POLICY, device)
    folded = fold_model(model)
    x = model_input(synthetic_frames(np.random.default_rng(SEED + 3),
                                     TIME_BATCH), device)
    with torch.no_grad():
        calls = capture_blocks(model, x, folded)
    it = 2
    t = {m: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "bytes": 0.0, "ops": 0.0} for m in kdb.ABLATIONS}
    kdb.reset_launches()
    for _, segs, layers, _ in calls:
        feat = kdb.dense_block_plain(segs, layers, c_lo=0)
        b, _, h, w = feat.shape
        for mode, e in t.items():
            lib = []
            for lay in layers:
                k, _, g = lay.weight.shape
                buf, ref = feat.clone(), feat.clone()
                kdb.dense_layer(buf, lay, ablate=mode)
                kdb.dense_layer_plain(ref, lay, ablate=mode)
                a, r = buf[:, k:k + g].float(), ref[:, k:k + g].float()
                torch.testing.assert_close(
                    a, r, **ISOLATED_TOL["bfloat16"],
                    msg=f"--ablate {mode} layer at c={k}, {h}x{w}")
                e["err"] = max(e["err"], (a - r).abs().max().item())
                del buf, ref
                wo = lay.weight.reshape(k, 3, 3, g).permute(3, 0, 1, 2)
                if mode == "no_taps":
                    lib.append((kdb.bn_relu_plain(feat, lay.scale, lay.shift),
                                wo[:, :, 1:2, 1:2].contiguous(), 0))
                else:
                    lib.append((feat[:, :k], wo.contiguous(), 1))
                taps = 1 if mode == "no_taps" else 9
                e["bytes"] += (b * h * w * (k + g) * it + k * 9 * g * it
                               + 8 * k + 4 * g)
                e["ops"] += 2.0 * b * h * w * k * taps * g
            e["ms"] += _time_ms(lambda: [kdb.dense_layer(feat, lay,
                                                         ablate=mode)
                                         for lay in layers], reps=3)
            e["plain_ms"] += _time_ms(lambda: [kdb.dense_layer_plain(
                feat, lay, ablate=mode) for lay in layers], reps=3)
            e["library_ms"] += _time_ms(lambda: [F.conv2d(a, wo, padding=p)
                                                 for a, wo, p in lib], reps=3)
            del lib
    check(kdb.mma_launches["dense_layer"] == 0
          and all(kdb.ablate_launches.values()),
          f"--ablate: {kdb.ablate_launches}, default {kdb.mma_launches}")
    out = []
    for mode, e in t.items():
        t_bytes = e["bytes"] / PEAK_BYTES * 1e3
        t_ops = e["ops"] / PEAK_BF16_OPS * 1e3
        entry = {
            "name": f"k4_dense_{mode}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": ablated[mode],
            "max_abs_err": e["err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": e["library_ms"]}
        out.append(entry)
        print(f"timing: k4_dense_{mode} (--ablate) per B={TIME_BATCH} "
              f"forward: kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} "
              f"ms, cuDNN conv {e['library_ms']:.3f} ms, bound "
              f"{entry['bound_ms']:.3f} ms ({entry['bound_by']}); max|err| "
              f"against plain {e['err']:.3e} (limit "
              f"{ISOLATED_TOL['bfloat16']})  [{card}]", flush=True)
    return out


def diagnostics_phase(sd, device, card, kernels) -> None:
    """Phase 23: the kernel diagnostics and the real-domain path, each
    part's seconds printed; adds this phase's launch counts and the two
    --ablate variants to ``kernels``."""
    dense_bound = next(k["bound_ms"] for k in kernels
                       if k["name"] == "k4_dense_layer")
    t0 = time.perf_counter()
    serve = serve_breakdown_check(card, dense_bound)
    print(f"diagnostics: 23a in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    train = {"launches_breakdown": train_breakdown_check(card)}
    print(f"diagnostics: 23b in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    train["launches_train_benchmark"] = train_benchmark_check(card)
    print(f"diagnostics: 23c in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        train["launches_real_mme"] = real_domain_check(sd, device, card,
                                                       tmp)
    print(f"diagnostics: 23d in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    kernels += ablation_entries(sd, device, card, serve["ablated"])
    print(f"diagnostics: 23e in {time.perf_counter() - t0:.1f} s", flush=True)
    for k in kernels:
        if k["name"].startswith("k4_") and k["name"][3:] in serve["launches"]:
            k["launches_breakdown"] = serve["launches"][k["name"][3:]]
        for wrapper, (name, _) in TRAIN_KERNELS.items():
            if k["name"] == name:
                for key, counts in train.items():
                    k[key] = counts[wrapper]


# ---------------------------------------------------------------------------
# phase 24: the JAX package's FFV1 recordings through the port's codec
# ---------------------------------------------------------------------------

FFV1_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "sim2real_lane_segment_tpu_torch", "data",
                            "assets", "ffv1")
FFV1_AGENTS, FFV1_STEPS = 2, 64   # 128 rendered pairs: 256 frames
FFV1_TIMED = 32                    # frames of each kind MPNG is timed on


def _digests(frames) -> list:
    import hashlib

    return [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]


def ffv1_fixture_check(card, tmp) -> int:
    """Phases 24a-b: the committed JAX-written recording
    (``scripts/make_ffv1_fixture.py``: the JAX datagen's FFV1 pair, 16
    frames at 160x120, a keyframe at frames 0 and 12) decodes to cv2's
    digests; ``cli.postprocess`` labels it on the card through K5 (its
    count set to 0 just before and read just after) into the input and
    label videos whose frames have the digests of the JAX postprocess's.
    Returns K5's launches."""
    import shutil

    from sim2real_lane_segment_tpu_torch.cli import postprocess
    from sim2real_lane_segment_tpu_torch.data import videoio
    from sim2real_lane_segment_tpu_torch.kernels import labelgen as klg

    with open(os.path.join(FFV1_FIXTURE, "digests.json")) as f:
        want = json.load(f)
    rec = os.path.join(tmp, "jax_recording")
    os.makedirs(rec)
    for name, digests in want["recording"].items():
        path = os.path.join(FFV1_FIXTURE, name)
        got = _digests(np.concatenate(list(videoio.read_frames(path))))
        same = sum(a == b for a, b in zip(got, digests))
        print(f"ffv1: the JAX package's {name} ({videoio.codec_of(path)}, "
              f"{len(got)} frames): {same} of {len(digests)} frames equal "
              f"cv2's decode by SHA-256  [{card}]")
        check(got == digests, f"{name} decodes otherwise than cv2")
        shutil.copyfile(path, os.path.join(rec, name))
    out = os.path.join(tmp, "jax_labelled")
    klg.reset_launches()
    done = postprocess.main(["-id", rec, "-od", out])
    launches = klg.launches["labelgen"]
    for kind in ("input", "label"):
        path = os.path.join(out, kind, "000000.avi")
        got = _digests(np.concatenate(list(videoio.read_frames(path))))
        same = sum(a == b for a, b in zip(got, want["postprocess"][kind]))
        print(f"ffv1: postprocess of the JAX recording on the card, {kind} "
              f"({videoio.codec_of(path)}): {same} of {len(got)} frames "
              f"equal the JAX postprocess's; K5 launches {launches} "
              f"(expected 1)  [{card}]")
        check(got == want["postprocess"][kind],
              f"postprocess {kind} differs from the JAX postprocess's")
    check(done == 1 and launches == 1,
          f"postprocess: {done} recordings, K5 launches {launches}")
    return launches


def ffv1_round_trip(device, card) -> None:
    """Phases 24c-d: 128 rendered 480x640 pairs (loop_dyn_duckiebots, 2
    agents x 64 expert steps, fisheye) through ``data/ffv1``'s encoder and
    decoder, byte-equal, as two streams (orig, annot) of cv2's settings;
    ms per frame of FFV1 encode and decode on the host beside
    MPNG's (the PNG the port wrote before: Sub filter, zlib level
    ``videoio.ZLIB_LEVEL``) on FFV1_TIMED frames of each stream, and
    MPNG's decode under Paeth (which libpng's adaptive filters pick often)
    on one frame of each."""
    import torch

    from sim2real_lane_segment_tpu_torch.data import ffv1, png, videoio
    from sim2real_lane_segment_tpu_torch.sim import lanes, render, rollout
    from sim2real_lane_segment_tpu_torch.sim.maps import builtin_map

    h, w = DG_SIZE
    m = builtin_map("loop_dyn_duckiebots")
    la = lanes.build_lane_arrays(m, device)
    pos, ang = rollout.sample_spawns(m, la, np.random.default_rng(SEED + 24),
                                     FFV1_AGENTS, device)
    batch = rollout.expert_rollout(
        render.build_scene(m, SEED, device=device), la,
        torch.Generator(device).manual_seed(SEED + 24), pos, ang,
        tile_size=m.tile_size, n_steps=FFV1_STEPS, height=h, width=w,
        distortion=True)
    streams = {kind: frames.transpose(0, 1).reshape(-1, h, w, 3).flip(-1)
               .cpu().numpy() for kind, frames in (("orig", batch.orig),
                                                   ("annot", batch.annot))}
    n = sum(len(f) for f in streams.values())
    ms, sizes = {}, {}
    for kind, frames in streams.items():
        enc = ffv1.Encoder(w, h)
        t0 = time.perf_counter()
        packets = [enc.encode(f) for f in frames]
        ms[f"{kind} encode"] = (time.perf_counter() - t0) / len(frames) * 1e3
        dec = ffv1.Decoder(enc.extradata, w, h)
        t0 = time.perf_counter()
        out = [dec.decode(p) for p, _ in packets]
        ms[f"{kind} decode"] = (time.perf_counter() - t0) / len(frames) * 1e3
        keys = [i for i, (_, key) in enumerate(packets) if key]
        equal = sum(np.array_equal(a, b) for a, b in zip(out, frames))
        sizes[kind] = sum(len(p) for p, _ in packets) / len(frames) / 1e3
        print(f"ffv1 round trip: {kind} {len(frames)} frames {h}x{w}: "
              f"{equal} byte-equal, keyframes {keys}, "
              f"{sizes[kind]:.1f} kB a frame  [{card}]")
        check(equal == len(frames) and keys == list(
            range(0, len(frames), ffv1.KEYFRAME_INTERVAL)),
            f"FFV1 round trip of {kind}: {equal} of {len(frames)} equal")
    check(n == 2 * FFV1_AGENTS * FFV1_STEPS, f"{n} frames rendered")
    for kind, frames in streams.items():
        rgb = [np.ascontiguousarray(f[..., ::-1]) for f in frames[:FFV1_TIMED]]
        t0 = time.perf_counter()
        coded = [png.encode_png(f, 1, level=videoio.ZLIB_LEVEL) for f in rgb]
        ms[f"{kind} MPNG encode"] = ((time.perf_counter() - t0)
                                     / FFV1_TIMED * 1e3)
        # Paeth (numpy row by row) on one frame: it is ~20x slower
        for filt, label, data in (
                (1, "decode", coded),
                (4, "decode Paeth", [png.encode_png(
                    rgb[0], 4, level=videoio.ZLIB_LEVEL)])):
            t0 = time.perf_counter()
            back = [png.decode_png(d) for d in data]
            ms[f"{kind} MPNG {label}"] = ((time.perf_counter() - t0)
                                          / len(data) * 1e3)
            check(all(np.array_equal(a, b) for a, b in zip(back, rgb)),
                  f"PNG filter {filt} round trip")
        sizes[f"{kind} MPNG"] = sum(len(d) for d in coded) / FFV1_TIMED / 1e3
    print(f"timing (host): ms a {h}x{w} frame, FFV1 (4 slice threads) "
          f"against MPNG (one thread): "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + "; kB a frame: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in sizes.items())
          + f"  [{card}]", flush=True)


def ffv1_phase(device, card) -> dict:
    """Phase 24: the JAX package's FFV1 recordings through the port's
    codec, each part's seconds printed."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        k5 = ffv1_fixture_check(card, tmp)
        print(f"ffv1: 24a-b in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ffv1_round_trip(device, card)
    print(f"ffv1: 24c-d in {time.perf_counter() - t0:.1f} s", flush=True)
    return {"k5_launches": k5}


# ---------------------------------------------------------------------------
# phase 25: FCDenseNet57 (growth 12) on the tensor cores
# ---------------------------------------------------------------------------

ARCH57 = "57"
# launches of FCDenseNet57: a forward's 44 dense layers, 5 TransitionDowns
# and 1 classifier; a train step's 44 dense + 5 TD forwards, 5 TD
# backwards, 44 stages and 11 block inputs
K4_PER_FORWARD_57 = {"dense_layer": 44, "transition": 5, "classifier": 1}
TRAIN_PER_STEP_57 = {"consumer_fwd": 49, "consumer_bwd": 5, "stage": 44,
                     "final": 11}
G12_SPLITS = (("train", 64), ("valid", 32), ("test", 32))
# the kernels line's names of FCDenseNet57's rows
G12_NAMES = {"dense_layer": "k4_dense_layer_g12",
             **{k: f"{v[0]}_g12" for k, v in TRAIN_KERNELS.items()}}


def _entry(name, source, replaces, launches, err, d):
    """A kernels-line entry from timed sums ``d`` (ms, plain_ms,
    library_ms, bytes, ops)."""
    t_bytes = d["bytes"] / PEAK_BYTES * 1e3
    t_ops = d["ops"] / PEAK_BF16_OPS * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": d["ms"], "plain_ms": d["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": d["library_ms"]}


def growth_timing(sd, device, card, arch=ARCH57):
    """Phase 25d: ``arch``'s K4 dense layers per B=64 forward (per plane,
    beside one cuDNN conv on the activated operands) and its K1 (3x3 and
    1x1 apart), K2, K3a and K3b per B=32 ``--pallas_train`` step, every
    call timed alone (CUDA events) on the operands the path gives it, its
    plain version and the bound beside.  Each dense layer and train site
    is held against its plain version first.  It reads only what the port
    had before growth 12 took the tensor cores, so that
    ``scripts/torch_growth_timing.py`` runs it on an older tree too.
    Returns ({"dense_layer" and each train wrapper: timed sums, calls, max
    err, tensor-core launches}, the K1 3x3 sums)."""
    import torch
    import torch.nn.functional as F

    from sim2real_lane_segment_tpu_torch.cli.test import build_model
    from sim2real_lane_segment_tpu_torch.core.dtypes import DEFAULT_POLICY
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb
    from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import \
        fold_model
    from sim2real_lane_segment_tpu_torch.train.supervised import \
        SupervisedTrainer

    def sums():
        return {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
                "ops": 0.0, "calls": 0, "err": 0.0, "mma": 0}

    out = {k: sums() for k in ("dense_layer", *TRAIN_KERNELS)}
    # serving: B=64, every block's dense layers on the plain chain's buffer
    model = make_model(sd, DEFAULT_POLICY, device, arch)
    folded = fold_model(model)
    x = model_input(synthetic_frames(np.random.default_rng(SEED + 3),
                                     TIME_BATCH), device)
    d = out["dense_layer"]
    planes = {}  # (h, w) -> [layers, kernel ms, cuDNN ms, GFLOP]
    with torch.no_grad():
        for name, segs, layers, kw in capture_blocks(model, x, folded):
            feat = kdb.dense_block_plain(segs, layers, c_lo=0)
            b, _, h, w = feat.shape
            kdb.reset_launches()
            acts = []
            for lay in layers:
                k, _, g = lay.weight.shape
                buf = feat.clone()
                kdb.dense_layer(buf, lay)
                a, r = buf[:, k:k + g].float(), feat[:, k:k + g].float()
                torch.testing.assert_close(
                    a, r, **ISOLATED_TOL["bfloat16"],
                    msg=f"{arch} B={TIME_BATCH} {name} layer at c={k}")
                d["err"] = max(d["err"], (a - r).abs().max().item())
                del buf
                acts.append((kdb.bn_relu_plain(feat, lay.scale, lay.shift),
                             lay.weight.reshape(k, 3, 3, g)
                             .permute(3, 0, 1, 2).contiguous()))
                d["bytes"] += (b * h * w * (k + g) * 2 + k * 9 * g * 2
                               + 8 * k + 4 * g)
                d["ops"] += 2.0 * b * h * w * k * 9 * g
            d["calls"] += len(layers)
            d["mma"] += kdb.mma_launches["dense_layer"]
            ms = _time_ms(lambda: [kdb.dense_layer(feat, lay)
                                   for lay in layers])
            lib_ms = _time_ms(lambda: [F.conv2d(a, wo, padding=1)
                                       for a, wo in acts])
            d["ms"] += ms
            d["library_ms"] += lib_ms
            d["plain_ms"] += _time_ms(lambda: [kdb.dense_layer_plain(
                feat, lay) for lay in layers])
            p = planes.setdefault((h, w), [0, 0.0, 0.0, 0.0])
            p[0] += len(layers)
            p[1] += ms
            p[2] += lib_ms
            p[3] += sum(2.0 * b * h * w * lay.weight.shape[0] * 9
                        * lay.weight.shape[2] for lay in layers) / 1e9
            del feat, acts
    print(f"timing: FCDenseNet{arch} k4_dense_layer per resolution, "
          f"B={TIME_BATCH} (CUDA events; cuDNN conv on the activated "
          f"operands)  [{card}]")
    for (h, w), (n, ms, lib_ms, gflop) in planes.items():
        print(f"  {h:3d}x{w:<3d} {n:2d} layers {gflop:7.1f} GFLOP: kernel "
              f"{ms:8.3f} ms, cuDNN {lib_ms:8.3f} ms")
    del model, folded, x

    # training: one B=32 --pallas_train step recorded, each call again
    rng = np.random.default_rng(SEED + 9)
    images = synthetic_frames(rng, TRAIN_BATCH)
    labels = rng.integers(0, N_CLS, (TRAIN_BATCH, H, W)).astype(np.uint8)
    net = build_model(arch, N_CLS)
    net.load_state_dict(sd)
    trainer = SupervisedTrainer(num_cls=N_CLS, model=net, pallas_train=True)
    masks = train_masks(trainer.model, TRAIN_BATCH, device, SEED + 10)
    calls = []
    real = {k: getattr(ktb, k) for k in TRAIN_KERNELS}

    def recording(name):
        def wrapper(*a, **kw):
            res = real[name](*a, **kw)
            calls.append((name, a, kw, res))
            return res
        return wrapper

    ktb.reset_launches()
    with mock.patch.multiple(ktb, **{k: recording(k)
                                     for k in TRAIN_KERNELS}):
        trainer.train_step(images, labels, 1e-3, masks=masks)
    torch.cuda.synchronize()
    for k in TRAIN_KERNELS:
        out[k]["mma"] = ktb.mma_launches[k]
    k1_3x3 = sums()
    k1_3x3["mma"] = None  # the wrapper counts its 3x3 and 1x1 launches together
    with torch.no_grad():
        for name, a, kw, res in calls:
            kw = {k: v for k, v in kw.items() if k != "out"}
            e = out[name]
            e["calls"] += 1
            label = (f"{arch} bfloat16 B={TRAIN_BATCH} "
                     f"{TRAIN_KERNELS[name][0]:16s} site {e['calls']:2d}")
            e["err"] = max(e["err"], _hold_site(
                label, _as_list(real[name](*a, **kw)),
                _as_list(getattr(ktb, f"{name}_plain")(*a, **kw)),
                TRAIN_REL_TOL["bfloat16"], card))
        for name, a, kw, res in calls:
            kw = {k: v for k, v in kw.items() if k != "out"}
            e = out[name]
            moved, ops = _train_cost(name, a, res)
            ms = _time_ms(lambda: real[name](*a, **kw), 2)
            plain_ms = _time_ms(
                lambda: getattr(ktb, f"{name}_plain")(*a, **kw), 2)
            lib = _train_library(name, a)
            lib_ms = None if lib is None else _time_ms(lib, 2)
            cells = [e]
            if name == "consumer_fwd" and a[3].shape[1] == 9:
                cells.append(k1_3x3)
            for c in cells:
                c["bytes"] += moved
                c["ops"] += ops
                c["ms"] += ms
                c["plain_ms"] += plain_ms
                c["library_ms"] = (None if lib_ms is None
                                   else c["library_ms"] + lib_ms)
                c["calls"] += c is k1_3x3
    torch.cuda.synchronize()
    for name, e in out.items():
        lib = ("n/a" if e["library_ms"] is None
               else f"{e['library_ms']:.3f} ms")
        per = (f"B={TIME_BATCH} forward" if name == "dense_layer"
               else f"B={TRAIN_BATCH} train step")
        print(f"timing: FCDenseNet{arch} {G12_NAMES[name]} per {per} "
              f"({e['calls']} launches, {e['mma']} on the tensor cores): "
              f"kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms, "
              f"cuDNN yardstick {lib}, bound "
              f"{max(e['bytes'] / PEAK_BYTES, e['ops'] / PEAK_BF16_OPS) * 1e3:.3f}"
              f" ms ({e['ops'] / 1e9:.1f} GFLOP, {e['bytes'] / 1e9:.3f} GB), "
              f"max|err| {e['err']:.3e}  [{card}]")
    print(f"timing: FCDenseNet{arch} k1_consumer_fwd 3x3 alone: "
          f"{k1_3x3['calls']} launches {k1_3x3['ms']:.3f} ms, cuDNN "
          f"{k1_3x3['library_ms']:.3f} ms, bound "
          f"{max(k1_3x3['bytes'] / PEAK_BYTES, k1_3x3['ops'] / PEAK_BF16_OPS) * 1e3:.3f}"
          f" ms  [{card}]", flush=True)
    return out, k1_3x3


def growth12_paths(sd, card, tmp):
    """Phase 25c: FCDenseNet57's paths on the card with K4's and K1-K3b's
    counts set to 0 just before each and read just after, no plain version
    called: ``cli.train --arch 57 --pallas_train`` (one epoch of two B=32
    steps on a PNG tree), ``cli.test --arch 57 --fused`` on its test split
    and ``cli.serve --arch 57 --fused`` behind the engine.  Returns the
    launches {wrapper: count} of the train run and of the serving runs."""
    import torch

    from sim2real_lane_segment_tpu_torch.cli import serve
    from sim2real_lane_segment_tpu_torch.cli import train as train_cli
    from sim2real_lane_segment_tpu_torch.cli.test import \
        load_trainer_and_state
    from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
    from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb

    root = os.path.join(tmp, "simData57")
    write_png_tree(root, G12_SPLITS, seed=SEED + 25)
    plain = {}
    patches = (_plain_counting(ktb, [f"{k}_plain" for k in TRAIN_KERNELS],
                               plain),
               _plain_counting(kdb, ["dense_layer_plain", "transition_plain",
                                     "classifier_plain"], plain))
    with mock.patch.multiple(ktb, **patches[0]), \
            mock.patch.multiple(kdb, **patches[1]):
        ktb.reset_launches()
        t0 = time.perf_counter()
        res = train_cli.main(["--trainType", "sim", "--dataPath", root,
                              "--arch", ARCH57, "--pallas_train",
                              "--max_epochs", "1", "-b", str(TRAIN_BATCH),
                              "--default_root_dir", tmp, "--seed",
                              str(SEED)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        train = dict(ktb.launches)
        train_mma = dict(ktb.mma_launches)
        steps = G12_SPLITS[0][1] // TRAIN_BATCH
        expect = {k: v * steps for k, v in TRAIN_PER_STEP_57.items()}
        print(f"growth 12: cli.train --arch 57 --pallas_train, {steps} "
              f"steps of B={TRAIN_BATCH} in {wall:.1f} s: launches "
              f"{json.dumps(train)}, on the tensor cores "
              f"{json.dumps(train_mma)}, expected {json.dumps(expect)}  "
              f"[{card}]")
        check(train == expect and train_mma == expect,
              "cli.train --arch 57: a K1-K3b site missing or off the "
              "tensor-core route")
        weights = os.path.join(res["out_dir"], "best_weights.pt")

        eval_fused_checked("growth 12", "baseline", weights,
                           os.path.join(root, "test"), G12_SPLITS[2][1],
                           card, ARCH57, K4_PER_FORWARD_57)
        test_mma = kdb.mma_launches["dense_layer"]
        batches = -(-G12_SPLITS[2][1] // TRAIN_BATCH)
        check(test_mma == K4_PER_FORWARD_57["dense_layer"] * batches,
              f"cli.test --arch 57 --fused: {test_mma} dense layers on "
              f"the tensor cores")

        args = serve.parse_args(["--checkpointPath", weights, "--arch",
                                 ARCH57, "--num_cls", str(N_CLS),
                                 "--height", str(H), "--width", str(W),
                                 "--fused"])
        predict_fn, _, _ = serve.build_predict_fn(args)
        requests = client_requests(np.random.default_rng(SEED + 26))[:2]
        kdb.reset_launches()
        replies, stats, _ = drive_engine(predict_fn, requests)
        served = dict(kdb.launches)
        served_mma = kdb.mma_launches["dense_layer"]
    expect = {k: v * stats["batches"] for k, v in K4_PER_FORWARD_57.items()}
    print(f"growth 12: cli.serve --arch 57 --fused behind the engine, "
          f"{stats['batches']} batches: K4 launches {json.dumps(served)}, "
          f"dense layers on the tensor cores {served_mma}, expected "
          f"{json.dumps(expect)}; plain versions called {json.dumps(plain)}"
          f"  [{card}]")
    check(served == expect and served_mma == expect["dense_layer"],
          "cli.serve --arch 57: K4 launches or route differ")
    check(not any(plain.values()), "a plain version ran on an FCDenseNet57 "
          "path")
    ref = load_trainer_and_state("baseline", weights, num_cls=N_CLS,
                                 arch=ARCH57, height=H, width=W)
    same = total = 0
    for reqs, outs in zip(requests, replies):
        for frames, pred in zip(reqs, outs):
            same += int((ref.predict_step(frames).cpu().numpy()
                         == pred).sum())
            total += pred.size
    print(f"growth 12: served masks against the plain module (bf16) "
          f"{same / total:.6f} over {total} pixels  [{card}]")
    check(same / total >= MIN_PIXEL_AGREEMENT,
          f"FCDenseNet57 pixel agreement {same / total}")
    return train, {"dense_layer": served["dense_layer"]}


def growth12_phase(device, card) -> list:
    """Phase 25: FCDenseNet57, whose growth-12 dense layers take the
    tensor cores in bfloat16: (a) K4 against plain on all 11 blocks, B=8,
    f32 and bf16; (b) one fused B=4 train step with every K1-K3b site
    against plain (a dropped channel at every dropout site, zero BN
    shifts); (c) its train, test and serve paths through the kernels alone;
    (d) the timings.  Returns the kernels-line entries of its rows."""
    t0 = time.perf_counter()
    sd = seeded_state_dict(device, ARCH57)
    errs = {"dense_layer": 0.0, **{k: 0.0 for k in TRAIN_KERNELS}}
    for dtype_name in ("float32", "bfloat16"):
        e = compare_blocks(sd, device, dtype_name, card, ARCH57,
                           K4_PER_FORWARD_57["dense_layer"])
        errs["dense_layer"] = max(errs["dense_layer"], e["dense_layer"])
        for k, v in compare_train_kernels(sd, device, dtype_name, card,
                                          ARCH57, TRAIN_PER_STEP_57).items():
            errs[k] = max(errs[k], v)
    print(f"growth 12: (a), (b) done in {time.perf_counter() - t0:.1f} s  "
          f"[{card}]", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        launches = {}
        for counts in growth12_paths(sd, card, tmp):
            launches.update(counts)
    print(f"growth 12: (c) done in {time.perf_counter() - t0:.1f} s  "
          f"[{card}]", flush=True)
    timed, _ = growth_timing(sd, device, card, ARCH57)
    check(timed["dense_layer"]["mma"] == timed["dense_layer"]["calls"]
          == K4_PER_FORWARD_57["dense_layer"],
          f"B={TIME_BATCH}: {timed['dense_layer']['mma']} of "
          f"{timed['dense_layer']['calls']} dense layers on the tensor cores")
    check(all(timed[k]["mma"] == TRAIN_PER_STEP_57[k] for k in TRAIN_KERNELS),
          "B=32: a train site off the tensor-core route")
    entries = []
    for name, d in timed.items():
        source, replaces = ((SOURCE, REPLACES) if name == "dense_layer"
                            else (TRAIN_SOURCE, TRAIN_KERNELS[name][1]))
        entries.append(_entry(G12_NAMES[name], source, replaces,
                              launches[name], max(errs[name], d["err"]), d))
    print(f"growth 12: phase 25 done in {time.perf_counter() - t0:.1f} s  "
          f"[{card}]", flush=True)
    return entries


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        from sim2real_lane_segment_tpu_torch.kernels import build
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    card = card_label()
    device = torch.device("cuda")
    # strict float32, as every CLI of the port sets it
    from sim2real_lane_segment_tpu_torch.core.runtime import \
        set_float32_precision
    set_float32_precision()
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}")
    print(card, flush=True)

    seconds, clock = {}, [time.perf_counter()]

    def lap(phase):
        """Records the seconds since the last lap as ``phase``'s."""
        now = time.perf_counter()
        seconds[phase] = round(now - clock[0], 1)
        clock[0] = now

    # phase 2: build, one nvcc per CUDA source and the host compiler for
    # the FFV1 codec, all at once
    t0 = time.perf_counter()
    sources = ("dense_block", "train_block", "int8_body", "labelgen")
    build.build(*sources, "ffv1")
    for name in sources + ("ffv1",):
        build.load(name)
    nvcc = {k: v for k, v in build.build_seconds.items() if k in sources}
    cxx = build.build_seconds.get("ffv1")
    print(f"build: {', '.join(sources)} and ffv1 in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {json.dumps(nvcc)} s; "
          f"ffv1 with {build.find_cxx()}: "
          f"{'built before' if cxx is None else f'{cxx:.1f} s'})  [{card}]")
    for name in sources:
        for entry, info in ptxas_report(build.build_log.get(name, "")):
            tag = (" [tensor cores]" if entry in MMA_KERNELS + IMMA_KERNELS
                   else "")
            print(f"  {name}: {entry}{tag}: {info}")
    for name in sources:
        for entry, info in ptxas_report(build.build_log.get(name, "")):
            if entry in REDESIGNED:
                print(f"build: {entry}: {info}  [{card}]")
    shared = [f"{entry}: {info}" for name in sources
              for entry, info in ptxas_report(build.build_log.get(name, ""))
              if entry in SHARED_BODY]
    if shared:  # the libraries were built in this run
        print(f"build: the 3x3 body's kernels (K1 and serving's, the "
              f"--ablate variants): {'; '.join(shared)}  [{card}]")
    hmma = tensor_core_instructions(build)
    if hmma is None:
        print("build: cuobjdump not found beside nvcc; tensor-core "
              "instructions not checked")
    else:
        print(f"build: tensor-core instructions (HMMA, HGMMA; IMMA for "
              f"{', '.join(IMMA_KERNELS)}) per kernel {json.dumps(hmma)}  "
              f"[{card}]")
        check(all(hmma.values()), "a tensor-core kernel holds no HMMA, "
              "HGMMA or IMMA instruction")

    lap("1-2")

    # phase 3: kernel against plain, every block at full width
    t0 = time.perf_counter()
    sd = seeded_state_dict(device)
    errs = {}
    for dtype_name in ("float32", "bfloat16"):
        errs[dtype_name] = compare_blocks(sd, device, dtype_name, card)
    print(f"compare: done in {time.perf_counter() - t0:.1f} s  [{card}]",
          flush=True)

    lap(3)

    # phase 4: serve end to end
    launches, fps = serve_phase(sd, device, card)

    lap(4)

    # phase 5: timing
    kernels, cls_times = timing_phase(sd, device, card, launches,
                                      errs["bfloat16"])
    print(f"engine: {fps:.1f} frames/s end to end  [{card}]", flush=True)

    lap(5)

    # phase 6: train kernels against plain, every site of one step
    t0 = time.perf_counter()
    train_errs = {}
    for dtype_name in ("float32", "bfloat16"):
        train_errs[dtype_name] = compare_train_kernels(sd, device,
                                                       dtype_name, card)
    print(f"compare: train kernels done in {time.perf_counter() - t0:.1f} s"
          f"  [{card}]", flush=True)

    lap(6)

    # phase 7: whole-model gradients against plain autograd
    check_model_grads(sd, device, card)

    lap(7)

    # phase 8: train end to end (the training main path)
    work = tempfile.TemporaryDirectory()
    train_launches, _, sim_weights = train_phase(card, work.name)

    lap(8)

    # phase 9: train timing
    kernels += train_timing(sd, device, card, train_launches,
                            train_errs["bfloat16"])

    lap(9)

    # phase 10: K6 against plain at full width, the committed student
    t0 = time.perf_counter()
    lite_trainer, qn = lite_quantized(device)
    k6_err = compare_int8_body(qn, device, card)
    print(f"compare: K6 done in {time.perf_counter() - t0:.1f} s  [{card}]",
          flush=True)

    lap(10)

    # phase 11: serve LaneNetLite: float, int8, int8 through K6
    k6_launches, lite_fps = lite_serve_phase(card)

    lap(11)

    # phase 12: label extraction through K5
    k5_launches, big_pairs = labelgen_phase(device, card)

    lap(12)

    # phase 13: LaneNetLite and label timing
    kernels += lite_timing(lite_trainer, qn, big_pairs, device, card,
                           k6_launches, k6_err, k5_launches, cls_times)
    print("engine lite: " + ", ".join(f"{k} {v:.1f} frames/s"
                                      for k, v in lite_fps.items())
          + f" end to end  [{card}]", flush=True)

    lap(13)

    # phase 14: one MME step, kernels against plain at every site
    t0 = time.perf_counter()
    for dtype_name in ("float32", "bfloat16"):
        compare_mme_step(sd, device, dtype_name, card)
    print(f"compare: MME step done in {time.perf_counter() - t0:.1f} s  "
          f"[{card}]", flush=True)

    lap(14)

    # phase 15: the st and mme CLIs, then cli.test, end to end
    t0 = time.perf_counter()
    mme_launches, mme_steps = two_domain_phase(card, sim_weights)
    print(f"two-domain: done in {time.perf_counter() - t0:.1f} s; K1-K3b "
          f"launches per MME step "
          f"{json.dumps({k: v // mme_steps for k, v in mme_launches.items()})}"
          f"  [{card}]", flush=True)

    lap(15)

    # phase 16: MME step and augmentation timing
    t0 = time.perf_counter()
    mme_timing(sd, device, card)
    print(f"timing: phase 16 done in {time.perf_counter() - t0:.1f} s  "
          f"[{card}]", flush=True)

    lap(16)

    # phase 17: --device_cache, the graphed multi-step dispatch
    t0 = time.perf_counter()
    cache_equivalence(card, sim_weights)
    cache_timing(sd, device, card)
    print(f"cache: phase 17 done in {time.perf_counter() - t0:.1f} s  "
          f"[{card}]", flush=True)

    lap(17)

    # phase 18: the HM and CycleGAN regimes and the domain study
    t0 = time.perf_counter()
    regimes_study_phase(device, card)
    print(f"regimes: phase 18 done in {time.perf_counter() - t0:.1f} s  "
          f"[{card}]", flush=True)
    lap(18)

    # phase 19: the serving student's life
    lifecycle_phase(sd, device, card)
    lap(19)

    # phase 20: the trainer's surface
    surface_phase(sd, device, card)
    lap(20)

    # phase 21: data generation, datagen -> postprocess (K5) ->
    # preprocess_db -> train, and the study's render
    dg = datagen_phase(device, card)
    for k in kernels:
        if k["name"] == "k5_labelgen":
            k["launches_datagen"] = dg["k5_launches"]
        for wrapper, (name, _) in TRAIN_KERNELS.items():
            if k["name"] == name:
                k["launches_datagen"] = dg["train_launches"][wrapper]
    lap(21)

    # phase 22: the interactive simulator, learning/ and the video CLIs
    # (make_demo_video --fused through K4, from phase 8's weights)
    sim = sim_learning_video_phase(device, card, sim_weights)
    work.cleanup()
    for k in kernels:
        for name, n in sim["demo"]["launches"].items():
            if k["name"] == f"k4_{name}":
                k["launches_demo_video"] = n
    lap(22)

    # phase 23: the kernel diagnostics (serve_breakdown, train_breakdown,
    # train_benchmark) and the real-domain path (create_real_db ->
    # preprocess_db -> an MME step; get_real_data, plot_lr)
    diagnostics_phase(sd, device, card, kernels)
    lap(23)

    # phase 24: the JAX package's FFV1 recordings through the port's codec
    # (its fixture decoded and labelled through K5), and the codec's round
    # trip and times at 480x640
    ffv1 = ffv1_phase(device, card)
    for k in kernels:
        if k["name"] == "k5_labelgen":
            k["launches_ffv1_fixture"] = ffv1["k5_launches"]
    lap(24)

    # phase 25: FCDenseNet57, growth 12, on the tensor cores
    kernels += growth12_phase(device, card)
    lap(25)
    print(f"phases: seconds {json.dumps(seconds)}, "
          f"{sum(seconds.values()):.1f} in all  [{card}]", flush=True)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
