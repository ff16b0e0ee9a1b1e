"""PyTorch/CUDA port of ``sim2real_lane_segment_tpu`` for NVIDIA Hopper.

The port covers two FCDenseNet paths:

- serving: ``cli.serve`` -> ``train.supervised.SupervisedTrainer.
  predict_step_fused`` -> ``models.tiramisu_fused.fused_apply``, whose
  dense blocks run through the hand-written CUDA kernels in
  ``csrc/dense_block.cu``;
- supervised training: ``cli.train`` -> ``train.loop.fit`` ->
  ``SupervisedTrainer.train_step``, which with ``--pallas_train`` runs
  ``models.tiramisu_train_fused.fused_apply_train`` on the kernels in
  ``csrc/train_block.cu``.

Around them: LaneNetLite serving (``csrc/int8_body.cu``), label
extraction (``csrc/labelgen.cu``), the ``st`` and MME regimes, and the HM
and CycleGAN regimes with the domain study (``cli.hist_match``,
``cli.train_cyclegan``, ``cli.sim2real_convert``, ``cli.domain_study``),
which run on tensor ops and cuDNN and train through the same kernels.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
