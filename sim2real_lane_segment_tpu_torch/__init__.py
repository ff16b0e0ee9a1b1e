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

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
