"""PyTorch/CUDA port of ``sim2real_lane_segment_tpu`` for NVIDIA Hopper.

The port covers the FCDenseNet serving path: ``cli.serve`` ->
``train.supervised.SupervisedTrainer.predict_step_fused`` ->
``models.tiramisu_fused.fused_apply``, whose dense blocks run through the
hand-written CUDA kernels in ``csrc/dense_block.cu``.  Entry points run on
the GPU unless the caller passes ``device="cpu"``.
"""
