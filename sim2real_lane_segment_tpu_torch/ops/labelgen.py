"""Label extraction from (original, annotated) frame pairs, on the device.

Counterpart of ``sim2real_lane_segment_tpu.ops.labelgen``, the reference
binarization (rightLaneDatagen/postprocess_v2.py:29-53):

1. the int16 difference ``annot - orig``;
2. channel-sign rules on the B, G, R channels: left lane b > 0, right
   lane g > 0, obstacle r > 0 or (r >= 0 and (b < 0 or g < 0));
3. per class, a morphological OPEN then CLOSE with a 5x5 rect kernel;
4. priority overwrite into one uint8 mask: right = 1, then left = 2,
   then obstacle = 3.

On CUDA tensors this is kernel K5 (``kernels.labelgen``), one launch per
batch; on CPU tensors its plain version, the morphology of
``ops.morphology``.  Both are bit-exact against the JAX function.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import labelgen as _k


def process_classes(img_orig, img_annot, channel_order: str = "bgr"
                    ) -> torch.Tensor:
    """Extract the 4-class label mask from (orig, annot) frame pairs.

    Args:
      img_orig, img_annot: uint8 tensors (or numpy arrays, which run on
        the CPU) of shape (..., H, W, 3).
      channel_order: 'bgr' (cv2-read frames, reference semantics) or 'rgb'
        (frames straight from the simulator renderer).

    Returns:
      uint8 mask (..., H, W) with {0: bg, 1: right, 2: left, 3: obstacle},
      on the frames' device.
    """
    if isinstance(img_orig, np.ndarray):
        img_orig = torch.from_numpy(np.ascontiguousarray(img_orig))
    if isinstance(img_annot, np.ndarray):
        img_annot = torch.from_numpy(np.ascontiguousarray(img_annot))
    return _k.process_classes(img_orig, img_annot, channel_order)


# The JAX package jits ``process_classes`` over a batch; PyTorch runs
# eagerly and the kernel already takes the whole batch in one launch.
process_classes_batch = process_classes
