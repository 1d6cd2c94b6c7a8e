"""A frozen copy of the port's pipeline as the CPU runs it, kept as the
benchmark's plain reference: plain PyTorch on any device, both kernels
replaced by their plain twins (`ops/segmentation.label_prop_plain`,
`ops/knn.top5_l2_plain`), the frame steps eager with host branching. It
imports nothing of the port, so a later change to the port cannot move it.

Geometry runs in float32 with TF32 off, as the port states; the control of
`loambench/tests/test_loambench_control.py` turns TF32 on around it.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
