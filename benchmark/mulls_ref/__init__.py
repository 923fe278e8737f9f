"""The benchmark's plain reference of the LiDAR odometry step: a frozen
copy of the step of the program under test, its neighbourhood operations in
plain PyTorch, imported by nothing of the program and importing nothing of
it.  Every package path mirrors the program's, so a module's counterpart is
found by path."""

import torch as _torch

# distances, covariances and normal equations in full float32
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
