"""mulls_tpu_torch — the PyTorch and CUDA port of mulls_tpu for one NVIDIA
H100.

The JAX package ``mulls_tpu`` is the reference and stays beside this one;
this package imports neither JAX nor anything of ``mulls_tpu``.  Its layout
mirrors the reference module for module (``core/``, ``ops/``,
``frontend/``, ``mapping/``, ``pipeline/``, ``io/``, ``eval/``, ``apps/``,
and ``tools/`` for the repository's ``tools/``), so each module's
counterpart is found by path.  The three Pallas TPU kernels of
``mulls_tpu/ops/kernels.py`` and the two of ``tools/perf_mfu_roofline.py``
are hand-written CUDA here (``csrc/``, bound in
:mod:`mulls_tpu_torch.ops.kernels`; the probe's two wrapped in
:mod:`mulls_tpu_torch.tools.roofline`).

Entry points run on ``device="cuda"`` unless the caller asks for the CPU,
where every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry everywhere: distances, covariances and normal equations need full
# f32.  TF32's 10-bit mantissa fails the same coordinate-accuracy bar as bf16
# (the reference sets jax_default_matmul_precision=float32 for this reason).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from mulls_tpu_torch.config import MullsConfig, ShapeConfig, load_flagfile  # noqa: E402

__all__ = ["MullsConfig", "ShapeConfig", "load_flagfile", "__version__"]
