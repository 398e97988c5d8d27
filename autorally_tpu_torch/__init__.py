"""autorally_tpu_torch — the PyTorch/CUDA port of ``autorally_tpu``.

A second package beside the JAX one, for NVIDIA Hopper GPUs: the same MPPI
solver, models, costs and public names, with the TPU's Pallas kernels
replaced by hand-written CUDA kernels (``csrc/``) and plain PyTorch
versions of them for the CPU.  It imports neither ``jax`` nor
``autorally_tpu``.  Entry points run on ``cuda`` unless given
``device="cpu"``.

Math is fp32 throughout, with TF32 switched off for matmuls and cuDNN, as
the JAX package's default ``matmul_precision="highest"`` requires (and
``"high"``, which its kernels round up to it), but where
``matmul_precision="default"`` asks for the MXU's one bf16 pass in the
rollouts' dynamics: those products take bf16 operands and float32 sums
(``ops/rollout_kernel.py``).
"""

import torch

from autorally_tpu_torch.config import (CostParams, MPPIConfig,
                                        load_launch_params, resolve_device)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["CostParams", "MPPIConfig", "load_launch_params",
           "resolve_device", "__version__"]
