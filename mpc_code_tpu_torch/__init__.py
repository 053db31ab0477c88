"""mpc_code_tpu_torch — the PyTorch/CUDA port of ``mpc_code_tpu``.

Module paths and public names mirror the JAX package so that each
counterpart is easy to find.  The hot path runs on an NVIDIA Hopper card:
the RK4 stage-Jacobian sweep (``ops/sweep_cuda.py``) and the Riccati KKT
solve (``solver/riccati_kernel.py``) are hand-written CUDA kernels, and
everything else is PyTorch on whole batched tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from mpc_code_tpu_torch import config
from mpc_code_tpu_torch import ops
from mpc_code_tpu_torch import models
from mpc_code_tpu_torch import solver

__all__ = ["config", "ops", "models", "solver", "__version__"]
