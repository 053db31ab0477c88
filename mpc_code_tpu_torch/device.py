"""Device selection for the port's entry points.

Entry points take an explicit ``device``.  The default is the card: with no
CUDA device they raise, and nothing continues on the CPU unless the caller
asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def pin_fp32_precision() -> None:
    """Full-precision f32 matmuls, TF32 off for cuBLAS and cuDNN.

    Interior-point linear algebra needs true f32 accumulation to converge
    below ~1e-2 scaled KKT error.  It changes process-wide settings, so the
    library never calls it: the entry script does (``chip_smoke.py``), as
    the JAX bench pins ``jax_default_matmul_precision='highest'``
    (``bench.py:40-42``)."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
