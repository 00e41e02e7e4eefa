"""nmma_tpu_torch — the PyTorch/CUDA port of nmma_tpu.

Batch-first PyTorch counterparts of the ``nmma_tpu`` modules on the EM
parameter-estimation path, with the Pallas TPU kernels replaced by kernels
written by hand for Hopper (``csrc/``). The JAX package is the reference the
port's tests hold it against; nothing here imports it or JAX.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit device they raise.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Full IEEE f32 everywhere: the reference contracts at HIGHEST precision
# because lower-precision multiplies cost ~0.05 mag (nmma_tpu
# likelihood/em.py:186-196), and TF32 keeps only ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DTYPE = torch.float32


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card, and
    raises when there is none (no silent CPU fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nmma_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
