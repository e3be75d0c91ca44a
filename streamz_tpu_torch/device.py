"""Device resolution shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.  When CUDA
is missing and the CPU was not asked for, they raise instead of carrying on
quietly on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a usable card raises;
    on CUDA, TF32 is switched off for matmuls and cuDNN."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' "
                "(--device cpu on the CLI) to run on the CPU"
            )
        # The reference computes the frontend at f32-equivalent precision
        # (streamz_tpu/dsp/mfcc.py:32-35) and the MLP in f32; TF32 keeps
        # only ~3 decimal digits, too few for the 1e-3 feature gate.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def staged(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` as a tensor to copy to ``dev``: pinned for a CUDA device, so a
    ``non_blocking`` copy does not block the host (the caching host
    allocator keeps the buffer until the copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if dev.type == "cuda" else t


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without waiting for the device's queue."""
    return staged(a, dev).to(dev, non_blocking=True)
