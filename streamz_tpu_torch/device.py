"""Device resolution shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.  When CUDA
is missing and the CPU was not asked for, they raise instead of carrying on
quietly on the CPU.
"""

from __future__ import annotations

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
