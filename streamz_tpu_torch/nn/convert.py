"""Parameters between numpy arrays and the port's tensors.

``params_from_numpy`` takes a parameter mapping as numpy arrays — for
example the JAX package's params as ``{k: np.asarray(v)}`` — and returns
the port's f32 tensors on a device; ``params_to_numpy`` is its inverse.
With them both packages compute with the same weights.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from streamz_tpu_torch.device import resolve_device
from streamz_tpu_torch.nn.model import PARAM_NAMES


def params_from_numpy(
    d: Mapping[str, np.ndarray], device=None
) -> Dict[str, torch.Tensor]:
    """``{w1, b1, w2, b2, w3, b3}`` numpy arrays → f32 tensors on ``device``
    (``cuda`` unless ``'cpu'`` is asked for).  Raises on a missing key or a
    shape that does not chain."""
    missing = [k for k in PARAM_NAMES if k not in d]
    if missing:
        raise KeyError(f"missing parameters: {missing}")
    arrs = {k: np.asarray(d[k], np.float32) for k in PARAM_NAMES}
    w1, b1, w2, b2, w3, b3 = (arrs[k] for k in PARAM_NAMES)
    if not (
        w1.ndim == w2.ndim == w3.ndim == 2 and b1.ndim == b2.ndim == b3.ndim == 1
        and w1.shape[1] == b1.shape[0] == w2.shape[0]
        and w2.shape[1] == b2.shape[0] == w3.shape[0]
        and w3.shape[1] == b3.shape[0]
    ):
        raise ValueError(
            "inconsistent parameter shapes: "
            + ", ".join(f"{k}{arrs[k].shape}" for k in PARAM_NAMES)
        )
    dev = resolve_device(device)
    # torch.tensor copies: the result never aliases the caller's arrays.
    return {k: torch.tensor(v, device=dev) for k, v in arrs.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's parameters → f32 numpy arrays."""
    return {k: params[k].detach().cpu().numpy().astype(np.float32) for k in PARAM_NAMES}
