"""Batched data augmentation on the caller's device (``streamz-rs/src/lib.rs:103-116``).

The port of ``streamz_tpu/dsp/augment.py``.  Per clip: a gain in
[0.95, 1.05), additive noise with a per-clip amplitude in [0, 0.005)·32767
and per-sample values in (-amp, amp), and a circular left shift in
[0, min(len, 800)).  The output is clamped to the i16 range and truncated
toward zero, the reference's ``as i16`` cast.

The draws come from the threefry twin (:mod:`streamz_tpu_torch.nn.prng`)
with the JAX function's four-way key split, and every step is one torch
op rounded on its own, so the result equals the JAX function's bit for
bit, on the CPU and on the card.
"""

from __future__ import annotations

import torch

from streamz_tpu_torch import config
from streamz_tpu_torch.nn import prng


def augment(key: torch.Tensor, samples, n_samples=None) -> torch.Tensor:
    """Augment PCM. samples: [T] or [B, T] i16/f32 raw-scale values, a
    tensor (computed on its device) or an array (on the CPU).

    ``n_samples`` optionally gives the valid length per clip (defaults to
    the full padded width); the circular shift wraps within the valid
    region and samples past it are returned unchanged.  Returns float32 at
    the raw i16 scale (truncated to integer values).
    """
    x = torch.as_tensor(samples)
    squeeze = x.dim() == 1
    x = torch.atleast_2d(x.to(torch.float32))
    B, T = x.shape
    dev = x.device
    key = key.to(dev)
    if n_samples is None:
        n = torch.full((B,), T, dtype=torch.int64, device=dev)
    else:
        n = torch.as_tensor(n_samples, dtype=torch.int64, device=dev).reshape(-1)
        n = n.expand(B)

    k_noise_amp, k_gain, k_shift, k_noise = prng.split(key, 4)
    noise_amp = prng.uniform(k_noise_amp, (B, 1), 0.0, 0.005)
    gain = prng.uniform(k_gain, (B, 1), 0.95, 1.05)
    shift_max = torch.clamp(torch.clamp(n, max=config.WINDOW_SIZE), min=1)
    shift = (prng.uniform(k_shift, (B,)) * shift_max.to(torch.float32)).to(torch.int64)

    idx = torch.arange(T, device=dev)[None, :]
    n_col = n[:, None]
    src = torch.where(n_col > 0, (idx + shift[:, None]) % torch.clamp(n_col, min=1), idx)
    shifted = torch.take_along_dim(x, src, dim=1)

    noise = prng.uniform(k_noise, (B, T), -1.0, 1.0) * noise_amp
    val = shifted * gain + noise * 32767.0
    val = torch.trunc(torch.clamp(val, -32768.0, 32767.0))
    val = torch.where(idx < n_col, val, x)
    return val[0] if squeeze else val
