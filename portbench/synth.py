"""Seeded synthetic voices, made on the card.

Frozen from ``chip_smoke.py``'s ``synth_speakers`` and ``synth_clips`` at
commit 9a1a12a3fe3c.  Changed: the sample rate and each clip's length are
arguments (the copy made 10 s clips at 44.1 kHz only), and clips are made
in blocks so that thousands fit.  At 44.1 kHz and 10 s the draws are the
copy's, in the same order.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def synth_speakers(rng: np.random.Generator, n: int):
    """Per speaker: a fundamental and a harmonic envelope."""
    f0 = rng.uniform(90.0, 260.0, n)
    env = rng.uniform(0.05, 1.0, (n, 24)) * (0.85 ** np.arange(24))[None, :]
    return f0, env


def synth_clips(f0, env, speakers, gen: torch.Generator, dev, rate: int,
                lengths: Sequence[int], block: int = 64) -> list:
    """int16 voices, clip i of ``lengths[i]`` samples by speaker
    ``speakers[i]``: harmonics of the speaker's f0 under its envelope, with
    vibrato, syllable-rate amplitude modulation and noise.  Phases, jitter
    and noise come from ``gen``; each block of clips is made at its longest
    length and cut."""
    speakers = np.asarray(speakers)
    out = []
    for lo in range(0, len(speakers), block):
        spk = speakers[lo:lo + block]
        lens = [int(v) for v in lengths[lo:lo + block]]
        pcm = _block(f0, env, spk, gen, dev, rate, max(lens))
        out.extend(pcm[i, :n] for i, n in enumerate(lens))
    return out


def _block(f0, env, speakers, gen, dev, rate: int, samples: int) -> np.ndarray:
    n = len(speakers)
    t = torch.arange(samples, device=dev, dtype=torch.float64) / rate
    f0s = torch.tensor(f0[speakers], device=dev) * (
        1 + 0.03 * torch.rand(n, device=dev, generator=gen, dtype=torch.float64))
    envs = torch.tensor(env[speakers], device=dev)  # [n, H]
    H = envs.shape[1]
    vib = 0.01 * torch.sin(2 * math.pi * 5.0 * t)[None, :]
    phase0 = 2 * math.pi * torch.rand(n, H, device=dev, generator=gen, dtype=torch.float64)
    out = torch.zeros(n, t.numel(), device=dev, dtype=torch.float64)
    base_phase = 2 * math.pi * (t[None, :] + vib.cumsum(1) / rate) * f0s[:, None]
    for h in range(H):
        out += envs[:, h:h + 1] * torch.sin((h + 1) * base_phase + phase0[:, h:h + 1])
    syll = 0.6 + 0.4 * torch.sin(
        2 * math.pi * 3.0 * t[None, :]
        + 2 * math.pi * torch.rand(n, 1, device=dev, generator=gen, dtype=torch.float64))
    out = out * syll + 0.02 * torch.randn(out.shape, device=dev, generator=gen,
                                         dtype=torch.float64)
    out = out / out.abs().amax(dim=1, keepdim=True) * 14000.0
    return out.round().clamp(-32768, 32767).to(torch.int16).cpu().numpy()
