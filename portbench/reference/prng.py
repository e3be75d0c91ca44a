"""A torch twin of ``jax.random``'s threefry2x32 keys, bit for bit.

Frozen copy of ``streamz_tpu_torch/nn/prng.py`` at commit 9a1a12a3fe3c, for the
benchmark's plain reference: it imports nothing of the port, and a later
change to the port does not change it.

The discovery loop's shuffles and dropout masks come from ``jax.random`` in
the JAX package (``streamz_tpu/nn/train.py:file_epoch_views``), which pins
the *partitionable* threefry layout (``streamz_tpu/config.py:18-24``).  This
module reproduces that generator on any torch device, so both packages
train on the same bits and their labels can be compared exactly:

- a key is an int64 tensor ``[..., 2]`` holding two uint32 words;
- ``split(key, n)[i]`` and ``fold_in(key, i)`` hash the counter (0, i);
- ``uniform(key, shape)`` hashes the flat C-order index of each element,
  split into (hi, lo) 32-bit words, takes ``out0 ^ out1`` as its 32 random
  bits and maps them to ``[0, 1)`` as ``bitcast((bits >> 9) | 0x3F800000) - 1``;
  with ``minval``/``maxval`` it scales that as ``jax.random.uniform`` does,
  ``max(minval, u * (maxval - minval) + minval)`` with the multiply-add
  rounded once to f32, as XLA's fused multiply-add rounds it (the draws of
  ``streamz_tpu/dsp/augment.py``);
- ``permutation`` and ``randint`` are ``jax.random``'s on those bits (the
  draws of ``streamz_tpu/infer/cluster.py``).

uint32 arithmetic runs in int64 with a 32-bit mask.  Every function takes a
batch of keys (leading dimensions) and broadcasts over it.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds (Salmon et al. 2011), on
    broadcastable int64 tensors of uint32 words.  Returns (out0, out1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32: words (0, seed)."""
    if not 0 <= int(seed) <= _MASK:
        raise ValueError(f"seed {seed} is outside [0, 2**32)")
    return torch.tensor([0, int(seed)], dtype=torch.int64, device=device)


def _hash(key: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Keys [..., 2] hashed with counters (0, counter) → keys [..., *c, 2]."""
    lead = key.shape[:-1]
    shape = (*lead, *([1] * (counter.dim())))
    k0, k1 = key[..., 0].reshape(shape), key[..., 1].reshape(shape)
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(k0, k1, zero, counter)
    o0, o1 = torch.broadcast_tensors(o0, o1)
    return torch.stack((o0, o1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys [..., 2] → [..., num, 2]."""
    return _hash(key, torch.arange(num, dtype=torch.int64, device=key.device))


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` may be a tensor of values, giving
    one key per value: [..., 2] → [..., *data.shape, 2]."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    return _hash(key, d)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2**32)): [..., 2] → [..., *shape]."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    view = (*lead, *([1] * len(shape)))
    k0, k1 = key[..., 0].reshape(view), key[..., 1].reshape(view)
    o0, o1 = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return o0 ^ o1


def uniform(key: torch.Tensor, shape: Sequence[int], minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=minval, maxval=maxval)`` in
    float32, bit for bit.  ``minval`` and ``maxval`` are numbers or tensors
    that broadcast against ``shape``; the defaults give [0, 1).

    XLA fuses ``u * (maxval - minval) + minval`` into one multiply-add with
    a single rounding.  Here it runs in float64, where the product of two
    f32 values is exact and so is the sum for bounds within a few binades
    of the span (every range the port draws), then rounds once to f32: the
    same bits on the CPU and on the card, with no fused op needed."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    if isinstance(minval, (int, float)) and isinstance(maxval, (int, float)) and (
            minval == 0.0 and maxval == 1.0):
        return floats
    lo = torch.as_tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=key.device)
    span = (hi - lo).to(torch.float64)
    scaled = (floats.to(torch.float64) * span + lo.to(torch.float64)).to(torch.float32)
    return torch.maximum(lo, scaled)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for one key: a permutation of
    ``arange(n)`` (int64), bit for bit.

    JAX 0.9.0's ``_shuffle`` sorts by fresh 32-bit keys for
    ``ceil(3 ln n / ln(2**32 - 1))`` rounds (none for n = 1, one up to
    n = 1625), splitting the key each round (``key, subkey = split(key)``,
    the sort keys ``random_bits(subkey, (n,))``).  Its ``lax.sort_key_val``
    runs with its default ``is_stable=True``, so two elements that draw the
    same 32-bit key keep their order within the round; the stable sort here
    does the same, and ties give the same permutation too.
    """
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))
    for _ in range(rounds):
        key, subkey = split(key)
        order = torch.argsort(random_bits(subkey, (n,)), stable=True)
        x = x[order]
    return x


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32, bit for
    bit: two words per element from the halves of ``split(key)``, reduced
    modulo the span as ``(hi % span) * m + lo % span`` with
    ``m = (2**16 % span)**2 % span``, every step in wrapping uint32
    arithmetic as ``_randint`` computes it.  A span of 0 or less gives
    ``minval``."""
    lo32, hi32 = -(2 ** 31), 2 ** 31 - 1
    minval = min(max(int(minval), lo32), hi32)
    maxval = min(max(int(maxval), lo32), hi32)
    span = 1 if maxval <= minval else (maxval - minval) & _MASK
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    mult = (((2 ** 16 % span) ** 2) & _MASK) % span
    offset = (((higher % span) * mult) & _MASK) + lower % span
    offset = (offset & _MASK) % span
    out = (minval + offset + 2 ** 31) % 2 ** 32 - 2 ** 31  # int32 wrap
    return out.to(torch.int32)
