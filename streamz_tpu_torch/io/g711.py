"""G.711 mu-law / A-law companding: the telephony serving wire.

The port of ``streamz_tpu/io/g711.py``, a copy: the tables, ``decode`` and
``encode`` are the JAX package's bit for bit (``tests/test_torch_serve.py``
holds them to it).  The multi-stream serving layer
(:mod:`streamz_tpu_torch.app.serve`) ships companded bytes to the device, 8
bits a sample instead of 16 (i16) or 32 (f32), and expands them there.

- ``ULAW_TABLE`` / ``ALAW_TABLE`` map a companded byte to its exact linear
  PCM value as float32 (small integers, exactly representable).  The device
  wire gathers from a device copy of the table and then runs the same
  ``linear / 32767.0`` conversion as the i16 wire, so a mu-law byte gives
  bit-identical features to host-decoding it to i16 and feeding the i16.
- Encode follows the ITU-T G.711 segment layout (bias 0x84, clip 0x7F7B
  for mu-law; the 13-bit A-law segments with even-bit inversion 0x55).
  Round-tripping any i16 through encode->decode lands within the segment's
  quantization step (<= 1024 for mu-law's top segment, <= 256 for A-law's).

Companding is lossy by construction (8-bit log quantization, ~38 dB SNR on
speech): the serving guarantee is exact parity with the *decoded* PCM.
"""

from __future__ import annotations

import numpy as np

_ULAW_BIAS = 0x84  # 132
_ULAW_CLIP = 32635  # 0x7F7B


def _ulaw_decode_one(code: int) -> int:
    """ITU-T G.711 mu-law expand: one companded byte -> linear PCM."""
    u = ~code & 0xFF
    sign = u & 0x80
    exp = (u >> 4) & 0x07
    man = u & 0x0F
    mag = (((man << 3) + _ULAW_BIAS) << exp) - _ULAW_BIAS
    return -mag if sign else mag


def _alaw_decode_one(code: int) -> int:
    """ITU-T G.711 A-law expand: one companded byte -> linear PCM.

    Sign convention per the standard: bit 7 SET (after the 0x55 even-bit
    inversion) means positive.
    """
    a = code ^ 0x55  # even-bit inversion
    sign = a & 0x80
    exp = (a >> 4) & 0x07
    man = a & 0x0F
    if exp == 0:
        mag = (man << 4) + 8
    else:
        mag = ((man << 4) + 0x108) << (exp - 1)
    return mag if sign else -mag


# Decode tables: exact linear PCM values, stored as f32 (small integers are
# exact).  int16 twins for the host-side decode used when a mixed fleet
# downgrades a u8 slot onto the i16 wire.
ULAW_TABLE_I16 = np.array([_ulaw_decode_one(c) for c in range(256)], np.int16)
ALAW_TABLE_I16 = np.array([_alaw_decode_one(c) for c in range(256)], np.int16)
ULAW_TABLE = ULAW_TABLE_I16.astype(np.float32)
ALAW_TABLE = ALAW_TABLE_I16.astype(np.float32)

#: encoding tag -> (f32 table, i16 table); the serving layer keys its u8
#: wire on these tags.
TABLES = {
    "ulaw": (ULAW_TABLE, ULAW_TABLE_I16),
    "alaw": (ALAW_TABLE, ALAW_TABLE_I16),
}


def ulaw_decode(codes: np.ndarray) -> np.ndarray:
    """Companded mu-law bytes -> exact linear int16 PCM."""
    return ULAW_TABLE_I16[np.asarray(codes, np.uint8)]


def alaw_decode(codes: np.ndarray) -> np.ndarray:
    """Companded A-law bytes -> exact linear int16 PCM."""
    return ALAW_TABLE_I16[np.asarray(codes, np.uint8)]


def ulaw_encode(pcm: np.ndarray) -> np.ndarray:
    """Linear int16 PCM -> G.711 mu-law bytes (ITU segment layout)."""
    x = np.asarray(pcm, np.int32)
    sign = np.where(x < 0, 0x80, 0x00)
    mag = np.minimum(np.abs(x), _ULAW_CLIP) + _ULAW_BIAS
    # Segment = position of the highest set bit above bit 7.
    exp = (np.floor(np.log2(mag)) - 7).astype(np.int32)
    exp = np.clip(exp, 0, 7)
    man = (mag >> (exp + 3)) & 0x0F
    return (~(sign | (exp << 4) | man) & 0xFF).astype(np.uint8)


def alaw_encode(pcm: np.ndarray) -> np.ndarray:
    """Linear int16 PCM -> G.711 A-law bytes (ITU segment layout).

    Matches the reference C implementation (Sun/ffmpeg g711.c): the value
    drops to the 13-bit domain first, negatives compand their one's
    complement, and the mantissa shift is by 1 in segments 0-1 and by the
    segment number above.
    """
    x13 = np.asarray(pcm, np.int32) >> 3  # 16 -> 13-bit domain
    pos = x13 >= 0
    sign = np.where(pos, 0x80, 0x00)
    mag = np.where(pos, x13, -x13 - 1)
    exp = np.zeros_like(mag)
    nz = mag >= 0x20
    exp[nz] = (np.floor(np.log2(mag[nz])) - 4).astype(np.int32)
    exp = np.clip(exp, 0, 7)
    man = np.where(exp < 2, (mag >> 1) & 0x0F, (mag >> exp) & 0x0F)
    return ((sign | (exp << 4) | man) ^ 0x55).astype(np.uint8)


def decode(codes: np.ndarray, encoding: str) -> np.ndarray:
    """Dispatch by encoding tag ('ulaw' | 'alaw') -> linear int16 PCM."""
    if encoding not in TABLES:
        raise ValueError(f"unknown G.711 encoding {encoding!r}")
    return TABLES[encoding][1][np.asarray(codes, np.uint8)]
