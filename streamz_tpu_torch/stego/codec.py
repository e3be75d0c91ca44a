"""Steganography subsystem: hide a file's bits in network weights.

The port of ``streamz_tpu/stego/codec.py``, with capability parity with
the reference (``streamz-rs/src/lib.rs:1717-1825``, ``src/main.rs:185-198``,
``:671-701``):

- trigger: an ingested MP3 whose SHA-512 equals the active checksum constant
  arms the subsystem (host-side, :mod:`streamz_tpu_torch.io.audio`);
- ``encode_file``: train a 512-in/512/256/(8·len)-out net with sigmoid+MSE
  steps at lr 0.5 for up to 10M epochs until every output bit rounds to its
  target, with the checksum's 512 bits as the only input, on the card in
  blocks of steps with the bit-exact early-exit predicate;
- the trained output layer is stashed on the classifier as ``w4``/``b4``
  (npz ``w4_{i}``/``b4_{i}`` columns);
- ``extract_file`` / ``extract_file_from_classifier``: present the checksum
  bits, threshold sigmoid outputs at 0.5, repack bytes MSB-first, on the
  host in numpy.

**Conscious fix (documented deviation, as in the JAX package):** the
reference's decoder rebuilds the hidden layers with *fresh random weights*
(``SimpleNeuralNet::new`` inside ``extract_file_from_classifier``,
``src/lib.rs:1807-1825``) while the encoder's trained hidden layers are
discarded (``src/main.rs:690-695``), so recovery of the hidden bytes is
impossible in the reference.  Here the encode net's hidden layers are
*derived deterministically from the checksum* (seeded init) and frozen
during encoding, so the decoder can reconstruct them from the same checksum
and ``--decode`` genuinely recovers the file, bit-exactly, from only the
stored ``w4``/``b4`` columns.  The payload is XOR-whitened with a
checksum-keyed keystream, so a wrong checksum decodes to noise.  Schema and
CLI surface are unchanged.  The host draws (h2, the keystream, the scaled
init) are numpy's PCG64, the JAX package's, so either package decodes the
other's encoding.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from streamz_tpu_torch import config
from streamz_tpu_torch.device import resolve_device
from streamz_tpu_torch.nn.model import SpeakerNet, round_capacity

_HEX_DIGITS = set("0123456789abcdefABCDEF")

# The predicate's margin: the reference exits as soon as every bit *rounds*
# right (src/lib.rs:1756-1763); the margin on top keeps the decision stable
# between the training device's f32 sums and the host decoder's.
_MARGIN = 0.02
# The largest block of steps between two reads of the done flag.
_MAX_BLOCK = 256


def hex_to_bytes(s: str) -> bytes:
    """Lenient hex parse (src/lib.rs:60-65): invalid byte pairs are skipped.

    Pair validity is checked per character, NOT via ``int(pair, 16)``:
    Python's int() strips whitespace (``int(' f', 16) == 15``) where the
    reference's ``u8::from_str_radix`` rejects it; a whitespace-bearing
    override string must skip the same pairs the Rust binary skips, or the
    derived 512-bit stego key diverges.
    """
    out = bytearray()
    for i in range(0, len(s) - 1, 2):
        pair = s[i : i + 2]
        if pair[0] in _HEX_DIGITS and pair[1] in _HEX_DIGITS:
            out.append(int(pair, 16))
    return bytes(out)


def bytes_to_bits(data: bytes) -> np.ndarray:
    """MSB-first bit expansion (src/lib.rs:1726-1731)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    return np.unpackbits(arr).astype(np.float32)


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """MSB-first bit packing (src/lib.rs:1791-1801)."""
    bits = np.asarray(bits).astype(np.uint8)
    pad = (-len(bits)) % 8
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits).tobytes()


def checksum_input_bits() -> np.ndarray:
    """The 512 input bits derived from the active checksum constant."""
    return bytes_to_bits(hex_to_bytes(config.get_checksum_constant()))


def _seed_from_checksum() -> int:
    digest = hashlib.sha256(config.get_checksum_constant().encode()).digest()
    return int.from_bytes(digest[:4], "little")


def _keystream(n_bits: int) -> np.ndarray:
    """Checksum-derived whitening keystream (uint8 0/1 of length n_bits).

    The sigmoid trainer's updates are rank-1 in the hidden activation, so the
    raw stored bit pattern would survive decoding under *any* positively
    correlated key.  XOR-whitening the payload with a checksum-keyed stream
    makes a wrong checksum decode to uniform noise while the npz schema and
    training loop stay unchanged.
    """
    rng = np.random.default_rng(_seed_from_checksum() ^ 0xC0DEC0DE)
    return rng.integers(0, 2, size=n_bits, dtype=np.uint8)


def _hidden_activation(input_bits: np.ndarray, hidden1: int = 512, hidden2: int = 256) -> np.ndarray:
    """Deterministic checksum-keyed hidden feature vector h2 (see module doc)."""
    rng = np.random.default_rng(_seed_from_checksum())
    n_in = len(input_bits)
    w1 = rng.uniform(-0.5, 0.5, size=(n_in, hidden1)).astype(np.float32)
    w2 = rng.uniform(-0.5, 0.5, size=(hidden1, hidden2)).astype(np.float32)
    h1 = np.maximum(input_bits @ w1, 0.0)
    h2 = np.tanh(h1 @ w2)
    return h2.astype(np.float32)


def _outputs(w3: torch.Tensor, b3: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(h2 @ w3 + b3)


def _bits_match(out: torch.Tensor, target: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Whether every real bit clears the margin on its target's side (a
    0-d bool tensor); columns at or past ``n_bits`` are padding."""
    ok = torch.where(target > 0.5, out > 0.5 + _MARGIN, out < 0.5 - _MARGIN)
    live = torch.arange(out.shape[0], device=out.device) < n_bits
    return torch.all(ok | ~live)


def _train_bits_loop(
    w3: torch.Tensor,      # [h2, n_out_cap], updated in place
    b3: torch.Tensor,      # [n_out_cap], updated in place
    h2: torch.Tensor,      # [h2] fixed hidden activation
    target: torch.Tensor,  # [n_out_cap] (padding targets are 0)
    n_bits: int,
    lr: float,
    *,
    max_epochs: int,
    max_block: int = _MAX_BLOCK,
) -> Tuple[int, bool]:
    """Sigmoid+MSE SGD on the output layer until every real bit rounds
    right (src/lib.rs:1753-1764), or ``max_epochs`` steps; returns (steps,
    done).

    A step is ``delta = (out - t) * out * (1 - out)``, ``w3 -= lr *
    outer(h2, delta)``, ``b3 -= lr * delta``, then the predicate on the new
    outputs, which the next step reuses.  The steps run in blocks on the
    device with no host read inside a block: each step's update and count
    are masked by the on-device done flag, so a block that runs past the
    first step that satisfied the predicate leaves the weights and the
    count as they were at that step.  The host reads the flag and the count
    once per block, and cuts the last block at ``max_epochs``.  Blocks
    double from 1 step up to ``max_block``: the usual encode converges in
    one step and runs no masked step, and a long run reads once per
    ``max_block`` steps while masking fewer steps than it ran."""
    dev = w3.device
    out = _outputs(w3, b3, h2)
    done = _bits_match(out, target, n_bits)
    step = torch.zeros((), dtype=torch.int64, device=dev)
    block = 1
    while True:
        done_h, steps_h = torch.stack((done.to(torch.int64), step)).tolist()
        if done_h or steps_h >= max_epochs:
            return steps_h, bool(done_h)
        for _ in range(min(block, max_epochs - steps_h)):
            active = ~done
            delta = (out - target) * out * (1.0 - out) * active
            upd = torch.outer(h2, delta)
            upd.mul_(lr)
            w3.sub_(upd)
            del upd
            b3.sub_(lr * delta)
            step += active
            out = _outputs(w3, b3, h2)
            done = done | _bits_match(out, target, n_bits)
        block = min(2 * block, max_block)


def encode_file(path: str, *, max_epochs: int = config.STEGO_MAX_EPOCHS,
                device=None) -> SpeakerNet:
    """Encode a file's bits into a fresh network (src/lib.rs:1717-1772),
    trained on ``device`` (``cuda`` unless ``'cpu'`` is asked for).

    The returned net lives on the host: its layers are only read back by
    the host decoder and the ``w4``/``b4`` stash, and at the payload cap
    its output layer alone is 1 GiB."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        data = f.read()
    if len(data) > config.STEGO_MAX_PAYLOAD_BYTES:
        cap_bits = round_capacity(8 * len(data))
        raise ValueError(
            f"stego payload {path!r} is {len(data)} bytes; the encoder "
            f"trains a [256, {cap_bits}] f32 output layer (~8 KB of "
            f"weights and ~16 KB of peak device memory per payload byte), "
            f"so payloads are capped at "
            f"{config.STEGO_MAX_PAYLOAD_BYTES} bytes.  Split the file or "
            f"raise streamz_tpu_torch.config.STEGO_MAX_PAYLOAD_BYTES if your "
            f"device has the memory."
        )
    print(f"Encoding file {path}...")
    target_bits = bytes_to_bits(data)
    input_bits = checksum_input_bits()
    n_bits = len(target_bits)

    h2 = _hidden_activation(input_bits)
    cap = round_capacity(n_bits)
    # Random init scaled so initial pre-activations stay in the sigmoid's
    # responsive region (|z| ~ O(1)).  The reference's U(-0.5, 0.5) init can
    # leave bits saturated on the wrong side where the (out-t)*out*(1-out)
    # delta vanishes and even 10M epochs fail; a *zero* init would converge
    # but collapses every w3 column onto the span of h2, destroying the
    # checksum-key dependence of the stored weights.  Small random init gives
    # both convergence and key-dependence.
    rng = np.random.default_rng(_seed_from_checksum() ^ 0x5EED)
    scale = 1.0 / max(float(np.linalg.norm(h2)), 1.0)
    w3 = rng.uniform(-scale, scale, size=(len(h2), cap)).astype(np.float32)
    target_pad = np.zeros((cap,), np.float32)
    target_pad[:n_bits] = np.bitwise_xor(
        target_bits.astype(np.uint8), _keystream(n_bits)
    ).astype(np.float32)

    w3_t = torch.from_numpy(w3).to(dev)
    del w3
    b3_t = torch.zeros((cap,), dtype=torch.float32, device=dev)
    steps, done = _train_bits_loop(
        w3_t, b3_t, torch.from_numpy(h2).to(dev), torch.from_numpy(target_pad).to(dev),
        n_bits, config.STEGO_LR, max_epochs=int(max_epochs),
    )
    if not done:
        # Surfacing this is load-bearing: a non-converged run would store
        # weights whose decode returns garbage.
        raise RuntimeError(
            f"stego encoding of {path!r} did not converge within "
            f"{int(max_epochs)} epochs ({n_bits} bits); raise max_epochs "
            "or shrink the payload"
        )
    print(f"Finished encoding {path} ({steps} steps)")

    w3_np = w3_t[:, :n_bits].cpu().numpy()
    b3_np = b3_t[:n_bits].cpu().numpy()
    del w3_t, b3_t
    net = SpeakerNet.new(
        input_size=len(input_bits), hidden1=512, hidden2=len(h2), output=1,
        seed=_seed_from_checksum(), device="cpu",
    )
    net.num_speakers = n_bits
    net.file_lists = [[] for _ in range(n_bits)]
    net.set_output_layer(w3_np, b3_np)
    # Stash as the encoding layer (the reference mirrors w3 -> w4,
    # src/lib.rs:1768-1770).
    net.set_encoding_layer(w3_np, b3_np)
    return net


def extract_file(w_out, b_out: Optional[np.ndarray] = None) -> bytes:
    """Recover bytes from a stored output layer via the checksum-keyed hidden
    activation (src/lib.rs:1777-1802, with the decode fix; see module doc).

    Accepts either ``(w, b)`` arrays or a :class:`SpeakerNet` (the reference
    signature takes the net), in which case its live output layer is used.
    """
    if isinstance(w_out, SpeakerNet):
        w_out, b_out = w_out.output_layer()
    if b_out is None:
        raise ValueError(
            "extract_file needs the bias vector: pass (w, b) arrays or a "
            "SpeakerNet"
        )
    input_bits = checksum_input_bits()
    h2 = _hidden_activation(input_bits, hidden2=int(w_out.shape[0]))
    out = 1.0 / (1.0 + np.exp(-(h2 @ np.asarray(w_out, np.float32) + np.asarray(b_out, np.float32))))
    bits = (out > 0.5).astype(np.uint8)
    bits = np.bitwise_xor(bits, _keystream(len(bits)))
    return bits_to_bytes(bits)


def extract_file_from_classifier(net: SpeakerNet) -> bytes:
    """Decode from a classifier: prefer the stashed w4/b4 stego layer, else
    fall back to the classifier's own output layer (src/lib.rs:1807-1825)."""
    enc = net.encoding_layer()
    if enc is not None:
        w4, b4 = enc
        return extract_file(w4, b4)
    w3, b3 = net.output_layer()
    return extract_file(w3, b3)
