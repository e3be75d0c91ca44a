"""The speaker-ID MLP in PyTorch, with the JAX package's capacity layout.

The port of ``streamz_tpu/nn/model.py``.  Reference architecture
(``streamz-rs/src/lib.rs:744-790``): ``w1`` (in x h1, ReLU) -> ``w2``
(h1 x h2, tanh) -> ``w3`` (h2 x out, softmax), instantiated 60x512x256xS.

``w3``/``b3`` are allocated at a *capacity* that is a multiple of 128 and a
``num_speakers`` count masks the inactive columns, exactly as in the JAX
package, so both packages hold the same parameters.  Weights keep the JAX
layout (``x @ w1``, ``w1`` is [in, h1]), not ``nn.Linear``'s [out, in].

Both embedding heads of the reference are kept:

- ``embed`` = tanh(h2)  (``src/lib.rs:895-900``)
- ``forward_embedding`` = ReLU(h2)  (``src/lib.rs:1073-1079``), the one
  the identification path pools.

and the steganography codec's unmasked sigmoid head ``forward_bits``
(``src/lib.rs:908-914``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from streamz_tpu_torch import config
from streamz_tpu_torch.device import resolve_device

Params = Mapping[str, torch.Tensor]
PARAM_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")

# Large negative logit used to mask inactive softmax columns.  Finite (not
# -inf) so that exp() underflows cleanly to 0.0 without NaN risk.
MASK_LOGIT = -1e30

_CAPACITY_ALIGN = 128


def round_capacity(n: int) -> int:
    """Round a class count up to the 128-aligned capacity."""
    n = max(int(n), 1)
    return ((n + _CAPACITY_ALIGN - 1) // _CAPACITY_ALIGN) * _CAPACITY_ALIGN


def _uniform(rng: np.random.Generator, shape) -> np.ndarray:
    # Reference init: U(-0.5, 0.5) (src/lib.rs:770).
    return rng.uniform(-0.5, 0.5, size=shape).astype(np.float32)


def init_params(
    input_size: int,
    hidden1: int,
    hidden2: int,
    output: int,
    *,
    capacity: Optional[int] = None,
    seed: int = 0,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Fresh f32 parameters on ``device``, drawn in the JAX package's order
    from ``np.random.default_rng(seed)``, so both packages start from the
    same bits (src/lib.rs:767-790)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cap = round_capacity(capacity if capacity is not None else output)
    params = {
        "w1": _uniform(rng, (input_size, hidden1)),
        "b1": np.zeros((hidden1,), np.float32),
        "w2": _uniform(rng, (hidden1, hidden2)),
        "b2": np.zeros((hidden2,), np.float32),
        "w3": _uniform(rng, (hidden2, cap)),
        "b3": np.zeros((cap,), np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in params.items()}


def class_mask(capacity: int, num_speakers: int, device=None) -> torch.Tensor:
    """[capacity] float mask: 1.0 for live columns, 0.0 for inactive."""
    return (torch.arange(capacity, device=device) < num_speakers).to(torch.float32)


# ---------------------------------------------------------------------------
# Plain forward functions on a parameter mapping.  The three products are
# plain large matmuls (outside any Pallas kernel in the JAX package too).
# ---------------------------------------------------------------------------


def hidden_tanh(params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared trunk: returns (h1=relu, h2=tanh). x: [..., in]."""
    h1 = torch.relu(x @ params["w1"] + params["b1"])
    h2 = torch.tanh(h1 @ params["w2"] + params["b2"])
    return h1, h2


def forward_logits(params: Params, x: torch.Tensor, num_speakers: int) -> torch.Tensor:
    """Masked logits over the full capacity. x: [..., in] -> [..., capacity]."""
    _, h2 = hidden_tanh(params, x)
    logits = h2 @ params["w3"] + params["b3"]
    mask = torch.arange(logits.shape[-1], device=logits.device) < num_speakers
    return torch.where(mask, logits, torch.full((), MASK_LOGIT, device=logits.device))


def forward(params: Params, x: torch.Tensor, num_speakers: int) -> torch.Tensor:
    """Softmax probabilities over live classes (src/lib.rs:880-891).

    Returns [..., capacity]; inactive columns are exactly 0.0, also when
    ``num_speakers == 0``, where the all-``MASK_LOGIT`` softmax would
    otherwise be a uniform 1/capacity row.
    """
    probs = torch.softmax(forward_logits(params, x, num_speakers), dim=-1)
    return probs * class_mask(probs.shape[-1], num_speakers, probs.device)


def embed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """tanh-h2 embedding head (src/lib.rs:895-900)."""
    return hidden_tanh(params, x)[1]


def forward_embedding(params: Params, x: torch.Tensor) -> torch.Tensor:
    """ReLU-h2 embedding head (src/lib.rs:1073-1079), the variant the
    identification path pools."""
    h1 = torch.relu(x @ params["w1"] + params["b1"])
    return torch.relu(h1 @ params["w2"] + params["b2"])


def forward_bits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Sigmoid output head of the steganography codec (src/lib.rs:908-914):
    no class mask, the whole output layer."""
    _, h2 = hidden_tanh(params, x)
    return torch.sigmoid(h2 @ params["w3"] + params["b3"])


class SpeakerMLP(nn.Module):
    """The six parameter tensors as an ``nn.Module``; ``forward`` gives the
    masked softmax probabilities."""

    def __init__(self, params: Params):
        super().__init__()
        for name in PARAM_NAMES:
            self.register_parameter(
                name, nn.Parameter(params[name].to(torch.float32), requires_grad=False)
            )

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def forward(self, x: torch.Tensor, num_speakers: int) -> torch.Tensor:
        return forward(self.params(), x, num_speakers)


@dataclasses.dataclass
class SpeakerNet:
    """The MLP plus the metadata ``model.npz`` carries (the reference
    ``SimpleNeuralNet`` fields, ``src/lib.rs:744-762``): per-speaker
    ``file_lists``, dataset specs, stored speaker embeddings
    ``(mean, mean_sim, std_sim)`` and the optional ``w4/b4`` layer."""

    mlp: SpeakerMLP
    num_speakers: int
    file_lists: List[List[str]]
    sample_rate: int = config.DEFAULT_SAMPLE_RATE
    bits: int = 16
    embeddings: List[Tuple[np.ndarray, float, float]] = dataclasses.field(
        default_factory=list
    )
    w4: Optional[np.ndarray] = None
    b4: Optional[np.ndarray] = None
    _growth_seed: int = 1_000_003

    @classmethod
    def new(
        cls,
        input_size: int = config.FEATURE_SIZE,
        hidden1: int = config.HIDDEN1,
        hidden2: int = config.HIDDEN2,
        output: int = 1,
        *,
        seed: int = 0,
        device=None,
    ) -> "SpeakerNet":
        params = init_params(input_size, hidden1, hidden2, output, seed=seed,
                             device=device)
        return cls(
            mlp=SpeakerMLP(params),
            num_speakers=output,
            file_lists=[[] for _ in range(output)],
        )

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.mlp.params()

    @params.setter
    def params(self, params: Params) -> None:
        self.mlp = SpeakerMLP(params)

    def working_params(self) -> Dict[str, torch.Tensor]:
        """Contiguous copies of the parameters, for the trainers that update
        them in place; assign them back to ``params`` when done."""
        return {k: v.detach().clone().contiguous() for k, v in self.params.items()}

    @property
    def device(self) -> torch.device:
        return self.mlp.w1.device

    @property
    def capacity(self) -> int:
        return int(self.mlp.w3.shape[1])

    def output_size(self) -> int:
        return self.num_speakers

    def embedding_size(self) -> int:
        return int(self.mlp.w2.shape[1])

    def input_size(self) -> int:
        return int(self.mlp.w1.shape[0])

    def set_embeddings(self, embeds: List[Tuple[np.ndarray, float, float]]) -> None:
        self.embeddings = embeds

    def set_dataset_specs(self, sample_rate: int, bits: int) -> None:
        self.sample_rate = sample_rate
        self.bits = bits

    # -- class growth (src/lib.rs:797-821), bit-identical to the JAX package --

    def add_output_class(self) -> None:
        """Expose one more softmax column, doubling capacity if exhausted."""
        if self.num_speakers >= self.capacity:
            self._grow_capacity(self.capacity * 2)
        if len(self.file_lists) <= self.num_speakers:
            self.file_lists.append([])
        self.num_speakers += 1

    def ensure_capacity(self, n: int) -> None:
        """Grow the padded ``w3`` capacity to hold at least ``n`` classes,
        so the discovery loop can grow classes on the device."""
        if n > self.capacity:
            self._grow_capacity(n)

    def _grow_capacity(self, new_capacity: int) -> None:
        """New ``w3`` columns are drawn U(-0.5, 0.5) from
        ``default_rng(_growth_seed)``, as the JAX package draws them."""
        new_capacity = round_capacity(new_capacity)
        old_cap = self.capacity
        rng = np.random.default_rng(self._growth_seed)
        self._growth_seed += 1
        extra = torch.from_numpy(
            _uniform(rng, (self.embedding_size(), new_capacity - old_cap))
        ).to(self.device)
        p = self.params
        w3 = torch.cat([p["w3"].detach(), extra], dim=1)
        b3 = torch.cat([p["b3"].detach(),
                        torch.zeros(new_capacity - old_cap, device=self.device)])
        self.params = dict(p, w3=w3, b3=b3)

    def set_output_layer(self, w3: np.ndarray, b3: np.ndarray) -> None:
        """Replace the live softmax layer (src/lib.rs:829-833); padding
        columns are re-drawn U(-0.5, 0.5) and the capacity never shrinks."""
        n = int(b3.shape[0])
        cap = round_capacity(max(n, self.capacity))
        rng = np.random.default_rng(self._growth_seed)
        self._growth_seed += 1
        if n == cap:
            # No padding column: the draw would be overwritten whole (a
            # steganography layer at the 128 KiB cap is 268 M draws).
            w3_full = np.array(w3, np.float32)
        else:
            w3_full = _uniform(rng, (w3.shape[0], cap))
            w3_full[:, :n] = w3
        b3_full = np.zeros((cap,), np.float32)
        b3_full[:n] = b3
        self.params = dict(self.params, w3=torch.from_numpy(w3_full).to(self.device),
                           b3=torch.from_numpy(b3_full).to(self.device))
        self.num_speakers = n

    def record_training_file(self, cls_id: int, path: str) -> None:
        """Append a path to a speaker's file list, de-duplicated (src/lib.rs:855-862)."""
        while len(self.file_lists) <= cls_id:
            self.file_lists.append([])
        if path not in self.file_lists[cls_id]:
            self.file_lists[cls_id].append(path)

    # -- stego layer (src/lib.rs:836-847) ------------------------------------

    def set_encoding_layer(self, w4: np.ndarray, b4: np.ndarray) -> None:
        self.w4 = np.asarray(w4, np.float32)
        self.b4 = np.asarray(b4, np.float32)

    def encoding_layer(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self.w4 is not None and self.b4 is not None:
            return self.w4, self.b4
        return None

    def output_layer(self) -> Tuple[np.ndarray, np.ndarray]:
        """Live (unpadded) softmax layer (src/lib.rs:850-852)."""
        w3 = self.mlp.w3.detach().cpu().numpy()[:, : self.num_speakers]
        b3 = self.mlp.b3.detach().cpu().numpy()[: self.num_speakers]
        return w3, b3

    # -- convenience host-side forward passes --------------------------------

    def _host(self, fn, x) -> np.ndarray:
        with torch.inference_mode():
            xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
            return fn(self.params, xt).cpu().numpy()

    def forward(self, x) -> np.ndarray:
        """Softmax over the *live* classes only, shape [..., num_speakers]."""
        out = self._host(lambda p, xt: forward(p, xt, self.num_speakers), x)
        return out[..., : self.num_speakers]

    def embed_np(self, x) -> np.ndarray:
        """tanh-h2 embedding of ``x`` as a host array (src/lib.rs:895-900)."""
        return self._host(embed, x)

    # reference method name (src/lib.rs:895-900)
    embed_host = embed_np

    def forward_embedding_np(self, x) -> np.ndarray:
        """ReLU-h2 embedding of ``x`` as a host array (src/lib.rs:1073-1079)."""
        return self._host(forward_embedding, x)

    def forward_bits(self, x) -> np.ndarray:
        """Sigmoid head on the live output columns (src/lib.rs:908-914),
        sliced to ``num_speakers``: the reference's output is exactly the
        trained bit width, and the capacity padding's random columns would
        be phantom bits."""
        return self._host(forward_bits, x)[..., : self.num_speakers]

    # -- in-place training steps (reference method surface,
    #    src/lib.rs:917-1060) -------------------------------------------------

    def _target_full(self, target) -> Tuple[np.ndarray, int]:
        """A live-class target vector zero-padded to the capacity, and the
        number of its columns that are live."""
        t_live = np.asarray(target, np.float32).ravel()
        n_live = min(len(t_live), self.capacity)
        t_full = np.zeros((self.capacity,), np.float32)
        t_full[:n_live] = t_live[:n_live]
        return t_full, n_live

    def train(self, x, target, lr: float) -> None:
        """Single-sample CE+softmax SGD step (src/lib.rs:954-999)."""
        self.train_batch(np.asarray(x, np.float32)[None, :], target, lr)

    def train_batch(self, batch, target, lr: float) -> None:
        """Mean-gradient SGD over a batch with a shared live-class target
        vector (src/lib.rs:1002-1060)."""
        from streamz_tpu_torch.nn import train as _T

        batch = np.asarray(batch, np.float32)
        if batch.size == 0:
            return
        t_full, _ = self._target_full(target)
        dev = self.device
        xt = torch.from_numpy(batch).to(dev)
        t = torch.from_numpy(t_full).to(dev).expand(xt.shape[0], -1)
        self.params = _T.train_batch(self.working_params(), xt, t, float(lr),
                                     self.num_speakers)

    def train_bits(self, x, target, lr: float) -> None:
        """Single-step MSE+sigmoid update on the full output layer
        (src/lib.rs:917-951); columns past the target's length stay."""
        from streamz_tpu_torch.nn import train as _T

        t_full, n_live = self._target_full(target)
        dev = self.device
        self.params = _T.train_bits_step(
            self.working_params(), torch.as_tensor(np.asarray(x, np.float32), device=dev),
            torch.from_numpy(t_full).to(dev), float(lr), n_live)

    # -- persistence (src/lib.rs:1081-1281) ----------------------------------

    def save(self, path: str) -> None:
        from streamz_tpu_torch.nn import checkpoint

        checkpoint.save(self, path)

    @classmethod
    def load(cls, path: str, device=None) -> "SpeakerNet":
        from streamz_tpu_torch.nn import checkpoint

        return checkpoint.load(path, device=device)
