"""K7, the fused classifier forward, as a hand-written CUDA kernel for Hopper.

Replaces ``streamz_tpu/nn/pallas_forward.py:_fwd_kernel`` (through
``forward_probs_pallas``).  The kernel source is
``streamz_tpu_torch/csrc/forward_probs.cu``:
:mod:`streamz_tpu_torch._cuda_build` builds it with ``nvcc`` for ``sm_90a``
at first use and loads its plain C entry point with ``ctypes``.

:func:`forward_probs_k7` takes window features [R, F] and returns the masked
softmax probabilities [R, capacity] of the 60→512→256→capacity MLP, with the
columns at or past ``num_speakers`` exactly 0.0 (also when it is 0).  A CUDA
tensor launches the kernel or raises; a CPU tensor runs its plain version,
:func:`streamz_tpu_torch.nn.model.forward`, because there is no kernel to
run there.  ``forward_probs_k7.launches`` counts kernel launches.

As in the JAX package, the main path's forward stays the plain
``nn/model.forward`` (torch matmuls); K7 is the alternate fused backend,
reached through this wrapper and the bench twin
(:mod:`streamz_tpu_torch.bench`).
"""

from __future__ import annotations

import ctypes

import torch

from streamz_tpu_torch import _cuda_build
from streamz_tpu_torch.nn.model import PARAM_NAMES, Params, forward
from streamz_tpu_torch.nn.train_kernels import _check, _check_params


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.streamz_forward_probs.argtypes = [
        p, i64, i32, i32, p, p, p, p, p, p, i32, i32, i32, p, p]
    lib.streamz_forward_probs.restype = i32
    lib.streamz_forward_probs_tile.argtypes = []
    lib.streamz_forward_probs_tile.restype = i32


def forward_probs_k7(params: Params, x: torch.Tensor, num_speakers: int) -> torch.Tensor:
    """K7: masked softmax probabilities for a window batch.

    x: [R, F] f32 → [R, capacity]; the counterpart of
    ``model.forward(params, x, num_speakers)`` on 2-D inputs.  R == 0
    launches nothing.
    """
    if x.device.type == "cpu":
        return forward(params, x, num_speakers)
    if x.device.type != "cuda":
        raise ValueError(f"K7 runs on CUDA or CPU tensors, got {x.device}")
    dev = x.device
    F, H1, H2, cap = _check_params(params, dev)
    if x.dim() != 2:
        raise ValueError(f"K7 takes [R, {F}] features, got {tuple(x.shape)}")
    R = x.shape[0]
    _check("x", x, torch.float32, (R, F), dev)
    if R == 0:
        return torch.empty((0, cap), dtype=torch.float32, device=dev)
    ns = max(0, min(int(num_speakers), cap))
    lib = _cuda_build.load("forward_probs", _declare)
    tile = int(lib.streamz_forward_probs_tile())
    out = torch.empty((-(-R // tile) * tile, cap), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.streamz_forward_probs(
            x.data_ptr(), R, F, ns, *(params[k].data_ptr() for k in PARAM_NAMES),
            H1, H2, cap, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"K7 (forward_probs) launch failed: CUDA error {rc}")
    forward_probs_k7.launches += 1
    return out[:R]


forward_probs_k7.launches = 0
