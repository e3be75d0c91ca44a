"""K7, the fused classifier forward, as a hand-written CUDA kernel for Hopper.

Replaces ``streamz_tpu/nn/pallas_forward.py:_fwd_kernel`` (through
``forward_probs_pallas``).  The kernel source is
``streamz_tpu_torch/csrc/forward_probs.cu``:
:mod:`streamz_tpu_torch._cuda_build` builds it with ``nvcc`` for ``sm_90a``
at first use and loads its plain C entry point with ``ctypes``.

:func:`forward_probs_k7` takes window features [R, F] and returns the masked
softmax probabilities [R, capacity] of the 60→512→256→capacity MLP, with the
columns at or past ``num_speakers`` exactly 0.0 (also when it is 0).  It
computes what the TPU kernel computes: its three products at DEFAULT
precision, each operand rounded to bf16 (nearest even) with f32 sums; the
biases, activations, mask and softmax in f32.  A CUDA tensor launches the
kernel or raises; a CPU tensor runs its plain version,
:func:`forward_probs_plain`, because there is no kernel to run there.
``forward_probs_k7.launches`` counts kernel launches (one per call: the
weight packing and the forward).

As in the JAX package, the main path's forward stays the plain FP32
``nn/model.forward`` (torch matmuls); K7 is the alternate fused backend,
reached through this wrapper and the bench twin
(:mod:`streamz_tpu_torch.bench`).
"""

from __future__ import annotations

import ctypes

import torch

from streamz_tpu_torch import _cuda_build
from streamz_tpu_torch.nn.model import MASK_LOGIT, PARAM_NAMES, Params
from streamz_tpu_torch.nn.train_kernels import _check, _check_params

K_ALIGN = 64   # a layer's K padded to whole ring stages (four k16 steps)
N_CHUNK = 128  # a layer's output columns padded to whole chunks (one wgmma N)
ROUTES = ("on chip", "device memory")  # where the kernel keeps the activations


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def forward_probs_plain(params: Params, x: torch.Tensor, num_speakers: int) -> torch.Tensor:
    """K7's function as torch ops: ``_fwd_kernel`` at DEFAULT precision.

    h1 = relu(bf16(x) @ bf16(w1) + b1), h2 = tanh(bf16(h1) @ bf16(w2) + b2),
    logits = bf16(h2) @ bf16(w3) + b3, masked at or past ``num_speakers``,
    then the softmax; the inactive columns exactly 0.0.
    """
    cap = params["w3"].shape[1]
    h1 = torch.relu(_bf16(x) @ _bf16(params["w1"]) + params["b1"])
    h2 = torch.tanh(_bf16(h1) @ _bf16(params["w2"]) + params["b2"])
    logits = _bf16(h2) @ _bf16(params["w3"]) + params["b3"]
    live = torch.arange(cap, device=x.device) < num_speakers
    logits = torch.where(live, logits, torch.full((), MASK_LOGIT, device=x.device))
    return torch.where(live, torch.softmax(logits, dim=-1), torch.zeros((), device=x.device))


def padded_widths(F: int, H1: int, H2: int, cap: int):
    """(K1, N1, N2, N3): layer 1 is [K1, N1], layer 2 [N1, N2], layer 3 [N2, N3]."""
    up = lambda v, m: -(-v // m) * m  # noqa: E731
    return up(F, K_ALIGN), up(H1, N_CHUNK), up(H2, N_CHUNK), up(cap, N_CHUNK)


def packed_weights_plain(params: Params) -> torch.Tensor:
    """The kernel's packed weights as torch ops: a 1-D bf16 tensor, w1, w2
    and w3 in turn, each padded with zeros to [K, N] of
    :func:`padded_widths` and laid out as [N / 128 chunks, K / 16 k16 steps,
    128 columns n, 16 k]: column n's 16 k in 32 bytes, its two 8-k halves
    swapped when n // 4 is odd (wgmma's 32-byte swizzle)."""
    F, H1 = params["w1"].shape
    H2, cap = params["w3"].shape
    K1, N1, N2, N3 = padded_widths(F, H1, H2, cap)
    odd = (torch.arange(N_CHUNK) >> 2) & 1 == 1
    parts = []
    for name, K, N in (("w1", K1, N1), ("w2", N1, N2), ("w3", N2, N3)):
        w = params[name]
        wp = torch.zeros((K, N), dtype=torch.bfloat16, device=w.device)
        wp[:w.shape[0], :w.shape[1]] = w.to(torch.bfloat16)
        # [k = (step, half, kk), n = (chunk, nn)] -> [chunk, step, nn, half, kk]
        b = wp.reshape(K // 16, 2, 8, N // N_CHUNK, N_CHUNK).permute(3, 0, 4, 1, 2).contiguous()
        b[:, :, odd] = b[:, :, odd].flip(3)
        parts.append(b.reshape(-1))
    return torch.cat(parts)


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.streamz_forward_probs.argtypes = [
        p, i64, i32, i32, p, p, p, p, p, p, i32, i32, i32, p, i64, p, p]
    lib.streamz_forward_probs.restype = i32
    lib.streamz_forward_probs_pack.argtypes = [p, p, p, i32, i32, i32, i32, p, p]
    lib.streamz_forward_probs_pack.restype = i32
    for name, res in (("workspace", i64), ("route", i32), ("smem", i32), ("packed_elems", i64)):
        fn = getattr(lib, f"streamz_forward_probs_{name}")
        fn.argtypes = [i32, i32, i32, i32]
        fn.restype = res


def _lib() -> ctypes.CDLL:
    return _cuda_build.load("forward_probs", _declare)


def k7_route(F: int, H1: int, H2: int, cap: int) -> str:
    """Where K7 keeps the activations at these widths (:data:`ROUTES`)."""
    return ROUTES[_lib().streamz_forward_probs_route(F, H1, H2, cap)]


def k7_smem_bytes(F: int, H1: int, H2: int, cap: int) -> int:
    """Shared memory one K7 block asks for at these widths."""
    return int(_lib().streamz_forward_probs_smem(F, H1, H2, cap))


def packed_weights_k7(params: Params) -> torch.Tensor:
    """The kernel's pack stage alone on CUDA parameters: the bf16 tensor
    that :func:`packed_weights_plain` computes (the card tests hold the two
    bit for bit)."""
    dev = params["w1"].device
    F, H1, H2, cap = _check_params(params, dev)
    lib = _lib()
    out = torch.empty(int(lib.streamz_forward_probs_packed_elems(F, H1, H2, cap)),
                      dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        rc = lib.streamz_forward_probs_pack(
            params["w1"].data_ptr(), params["w2"].data_ptr(), params["w3"].data_ptr(),
            F, H1, H2, cap, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K7's pack kernel failed to launch: CUDA error {rc}")
    return out


def forward_probs_k7(params: Params, x: torch.Tensor, num_speakers: int) -> torch.Tensor:
    """K7: masked softmax probabilities for a window batch.

    x: [R, F] f32 → [R, capacity]; the counterpart of
    ``forward_probs_pallas(params, x, num_speakers)``.  R == 0 launches
    nothing.
    """
    if x.device.type == "cpu":
        return forward_probs_plain(params, x, num_speakers)
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
    lib = _lib()
    nbytes = int(lib.streamz_forward_probs_workspace(F, H1, H2, cap))
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = torch.empty((R, cap), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.streamz_forward_probs(
            x.data_ptr(), R, F, ns, *(params[k].data_ptr() for k in PARAM_NAMES),
            H1, H2, cap, work.data_ptr(), nbytes, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"K7 (forward_probs) launch failed: CUDA error {rc}")
    forward_probs_k7.launches += 1
    return out


forward_probs_k7.launches = 0
