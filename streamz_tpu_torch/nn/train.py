"""Training steps with the reference's SGD semantics, in PyTorch.

The port of ``streamz_tpu/nn/train.py``: its single-device trainers and
the window-sharded per-file trainer of the discovery loop's mesh route
(:func:`train_on_windows_sharded_impl`).
The reference trains with a hand-written backprop whose output delta is
exactly ``softmax(logits) - target``, including the quirk that an
out-of-range target class gives a zero target vector
(``streamz-rs/src/lib.rs:592-594``, ``:954-1060``).

The corpus step runs K5's step form and the per-file trainer K6
(``train_kernels``): each wrapper launches its kernel for CUDA tensors, at
every capacity, and runs its plain formulation for CPU tensors.  The plain
versions are ``train_kernels.corpus_grads_plain`` with ``_apply_step``, and
``train_windows_plain``.

The window-sharded trainer is plain torch ops, as it is plain XLA in the
JAX package: each rank computes its slice of every chunk's gradient with
``train_kernels._mlp_grads`` and one all-reduce per chunk merges them.

``train_bits_step`` is the steganography codec's sigmoid+MSE step
(``src/lib.rs:917-951``), plain torch as it is plain XLA in the JAX
package.

The step functions update the parameter dictionary IN PLACE and also
return it, where the JAX package returns a new one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from streamz_tpu_torch.nn import prng
from streamz_tpu_torch.nn.model import PARAM_NAMES
from streamz_tpu_torch.nn.train_kernels import (
    Batch,
    NumSpeakers,
    Params,
    _mlp_grads,
    _sgd,
    corpus_step_k5,
    split_sums,
    train_windows_k6,
)
from streamz_tpu_torch.parallel import comm
from streamz_tpu_torch.runtime.profiler import span


def train_batch(params: Params, batch: torch.Tensor, target: torch.Tensor, lr,
                num_speakers: NumSpeakers,
                weights: Optional[torch.Tensor] = None) -> Params:
    """One mean-gradient SGD step over a batch (src/lib.rs:1002-1060), with
    per-row targets [B, cap]; a fully masked batch applies no update."""
    w = torch.ones(batch.shape[0], device=batch.device) if weights is None else weights
    grads, _, _ = _mlp_grads(params, batch, target, w, num_speakers)
    _sgd(params, grads, w.sum(), lr)
    return params


def file_epoch_views(windows: torch.Tensor, n_valid, key: torch.Tensor,
                     dropout: float, epochs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-epoch shuffled and dropped window views and their valid masks,
    drawn from the threefry twin exactly as the JAX package draws them from
    ``jax.random`` (``streamz_tpu/nn/train.py:84-114``): valid windows
    first in random order (a stable argsort, padding rows at +inf), plain
    zeroing dropout, all-zero windows skipped.  Returns (dropped
    [E, N_pad, F], valid [E, N_pad])."""
    n_pad, feat = windows.shape
    dev = windows.device
    ekeys = prng.split(key, epochs)                 # [E, 2]
    sub = prng.split(ekeys, 2)                      # [E, 2, 2]
    k_perm, k_drop = sub[:, 0], sub[:, 1]
    real = torch.arange(n_pad, device=dev) < n_valid
    scores = torch.where(real, prng.uniform(k_perm, (n_pad,)),
                         torch.full((), float("inf"), device=dev))
    order = torch.argsort(scores, dim=-1, stable=True)  # [E, N_pad]
    keep = prng.uniform(k_drop, (n_pad, feat)) >= dropout
    dropped = torch.where(keep, windows[order], torch.zeros((), device=dev))
    valid = real & (dropped != 0.0).any(dim=-1)
    return dropped, valid.to(torch.float32)


def train_on_windows_impl(params: Params, windows: torch.Tensor, n_valid,
                          target_vec: torch.Tensor, num_speakers: NumSpeakers,
                          key: torch.Tensor, lr: float, dropout: float, *,
                          epochs: int, batch_size: int):
    """``pretrain_from_features`` (src/lib.rs:582-628) on padded windows
    [N_pad, F] of which the first ``n_valid`` are real: ``epochs`` shuffled,
    dropped epochs, chunks of ``batch_size``, the mean gradient of each
    chunk's surviving windows applied once per chunk.  The whole chunk loop
    is one K6 launch on CUDA.  Returns (params, mean reported loss over the
    processed windows, a device scalar)."""
    n_pad, feat = windows.shape
    n_chunks = n_pad // batch_size
    with span("train.draws"):
        dropped, valid = file_epoch_views(windows, n_valid, key, dropout, epochs)
    chunks = dropped.reshape(epochs * n_chunks, batch_size, feat)
    masks = valid.reshape(epochs * n_chunks, batch_size)
    loss_sum, loss_cnt = train_windows_k6(params, chunks, masks, target_vec,
                                          num_speakers, lr)
    mean = torch.where(loss_cnt > 0, loss_sum / torch.clamp(loss_cnt, min=1.0),
                       torch.zeros((), device=windows.device))
    return params, mean


def train_on_windows_sharded_impl(params: Params, windows: torch.Tensor, n_valid,
                                  target_vec: torch.Tensor, num_speakers: NumSpeakers,
                                  key: torch.Tensor, lr: float, dropout: float, *,
                                  epochs: int, batch_size: int, mesh):
    """:func:`train_on_windows_impl` with every chunk's gradient split over
    the ranks of ``mesh`` (``streamz_tpu/nn/train.py:245-306``).

    Every rank builds the same epoch views from the same key; rank ``r``
    of ``n`` takes rows ``[r*rows_per, (r+1)*rows_per)`` of each chunk,
    ``rows_per = ceil(batch_size / n)`` (a chunk is padded with weight-0
    rows when ``n`` does not divide it), and computes their gradient sums
    with the plain ``_mlp_grads``.  ONE all-reduce per chunk merges a flat
    ``[dw1 | db1 | dw2 | db2 | dw3 | db3 | loss, count, 0, 0]`` buffer
    (``train_kernels.split_sums``'s layout), then every rank applies the
    same mean-gradient update in place, so the parameters stay
    bit-identical on every rank.  The merged gradient equals the whole
    chunk's up to f32 summation order.  Returns (params, mean reported loss
    over the processed windows, a device scalar)."""
    n_pad, feat = windows.shape
    n_chunks = n_pad // batch_size
    dev = windows.device
    with span("train.draws"):
        dropped, valid = file_epoch_views(windows, n_valid, key, dropout, epochs)
    chunks = dropped.reshape(epochs * n_chunks, batch_size, feat)
    masks = valid.reshape(epochs * n_chunks, batch_size)
    n_dev = mesh.size()
    rows_per = -(-batch_size // n_dev)
    pad = rows_per * n_dev - batch_size
    if pad:  # weight-0 rows for an uneven split
        chunks = torch.nn.functional.pad(chunks, (0, 0, 0, pad))
        masks = torch.nn.functional.pad(masks, (0, pad))
    lo = comm.axis_index(mesh) * rows_per
    chunks, masks = chunks[:, lo:lo + rows_per], masks[:, lo:lo + rows_per]
    tgt = target_vec.expand(rows_per, -1)
    zeros2 = torch.zeros((2,), device=dev)
    loss_sum = torch.zeros((), device=dev)
    loss_cnt = torch.zeros((), device=dev)
    for s in range(chunks.shape[0]):
        wmask = masks[s]
        grads, _, probs = _mlp_grads(params, chunks[s], tgt, wmask, num_speakers)
        report = -(tgt * torch.log(torch.clamp(probs, min=1e-12))).sum(dim=-1)
        flat = torch.cat([*(grads[k].reshape(-1) for k in PARAM_NAMES),
                          (report * wmask).sum().reshape(1), wmask.sum().reshape(1),
                          zeros2])
        grads, part, count = split_sums(params, comm.psum(flat, mesh))
        _sgd(params, grads, count, lr)
        loss_sum = loss_sum + part
        loss_cnt = loss_cnt + count
    mean = torch.where(loss_cnt > 0, loss_sum / torch.clamp(loss_cnt, min=1.0),
                       torch.zeros((), device=dev))
    return params, mean


def corpus_step(params: Params, batch: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor, num_speakers: NumSpeakers, lr):
    """One SGD step on a large labelled batch through K5's step form, ``p -=
    lr / max(count, 1) * grad`` in place; returns (params, mean CE loss as a
    device scalar)."""
    return params, corpus_step_k5(params, Batch(batch, labels, weights),
                                  num_speakers, lr)


def train_bits_step(params: Params, x: torch.Tensor, target: torch.Tensor, lr,
                    n_live: int) -> Params:
    """One MSE+sigmoid SGD step of the whole MLP on ``x`` ([in], or rows
    [B, in] whose losses add up), in place.

    The gradient of ``0.5 * sum_live (sigmoid(h2 @ w3 + b3) - t)**2`` by the
    chain rule: the output delta ``(out - t) * out * (1 - out)``
    (src/lib.rs:926-927), zero for the columns at or past ``n_live`` (the
    capacity padding, whose random weights would otherwise move the trunk),
    then back through tanh and ReLU to every layer."""
    x2 = torch.atleast_2d(x)
    h1 = torch.relu(x2 @ params["w1"] + params["b1"])
    h2 = torch.tanh(h1 @ params["w2"] + params["b2"])
    out = torch.sigmoid(h2 @ params["w3"] + params["b3"])
    live = torch.arange(out.shape[-1], device=out.device) < n_live
    delta = torch.where(live, (out - target) * (out * (1.0 - out)),
                        torch.zeros((), device=out.device))
    dh2 = (delta @ params["w3"].T) * (1.0 - h2 * h2)
    dh1 = (dh2 @ params["w2"].T) * (h1 > 0.0)
    grads = {
        "w1": x2.T @ dh1, "b1": dh1.sum(0),
        "w2": h1.T @ dh2, "b2": dh2.sum(0),
        "w3": h2.T @ delta, "b3": delta.sum(0),
    }
    for k in PARAM_NAMES:
        params[k].sub_(lr * grads[k])
    return params
