"""K5 and K6, the training kernels, as hand-written CUDA kernels for Hopper.

- **K5** (``csrc/corpus_grads.cu``) replaces
  ``streamz_tpu/nn/pallas_train.py:_train_kernel`` (``corpus_grads_pallas``,
  ``corpus_step_pallas``): forward, masked softmax cross-entropy and
  backward of labelled rows on the tensor cores (3xTF32).  Rows come from a
  batch (:class:`Batch`) or are gathered on the card from a window pool by
  the epoch's order and dropout mask (:class:`PoolRows`).  Two forms: the
  six gradient sums with the weighted loss sum and the count
  (:func:`corpus_grads_k5`, :func:`corpus_rows_grads_k5`), or the SGD step
  applied in place with the mean loss (:func:`corpus_step_k5`).
- **K6** (``csrc/file_train.cu``) replaces ``_file_train_kernel``
  (``train_windows_pallas``): the whole per-file chunk-SGD loop of the
  discovery loop in one launch of one thread-block cluster, whose CTAs hold
  the parameters in their shared memory for the whole file (w3, or every
  weight and the activations, stay in device memory when their slices do
  not fit: :data:`K6_ROUTES`).  It takes any chunk size: chunks of more
  than 32 windows run as row tiles of 32 within a step.
  :func:`train_windows_k6`.

Beside each kernel is its plain PyTorch version, :func:`corpus_grads_plain`
(after :func:`rows_plain`; the step adds :func:`_apply_step`) and
:func:`train_windows_plain` (a loop of :func:`_chunk_update`), with the
same hand-written backward: the delta ``softmax - target`` of the surrogate
loss ``sum_i w_i (logsumexp(logits_i) - <t_i, logits_i>)``
(``streamz-rs/src/lib.rs:954-1060``).  A wrapper given CPU tensors runs the
plain version, since there is no kernel there; given CUDA tensors it
launches its kernel or raises, at every capacity.  Each wrapper counts its
launches in ``.launches`` (K5's entry points all count on
``corpus_grads_k5.launches``).

Parameters are dictionaries of f32 tensors in the JAX package's layout
(``w1`` [F, H1] ... ``b3`` [capacity]).  The corpus step and the per-file
trainers (``corpus_step_k5``, ``train_windows_k6`` and their plain twins)
update them IN PLACE, which saves a copy of the parameters per step.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from streamz_tpu_torch import _cuda_build
from streamz_tpu_torch.nn.model import MASK_LOGIT, PARAM_NAMES

Params = Dict[str, torch.Tensor]
NumSpeakers = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# The plain formulation (the CPU path, and the reference the kernels are
# held to on the card).
# ---------------------------------------------------------------------------


def _mlp_grads(params: Params, x: torch.Tensor, target: torch.Tensor,
               w: torch.Tensor, num_speakers: NumSpeakers):
    """Gradient sums of the surrogate loss for rows ``x`` [B, F] with
    targets [B, cap] and row weights [B]; returns (grads, per-row surrogate
    loss [B], probs [B, cap]).  Columns >= num_speakers are masked, and
    their delta is zeroed, as the mask's backward does."""
    h1 = torch.relu(x @ params["w1"] + params["b1"])
    h2 = torch.tanh(h1 @ params["w2"] + params["b2"])
    logits = h2 @ params["w3"] + params["b3"]
    live = torch.arange(logits.shape[-1], device=x.device) < num_speakers
    logits = torch.where(live, logits, torch.full((), MASK_LOGIT, device=x.device))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    se = e.sum(dim=-1, keepdim=True)
    probs = e / se
    per = (m + torch.log(se))[:, 0] - (target * logits).sum(dim=-1)
    delta = (probs - target) * w[:, None] * live
    dh2 = (delta @ params["w3"].T) * (1.0 - h2 * h2)
    dh1 = (dh2 @ params["w2"].T) * (h1 > 0.0)
    grads = {
        "w1": x.T @ dh1, "b1": dh1.sum(0),
        "w2": h1.T @ dh2, "b2": dh2.sum(0),
        "w3": h2.T @ delta, "b3": delta.sum(0),
    }
    return grads, per, probs


def _corpus_target(labels: torch.Tensor, capacity: int,
                   num_speakers: NumSpeakers) -> torch.Tensor:
    """one-hot(label), zeroed when the label is out of range
    (``streamz-rs/src/lib.rs:592-594``)."""
    cols = torch.arange(capacity, device=labels.device)
    hot = (cols[None, :] == labels[:, None]) & (labels < num_speakers)[:, None]
    return hot.to(torch.float32)


def corpus_grads_plain(params: Params, batch: torch.Tensor, labels: torch.Tensor,
                       weights: torch.Tensor, num_speakers: NumSpeakers):
    """Summed gradients + (loss_sum, count) for one labelled batch."""
    target = _corpus_target(labels, params["b3"].shape[0], num_speakers)
    grads, per, _ = _mlp_grads(params, batch, target, weights, num_speakers)
    return grads, (per * weights).sum(), weights.sum()


class Batch(NamedTuple):
    """Labelled rows as they are: ``x`` [B, F] f32, ``labels`` [B] int32,
    ``weights`` [B] f32."""

    x: torch.Tensor
    labels: torch.Tensor
    weights: torch.Tensor


class PoolRows(NamedTuple):
    """A corpus step's rows, gathered from a window pool: row i is
    ``pool_x[order[i]]`` ([N, F] f32), times ``keep[i]`` ([n, F] uint8 0/1,
    the dropout mask of the step's positions; None without dropout),
    labelled ``pool_y[order[i]]`` ([N] int32).  Rows ``i >= n`` of ``order``
    ([B] int32) are the epoch's padding: weight 0.  Under dropout a row's
    weight is also 0 when it is all zero (``src/lib.rs:119-129, :607-609``)."""

    pool_x: torch.Tensor
    pool_y: torch.Tensor
    order: torch.Tensor
    keep: Optional[torch.Tensor]
    n: int


Rows = Union[Batch, PoolRows]


def rows_plain(rows: Rows) -> Batch:
    """The rows as a :class:`Batch`, gathered in plain torch: the same bits
    as the JAX package's host gather (``streamz_tpu/app/corpus.py:95-113``)."""
    if isinstance(rows, Batch):
        return rows
    idx = rows.order.long()
    x = rows.pool_x[idx]
    w = (torch.arange(len(idx), device=x.device) < rows.n).to(torch.float32)
    if rows.keep is not None:
        x[:rows.n] = x[:rows.n] * rows.keep.to(torch.float32)
        w = w * (x != 0.0).any(dim=-1)
    return Batch(x, rows.pool_y[idx], w)


def _sgd(params: Params, grads: Params, count: torch.Tensor, lr) -> None:
    """``p -= lr / count * grad`` in place; no update when count is 0."""
    scale = torch.where(count > 0, lr / torch.clamp(count, min=1.0),
                        torch.zeros((), device=count.device))
    for k in PARAM_NAMES:
        params[k].sub_(scale * grads[k])


def _apply_step(params: Params, grads: Params, loss_sum: torch.Tensor,
                count: torch.Tensor, lr) -> torch.Tensor:
    """The corpus step's update in place; returns the mean loss."""
    _sgd(params, grads, count, lr)
    return loss_sum / torch.clamp(count, min=1.0)


def _chunk_update(params: Params, batch: torch.Tensor, wmask: torch.Tensor,
                  target_vec: torch.Tensor, num_speakers: NumSpeakers, lr):
    """One chunk of the per-file trainer, the plain twin of a K6 step: the
    mean gradient over the chunk's surviving windows is applied in place
    (none when no window survives), and the clamped cross-entropy report
    ``-sum t log(max(p, 1e-12))`` rides along.  Returns (loss part, count)."""
    tgt = target_vec.expand(batch.shape[0], -1)
    grads, _, probs = _mlp_grads(params, batch, tgt, wmask, num_speakers)
    report = -(tgt * torch.log(torch.clamp(probs, min=1e-12))).sum(dim=-1)
    count = wmask.sum()
    _sgd(params, grads, count, lr)
    return (report * wmask).sum(), count


def train_windows_plain(params: Params, chunks: torch.Tensor, masks: torch.Tensor,
                        target_vec: torch.Tensor, num_speakers: NumSpeakers, lr):
    """The per-file chunk loop: ``_chunk_update`` over chunks [S, B, F] with
    masks [S, B], in order.  Updates ``params`` in place; returns
    (loss_sum, loss_count)."""
    loss_sum = torch.zeros((), device=chunks.device)
    loss_cnt = torch.zeros((), device=chunks.device)
    for s in range(chunks.shape[0]):
        part, count = _chunk_update(params, chunks[s], masks[s], target_vec,
                                    num_speakers, lr)
        loss_sum = loss_sum + part
        loss_cnt = loss_cnt + count
    return loss_sum, loss_cnt


# ---------------------------------------------------------------------------
# The kernels.
# ---------------------------------------------------------------------------


def _declare_k5(lib: ctypes.CDLL) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.streamz_k5.argtypes = [
        p, p, p, p, p, i32, i32, p, p, p, p, p, p, p, i32, i32, i32, i32, i32, p, p, p,
        ctypes.c_float, p, p]
    lib.streamz_k5.restype = i32
    lib.streamz_k5_grad_size.argtypes = [i32, i32, i32, i32]
    lib.streamz_k5_grad_size.restype = ctypes.c_longlong
    lib.streamz_k5_parts.argtypes = [i32, i32, i32, i32, i32, i32]
    lib.streamz_k5_parts.restype = i32
    lib.streamz_k5_workspace.argtypes = [i32, i32, i32, i32, i32, i32]
    lib.streamz_k5_workspace.restype = ctypes.c_longlong


def _declare_k6(lib: ctypes.CDLL) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.streamz_file_train.argtypes = [
        p, p, i32, i32, i32, p, p, ctypes.c_float, p, p, p, p, p, p, i32, i32, i32,
        p, p, p]
    lib.streamz_file_train.restype = i32
    lib.streamz_file_train_rows.argtypes = [i32]
    lib.streamz_file_train_rows.restype = i32
    lib.streamz_file_train_cluster.argtypes = []
    lib.streamz_file_train_cluster.restype = i32
    lib.streamz_file_train_route.argtypes = [i32, i32, i32, i32, i32]
    lib.streamz_file_train_route.restype = i32
    lib.streamz_file_train_scratch.argtypes = [i32, i32, i32, i32, i32]
    lib.streamz_file_train_scratch.restype = ctypes.c_longlong


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_params(params: Params, device) -> Tuple[int, int, int, int]:
    F, H1 = params["w1"].shape
    H2, cap = params["w3"].shape
    shapes = {"w1": (F, H1), "b1": (H1,), "w2": (H1, H2), "b2": (H2,),
              "w3": (H2, cap), "b3": (cap,)}
    for k, shp in shapes.items():
        _check(k, params[k], torch.float32, shp, device)
    if any(d % 4 for d in (F, H1, H2, cap)):
        raise ValueError(f"widths {(F, H1, H2, cap)} must be multiples of 4")
    return F, H1, H2, cap


def _ns_tensor(num_speakers: NumSpeakers, device) -> torch.Tensor:
    """The live class count as the int32 device scalar the kernels read."""
    if isinstance(num_speakers, torch.Tensor):
        ns = num_speakers.reshape(()).to(device=device, dtype=torch.int32)
        return ns.contiguous()
    return torch.tensor(int(num_speakers), dtype=torch.int32, device=device)


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _k5(params: Params, rows: Rows, num_speakers: NumSpeakers, lr):
    """K5 on CUDA rows: the gradient sums (``lr`` None) as the flat buffer
    of :func:`corpus_rows_sums_k5`, or the step in place, returning the
    mean loss as a [1] tensor.  One launch."""
    dev = rows[0].device
    F, H1, H2, cap = _check_params(params, dev)
    if F > 64:
        raise ValueError(f"K5 takes feature widths up to 64, got {F}")
    if any(params[k].data_ptr() % 16 for k in PARAM_NAMES):
        raise ValueError("K5 takes parameters aligned to 16 bytes")
    if isinstance(rows, Batch):
        B = rows.x.shape[0] if rows.x.dim() == 2 else 0
        if B == 0:
            raise ValueError(f"K5 takes a non-empty [B, {F}] batch, got {tuple(rows.x.shape)}")
        _check("batch", rows.x, torch.float32, (B, F), dev)
        _check("labels", rows.labels, torch.int32, (B,), dev)
        _check("weights", rows.weights, torch.float32, (B,), dev)
        src = (rows.x, rows.labels, rows.weights, None, None)
        n_src, R = B, B
    else:
        N = rows.pool_x.shape[0]
        R = int(rows.n)
        _check("pool_x", rows.pool_x, torch.float32, (N, F), dev)
        _check("pool_y", rows.pool_y, torch.int32, (N,), dev)
        if rows.order.dim() != 1 or not 0 < R <= rows.order.shape[0]:
            raise ValueError(f"K5 takes 1 to {rows.order.shape[0]} real rows, got {R}")
        _check("order", rows.order, torch.int32, rows.order.shape, dev)
        if rows.keep is not None:
            _check("keep", rows.keep, torch.uint8, (R, F), dev)
        src = (rows.pool_x, rows.pool_y, None, rows.order, rows.keep)
        n_src = N
    ns = _ns_tensor(num_speakers, dev)
    lib = _cuda_build.load("corpus_grads", _declare_k5)
    parts = int(lib.streamz_k5_parts(R, F, H1, H2, cap, _sm_count(dev)))
    ws = torch.empty((int(lib.streamz_k5_workspace(R, F, H1, H2, cap, parts)),),
                     dtype=torch.float32, device=dev)
    size = int(lib.streamz_k5_grad_size(F, H1, H2, cap))
    # sums: [dw1 | db1 | dw2 | db2 | dw3 | db3 | loss, count, 0, 0]
    out = torch.empty((size + 4,) if lr is None else (1,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.streamz_k5(
            *(None if t is None else t.data_ptr() for t in src), n_src, R, ns.data_ptr(),
            *(params[k].data_ptr() for k in PARAM_NAMES), F, H1, H2, cap, parts,
            ws.data_ptr(), out.data_ptr() if lr is None else None,
            out[size:].data_ptr() if lr is None else None,
            0.0 if lr is None else float(lr), None if lr is None else out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"K5 (corpus_grads) launch failed: CUDA error {rc}")
    corpus_grads_k5.launches += 1
    return out


def _k5_device(rows: Rows) -> torch.device:
    dev = rows[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"K5 runs on CUDA or CPU tensors, got {dev}")
    return dev


def sums_size(params: Params) -> int:
    """The floats of K5's flat sums buffer: the gradients' and four more."""
    return sum(params[k].numel() for k in PARAM_NAMES) + 4


def split_sums(params: Params, flat: torch.Tensor):
    """(grads, loss_sum, count) as views of a flat sums buffer."""
    grads, off = {}, 0
    for k in PARAM_NAMES:
        n = params[k].numel()
        grads[k] = flat[off:off + n].view(params[k].shape)
        off += n
    return grads, flat[off], flat[off + 1]


def corpus_rows_sums_k5(params: Params, rows: Rows, num_speakers: NumSpeakers) -> torch.Tensor:
    """K5's sums form as one flat f32 buffer ``[dw1 | db1 | dw2 | db2 | dw3 |
    db3 | loss_sum, count, 0, 0]`` (``csrc/corpus_grads.cu``'s layout, of
    :func:`sums_size` floats), the one tensor a data-parallel step
    all-reduces.  :func:`split_sums` reads it."""
    if _k5_device(rows).type == "cpu":
        grads, loss_sum, count = corpus_grads_plain(params, *rows_plain(rows), num_speakers)
        return torch.cat([*(grads[k].reshape(-1) for k in PARAM_NAMES),
                          loss_sum.reshape(1), count.reshape(1), loss_sum.new_zeros(2)])
    return _k5(params, rows, num_speakers, None)


def corpus_rows_grads_k5(params: Params, rows: Rows, num_speakers: NumSpeakers):
    """K5's sums form: summed gradients + (loss_sum, count) over ``rows``.
    Bit-reproducible on one card."""
    if _k5_device(rows).type == "cpu":
        return corpus_grads_plain(params, *rows_plain(rows), num_speakers)
    return split_sums(params, _k5(params, rows, num_speakers, None))


def corpus_grads_k5(params: Params, batch: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor, num_speakers: NumSpeakers):
    """K5: summed gradients + (loss_sum, count) for one labelled batch
    (``batch`` [B, F] f32, ``labels`` [B] int32, ``weights`` [B] f32).  The
    gradient sums are bit-reproducible on one card.  ``.launches`` counts
    every K5 launch, through any entry point."""
    return corpus_rows_grads_k5(params, Batch(batch, labels, weights), num_speakers)


corpus_grads_k5.launches = 0


def corpus_step_k5(params: Params, rows: Rows, num_speakers: NumSpeakers, lr):
    """K5's step form: ``p -= lr / max(count, 1) * grad`` in place over
    ``rows`` (no update when count is 0); returns the mean loss
    ``loss_sum / max(count, 1)`` as a device scalar.  On the CPU the plain
    gather, gradients and :func:`_apply_step`."""
    if _k5_device(rows).type == "cpu":
        return _apply_step(params, *corpus_grads_plain(params, *rows_plain(rows),
                                                       num_speakers), lr)
    return _k5(params, rows, num_speakers, lr)[0]


# K6's routes, by what fits in a CTA's shared memory (csrc/file_train.cu).
K6_ROUTES = ("shared memory", "w3 in device memory", "device memory")


def k6_plan(F: int, H1: int, H2: int, capacity: int, B: int) -> Tuple[int, str]:
    """K6's cluster size and route for these widths and chunks of B windows
    (builds the kernel): every slice in the cluster's shared memory, w3 in
    device memory, or w1, w2, w3 and the activations in device memory.
    Chunks of more than 32 windows run as row tiles of 32 on any route."""
    lib = _cuda_build.load("file_train", _declare_k6)
    route = int(lib.streamz_file_train_route(F, H1, H2, capacity, B))
    if route < 0:
        raise ValueError(f"K6 takes feature widths up to 64, got {F}")
    return int(lib.streamz_file_train_cluster()), K6_ROUTES[route]


def train_windows_k6(params: Params, chunks: torch.Tensor, masks: torch.Tensor,
                     target_vec: torch.Tensor, num_speakers: NumSpeakers, lr: float):
    """K6: the per-file chunk loop in one launch, over chunks [S, B, F] f32
    with masks [S, B] f32, a target vector [capacity] and the live class
    count (an int or a device scalar, which the kernel reads on the card,
    so the caller never waits).  Updates ``params`` in place; returns
    (loss_sum, loss_count) device scalars.  S == 0 launches nothing."""
    if chunks.device.type == "cpu":
        return train_windows_plain(params, chunks, masks, target_vec,
                                   num_speakers, lr)
    if chunks.device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA or CPU tensors, got {chunks.device}")
    dev = chunks.device
    F, H1, H2, cap = _check_params(params, dev)
    if chunks.dim() != 3:
        raise ValueError(f"K6 takes [S, B, {F}] chunks, got {tuple(chunks.shape)}")
    S, B = chunks.shape[:2]
    _check("chunks", chunks, torch.float32, (S, B, F), dev)
    _check("masks", masks, torch.float32, (S, B), dev)
    _check("target_vec", target_vec, torch.float32, (cap,), dev)
    stats = torch.zeros((2,), dtype=torch.float32, device=dev)
    if S == 0:
        return stats[0], stats[1]
    if any(t.data_ptr() % 16 for t in (chunks, *params.values())):
        raise ValueError("K6 takes chunks and parameters aligned to 16 bytes")
    k6_plan(F, H1, H2, cap, B)
    lib = _cuda_build.load("file_train", _declare_k6)
    floats = int(lib.streamz_file_train_scratch(F, H1, H2, cap, B))
    scratch = torch.empty((floats,), dtype=torch.float32, device=dev) if floats else None
    ns = _ns_tensor(num_speakers, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.streamz_file_train(
            chunks.data_ptr(), masks.data_ptr(), S, B, F, target_vec.data_ptr(),
            ns.data_ptr(), float(lr), *(params[k].data_ptr() for k in PARAM_NAMES),
            H1, H2, cap, None if scratch is None else scratch.data_ptr(),
            stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"K6 (file_train) launch failed: CUDA error {rc}")
    train_windows_k6.launches += 1
    return stats[0], stats[1]


train_windows_k6.launches = 0
