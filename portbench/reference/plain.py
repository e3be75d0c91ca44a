"""The plain reference of the benchmark: the reference system's arithmetic in
plain PyTorch, float32 with TF32 off, on any device.

It imports nothing of ``streamz_tpu_torch``.  Its pieces are frozen from the
port's plain paths at commit 9a1a12a3fe3c and rewritten as straight loops:

- :func:`mfcc` is ``streamz_tpu_torch/dsp/mfcc_ref.py`` (the golden spec,
  ``streamz-rs/src/lib.rs:279-345``) as float32 products: the 800-point DFT
  as one product with a cosine and a sine basis, the mel filterbank and
  the DCT-II as products, deltas and the per-frame z-norm;
- :func:`init_params`, :func:`mlp_grads` and :func:`sgd` are
  ``nn/model.init_params`` and ``nn/train_kernels._mlp_grads``/``_sgd``
  (``src/lib.rs:744-790``, ``:954-1060``);
- :func:`train_corpus` is ``app/corpus.train_corpus`` with
  ``train_kernels.rows_plain``: the same ``np.random.default_rng`` draws;
- :func:`train_file` is ``nn/train.file_epoch_views`` with
  ``train_kernels.train_windows_plain``: the threefry draws of
  :mod:`portbench.reference.prng`, fully masked chunks skipped (they apply
  no update); :func:`train_files` runs it for many files side by side;
- :func:`decide` is ``app/device_loop._file_step``'s decision, written as
  ``app/incremental.run_incremental_host`` writes it;
- :func:`speaker_stats` and :func:`gate` are
  ``infer/cosine.compute_speaker_embeddings`` and
  ``identify_sims_cosine``.

Every product goes through :func:`mm`.  With ``tf32=True`` its operands
are rounded to TF32 (10 mantissa bits) first, as the tensor cores round
them: that is the benchmark's control, the nearest precision below the
float32 that the configuration states, the same on the CPU and the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import config, mel, prng

Params = Dict[str, torch.Tensor]
NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")
MASK_LOGIT = -1e30


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties away from 0."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """``a @ b`` in float32; with ``tf32`` the operands are TF32 first."""
    if tf32:
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


# ---------------------------------------------------------------------------
# The frontend.
# ---------------------------------------------------------------------------

_BASES: Dict[Tuple[str, str], Tuple[torch.Tensor, ...]] = {}


def _bases(device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    key = (str(device), "mfcc")
    if key not in _BASES:
        w = config.WINDOW_SIZE
        n = np.arange(w)[:, None]
        k = np.arange(w // 2 + 1)[None, :]
        ang = 2.0 * np.pi * ((n * k) % w) / w
        cos = torch.tensor(np.cos(ang), dtype=torch.float32, device=device)
        sin = torch.tensor(-np.sin(ang), dtype=torch.float32, device=device)
        fb = torch.tensor(mel.mel_filterbank().T, dtype=torch.float32, device=device)
        dct = torch.tensor(mel.dct2_matrix().T, dtype=torch.float32, device=device)
        _BASES[key] = (cos, sin, fb, dct)
    return _BASES[key]


def _deltas(x: torch.Tensor) -> torch.Tensor:
    prev = torch.cat([x[:1], x[:-1]])
    nxt = torch.cat([x[1:], x[-1:]])
    return (nxt - prev) / 2.0


def mfcc(pcm: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """One clip's PCM (float32 at the [-1, 1] scale, 1-D) → [windows, 60]."""
    w, hop = config.WINDOW_SIZE, config.HOP_SIZE
    if pcm.numel() < w:
        return torch.zeros((0, config.FEATURE_SIZE), device=pcm.device)
    cos, sin, fb, dct = _bases(pcm.device)
    frames = pcm.unfold(0, w, hop)
    re, im = mm(frames, cos, tf32), mm(frames, sin, tf32)
    power = re * re + im * im
    logmel = torch.log(torch.clamp(mm(power, fb, tf32), min=1e-12))
    base = mm(logmel, dct, tf32)
    d1 = _deltas(base)
    feats = torch.cat([base, d1, _deltas(d1)], dim=1)
    mean = feats.mean(dim=1, keepdim=True)
    std = torch.clamp(torch.sqrt(((feats - mean) ** 2).mean(dim=1, keepdim=True)), min=1e-6)
    return (feats - mean) / std


def pcm_to_f32(samples: np.ndarray) -> np.ndarray:
    """int16 PCM at the [-1, 1] scale (``src/lib.rs:167-169``)."""
    return np.asarray(samples, np.float32) / np.float32(32767.0)


# ---------------------------------------------------------------------------
# The MLP.
# ---------------------------------------------------------------------------


def round_capacity(n: int) -> int:
    return max(1, -(-int(n) // 128)) * 128


def init_params(output: int, seed: int = 0, device=None) -> Params:
    """U(-0.5, 0.5) weights and zero biases from ``default_rng(seed)``, w1,
    w2, w3 in that order, w3 at the 128-aligned capacity."""
    rng = np.random.default_rng(seed)
    cap = round_capacity(output)
    F, H1, H2 = config.FEATURE_SIZE, config.HIDDEN1, config.HIDDEN2
    out = {}
    for name, shape in (("w1", (F, H1)), ("b1", (H1,)), ("w2", (H1, H2)), ("b2", (H2,)),
                        ("w3", (H2, cap)), ("b3", (cap,))):
        v = (np.zeros(shape, np.float32) if name[0] == "b"
             else rng.uniform(-0.5, 0.5, size=shape).astype(np.float32))
        out[name] = torch.from_numpy(v).to(device)
    return out


def embed_relu(params: Params, x: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """The ReLU-h2 embedding of windows x [..., 60] (``src/lib.rs:1073-1079``)."""
    h1 = torch.relu(mm(x, params["w1"], tf32) + params["b1"])
    return torch.relu(mm(h1, params["w2"], tf32) + params["b2"])


def probs(params: Params, x: torch.Tensor, num_speakers: int, tf32: bool = False):
    """Masked softmax over the live classes (``src/lib.rs:880-891``)."""
    h1 = torch.relu(mm(x, params["w1"], tf32) + params["b1"])
    h2 = torch.tanh(mm(h1, params["w2"], tf32) + params["b2"])
    logits = mm(h2, params["w3"], tf32) + params["b3"]
    live = torch.arange(logits.shape[-1], device=x.device) < num_speakers
    p = torch.softmax(torch.where(live, logits, torch.full((), MASK_LOGIT, device=x.device)),
                      dim=-1)
    return p * live


def mlp_grads(params: Params, x, target, w, num_speakers, tf32: bool = False):
    """Gradient sums of the surrogate loss ``sum_i w_i (logsumexp - <t_i,
    logits_i>)``; returns (grads, probs).  ``x`` is [rows, F], or [files,
    rows, F] for files side by side, each with its own parameters (biases
    then [files, 1, H]) and ``num_speakers`` ([files, 1, 1])."""
    def tr(a):
        return a.transpose(-1, -2)

    h1 = torch.relu(mm(x, params["w1"], tf32) + params["b1"])
    h2 = torch.tanh(mm(h1, params["w2"], tf32) + params["b2"])
    logits = mm(h2, params["w3"], tf32) + params["b3"]
    live = torch.arange(logits.shape[-1], device=x.device) < num_speakers
    logits = torch.where(live, logits, torch.full((), MASK_LOGIT, device=x.device))
    p = torch.softmax(logits, dim=-1)
    delta = (p - target) * w[..., None] * live
    dh2 = mm(delta, tr(params["w3"]), tf32) * (1.0 - h2 * h2)
    dh1 = mm(dh2, tr(params["w2"]), tf32) * (h1 > 0.0)
    grads = {"w1": mm(tr(x), dh1, tf32), "b1": dh1.sum(-2).reshape(params["b1"].shape),
             "w2": mm(tr(h1), dh2, tf32), "b2": dh2.sum(-2).reshape(params["b2"].shape),
             "w3": mm(tr(h2), delta, tf32), "b3": delta.sum(-2).reshape(params["b3"].shape)}
    return grads, p


def sgd(params: Params, grads: Params, count: float, lr: float) -> None:
    """``p -= lr / count * grad``; nothing when count is 0."""
    if count <= 0:
        return
    scale = torch.tensor(lr, dtype=torch.float32) / torch.tensor(count, dtype=torch.float32)
    for k in NAMES:
        params[k].sub_(scale.to(params[k].device) * grads[k])


def train_corpus(params: Params, pool_x: torch.Tensor, pool_y: torch.Tensor,
                 num_speakers: int, *, epochs: int = config.TRAIN_EPOCHS,
                 batch_size: int = config.CORPUS_BATCH, lr: float = config.CORPUS_LR,
                 dropout: float = config.DEFAULT_DROPOUT, seed: int = 0,
                 tf32: bool = False, half: bool = False) -> Params:
    """The labelled files' corpus training (``src/main.rs:640-668``): per
    epoch a permutation and a dropout mask from ``default_rng(seed)``,
    steps of ``batch_size`` rows, a row dropped to all zeros skipped.
    ``half`` plants a fault for the check's readings: each step keeps the
    first half of its rows and takes the mean over them."""
    params = {k: v.clone() for k, v in params.items()}
    n = len(pool_x)
    if n == 0:
        return params
    dev = pool_x.device
    rng = np.random.default_rng(seed)
    cap = params["b3"].shape[0]
    cols = torch.arange(cap, device=dev)
    for _ in range(int(epochs)):
        order = torch.from_numpy(rng.permutation(n).astype(np.int64)).to(dev)
        keep = torch.from_numpy(
            rng.random((n, pool_x.shape[1]), dtype=np.float32) >= dropout).to(dev)
        for lo in range(0, n, batch_size):
            idx = order[lo:lo + batch_size]
            x = pool_x[idx] * keep[lo:lo + batch_size]
            y = pool_y[idx]
            w = (x != 0.0).any(dim=1).to(torch.float32)
            if half:
                w[(len(w) + 1) // 2:] = 0.0
            target = ((cols[None, :] == y[:, None]) & (y < num_speakers)[:, None]).float()
            grads, _ = mlp_grads(params, x, target, w, num_speakers, tf32)
            sgd(params, grads, float(w.sum()), lr)
    return params


def epoch_views(windows: torch.Tensor, n_valid: int, key: torch.Tensor, dropout: float,
                epochs: int):
    """Per epoch: the valid windows in a threefry-shuffled order, dropped
    feature by feature, and their keep flags (a window dropped to all
    zeros is skipped).  ``windows`` is [n_pad, F] with the first
    ``n_valid`` real (the JAX package's ``file_epoch_views``)."""
    n_pad, feat = windows.shape
    dev = windows.device
    ekeys = prng.split(key, epochs)
    sub = prng.split(ekeys, 2)
    real = torch.arange(n_pad, device=dev) < n_valid
    scores = torch.where(real, prng.uniform(sub[:, 0], (n_pad,)),
                         torch.full((), float("inf"), device=dev))
    order = torch.argsort(scores, dim=-1, stable=True)
    keep = prng.uniform(sub[:, 1], (n_pad, feat)) >= dropout
    dropped = torch.where(keep, windows[order], torch.zeros((), device=dev))
    valid = real & (dropped != 0.0).any(dim=-1)
    return dropped, valid.to(torch.float32)


def train_file(params: Params, windows: torch.Tensor, n_valid: int, target_class: int,
               num_speakers: int, key: torch.Tensor, lr: float, *,
               dropout: float = config.DEFAULT_DROPOUT,
               epochs: int = config.INCREMENTAL_EPOCHS,
               batch_size: int = config.BATCH_SIZE, tf32: bool = False,
               half: bool = False) -> Params:
    """One file of the discovery loop (``src/lib.rs:582-628``): ``epochs``
    shuffled, dropped passes in chunks of ``batch_size``, each chunk's mean
    gradient applied once.  The target is one-hot where the class is live.
    ``half`` plants a fault: each chunk keeps the first half of its rows."""
    params = {k: v.clone() for k, v in params.items()}
    n_pad, feat = windows.shape
    cap = params["b3"].shape[0]
    dropped, valid = epoch_views(windows, n_valid, key, dropout, epochs)
    target = torch.zeros(cap, device=windows.device)
    if 0 <= target_class < num_speakers:
        target[target_class] = 1.0
    n_chunks = n_pad // batch_size
    chunks = dropped.reshape(epochs * n_chunks, batch_size, feat)
    masks = valid.reshape(epochs * n_chunks, batch_size)
    if half:
        masks[:, (batch_size + 1) // 2:] = 0.0
    counts = masks.sum(dim=1).tolist()
    tgt = target.expand(batch_size, -1)
    for s, count in enumerate(counts):
        if count > 0:
            grads, _ = mlp_grads(params, chunks[s], tgt, masks[s], num_speakers, tf32)
            sgd(params, grads, count, lr)
    return params


def train_files(params: Sequence[Params], windows: Sequence[torch.Tensor],
                n_valid: Sequence[int], target_class: Sequence[int],
                num_speakers: Sequence[int], keys: Sequence[torch.Tensor],
                lrs: Sequence[float], *, dropout: float = config.DEFAULT_DROPOUT,
                epochs: int = config.INCREMENTAL_EPOCHS,
                batch_size: int = config.BATCH_SIZE, tf32: bool = False,
                half: bool = False) -> List[Params]:
    """:func:`train_file` of many files, each from its own parameters, side
    by side: files of one padded length step together through batched
    products.  A chunk with no row that counts applies no update."""
    out: List[Optional[Params]] = [None] * len(params)
    groups: Dict[int, List[int]] = {}
    for i, w in enumerate(windows):
        groups.setdefault(w.shape[0], []).append(i)
    for n_pad, idx in groups.items():
        B, feat, dev = len(idx), windows[idx[0]].shape[1], windows[idx[0]].device
        shapes = {k: params[idx[0]][k].shape for k in NAMES}
        P = {k: torch.stack([params[i][k] for i in idx]).reshape(
            (B, 1, -1) if k[0] == "b" else (B,) + shapes[k]).clone() for k in NAMES}
        views = [epoch_views(windows[i], n_valid[i], keys[i], dropout, epochs) for i in idx]
        steps = epochs * (n_pad // batch_size)
        chunks = torch.stack([d for d, _ in views]).reshape(B, steps, batch_size, feat)
        masks = torch.stack([v for _, v in views]).reshape(B, steps, batch_size)
        if half:
            masks[:, :, (batch_size + 1) // 2:] = 0.0
        cap = P["b3"].shape[-1]
        ns = torch.tensor([num_speakers[i] for i in idx], device=dev).reshape(B, 1, 1)
        tc = torch.tensor([target_class[i] for i in idx], device=dev).reshape(B, 1, 1)
        cols = torch.arange(cap, device=dev)
        target = ((cols == tc) & (tc >= 0) & (tc < ns)).to(torch.float32)
        target = target.expand(B, batch_size, cap)
        lr = torch.tensor([lrs[i] for i in idx], dtype=torch.float32, device=dev)
        counts = masks.sum(dim=2)
        for s in (counts > 0).any(dim=0).nonzero().flatten().tolist():
            grads, _ = mlp_grads(P, chunks[:, s], target, masks[:, s], ns, tf32)
            c = counts[:, s]
            scale = torch.where(c > 0, lr / c, torch.zeros((), device=dev))
            for k in NAMES:
                P[k].sub_(scale.reshape(B, 1, 1) * grads[k])
        for j, i in enumerate(idx):
            out[i] = {k: P[k][j].reshape(shapes[k]) for k in NAMES}
    return out  # type: ignore[return-value]


def file_key(k: int, device=None) -> torch.Tensor:
    """The discovery loop's key of its k-th file in a fresh process: the
    first key drawn, ``PRNGKey(1)``, folded with k."""
    return prng.fold_in(prng.PRNGKey(1, device=device), k)


def clip_embedding(params: Params, windows: torch.Tensor, tf32: bool = False):
    """Mean ReLU-h2 embedding, L2-normalized where its norm passes 1e-6."""
    s = embed_relu(params, windows, tf32).mean(dim=0)
    norm = torch.sqrt((s * s).sum())
    return s / norm if float(norm) > 1e-6 else s


def median_embedding(params: Params, windows: torch.Tensor, tf32: bool = False):
    """Per-dimension median ReLU-h2 embedding, the midpoint of the two
    middle values for an even count (``src/lib.rs:1474-1495``)."""
    e = torch.sort(embed_relu(params, windows, tf32), dim=0).values
    n = e.shape[0]
    return e[(n - 1) // 2] if n % 2 else 0.5 * (e[n // 2 - 1] + e[n // 2])


def normalize(v: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt((v * v).sum())
    return v / norm if float(norm) > 1e-6 else v


def cosines(embs: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Cosine of each embedding [n, h] with each centroid [s, h], 0 where a
    norm is 0."""
    ne = torch.sqrt((embs * embs).sum(dim=1))
    nc = torch.sqrt((cents * cents).sum(dim=1))
    denom = ne[:, None] * nc[None, :]
    dots = embs @ cents.T
    return torch.where(denom > 0, dots / torch.where(denom == 0, 1.0, denom),
                       torch.zeros((), device=embs.device))


def decide(emb: torch.Tensor, run_sum: torch.Tensor, run_cnt: torch.Tensor,
           num_speakers: int, k: int, label: Optional[int], burn_in_limit: int,
           max_speakers: int, threshold: float = config.DEFAULT_CONF_THRESHOLD):
    """The discovery loop's label for its k-th file (``src/main.rs:779-800``)
    from the centroids' running sums and counts before it: returns
    (speaker id, how far the similarities lay from another decision; +inf
    where none decided it).  A fresh model has no stored centroids."""
    burn = k < burn_in_limit
    thr = 0.5 if burn else threshold
    at_cap = num_speakers >= max_speakers
    if label is not None:
        return int(label), math.inf
    if burn and not at_cap:
        return num_speakers, math.inf
    seen = (run_cnt > 0).nonzero().flatten().tolist()
    if not seen:
        return (0 if at_cap else num_speakers), math.inf
    cents = run_sum[seen]
    sims = cosines(emb[None, :].double(), cents.double())[0]
    order = torch.argsort(sims, descending=True, stable=True)
    best = seen[int(order[0])]
    top = float(sims[order[0]])
    dyn = float(np.float32(0.7) * np.float32(thr)) if len(seen) < 20 else float(np.float32(thr))
    gap = top - float(sims[order[1]]) if len(seen) > 1 else math.inf
    margin = gap if at_cap else min(gap, abs(top - dyn))
    if at_cap or (top > dyn and best < num_speakers):
        return best, margin
    return num_speakers, margin


def speaker_stats(embeds: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, float, float]:
    """(centroid, mean similarity, its population std) of one speaker's
    file embeddings (``src/lib.rs:1555-1599``)."""
    e = torch.stack(list(embeds))
    mean = normalize(e.mean(dim=0))
    sims = cosines(e, mean[None, :])[:, 0]
    m = float(sims.mean())
    return mean, m, float(torch.sqrt(((sims - m) ** 2).mean()))


def gate(sims: np.ndarray, mean_sims: np.ndarray, std_sims: np.ndarray,
         threshold: float = config.DEFAULT_CONF_THRESHOLD) -> Tuple[Optional[int], float]:
    """The adaptive cosine gate of ``--identify`` (``src/lib.rs:1634-1661``):
    (speaker id or None, how far any similarity lies from a bound of the
    gate or the best two from each other)."""
    sims = np.asarray(sims, np.float64)
    factor = 0.3 if len(sims) < 200 else 1.0
    lo = mean_sims - 2.0 * std_sims
    dyn = mean_sims + std_sims * factor
    ok = (sims > 0.35) & ((sims > dyn) | (sims > 0.5)) & (sims >= lo) & (sims > threshold)
    cand = np.flatnonzero(ok)
    sid = None if cand.size == 0 else int(cand[np.argmax(sims[cand])])
    bounds = np.stack([lo, dyn, np.full_like(lo, 0.35), np.full_like(lo, 0.5),
                       np.full_like(lo, threshold)])
    top = np.sort(sims)[-2:]
    margin = float(min(np.abs(sims[None, :] - bounds).min(),
                       top[-1] - top[0] if len(top) > 1 else math.inf))
    return sid, margin

