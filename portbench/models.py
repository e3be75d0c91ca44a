"""The identification cells' ``model.npz``, made in set-up from
the seed by the benchmark's own code, so that no reference has to train.

w1, b1, w2 and b2 are the reference's initialisation (U(-0.5, 0.5) weights,
zero biases).  Each live ``w3`` column is its speaker's mean tanh-h2
embedding over its enrollment clips, centred on the speakers' mean and
scaled by one factor for all, chosen so that the mean probability of the
own speaker on the enrollment windows is ``OWN_PROB``, or ``NEAR_SUP`` of
the most that any scale reaches where that is less (with random first
layers a window's own speaker is the most likely one for only some of the
windows, so the mean probability cannot pass that share).  b3 is zero.  Each speaker's stored
(centroid, mean similarity, std) comes from its enrollment clips' median
ReLU-h2 embeddings, as the program's finalize computes them.  The file
follows the reference's ``model.npz`` schema (``src/lib.rs`` save/load).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from portbench import synth
from portbench.reference import plain

OWN_PROB = 0.95
NEAR_SUP = 0.95      # of the own-speaker probability the largest scale reaches
MAX_SCALE = 1e4
PROBE_WINDOWS = 32   # enrollment windows a speaker, for the scale's search


def make_model(cfg: dict, f0, env, gen: torch.Generator, dev, seed: int) -> dict:
    """Parameters and speaker statistics for ``cfg``'s speakers (voices
    ``f0``, ``env``): a dict of device tensors and numpy stats."""
    n_spk = cfg["speakers"]
    enr = cfg["enroll"]
    per, rate = enr["clips_per_speaker"], enr["rate"]
    spk = np.repeat(np.arange(n_spk), per)
    pcm = synth.synth_clips(f0, env, spk, gen, dev, rate, [int(enr["seconds"] * rate)] * len(spk))
    params = plain.init_params(n_spk, seed=seed % 2**63, device=dev)
    feats = [plain.mfcc(torch.from_numpy(plain.pcm_to_f32(p)).to(dev)) for p in pcm]
    h2_mean = torch.zeros(n_spk, params["w2"].shape[1], device=dev)
    probe = []
    for s in range(n_spk):
        x = torch.cat(feats[s * per:(s + 1) * per])
        h2 = torch.tanh(torch.relu(x @ params["w1"] + params["b1"]) @ params["w2"] + params["b2"])
        h2_mean[s] = h2.mean(dim=0)
        idx = torch.linspace(0, len(x) - 1, PROBE_WINDOWS, device=dev).long()
        probe.append(h2[idx])
    cols = h2_mean - h2_mean.mean(dim=0, keepdim=True)
    cols = cols / torch.linalg.norm(cols, dim=1, keepdim=True)
    probe_h2 = torch.stack(probe)                       # [S, P, H2]
    logits = probe_h2 @ cols.T                          # [S, P, S], before the scale
    own = torch.arange(n_spk, device=dev)

    def own_prob(scale: float) -> float:
        p = torch.softmax(scale * logits, dim=-1)
        return float(p[own, :, own].mean())

    target = min(OWN_PROB, NEAR_SUP * own_prob(MAX_SCALE))
    lo, hi = 0.0, MAX_SCALE
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if own_prob(mid) < target else (lo, mid)
    cap = params["b3"].shape[0]
    params["w3"] = torch.zeros(params["w3"].shape[0], cap, device=dev)
    params["w3"][:, :n_spk] = hi * cols.T
    params["b3"] = torch.zeros(cap, device=dev)
    stats = [plain.speaker_stats([plain.median_embedding(params, f) for f in
                                  feats[s * per:(s + 1) * per]]) for s in range(n_spk)]
    return {"params": params, "num_speakers": n_spk, "scale": hi,
            "centroids": torch.stack([c for c, _, _ in stats]).cpu().numpy(),
            "mean_sims": np.array([m for _, m, _ in stats], np.float32),
            "std_sims": np.array([s for _, _, s in stats], np.float32)}


def save_npz(model: dict, path: Path) -> None:
    """``model.npz`` in the reference's schema."""
    p = {k: v.detach().cpu().numpy() for k, v in model["params"].items()}
    ns = model["num_speakers"]
    arrays: Dict[str, np.ndarray] = {
        "w1": p["w1"], "b1": p["b1"], "w2": p["w2"], "b2": p["b2"],
        "sample_rate": np.array([44100], np.int64), "bits": np.array([16], np.int64),
        "num_speakers": np.array([ns], np.int64),
        "speaker_embeddings": model["centroids"].astype(np.float32),
        "speaker_mean_sims": model["mean_sims"], "speaker_std_sims": model["std_sims"]}
    for i in range(ns):
        arrays[f"w3_{i + 1}"] = np.ascontiguousarray(p["w3"][:, i])
        arrays[f"b3_{i + 1}"] = np.array([p["b3"][i]], np.float32)
        arrays[f"speaker_{i}_files"] = np.zeros(0, np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def utterance_lengths(cfg: dict, rng: np.random.Generator, n: int) -> List[int]:
    """Samples per utterance at the input rate: ``clip_seconds`` where the
    configuration fixes it, else lognormal with the configuration's mean,
    cut to its range."""
    rate = cfg["input_rate"]
    if "utterance_mean_s" not in cfg:
        return [int(cfg["identify"]["clip_seconds"] * rate)] * n
    sigma = cfg["utterance_sigma"]
    mu = np.log(cfg["utterance_mean_s"]) - sigma ** 2 / 2
    secs = np.clip(rng.lognormal(mu, sigma, n), cfg["utterance_min_s"], cfg["utterance_max_s"])
    return [int(s * rate) for s in secs]
