"""Driver ``identify``: ``--identify`` batches, back to back.

Set-up makes the configuration's voices from the seed, the model
(``portbench/models.py``) in a working directory as ``model.npz``, and a
pool of utterances written as WAVs at the configuration's input rate by
uniformly drawn speakers; it draws the batches (each ``batch`` utterances
of the pool, without repeats in a batch) and runs one batch to warm up.
The window runs ``streamz_tpu_torch.cli.main(["--identify", *paths])``
again and again, closed loop, from files on disk to the printed verdict
lines: the clips of every batch that started inside the window count,
over the time from the first batch's start to the last batch's end.

The check follows one batch drawn from the seed.  Hooks keep what the
program produced: the features (``cli.build_feature_map``),
the clip embeddings (``cli.batch_clip_embeddings``), the similarities
(``cli.cosine_matrix_many``) and the printed verdicts.  The plain
reference works each out again from the WAVs and the model's file: its
own decode and resampling (frozen copies), its own features.  The
resampled PCM is compared through the features: the port's native FFT
and numpy's agree to one step of int16, and a sample at a truncation
boundary can round either way (1 sample in 1 of 12 seeds, PERF.md).
"""

from __future__ import annotations

import re
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import glue, harness, models, roofline, synth
from portbench.reference import config as rc
from portbench.reference import plain
from portbench.reference import resample as refresample
from portbench.reference import wav as refwav

_VERDICT = re.compile(r"^(?P<path>.*): (?:speaker (?P<sid>\d+) \(similarity|unknown \()")


class State:
    def __init__(self):
        self.model_dir: Optional[Path] = None
        self.model: dict = {}
        self.pool: List[str] = []
        self.windows: Dict[str, int] = {}
        self.samples: Dict[str, int] = {}
        self.batches: List[List[str]] = []
        self.capture: Optional[dict] = None
        self.check_batch = 0
        self.argv: List[str] = []


def _install_hooks(state: State) -> None:
    from streamz_tpu_torch import cli
    from torch.profiler import record_function

    build_feature_map = glue.original(cli, "build_feature_map")
    embeddings = glue.original(cli, "batch_clip_embeddings")
    cosines = glue.original(cli, "cosine_matrix_many")

    def keep(name, value):
        if state.capture is not None:
            state.capture[name] = value
        return value

    def feature_hook(paths, *a, **k):
        with record_function("portbench.ingest_features"):
            out = build_feature_map(paths, *a, **k)
        keep("features", out[0])
        return out

    def embed_hook(*a, **k):
        with record_function("portbench.embed"):
            return keep("embeddings", embeddings(*a, **k))

    def cosine_hook(*a, **k):
        return keep("sims", cosines(*a, **k))

    cli.build_feature_map = feature_hook
    cli.batch_clip_embeddings = embed_hook
    cli.cosine_matrix_many = cosine_hook


def setup(ctx) -> State:
    cfg, wl = ctx.cell.config, ctx.cell.workload
    dev = torch.device(ctx.device)
    if dev.type == "cuda":
        glue.build(wl["kernels"])
    state = State()
    state.argv = [] if dev.type == "cuda" else ["--device", "cpu"]
    rng = np.random.default_rng(ctx.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    f0, env = synth.synth_speakers(rng, cfg["speakers"])
    state.model = models.make_model(cfg, f0, env, gen, dev, ctx.seed)
    state.model_dir = ctx.work / "model"
    state.model_dir.mkdir()
    models.save_npz(state.model, state.model_dir / "model.npz")
    ident = cfg["identify"]
    rate = cfg["input_rate"]
    spk = rng.integers(0, cfg["speakers"], ident["pool"])
    lengths = models.utterance_lengths(cfg, rng, ident["pool"])
    pcm = synth.synth_clips(f0, env, spk, gen, dev, rate, lengths)
    pool = ctx.work / "pool"
    pool.mkdir()
    for i, (s, p) in enumerate(zip(spk, pcm)):
        path = str(pool / f"u{i:04d}_s{s}.wav")
        refwav.write_wav(path, p, sample_rate=rate)
        state.pool.append(path)
        n44 = len(p) * rc.DEFAULT_SAMPLE_RATE // rate
        state.samples[path] = n44
        state.windows[path] = max(0, (n44 - rc.WINDOW_SIZE) // rc.HOP_SIZE + 1)
    state.batches = [[state.pool[j] for j in rng.choice(len(state.pool), ident["batch"],
                                                        replace=False)]
                     for _ in range(wl["batches_drawn"])]
    state.check_batch = int(rng.integers(0, wl["check"]["batches_drawn_from"]))
    _install_hooks(state)
    rc_, _, _ = glue.run_cli(state.argv + ["--identify", *state.batches[-1]], state.model_dir)
    if rc_ != 0:
        raise RuntimeError(f"the warm-up identify batch exited with {rc_}")
    ctx.log(f"frontend: {glue.frontend_choice()}; model scale {state.model['scale']:.4g}")
    return state


def window(state: State, ctx, run) -> dict:
    """``--identify`` batches back to back for ``ctx.seconds`` (traced: the
    workload's ``trace_units`` batches)."""
    limit = ctx.cell.workload["trace_units"] if ctx.trace else None
    units, failed = [], 0
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    while True:
        i = len(units)
        if (limit is not None and i >= limit) or (limit is None and i and
                                                   time.perf_counter() >= t_end):
            break
        paths = state.batches[i % len(state.batches)]
        state.capture = {} if i <= state.check_batch else None
        ts = time.perf_counter()
        rc_, report, lines = glue.run_cli(state.argv + ["--identify", *paths], state.model_dir)
        te = time.perf_counter()
        failed += len(paths) if rc_ != 0 else 0
        units.append({"paths": paths, "start": ts, "end": te, "clips": len(paths),
                      "phase_seconds": dict(report.get("phase_seconds", {})),
                      "lines": lines if state.capture is not None else None,
                      "capture": state.capture, "work": _work(state, paths)})
    state.capture = None
    keep = min(state.check_batch, len(units) - 1)
    for i, u in enumerate(units):
        if i != keep:
            u["capture"] = u["lines"] = None
    run.units = units
    ctx.log(f"batches: {len(units)}, seconds each "
            + harness.spread([u["end"] - u["start"] for u in units]))
    return {"units": units, "elapsed": units[-1]["end"] - t0, "checked": keep,
            "attempted": sum(len(u["paths"]) for u in units), "failed": failed}


def end_to_end(out: dict, ctx) -> dict:
    return {"identify_clips_per_s": (out["attempted"] - out["failed"]) / out["elapsed"]}


def _work(state: State, paths: List[str]) -> Dict[str, roofline.Work]:
    wins = [state.windows[p] for p in paths]
    dims = (rc.FEATURE_SIZE, rc.HIDDEN1, rc.HIDDEN2, state.model["params"]["b3"].shape[0])
    return {"frontend": roofline.frontend(wins, sum(state.samples[p] for p in paths)),
            "embed": roofline.embed_windows(sum(wins), dims)}


def _reference(state: State, paths: List[str], dev, tf32: bool) -> dict:
    pcm, feats, embs = {}, {}, []
    for p in paths:
        samples, rate, _ = refwav.read_wav(p)
        pcm[p] = refresample.resample_to_44100(samples, rate)
        feats[p] = plain.mfcc(torch.from_numpy(plain.pcm_to_f32(pcm[p])).to(dev), tf32)
        embs.append(plain.normalize(plain.embed_relu(state.model["params"], feats[p],
                                                     tf32).mean(dim=0)))
    cents = torch.from_numpy(state.model["centroids"]).to(dev)
    e = torch.stack(embs)
    if tf32:
        e, cents = plain.to_tf32(e), plain.to_tf32(cents)
    sims = plain.cosines(e, cents).cpu().numpy()
    return {"features": feats, "embeddings": e, "sims": sims,
            "verdicts": [plain.gate(r, state.model["mean_sims"], state.model["std_sims"])
                         for r in sims]}


def _program(state: State, unit: dict, dev) -> dict:
    cap = unit["capture"]
    printed = {}
    for line in unit["lines"]:
        m = _VERDICT.match(line)
        if m:
            printed[m["path"]] = None if m["sid"] is None else int(m["sid"])
    emb = torch.from_numpy(np.stack(cap["embeddings"])).to(dev)
    emb = emb / torch.linalg.norm(emb, dim=1, keepdim=True).clamp(min=1e-30)
    return {"features": {p: torch.from_numpy(np.asarray(f)).to(dev)
                         for p, f in cap["features"].items()},
            "embeddings": emb, "sims": np.asarray(cap["sims"]),
            "verdicts": [(printed.get(p, -1), None) for p in unit["paths"]]}


def _compare(got: dict, ref: dict, paths: List[str], margin_floor: float) -> List[tuple]:
    """The features (each side's from its own decoded and resampled PCM,
    so a fault in ingest shows here), the embeddings, the similarities, and
    the verdicts where the reference's similarities are not a near tie."""
    feat = max(float((got["features"][p] - ref["features"][p]).abs().max()) for p in paths)
    emb = float((got["embeddings"] - ref["embeddings"]).abs().max())
    sim = float(np.abs(got["sims"] - ref["sims"]).max())
    flips = sum(1 for (g, _), (r, margin) in zip(got["verdicts"], ref["verdicts"])
                if margin > margin_floor and g != r)
    return [("feat_gap", feat), ("emb_gap", emb),
            ("sim_gap", sim), ("verdict_flips", float(flips))]


def _numbers(state: State, out: dict, ctx, control: bool) -> List[tuple]:
    dev = torch.device(ctx.device)
    unit = out["units"][out["checked"]]
    ref = _reference(state, unit["paths"], dev, tf32=False)
    got = (_reference(state, unit["paths"], dev, tf32=True) if control
           else _program(state, unit, dev))
    return _compare(got, ref, unit["paths"], ctx.cell.workload["check"]["decision_margin"])


def check(state: State, out: dict, ctx) -> List[tuple]:
    """(name, value) of each number compared, program against reference."""
    return _numbers(state, out, ctx, control=False)


def control(state: State, out: dict, ctx) -> List[tuple]:
    """The same numbers with the reference in TF32 in the program's place."""
    return _numbers(state, out, ctx, control=True)
