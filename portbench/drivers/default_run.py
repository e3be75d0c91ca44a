"""Driver ``default_run``: the default training run, back to back.

Set-up makes the configuration's corpus from the seed (synthetic voices on
the card), writes it as WAVs once, and runs one default run to warm up
(the frontend probe, the kernels' loads).  The window then runs
``streamz_tpu_torch.cli.main([])`` again and again, closed loop, each in a
fresh working directory holding only ``train_files.txt`` (absolute paths,
some clips labelled), as a user's first run in a new directory: the clips
of every run that started inside the window count, over the time from
the first run's start to the last run's end.  Each run starts with the
port's process-wide key counter at 0, as a fresh process does.

The check follows one run drawn from the seed.  Hooks on three functions
of the program keep what it produced: the frontend's features
(``cli.build_feature_map``), the parameters after corpus training
(``app.corpus.train_corpus``), and, for every file of the discovery loop
(``app.device_loop._file_step``), its windows, the parameters before it,
its embedding and its speaker.  The plain reference (``portbench/reference``)
then works out: the features from the WAVs; the corpus training from the
same initialisation on its own features; for every file, its embedding
and its training from the program's parameters before it (the discovery
loop can only be followed from the program's own state: it is chaotic in
its labels), and its label from the reference's own centroid sums, kept
along the speakers that the program wrote; and ``model.npz``'s speaker
statistics from its parameters on the reference's own features.
"""

from __future__ import annotations

import math
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import glue, harness, roofline, synth
from portbench.reference import config as rc
from portbench.reference import plain
from portbench.reference import wav as refwav


class State:
    """Set-up's products and the hooks' captures."""

    def __init__(self):
        self.paths: List[str] = []
        self.labels: List[Optional[int]] = []
        self.pcm: List[np.ndarray] = []
        self.train_text = ""
        self.capture: Optional[dict] = None
        self.runs_dir: Optional[Path] = None
        self.argv: List[str] = []
        self.check_run = 0


def _install_hooks(state: State) -> None:
    """Wrap the three functions whose results the check follows, and two
    more for their spans in the traced run."""
    from streamz_tpu_torch import cli
    from streamz_tpu_torch.app import corpus, device_loop
    from torch.profiler import record_function

    build_feature_map = glue.original(cli, "build_feature_map")
    train_corpus = glue.original(corpus, "train_corpus")
    file_step = glue.original(device_loop, "_file_step")
    run_incremental = glue.original(cli, "run_incremental")
    finalize_and_save = glue.original(cli, "finalize_and_save")

    def feature_hook(paths, *a, **k):
        with record_function("portbench.ingest_features"):
            out = build_feature_map(paths, *a, **k)
        if state.capture is not None:
            state.capture["features"] = out[0]
        return out

    def corpus_hook(net, windows, labels, **k):
        with record_function("portbench.corpus"):
            out = train_corpus(net, windows, labels, **k)
        if state.capture is not None:
            state.capture["corpus"] = {n: v.detach().clone() for n, v in net.params.items()}
            state.capture["corpus_ns"] = int(net.num_speakers)
        return out

    def file_hook(st, windows, n_valid, label, *a, **k):
        files = None if state.capture is None else state.capture.setdefault("files", [])
        if files is not None:
            rec = {"windows": windows, "n": int(n_valid), "label": int(label),
                   "before": {n: v.clone() for n, v in st[0].items()}}
        out = file_step(st, windows, n_valid, label, *a, **k)
        if files is not None:
            rec["sid"], rec["emb"] = out[0], out[2]
            files.append(rec)
        return out

    def discovery_hook(*a, **k):
        with record_function("portbench.discovery"):
            return run_incremental(*a, **k)

    def finalize_hook(*a, **k):
        with record_function("portbench.finalize"):
            return finalize_and_save(*a, **k)

    cli.build_feature_map = feature_hook
    corpus.train_corpus = corpus_hook
    device_loop._file_step = file_hook
    cli.run_incremental = discovery_hook
    cli.finalize_and_save = finalize_hook


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
    corpus = cfg["corpus"]
    n_spk, per = cfg["speakers"], corpus["clips_per_speaker"]
    rate = cfg["input_rate"]
    f0, env = synth.synth_speakers(rng, n_spk)
    spk = np.repeat(np.arange(n_spk), per)
    state.pcm = synth.synth_clips(f0, env, spk, gen, dev, rate,
                                  [int(corpus["clip_seconds"] * rate)] * len(spk))
    clips = ctx.work / "clips"
    clips.mkdir()
    lines = []
    for i, s in enumerate(spk):
        path = str(clips / f"c{i:03d}_s{s}.wav")
        refwav.write_wav(path, state.pcm[i], sample_rate=rate)
        lab = int(s) if i % per < corpus["labelled_per_speaker"] else None
        state.paths.append(path)
        state.labels.append(lab)
        lines.append(path if lab is None else f"{path},{lab}")
    state.train_text = "\n".join(lines) + "\n"
    state.check_run = int(rng.integers(0, wl["check"]["runs_drawn_from"]))
    state.runs_dir = ctx.work / "runs"
    state.runs_dir.mkdir()
    _install_hooks(state)
    rc_, _, _ = _one_run(state, "warm")
    if rc_ != 0:
        raise RuntimeError(f"the warm-up default run exited with {rc_}")
    ctx.log(f"frontend: {glue.frontend_choice()}")
    return state


def _one_run(state: State, tag: str):
    """One default run in a fresh directory; returns (rc, report, dir)."""
    from streamz_tpu_torch.nn import drivers

    d = state.runs_dir / tag
    d.mkdir()
    (d / "train_files.txt").write_text(state.train_text)
    drivers._key_counter[0] = 0
    rc_, report, _ = glue.run_cli(state.argv, d)
    return rc_, report, d


def window(state: State, ctx, run) -> dict:
    """Default runs back to back for ``ctx.seconds`` (traced: the
    workload's ``trace_units`` runs)."""
    limit = ctx.cell.workload["trace_units"] if ctx.trace else None
    units, failed = [], 0
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    while True:
        i = len(units)
        if (limit is not None and i >= limit) or (limit is None and i and
                                                   time.perf_counter() >= t_end):
            break
        state.capture = {} if i <= state.check_run else None
        ts = time.perf_counter()
        rc_, report, d = _one_run(state, f"r{i}")
        te = time.perf_counter()
        failed += rc_ != 0
        units.append({"rc": rc_, "dir": d, "report": report, "start": ts, "end": te,
                      "clips": len(state.paths),
                      "capture": state.capture})
    state.capture = None
    elapsed = units[-1]["end"] - t0
    work = _work(state)
    for u in units:
        u["phase_seconds"] = dict(u["report"].pop("phase_seconds", {}))
        u["work"] = work
        u.pop("report")
    keep = min(state.check_run, len(units) - 1)
    for i, u in enumerate(units):
        if i != keep:
            u["capture"] = None
            shutil.rmtree(u["dir"], ignore_errors=True)
    run.units = units
    ctx.log(f"default runs: {len(units)}, seconds each "
            + harness.spread([u["end"] - u["start"] for u in units]))
    return {"units": units, "elapsed": elapsed, "attempted": len(units) * len(state.paths),
            "failed": failed * len(state.paths), "checked": keep}


def end_to_end(out: dict, ctx) -> dict:
    n = out["attempted"] - out["failed"]
    return {"train_clips_per_s": n / out["elapsed"]}


def _work(state: State) -> Dict[str, roofline.Work]:
    """The functions' work of one default run, counted from the shapes of
    its inputs: the frontend on every clip; the corpus steps over the
    labelled clips' windows; per file, the embedding forward and the chunk
    steps (every window valid, chunks of 8, 5 epochs); finalize's
    embedding forward of every clip."""
    wins = [max(0, (len(p) - rc.WINDOW_SIZE) // rc.HOP_SIZE + 1) for p in state.pcm]
    cap = plain.round_capacity(len({x for x in state.labels if x is not None}) + 10)
    dims = (rc.FEATURE_SIZE, rc.HIDDEN1, rc.HIDDEN2, cap)
    pool = sum(w for w, lab in zip(wins, state.labels) if lab is not None)
    per_epoch = [min(rc.CORPUS_BATCH, pool - lo) for lo in range(0, pool, rc.CORPUS_BATCH)]
    corpus = roofline.corpus_steps(per_epoch * rc.TRAIN_EPOCHS, rc.CORPUS_BATCH, dims)
    k6 = roofline.Work()
    for w in wins:
        chunks = 1 << max(0, math.ceil(math.log2(max(1, -(-w // rc.BATCH_SIZE)))))
        rows = np.arange(chunks * rc.BATCH_SIZE) < w
        masks = np.tile(rows.reshape(chunks, rc.BATCH_SIZE), (rc.INCREMENTAL_EPOCHS, 1))
        k6 = k6 + roofline.file_train(masks, dims)
    return {"frontend": roofline.frontend(wins, sum(len(p) for p in state.pcm)),
            "corpus": corpus, "k6": k6,
            # the discovery loop's embeddings and finalize's, of every clip
            "embed": roofline.embed_windows(2 * sum(wins), dims)}


# ---------------------------------------------------------------------------
# The check.
# ---------------------------------------------------------------------------


def _leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              start: Dict[str, torch.Tensor], live: int) -> float:
    """The worst leaf's ||got - want|| over ||want - start||: how far the
    program's parameters lie from the reference's, against how far the
    reference moved them; w3 and b3 over the live classes only."""
    worst = 0.0
    for k in plain.NAMES:
        g, w, s = (t[k].double() for t in (got, want, start))
        if k in ("w3", "b3"):
            g, w, s = (x[..., :live] for x in (g, w, s))
        moved = float(torch.linalg.norm(w - s))
        if moved > 0:
            worst = max(worst, float(torch.linalg.norm(g - w)) / moved)
    return worst


def _npz_params(z, dev) -> Dict[str, torch.Tensor]:
    ns = int(z["num_speakers"][0])
    w3 = np.stack([z[f"w3_{i + 1}"] for i in range(ns)], axis=1)
    b3 = np.array([z[f"b3_{i + 1}"][0] for i in range(ns)], np.float32)
    out = {k: z[k] for k in ("w1", "b1", "w2", "b2")}
    out.update(w3=w3, b3=b3)
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
            for k, v in out.items()}


def _written_labels(unit: dict) -> List[Optional[int]]:
    labels = []
    for line in (unit["dir"] / "train_files.txt").read_text().splitlines():
        parts = line.split(",")
        labels.append(int(parts[1]) if len(parts) > 1 else None)
    return labels


def _program_side(state: State, unit: dict, dev) -> dict:
    """What the checked run produced, as the comparison reads it: every
    file's embedding and the parameters after it (those before the next
    file; after the last, ``model.npz``'s), its written labels, its
    statistics."""
    cap = unit["capture"]
    z = np.load(unit["dir"] / "model.npz")
    final = _npz_params(z, dev)
    recs = cap["files"]
    files = [(rec["emb"].float(), recs[k + 1]["before"] if k + 1 < len(recs) else final)
             for k, rec in enumerate(recs)]
    ns = int(z["num_speakers"][0])
    return {"features": {p: torch.from_numpy(np.asarray(f)).to(dev)
                         for p, f in cap["features"].items()},
            "corpus": cap["corpus"], "files": files, "labels": _written_labels(unit),
            "final": (torch.from_numpy(z["speaker_embeddings"][:ns]).to(dev),
                      z["speaker_mean_sims"][:ns].astype(np.float64),
                      z["speaker_std_sims"][:ns].astype(np.float64))}


def _reference_side(state: State, unit: dict, dev, tf32: bool, half: bool = False) -> dict:
    """The plain reference's answers to the same inputs (``tf32``: the
    control, its products in TF32; ``half``: a planted fault, each training
    step over half of its rows).  Its own features feed its corpus training
    and finalize's statistics; the discovery loop's files start from the
    program's parameters before each (``feat_gap`` holds the windows they
    train on)."""
    cap = unit["capture"]
    feats = {}
    for p in state.paths:
        samples, _, _ = refwav.read_wav(p)
        x = torch.from_numpy(plain.pcm_to_f32(samples)).to(dev)
        feats[p] = plain.mfcc(x, tf32=tf32)
    labelled = [(p, c) for p, c in zip(state.paths, state.labels) if c is not None]
    n_spk = len({c for _, c in labelled})
    init = plain.init_params(n_spk, seed=0, device=dev)
    pool_x = torch.cat([feats[p] for p, _ in labelled])
    pool_y = torch.cat([torch.full((len(feats[p]),), c, dtype=torch.int64, device=dev)
                        for p, c in labelled])
    corpus = plain.train_corpus(init, pool_x, pool_y, n_spk, tf32=tf32, half=half)

    recs = cap["files"]
    n = len(recs)
    burn = min(max(math.ceil(n * rc.DEFAULT_BURN_IN_FRAC), 10), 50)
    max_sp = n_spk + 10
    width = int(recs[0]["before"]["b3"].shape[0])
    run_sum = torch.zeros((width, rc.HIDDEN2), device=dev)
    run_cnt = torch.zeros((width,), device=dev)
    ns, embs, decisions, live = n_spk, [], [], []
    for k, rec in enumerate(recs):
        emb = plain.clip_embedding(rec["before"], rec["windows"][:rec["n"]], tf32)
        decisions.append(plain.decide(emb, run_sum, run_cnt, ns, k, state.labels[k],
                                      burn, max_sp))
        sid = int(rec["sid"])  # the program's speaker keeps both on one path
        ns += state.labels[k] is None and sid == ns
        run_sum[sid] += emb
        run_cnt[sid] += 1.0
        embs.append(emb)
        live.append(ns)
    afters = plain.train_files(
        [r["before"] for r in recs], [r["windows"] for r in recs], [r["n"] for r in recs],
        [int(r["sid"]) for r in recs], live, [plain.file_key(k, dev) for k in range(n)],
        [rc.LR_EARLY if k < rc.LR_SWITCH_COUNT else rc.LR_LATE for k in range(n)],
        tf32=tf32, half=half)

    z = np.load(unit["dir"] / "model.npz")
    final_params = _npz_params(z, dev)
    stats = []
    for i in range(int(z["num_speakers"][0])):
        names = bytes(z[f"speaker_{i}_files"]).decode().split("\n")
        medians = [plain.median_embedding(final_params, feats[p], tf32) for p in names if p]
        stats.append(plain.speaker_stats(medians) if medians else
                     (torch.zeros(rc.HIDDEN2, device=dev), 0.0, 0.0))
    return {"features": feats, "corpus": corpus, "init": init, "n_live": n_spk,
            "files": list(zip(embs, afters)), "befores": [r["before"] for r in recs],
            "live": live, "decisions": decisions, "labels": [d[0] for d in decisions],
            "final": (torch.stack([s[0] for s in stats]),
                      np.array([s[1] for s in stats]), np.array([s[2] for s in stats]))}


def _compare(got: dict, ref: dict, margin_floor: float) -> Dict[str, float]:
    """The features; the corpus-trained parameters; every file's embedding
    and parameters after it; finalize's statistics; and every file's label
    where the reference's similarities are not a near tie."""
    feat = max(float((got["features"][p] - ref["features"][p]).abs().max())
               for p in ref["features"])
    corpus = _leaf_gap(got["corpus"], ref["corpus"], ref["init"], ref["n_live"])
    file_gap = emb_gap = 0.0
    for (emb_g, after_g), (emb_r, after_r), before, live in zip(
            got["files"], ref["files"], ref["befores"], ref["live"]):
        emb_gap = max(emb_gap, float((plain.normalize(emb_g) - emb_r).abs().max()))
        file_gap = max(file_gap, _leaf_gap(after_g, after_r, before, live))
    cg, mg, sg = got["final"]
    cr, mr, sr = ref["final"]
    final = max(float((cg - cr).abs().max()), float(np.abs(mg - mr).max()),
                float(np.abs(sg - sr).max()))
    flips = sum(1 for g, (r, margin) in zip(got["labels"], ref["decisions"])
                if margin > margin_floor and g != r)
    return {"feat_gap": feat, "corpus_gap": corpus, "file_gap": file_gap,
            "emb_gap": emb_gap, "final_gap": final, "label_flips": float(flips)}


def _numbers(state: State, out: dict, ctx, side: str) -> List[tuple]:
    """The numbers compared: the program's answers (``side`` "program"),
    the control's ("control": the reference in TF32) or a planted fault's
    ("half": the reference training on half of each step's rows), each
    against the reference."""
    dev = torch.device(ctx.device)
    unit = out["units"][out["checked"]]
    ref = _reference_side(state, unit, dev, tf32=False)
    got = (_program_side(state, unit, dev) if side == "program" else
           _reference_side(state, unit, dev, tf32=side == "control", half=side == "half"))
    return list(_compare(got, ref, ctx.cell.workload["check"]["decision_margin"]).items())


def check(state: State, out: dict, ctx) -> List[tuple]:
    """(name, value) of each number compared, program against reference."""
    return _numbers(state, out, ctx, "program")


def control(state: State, out: dict, ctx) -> List[tuple]:
    """The same numbers with the reference in TF32 in the program's place."""
    return _numbers(state, out, ctx, "control")


def faults(state: State, out: dict, ctx) -> dict:
    """The numbers under the faults a training cell can have, at the cell's
    own size: half of each step's rows left out; every step returning its
    state unchanged; an answer altered where it is produced (each
    speaker's stored statistics written for the next speaker, and the last
    file's label for the next speaker)."""
    dev = torch.device(ctx.device)
    unit = out["units"][out["checked"]]
    floor = ctx.cell.workload["check"]["decision_margin"]
    ref = _reference_side(state, unit, dev, tf32=False)
    unchanged = dict(ref, corpus=ref["init"],
                     files=[(e, b) for (e, _), b in zip(ref["files"], ref["befores"])])
    cents, means, stds = ref["final"]
    labels = list(ref["labels"])
    labels[-1] = (labels[-1] or 0) + 1
    altered = dict(ref, labels=labels,
                   final=(cents.roll(1, 0), np.roll(means, 1), np.roll(stds, 1)))
    return {"half": dict(_numbers(state, out, ctx, "half")),
            "unchanged": _compare(unchanged, ref, floor),
            "altered": _compare(altered, ref, floor)}
