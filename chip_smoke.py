#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (streamz_tpu_torch) runs on a GPU.

    python3 chip_smoke.py        # from the root of a checkout, one NVIDIA GPU

Phases (each runs uncaught: any failure exits non-zero without a result):

1. Build K1, K5 and K6 (``streamz_tpu_torch/csrc/{mfcc_base,corpus_grads,
   file_train}.cu``) with nvcc for sm_90a, one nvcc per source, at once.
2. Hold K1 against its plain PyTorch version on the card at the launcher's
   edge shapes, a clip shorter than one block and the main-path shape,
   within 1e-3 on the base MFCCs.
3. Hold K5 against its plain version at the corpus training's shape
   (4096 windows, capacity 128) and a ragged batch, and at capacities 1024
   and 4096: gradient sums within 1e-4 of the largest |grad|, the loss sum
   within 1e-4 relative, the count exact, two runs bit-identical.  Hold K6
   against its plain version on one main-path file (a 10 s clip: 1280 chunk
   steps): parameters within 1e-3, the loss sum within 1e-3 relative, the
   count exact.
4. The default training run, ``python -m streamz_tpu_torch`` (``cli.main([])``),
   at full width (60→512→256, capacity 128) on 64 seeded synthetic 10 s
   clips at 44.1 kHz of 8 synthetic speakers, 2 clips of each labelled:
   ingest, K1, corpus training through K5 (100 epochs, batch 4096),
   the discovery loop through K6 (one launch per processed file),
   ``model.npz`` and the relabelled lists.  The launch counts of K1, K5 and
   K6 are zeroed just before and read just after; each must have moved.
5. ``--identify`` (``cli.main(["--identify", ...])``) of 64 held-out clips
   against the trained model, with K1's count zeroed and read; prints how
   many clips it gives their own speaker.
6. The gated vote pipeline (``identify_speaker_list_batch``) on those clips.
7. The GPU path against the CPU path on 8 clips (features, embeddings,
   similarities, and the gate's verdicts wherever the similarities lie
   farther from a gate bound than the two paths differ).
8. The same bare run at a reduced size (16 clips of 2 s, 4 speakers) on the
   CPU (plain versions) and on the GPU (kernels): the same labels for every
   file up to the first whose decision margin is within 1e-3 of a change.
9. Time K1, K5 and K6 per launch with CUDA events against their bounds and
   their plain versions, and the default run by phase (ingest, features,
   corpus, discovery, finalize) with synchronised timers.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Writes the same
numbers to ``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no
result, without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CSRC = HERE / "streamz_tpu_torch" / "csrc"
SOURCES = {"mfcc_base": "K1", "corpus_grads": "K5", "file_train": "K6"}

N_SPEAKERS = 8
CLIPS_PER_SPEAKER = 8
LABELLED_PER_SPEAKER = 2
CLIP_SECONDS = 10
RATE = 44_100
SEED = 0
K1_TOL = 1e-3          # base MFCCs: the frontend's golden gate
K5_TOL = 1e-4          # gradient sums relative to the largest |grad|; loss sum relative
K6_TOL = 1e-3          # parameters (abs) and loss sum (relative) after 1280 steps
GPU_VS_CPU_TOL = 1e-3  # features / embeddings / sims / margins, GPU vs CPU
# Published H100 SXM peaks (NVIDIA data sheet, dense): FP32 on the CUDA
# cores, TF32 on the tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else "unknown"


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, nbytes: float):
    """The least time the card could take: (ms, 'operations' or 'bytes')."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def synth_speakers(rng: np.random.Generator, n: int):
    """Per speaker: a fundamental and a harmonic envelope."""
    f0 = rng.uniform(90.0, 260.0, n)
    env = rng.uniform(0.05, 1.0, (n, 24)) * (0.85 ** np.arange(24))[None, :]
    return f0, env


def synth_clips(f0, env, speakers, gen: torch.Generator, dev,
                seconds: int = CLIP_SECONDS) -> np.ndarray:
    """[n, seconds] int16 voices made on the card: harmonics of the
    speaker's f0 under its envelope, with vibrato, syllable-rate amplitude
    modulation and noise.  Phases, jitter and noise come from ``gen``."""
    n = len(speakers)
    t = torch.arange(seconds * RATE, device=dev, dtype=torch.float64) / RATE
    f0s = torch.tensor(f0[speakers], device=dev) * (
        1 + 0.03 * torch.rand(n, device=dev, generator=gen, dtype=torch.float64))
    envs = torch.tensor(env[speakers], device=dev)  # [n, H]
    H = envs.shape[1]
    vib = 0.01 * torch.sin(2 * math.pi * 5.0 * t)[None, :]  # [1, S]
    phase0 = 2 * math.pi * torch.rand(n, H, device=dev, generator=gen, dtype=torch.float64)
    out = torch.zeros(n, t.numel(), device=dev, dtype=torch.float64)
    base_phase = 2 * math.pi * (t[None, :] + vib.cumsum(1) / RATE) * f0s[:, None]
    for h in range(H):
        out += envs[:, h:h + 1] * torch.sin((h + 1) * base_phase + phase0[:, h:h + 1])
    syll = 0.6 + 0.4 * torch.sin(
        2 * math.pi * 3.0 * t[None, :]
        + 2 * math.pi * torch.rand(n, 1, device=dev, generator=gen, dtype=torch.float64))
    out = out * syll + 0.02 * torch.randn(out.shape, device=dev, generator=gen,
                                         dtype=torch.float64)
    out = out / out.abs().amax(dim=1, keepdim=True) * 14000.0
    return out.round().clamp(-32768, 32767).to(torch.int16).cpu().numpy()


def k1_ops_and_bytes(B: int, T: int, mel_weights: int):
    """Operations and bytes of the MFCC base on [B, T] PCM, counted from the
    function (not the kernel): the [400 x 802] block DFT per block row, the
    combine and power, the mel product over the filterbank's ``mel_weights``
    nonzero weights (each filter's contiguous bin range), the log and the
    [26 -> 20] DCT per window; each input read once, the output written once."""
    nb = T // 400
    rows, wins = B * nb, B * max(nb - 1, 0)
    ops = (2 * rows * 400 * 802 + wins * 401 * 7 + 2 * wins * mel_weights
           + wins * 26 + 2 * wins * 26 * 20)
    nbytes = 4 * (B * T + wins * 20 + 400 * 802 + mel_weights + 3 * 26 + 26 * 20)
    return ops, nbytes


def mlp_row_ops(F: int, H1: int, H2: int, cap: int) -> int:
    """Multiply-adds (2 operations each) of one row's forward, data backward
    (dh2, dh1) and weight gradients; the elementwise work (activations,
    softmax, biases), under 1% of it, is not counted."""
    fwd = F * H1 + H1 * H2 + H2 * cap
    return 2 * (fwd + (cap * H2 + H2 * H1) + fwd)


def k5_ops_and_bytes(w: torch.Tensor, dims):
    """K5 on a batch: the rows that carry weight; x, labels and weights read
    once, the parameters read once, the gradients and stats written once."""
    F, H1, H2, cap = dims
    n_params = F * H1 + H1 + H1 * H2 + H2 + H2 * cap + cap
    rows = int((w > 0).sum())
    nbytes = 4 * (w.numel() * (F + 2) + 2 * n_params + 2)
    return rows * mlp_row_ops(*dims), nbytes


def k6_ops_and_bytes(masks: torch.Tensor, dims):
    """K6 on one file: the valid rows of the chunks that survive, plus each
    surviving chunk's update (2 operations per parameter); chunks, masks
    and the target read once, the parameters read and written once."""
    F, H1, H2, cap = dims
    n_params = F * H1 + H1 + H1 * H2 + H2 + H2 * cap + cap
    rows = int((masks > 0).sum())
    live = int((masks.sum(dim=1) > 0).sum())
    S, B = masks.shape
    nbytes = 4 * (S * B * (F + 1) + cap + 2 * n_params + 2)
    return rows * mlp_row_ops(*dims) + live * 2 * n_params, nbytes


def gate_margin(row: np.ndarray, stats, threshold: float) -> float:
    """How far one clip's similarity row lies from flipping its verdict
    under ``identify_sims_cosine``: the least distance of any similarity to
    any of its speaker's gate bounds (mean - 2 std, mean + 0.3 std, 0.35,
    0.5, the threshold), and the gap between the two best similarities."""
    mean = np.array([m for _, m, _ in stats])
    std = np.array([s for _, _, s in stats])
    bounds = np.stack([mean - 2 * std, mean + 0.3 * std, np.full_like(mean, 0.35),
                       np.full_like(mean, 0.5), np.full_like(mean, threshold)])
    top = np.sort(row)[-2:]
    return float(min(np.abs(row[None, :] - bounds).min(), top[1] - top[0]))


def write_corpus(pcm: np.ndarray, spk: np.ndarray, labelled: int, prefix: str):
    """WAVs in the working directory and their ``train_files.txt``: the
    first ``labelled`` clips of each speaker carry their label."""
    from streamz_tpu_torch.io import wav

    lines, seen = [], {}
    for i, s in enumerate(spk):
        name = f"{prefix}_{i:02d}_s{s}.wav"
        wav.write_wav(name, pcm[i])
        seen[s] = seen.get(s, 0) + 1
        lines.append(f"{name},{s}" if seen[s] <= labelled else name)
    Path("train_files.txt").write_text("\n".join(lines) + "\n")
    return [ln.split(",")[0] for ln in lines]


def run_cli(args):
    """``cli.main(args)`` with its stdout captured; returns (rc, lines,
    report), the report holding a default run's phase times and margins."""
    from streamz_tpu_torch.cli import main as cli_main

    buf, report = io.StringIO(), {}
    with contextlib.redirect_stdout(buf):
        rc = cli_main(args, report=report)
    return rc, buf.getvalue().splitlines(), report


def main() -> int:
    if not torch.cuda.is_available():
        fail("CUDA is not available; this check needs an NVIDIA GPU")
    missing = [n for n in SOURCES if not (CSRC / f"{n}.cu").exists()]
    if missing:
        fail(f"run from a checkout of the repository ({missing} missing in {CSRC})")
    sys.path.insert(0, str(HERE))

    from streamz_tpu_torch import _cuda_build, config
    from streamz_tpu_torch.device import resolve_device
    from streamz_tpu_torch.dsp import mfcc, mfcc_kernel
    from streamz_tpu_torch.dsp.features import FeatureExtractor
    from streamz_tpu_torch.infer.cosine import cosine_matrix_many, identify_sims_cosine
    from streamz_tpu_torch.infer.embed import batch_clip_embeddings
    from streamz_tpu_torch.infer.identify import identify_speaker_list_batch
    from streamz_tpu_torch.io import filelists, wav
    from streamz_tpu_torch.io.audio import batch_resample
    from streamz_tpu_torch.nn import checkpoint, drivers, prng
    from streamz_tpu_torch.nn import train_kernels as tk
    from streamz_tpu_torch.nn.model import init_params
    from streamz_tpu_torch.nn.train import file_epoch_views

    dev = resolve_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    report = {"card": card, "kind": kind, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    # 1. Build every kernel, one nvcc per source, all at once.
    t0 = time.perf_counter()
    _cuda_build.build_all(SOURCES)
    build_s = time.perf_counter() - t0
    print(f"[build] K1, K5, K6 built in {build_s:.2f} s; K1 uses "
          f"{mfcc_kernel.smem_bytes()} B shared memory per block")
    for name, log in _cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {SOURCES[name]} ptxas: {line.strip()}")
    report["build_s"] = build_s

    # Synthetic corpus, made on the card from the seed: 8 training and 8
    # held-out clips per speaker.
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    f0, env = synth_speakers(rng, N_SPEAKERS)
    spk = np.repeat(np.arange(N_SPEAKERS), CLIPS_PER_SPEAKER)
    t0 = time.perf_counter()
    train_pcm = synth_clips(f0, env, spk, gen, dev)
    query_pcm = synth_clips(f0, env, spk, gen, dev)
    print(f"[data] {len(train_pcm)} training + {len(query_pcm)} held-out clips of "
          f"{CLIP_SECONDS} s at {RATE} Hz made in {time.perf_counter() - t0:.2f} s")

    # 2. K1 vs its plain version on the card.  These launches are checks,
    # not the main path: the counts are zeroed before each path below.
    n = query_pcm.shape[1]
    tlen = mfcc._bucket_len(n)
    main_batch = np.zeros((len(query_pcm), tlen), np.float32)
    main_batch[:, :n] = mfcc._to_f32(query_pcm)
    main_pcm = torch.from_numpy(main_batch).to(dev)
    shapes = [(1, 800), (1, 2000), (2, 4000), (1, 208000), (3, 208000),
              (129, 1600), (513, 800), (2, 399)]
    errs = {}
    for B, T in shapes:
        pcm = torch.randn((B, T), generator=gen, device=dev) * 0.1
        got = mfcc_kernel.mfcc_base_v4(pcm)
        want = mfcc.mfcc_base(pcm)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"K1 shape {tuple(got.shape)} != plain {tuple(want.shape)} at {(B, T)}")
        errs[f"{B}x{T}"] = float((got - want).abs().max()) if got.numel() else 0.0
    got = mfcc_kernel.mfcc_base_v4(main_pcm)
    want = mfcc.mfcc_base(main_pcm)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"K1 at the main-path shape: {tuple(got.shape)} vs {tuple(want.shape)}")
    errs[f"{main_pcm.shape[0]}x{main_pcm.shape[1]} (main path)"] = float(
        (got - want).abs().max())
    del got, want
    for k, v in errs.items():
        print(f"[k1-vs-plain] {k}: max abs err {v:.3e} (bound {K1_TOL:g})")
    if max(errs.values()) > K1_TOL:
        fail(f"K1 disagrees with its plain version: {errs}")
    report["k1_max_abs_err"] = errs

    # 3. K5 and K6 vs their plain versions, on features of the labelled
    # training clips.
    extractor = FeatureExtractor(device=dev)
    labelled = [i for i in range(len(spk)) if i % CLIPS_PER_SPEAKER < LABELLED_PER_SPEAKER]
    feats = extractor.extract_batch([train_pcm[i] for i in labelled])
    pool = np.concatenate(feats)
    pool_y = np.concatenate([np.full(len(f), spk[i], np.int32) for f, i in zip(feats, labelled)])
    order = np.random.default_rng(SEED).permutation(len(pool))[:4096]
    k5_x = torch.from_numpy(np.ascontiguousarray(pool[order])).to(dev)
    k5_y = torch.from_numpy(pool_y[order]).to(dev)
    k5_w = torch.ones(len(order), device=dev)
    dims = (config.FEATURE_SIZE, config.HIDDEN1, config.HIDDEN2, 128)
    k5_errs, k5_abs = {}, 0.0
    for cap, B in ((128, 4096), (128, 1531), (1024, 4096), (4096, 777)):
        params = init_params(*dims[:3], cap, seed=SEED, device=dev)
        ns = N_SPEAKERS if cap == 128 else cap - 28
        x, y, w = k5_x[:B], k5_y[:B], k5_w[:B]
        if cap != 128:  # labels over the whole capacity, some past the live classes
            y = torch.randint(0, cap + 50, (B,), generator=gen, device=dev).to(torch.int32)
        g1, loss1, cnt1 = tk.corpus_grads_k5(params, x, y, w, ns)
        g2, loss2, _ = tk.corpus_grads_k5(params, x, y, w, ns)
        want, wloss, wcnt = tk.corpus_grads_plain(params, x, y, w, ns)
        torch.cuda.synchronize()
        if not all(torch.equal(g1[k], g2[k]) for k in g1) or float(loss1) != float(loss2):
            fail(f"K5 is not bit-reproducible at capacity {cap}, B {B}")
        rel = max(float((g1[k] - want[k]).abs().max()) / max(1.0, float(want[k].abs().max()))
                  for k in want)
        loss_err = abs(float(loss1) - float(wloss)) / max(1.0, abs(float(wloss)))
        k5_errs[f"cap{cap}xB{B}"] = (rel, loss_err)
        k5_abs = max(k5_abs, max(float((g1[k] - want[k]).abs().max()) for k in want))
        if (not math.isfinite(rel) or rel > K5_TOL or not math.isfinite(loss_err)
                or loss_err > K5_TOL or float(cnt1) != float(wcnt)):
            fail(f"K5 disagrees with its plain version at capacity {cap}, B {B}: "
                 f"grads {rel}, loss sum {loss_err}, count {float(cnt1)} vs {float(wcnt)}")
    for k, (v, le) in k5_errs.items():
        print(f"[k5-vs-plain] {k}: max err / max |grad| {v:.3e}, loss sum err "
              f"{le:.3e} (bound {K5_TOL:g} each); two runs bit-identical")
    report["k5_max_rel_err"] = k5_errs
    report["k5_max_abs_err"] = k5_abs

    file_w = feats[0]
    n_pad = config.next_pow2(-(-len(file_w) // config.BATCH_SIZE)) * config.BATCH_SIZE
    padded = torch.zeros((n_pad, config.FEATURE_SIZE), device=dev)
    padded[:len(file_w)] = torch.from_numpy(file_w).to(dev)
    dropped, valid = file_epoch_views(padded, len(file_w), prng.PRNGKey(1, dev),
                                      config.DEFAULT_DROPOUT, config.INCREMENTAL_EPOCHS)
    k6_chunks = dropped.reshape(-1, config.BATCH_SIZE, config.FEATURE_SIZE).contiguous()
    k6_masks = valid.reshape(-1, config.BATCH_SIZE).contiguous()
    k6_tvec = torch.zeros(128, device=dev)
    k6_tvec[3] = 1.0
    k6_params = init_params(*dims[:3], 128, seed=SEED, device=dev)
    got_p = {k: v.clone() for k, v in k6_params.items()}
    want_p = {k: v.clone() for k, v in k6_params.items()}
    gl, gc = tk.train_windows_k6(got_p, k6_chunks, k6_masks, k6_tvec, N_SPEAKERS + 1,
                                 config.LR_EARLY)
    wl, wc = tk.train_windows_plain(want_p, k6_chunks, k6_masks, k6_tvec,
                                    N_SPEAKERS + 1, config.LR_EARLY)
    torch.cuda.synchronize()
    k6_err = max(float((got_p[k] - want_p[k]).abs().max()) for k in want_p)
    k6_loss_err = abs(float(gl) - float(wl)) / max(1.0, abs(float(wl)))
    print(f"[k6-vs-plain] one {len(file_w)}-window file, {k6_chunks.shape[0]} chunk "
          f"steps: params max abs err {k6_err:.3e}, loss sum err {k6_loss_err:.3e} "
          f"(bound {K6_TOL:g} each); loss {float(gl):.6f} vs {float(wl):.6f}, count "
          f"{float(gc):g} vs {float(wc):g}")
    if (not math.isfinite(k6_err) or k6_err > K6_TOL or not math.isfinite(k6_loss_err)
            or k6_loss_err > K6_TOL or float(gc) != float(wc)):
        fail(f"K6 disagrees with its plain version: params {k6_err}, loss sum "
             f"{k6_loss_err}, count {float(gc)} vs {float(wc)}")
    report["k6_max_abs_err"] = k6_err
    report["k6_loss_err"] = k6_loss_err

    with tempfile.TemporaryDirectory(prefix="streamz_chip_smoke_") as work:
        # 4. The main path: the default training run through the CLI.
        os.chdir(work)
        names = write_corpus(train_pcm, spk, LABELLED_PER_SPEAKER, "train")
        counters = (mfcc_kernel.mfcc_base_v4, tk.corpus_grads_k5, tk.train_windows_k6)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, lines, run = run_cli([])
        train_s = time.perf_counter() - t0
        launches = {"K1": mfcc_kernel.mfcc_base_v4.launches,
                    "K5": tk.corpus_grads_k5.launches,
                    "K6": tk.train_windows_k6.launches}
        phases, margins = run["phase_seconds"], run["decision_margins"]
        for ln in lines:
            if ln.startswith(("Initial", "Number", "Average", "Processed", "Computed")):
                print(f"[train]   {ln}")
        processed = len(margins)
        print(f"[train] rc {rc}, {train_s:.2f} s, {processed} files through the "
              f"discovery loop, launches {launches}")
        if rc != 0:
            fail(f"the default run returned {rc}")
        steps = -(-len(pool) // 4096) * config.TRAIN_EPOCHS
        if (launches["K1"] < 1 or launches["K5"] != steps
                or launches["K6"] != processed or processed != len(names)):
            fail(f"the default run's launches {launches}: expected K1 >= 1, "
                 f"K5 = {steps}, K6 = {len(names)} (one per file)")
        net = checkpoint.load(config.MODEL_PATH, device=dev)
        relabelled = filelists.load_train_files(config.TRAIN_FILE_LIST)
        targets = filelists.load_target_files(config.TARGET_FILE_LIST)
        if (net.num_speakers < N_SPEAKERS or len(net.embeddings) != net.num_speakers
                or not all(torch.isfinite(v).all() for v in net.params.values())
                or [p for p, _ in relabelled] != names
                or any(c is None for _, c in relabelled) or len(targets) != len(names)):
            fail("model.npz or the relabelled lists are not what the run should write")
        kept = sum(1 for (p, c), s in zip(relabelled, spk) if c == s)
        finite = [m for m in margins if math.isfinite(m)]
        print(f"[train] model.npz: {net.num_speakers} speakers, {len(net.embeddings)} "
              f"embeddings; train_files.txt relabels all {len(relabelled)} clips, "
              f"{kept} with their own speaker's id (informational); smallest "
              f"decision margin {min(finite) if finite else float('inf'):.3e}")
        report.update({"train_s": train_s, "train_launches": launches,
                       "train_phase_s": phases, "train_speakers": net.num_speakers,
                       "train_own_label": kept})

        # 5. --identify of the held-out clips against the trained model.
        query_paths = []
        for i, s in enumerate(spk):
            query_paths.append(f"query_s{s}_{i % CLIPS_PER_SPEAKER}.wav")
            wav.write_wav(query_paths[-1], query_pcm[i])
        n_windows = sum(mfcc.window_count_host(len(p)) for p in query_pcm)
        mfcc_kernel.mfcc_base_v4.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, lines, _ = run_cli(["--identify", *query_paths])
        identify_s = time.perf_counter() - t0
        identify_launches = mfcc_kernel.mfcc_base_v4.launches
        verdicts = {ln.split(":")[0]: ln for ln in lines if ".wav:" in ln}
        print(f"[identify] rc {rc}, {len(verdicts)} verdict lines for "
              f"{len(query_paths)} clips, K1 launches {identify_launches}, "
              f"{identify_s:.3f} s")
        if rc != 0 or sorted(verdicts) != sorted(query_paths):
            fail(f"--identify: rc {rc}, verdicts for {len(verdicts)} clips")
        if identify_launches < 1:
            fail("--identify never launched K1")
        correct = sum(1 for p, s in zip(query_paths, spk)
                      if f": speaker {s} " in verdicts[p])
        unknown = sum(1 for v in verdicts.values() if ": speaker " not in v)
        print(f"[identify] {correct}/{len(query_paths)} held-out clips identified as "
              f"their own speaker, {unknown} unknown (trained model)")

        # 6. The vote pipeline on the same clips.
        pcms = [pcm for _, pcm in batch_resample(query_paths)]
        mfcc_kernel.mfcc_base_v4.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lists = identify_speaker_list_batch(net, pcms, config.DEFAULT_CONF_THRESHOLD,
                                            extractor)
        vote_s = time.perf_counter() - t0
        vote_launches = mfcc_kernel.mfcc_base_v4.launches
        if len(lists) != len(pcms) or vote_launches < 1:
            fail(f"vote pipeline: {len(lists)} lists, {vote_launches} K1 launches")
        top_ok = sum(1 for lst, s in zip(lists, spk) if lst and lst[0] == s)
        print(f"[votes] {len(lists)} clips, K1 launches {vote_launches}, "
              f"{vote_s:.3f} s, top-voted == own speaker for {top_ok}")

        # 7. The GPU path against the CPU path on one clip per speaker.
        pick = [k * CLIPS_PER_SPEAKER for k in range(N_SPEAKERS)]
        sub = [pcms[i] for i in pick]
        gf = extractor.extract_batch(sub)
        cf = FeatureExtractor(device="cpu").extract_batch(sub)
        cpu_net = checkpoint.load(config.MODEL_PATH, device="cpu")
        ge = np.stack(batch_clip_embeddings(net, gf))
        ce = np.stack(batch_clip_embeddings(cpu_net, cf))
        cents = np.stack([m for m, _, _ in net.embeddings])
        gs, cs = cosine_matrix_many(ge, cents), cosine_matrix_many(ce, cents)
        for name, a in (("features", gf), ("embeddings", [ge]), ("sims", [gs])):
            if not all(np.isfinite(x).all() for x in a):
                fail(f"non-finite {name}")
        if any(g.shape != (mfcc.window_count_host(n), config.FEATURE_SIZE) for g in gf):
            fail("feature shape")
        checks = {
            "features": max(float(np.abs(g - c).max()) for g, c in zip(gf, cf)),
            "embeddings": float(np.abs(ge - ce).max()),
            "sims": float(np.abs(gs - cs).max()),
        }
        thr = config.DEFAULT_CONF_THRESHOLD
        gv = [identify_sims_cosine(g, net.embeddings, thr) for g in gs]
        cv = [identify_sims_cosine(c, net.embeddings, thr) for c in cs]
        gmargins = [gate_margin(c, net.embeddings, thr) for c in cs]
        firm = [m > checks["sims"] for m in gmargins]
        print("[gpu-vs-cpu] " + ", ".join(f"{k} max abs err {v:.3e}"
                                          for k, v in checks.items())
              + f" (bound {GPU_VS_CPU_TOL:g}); verdicts agree "
              f"{sum(a == b for a, b in zip(gv, cv))}/{len(pick)}")
        print(f"[gpu-vs-cpu] verdicts {gv}; gate margins "
              + ", ".join(f"{m:.2e}" for m in gmargins)
              + f"; {sum(firm)} clips farther from a bound than the sims error")
        if max(checks.values()) > GPU_VS_CPU_TOL:
            fail(f"GPU path disagrees with the CPU path: {checks}")
        if any(f and a != b for f, a, b in zip(firm, gv, cv)):
            fail(f"gate verdicts differ: GPU {gv}, CPU {cv}")
        report["gate_verdicts"] = gv
        report["gate_margins"] = gmargins

    # 8. The same bare run at a reduced size, CPU (plain) vs GPU (kernels).
    small_spk = np.repeat(np.arange(4), 4)
    small_pcm = synth_clips(f0[:4], env[:4], small_spk, gen, dev, seconds=2)
    runs = {}
    for device in ("cpu", "cuda"):
        with tempfile.TemporaryDirectory(prefix="streamz_chip_smoke_small_") as work:
            os.chdir(work)
            write_corpus(small_pcm, small_spk, 1, "small")
            drivers._key_counter[0] = 0
            t0 = time.perf_counter()
            rc, _, run = run_cli(["--device", device])
            if rc != 0:
                fail(f"the reduced bare run on {device} returned {rc}")
            runs[device] = ([c for _, c in filelists.load_train_files(
                config.TRAIN_FILE_LIST)], run["decision_margins"],
                time.perf_counter() - t0)
    os.chdir(HERE)
    (cl, cm, cs_), (gl_, gm, gs_) = runs["cpu"], runs["cuda"]
    compared = 0
    for k, (a, b) in enumerate(zip(cl, gl_)):
        if min(cm[k], gm[k]) <= GPU_VS_CPU_TOL:
            break  # from here on the two runs may rightly part
        if a != b:
            fail(f"reduced run: file {k} labelled {b} on the GPU, {a} on the CPU "
                 f"(margins {cm[k]:.3e} / {gm[k]:.3e})")
        compared += 1
    finite = [m for m in cm + gm if math.isfinite(m)]
    print(f"[cpu-vs-gpu run] {len(cl)} files, labels CPU {cl} GPU {gl_}: "
          f"{compared} compared and equal; smallest margin "
          f"{min(finite) if finite else float('inf'):.3e} (bound {GPU_VS_CPU_TOL:g}); "
          f"{cs_:.1f} s on the CPU, {gs_:.1f} s on the GPU")
    if compared == 0:
        fail("the reduced run compared no label")
    report["cpu_vs_gpu_run"] = {"cpu": cl, "gpu": gl_, "compared": compared}

    # 9. Timing with CUDA events at the main-path shapes.
    B, T = main_pcm.shape
    rows = B * (T // 400)
    ops, nbytes = k1_ops_and_bytes(B, T, len(mfcc_kernel.kernel_constants()["fbw"]))
    k1_bound_ms, k1_bound_by = bound(ops, nbytes)
    tf32_bound_ms = max(ops / PEAK_TF32, nbytes / PEAK_BYTES) * 1e3
    dft = mfcc._constants(dev)[0]
    blocks = main_pcm.view(rows, 400)
    k1_ms = time_cuda(lambda: mfcc_kernel.mfcc_base_v4(main_pcm), iters=20)
    k1_plain_ms = time_cuda(lambda: mfcc.mfcc_base(main_pcm), iters=5)
    k1_lib_ms = time_cuda(lambda: torch.matmul(blocks, dft), iters=20)
    k1_ms_2 = time_cuda(lambda: mfcc_kernel.mfcc_base_v4(main_pcm), iters=20)
    print(f"[time] K1 mfcc_base_v4 [{B}, {T}] ({rows} block rows): {k1_ms:.3f} ms, "
          f"again {k1_ms_2:.3f} ms; plain {k1_plain_ms:.3f} ms; torch.matmul DFT stage "
          f"{k1_lib_ms:.3f} ms; bound {k1_bound_ms:.3f} ms by {k1_bound_by} "
          f"({ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; TF32 bound "
          f"{tf32_bound_ms:.3f} ms) | {card}")

    k5_params = init_params(*dims[:3], 128, seed=SEED, device=dev)
    k5_args = (k5_params, k5_x, k5_y, k5_w, N_SPEAKERS)
    k5_ops, k5_bytes = k5_ops_and_bytes(k5_w, dims)
    k5_bound_ms, k5_bound_by = bound(k5_ops, k5_bytes)
    k5_ms = time_cuda(lambda: tk.corpus_grads_k5(*k5_args), iters=50)
    k5_plain_ms = time_cuda(lambda: tk.corpus_grads_plain(*k5_args), iters=50)
    k5_ms_2 = time_cuda(lambda: tk.corpus_grads_k5(*k5_args), iters=50)
    print(f"[time] K5 corpus_grads [4096, 60] cap 128: {k5_ms:.3f} ms, again "
          f"{k5_ms_2:.3f} ms; plain {k5_plain_ms:.3f} ms; bound {k5_bound_ms:.4f} ms "
          f"by {k5_bound_by} ({k5_ops / 1e9:.2f} GFLOP, {k5_bytes / 1e6:.2f} MB); "
          f"{k5_ops / (min(k5_ms, k5_ms_2) * 1e-3) / 1e12:.1f} TFLOP/s | {card}")

    k6_p = {k: v.clone() for k, v in k6_params.items()}
    k6_args = (k6_p, k6_chunks, k6_masks, k6_tvec, N_SPEAKERS + 1, config.LR_EARLY)
    k6_ops, k6_bytes = k6_ops_and_bytes(k6_masks, dims)
    k6_bound_ms, k6_bound_by = bound(k6_ops, k6_bytes)
    k6_ms = time_cuda(lambda: tk.train_windows_k6(*k6_args), iters=5, warmup=1)
    k6_plain_ms = time_cuda(lambda: tk.train_windows_plain(*k6_args), iters=2, warmup=1)
    k6_ms_2 = time_cuda(lambda: tk.train_windows_k6(*k6_args), iters=5, warmup=1)
    live = int((k6_masks.sum(dim=1) > 0).sum())
    print(f"[time] K6 file_train, {k6_chunks.shape[0]} chunks ({live} with a surviving "
          f"window): {k6_ms:.3f} ms, again {k6_ms_2:.3f} ms ({min(k6_ms, k6_ms_2) * 1e3 / live:.1f} "
          f"us per step); plain {k6_plain_ms:.3f} ms; bound {k6_bound_ms:.4f} ms by "
          f"{k6_bound_by} ({k6_ops / 1e9:.2f} GFLOP, {k6_bytes / 1e6:.2f} MB) | {card}")
    print("[time] default run by phase: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phases.items()) + f"; total {train_s:.3f} s | {card}")
    print(f"[time] --identify end to end: {n_windows / identify_s:,.0f} windows/s "
          f"({n_windows} windows, {identify_s:.3f} s, host decode included); vote "
          f"pipeline {n_windows / vote_s:,.0f} windows/s ({vote_s:.3f} s) | {card}")
    total_s = time.perf_counter() - t_start
    print(f"[time] chip_smoke phases 1-9: {total_s:.1f} s")
    report.update({
        "identify_s": identify_s, "identify_windows": n_windows,
        "identify_windows_per_s": n_windows / identify_s,
        "identify_launches": identify_launches, "identify_correct": correct,
        "identify_unknown": unknown, "vote_s": vote_s,
        "vote_windows_per_s": n_windows / vote_s, "vote_launches": vote_launches,
        "gpu_vs_cpu": checks, "k1_ms": [k1_ms, k1_ms_2], "k1_plain_ms": k1_plain_ms,
        "k1_matmul_dft_ms": k1_lib_ms, "k1_tf32_bound_ms": tf32_bound_ms,
        "k5_ms": [k5_ms, k5_ms_2], "k5_plain_ms": k5_plain_ms,
        "k6_ms": [k6_ms, k6_ms_2], "k6_plain_ms": k6_plain_ms, "k6_live_chunks": live,
        "k6_chunks": int(k6_chunks.shape[0]), "total_s": total_s,
    })
    kernels = {"kernels": [
        {"name": "mfcc_base_v4", "route": "cuda",
         "source": "streamz_tpu_torch/csrc/mfcc_base.cu",
         "replaces": "streamz_tpu/dsp/pallas_mfcc.py:612",
         "launches": launches["K1"], "max_abs_err": max(errs.values()),
         "ms": min(k1_ms, k1_ms_2), "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
         "bound_by": k1_bound_by, "library_ms": k1_lib_ms},
        {"name": "corpus_grads_k5", "route": "cuda",
         "source": "streamz_tpu_torch/csrc/corpus_grads.cu",
         "replaces": "streamz_tpu/nn/pallas_train.py:67",
         "launches": launches["K5"], "max_abs_err": k5_abs,
         "ms": min(k5_ms, k5_ms_2), "plain_ms": k5_plain_ms, "bound_ms": k5_bound_ms,
         "bound_by": k5_bound_by, "library_ms": None},
        {"name": "train_windows_k6", "route": "cuda",
         "source": "streamz_tpu_torch/csrc/file_train.cu",
         "replaces": "streamz_tpu/nn/pallas_train.py:237",
         "launches": launches["K6"], "max_abs_err": k6_err,
         "ms": min(k6_ms, k6_ms_2), "plain_ms": k6_plain_ms, "bound_ms": k6_bound_ms,
         "bound_by": k6_bound_by, "library_ms": None},
    ]}
    report.update(kernels)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
