#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (streamz_tpu_torch) runs on a GPU.

    python3 chip_smoke.py        # from the root of a checkout, one NVIDIA GPU

Phases (each runs uncaught: any failure exits non-zero without a result):

1. Build K1 (``streamz_tpu_torch/csrc/mfcc_base.cu``) with nvcc for sm_90a.
2. Hold K1 against its plain PyTorch version on the card at the launcher's
   edge shapes, a clip shorter than one block and the main-path shape,
   within 1e-3 on the base MFCCs.
3. Drive ``python -m streamz_tpu_torch --identify`` (``cli.main``) on 64
   seeded synthetic 10 s clips at 44.1 kHz from 8 synthetic speakers,
   against a full-width random model (60→512→256, capacity 128) whose
   centroids come from 8 enrolment clips per speaker through the port's own
   embedding path.  K1's launch count is zeroed just before and read just
   after; the run must launch it.
4. Run the gated vote pipeline (``identify_speaker_list_batch``) on the same
   clips, with its own zeroed launch count.
5. Check the GPU path against the CPU path on 8 clips (features, embeddings,
   similarities, and the gate's verdicts wherever the similarities lie
   farther from a gate bound than the two paths differ), and that every
   output is finite and of the expected shape.
6. Time K1, its plain version and ``torch.matmul`` of the DFT product alone
   with CUDA events, and the two pipelines end to end in windows/s.

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
KERNEL_SOURCE = HERE / "streamz_tpu_torch" / "csrc" / "mfcc_base.cu"

N_SPEAKERS = 8
CLIPS_PER_SPEAKER = 8
CLIP_SECONDS = 10
RATE = 44_100
SEED = 0
K1_TOL = 1e-3          # base MFCCs: the frontend's golden gate
GPU_VS_CPU_TOL = 1e-3  # features / embeddings / sims, GPU path vs CPU path
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


def synth_speakers(rng: np.random.Generator):
    """Per speaker: a fundamental and a harmonic envelope."""
    f0 = rng.uniform(90.0, 260.0, N_SPEAKERS)
    env = rng.uniform(0.05, 1.0, (N_SPEAKERS, 24)) * (
        0.85 ** np.arange(24))[None, :]
    return f0, env


def synth_clips(f0, env, speakers, gen: torch.Generator, dev) -> np.ndarray:
    """[n, 10 s] int16 voices made on the card: harmonics of the speaker's
    f0 under its envelope, with vibrato, syllable-rate amplitude modulation
    and noise.  Phases, jitter and noise come from ``gen``."""
    n = len(speakers)
    t = torch.arange(CLIP_SECONDS * RATE, device=dev, dtype=torch.float64) / RATE
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


def main() -> int:
    if not torch.cuda.is_available():
        fail("CUDA is not available; this check needs an NVIDIA GPU")
    if not KERNEL_SOURCE.exists():
        fail(f"run from a checkout of the repository ({KERNEL_SOURCE} missing)")
    sys.path.insert(0, str(HERE))

    from streamz_tpu_torch import config
    from streamz_tpu_torch.cli import main as cli_main
    from streamz_tpu_torch.device import resolve_device
    from streamz_tpu_torch.dsp import mfcc, mfcc_kernel
    from streamz_tpu_torch.dsp.features import FeatureExtractor
    from streamz_tpu_torch.infer.cosine import (
        compute_speaker_embeddings, cosine_matrix_many, identify_sims_cosine,
    )
    from streamz_tpu_torch.infer.embed import batch_clip_embeddings
    from streamz_tpu_torch.infer.identify import identify_speaker_list_batch
    from streamz_tpu_torch.io import wav
    from streamz_tpu_torch.io.audio import batch_resample
    from streamz_tpu_torch.nn import checkpoint
    from streamz_tpu_torch.nn.model import SpeakerNet

    dev = resolve_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    report = {"card": card, "kind": kind, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    # 1. Build.
    t0 = time.perf_counter()
    mfcc_kernel.build()
    build_s = time.perf_counter() - t0
    smem = mfcc_kernel.smem_bytes()
    print(f"[build] K1 built in {build_s:.2f} s, {smem} B shared memory per block")
    for line in mfcc_kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")
    report["build_s"] = build_s
    report["smem_bytes"] = smem

    # Synthetic corpus, made on the card from the seed.
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    f0, env = synth_speakers(rng)
    spk = np.repeat(np.arange(N_SPEAKERS), CLIPS_PER_SPEAKER)
    t0 = time.perf_counter()
    enrol_pcm = synth_clips(f0, env, spk, gen, dev)
    query_pcm = synth_clips(f0, env, spk, gen, dev)
    print(f"[data] {len(enrol_pcm)} enrolment + {len(query_pcm)} query clips of "
          f"{CLIP_SECONDS} s at {RATE} Hz made in {time.perf_counter() - t0:.2f} s")

    # 2. K1 vs its plain version on the card.  These launches are checks,
    # not the main path: the count is zeroed before the main path below.
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

    with tempfile.TemporaryDirectory(prefix="streamz_chip_smoke_") as work:
        os.chdir(work)
        enrol_paths, query_paths = [], []
        for i, s in enumerate(spk):
            enrol_paths.append(f"enrol_s{s}_{i % CLIPS_PER_SPEAKER}.wav")
            query_paths.append(f"query_s{s}_{i % CLIPS_PER_SPEAKER}.wav")
            wav.write_wav(enrol_paths[-1], enrol_pcm[i])
            wav.write_wav(query_paths[-1], query_pcm[i])

        # Full-width random model; centroids from the enrolment clips
        # through the port's own embedding path (K1 on the card).
        extractor = FeatureExtractor(device=dev)
        net = SpeakerNet.new(config.FEATURE_SIZE, config.HIDDEN1, config.HIDDEN2,
                             N_SPEAKERS, seed=SEED, device=dev)
        if net.capacity != 128:
            fail(f"model capacity {net.capacity}, expected 128")
        net.file_lists = [[p for p, s in zip(enrol_paths, spk) if s == k]
                          for k in range(N_SPEAKERS)]
        t0 = time.perf_counter()
        net.set_embeddings(compute_speaker_embeddings(net, extractor))
        print(f"[enrol] {N_SPEAKERS} centroids from {len(enrol_paths)} clips in "
              f"{time.perf_counter() - t0:.2f} s; mean/std sims "
              + ", ".join(f"{m:.6f}/{s:.6f}" for _, m, s in net.embeddings))
        checkpoint.save(net, config.MODEL_PATH)

        # 3. The main path: --identify through the CLI.
        n_windows = sum(mfcc.window_count_host(len(p)) for p in query_pcm)
        buf = io.StringIO()
        mfcc_kernel.mfcc_base_v4.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["--identify", *query_paths])
        identify_s = time.perf_counter() - t0
        identify_launches = mfcc_kernel.mfcc_base_v4.launches
        lines = buf.getvalue().splitlines()
        verdicts = {ln.split(":")[0]: ln for ln in lines if ".wav:" in ln}
        print(f"[identify] rc {rc}, {len(verdicts)} verdict lines for "
              f"{len(query_paths)} clips, K1 launches {identify_launches}, "
              f"{identify_s:.3f} s")
        for ln in lines[:4]:
            print(f"[identify]   {ln}")
        if rc != 0 or sorted(verdicts) != sorted(query_paths):
            fail(f"--identify: rc {rc}, verdicts for {len(verdicts)} clips")
        if identify_launches < 1:
            fail("--identify never launched K1")
        correct = sum(
            1 for p, s in zip(query_paths, spk)
            if f": speaker {s} " in verdicts[p])
        unknown = sum(1 for v in verdicts.values() if ": speaker " not in v)
        print(f"[identify] {correct}/{len(query_paths)} clips matched their own "
              f"speaker, {unknown} unknown (random weights: informational)")

        # 4. The vote pipeline on the same clips.
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
              f"{vote_s:.3f} s, top-voted == own speaker for {top_ok} "
              "(informational)")

        # 5. The GPU path against the CPU path on one clip per speaker.
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
        # The gate's verdicts on the two paths.  A clip whose similarities
        # lie farther from every gate bound than the two paths differ must
        # get the same verdict on both; the margins say how much that shows.
        thr = config.DEFAULT_CONF_THRESHOLD
        gv = [identify_sims_cosine(g, net.embeddings, thr) for g in gs]
        cv = [identify_sims_cosine(c, net.embeddings, thr) for c in cs]
        margins = [gate_margin(c, net.embeddings, thr) for c in cs]
        firm = [m > checks["sims"] for m in margins]
        print("[gpu-vs-cpu] " + ", ".join(f"{k} max abs err {v:.3e}"
                                          for k, v in checks.items())
              + f" (bound {GPU_VS_CPU_TOL:g}); verdicts agree "
              f"{sum(a == b for a, b in zip(gv, cv))}/{len(pick)}")
        print(f"[gpu-vs-cpu] verdicts {gv}; gate margins "
              + ", ".join(f"{m:.2e}" for m in margins)
              + f"; {sum(firm)} clips farther from a bound than the sims error")
        if max(checks.values()) > GPU_VS_CPU_TOL:
            fail(f"GPU path disagrees with the CPU path: {checks}")
        if any(f and a != b for f, a, b in zip(firm, gv, cv)):
            fail(f"gate verdicts differ: GPU {gv}, CPU {cv}")
        report["gate_verdicts"] = gv
        report["gate_margins"] = margins
        os.chdir(HERE)

    # 6. Timing at the main-path shape, with CUDA events.
    B, T = main_pcm.shape
    rows = B * (T // 400)
    ops, nbytes = k1_ops_and_bytes(B, T, len(mfcc_kernel.kernel_constants()["fbw"]))
    bound_ms = max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if ops / PEAK_FP32 >= nbytes / PEAK_BYTES else "bytes"
    tf32_bound_ms = max(ops / PEAK_TF32, nbytes / PEAK_BYTES) * 1e3
    dft = mfcc._constants(dev)[0]
    blocks = main_pcm.view(rows, 400)
    k1_ms = time_cuda(lambda: mfcc_kernel.mfcc_base_v4(main_pcm), iters=20)
    plain_ms = time_cuda(lambda: mfcc.mfcc_base(main_pcm), iters=5)
    lib_ms = time_cuda(lambda: torch.matmul(blocks, dft), iters=20)
    k1_ms_2 = time_cuda(lambda: mfcc_kernel.mfcc_base_v4(main_pcm), iters=20)
    tflops = ops / (min(k1_ms, k1_ms_2) * 1e-3) / 1e12
    print(f"[time] K1 mfcc_base_v4 [{B}, {T}] ({rows} block rows): {k1_ms:.3f} ms, "
          f"again {k1_ms_2:.3f} ms; {tflops:.1f} TFLOP/s | {card}")
    print(f"[time] plain mfcc_base: {plain_ms:.3f} ms | {card}")
    print(f"[time] torch.matmul DFT stage [{rows}, 400] x [400, 802] f32: "
          f"{lib_ms:.3f} ms | {card}")
    print(f"[time] bound {bound_ms:.3f} ms by {bound_by} (FP32 {PEAK_FP32 / 1e12:g} "
          f"TFLOP/s, {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); on TF32 tensor "
          f"cores {tf32_bound_ms:.3f} ms; bytes alone {nbytes / PEAK_BYTES * 1e3:.3f} ms "
          f"| {card}")
    print(f"[time] --identify end to end: {n_windows / identify_s:,.0f} windows/s "
          f"({n_windows} windows, {identify_s:.3f} s, host decode included) | {card}")
    print(f"[time] vote pipeline: {n_windows / vote_s:,.0f} windows/s "
          f"({vote_s:.3f} s) | {card}")
    report.update({
        "identify_s": identify_s, "identify_windows": n_windows,
        "identify_windows_per_s": n_windows / identify_s,
        "identify_launches": identify_launches, "identify_correct": correct,
        "identify_unknown": unknown,
        "vote_s": vote_s, "vote_windows_per_s": n_windows / vote_s,
        "vote_launches": vote_launches, "gpu_vs_cpu": checks,
        "k1_ms": [k1_ms, k1_ms_2], "plain_ms": plain_ms, "matmul_dft_ms": lib_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "tf32_bound_ms": tf32_bound_ms,
        "gflop": ops / 1e9, "mbytes": nbytes / 1e6, "k1_tflops": tflops,
    })
    kernels = {"kernels": [{
        "name": "mfcc_base_v4",
        "route": "cuda",
        "source": "streamz_tpu_torch/csrc/mfcc_base.cu",
        "replaces": "streamz_tpu/dsp/pallas_mfcc.py:612",
        "launches": identify_launches,
        "max_abs_err": max(errs.values()),
        "ms": min(k1_ms, k1_ms_2),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }]}
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
