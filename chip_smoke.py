#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (streamz_tpu_torch) runs on a GPU.

    python3 chip_smoke.py        # from the root of a checkout, one NVIDIA GPU

Phases (each runs uncaught: any failure exits non-zero without a result):

1. Build all seven kernels, K1-K7 (``streamz_tpu_torch/csrc/{mfcc_base,
   mfcc_v3,mfcc_v2,mfcc_frames,corpus_grads,file_train,forward_probs}.cu``)
   with nvcc for sm_90a, one nvcc per source, all at once, and beside them
   the native ingest layer (``streamz_tpu_torch/native/``) with g++.
2. Hold the MFCC kernels K1-K4 against their plain PyTorch versions on the
   card at the launcher's edge shapes, a clip shorter than one block, the
   edges of their shared tile (an unaligned base and T % 4 != 0 among
   them) and the main-path shape, within 1e-3 on the base MFCCs, two
   launches at the main-path shape bit-identical; and each kernel
   backend's features against ``tests/fixtures/golden_features.npy`` on the
   golden clip, within 1e-3.
3. Hold K5 against its plain version at the corpus training's shape
   (4096 windows, capacity 128) and a ragged batch, and at capacities 1024
   and 4096, in both forms: the gradient sums within 1e-4 of the largest
   |grad|, the loss sum within 1e-4 relative, the count exact, two runs
   bit-identical; the step form's parameters within 1e-5 of ``_apply_step``
   over the plain sums.  The same on the pool route as the corpus phase runs
   it (the labelled pool on the card, epoch 0's order and dropout mask, its
   first step and its ragged last one of 1232 rows), whose plain gather must
   equal the JAX package's host gather bit for bit.  Hold K6 (one
   thread-block cluster per file) against its plain version on one
   main-path file (a 10 s clip: 1280 chunk steps) at capacity 128 (every
   slice in the cluster's shared memory) and 4096 (w3 in device memory):
   parameters within 1e-3, the loss sum within 1e-3 relative, the count
   exact, two launches bit-identical; and on three short files of 160 steps
   on the other routes (chunks of 64 and of 48 windows, row tiles of
   32; H1 = 4096, everything in device memory): within 1e-4, the count
   exact, bit-identical.
   Then the frontend probe: ``autotune_frontend(force=True)`` with a fresh
   cache measures K2 against K1 and keeps the winner for the run.
4. The default training run, ``python -m streamz_tpu_torch`` (``cli.main([])``),
   at full width (60→512→256, capacity 128) on 64 seeded synthetic 10 s
   clips at 44.1 kHz of 8 synthetic speakers, 2 clips of each labelled:
   ingest, the frontend through the probe's winner, corpus training through
   K5 (100 epochs, batch 4096), the discovery loop through K6 (one launch
   per processed file), ``model.npz`` and the relabelled lists.  Every
   kernel's launch count is zeroed just before and read just after; the
   winner's and K6's must have moved, K5's must be its 500 steps, and the
   plain step (``_apply_step``) and the plain gather must not have run.
   The run keeps the frontend's outputs on the card (``DeviceFeatureStore``),
   and the discovery loop and finalize gather from it: its
   ``host_pack_bytes`` must stay 0.
5. ``--identify`` (``cli.main(["--identify", ...])``) of 64 held-out clips
   against the trained model, counts zeroed and read; prints how many clips
   it gives their own speaker.  Then ``--eval`` of the same clips as the
   target list, with the store (the targets pinned, ``host_pack_bytes`` 0)
   and with ``STREAMZ_STORE_MAX_MB=0``: the same metrics dict; prints
   accuracy, precision, recall, F1 and the ``eval`` phase's seconds (the
   verbose per-file log goes to ``chiprun_out/chip_smoke_eval_*.log``).
   ``--check-embeddings`` and ``--cluster-embeddings 8`` on the card print
   what a ``--device cpu`` run prints.  Then the default run again on the
   same corpus without the store and with it, each from key 0 in a fresh
   directory: labels and ``model.npz`` arrays bit-identical to phase 4's;
   prints the ``discovery`` phase's seconds of all three.  Then the default
   run with ``--encode`` (``[stego-cli]``), from key 0 in a fresh directory:
   its first labelled clip listed as ``clips/<stem>.mp3``, an arbitrary
   blob whose ``cache/<stem>.wav`` holds the clip, ``--checksum`` the
   blob's SHA-512, a 4 KiB payload.  It must print "Hiding ..." and write
   ``w4_*``/``b4_*``, ``--decode`` must recover the payload exactly, and
   the labels and every other ``model.npz`` array must equal phase 4's bit
   for bit (the clip's path read as its cache WAV's); prints the phases'
   seconds, ``stego`` among them.
6. The gated vote pipeline (``identify_speaker_list_batch``) on those clips;
   then K7 (bf16 products, as its TPU kernel) on their 70,464 windows
   (capacity 128, ``num_speakers`` 0, 1, 8 and 128, the trained and a fresh
   model) against its plain version: every window within 1e-2 and all but
   1% within 2e-4 (a bf16 rounding of h1 or h2 may flip with the summation
   order), its labels the plain version's wherever that one's top-two gap
   is 0.02 or more; against the FP32 ``model.forward`` within 0.1, labels
   changing only where the FP32 top-two gap is under 0.2, the plain
   version's own distance beside; inactive columns exactly 0.  Then K7 on inputs whose sums are exact in any order at every shape of
   ``K7_EXACT`` (the tile's edges, capacities 256 and 4096, widths
   (60, 100, 52) and (60, 4096, 2048)): within 2e-4 of its plain version on
   every window, bit-identical twice.  Then the same vote pipeline through
   ``FeatureExtractor`` of each
   kernel backend (``'pallas'`` K4, ``'pallas_v2'`` K3, ``'pallas_v3'`` K2,
   ``'pallas_v4'`` K1), counts zeroed and read for each: its kernel's count
   must move, its features lie within 1e-3 of K1's, its vote lists equal
   K1's wherever no window lies within 1e-3 of a vote change, and its gate
   verdicts equal K1's wherever the gate margin exceeds twice the two
   backends' difference in similarity (so every margin over 1e-3 too).
   Then streaming and serving on the trained model and the 64 held-out
   clips (no kernel of the port runs there: every count must stay 0).
   ``[stream]``: one ``StreamingIdentifier`` per wire (f32, i16, mu-law,
   A-law) fed one clip in uneven chunks; its features within
   ``STREAM_PLAIN_TOL`` of the offline ``'plain'`` frontend on the card
   and within 1e-3 of ``'auto'``'s (K1 or K2), its verdict the offline
   vote verdict; then 99 feeds of 100 ms under
   ``torch.cuda.set_sync_debug_mode("error")``: no host read.
   ``[serve]``: (1) ``MultiStreamIdentifier`` with 64 slots, i16 and mu-law
   streams interleaved, fed every clip in 100 ms chunks with a tick after
   each round: the aggregate real-time factor, a tick's device ms by CUDA
   events and its kernel launches under the profiler, host ms per tick,
   peak device memory; every finalize verdict the offline vote verdict
   wherever the top-two vote gap exceeds ``VERDICT_MARGIN`` of the window
   count; the u8 wire's carry bit-identical to host-decoded i16. (2) The
   daemon, ``python -m streamz_tpu_torch --serve 0 --serve-streams 64`` in
   a subprocess on the card, 64 ``StreamClient`` streams at a 100 ms
   cadence for ``PACED_PERIODS`` periods (i16 and mu-law interleaved), then
   the rest of each clip: FEED and CURRENT latency p50/p95/p99, the
   server's tick ms, the first verdict on a fresh process and on a warm
   one, its RSS after each of ``RELOADS`` hot reloads of a rewritten
   ``model.npz`` beside a bare process's after ``import torch`` and one CUDA
   product; FINALIZE verdicts those of (1); no failed tick, exit 0 on
   SIGTERM. (3) A two-child ``LocalFleet`` on the card, started beside the
   daemon: the verdicts of (1).  (4) The identifier slot-sharded over
   ``[cuda:0, cuda:0]`` (a ``LocalMesh``, two shards on the card; over every
   card too when there are several), ticked in turns with an unsharded one
   on the chunks of (1): every finalize verdict the unsharded one's, both
   ticks' ms.
   ``[native]``: the C++ ingest layer (``streamz_tpu_torch/native/``, built
   by g++ into ``_build/``; the phase fails if it is unavailable) on the 64
   training WAVs and 16 held-out clips written at 48 and 22.05 kHz, bit for
   bit against the Python thread pool, both timed; the default run of
   phase 4 must have ingested through it and never through the pool.
   ``[dist]``: the multi-process run on the one card, every rank a process
   of its own (``chip_smoke.py --dist-worker``, killed at
   ``DIST_DEADLINE_S``).  Two ranks over gloo: the data-parallel corpus
   training (100 epochs, K5's sums form on each rank's half of every step,
   one all-reduce) against one process's ``train_corpus`` within
   ``DIST_PARAM_TOL``; the PCM-halo frontend (K1 on each rank's extended
   blocks) on a 170 s clip against the unsharded K1 features within
   ``K1_TOL``, whether they are bit-identical printed; the batched identify
   (clip-sharded) and the long-clip identify (PCM halo) against one
   process's verdicts wherever no window lies within ``K1_TOL`` of a vote
   change; the per-step K5 and all-reduce times of each rank.  Then the
   sharded discovery scan at full width (``SCAN_FILES`` training clips of
   10 s, their K1 features, phase 4's model, two gloo ranks): forced
   sharded against forced replicated (K6), the same labels, parameters
   within ``DIST_PARAM_TOL``, every rank's bits rank 0's, no K6 on the
   sharded route; its ms per file, all-reduces per file and one
   all-reduce's ms; then the measured scan choice with both probe times,
   the same on both ranks, cached for the CLI.  Then the CLI
   (``python -m streamz_tpu_torch`` with ``--coordinator/--num-processes/
   --process-id``) as two processes against one, from a cold frontend
   cache (no probe under a mesh: both run K1) and that cached scan choice:
   the default run on phase 4's corpus, the same ``train_files.txt``, K1,
   K5 and K6 (on the ``'single'`` route) launched on each rank, each
   rank's feature store of its shards on with ``host_pack_bytes`` 0;
   ``--eval`` of the single process's ``model.npz`` as two processes
   through the mesh store, the same metrics; the default run forced
   sharded on 16 training clips cut to ``SHORT_SECONDS`` (2 of each
   speaker, 1 labelled) against the same two ranks forced replicated, the
   same ``train_files.txt``; ``--eval`` of each run's own model
   printed beside them, with how many targets lie within the models' float
   noise (the DP corpus training's summation order, carried through the
   discovery loop) of a decision.  Then one rank over NCCL: the DP step
   bit-identical to K5's sums with ``_apply_step``, its K5 and all-reduce
   times.  Nothing here is a multi-GPU speed: the ranks share one card.
   ``[multichip]``: ``streamz_tpu_torch.entry.entry()`` on the card against
   the CPU's within ``GPU_VS_CPU_TOL``, then ``dryrun_multichip(2)`` (two
   gloo ranks on the card) and ``dryrun_multichip(1)`` (NCCL): every one of
   its five programs ``ok``.
7. The GPU path against the CPU path on 8 clips (features, embeddings,
   similarities, and the gate's verdicts wherever the similarities lie
   farther from a gate bound than the two paths differ).
8. The same bare run at a reduced size (12 clips of 1 s, 4 speakers) on the
   CPU (plain versions) and on the GPU (kernels): the same labels for every
   file up to the first whose decision margin is within 1e-3 of a change.
   Then ``--profile traces`` on that reduced corpus on the card: the phase
   report printed and a ``torch.profiler`` trace written that holds K6's
   kernel.  Then the steganography codec (``[stego]``): payloads of 64 B,
   4 KiB, 64 KiB and the 128 KiB cap (a [256, 1,048,576] f32 output layer)
   encoded on the card and decoded on the host, the bytes equal; prints
   the steps, the encode's seconds (the loop on the card apart) and the
   peak device memory.  Then ``train_from_files`` (``[pretrain]``) on 8
   training clips, 2 epochs, at full width, on the card and on the CPU:
   ``augment`` on the card equal to the CPU's bit for bit, one launch of
   the frontend's winner and one of K6 per (file, epoch), each parameter's
   gap to the CPU's within ``PRETRAIN_CHANGE_TOL`` of the CPU run's change
   from the initial weights (a run with one (file, epoch) skipped must fail
   it) and the mean loss within ``PRETRAIN_LOSS_TOL`` relative of the
   CPU's; prints the milliseconds per (file, epoch) and one step's stages.
9. The bench twin, ``python -m streamz_tpu_torch.bench`` (``bench.run()``),
   once, counts zeroed and read (the winner's and K7's must move); its JSON
   line is printed.  Then time every kernel per launch with CUDA events
   against its bound, its plain version and a library call (for K1-K4 the
   bf16x3 block DFT stage as one bf16 ``torch.matmul`` of the split planes,
   and the FP32 one; K4 is held to the work its output needs, K3's, with
   its own 800-tap formulation's bound and frame product beside), K1-K4
   also at the bench twin's shape, every
   frontend in windows/s, ten bench-twin calls under ``torch.profiler``
   split into the frontend's kernel and the rest, and the default run by
   phase (ingest, features, corpus, discovery, finalize) with synchronised
   timers.  K7 is timed through its C entry (the pack kernel and the
   forward) and through ``forward_probs_k7``, beside its bf16 bound and
   FP32 bound, its plain version, the three products alone as bf16
   ``torch.matmul`` and the FP32 ``forward``.  K5 is timed in both
   forms, beside its 3xTF32 bound and the function's FP32 bound.  K6 is
   timed per file and per live step on each route, beside the card's bound
   and one cluster's (its operations over the cluster's share of the FP32
   peak), and beside its plain version.  Then the corpus phase once more
   under ``torch.profiler``, split into K5, the uploads and the idle
   (host) time; last, one more pass of the discovery loop over the
   training clips, on a copy of the trained model, under the profiler: its
   time per file split into K6, the other kernels and the idle time.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(K5's entry also names its ``formulation`` and both forms' times, K6's its
``cluster`` size, its main-path ``k6_route`` and every timed route),
whose ``launches`` are each kernel's count in the one run of its own path
(named in ``path``: the default run for K5, K6 and the probe's winner, the
vote pipeline through its backend for the other MFCC kernels, the bench
twin for K7), with every path's count beside it, and as its last line ``{"ok": true, "device": {...}}``.  Writes the same
numbers to ``chiprun_out/chip_smoke.json`` and every printed line to
``chiprun_out/chip_smoke.log``.  Exits non-zero, printing no result,
without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import io
import json
import math
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CSRC = HERE / "streamz_tpu_torch" / "csrc"
SOURCES = {"mfcc_base": "K1", "mfcc_v3": "K2", "mfcc_v2": "K3", "mfcc_frames": "K4",
           "corpus_grads": "K5", "file_train": "K6", "forward_probs": "K7"}
FIXTURES = HERE / "tests" / "fixtures"
# The edges of the tile of K1-K4 (64 block rows, 63 windows, tile pairs),
# (B, T, offset) as tests/test_torch_cuda.py::TC_EDGES holds them.
TC_EDGES = [(1, 2000, 0), (1, 50800, 0), (1, 50400, 0), (1, 51200, 0), (43, 1200, 0),
            (1, 76000, 0), (1, 76400, 0), (3, 208000, 0), (2, 4123, 0), (5, 12345, 0),
            (7, 41600, 1), (4, 9999, 1)]
# The frontend backends of the kernels, by kernel id.
BACKENDS = {"K1": "pallas_v4", "K2": "pallas_v3", "K3": "pallas_v2", "K4": "pallas"}
KID = {b: k for k, b in BACKENDS.items()}

N_SPEAKERS = 8
CLIPS_PER_SPEAKER = 8
LABELLED_PER_SPEAKER = 2
CLIP_SECONDS = 10
RATE = 44_100
SEED = 0
K1_TOL = 1e-3          # base MFCCs (K1-K4 vs plain) and features: the golden gate
K5_TOL = 1e-4          # gradient sums relative to the largest |grad|; loss sum relative
K5_STEP_TOL = 1e-5     # K5's step form vs _apply_step on the plain sums, parameters abs
K5_LR = 0.01           # the corpus phase's learning rate
K6_TOL = 1e-3          # parameters (abs) and loss sum (relative) after 1280 steps
K6_CAPS = (128, 4096)  # K6 with w3 in the cluster's shared memory, and in device memory
K6_SHORT_TOL = 1e-4    # parameters (abs) and loss sum (relative) after 160 steps
SMS = 132              # streaming multiprocessors of an H100 SXM
# K7 runs its TPU kernel's bf16 products (f32 sums).  Against its plain
# version on inputs whose layer-1 and layer-2 sums are exact in f32 in any
# order (K7_EXACT): K7_TOL on every window.  On real inputs two f32
# summation orders may round an h1 or h2 value next to a bf16 midpoint to
# different neighbours, which moves that window by up to a few 1e-3: every
# window within K7_FLIP_TOL, all but K7_FLIP_SHARE of them within K7_TOL.
# Against the FP32 model.forward: K7_F32_TOL on the probabilities, so a
# window's label may change only where the FP32 top-two gap is under twice
# it; the plain version's own distance from FP32 is printed beside.  K7's
# labels equal the plain version's wherever its top-two gap is at least
# twice K7_FLIP_TOL.
K7_TOL = 2e-4
K7_FLIP_TOL = 1e-2
K7_FLIP_SHARE = 0.01
K7_F32_TOL = 0.1
# (F, H1, H2, capacity, rows) of the exact-input check: the tile's edges,
# the identify batch, capacities past one chunk (two softmax passes), and
# widths whose padding the kernel fills or whose activations live in
# device memory.
K7_EXACT = [(60, 512, 256, 128, 1), (60, 512, 256, 128, 63), (60, 512, 256, 128, 64),
            (60, 512, 256, 128, 65), (60, 512, 256, 128, 70464), (60, 512, 256, 256, 70464),
            (60, 512, 256, 4096, 70464), (60, 100, 52, 128, 70464), (60, 4096, 2048, 128, 65),
            (60, 4096, 2048, 128, 4096)]
GPU_VS_CPU_TOL = 1e-3  # features / embeddings / sims / margins, GPU vs CPU
# [dist]: the DP corpus training of two ranks against one process after the
# corpus phase's 500 steps (their K5 sums split each step's rows in two and
# add the halves, another f32 order; K6's 1e-3 after 1280 steps is the
# like gate), a spawned rank's deadline, and the steps timed per rank.
DIST_PARAM_TOL = 1e-3
DIST_DEADLINE_S = 300
DIST_TIMED_STEPS = 20
# [dist]'s sharded discovery scan: the first SCAN_FILES training clips at
# full length; the forced-sharded CLI run: 16 clips cut to SHORT_SECONDS
# (a 512-window bucket: 321 all-reduces a file).
SCAN_FILES = 8
SHORT_SECONDS = 2.5
# The steganography codec's payloads, 64 B to the 128 KiB cap (w3 of
# [256, 1,048,576] f32 = 1 GiB), and the payload the --encode run hides.
STEGO_BYTES = (64, 4096, 65536, 131072)
STEGO_CLI_BYTES = 4096
# train_from_files on the card against the same call on the CPU (K1 or K2
# against the plain frontend, K6 against its plain loop, 16 (file, epoch)
# steps of augment + features + one epoch of chunk SGD at full width, about
# 2,200 SGD steps): the mean losses within PRETRAIN_LOSS_TOL relative, and
# every parameter's gap to the CPU run, as a norm, within
# PRETRAIN_CHANGE_TOL of the norm of the CPU run's change from the initial
# weights.  A control, the card run with its last (file, epoch) skipped,
# must fail that gate, or the gate is too loose to see a lost step.
# Measured on an H100: the card's gaps 1.8e-4 (b3) to 9.2e-3 (w1), the
# control's 1.5e-2 (w2) to 7.2e-2 (b2); the limit sits between the card's
# largest and the control's largest, and four of the control's six
# parameters exceed it.
PRETRAIN_LOSS_TOL = 1e-3
PRETRAIN_CHANGE_TOL = 2e-2
PRETRAIN_CLIPS = 8
PRETRAIN_EPOCHS = 2
# Published H100 SXM peaks (NVIDIA data sheet, dense): FP32 on the CUDA
# cores, TF32 and bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# Streaming and serving (no kernel of the port runs there): the streamed
# features against the offline 'plain' frontend on the card, whose products
# run at other shapes (the CPU holds them to 1e-5), and against 'auto' at
# K1_TOL.  Verdicts are compared wherever the top-two vote gap exceeds
# VERDICT_MARGIN of the window count, confidences within VERDICT_CONF_RTOL.
STREAM_PLAIN_TOL = 1e-4
VERDICT_MARGIN = 1e-4
VERDICT_CONF_RTOL = 1e-4
SERVE_CHUNK = 4410     # 100 ms at 44.1 kHz, the daemon clients' cadence
PACED_PERIODS = 30     # 3 s of each clip at that cadence, the rest at once
RELOADS = 3            # hot reloads of a rewritten model.npz
BARE_RSS = (  # a process's RSS (MiB) after import torch, then after one CUDA product
    "import torch\n"
    "def rss():\n"
    "    with open('/proc/self/status') as f:\n"
    "        return next(float(ln.split()[1]) / 1024 for ln in f if ln.startswith('VmRSS'))\n"
    "a = rss()\n"
    "torch.ones(64, 400, device='cuda') @ torch.ones(400, 802, device='cuda')\n"
    "torch.cuda.synchronize()\n"
    "print(f'{a:.1f} {rss():.1f}')\n")


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def bound(ops: float, nbytes: float, bf16_ops: float = 0.0, tf32_ops: float = 0.0):
    """The least time the card could take: (ms, 'operations' or 'bytes'),
    ``ops`` FP32 operations on the CUDA cores and ``bf16_ops`` and
    ``tf32_ops`` on the tensor cores."""
    t_ops = ops / PEAK_FP32 + bf16_ops / PEAK_BF16 + tf32_ops / PEAK_TF32
    t_bytes = nbytes / PEAK_BYTES
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


def mfcc_tc_ops_and_bytes(kid: str, B: int, T: int, mel_weights: int, tail_weights: int):
    """K1-K4 on [B, T] PCM: (FP32 operations, bf16 operations, bytes).  The
    DFT in bf16x3 is three bf16 products of the [400 x 802] block DFT per
    block row (K4: of the [800 x 802] frame DFT per window); the mel stage
    is three bf16 products over the filterbank's nonzero weights for K2 and
    K1 (K1's tail weights, ``tail_weights`` of them, twice), one FP32
    product for K3 and K4; the combine, power, log and DCT are FP32.  Each
    input (the PCM, the bf16 hi and lo basis) read once, the output written
    once."""
    nb = T // 400
    rows, wins = B * nb, B * max(nb - 1, 0)
    taps = 800 if kid == "K4" else 400
    bf16 = 3 * 2 * (wins if kid == "K4" else rows) * taps * 802
    f32 = wins * 401 * (3 if kid == "K4" else 7) + wins * 26 + 2 * wins * 26 * 20
    mel = 2 * wins * (mel_weights + (tail_weights if kid == "K1" else 0))
    if kid in ("K1", "K2"):
        bf16 += 3 * mel
    else:
        f32 += mel
    nbytes = 4 * (B * T + wins * 20 + mel_weights + 3 * 26 + 26 * 20) + 2 * 2 * taps * 802
    return f32, bf16, nbytes


def k7_ops_and_bytes(R: int, dims):
    """K7 on R windows: the forward's multiply-adds, bf16 operands on the
    tensor cores (the softmax, under 1% of it, not counted); x read once,
    the parameters read once, the probabilities written once."""
    F, H1, H2, cap = dims
    n_params = F * H1 + H1 + H1 * H2 + H2 + H2 * cap + cap
    return 2 * R * (F * H1 + H1 * H2 + H2 * cap), 4 * (R * F + R * cap + n_params)


def k7_exact_inputs(F: int, H1: int, H2: int, cap: int, R: int, dev, seed: int):
    """Parameters and windows whose layer-1 and layer-2 sums are exact in
    f32 in any order: x in quarters of [-2, 2], w1 and w2 in eighths of
    [-1/2, 1/2], b1 in 32nds, b2 in 256ths (every product and partial sum a
    multiple of 2^-8 far below 2^16), so h1 and h2 round to the same bf16
    whatever the order; w3 and b3 uniform (layer 3 is not rounded)."""
    rng = np.random.default_rng(seed)

    def q(shape, lim, step):
        return (rng.integers(-lim, lim + 1, shape) * step).astype(np.float32)

    params = {"w1": q((F, H1), 4, 1 / 8), "b1": q((H1,), 16, 1 / 32),
              "w2": q((H1, H2), 4, 1 / 8), "b2": q((H2,), 64, 1 / 256),
              "w3": rng.uniform(-0.5, 0.5, (H2, cap)).astype(np.float32),
              "b3": rng.uniform(-0.5, 0.5, cap).astype(np.float32)}
    x = q((R, F), 8, 1 / 4)
    return ({k: torch.from_numpy(v).to(dev) for k, v in params.items()},
            torch.from_numpy(x).to(dev))


def k7_flip_stats(got: torch.Tensor, want: torch.Tensor):
    """(max abs error, windows past K7_TOL) of K7 against its plain version."""
    err = (got - want).abs().amax(dim=1)
    return float(err.max()) if err.numel() else 0.0, int((err > K7_TOL).sum())


def k7_vs_fp32(got: torch.Tensor, f32: torch.Tensor, ns: int):
    """(max abs error, windows whose label changed, the largest top-two gap
    of ``f32`` among them) of ``got`` against ``f32``: K7 or its plain
    version against the FP32 forward, or K7 against its plain version."""
    err = float((got - f32).abs().max())
    if ns < 2:
        return err, 0, 0.0
    top = f32[:, :ns].topk(2, dim=1).values
    changed = got[:, :ns].argmax(dim=1) != f32[:, :ns].argmax(dim=1)
    gaps = top[changed, 0] - top[changed, 1]
    return err, int(changed.sum()), float(gaps.max()) if gaps.numel() else 0.0


def vote_check(probs: np.ndarray, ns: int, threshold: float, tol: float):
    """One clip's gated vote counts from its [W, cap] probabilities, and the
    number of its windows within ``tol`` of changing their vote: best
    probability that close to the threshold, or to the runner-up."""
    p = probs[:, :ns]
    top = np.sort(p, axis=1)[:, -2:] if ns > 1 else np.concatenate(
        [np.zeros((len(p), 1), p.dtype), p], axis=1)
    best = top[:, 1]
    soft = int(((np.abs(best - threshold) <= tol) | (best - top[:, 0] <= tol)).sum())
    counts = np.bincount(p.argmax(axis=1)[best >= np.float32(threshold)], minlength=ns)
    return counts, soft


def mlp_row_ops(F: int, H1: int, H2: int, cap: int) -> int:
    """Multiply-adds (2 operations each) of one row's forward, data backward
    (dh2, dh1) and weight gradients; the elementwise work (activations,
    softmax, biases), under 1% of it, is not counted."""
    fwd = F * H1 + H1 * H2 + H2 * cap
    return 2 * (fwd + (cap * H2 + H2 * H1) + fwd)


def k5_ops_and_bytes(w: torch.Tensor, dims):
    """K5 on a step: (FP32 operations, the formulation's TF32 operations,
    bytes) over the rows that carry weight.  The function's work is
    ``mlp_row_ops`` per row; the kernel's formulation runs each product
    three times in TF32 (3xTF32), its weight gradients with the bias row.
    x, labels and weights read once, the parameters read once, the
    gradients (or the updated parameters) and stats written once."""
    F, H1, H2, cap = dims
    n_params = F * H1 + H1 + H1 * H2 + H2 + H2 * cap + cap
    rows = int((w > 0).sum())
    nbytes = 4 * (w.numel() * (F + 2) + 2 * n_params + 2)
    products = (F * H1 + H1 * H2 + H2 * cap + cap * H2 + H2 * H1
                + (F + 1) * H1 + (H1 + 1) * H2 + (H2 + 1) * cap)
    return rows * mlp_row_ops(*dims), 3 * 2 * rows * products, nbytes


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


def percentiles_ms(xs):
    """p50/p95/p99 of a list of seconds, in ms."""
    p = np.percentile(np.asarray(xs) * 1e3, (50, 95, 99))
    return {"p50": float(p[0]), "p95": float(p[1]), "p99": float(p[2]), "n": len(xs)}


def offline_votes(net, feats_dev):
    """The offline vote sums of one clip's features on the card (FP32
    ``forward``, summed over the windows) and its window count."""
    from streamz_tpu_torch.nn.model import forward

    with torch.no_grad():
        probs = forward(net.params, feats_dev, net.num_speakers)
    return probs.sum(dim=0).cpu().numpy(), int(feats_dev.shape[0])


def vote_margin(votes: np.ndarray, count: float, ns: int) -> float:
    """The top-two vote gap as a share of the window count."""
    if ns < 2 or count <= 0:
        return float("inf")
    top = np.sort(votes[:ns])[::-1]
    return float(top[0] - top[1]) / count


def check_verdicts(label, got, want, margins):
    """Speaker ids equal wherever the margin exceeds VERDICT_MARGIN, and the
    confidences within VERDICT_CONF_RTOL there; returns (compared, max rel)."""
    compared, worst = 0, 0.0
    for i, (g, w, m) in enumerate(zip(got, want, margins)):
        if m <= VERDICT_MARGIN:
            continue
        if g is None or w is None or g[0] != w[0]:
            fail(f"{label}: stream {i} verdict {g}, expected {w} (margin {m:.3e})")
        rel = abs(g[1] - w[1]) / max(abs(w[1]), 1e-30)
        worst = max(worst, rel)
        if rel > VERDICT_CONF_RTOL:
            fail(f"{label}: stream {i} confidence {g[1]!r}, expected {w[1]!r}")
        compared += 1
    return compared, worst


def vm_rss_mib(pid: int) -> float:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) / 1024.0
    return float("nan")


def stream_phase(net, pcms, dev, extractor, card, report, zero_counts):
    """``[stream]``: one StreamingIdentifier per wire against the offline
    frontends on the card, and ``feed`` free of host reads.  The offline
    features are made first; ``zero_counts`` runs before the streams."""
    from streamz_tpu_torch.app.stream import StreamingIdentifier, vote_verdict
    from streamz_tpu_torch.dsp.features import FeatureExtractor
    from streamz_tpu_torch.io import g711

    plain = FeatureExtractor("plain", device=dev)
    clip = pcms[0]
    wires = {"f32": (clip.astype(np.float32) / 32767.0, None, clip),
             "i16": (clip, None, clip)}
    for law in ("ulaw", "alaw"):
        codes = (g711.ulaw_encode if law == "ulaw" else g711.alaw_encode)(clip)
        wires[law] = (codes.tobytes(), law, g711.decode(codes, law))
    refs = {w: (plain.extract_batch([pcm])[0], extractor.extract_batch([pcm])[0])
            for w, (_, _, pcm) in wires.items()}
    zero_counts()
    rng = np.random.default_rng(SEED + 21)
    out = {}
    for wire, (fed, enc, pcm) in wires.items():
        chunks = rng.integers(1, 20000, size=64)
        sid = StreamingIdentifier(net, threshold=0.0, collect_features=True)
        i = 0
        t0 = time.perf_counter()
        for n in chunks:
            if i < len(fed):
                sid.feed(fed[i:i + int(n)], encoding=enc)
                i += int(n)
        if i < len(fed):
            sid.feed(fed[i:], encoding=enc)
        final = sid.finalize()
        stream_s = time.perf_counter() - t0
        got = sid.streamed_features()
        want, auto = refs[wire]
        if got.shape != want.shape:
            fail(f"[stream] {wire}: streamed features {got.shape}, offline {want.shape}")
        err_plain = float(np.abs(got - want).max())
        err_auto = float(np.abs(got - auto).max())
        votes, count = offline_votes(net, torch.from_numpy(want).to(dev))
        offline = vote_verdict(votes, count, net.output_size(), 0.0)
        margin = vote_margin(votes, count, net.num_speakers)
        out[wire] = {"max_abs_err_plain": err_plain, "max_abs_err_auto": err_auto,
                     "windows": int(got.shape[0]), "verdict": final, "offline": offline,
                     "margin": margin, "s": stream_s}
        print(f"[stream] {wire}: {got.shape[0]} windows in {len(chunks) + 1} uneven "
              f"chunks, {stream_s:.3f} s; features vs plain on the card max abs "
              f"{err_plain:.3e} (bound {STREAM_PLAIN_TOL:g}), vs '{extractor.resolved()}' "
              f"{err_auto:.3e} (bound {K1_TOL:g}); verdict {final}, offline {offline}, "
              f"margin {margin:.3e}")
        if err_plain > STREAM_PLAIN_TOL or err_auto > K1_TOL:
            fail(f"[stream] {wire}: streamed features off the offline frontends")
        check_verdicts(f"[stream] {wire}", [final], [offline], [margin])
    # feed reads nothing back: every chunk under the sync check.
    sid = StreamingIdentifier(net, threshold=0.0)
    sid.feed(clip[:8000])  # first use outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        for i in range(8000, len(clip), 4410):
            sid.feed(clip[i:i + 4410])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    n_chunks = len(range(8000, len(clip), 4410))
    print(f"[stream] {n_chunks} feeds of 100 ms under torch.cuda.set_sync_debug_mode"
          f"('error'): no host read; {enqueue_s / n_chunks * 1e3:.3f} ms a feed on the "
          f"host | {card}")
    out["sync_free_feeds"] = n_chunks
    out["feed_host_ms"] = enqueue_s / n_chunks * 1e3
    report["stream"] = out


def serve_phase(net, pcms, dev, card, work, report):
    """``[serve]``: MultiStreamIdentifier in process, the --serve daemon in a
    subprocess, and a two-child LocalFleet, on the 64 held-out clips."""
    import subprocess
    import threading

    from streamz_tpu_torch import config
    from streamz_tpu_torch.app.fleet import FleetClient, LocalFleet
    from streamz_tpu_torch.app.serve import MultiStreamIdentifier
    from streamz_tpu_torch.app.server import StreamClient
    from streamz_tpu_torch.app.stream import vote_verdict
    from streamz_tpu_torch.dsp.features import FeatureExtractor
    from streamz_tpu_torch.io import g711

    S = len(pcms)
    # Odd streams on the mu-law wire, even ones on i16, interleaved.
    codes = {i: g711.ulaw_encode(pcms[i]) for i in range(1, S, 2)}
    fed_pcm = [g711.ulaw_decode(codes[i]) if i in codes else pcms[i] for i in range(S)]

    def chunk(i, a, b):
        return (codes[i][a:b], "ulaw") if i in codes else (pcms[i][a:b], None)

    feats = FeatureExtractor("plain", device=dev).extract_batch(fed_pcm)
    offline, margins = [], []
    for f in feats:
        votes, count = offline_votes(net, torch.from_numpy(f).to(dev))
        offline.append(vote_verdict(votes, count, net.output_size(), 0.0))
        margins.append(vote_margin(votes, count, net.num_speakers))
    audio_s = sum(len(p) for p in pcms) / RATE

    # 1. In process: every clip in 100 ms chunks, a tick after each round.
    ident = MultiStreamIdentifier(net, n_streams=S, threshold=0.0)
    sids = [ident.open() for _ in range(S)]
    ident.tick()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    n = len(pcms[0])
    tick_host, tick_dev = [], []
    t_start = time.perf_counter()
    for a in range(0, n, SERVE_CHUNK):
        for i, sid in enumerate(sids):
            ident.feed(sid, *chunk(i, a, a + SERVE_CHUNK))
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        ident.tick()
        ev1.record()
        tick_host.append(time.perf_counter() - t0)
        tick_dev.append((ev0, ev1))
    finals = [ident.finalize(sid) for sid in sids]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    dev_ms = [e0.elapsed_time(e1) for e0, e1 in tick_dev]
    # One more tick of 64 slots x 16 blocks under the profiler: its kernels.
    prof_ident = MultiStreamIdentifier(net, n_streams=S, threshold=0.0)
    p_sids = [prof_ident.open() for _ in range(S)]
    for sid in p_sids:
        prof_ident.feed(sid, pcms[sid][:16 * config.HOP_SIZE])
    prof_ident.tick()
    for sid in p_sids:
        prof_ident.feed(sid, pcms[sid][16 * config.HOP_SIZE:32 * config.HOP_SIZE])
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ident.tick()
        torch.cuda.synchronize()
    acts = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kern = [e for e in acts if not e.key.startswith(("Memcpy", "Memset"))]
    launches = sum(e.count for e in kern)  # 0: the profiler saw no device time
    kern_ms = sum(e.self_device_time_total for e in kern) / 1e3
    copies = sum(e.count for e in acts) - launches
    compared, worst = check_verdicts("[serve] in process vs offline", finals, offline, margins)
    rtf = audio_s / wall
    wires = ", ".join(f"{k} {v}" for k, v in ident.stats()["wire_dispatches"].items() if v)
    print(f"[serve] in process: {S} streams (i16 and mu-law interleaved, {wires} dispatches), "
          f"{audio_s:.0f} s of audio in {wall:.3f} s: aggregate real-time factor {rtf:.1f}; "
          f"tick (one dispatch of {S} x {ident.k} blocks) device ms p50 "
          f"{np.median(dev_ms):.3f} by CUDA events, host ms p50 {np.median(tick_host) * 1e3:.3f}"
          f" p99 {np.percentile(tick_host, 99) * 1e3:.3f}; one tick under the profiler: "
          + (f"{launches} kernel launches, {kern_ms:.3f} ms of kernel time, {copies} copies"
             if launches else "no device time recorded, launches not measured")
          + f"; peak device memory {peak_mib:.1f} MiB, {peak_mib - base_mib:.1f} above what "
          f"was allocated before it | {card}")
    print(f"[serve] in process: finalize verdicts equal the offline vote verdicts on "
          f"{compared} of {S} streams (margins over {VERDICT_MARGIN:g}), confidences within "
          f"{worst:.2e} relative; top-two vote margins min {min(margins):.3e}, median "
          f"{float(np.median(margins)):.3e}")
    # The u8 wire alone, against host-decoded i16, bit for bit on the card.
    u8, i16 = (MultiStreamIdentifier(net, n_streams=S, threshold=0.0) for _ in range(2))
    for srv in (u8, i16):
        for _ in range(S):
            srv.open()
    for a in range(0, 2 * RATE, SERVE_CHUNK):
        for i in range(S):
            c = g711.ulaw_encode(pcms[i][a:a + SERVE_CHUNK])
            u8.feed(i, c, encoding="ulaw")
            i16.feed(i, g711.ulaw_decode(c))
        u8.tick()
        i16.tick()
    if (u8.stats()["wire_dispatches"]["u8"] == 0
            or not all(torch.equal(a, b) for a, b in zip(u8._carry, i16._carry))):
        fail(f"[serve] the u8 wire differs from host-decoded i16: {u8.stats()}")
    print(f"[serve] u8 wire: {u8.stats()['wire_dispatches']['u8']} dispatches of "
          f"mu-law bytes, the carry bit-identical to host-decoded i16")
    local_mesh_phase(net, S, len(pcms[0]), chunk, dev, card, report)
    report["serve_in_process"] = {
        "streams": S, "audio_s": audio_s, "wall_s": wall, "aggregate_rtf": rtf,
        "tick_device_ms": percentiles_ms([d / 1e3 for d in dev_ms]),
        "tick_host_ms": percentiles_ms(tick_host), "tick_kernel_launches": launches,
        "tick_kernel_ms": kern_ms, "tick_copies": copies, "peak_device_mib": peak_mib,
        "peak_above_base_mib": peak_mib - base_mib, "compared": compared,
        "conf_max_rel": worst, "margins": margins, "wires": ident.stats()["wire_dispatches"]}
    del prof_ident, u8, i16

    # 2. The daemon: python -m streamz_tpu_torch --serve 0 on the card.  The
    # fleet's two children of (3) start beside it and wait idle meanwhile.
    env = dict(os.environ, PYTHONPATH=str(HERE))
    fleet = LocalFleet(os.path.join(work, "model.npz"), n_servers=2, n_streams=S // 2,
                       threshold=0.0, tick_interval=0.005, env={"PYTHONPATH": str(HERE)},
                       device="cuda")
    fleet_box: dict = {}

    def start_fleet():
        t = time.perf_counter()
        try:
            fleet_box["endpoints"] = fleet.start(timeout=180)
        except Exception as e:  # reported after the join
            fleet_box["error"] = e
        fleet_box["ready_s"] = time.perf_counter() - t

    fleet_thread = threading.Thread(target=start_fleet, daemon=True)
    # Beside them a bare process: the RSS of `import torch` and of a CUDA
    # context with one product, against which the daemon's RSS is read.
    bare = subprocess.Popen([sys.executable, "-c", BARE_RSS], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    t_spawn = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "streamz_tpu_torch", "--serve", "0",
         "--serve-streams", str(S), "--threshold", "0"],
        cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        log: list = []
        reader = threading.Thread(target=lambda: log.extend(iter(proc.stdout.readline, "")),
                                  daemon=True)
        reader.start()
        fleet_thread.start()
        try:
            deadline = time.monotonic() + 120
            while not any(ln.startswith("Serving") for ln in log):
                if proc.poll() is not None or time.monotonic() > deadline:
                    fail("[serve] the daemon did not start: " + "".join(log)[-2000:])
                time.sleep(0.02)
            ready_s = time.perf_counter() - t_spawn
            rss_ready = vm_rss_mib(proc.pid)
            line = next(ln for ln in log if ln.startswith("Serving"))
            port = int(line.split("127.0.0.1:")[1].split()[0])

            def first_verdict(i):
                """Seconds from the first FEED of a new stream to its first verdict."""
                c = StreamClient("127.0.0.1", port, timeout=60)
                pcm, enc = chunk(i, 0, SERVE_CHUNK)
                t0 = time.perf_counter()
                c.feed(pcm.tobytes() if enc else pcm, wire=enc or "i16")
                while c.current() is None:
                    if time.perf_counter() - t0 > 60:
                        fail("[serve] no first verdict within 60 s")
                    time.sleep(0.002)
                return c, time.perf_counter() - t0

            c0, cold_s = first_verdict(0)
            clients = [c0] + [StreamClient("127.0.0.1", port, timeout=60) for _ in range(1, S)]
            feed_lat, cur_lat, errors = [], [], []
            paced = PACED_PERIODS * SERVE_CHUNK

            def run(idx):
                try:
                    t_next = time.perf_counter()
                    for p in range(PACED_PERIODS):
                        a = p * SERVE_CHUNK
                        for i in idx:
                            if i == 0 and p == 0:
                                continue  # stream 0's first chunk went in above
                            pcm, enc = chunk(i, a, a + SERVE_CHUNK)
                            t0 = time.perf_counter()
                            clients[i].feed(pcm.tobytes() if enc else pcm, wire=enc or "i16")
                            clients[i].current()  # replies once the FEED is taken
                            feed_lat.append(time.perf_counter() - t0)
                        time.sleep(max(0.0, t_next + 0.05 - time.perf_counter()))
                        for i in idx:
                            t0 = time.perf_counter()
                            clients[i].current()
                            cur_lat.append(time.perf_counter() - t0)
                        t_next += SERVE_CHUNK / RATE
                        time.sleep(max(0.0, t_next - time.perf_counter()))
                    for i in idx:
                        pcm, enc = chunk(i, paced, None)
                        clients[i].feed(pcm.tobytes() if enc else pcm, wire=enc or "i16")
                except Exception as e:  # reported after the join
                    errors.append(repr(e))

            clients[0].stats(reset_ticks=True)
            groups = [list(range(g, S, 8)) for g in range(8)]
            threads = [threading.Thread(target=run, args=(g,)) for g in groups]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            if errors or any(t.is_alive() for t in threads):
                fail(f"[serve] daemon clients failed: {errors[:3]}")
            paced_stats = clients[0].stats()
            daemon_finals = [c.finalize() for c in clients]
            for c in clients:
                c.close()
            d_compared, d_worst = check_verdicts("[serve] daemon vs in process", daemon_finals,
                                                 finals, margins)
            time.sleep(0.2)  # the slots close on the ticker
            c_warm, warm_s = first_verdict(0)
            c_warm.close()
            rss = [vm_rss_mib(proc.pid)]
            with StreamClient("127.0.0.1", port, timeout=60) as sc:
                model = os.path.join(work, "model.npz")
                blob = Path(model).read_bytes()
                for r in range(1, RELOADS + 1):
                    # The same bytes under a new inode: a rewritten checkpoint.
                    Path(model + ".new").write_bytes(blob)
                    os.replace(model + ".new", model)
                    deadline = time.monotonic() + 30
                    while sc.stats()["model_reloads"] < r:
                        if time.monotonic() > deadline:
                            fail(f"[serve] reload {r} did not happen: " + "".join(log)[-2000:])
                        time.sleep(0.05)
                    rss.append(vm_rss_mib(proc.pid))
            failed_ticks = [ln for ln in log if "tick failed" in ln]
            if failed_ticks:
                fail(f"[serve] the daemon logged failed ticks: {failed_ticks[:3]}")
            f_p, c_p = percentiles_ms(feed_lat), percentiles_ms(cur_lat)
            print(f"[serve] daemon: ready {ready_s:.2f} s after spawn; {S} streams at a 100 ms "
                  f"cadence for {PACED_PERIODS} periods (i16 and mu-law interleaved), then the "
                  f"rest of each clip at once: FEED (to its taking) p50/p95/p99 "
                  f"{f_p['p50']:.2f}/{f_p['p95']:.2f}/{f_p['p99']:.2f} ms, CURRENT "
                  f"{c_p['p50']:.2f}/{c_p['p95']:.2f}/{c_p['p99']:.2f} ms; server tick ms "
                  f"p50/p95/p99 {paced_stats.get('tick_ms_p50')}/{paced_stats.get('tick_ms_p95')}/"
                  f"{paced_stats.get('tick_ms_p99')} over {paced_stats.get('ticks_measured')} "
                  f"ticks; first verdict cold {cold_s * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} ms; "
                  f"RSS MiB when ready {rss_ready:.1f}, before and after each of {RELOADS} reloads "
                  + ", ".join(f"{r:.1f}" for r in rss) + f" | {card}")
            bare_out = bare.communicate(timeout=120)[0]
            try:
                rss_bare = [float(x) for x in bare_out.split()[-2:]]
            except ValueError:
                fail(f"[serve] the bare process printed {bare_out[-500:]!r}")
            print(f"[serve] a bare process beside it: RSS {rss_bare[0]:.1f} MiB after import "
                  f"torch, {rss_bare[1]:.1f} MiB after one CUDA product | {card}")
            print(f"[serve] daemon: FINALIZE verdicts equal the in-process ones on {d_compared} "
                  f"of {S} streams, confidences within {d_worst:.2e} relative")
            proc.terminate()
            rc = proc.wait(timeout=30)
            if rc != 0:
                fail(f"[serve] the daemon exited {rc} on SIGTERM")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        report["serve_daemon"] = {
            "ready_s": ready_s, "feed_ms": f_p, "current_ms": c_p,
            "server_tick_ms": {k: paced_stats.get(f"tick_ms_{k}") for k in ("p50", "p95", "p99")},
            "ticks_measured": paced_stats.get("ticks_measured"),
            "first_verdict_cold_ms": cold_s * 1e3, "first_verdict_warm_ms": warm_s * 1e3,
            "rss_mib_ready": rss_ready, "rss_mib_by_reload": rss, "rss_mib_bare": rss_bare,
            "compared": d_compared,
            "conf_max_rel": d_worst,
            "wires": paced_stats.get("wire_dispatches")}

        # 3. The two-child LocalFleet, idle since it became ready.
        fleet_thread.join(timeout=200)
        if "endpoints" not in fleet_box:
            fail(f"[serve] the fleet did not start: {fleet_box.get('error')!r}")
        endpoints, fleet_ready = fleet_box["endpoints"], fleet_box["ready_s"]
        t0 = time.perf_counter()
        with FleetClient(endpoints, timeout=120.0) as client:
            fids = [client.open() for _ in range(S)]
            homes = {client.home(f) for f in fids}
            for a in range(0, len(pcms[0]), RATE):  # 1 s of every stream a round
                for i, fid in enumerate(fids):
                    pcm, enc = chunk(i, a, a + RATE)
                    client.feed(fid, pcm.tobytes() if enc else pcm, wire=enc or "i16")
            fleet_finals = [client.finalize(f) for f in fids]
        fleet_s = time.perf_counter() - t0
        if homes != set(endpoints):
            fail(f"[serve] the fleet placed streams on {homes} of {endpoints}")
        f_compared, f_worst = check_verdicts("[serve] fleet vs in process", fleet_finals, finals,
                                             margins)
        print(f"[serve] fleet: 2 children on the card ready {fleet_ready:.2f} s after their "
              f"spawn (beside the daemon's), {S} streams round-robined in {fleet_s:.2f} s; "
              f"verdicts equal the in-process ones on {f_compared} of {S} streams, "
              f"confidences within {f_worst:.2e} relative")
        report["serve_fleet"] = {"ready_s": fleet_ready, "s": fleet_s, "compared": f_compared,
                                 "conf_max_rel": f_worst}
    finally:
        if bare.poll() is None:
            bare.kill()
            bare.wait(timeout=10)
        if fleet_thread.ident is not None:  # started
            fleet_thread.join(timeout=200)
        fleet.stop()


def local_mesh_phase(net, S: int, n: int, chunk, dev, card, report) -> None:
    """``[serve]``: the identifier slot-sharded over ``[card, card]`` (two
    shards on one card; and over every card when there are several),
    ticked in turns with an unsharded one on the same feeds (the 100 ms
    chunks of (1)): every finalize verdict the unsharded one's (the speaker,
    the confidence within ``VERDICT_CONF_RTOL``); each tick timed by the
    host clock between synchronisations."""
    from streamz_tpu_torch.app.serve import MultiStreamIdentifier

    meshes = {"2 shards on one card": [str(dev)] * 2}
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        meshes[f"{n_cards} cards"] = [f"cuda:{i}" for i in range(n_cards)]
    report["serve_local_mesh"] = {}
    for label, devices in meshes.items():
        pair = {"unsharded": MultiStreamIdentifier(net, n_streams=S, threshold=0.0),
                "sharded": MultiStreamIdentifier(net, n_streams=S, threshold=0.0,
                                                 mesh=devices)}
        ticks = {k: [] for k in pair}
        for srv in pair.values():
            for _ in range(S):
                srv.open()
        for a in range(0, n, SERVE_CHUNK):
            for k, srv in pair.items():
                for i in range(S):
                    srv.feed(i, *chunk(i, a, a + SERVE_CHUNK))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                srv.tick()
                torch.cuda.synchronize()
                ticks[k].append(time.perf_counter() - t0)
        fin = {k: [srv.finalize(i) for i in range(S)] for k, srv in pair.items()}
        for i, (got, want) in enumerate(zip(fin["sharded"], fin["unsharded"])):
            if (got is None) != (want is None) or got is not None and (
                    got[0] != want[0]
                    or abs(got[1] - want[1]) > VERDICT_CONF_RTOL * abs(want[1])):
                fail(f"[serve] {label}: stream {i} sharded {got}, unsharded {want}")
        ms = {k: float(np.median(v)) * 1e3 for k, v in ticks.items()}
        print(f"[serve] local-device identifier over {devices} ({label}): {S} streams, every "
              f"finalize verdict the unsharded identifier's (confidences within "
              f"{VERDICT_CONF_RTOL:g}); tick ms p50 (synchronised, in turns) sharded "
              f"{ms['sharded']:.3f} vs unsharded {ms['unsharded']:.3f} | {card}")
        report["serve_local_mesh"][label] = {"devices": devices, "tick_ms_p50": ms,
                                             "ticks": len(ticks["sharded"])}


def multichip_phase(card, report) -> None:
    """``[multichip]``: ``entry()`` on the card against the CPU's, then the
    port's ``dryrun_multichip`` over two ranks sharing the card (gloo) and
    over one rank (NCCL): every program ``ok`` (a failure raises)."""
    from streamz_tpu_torch import entry as tentry

    fn, args = tentry.entry()
    fn_cpu, args_cpu = tentry.entry(device="cpu")
    with torch.no_grad():
        got, want = fn(*args).cpu().numpy(), fn_cpu(*args_cpu).numpy()
    err = float(np.abs(got - want).max()) if got.shape == want.shape else math.inf
    if not np.isfinite(got).all() or err > GPU_VS_CPU_TOL:
        fail(f"[multichip] entry() on the card {got.shape}, {err:.2e} from the CPU's")
    report["multichip"] = {"entry_max_abs_vs_cpu": err}
    for n in (2, 1):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = tentry.dryrun_multichip(n)
        wall = time.perf_counter() - t0
        line = next(ln for ln in buf.getvalue().splitlines()
                    if ln.startswith("multichip programs:"))
        backend = "gloo" if n > torch.cuda.device_count() else "nccl"
        print(f"[multichip] dryrun_multichip({n}), {n} rank(s) over {backend}: "
              f"{sum(v == 'ok' for v in res.values())} of {len(tentry.PROGRAMS)} programs ok "
              f"({line}) in {wall:.1f} s; entry() vote sums {got.shape}, {err:.2e} from "
              f"the CPU's | {card}")
        report["multichip"][f"{n} ranks"] = {"results": res, "wall_s": wall,
                                             "backend": backend}


# ---------------------------------------------------------------------------
# [native] and [dist].
# ---------------------------------------------------------------------------


def native_phase(work: str, names, query_pcm, card, report):
    """``[native]``: the C++ ingest layer (built by g++ into ``_build/``) on
    the smoke corpus (the 64 training WAVs, and 16 held-out clips written
    with 48 kHz and 22.05 kHz headers so the resampler runs) against the
    Python thread pool: bit for bit, both timed (host code)."""
    from streamz_tpu_torch.io import audio, native, wav

    if not native.available():
        fail(f"[native] the C++ ingest layer is unavailable: {native.unavailable_reason}")
    paths = [str(Path(work) / n) for n in names]
    for i in range(16):
        p = str(Path(work) / f"native_{i:02d}.wav")
        wav.write_wav(p, query_pcm[i], sample_rate=(48000, 22050)[i % 2])
        paths.append(p)
    runs = {"native": [], "thread pool": []}
    outs = {}
    for which in ("thread pool", "native", "native", "thread pool"):
        t0 = time.perf_counter()
        got = (audio.batch_resample(paths) if which == "native"
               else audio.batch_resample_threads(paths))
        runs[which].append((time.perf_counter() - t0) * 1e3)
        outs[which] = got
    a, b = outs["native"], outs["thread pool"]
    if [p for p, _ in a] != paths or [p for p, _ in b] != paths:
        fail("[native] a clip was dropped")
    if not all(np.array_equal(x, y) and x.dtype == y.dtype for (_, x), (_, y) in zip(a, b)):
        fail("[native] the native ingest differs from the thread pool's")
    audio_s = sum(len(x) for _, x in a) / RATE
    print(f"[native] {len(paths)} WAVs ({audio_s:.0f} s of 44.1 kHz audio after "
          f"resampling 16 of them): native ingest {runs['native'][0]:.1f} / "
          f"{runs['native'][1]:.1f} ms, Python thread pool {runs['thread pool'][0]:.1f} / "
          f"{runs['thread pool'][1]:.1f} ms (order: pool, native, native, pool), "
          f"bit-identical; library {native.so_path().name}, {os.cpu_count()} host cores "
          f"| {card}")
    report["native"] = {"clips": len(paths), "audio_s": audio_s, "ms": runs,
                        "host_cores": os.cpu_count()}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(mode: str, dirs, extra=(), env=None, tag=None):
    """Run ``chip_smoke.py --dist-worker <mode>`` as ``len(dirs)`` ranks,
    rank r in ``dirs[r]``, each rank's output in
    ``chiprun_out/chip_smoke_dist_<tag>_<r>.log`` (``tag`` defaults to
    ``mode``); kills every rank at ``DIST_DEADLINE_S`` and fails; returns
    each rank's ``out_<r>.json``."""
    import subprocess

    world, port = len(dirs), _free_port()
    tag = tag or mode
    env = dict(os.environ if env is None else env, PYTHONPATH=str(HERE))
    logs = HERE / "chiprun_out"
    logs.mkdir(exist_ok=True)
    procs, files = [], []
    for r, d in enumerate(dirs):
        f = open(logs / f"chip_smoke_dist_{tag}_{r}.log", "w")
        files.append(f)
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), "--dist-worker", mode, str(r),
             str(world), str(port), str(d), *extra],
            cwd=str(d), env=env, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DIST_DEADLINE_S
    try:
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                fail(f"[dist] {mode}: rank {r} of {world} missed the "
                     f"{DIST_DEADLINE_S} s deadline (logs in chiprun_out/)")
            if rc != 0:
                fail(f"[dist] {mode}: rank {r} of {world} exited {rc}: "
                     + (logs / f"chip_smoke_dist_{tag}_{r}.log").read_text()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    return [json.loads((Path(d) / f"out_{r}.json").read_text()) for r, d in enumerate(dirs)]


def dist_worker(argv) -> int:
    """One rank of a ``[dist]`` job: ``<mode> <rank> <world> <port> <dir>
    [cli args]``.  ``cli``: the CLI with the multi-process flags (none for a
    world of 1) in ``dir``; ``lib``: the DP corpus training, the PCM-halo
    frontend, the batched and long-clip identify over the mesh; ``nccl``:
    the DP step over a 1-rank NCCL group.  Each writes ``out_<rank>.json``
    (and rank 0 of ``lib`` its arrays to ``out.npz``) with its kernel
    counts."""
    mode, rank, world, port, work = argv[0], int(argv[1]), int(argv[2]), argv[3], Path(argv[4])
    sys.path.insert(0, str(HERE))
    from streamz_tpu_torch import config
    from streamz_tpu_torch.app.corpus import train_corpus
    from streamz_tpu_torch.dsp import mfcc_kernel
    from streamz_tpu_torch.dsp.features import FeatureExtractor
    from streamz_tpu_torch.infer.identify import identify_speaker, identify_speaker_list_batch
    from streamz_tpu_torch.nn import checkpoint
    from streamz_tpu_torch.nn import train_kernels as tk
    from streamz_tpu_torch.nn.forward_kernel import forward_probs_k7
    from streamz_tpu_torch.nn.model import SpeakerNet
    from streamz_tpu_torch.parallel import comm
    from streamz_tpu_torch.parallel import data_parallel as dp
    from streamz_tpu_torch.parallel import window_parallel as wp

    counters = {**mfcc_kernel.WRAPPERS, "K5": tk.corpus_grads_k5, "K6": tk.train_windows_k6,
                "K7": forward_probs_k7}

    def zero():
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {k: c.launches for k, c in counters.items()}

    out = {}
    if mode == "cli":
        os.chdir(work)
        flags = [] if world == 1 else ["--coordinator", f"127.0.0.1:{port}",
                                       "--num-processes", str(world), "--process-id", str(rank)]
        zero()
        t0 = time.perf_counter()
        rc, lines, rep = run_cli(list(argv[5:]) + flags)
        out = {"rc": rc, "lines": lines, "counts": counts(), "s": time.perf_counter() - t0,
               "phase_s": rep.get("phase_seconds"), "metrics": rep.get("metrics"),
               "processed": len(rep.get("decision_margins") or []),
               "store_stats": rep.get("store_stats")}
        (work / f"out_{rank}.json").write_text(json.dumps(out))
        return 0 if rc == 0 else 1

    dev = comm.initialize_distributed(f"127.0.0.1:{port}", world, rank)
    mesh = comm.make_mesh()
    if mode == "scan":
        return scan_worker(work, rank, mesh, dev, zero, counts, out)
    d = np.load(work / "in.npz")
    ns = int(d["ns"])
    out.update(backend=comm.backend(), device=str(dev))

    def step_times(params, x, y, w):
        """(K5 sums ms, all-reduce ms) per step on this rank's rows: CUDA
        events around each, medians of DIST_TIMED_STEPS."""
        k5, ar = [], []
        rows = tk.Batch(x, y, w)
        flat = tk.corpus_rows_sums_k5(params, rows, ns)  # warm
        comm.psum(flat, mesh)
        for _ in range(DIST_TIMED_STEPS):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            flat = tk.corpus_rows_sums_k5(params, rows, ns)
            e[1].record()
            comm.psum(flat, mesh)
            e[2].record()
            torch.cuda.synchronize()
            k5.append(e[0].elapsed_time(e[1]))
            ar.append(e[1].elapsed_time(e[2]))
        return float(np.median(k5)), float(np.median(ar))

    pool_x, pool_y = d["pool_x"], d["pool_y"]
    n_step = min(4096, len(pool_x))  # one corpus step's rows
    if mode == "nccl":
        x, y = pool_x[:n_step], pool_y[:n_step]
        w = np.ones(n_step, np.float32)
        net = SpeakerNet.new(output=ns, seed=0, device=dev)
        p_dp, p_sums, p_step = (net.working_params() for _ in range(3))
        zero()
        _, loss = dp.make_dp_train_step(mesh)(p_dp, x, y, w, ns, K5_LR)
        out["counts"] = counts()
        batch = tk.Batch(*(torch.from_numpy(a).to(dev) for a in (x, y, w)))
        grads, loss_sum, count = tk.corpus_rows_grads_k5(p_sums, batch, ns)
        tk._apply_step(p_sums, grads, loss_sum, count, K5_LR)
        tk.corpus_step_k5(p_step, batch, ns, K5_LR)
        out["vs_sums_bit_identical"] = all(torch.equal(p_dp[k], p_sums[k]) for k in p_dp)
        out["vs_step_max_abs"] = max(float((p_dp[k] - p_step[k]).abs().max()) for k in p_dp)
        out["loss"] = float(loss)
        out["k5_ms"], out["all_reduce_ms"] = step_times(
            p_dp, *(t[: n_step // world] for t in batch))
        (work / f"out_{rank}.json").write_text(json.dumps(out))
        comm.shutdown()
        return 0

    # lib: the DP corpus training as the corpus phase runs it.
    net = SpeakerNet.new(output=ns, seed=0, device=dev)
    zero()
    t0 = time.perf_counter()
    losses = train_corpus(net, pool_x, pool_y, epochs=config.TRAIN_EPOCHS, lr=K5_LR,
                          dropout=config.DEFAULT_DROPOUT, mesh=mesh, seed=0)
    torch.cuda.synchronize()
    out["corpus_s"] = time.perf_counter() - t0
    out["corpus_counts"] = counts()
    arrays = {f"corpus_{k}": v.cpu().numpy() for k, v in net.params.items()}
    arrays["corpus_losses"] = np.asarray(losses)
    bl = n_step // world
    lo = rank * bl
    out["k5_ms"], out["all_reduce_ms"] = step_times(
        net.working_params(), torch.from_numpy(pool_x[lo:lo + bl]).to(dev),
        torch.from_numpy(pool_y[lo:lo + bl]).to(dev), torch.ones(bl, device=dev))
    zero()
    t0 = time.perf_counter()
    arrays["halo_feats"] = wp.mfcc_features_pcm_sharded(d["long"], mesh)
    out["halo_s"] = time.perf_counter() - t0
    out["halo_counts"] = counts()
    trained = checkpoint.load(str(work / "model.npz"), device=dev)
    ex = FeatureExtractor(device=dev)
    out["resolved"] = ex.resolved()
    clips = list(d["clips"])
    zero()
    t0 = time.perf_counter()
    out["lists"] = identify_speaker_list_batch(trained, clips, config.DEFAULT_CONF_THRESHOLD,
                                               ex, mesh=mesh)
    out["long_id"] = identify_speaker(trained, d["long"], ex, mesh=mesh)
    out["identify_s"] = time.perf_counter() - t0
    out["identify_counts"] = counts()
    if rank == 0:
        np.savez(work / "out.npz", **arrays)
    (work / f"out_{rank}.json").write_text(json.dumps(out))
    comm.shutdown()
    return 0


def scan_worker(work: Path, rank: int, mesh, dev, zero, counts, out: dict) -> int:
    """One rank of ``[dist]``'s sharded scan: the discovery loop over
    ``scan.npz``'s files from the trained model, forced onto the sharded
    route and then onto the replicated one (K6), each from key 0; the
    all-reduces of the sharded run counted; the all-reduce of one chunk's
    buffer timed alone; then the measured scan choice with its two probe
    times, from a fresh cache (rank 0 writes it to ``scan_cache.json``).
    Writes ``out_<rank>.json`` and its parameters to ``scan_<rank>.npz``."""
    from streamz_tpu_torch import config
    from streamz_tpu_torch.app import device_loop as dl
    from streamz_tpu_torch.nn import checkpoint, drivers
    from streamz_tpu_torch.nn import train_kernels as tk
    from streamz_tpu_torch.parallel import comm
    from streamz_tpu_torch.runtime import autotune

    out.update(backend=comm.backend(), device=str(dev))
    d = np.load(work / "scan.npz")
    fm = {f"scan_{i}": d[f"f{i}"] for i in range(int(d["n"]))}
    all_reduces = [0]
    psum = comm.psum

    def counting(x, m):
        all_reduces[0] += 1
        return psum(x, m)

    comm.psum = counting
    arrays = {}
    for route, env in (("sharded", "1"), ("replicated", "0")):
        os.environ["STREAMZ_SHARD_DISCOVERY"] = env
        drivers._key_counter[0] = 0
        net = checkpoint.load(str(work / "model.npz"), device=dev)
        files = [(p, None) for p in fm]
        zero()
        all_reduces[0] = 0
        t0 = time.perf_counter()
        _, n, _, _, margins = dl.run_incremental_device(
            net, files, dict(fm), burn_in_limit=0,
            conf_threshold=config.DEFAULT_CONF_THRESHOLD, dropout=config.DEFAULT_DROPOUT,
            batch_size=config.BATCH_SIZE, epochs=config.INCREMENTAL_EPOCHS,
            max_speakers=None, show_progress=False, mesh=mesh)
        torch.cuda.synchronize()
        out[route] = {"s": time.perf_counter() - t0, "files": n, "counts": counts(),
                      "all_reduces": all_reduces[0], "labels": [c for _, c in files],
                      "margins": margins}
        arrays.update({f"{route}_{k}": v.cpu().numpy() for k, v in net.params.items()})
    comm.psum = psum
    os.environ.pop("STREAMZ_SHARD_DISCOVERY")
    # One chunk's all-reduce alone: the gradients, the loss and the count.
    buf = torch.zeros((tk.sums_size(net.params),), device=dev)
    ms = []
    for _ in range(DIST_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comm.psum(buf, mesh)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["all_reduce_ms"] = float(np.median(ms[1:]))
    out["all_reduce_bytes"] = buf.numel() * 4
    # The measured choice, probed afresh by every rank.
    os.environ["STREAMZ_AUTOTUNE_CACHE"] = str(work / "scan_cache.json")
    os.environ.pop("STREAMZ_NO_AUTOTUNE", None)
    autotune.reset()
    first = d["f0"]
    bucket = config.next_pow2(-(-len(first) // config.BATCH_SIZE)) * config.BATCH_SIZE
    zero()
    out["choice"] = dl._resolve_scan_backend(mesh, config.INCREMENTAL_EPOCHS,
                                             config.BATCH_SIZE, net.working_params(),
                                             first.shape[1], bucket)
    out["probe_counts"] = counts()
    out["probe_s"] = autotune.probe_times[f"discovery_scan_{mesh.size()}dev:"
                                          f"{autotune.device_kind()}"]
    np.savez(work / f"scan_{rank}.npz", **arrays)
    (work / f"out_{rank}.json").write_text(json.dumps(out))
    comm.shutdown()
    return 0


def eval_noise(cli, dev):
    """How far apart the runs' models score the --eval targets: the largest
    difference of any target's cosine similarity to any stored centroid
    between the single process's model.npz and a rank's, and how many
    targets lie within it of an --eval decision (their top-two gap, or
    their best similarity's distance to the threshold)."""
    from streamz_tpu_torch import config
    from streamz_tpu_torch.dsp.features import FeatureExtractor
    from streamz_tpu_torch.infer.cosine import cosine_matrix_many
    from streamz_tpu_torch.infer.embed import batch_clip_embeddings
    from streamz_tpu_torch.io import audio, filelists
    from streamz_tpu_torch.nn import checkpoint

    base = cli[1][0]
    targets = filelists.load_target_files(str(base / config.TARGET_FILE_LIST))
    pcms = [pcm for _, pcm in audio.batch_resample([str(base / p) for p, _ in targets])]
    feats = FeatureExtractor("pallas_v4", device=dev).extract_batch(pcms)

    def sims(d):
        net = checkpoint.load(str(d / config.MODEL_PATH), device=dev)
        cents = np.stack([np.asarray(m, np.float32) for m, _, _ in net.embeddings])
        return cosine_matrix_many(np.stack(batch_clip_embeddings(net, feats)), cents)

    s1 = sims(base)
    noise = max(float(np.abs(sims(d) - s1).max()) for d in cli[2])
    top = np.sort(s1, axis=1)[:, -2:]
    margin = np.minimum(top[:, 1] - top[:, 0],
                        np.abs(top[:, 1] - config.DEFAULT_CONF_THRESHOLD))
    return int((margin <= noise).sum()), noise


def scan_phase(work: str, root: Path, train_pcm, dev, card, report, by_path) -> Path:
    """``[dist]``'s sharded discovery scan at full width: the first
    ``SCAN_FILES`` training files (their K1 features) from the trained
    model, two gloo ranks sharing the card, forced sharded and then
    replicated (K6); labels equal, parameters within ``DIST_PARAM_TOL``,
    every rank's bits rank 0's.  Then the measured scan choice.  Returns
    the directory whose ``scan_cache.json`` holds that choice."""
    import shutil

    from streamz_tpu_torch import config
    from streamz_tpu_torch.app.device_loop import PROBE_FILES
    from streamz_tpu_torch.dsp.features import FeatureExtractor

    scan = root / "scan"
    scan.mkdir()
    feats = FeatureExtractor("pallas_v4", device=dev).extract_batch(list(train_pcm[:SCAN_FILES]))
    np.savez(scan / "scan.npz", n=SCAN_FILES, **{f"f{i}": f for i, f in enumerate(feats)})
    shutil.copy(Path(work) / config.MODEL_PATH, scan / "model.npz")
    t0 = time.perf_counter()
    outs = spawn_ranks("scan", [scan, scan])
    wall = time.perf_counter() - t0
    arrays = [dict(np.load(scan / f"scan_{r}.npz")) for r in range(len(outs))]
    for r, (o, a) in enumerate(zip(outs, arrays)):
        if o["backend"] != "gloo":
            fail(f"[dist] scan rank {r}: backend {o['backend']}")
        if any(not np.array_equal(v, arrays[0][k]) for k, v in a.items()):
            fail(f"[dist] scan rank {r}'s parameters differ from rank 0's")
        for route, k6 in (("sharded", 0), ("replicated", SCAN_FILES)):
            by_path[f"[dist] scan rank {r}, {route}"] = o[route]["counts"]
            if o[route]["counts"]["K6"] != k6 or o[route]["files"] != SCAN_FILES:
                fail(f"[dist] scan rank {r}, {route}: {o[route]['files']} files, "
                     f"launches {o[route]['counts']}")
        by_path[f"[dist] scan rank {r}, probe"] = o["probe_counts"]
        if o["sharded"]["labels"] != outs[0]["replicated"]["labels"]:
            fail(f"[dist] scan rank {r}: sharded labels {o['sharded']['labels']}, "
                 f"replicated {outs[0]['replicated']['labels']}")
        if o["choice"] != outs[0]["choice"]:
            fail(f"[dist] scan: rank {r} chose {o['choice']!r}, rank 0 {outs[0]['choice']!r}")
    err = max(float(np.abs(arrays[0][f"sharded_{k}"] - arrays[0][f"replicated_{k}"]).max())
              for k in ("w1", "b1", "w2", "b2", "w3", "b3"))
    o = outs[0]
    sh, rep = o["sharded"], o["replicated"]
    per_file = sh["all_reduces"] / SCAN_FILES
    margins = [m for m in sh["margins"] if math.isfinite(m)]
    ratio = o["probe_s"]["sharded"] / o["probe_s"]["single"]
    print(f"[dist] sharded discovery scan, {SCAN_FILES} files of 10 s at 60-512-256, capacity "
          f"{arrays[0]['sharded_b3'].shape[0]}, 2 gloo ranks on one card ({wall:.1f} s): "
          f"{sh['s'] / SCAN_FILES * 1e3:.1f} ms per file, {per_file:.0f} all-reduces per file "
          f"(one of {o['all_reduce_bytes']} B: {o['all_reduce_ms']:.3f} ms alone), no K6; "
          f"replicated route (K6) {rep['s'] / SCAN_FILES * 1e3:.1f} ms per file; labels "
          f"equal {sh['labels']}, parameters max abs {err:.2e} (bound {DIST_PARAM_TOL:g}), "
          f"every rank's bits rank 0's; smallest decision margin "
          f"{min(margins) if margins else float('inf'):.3e} | {card}")
    print(f"[dist] scan choice measured on this card: {o['choice']!r} (probes of "
          f"{PROBE_FILES} files at the leading bucket: 'single' {o['probe_s']['single'] * 1e3:.1f} ms, "
          f"'sharded' {o['probe_s']['sharded'] * 1e3:.1f} ms, {ratio:.0f}x), the same on "
          f"every rank | {card}")
    if err > DIST_PARAM_TOL:
        fail(f"[dist] the sharded scan's parameters lie {err:.2e} from the replicated route's")
    report["dist"]["scan"] = {
        "files": SCAN_FILES, "wall_s": wall, "err": err, "choice": o["choice"],
        "probe_s": o["probe_s"], "all_reduce_ms": o["all_reduce_ms"],
        "all_reduce_bytes": o["all_reduce_bytes"],
        "ranks": [{k: x[k] for k in ("sharded", "replicated", "probe_counts")} for x in outs]}
    return scan


def short_cli_phase(root: Path, train_pcm, spk, env, card, report, by_path) -> None:
    """``[dist]``: the CLI's default run as two ranks forced onto the
    sharded scan, on 16 training clips (2 of each speaker, 1 labelled) cut
    to 2.5 s, against the same two ranks forced onto the replicated route:
    the same ``train_files.txt``, no K6 on the sharded route."""
    from streamz_tpu_torch import config

    idx = [i for i in range(len(spk)) if i % CLIPS_PER_SPEAKER in (0, CLIPS_PER_SPEAKER // 2)]
    cut = int(SHORT_SECONDS * RATE)
    dirs = {route: [root / f"short_{route}_{r}" for r in range(2)]
            for route in ("sharded", "replicated")}
    cwd = os.getcwd()
    for ds in dirs.values():
        for d in ds:
            d.mkdir()
            os.chdir(d)
            write_corpus(train_pcm[idx, :cut], spk[idx], 1, "short")
    os.chdir(cwd)
    runs = {}
    for route, flag in (("sharded", "1"), ("replicated", "0")):
        runs[route] = spawn_ranks("cli", dirs[route], env=dict(env, STREAMZ_SHARD_DISCOVERY=flag),
                                  tag=f"cli_short_{route}")
        for r, o in enumerate(runs[route]):
            by_path[f"[dist] 2 processes, rank {r}, {len(idx)} x {SHORT_SECONDS} s, "
                    f"{route}"] = o["counts"]
            k6 = o["processed"] if route == "replicated" else 0
            if o["rc"] != 0 or o["processed"] != len(idx) or o["counts"]["K6"] != k6:
                fail(f"[dist] short CLI, {route}, rank {r}: {o['processed']} files, "
                     f"launches {o['counts']}")
    want = (dirs["replicated"][0] / config.TRAIN_FILE_LIST).read_text()
    for d in dirs["sharded"] + dirs["replicated"]:
        if (d / config.TRAIN_FILE_LIST).read_text() != want:
            fail(f"[dist] short CLI: {d.name}'s train_files.txt differs from the replicated "
                 "route's")
    sh = runs["sharded"][0]["phase_s"]["discovery"]
    rp = runs["replicated"][0]["phase_s"]["discovery"]
    print(f"[dist] CLI default run forced sharded (STREAMZ_SHARD_DISCOVERY=1), 2 ranks, "
          f"{len(idx)} clips of {SHORT_SECONDS} s: train_files.txt identical to the forced "
          f"replicated run's; discovery {sh:.2f} s ({sh / len(idx) * 1e3:.1f} ms per file), "
          f"replicated {rp:.2f} s ({rp / len(idx) * 1e3:.1f} ms per file) | {card}")
    report["dist"]["short_cli"] = {route: [{k: o[k] for k in ("s", "counts", "phase_s")}
                                           for o in v] for route, v in runs.items()}


def dist_phase(work: str, train_pcm, spk, query_pcm, pool, pool_y, dev, card, report,
               by_path):
    """``[dist]``: the multi-process run on the one card.  Two ranks over
    gloo sharing it: the DP corpus training against the single-process
    ``train_corpus`` (DIST_PARAM_TOL), the PCM-halo frontend against the
    unsharded K1 features (K1_TOL; the gap printed), the batched and the
    long-clip identify verdicts against one process's, and the CLI's
    default run and ``--eval`` as two processes against one (the same
    labels and metrics).  Then one rank over NCCL: the DP step against K5's
    sums and ``_apply_step``.  Every rank's K1, K5 and K6 counts are read
    from its own process; per-step K5 and all-reduce times per rank."""
    import shutil

    from streamz_tpu_torch import config
    from streamz_tpu_torch.app.corpus import train_corpus
    from streamz_tpu_torch.dsp import mfcc
    from streamz_tpu_torch.dsp.features import FeatureExtractor
    from streamz_tpu_torch.infer.identify import identify_speaker, identify_speaker_list_batch
    from streamz_tpu_torch.nn import checkpoint
    from streamz_tpu_torch.nn.model import SpeakerNet, forward
    from streamz_tpu_torch.parallel.window_parallel import LONG_CLIP_WINDOW_THRESHOLD

    root = Path(tempfile.mkdtemp(prefix="streamz_chip_smoke_dist_"))
    lib = root / "lib"
    lib.mkdir()
    long_pcm = np.concatenate(list(query_pcm[:17]))  # 170 s
    n_long = mfcc.window_count_host(len(long_pcm))
    if n_long < LONG_CLIP_WINDOW_THRESHOLD:
        fail(f"[dist] the long clip has {n_long} windows, under the threshold")
    np.savez(lib / "in.npz", pool_x=pool, pool_y=pool_y, ns=N_SPEAKERS, long=long_pcm,
             clips=query_pcm)
    shutil.copy(Path(work) / config.MODEL_PATH, lib / "model.npz")
    t0 = time.perf_counter()
    outs = spawn_ranks("lib", [lib, lib])
    lib_s = time.perf_counter() - t0
    arrays = np.load(lib / "out.npz")
    for r, o in enumerate(outs):
        if o["backend"] != "gloo" or o["device"] != "cuda:0" or o["resolved"] != "pallas_v4":
            fail(f"[dist] rank {r}: backend {o['backend']}, device {o['device']}, "
                 f"frontend {o['resolved']} (expected gloo, cuda:0, pallas_v4)")
        for what, key, kid in (("corpus", "corpus_counts", "K5"),
                               ("PCM halo", "halo_counts", "K1"),
                               ("identify", "identify_counts", "K1")):
            by_path[f"[dist] rank {r}, {what}"] = o[key]
            if o[key][kid] < 1:
                fail(f"[dist] rank {r} never launched {kid} in the {what} run: {o[key]}")
    # The single-process references on the card.
    net1 = SpeakerNet.new(output=N_SPEAKERS, seed=0, device=dev)
    losses1 = train_corpus(net1, pool, pool_y, epochs=config.TRAIN_EPOCHS, lr=K5_LR,
                           dropout=config.DEFAULT_DROPOUT, seed=0)
    corpus_err = max(float(np.abs(arrays[f"corpus_{k}"] - v.cpu().numpy()).max())
                     for k, v in net1.params.items())
    loss_err = float(np.abs(arrays["corpus_losses"] - np.asarray(losses1)).max())
    k1 = FeatureExtractor("pallas_v4", device=dev)
    want = k1.extract(long_pcm)
    halo = arrays["halo_feats"]
    if halo.shape != want.shape or not np.isfinite(halo).all():
        fail(f"[dist] PCM-halo features {halo.shape}, unsharded {want.shape}")
    halo_err = float(np.abs(halo - want).max())
    halo_bits = bool(np.array_equal(halo, want))
    trained = checkpoint.load(config.MODEL_PATH, device=dev)
    thr = config.DEFAULT_CONF_THRESHOLD
    clips = list(query_pcm)
    lists1 = identify_speaker_list_batch(trained, clips, thr, k1)
    compared = 0
    for i, f in enumerate(k1.extract_batch(clips)):
        with torch.no_grad():
            probs = forward(trained.params, torch.from_numpy(f).to(dev),
                            trained.num_speakers).cpu().numpy()
        _, soft = vote_check(probs, trained.num_speakers, thr, K1_TOL)
        if soft:
            continue  # a window within K1_TOL of changing its vote
        compared += 1
        for r, o in enumerate(outs):
            if o["lists"][i] != lists1[i]:
                fail(f"[dist] rank {r}: clip {i} votes {o['lists'][i]}, one process "
                     f"{lists1[i]}")
    long1 = identify_speaker(trained, long_pcm, k1)
    votes, count = offline_votes(trained, torch.from_numpy(want).to(dev))
    long_margin = vote_margin(votes, count, trained.num_speakers)
    if long_margin > K1_TOL and any(o["long_id"] != long1 for o in outs):
        fail(f"[dist] long-clip verdicts {[o['long_id'] for o in outs]}, one process {long1}")
    print(f"[dist] 2 ranks over gloo on one card ({lib_s:.1f} s): DP corpus training "
          f"({config.TRAIN_EPOCHS} epochs) vs one process: params max abs "
          f"{corpus_err:.2e} (bound {DIST_PARAM_TOL:g}), epoch losses {loss_err:.2e}; K5 "
          f"launches per rank {[o['corpus_counts']['K5'] for o in outs]}; per step and rank, "
          + "; ".join(f"rank {r}: K5 sums {o['k5_ms']:.3f} ms, all-reduce "
                      f"{o['all_reduce_ms']:.3f} ms" for r, o in enumerate(outs))
          + f" | {card}")
    print(f"[dist] PCM-halo frontend, a {n_long}-window clip: max abs vs the unsharded "
          f"K1 features {halo_err:.2e} (bound {K1_TOL:g}), bit-identical: {halo_bits}; K1 "
          f"launches per rank {[o['halo_counts']['K1'] for o in outs]}; identify: vote "
          f"lists equal on {compared}/{len(clips)} clips compared (none with a window "
          f"within {K1_TOL:g} of a vote change skipped otherwise), long-clip verdict "
          f"{[o['long_id'] for o in outs]} vs {long1} (margin {long_margin:.2e})")
    if corpus_err > DIST_PARAM_TOL or halo_err > K1_TOL:
        fail("[dist] the 2-rank run disagrees with one process")
    report["dist"] = {
        "lib_s": lib_s, "corpus_max_abs": corpus_err, "corpus_loss_max_abs": loss_err,
        "halo_max_abs": halo_err, "halo_bit_identical": halo_bits,
        "identify_compared": compared, "long_margin": long_margin,
        "ranks": [{k: o[k] for k in ("k5_ms", "all_reduce_ms", "corpus_s", "corpus_counts",
                                     "halo_counts", "identify_counts")} for o in outs]}

    scan_dir = scan_phase(work, root, train_pcm, dev, card, report, by_path)

    # The CLI: one process, then two, from a cold frontend cache (no probe
    # under a mesh: both run K1) and the scan choice the sharded scan's
    # probe cached (the replicated route, when the card decided so).
    cli = {1: [root / "single"], 2: [root / "p0", root / "p1"]}
    for d in cli[1] + cli[2]:
        d.mkdir()
        os.chdir(d)
        write_corpus(train_pcm, spk, LABELLED_PER_SPEAKER, "train")
    os.chdir(work)
    env = dict(os.environ, STREAMZ_AUTOTUNE_CACHE=str(scan_dir / "scan_cache.json"),
               STREAMZ_NO_AUTOTUNE="1")
    runs = {}

    def run(label, args, world):
        runs[label, world] = spawn_ranks("cli", cli[world], args, env=env,
                                         tag=f"cli_{label}_{world}p")
        for r, o in enumerate(runs[label, world]):
            by_path[f"[dist] {world} process(es), rank {r}, {label}"] = o["counts"]

    for world in cli:
        run("default run", (), world)
    want_labels = (cli[1][0] / config.TRAIN_FILE_LIST).read_text()
    for d in cli[2]:
        if (d / config.TRAIN_FILE_LIST).read_text() != want_labels:
            fail(f"[dist] {d.name}'s train_files.txt differs from the single process's")
    scan_choice = report["dist"]["scan"]["choice"]
    for r, o in enumerate(runs["default run", 2]):
        c = o["counts"]
        k6 = o["processed"] if scan_choice == "single" else 0
        if c["K1"] < 1 or c["K5"] < 1 or c["K6"] != k6:
            fail(f"[dist] CLI rank {r}: launches {c}, {o['processed']} files processed "
                 f"on the {scan_choice!r} route")
        st = o["store_stats"]
        if st is None or st["host_pack_bytes"] != 0:
            fail(f"[dist] CLI rank {r}: the mesh store's stats {st} (expected on, "
                 "host_pack_bytes 0)")
        if not any("Running on 2 devices" in ln and "gloo" in ln for ln in o["lines"]):
            fail(f"[dist] CLI rank {r} did not report the mesh")
    # --eval of each run's own model.npz (the ranks' differ from the single
    # process's by the DP corpus training's float noise, carried through the
    # discovery loop): informational, with how many targets lie within that
    # noise of a decision.  Then --eval of the single process's model.npz
    # as two processes: the same metrics, the gate.
    for world in cli:
        run("--eval, own model", ("--eval",), world)
    near, noise = eval_noise(cli, dev)
    own1 = runs["--eval, own model", 1][0]["metrics"]
    own2 = [o["metrics"] for o in runs["--eval, own model", 2]]
    for d in cli[2]:
        shutil.copy(cli[1][0] / config.MODEL_PATH, d / config.MODEL_PATH)
    run("--eval, one model", ("--eval",), 2)
    same = [o["metrics"] for o in runs["--eval, one model", 2]]
    for r, o in enumerate(runs["--eval, one model", 2]):
        if o["store_stats"] is None or o["store_stats"]["host_pack_bytes"] != 0:
            fail(f"[dist] CLI --eval rank {r}: the mesh store's stats {o['store_stats']}")
    single, two = runs["default run", 1][0], runs["default run", 2]
    print(f"[dist] CLI default run, one process {single['s']:.1f} s vs two over gloo "
          f"{max(o['s'] for o in two):.1f} s, the discovery loop on the cached "
          f"{scan_choice!r} route, each rank's store of its shards on (host_pack_bytes 0): "
          f"train_files.txt identical on both ranks; launches per rank "
          f"{[o['counts'] for o in two]}; phases one process {single['phase_s']}, rank 0 "
          f"{two[0]['phase_s']} | {card}")
    print(f"[dist] CLI --eval: one process's model.npz as two processes, through the "
          f"mesh store (host_pack_bytes 0): metrics "
          f"{'equal' if all(m == own1 for m in same) else 'DIFFER'} ({own1}); each "
          f"run's own model: accuracy {own1['accuracy']:.4f} (one process) vs "
          f"{[m['accuracy'] for m in own2]} (two), the models' similarities differ by up "
          f"to {noise:.2e} and {near} of the targets lie within that of a decision")
    if any(m != own1 for m in same):
        fail(f"[dist] --eval over two processes {same}, one process {own1}")
    report["dist"]["cli"] = {f"{a}, {w} process(es)": [
        {k: o[k] for k in ("s", "counts", "phase_s", "metrics", "processed")} for o in v]
        for (a, w), v in runs.items()}
    report["dist"]["eval_noise"] = {"similarity": noise, "targets_within": near}
    short_cli_phase(root, train_pcm, spk, env, card, report, by_path)

    # One rank over NCCL: the DP step.
    nccl = root / "nccl"
    nccl.mkdir()
    shutil.copy(lib / "in.npz", nccl / "in.npz")
    (o,) = spawn_ranks("nccl", [nccl])
    by_path["[dist] 1 rank over NCCL, DP step"] = o["counts"]
    if (o["backend"] != "nccl" or o["counts"]["K5"] != 1 or not o["vs_sums_bit_identical"]
            or o["vs_step_max_abs"] > K5_STEP_TOL):
        fail(f"[dist] NCCL: {o}")
    print(f"[dist] 1 rank over NCCL: DP step bit-identical to K5's sums + _apply_step, "
          f"{o['vs_step_max_abs']:.2e} from the step form (bound {K5_STEP_TOL:g}); per "
          f"step K5 sums {o['k5_ms']:.3f} ms, all-reduce {o['all_reduce_ms']:.3f} ms "
          f"| {card}")
    report["dist"]["nccl"] = o
    shutil.rmtree(root, ignore_errors=True)


class _Tee(io.TextIOBase):
    """Writes to every stream given: the standard output and the run's log
    (a remote run may hand back only the end of its output)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self) -> None:
        for st in self.streams:
            st.flush()

    def fileno(self) -> int:
        return self.streams[0].fileno()


def main() -> int:
    if not torch.cuda.is_available():
        fail("CUDA is not available; this check needs an NVIDIA GPU")
    missing = [n for n in SOURCES if not (CSRC / f"{n}.cu").exists()]
    if missing:
        fail(f"run from a checkout of the repository ({missing} missing in {CSRC})")
    sys.path.insert(0, str(HERE))
    (HERE / "chiprun_out").mkdir(exist_ok=True)
    sys.stdout = _Tee(sys.stdout, open(HERE / "chiprun_out" / "chip_smoke.log", "w"))

    from streamz_tpu_torch import _cuda_build, bench, config
    from streamz_tpu_torch.app.corpus import train_corpus
    from streamz_tpu_torch.app.incremental import run_incremental
    from streamz_tpu_torch.device import resolve_device
    from streamz_tpu_torch.dsp import features, mfcc, mfcc_kernel
    from streamz_tpu_torch.dsp.features import FeatureExtractor
    from streamz_tpu_torch.infer.cosine import cosine_matrix_many, identify_sims_cosine
    from streamz_tpu_torch.infer.embed import batch_clip_embeddings
    from streamz_tpu_torch.infer.identify import identify_speaker_list_batch
    from streamz_tpu_torch.io import filelists, native, wav
    from streamz_tpu_torch.io.audio import batch_resample
    from streamz_tpu_torch.nn import checkpoint, drivers, prng
    from streamz_tpu_torch.nn import train_kernels as tk
    from streamz_tpu_torch.nn import forward_kernel as fk
    from streamz_tpu_torch.nn.forward_kernel import forward_probs_k7, forward_probs_plain
    from streamz_tpu_torch.nn.model import forward, init_params
    from streamz_tpu_torch.nn.train import file_epoch_views
    from streamz_tpu_torch.runtime import autotune
    from streamz_tpu_torch.runtime.measure import chain_timer

    def time_ms(fn, iters: int) -> float:
        """Milliseconds per call: CUDA events around ``iters`` calls after
        one warm-up call."""
        return chain_timer(fn, iters=iters, repeats=1) * 1e3

    dev = resolve_device("cuda")
    card = bench.card_line()
    kind = torch.cuda.get_device_name(0)
    report = {"card": card, "kind": kind, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t_start = time.perf_counter()
    marks = []  # (phase, start time): the script's seconds by phase

    def mark(label):
        marks.append((label, time.perf_counter()))

    # 1. Build every kernel, one nvcc per source, all at once.
    mark("build")
    t0 = time.perf_counter()
    # The native ingest layer (g++) builds beside the kernels (nvcc), so
    # that no phase time below holds a build.
    with ThreadPoolExecutor(max_workers=1) as pool:
        native_build = pool.submit(native.load)
        _cuda_build.build_all(SOURCES)
    if native_build.result() is None:
        fail(f"the native ingest layer did not build: {native.unavailable_reason}")
    build_s = time.perf_counter() - t0
    print(f"[build] K1-K7 and {native.so_path().name} built in {build_s:.2f} s; shared "
          "memory per block: " + ", ".join(
              f"{k} {mfcc_kernel.smem_bytes(src)} B" for k, src in mfcc_kernel.SOURCES.items()))
    for name, log in _cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {SOURCES[name]} ptxas: {line.strip()}")
    report["build_s"] = build_s

    # Synthetic corpus, made on the card from the seed: 8 training and 8
    # held-out clips per speaker.
    mark("data")
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

    mark("K1-K4 checks")
    # 2. K1-K4 vs their plain versions on the card, and each kernel
    # backend on the golden clip.  These launches are checks, not the main
    # path: the counts are zeroed before each path below.
    n = query_pcm.shape[1]
    tlen = mfcc._bucket_len(n)
    main_batch = np.zeros((len(query_pcm), tlen), np.float32)
    main_batch[:, :n] = mfcc._to_f32(query_pcm)
    main_pcm = torch.from_numpy(main_batch).to(dev)
    shapes = [(1, 800), (1, 2000), (2, 4000), (1, 208000), (3, 208000),
              (129, 1600), (513, 800), (2, 399)]
    plain_base = {
        "K1": lambda x: mfcc_kernel.mfcc_base_bf16x3_plain(x, True, tail_fold=True),
        "K2": lambda x: mfcc_kernel.mfcc_base_bf16x3_plain(x, True),
        "K3": lambda x: mfcc_kernel.mfcc_base_bf16x3_plain(x, False),
        "K4": mfcc_kernel.mfcc_base_frames_plain,
    }
    # K1 draws from the run's generator as before K2-K4 existed; they draw
    # from their own, so the data of the later phases is unchanged.
    check_gen = torch.Generator(device=dev)
    check_gen.manual_seed(SEED + 1)
    mfcc_errs = {}
    for kid, wrapper in mfcc_kernel.WRAPPERS.items():
        errs = {}
        for B, T in shapes:
            g = gen if kid == "K1" else check_gen
            pcm = torch.randn((B, T), generator=g, device=dev) * 0.1
            got = wrapper(pcm)
            want = plain_base[kid](pcm)
            torch.cuda.synchronize()
            if got.shape != want.shape:
                fail(f"{kid} shape {tuple(got.shape)} != plain {tuple(want.shape)} at {(B, T)}")
            errs[f"{B}x{T}"] = float((got - want).abs().max()) if got.numel() else 0.0
        # The edges of their tile, as the card tests hold them (offset 1: a
        # base one float past a 16-byte boundary).
        for B, T, off in TC_EDGES:
            flat = torch.randn((B * T + off,), generator=check_gen, device=dev) * 0.1
            pcm = flat[off:].view(B, T)
            got = wrapper(pcm)
            want = plain_base[kid](pcm)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"{kid} at {(B, T, off)}: {tuple(got.shape)} vs {tuple(want.shape)}")
            errs[f"{B}x{T}+{off}"] = float((got - want).abs().max())
        got = wrapper(main_pcm)
        want = plain_base[kid](main_pcm)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{kid} at the main-path shape: {tuple(got.shape)} vs {tuple(want.shape)}")
        again = wrapper(main_pcm)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{kid}: two launches at the main-path shape differ")
        del again
        errs[f"{main_pcm.shape[0]}x{main_pcm.shape[1]} (main path)"] = float(
            (got - want).abs().max())
        del got, want
        print(f"[{kid.lower()}-vs-plain] max abs err by shape: " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items()) + f" (bound {K1_TOL:g})")
        if max(errs.values()) > K1_TOL:
            fail(f"{kid} disagrees with its plain version: {errs}")
        mfcc_errs[kid] = errs
    golden_clip = np.load(FIXTURES / "golden_clip.npy")
    golden = np.load(FIXTURES / "golden_features.npy")
    golden_errs = {}
    for kid, backend in BACKENDS.items():
        got = FeatureExtractor(backend, device=dev).extract(golden_clip)
        if got.shape != golden.shape:
            fail(f"{kid} golden features shape {got.shape} != {golden.shape}")
        golden_errs[kid] = float(np.abs(got - golden).max())
    print("[golden] features vs golden_features.npy: " + ", ".join(
        f"{k} ({BACKENDS[k]}) {v:.2e}" for k, v in golden_errs.items())
        + f" (bound {K1_TOL:g})")
    if max(golden_errs.values()) > K1_TOL:
        fail(f"a kernel backend misses the golden features: {golden_errs}")
    report["mfcc_max_abs_err"] = mfcc_errs
    report["golden_max_abs_err"] = golden_errs

    mark("K5/K6 checks")
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
    k5_errs, k5_abs, k5_step_err = {}, 0.0, 0.0

    def k5_check(label, params, rows, ns):
        """K5's sums form twice and its step form once on ``rows`` against
        the plain gather, gradients and step: returns the plain sums."""
        nonlocal k5_abs, k5_step_err
        g1, loss1, cnt1 = tk.corpus_rows_grads_k5(params, rows, ns)
        g2, loss2, _ = tk.corpus_rows_grads_k5(params, rows, ns)
        want, wloss, wcnt = tk.corpus_grads_plain(params, *tk.rows_plain(rows), ns)
        stepped = {k: v.clone() for k, v in params.items()}
        ref = {k: v.clone() for k, v in params.items()}
        tk.corpus_step_k5(stepped, rows, ns, K5_LR)
        tk._apply_step(ref, want, wloss, wcnt, K5_LR)
        torch.cuda.synchronize()
        if not all(torch.equal(g1[k], g2[k]) for k in g1) or float(loss1) != float(loss2):
            fail(f"K5 is not bit-reproducible: {label}")
        rel = max(float((g1[k] - want[k]).abs().max()) / max(1.0, float(want[k].abs().max()))
                  for k in want)
        loss_err = abs(float(loss1) - float(wloss)) / max(1.0, abs(float(wloss)))
        step_err = max(float((stepped[k] - ref[k]).abs().max()) for k in ref)
        k5_errs[label] = (rel, loss_err, step_err)
        k5_abs = max(k5_abs, max(float((g1[k] - want[k]).abs().max()) for k in want))
        k5_step_err = max(k5_step_err, step_err)
        if (not math.isfinite(rel) or rel > K5_TOL or not math.isfinite(loss_err)
                or loss_err > K5_TOL or float(cnt1) != float(wcnt)
                or not math.isfinite(step_err) or step_err > K5_STEP_TOL):
            fail(f"K5 disagrees with its plain version, {label}: grads {rel}, loss sum "
                 f"{loss_err}, count {float(cnt1)} vs {float(wcnt)}, step {step_err}")
        return want

    for cap, B in ((128, 4096), (128, 1531), (1024, 4096), (4096, 777)):
        params = init_params(*dims[:3], cap, seed=SEED, device=dev)
        ns = N_SPEAKERS if cap == 128 else cap - 28
        x, y, w = k5_x[:B], k5_y[:B], k5_w[:B]
        if cap != 128:  # labels over the whole capacity, some past the live classes
            y = torch.randint(0, cap + 50, (B,), generator=gen, device=dev).to(torch.int32)
        k5_check(f"cap{cap}xB{B}", params, tk.Batch(x, y, w), ns)
    # The pool route as the corpus phase runs it: the labelled pool on the
    # card, epoch 0's order and keep mask (dropout 0.2) drawn as train_corpus
    # draws them, its first step and its ragged last one.
    pool_dev = torch.from_numpy(pool).to(dev)
    pool_y_dev = torch.from_numpy(pool_y).to(dev)
    drng = np.random.default_rng(SEED)
    perm = drng.permutation(len(pool)).astype(np.int32)
    keep_all = drng.random(pool.shape, dtype=np.float32) >= config.DEFAULT_DROPOUT
    k5_steps = -(-len(pool) // 4096)
    order_all = np.zeros(k5_steps * 4096, np.int32)
    order_all[:len(pool)] = perm
    order_dev = torch.from_numpy(order_all).to(dev)
    keep_dev = torch.from_numpy(keep_all.view(np.uint8)).to(dev)
    k5_pool_rows = {}
    for s_ in (0, k5_steps - 1):
        lo, real = s_ * 4096, min(4096, len(pool) - s_ * 4096)
        rows = tk.PoolRows(pool_dev, pool_y_dev, order_dev[lo:lo + 4096],
                           keep_dev[lo:lo + real], real)
        k5_pool_rows[real] = rows
        want = k5_check(f"pool step {s_} ({real} real rows of 4096, dropout "
                        f"{config.DEFAULT_DROPOUT:g})", init_params(*dims[:3], 128, seed=SEED,
                                                                    device=dev), rows, N_SPEAKERS)
        # The plain gather against the host gather of the JAX package's route.
        hx = pool[order_all[lo:lo + 4096]]
        hw = (np.arange(4096) < real).astype(np.float32)
        hx[:real] = hx[:real] * keep_all[lo:lo + real]
        hw = hw * np.any(hx != 0.0, axis=-1)
        gx, _, gw = tk.rows_plain(rows)
        if not (np.array_equal(gx.cpu().numpy(), hx) and np.array_equal(gw.cpu().numpy(), hw)):
            fail(f"the plain pool gather differs from the host gather at step {s_}")
    for k, (v, le, se) in k5_errs.items():
        print(f"[k5-vs-plain] {k}: max err / max |grad| {v:.3e}, loss sum err "
              f"{le:.3e} (bound {K5_TOL:g} each); step form params max abs err {se:.3e} "
              f"(bound {K5_STEP_TOL:g}); two runs bit-identical")
    report["k5_max_rel_err"] = k5_errs
    report["k5_max_abs_err"] = k5_abs
    report["k5_step_max_abs_err"] = k5_step_err

    file_w = feats[0]
    n_pad = config.next_pow2(-(-len(file_w) // config.BATCH_SIZE)) * config.BATCH_SIZE
    padded = torch.zeros((n_pad, config.FEATURE_SIZE), device=dev)
    padded[:len(file_w)] = torch.from_numpy(file_w).to(dev)
    dropped, valid = file_epoch_views(padded, len(file_w), prng.PRNGKey(1, dev),
                                      config.DEFAULT_DROPOUT, config.INCREMENTAL_EPOCHS)
    k6_chunks = dropped.reshape(-1, config.BATCH_SIZE, config.FEATURE_SIZE).contiguous()
    k6_masks = valid.reshape(-1, config.BATCH_SIZE).contiguous()
    # K6 at capacity 128 (w3 in the cluster's shared memory) and 4096 (w3
    # in device memory): against the plain loop, and two launches bit for bit.
    k6_tvecs, k6_params, k6_plans, k6_errs = {}, {}, {}, {}
    for cap in K6_CAPS:
        k6_tvecs[cap] = torch.zeros(cap, device=dev)
        k6_tvecs[cap][3] = 1.0
        k6_params[cap] = init_params(*dims[:3], cap, seed=SEED, device=dev)
        k6_plans[cap] = tk.k6_plan(*dims[:3], cap, config.BATCH_SIZE)
        got_p = {k: v.clone() for k, v in k6_params[cap].items()}
        again_p = {k: v.clone() for k, v in k6_params[cap].items()}
        want_p = {k: v.clone() for k, v in k6_params[cap].items()}
        args = (k6_chunks, k6_masks, k6_tvecs[cap], N_SPEAKERS + 1, config.LR_EARLY)
        gl, gc = tk.train_windows_k6(got_p, *args)
        al, ac = tk.train_windows_k6(again_p, *args)
        wl, wc = tk.train_windows_plain(want_p, *args)
        torch.cuda.synchronize()
        if (not all(torch.equal(got_p[k], again_p[k]) for k in got_p)
                or float(gl) != float(al) or float(gc) != float(ac)):
            fail(f"K6 is not bit-reproducible at capacity {cap}")
        err = max(float((got_p[k] - want_p[k]).abs().max()) for k in want_p)
        loss_err = abs(float(gl) - float(wl)) / max(1.0, abs(float(wl)))
        cluster, route = k6_plans[cap]
        print(f"[k6-vs-plain] capacity {cap} ({cluster} CTAs, w3 in {route}): one "
              f"{len(file_w)}-window file, {k6_chunks.shape[0]} chunk steps: params max "
              f"abs err {err:.3e}, loss sum err {loss_err:.3e} (bound {K6_TOL:g} each); "
              f"loss {float(gl):.6f} vs {float(wl):.6f}, count {float(gc):g} vs "
              f"{float(wc):g}; two launches bit-identical")
        if (not math.isfinite(err) or err > K6_TOL or not math.isfinite(loss_err)
                or loss_err > K6_TOL or float(gc) != float(wc)):
            fail(f"K6 disagrees with its plain version at capacity {cap}: params "
                 f"{err}, loss sum {loss_err}, count {float(gc)} vs {float(wc)}")
        k6_errs[cap] = (err, loss_err)
    if [r for _, r in k6_plans.values()] != ["shared memory", "w3 in device memory"]:
        fail(f"K6's routes at capacities {K6_CAPS}: {k6_plans}")
    # K6 on its other routes, each on a short file of this clip's
    # windows (5 epochs, 160 chunk steps): chunks of 64 and 48 windows (row
    # tiles of 32, the second of 48's ragged) and H1 = 4096 (every weight
    # and activation in device memory).
    k6_short = {}
    for label, (h1w, B, npad, nv) in {"B=64": (config.HIDDEN1, 64, 2048, len(file_w)),
                                      "B=48": (config.HIDDEN1, 48, 1536, len(file_w)),
                                      "H1=4096": (4096, 8, 256, 200)}.items():
        win = torch.zeros((npad, config.FEATURE_SIZE), device=dev)
        win[:nv] = torch.from_numpy(file_w[:nv]).to(dev)
        d_s, v_s = file_epoch_views(win, nv, prng.PRNGKey(2, dev), config.DEFAULT_DROPOUT,
                                    config.INCREMENTAL_EPOCHS)
        sdims = (config.FEATURE_SIZE, h1w, config.HIDDEN2, 128)
        entry = {"chunks": d_s.reshape(-1, B, config.FEATURE_SIZE).contiguous(),
                 "masks": v_s.reshape(-1, B).contiguous(), "dims": sdims,
                 "params": init_params(*sdims, seed=SEED, device=dev),
                 "plan": tk.k6_plan(*sdims, B), "B": B}
        args = (entry["chunks"], entry["masks"], k6_tvecs[128], N_SPEAKERS + 1,
                config.LR_EARLY)
        got_p, again_p, want_p = ({k: v.clone() for k, v in entry["params"].items()}
                                  for _ in range(3))
        gl, gc = tk.train_windows_k6(got_p, *args)
        al, ac = tk.train_windows_k6(again_p, *args)
        wl, wc = tk.train_windows_plain(want_p, *args)
        torch.cuda.synchronize()
        if (not all(torch.equal(got_p[k], again_p[k]) for k in got_p)
                or float(gl) != float(al) or float(gc) != float(ac)):
            fail(f"K6 is not bit-reproducible at {label}")
        err = max(float((got_p[k] - want_p[k]).abs().max()) for k in want_p)
        loss_err = abs(float(gl) - float(wl)) / max(1.0, abs(float(wl)))
        entry.update(err=err, loss_err=loss_err)
        print(f"[k6-vs-plain] {label} ({sdims[1]} -> {sdims[2]}, chunks of {B}; "
              f"{entry['plan'][0]} CTAs, route: {entry['plan'][1]}): "
              f"{entry['chunks'].shape[0]} chunk steps: params max abs err {err:.3e}, loss "
              f"sum err {loss_err:.3e} (bound {K6_SHORT_TOL:g} each); count {float(gc):g} vs "
              f"{float(wc):g}; two launches bit-identical")
        if (not math.isfinite(err) or err > K6_SHORT_TOL or not math.isfinite(loss_err)
                or loss_err > K6_SHORT_TOL or float(gc) != float(wc)):
            fail(f"K6 disagrees with its plain version at {label}: params {err}, loss sum "
                 f"{loss_err}, count {float(gc)} vs {float(wc)}")
        k6_short[label] = entry
    if [e["plan"][1] for e in k6_short.values()] != ["w3 in device memory"] * 2 + ["device memory"]:
        fail(f"K6's routes at the short files: {[e['plan'] for e in k6_short.values()]}")
    k6_err = max([e for e, _ in k6_errs.values()] + [e["err"] for e in k6_short.values()])
    report["k6_max_abs_err"] = {c: e for c, (e, _) in k6_errs.items()}
    report["k6_loss_err"] = {c: le for c, (_, le) in k6_errs.items()}

    mark("probe")
    # The frontend probe, with a fresh cache, before the main path, so that
    # no phase time below holds a probe.
    counters = {**mfcc_kernel.WRAPPERS, "K5": tk.corpus_grads_k5,
                "K6": tk.train_windows_k6, "K7": forward_probs_k7}
    by_path = {}

    def zero_counts():
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()

    def read_counts(path):
        by_path[path] = {k: c.launches for k, c in counters.items()}
        return by_path[path]

    cache_dir = tempfile.TemporaryDirectory(prefix="streamz_chip_smoke_tune_")
    os.environ["STREAMZ_AUTOTUNE_CACHE"] = str(Path(cache_dir.name) / "autotune.json")
    autotune.reset()
    winner = features.autotune_frontend(force=True)
    probe = autotune.probe_times[f"frontend:{kind}"]
    win_kid = KID[winner]
    spread = autotune.probe_spread[f"frontend:{kind}"]
    print("[probe] 'auto' measured " + ", ".join(
        f"{KID[b]} ({b}) {t / 16 * 1e3:.3f} ms" for b, t in probe.items())
        + f" per [32, 441600] frontend call (median of 3 runs of 16), run-to-run "
        f"spread {spread:.2%}: K2 must beat K1 by more; the run uses {winner!r} "
        f"({win_kid})")
    if FeatureExtractor(device=dev).resolved() != winner:
        fail("'auto' does not resolve to the probe's winner")
    report["probe_ms_per_call"] = {b: t / 16 * 1e3 for b, t in probe.items()}
    report["probe_spread"] = spread
    report["frontend"] = winner

    with tempfile.TemporaryDirectory(prefix="streamz_chip_smoke_") as work:
        mark("default run")
        # 4. The main path: the default training run through the CLI.
        os.chdir(work)
        names = write_corpus(train_pcm, spk, LABELLED_PER_SPEAKER, "train")
        # The plain gather and the plain step must not run on the CUDA path:
        # count their calls through the default run.
        plain_calls = {"_apply_step": 0, "rows_plain": 0}
        plain_fns = {n: getattr(tk, n) for n in plain_calls}

        def counted(name):
            def call(*a, **k):
                plain_calls[name] += 1
                return plain_fns[name](*a, **k)
            return call

        for n_ in plain_calls:
            setattr(tk, n_, counted(n_))
        # The ingest must take the native layer, never the thread pool.
        from streamz_tpu_torch.io import audio as audio_mod
        ingest_calls = {"native": 0, "thread pool": 0}
        ingest_fns = {"native": (native, "batch_ingest", native.batch_ingest),
                      "thread pool": (audio_mod, "batch_resample_threads",
                                      audio_mod.batch_resample_threads)}

        def counted_ingest(which, fn):
            def call(*a, **k):
                ingest_calls[which] += 1
                return fn(*a, **k)
            return call

        for which, (mod, attr, fn) in ingest_fns.items():
            setattr(mod, attr, counted_ingest(which, fn))
        zero_counts()
        drivers._key_counter[0] = 0
        t0 = time.perf_counter()
        try:
            rc, lines, run = run_cli([])
        finally:
            for n_, fn in plain_fns.items():
                setattr(tk, n_, fn)
            for mod, attr, fn in ingest_fns.values():
                setattr(mod, attr, fn)
        train_s = time.perf_counter() - t0
        launches = read_counts("default run")
        phases, margins = run["phase_seconds"], run["decision_margins"]
        for ln in lines:
            if ln.startswith(("Initial", "Number", "Average", "Processed", "Computed")):
                print(f"[train]   {ln}")
        processed = len(margins)
        print(f"[train] rc {rc}, {train_s:.2f} s, {processed} files through the "
              f"discovery loop, frontend {winner!r}, launches {launches}")
        if rc != 0:
            fail(f"the default run returned {rc}")
        steps = -(-len(pool) // 4096) * config.TRAIN_EPOCHS
        if (launches[win_kid] < 1 or launches["K5"] != steps
                or launches["K6"] != processed or processed != len(names)):
            fail(f"the default run's launches {launches}: expected {win_kid} >= 1, "
                 f"K5 = {steps}, K6 = {len(names)} (one per file)")
        print(f"[train] K5 step launches {launches['K5']}; plain ops on the CUDA path: "
              f"_apply_step {plain_calls['_apply_step']}, plain gather "
              f"{plain_calls['rows_plain']} (must be 0)")
        if any(plain_calls.values()):
            fail(f"the default run ran plain corpus ops on the card: {plain_calls}")
        print(f"[train] ingest calls: {ingest_calls} (the thread pool must not run)")
        if ingest_calls["native"] < 1 or ingest_calls["thread pool"]:
            fail(f"the default run's ingest did not take the native layer: {ingest_calls}")
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
                       "train_plain_calls": plain_calls,
                       "train_phase_s": phases, "train_speakers": net.num_speakers,
                       "train_own_label": kept})

        mark("--identify")
        # 5. --identify of the held-out clips against the trained model.
        query_paths = []
        for i, s in enumerate(spk):
            query_paths.append(f"query_s{s}_{i % CLIPS_PER_SPEAKER}.wav")
            wav.write_wav(query_paths[-1], query_pcm[i])
        n_windows = sum(mfcc.window_count_host(len(p)) for p in query_pcm)
        zero_counts()
        t0 = time.perf_counter()
        rc, lines, _ = run_cli(["--identify", *query_paths])
        identify_s = time.perf_counter() - t0
        identify_launches = read_counts("--identify")[win_kid]
        verdicts = {ln.split(":")[0]: ln for ln in lines if ".wav:" in ln}
        print(f"[identify] rc {rc}, {len(verdicts)} verdict lines for "
              f"{len(query_paths)} clips, {win_kid} launches {identify_launches}, "
              f"{identify_s:.3f} s")
        if rc != 0 or sorted(verdicts) != sorted(query_paths):
            fail(f"--identify: rc {rc}, verdicts for {len(verdicts)} clips")
        if identify_launches < 1:
            fail(f"--identify never launched {win_kid}")
        correct = sum(1 for p, s in zip(query_paths, spk)
                      if f": speaker {s} " in verdicts[p])
        unknown = sum(1 for v in verdicts.values() if ": speaker " not in v)
        print(f"[identify] {correct}/{len(query_paths)} held-out clips identified as "
              f"their own speaker, {unknown} unknown (trained model)")

        mark("--eval")
        # 5b. --eval of the held-out clips against the trained model, the
        # store on (only the targets pinned) and off: the same metrics.
        filelists.write_target_files(config.TARGET_FILE_LIST,
                                     list(zip(query_paths, (int(s) for s in spk))))
        evals = {}
        for store_mb in ("4096", "0"):
            os.environ["STREAMZ_STORE_MAX_MB"] = store_mb
            zero_counts()
            log = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stderr(log):
                    rc, lines, ev = run_cli(["--eval"])
            finally:
                del os.environ["STREAMZ_STORE_MAX_MB"]
            eval_wall_s = time.perf_counter() - t0
            eval_launches = read_counts(f"--eval, store {store_mb} MB")
            (HERE / "chiprun_out").mkdir(exist_ok=True)
            (HERE / "chiprun_out" / f"chip_smoke_eval_{store_mb}.log").write_text(
                log.getvalue())
            if rc != 0 or "metrics" not in ev:
                fail(f"--eval with STREAMZ_STORE_MAX_MB={store_mb} returned {rc}")
            if eval_launches[win_kid] < 1:
                fail(f"--eval never launched {win_kid}")
            evals[store_mb] = (ev, eval_wall_s)
        (on, on_s), (off, off_s) = evals["4096"], evals["0"]
        m, st = on["metrics"], on["store_stats"]
        print(f"[eval] {len(query_paths)} held-out clips, store on: accuracy "
              f"{m['accuracy']:.4f}, precision {m['precision']:.4f}, recall "
              f"{m['recall']:.4f}, F1 {m['f1']:.4f}; eval phase "
              f"{on['phase_seconds']['eval']:.3f} s (store off "
              f"{off['phase_seconds']['eval']:.3f} s), ingest+features+eval "
              f"{on_s:.3f} s (off {off_s:.3f} s); store host_pack_bytes "
              f"{st['host_pack_bytes']} (must be 0), {win_kid} launches "
              f"{by_path['--eval, store 4096 MB'][win_kid]} | {card}")
        if off["metrics"] != m or off["store_stats"] is not None:
            fail(f"--eval metrics with the store {m} and without {off['metrics']}")
        if st is None or st["host_pack_bytes"] != 0 or st["dropped_buckets"]:
            fail(f"--eval store stats {st}: the targets must all be resident")
        report["eval"] = {"metrics": m, "phase_s": on["phase_seconds"],
                          "phase_s_store_off": off["phase_seconds"],
                          "wall_s": on_s, "wall_s_store_off": off_s, "store_stats": st}

        mark("inspection modes")
        # 5c. --check-embeddings and --cluster-embeddings 8 on the card and
        # on the CPU, on the trained model: the same lines.
        for args in (["--check-embeddings"], ["--cluster-embeddings", str(N_SPEAKERS)]):
            outs = [run_cli(args + dev_args)[:2] for dev_args in ([], ["--device", "cpu"])]
            if outs[0] != outs[1] or outs[0][0] != 0 or len(outs[0][1]) < net.num_speakers:
                fail(f"{' '.join(args)} on the card {outs[0]} and on the CPU {outs[1]}")
            print(f"[inspect] {' '.join(args)}: rc 0, {len(outs[0][1])} lines, equal on the "
                  f"card and on the CPU; last: {outs[0][1][-1]!r}")

        mark("store in the default run")
        # 5d. The default run on the same corpus without the store and with
        # it again, each in a fresh directory from key 0 (as phase 4): the
        # same labels and model.npz arrays, bit for bit, as phase 4's run.
        ref_lists = Path(config.TRAIN_FILE_LIST).read_text()
        ref_model = dict(np.load(config.MODEL_PATH))
        discovery_s = {"store, phase 4": phases["discovery"]}
        for label, store_mb in (("no store", "0"), ("store", "4096")):
            sub = Path(work) / label.replace(" ", "_")
            sub.mkdir()
            os.chdir(sub)
            write_corpus(train_pcm, spk, LABELLED_PER_SPEAKER, "train")
            os.environ["STREAMZ_STORE_MAX_MB"] = store_mb
            drivers._key_counter[0] = 0
            try:
                rc, _, rerun = run_cli([])
            finally:
                del os.environ["STREAMZ_STORE_MAX_MB"]
            if rc != 0:
                fail(f"the default run ({label}) returned {rc}")
            model_ = dict(np.load(config.MODEL_PATH))
            same = (Path(config.TRAIN_FILE_LIST).read_text() == ref_lists
                    and model_.keys() == ref_model.keys()
                    and all(np.array_equal(model_[k], ref_model[k]) for k in ref_model))
            if not same or (rerun["store_stats"] is None) != (store_mb == "0"):
                fail(f"the default run ({label}): labels or model.npz differ from phase 4's")
            discovery_s[label] = rerun["phase_seconds"]["discovery"]
            os.chdir(work)
        st = run["store_stats"]
        print("[store] default run, discovery phase: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in discovery_s.items()) + "; labels and model.npz "
              f"bit-identical; phase 4's store host_pack_bytes {st['host_pack_bytes']} "
              f"(must be 0) | {card}")
        if st["host_pack_bytes"] != 0 or st["dropped_buckets"]:
            fail(f"the default run's store stats {st}: every clip must be resident")
        report["store_discovery_s"] = discovery_s
        report["train_store_stats"] = st

        mark("--encode")
        # 5e. The default run with --encode, from key 0 in a fresh directory
        # (as phase 4): its first labelled clip is listed as clips/<stem>.mp3,
        # an arbitrary blob whose cache/<stem>.wav holds the clip's samples,
        # and --checksum is the blob's SHA-512.  The run must hide the
        # payload, and --decode recover it; the labels and every model.npz
        # array but w4/b4 must equal phase 4's bit for bit, the clip's path
        # read as its cache WAV's (the encode draws its own generators and
        # touches only w4/b4).
        sub = Path(work) / "stego"
        sub.mkdir()
        os.chdir(sub)
        stego_names = write_corpus(train_pcm, spk, LABELLED_PER_SPEAKER, "train")
        wav_name = stego_names[0]
        stem = Path(wav_name).stem
        mp3_name, cache_name = f"clips/{stem}.mp3", f"cache/{stem}.wav"
        Path("clips").mkdir()
        Path("cache").mkdir()
        os.replace(wav_name, cache_name)
        blob = np.random.default_rng(SEED + 11).bytes(3001)
        Path(mp3_name).write_bytes(blob)
        Path(config.TRAIN_FILE_LIST).write_text(
            Path(config.TRAIN_FILE_LIST).read_text().replace(wav_name, mp3_name, 1))
        secret = np.random.default_rng(SEED + 12).bytes(STEGO_CLI_BYTES)
        Path("secret.bin").write_bytes(secret)
        sha = hashlib.sha512(blob).hexdigest()
        zero_counts()
        drivers._key_counter[0] = 0
        t0 = time.perf_counter()
        rc, enc_lines, enc_run = run_cli(["--encode", "secret.bin", "--checksum", sha])
        enc_wall_s = time.perf_counter() - t0
        enc_counts = read_counts("default run with --encode")
        hiding = [ln for ln in enc_lines if ln.startswith(("Hiding", "Finished encoding"))]
        if rc != 0 or len(hiding) != 2 or hiding[0] != "Hiding secret.bin in neural network":
            fail(f"the default run with --encode: rc {rc}, lines {hiding}")
        enc_model = dict(np.load(config.MODEL_PATH))
        stego_keys = {k for k in enc_model if k.startswith(("w4_", "b4_"))}
        written = Path(config.TRAIN_FILE_LIST).read_text().replace(mp3_name, wav_name)

        def same_entry(k):
            a, b = enc_model[k], ref_model[k]
            if k.startswith("speaker_") and k.endswith("_files"):
                a = np.frombuffer(bytes(a).decode().replace(cache_name, wav_name).encode(),
                                  np.uint8)
            return a.dtype == b.dtype and np.array_equal(a, b)

        if len(stego_keys) != 2 * 8 * STEGO_CLI_BYTES:
            fail(f"model.npz holds {len(stego_keys)} w4/b4 entries, expected "
                 f"{2 * 8 * STEGO_CLI_BYTES}")
        if (written != ref_lists or set(enc_model) - stego_keys != set(ref_model)
                or not all(same_entry(k) for k in ref_model)):
            fail("the --encode run: labels or model.npz arrays other than w4/b4 differ "
                 "from phase 4's")
        rc, dec_lines, _ = run_cli(["--decode", "decoded.bin", "--checksum", sha])
        if (rc != 0 or f"Decoded {STEGO_CLI_BYTES} bytes" not in dec_lines
                or Path("decoded.bin").read_bytes() != secret):
            fail(f"--decode after --encode: rc {rc}, {dec_lines}")
        config.set_checksum_constant_override(None)
        ep = enc_run["phase_seconds"]
        print(f"[stego-cli] {' / '.join(hiding)}; model.npz has {len(stego_keys)} w4/b4 "
              f"entries, its other arrays and the labels bit-identical to phase 4's; "
              f"--decode recovered all {STEGO_CLI_BYTES} bytes; launches {enc_counts}; "
              "phases " + ", ".join(f"{k} {v:.3f} s" for k, v in ep.items())
              + f" (phase 4: stego -, discovery {phases['discovery']:.3f} s); "
              f"wall {enc_wall_s:.3f} s | {card}")
        if enc_counts["K6"] != len(names) or enc_counts[win_kid] < 1 or enc_counts["K5"] < 1:
            fail(f"the --encode run's launches {enc_counts}")
        report["stego_cli"] = {"phase_s": ep, "wall_s": enc_wall_s, "launches": enc_counts,
                               "w4_b4_entries": len(stego_keys)}
        os.chdir(work)

        mark("votes")
        # 6. The vote pipeline on the same clips.
        pcms = [pcm for _, pcm in batch_resample(query_paths)]
        thr = config.DEFAULT_CONF_THRESHOLD
        zero_counts()
        t0 = time.perf_counter()
        lists = identify_speaker_list_batch(net, pcms, thr, extractor)
        vote_s = time.perf_counter() - t0
        vote_launches = read_counts("votes")[win_kid]
        if len(lists) != len(pcms) or vote_launches < 1:
            fail(f"vote pipeline: {len(lists)} lists, {vote_launches} {win_kid} launches")
        top_ok = sum(1 for lst, s in zip(lists, spk) if lst and lst[0] == s)
        print(f"[votes] {len(lists)} clips, {win_kid} launches {vote_launches}, "
              f"{vote_s:.3f} s, top-voted == own speaker for {top_ok}")

        mark("stream")
        # 6b. Streaming on the trained model, then serving: in process, the
        # --serve daemon and a two-child fleet.  No kernel of the port runs
        # there; the counts are zeroed before and must not move.
        serve_t0 = time.perf_counter()
        stream_phase(net, list(query_pcm), dev, extractor, card, report, zero_counts)
        mark("serve")
        serve_phase(net, list(query_pcm), dev, card, work, report)
        serve_counts = read_counts("stream and serve")
        if any(serve_counts.values()):
            fail(f"streaming and serving launched a kernel: {serve_counts}")
        print(f"[serve] streaming and serving phases {time.perf_counter() - serve_t0:.1f} s; "
              f"kernel launches {serve_counts} (none on this path)")

        mark("native")
        native_phase(work, names, query_pcm, card, report)
        mark("dist")
        dist_phase(work, train_pcm, spk, query_pcm, pool, pool_y, dev, card, report, by_path)
        mark("multichip")
        multichip_phase(card, report)

        mark("K7 check")
        # K7 on the identify batch, every window of the 64 held-out clips,
        # through the trained model, whose softmax is mostly saturated, and
        # through the bench's fresh seeded model, whose is not: against its
        # plain version (bf16 roundings may flip) and the FP32 forward.
        qfeats = extractor.extract_batch(pcms)
        k7_x = torch.from_numpy(np.concatenate(qfeats)).to(dev)
        k7_errs, k7_f32 = {}, {}
        for label, k7_net in (("trained", net), ("fresh", bench.make_net(dev))):
            for ns in (0, 1, N_SPEAKERS, k7_net.capacity):
                got = forward_probs_k7(k7_net.params, k7_x, ns)
                want = forward_probs_plain(k7_net.params, k7_x, ns)
                f32 = forward(k7_net.params, k7_x, ns)
                torch.cuda.synchronize()
                if got.shape != want.shape or not bool((got[:, ns:] == 0.0).all()):
                    fail(f"K7 at num_speakers {ns}: shape {tuple(got.shape)}, or a "
                         "column at or past num_speakers is not exactly 0")
                err, past = k7_flip_stats(got, want)
                k7_errs[f"{label} ns={ns}"] = err
                if err > K7_FLIP_TOL or past > K7_FLIP_SHARE * k7_x.shape[0]:
                    fail(f"K7 ({label}, ns {ns}) against its plain version: max abs "
                         f"{err:.3e}, {past} windows past {K7_TOL:g}")
                f32_err, changed, gap = k7_vs_fp32(got, f32, ns)
                plain_f32 = k7_vs_fp32(want, f32, ns)
                _, moved, moved_gap = k7_vs_fp32(got, want, ns)
                k7_f32[f"{label} ns={ns}"] = {
                    "max_abs": f32_err, "labels_changed": changed, "largest_gap_changed": gap,
                    "plain_max_abs": plain_f32[0], "plain_labels_changed": plain_f32[1],
                    "labels_unlike_plain": moved, "largest_plain_gap_unlike": moved_gap}
                if f32_err > K7_F32_TOL or gap >= 2 * K7_F32_TOL or moved_gap >= 2 * K7_FLIP_TOL:
                    fail(f"K7 ({label}, ns {ns}) against the FP32 forward: max abs "
                         f"{f32_err:.3e}, {changed} labels changed, FP32 top-two gap up to "
                         f"{gap:.3e}; {moved} labels unlike the plain version's, its gap "
                         f"up to {moved_gap:.3e}")
                print(f"[k7-check] {label} model, ns {ns}: against plain max abs {err:.3e}, "
                      f"{past} of {k7_x.shape[0]} windows past {K7_TOL:g}, {moved} labels "
                      f"unlike its (its top-two gap up to {moved_gap:.3e}); against FP32 "
                      f"forward max abs {f32_err:.3e}, {changed} labels changed (FP32 "
                      f"top-two gap up to {gap:.3e}); the plain version against FP32 "
                      f"{plain_f32[0]:.3e}, {plain_f32[1]} labels changed")
            unsaturated = float(((f32 > 1e-6) & (f32 < 1 - 1e-6)).any(dim=1).float().mean())
            print(f"[k7-check] {label} model: {unsaturated:.1%} of the windows have a "
                  "probability strictly between 0 and 1 (within 1e-6)")
        # On inputs whose sums are exact in any order, at every shape: every
        # window within K7_TOL, inactive columns exactly 0, two launches
        # bit-identical.
        exact_errs = {}
        for F, H1, H2, cap, R in K7_EXACT:
            e_params, e_x = k7_exact_inputs(F, H1, H2, cap, R, dev, seed=R + cap + H1)
            for ns in (0, 1, N_SPEAKERS, cap):
                got = forward_probs_k7(e_params, e_x, ns)
                again = forward_probs_k7(e_params, e_x, ns)
                want = forward_probs_plain(e_params, e_x, ns)
                torch.cuda.synchronize()
                key = f"{F}x{H1}x{H2}x{cap} R={R} ns={ns}"
                exact_errs[key] = float((got - want).abs().max())
                if (got.shape != want.shape or exact_errs[key] > K7_TOL
                        or not bool((got[:, ns:] == 0.0).all()) or not torch.equal(got, again)):
                    fail(f"K7 at {key}: max abs {exact_errs[key]:.3e} against its plain "
                         "version, or a nonzero inactive column, or two launches differ")
            del got, again, want, e_x
        print(f"[k7-check] exact-sum inputs, {len(exact_errs)} cases: max abs err "
              + ", ".join(f"{k} {v:.2e}" for k, v in exact_errs.items() if not k.endswith("=0"))
              + f" (bound {K7_TOL:g} on every window); inactive columns exactly 0; every "
              "case bit-identical twice")
        report["k7_max_abs_err"] = k7_errs
        report["k7_vs_fp32"] = k7_f32
        report["k7_exact_max_abs_err"] = exact_errs

        mark("every backend")
        # The vote pipeline through every kernel backend, each its own path.
        base_feats = FeatureExtractor("pallas_v4", device=dev).extract_batch(pcms)
        base_probs = [forward(net.params, torch.from_numpy(f).to(dev),
                              net.num_speakers).cpu().numpy() for f in base_feats]
        cents = np.stack([m for m, _, _ in net.embeddings])
        base_sims = cosine_matrix_many(
            np.stack(batch_clip_embeddings(net, base_feats)), cents)
        base_verdicts = [identify_sims_cosine(r, net.embeddings, thr) for r in base_sims]
        base_margins = [gate_margin(r, net.embeddings, thr) for r in base_sims]
        base_lists = None
        backend_report = {}
        for kid, backend in BACKENDS.items():
            ex = FeatureExtractor(backend, device=dev)
            zero_counts()
            t0 = time.perf_counter()
            blists = identify_speaker_list_batch(net, pcms, thr, ex)
            b_s = time.perf_counter() - t0
            b_launches = read_counts(f"votes through {backend}")[kid]
            if b_launches < 1 or len(blists) != len(pcms):
                fail(f"the vote pipeline through {backend!r} launched {kid} "
                     f"{b_launches} times")
            bfeats = ex.extract_batch(pcms)
            ferr = max(float(np.abs(a - b).max()) for a, b in zip(bfeats, base_feats))
            bsims = cosine_matrix_many(np.stack(batch_clip_embeddings(net, bfeats)), cents)
            serr = float(np.abs(bsims - base_sims).max())
            bverdicts = [identify_sims_cosine(r, net.embeddings, thr) for r in bsims]
            if base_lists is None:
                base_lists = blists  # K1 runs first: the lists to hold the others to
            # A window whose vote may change moves at most one vote out of a
            # count and one into another: a list is held to K1's whole when
            # no window is that close, its top speaker when the top two
            # counts differ by more than twice the number that are.
            whole = top = 0
            for i, probs in enumerate(base_probs):
                counts, soft = vote_check(probs, net.num_speakers, thr, GPU_VS_CPU_TOL)
                top2 = np.sort(np.r_[0, counts])[-2:]
                if soft == 0:
                    whole += 1
                    if blists[i] != base_lists[i]:
                        fail(f"{backend!r}: clip {i} votes {blists[i]}, K1 {base_lists[i]}")
                elif top2[1] - top2[0] > 2 * soft:
                    top += 1
                    if blists[i][:1] != base_lists[i][:1]:
                        fail(f"{backend!r}: clip {i} top-voted {blists[i][:1]}, K1 "
                             f"{base_lists[i][:1]} ({soft} windows within "
                             f"{GPU_VS_CPU_TOL:g} of a vote change)")
            # A verdict may rightly differ only where a similarity lies within
            # the two backends' difference of a gate bound (or of the other
            # top similarity): the margin has to exceed twice that difference.
            firm = [m > 2 * serr for m in base_margins]
            if any(f and a != b for f, a, b in zip(firm, bverdicts, base_verdicts)):
                fail(f"{backend!r}: gate verdicts {bverdicts} differ from K1's {base_verdicts}")
            print(f"[backends] {backend!r} ({kid}): {b_launches} launches, votes "
                  f"{n_windows / b_s:,.0f} windows/s; features max abs err vs K1 "
                  f"{ferr:.2e} (bound {K1_TOL:g}); vote lists equal K1's whole on "
                  f"{whole} clips and in their top speaker on {top} more (the rest "
                  f"too close to call); sims max abs err vs K1 {serr:.2e}, gate "
                  f"verdicts equal K1's on all {sum(firm)} clips with margin > "
                  f"{2 * serr:.2e} ({sum(m > GPU_VS_CPU_TOL for m in base_margins)} "
                  f"with margin > {GPU_VS_CPU_TOL:g})")
            if ferr > K1_TOL:
                fail(f"{backend!r} features differ from K1's by {ferr}")
            backend_report[backend] = {"launches": b_launches, "feature_err": ferr,
                                       "lists_whole": whole, "lists_top": top,
                                       "verdicts_firm": sum(firm)}
        report["backends"] = backend_report

        mark("GPU vs CPU")
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

    mark("reduced CPU/GPU runs")
    # 8. The same bare run at a reduced size, CPU (plain) vs GPU (kernels).
    small_spk = np.repeat(np.arange(4), 3)
    small_pcm = synth_clips(f0[:4], env[:4], small_spk, gen, dev, seconds=1)
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

    mark("--profile")
    # 8b. --profile dir on the card: the reduced corpus's default run under
    # torch.profiler; the trace must hold K6's kernel.
    with tempfile.TemporaryDirectory(prefix="streamz_chip_smoke_profile_") as work:
        os.chdir(work)
        write_corpus(small_pcm, small_spk, 1, "small")
        zero_counts()
        rc, lines, _ = run_cli(["--profile", "traces"])
        prof_launches = read_counts("--profile")
        traces = sorted(Path("traces").glob("*.pt.trace.json"))
        if rc != 0 or len(traces) != 1 or "Phase timing:" not in lines:
            fail(f"--profile traces: rc {rc}, traces {traces}")
        text = traces[0].read_text()
        if "file_train_kernel" not in text or prof_launches["K6"] < 1:
            fail("--profile's trace holds no K6 (file_train_kernel) launch")
        phase_lines = lines[lines.index("Phase timing:"):][:8]
        print(f"[profile] trace {traces[0].name}, {len(text) / 1e6:.1f} MB, "
              f"{text.count('file_train_kernel')} mentions of file_train_kernel, K6 "
              f"launches {prof_launches['K6']}; " + " | ".join(x.strip() for x in phase_lines))
        os.chdir(HERE)

    mark("stego codec")
    # 8c. The steganography codec on the card: payloads of 64 B to the 128
    # KiB cap, each encoded (host draws, the block loop on the card) and
    # decoded on the host; the bytes must match exactly.
    from streamz_tpu_torch.stego import codec
    loop_s = []
    real_loop = codec._train_bits_loop

    def timed_loop(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = real_loop(*a, **k)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t0)
        return got

    codec._train_bits_loop = timed_loop
    stego_rows = {}
    try:
        with tempfile.TemporaryDirectory(prefix="streamz_chip_smoke_stego_") as work:
            for nbytes in STEGO_BYTES:
                payload = np.random.default_rng(SEED + nbytes).bytes(nbytes)
                path = Path(work) / f"payload_{nbytes}.bin"
                path.write_bytes(payload)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    enc = codec.encode_file(str(path), device=dev)
                torch.cuda.synchronize()
                enc_s = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() - base
                held = torch.cuda.memory_allocated() - base
                if held > 2 ** 20:
                    fail(f"stego: the encoded net holds {held / 2 ** 20:.1f} MiB on the card")
                enc_steps = int(buf.getvalue().split("(")[-1].split()[0])
                t0 = time.perf_counter()
                got = codec.extract_file_from_classifier(enc)
                dec_s = time.perf_counter() - t0
                del enc
                if got != payload:
                    fail(f"stego: the {nbytes}-byte payload decodes to other bytes")
                w3_mib = 256 * 8 * nbytes * 4 / 2 ** 20
                stego_rows[nbytes] = {"steps": enc_steps, "encode_s": enc_s, "loop_s": loop_s[-1],
                                      "decode_s": dec_s, "peak_device_mib": peak / 2 ** 20,
                                      "w3_mib": w3_mib}
                print(f"[stego] {nbytes} B ({8 * nbytes} bits): {enc_steps} steps, encode "
                      f"{enc_s:.3f} s (the loop on the card {loop_s[-1]:.4f} s), decode on "
                      f"the host {dec_s:.3f} s, bytes equal; peak device memory "
                      f"{peak / 2 ** 20:.1f} MiB (w3 {w3_mib:.1f} MiB) | {card}")
    finally:
        codec._train_bits_loop = real_loop
    report["stego"] = stego_rows

    mark("train_from_files")
    # 8d. train_from_files on the card: 8 training clips (one a speaker), 2
    # epochs, full width.  augment on the card must equal augment on the
    # CPU bit for bit; each (file, epoch) is one launch of the frontend's
    # winner and one of K6; the result is held to the same call on the CPU
    # (the plain versions).
    from streamz_tpu_torch.dsp.augment import augment
    from streamz_tpu_torch.nn.model import SpeakerNet
    picks = [k * CLIPS_PER_SPEAKER for k in range(PRETRAIN_CLIPS)]
    aug_key = prng.PRNGKey(SEED + 3)
    aug_card = augment(aug_key, torch.from_numpy(train_pcm[picks[0]]).to(dev)).cpu()
    aug_host = augment(aug_key, torch.from_numpy(train_pcm[picks[0]]))
    if not torch.equal(aug_card.view(torch.int32), aug_host.view(torch.int32)):
        fail("augment on the card differs from augment on the CPU")
    pre = {}
    with tempfile.TemporaryDirectory(prefix="streamz_chip_smoke_pretrain_") as work:
        os.chdir(work)
        files = []
        for i in picks:
            files.append((f"clip_{i:02d}.wav", int(spk[i])))
            wav.write_wav(files[-1][0], train_pcm[i])
        steps_ = PRETRAIN_CLIPS * PRETRAIN_EPOCHS
        real_epoch = drivers.pretrain_network
        control_epochs = []

        def skip_last(*a, **k):
            # The control: train_from_files with its last (file, epoch) left
            # out, all else as the card run.
            control_epochs.append(1)
            return 0.0 if len(control_epochs) == steps_ else real_epoch(*a, **k)

        for run in ("cuda", "cpu", "control"):
            device = "cpu" if run == "cpu" else "cuda"
            pnet = SpeakerNet.new(output=N_SPEAKERS, seed=SEED, device=device)
            if run == "cpu":
                init = {k: v.detach().clone() for k, v in pnet.params.items()}
            ex = FeatureExtractor(device=device)
            if run == "control":
                drivers.pretrain_network = skip_last
            try:
                zero_counts()
                t0 = time.perf_counter()
                mean = drivers.train_from_files(
                    pnet, files, N_SPEAKERS, PRETRAIN_EPOCHS, 0.05, config.DEFAULT_DROPOUT,
                    config.BATCH_SIZE, ex, key=prng.PRNGKey(SEED))
                if device == "cuda":
                    torch.cuda.synchronize()
                elapsed = time.perf_counter() - t0
            finally:
                drivers.pretrain_network = real_epoch
            pre[run] = (pnet, mean, elapsed,
                        None if run == "control" else read_counts(f"train_from_files on {run}"))
        os.chdir(HERE)
    (gnet, gmean, gs, gcounts), (cnet, cmean, cs, _) = pre["cuda"], pre["cpu"]
    if gcounts[win_kid] != steps_ or gcounts["K6"] != steps_:
        fail(f"train_from_files launched {win_kid} {gcounts[win_kid]} and K6 "
             f"{gcounts['K6']} times, expected {steps_} each")
    change = {k: float((cnet.params[k] - init[k]).norm()) for k in cnet.params}
    if min(change.values()) == 0.0:
        fail(f"train_from_files on the CPU left a parameter unchanged: {change}")

    def gap_to_cpu(net):
        # Each parameter's gap to the CPU run over the CPU run's change.
        return {k: float((net.params[k].cpu() - cnet.params[k]).norm()) / change[k]
                for k in cnet.params}

    p_gap, ctrl_gap = gap_to_cpu(gnet), gap_to_cpu(pre["control"][0])
    diffs = {k: gnet.params[k].cpu() - cnet.params[k] for k in gnet.params}
    p_err = max(float(d.abs().max()) for d in diffs.values())
    # Where the largest single-weight gap sits, the CPU run's value and its
    # change from the initial weight there.
    at_k = max(diffs, key=lambda k: float(diffs[k].abs().max()))
    at_i = int(diffs[at_k].abs().argmax())
    at_idx = tuple(int(i) for i in np.unravel_index(at_i, tuple(diffs[at_k].shape)))
    at_cpu = float(cnet.params[at_k].reshape(-1)[at_i])
    at_change = at_cpu - float(init[at_k].reshape(-1)[at_i])
    l_err = abs(gmean - cmean) / max(abs(cmean), 1e-12)
    finite = all(bool(torch.isfinite(v).all()) for v in gnet.params.values())
    # Where a (file, epoch) step's time goes on the card: one clip, its
    # stages each ended by a synchronisation, best of three.
    clip0 = train_pcm[picks[0]]
    ex = FeatureExtractor(device=dev)
    pcm_dev = torch.from_numpy(clip0).to(dev, torch.float32)
    stage_ms = {"augment": [], "features": [], "trainer": []}
    for r in range(3):
        k_aug, k_train = prng.split(prng.fold_in(prng.PRNGKey(SEED).to(dev), r))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aug = augment(k_aug, pcm_dev).to(torch.int16).to(torch.float32) / 32767.0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wins = ex.extract_device(aug)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        drivers.pretrain_from_features(gnet, wins, int(spk[picks[0]]), N_SPEAKERS, 1, 0.05,
                                       config.DEFAULT_DROPOUT, config.BATCH_SIZE, key=k_train)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, a, b in (("augment", t0, t1), ("features", t1, t2), ("trainer", t2, t3)):
            stage_ms[name].append((b - a) * 1e3)
    stage_ms = {k: min(v) for k, v in stage_ms.items()}
    print(f"[pretrain] train_from_files, {PRETRAIN_CLIPS} clips x {PRETRAIN_EPOCHS} epochs "
          f"at 60x512x256x{gnet.capacity}: launches {win_kid} {gcounts[win_kid]}, K6 "
          f"{gcounts['K6']}; card {gs / steps_ * 1e3:.1f} ms per (file, epoch) (the file "
          f"loads included), CPU {cs / steps_ * 1e3:.1f} ms; one step's stages on the card, "
          "best of 3: " + ", ".join(f"{k} {v:.2f} ms" for k, v in stage_ms.items())
          + f"; mean loss card {gmean:.6f}, CPU {cmean:.6f} (relative {l_err:.3e}, bound "
          f"{PRETRAIN_LOSS_TOL:g}); each parameter's gap to the CPU over the CPU's change "
          f"from init (bound {PRETRAIN_CHANGE_TOL:g}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in p_gap.items())
          + "; the control with its last (file, epoch) skipped: "
          + ", ".join(f"{k} {v:.3e}" for k, v in ctrl_gap.items())
          + f"; largest single gap {p_err:.3e} at {at_k}{list(at_idx)} (CPU value "
          f"{at_cpu:.4f}, its change from init {at_change:.4f}); augment card == CPU "
          f"bit for bit on {train_pcm.shape[1]} samples | {card}")
    if (not finite or max(p_gap.values()) > PRETRAIN_CHANGE_TOL
            or l_err > PRETRAIN_LOSS_TOL):
        fail(f"train_from_files on the card against the CPU: parameter gaps {p_gap}, "
             f"loss {l_err:.3e}")
    if max(ctrl_gap.values()) <= PRETRAIN_CHANGE_TOL:
        fail(f"the [pretrain] gate passes a run with its last (file, epoch) skipped: "
             f"{ctrl_gap}")
    report["pretrain"] = {"launches": gcounts, "card_s": gs, "cpu_s": cs,
                          "card_ms_per_step": gs / steps_ * 1e3,
                          "cpu_ms_per_step": cs / steps_ * 1e3, "stage_ms": stage_ms,
                          "mean_loss": [gmean, cmean], "param_max_abs_err": p_err,
                          "param_max_abs_err_at": [at_k, list(at_idx), at_cpu, at_change],
                          "param_gap_over_change": p_gap, "control_gap_over_change": ctrl_gap,
                          "change_norm": change, "loss_rel_err": l_err}

    mark("bench twin")
    # 9. The bench twin, once, as a user runs it; then timing with CUDA
    # events at the main-path shapes.
    zero_counts()
    bench_rec = bench.run()
    bench_counts = read_counts("bench")
    print(f"[bench] {json.dumps(bench_rec)}")
    if bench_counts[win_kid] < 1 or bench_counts["K7"] < 1:
        fail(f"the bench twin's launches {bench_counts}: expected {win_kid} and K7 >= 1")
    report["bench"] = bench_rec
    # Each kernel's launches are those of the one run of its own path, its
    # counts zeroed just before and read just after: the default run for K5,
    # K6 and the probe's winner, the vote pipeline through its backend for
    # the other MFCC kernels, the bench twin for K7.
    own_path = {k: "default run" for k in ("K5", "K6", win_kid)}
    own_path.update({k: f"votes through {b}" for k, b in BACKENDS.items() if k != win_kid})
    own_path["K7"] = "bench"
    launches = {k: by_path[p][k] for k, p in own_path.items()}
    print("[launches] by path: " + "; ".join(
        f"{path}: " + ", ".join(f"{k} {v}" for k, v in c.items() if v)
        for path, c in by_path.items()))
    print("[launches] reported, each from its kernel's own path: " + ", ".join(
        f"{k} {launches[k]} ({own_path[k]})" for k in sorted(launches)))
    report["launches_by_path"] = by_path

    mark("timing")
    B, T = main_pcm.shape
    rows = B * (T // 400)
    consts = mfcc_kernel.kernel_constants()
    mel_w = len(consts["fbw"])
    tail_w = int(sum(max(0, hi - max(lo, 384))
                     for lo, hi in zip(consts["mel_lo"], consts["mel_hi"])))
    # The yardsticks, made before the timing: each kernel's DFT as one
    # torch.matmul, in FP32 and in bf16x3 (one bf16 product of the split
    # planes concatenated along k, [x_hi | x_hi | x_lo] @ [d_hi; d_lo; d_hi],
    # over the kernels' 896 basis columns): the block DFT stage, which every
    # one of K1-K4 is held to, and K4's own frame product.
    blocks = main_pcm.view(rows, 400)
    fp32_ms = {"block": time_ms(lambda: torch.matmul(blocks, mfcc._constants(dev)[0]), iters=20)}
    frames = main_pcm.unfold(1, 800, 400).reshape(-1, 800).contiguous()
    frame_dft = mfcc_kernel._frame_constants(dev)
    fp32_ms["frame"] = time_ms(lambda: torch.matmul(frames, frame_dft), iters=10)
    bf16x3_ms = {}
    for form, x, basis in (("block", blocks, consts["basis"]),
                           ("frame", frames, consts["frame_basis"])):
        xh, xl = mfcc_kernel.bf16_split(x)
        dh, dl = mfcc_kernel.bf16_split(torch.from_numpy(basis).to(dev))
        x3, d3 = torch.cat([xh, xh, xl], 1), torch.cat([dh, dl, dh], 0)
        del xh, xl
        bf16x3_ms[form] = time_ms(lambda: torch.matmul(x3, d3), iters=20)
        print(f"[time] bf16x3 {form} DFT, one bf16 torch.matmul [{x3.shape[0]}, "
              f"{x3.shape[1]}] x [{d3.shape[0]}, {d3.shape[1]}]: {bf16x3_ms[form]:.3f} ms; "
              f"FP32 [{x.shape[0]}, {x.shape[1]}] x [{x.shape[1]}, 802]: "
              f"{fp32_ms[form]:.3f} ms | {card}")
        del x3, d3
    del frames
    # The bench twin's PCM batch, for each kernel at its shape.
    twin_pcm = bench._clip_batch(32, 10.0, dev)[0]
    # K4's output needs only K3's work: the frame basis' second half is
    # (-1)^k times its first, so the block-parity DFT gives the same bf16
    # products at half the operations.  K4 is held to that bound and to the
    # block DFT stage; its own 800-tap formulation's bound and frame product
    # stand beside them.
    timed = {}
    for kid in ("K1", "K2", "K3", "K4"):
        need = "K3" if kid == "K4" else kid
        f32_ops, bf_ops, kb = mfcc_tc_ops_and_bytes(need, B, T, mel_w, tail_w)
        bound_ms, bound_by = bound(f32_ops, kb, bf_ops)
        wrapper = mfcc_kernel.WRAPPERS[kid]
        ms_1 = time_ms(lambda: wrapper(main_pcm), iters=10)
        plain_ms = time_ms(lambda: plain_base[kid](main_pcm), iters=3)
        ms_2 = time_ms(lambda: wrapper(main_pcm), iters=10)
        tb, tt = twin_pcm.shape
        t_ops = mfcc_tc_ops_and_bytes(need, tb, tt, mel_w, tail_w)
        twin_bound_ms, _ = bound(t_ops[0], t_ops[2], t_ops[1])
        twin_1 = time_ms(lambda: wrapper(twin_pcm), iters=20)
        twin_2 = time_ms(lambda: wrapper(twin_pcm), iters=20)
        timed[kid] = {"ms": [ms_1, ms_2], "plain_ms": plain_ms, "library_ms": bf16x3_ms["block"],
                      "fp32_library_ms": fp32_ms["block"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "twin_ms": [twin_1, twin_2],
                      "twin_bound_ms": twin_bound_ms}
        print(f"[time] {kid} {wrapper.__name__} [{B}, {T}]: {ms_1:.3f} ms, again "
              f"{ms_2:.3f} ms; plain {plain_ms:.3f} ms; bf16x3 block DFT (one bf16 "
              f"torch.matmul) {bf16x3_ms['block']:.3f} ms, FP32 {fp32_ms['block']:.3f} ms; "
              f"bound {bound_ms:.3f} ms by {bound_by} ({f32_ops / 1e9:.2f} GFLOP FP32 + "
              f"{bf_ops / 1e9:.2f} GFLOP bf16, {kb / 1e6:.1f} MB); at the bench twin's "
              f"[{tb}, {tt}]: {twin_1:.4f} ms, again {twin_2:.4f} ms, bound "
              f"{twin_bound_ms:.4f} ms | {card}")
        if kid == "K4":
            f_ops = mfcc_tc_ops_and_bytes("K4", B, T, mel_w, tail_w)
            timed[kid].update({
                "formulation_bound_ms": bound(f_ops[0], f_ops[2], f_ops[1])[0],
                "formulation_library_ms": bf16x3_ms["frame"],
                "formulation_fp32_library_ms": fp32_ms["frame"]})
            print(f"[time] K4's own 800-tap formulation: bound "
                  f"{timed[kid]['formulation_bound_ms']:.3f} ms ({f_ops[1] / 1e9:.2f} GFLOP "
                  f"bf16); bf16x3 frame product (one bf16 torch.matmul) "
                  f"{bf16x3_ms['frame']:.3f} ms, FP32 {fp32_ms['frame']:.3f} ms | {card}")

    ns = net.num_speakers
    k7_dims = (*dims[:3], net.capacity)
    k7_ops, k7_bytes = k7_ops_and_bytes(k7_x.shape[0], k7_dims)
    k7_bound_ms, k7_bound_by = bound(0, k7_bytes, bf16_ops=k7_ops)
    k7_fp32_bound_ms, _ = bound(k7_ops, k7_bytes)
    # K7 alone: its C entry (the pack kernel and the forward) on buffers made
    # once; and as a user calls it, through forward_probs_k7.
    k7_lib = fk._lib()
    k7_ws = int(k7_lib.streamz_forward_probs_workspace(*k7_dims))
    k7_work = torch.empty(k7_ws, dtype=torch.uint8, device=dev)
    k7_out = torch.empty((k7_x.shape[0], net.capacity), device=dev)
    k7_ptrs = [net.params[k].data_ptr() for k in fk.PARAM_NAMES]
    k7_stream = torch.cuda.current_stream().cuda_stream

    def k7_launch():
        rc = k7_lib.streamz_forward_probs(
            k7_x.data_ptr(), k7_x.shape[0], k7_dims[0], ns, *k7_ptrs, *k7_dims[1:],
            k7_work.data_ptr(), k7_ws, k7_out.data_ptr(), k7_stream)
        if rc != 0:
            fail(f"K7 launch failed: CUDA error {rc}")

    k7_ms = [time_ms(k7_launch, iters=50)]
    k7_plain_ms = time_ms(lambda: forward_probs_plain(net.params, k7_x, ns), iters=10)
    k7_ms.append(time_ms(k7_launch, iters=50))
    fwd_1 = bench.bench_forward(net, k7_x)
    fwd_2 = bench.bench_forward(net, k7_x)
    # The yardstick: the three products alone as bf16 torch.matmul (cuBLAS)
    # on the same shapes, their operands rounded beforehand.
    with torch.no_grad():
        k7_h1 = torch.relu(k7_x @ net.params["w1"] + net.params["b1"]).to(torch.bfloat16)
        k7_h2 = torch.tanh(k7_h1.float() @ net.params["w2"] + net.params["b2"]).to(torch.bfloat16)
    k7_xb = k7_x.to(torch.bfloat16)
    k7_wb = [net.params[k].to(torch.bfloat16) for k in ("w1", "w2", "w3")]
    k7_library_ms = time_ms(
        lambda: (k7_xb @ k7_wb[0], k7_h1 @ k7_wb[1], k7_h2 @ k7_wb[2]), iters=20)
    del k7_h1, k7_h2, k7_xb
    timed["K7"] = {"ms": k7_ms, "plain_ms": k7_plain_ms, "library_ms": k7_library_ms,
                   "bound_ms": k7_bound_ms, "bound_by": k7_bound_by,
                   "fp32_bound_ms": k7_fp32_bound_ms,
                   "wrapper_ms": [fwd_1["forward_k7_ms"], fwd_2["forward_k7_ms"]],
                   "fp32_forward_ms": [fwd_1["forward_plain_ms"], fwd_2["forward_plain_ms"]],
                   "route": fk.k7_route(*k7_dims), "smem": fk.k7_smem_bytes(*k7_dims)}
    print(f"[time] K7 [{k7_x.shape[0]}, 60] capacity {net.capacity}, {ns} live, "
          f"{timed['K7']['route']} ({timed['K7']['smem']} B of shared memory a block): "
          f"{k7_ms[0]:.4f} ms, again {k7_ms[1]:.4f} ms (pack and forward, its C entry); "
          f"through forward_probs_k7 {fwd_1['forward_k7_ms']:.4f}, "
          f"{fwd_2['forward_k7_ms']:.4f} ms; plain version (torch, bf16-rounded operands) "
          f"{k7_plain_ms:.3f} ms; the three products as bf16 torch.matmul "
          f"{k7_library_ms:.4f} ms; FP32 forward {fwd_1['forward_plain_ms']:.3f}, "
          f"{fwd_2['forward_plain_ms']:.3f} ms; bound {k7_bound_ms:.4f} ms by {k7_bound_by} "
          f"({k7_ops / 1e9:.2f} GFLOP bf16, {k7_bytes / 1e6:.1f} MB), in FP32 "
          f"{k7_fp32_bound_ms:.3f} ms | {card}")
    fronts = bench.bench_frontends()
    print("[time] frontends at 32 x 10 s: " + ", ".join(
        f"{k.split('_windows')[0][5:]} {v:,.0f}" for k, v in fronts.items())
        + f" windows/s | {card}")
    report["frontends_windows_per_s"] = fronts
    # Where a bench-twin call's device time goes: ten calls of its pipeline
    # (the 'auto' winner, forward, vote sums) under torch.profiler, split
    # into the frontend's kernel and the rest.
    twin_run = bench._pipeline(bench.make_net(dev), features.frontend_core(winner), forward)
    twin_pcm, twin_ns, twin_win = bench._clip_batch(32, 10.0, dev)
    with torch.inference_mode():
        twin_run(twin_pcm, twin_ns)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                twin_run(twin_pcm, twin_ns)
            torch.cuda.synchronize()
            twin_wall_ms = (time.perf_counter() - t0) / 10 * 1e3
    twin_kernels = sorted(((e.key, e.self_device_time_total * 1e-4, e.count // 10)
                           for e in prof.key_averages() if e.self_device_time_total > 0),
                          key=lambda t: -t[1])
    twin_busy_ms = sum(t for _, t, _ in twin_kernels)
    twin_front_ms = sum(t for k, t, _ in twin_kernels if "mfcc" in k)
    twin_split = {"wall_ms": twin_wall_ms, "device_busy_ms": twin_busy_ms,
                  "frontend_kernel_ms": twin_front_ms, "frontend": winner,
                  "other_device_ms": twin_busy_ms - twin_front_ms,
                  "windows": 32 * twin_win, "kernels": twin_kernels[:8]}
    if twin_busy_ms > 0:
        print(f"[time] bench-twin call under the profiler ({32 * twin_win} windows, "
              f"{winner}): {twin_wall_ms:.3f} ms wall, device busy {twin_busy_ms:.3f} ms "
              f"= {win_kid} {twin_front_ms:.3f} ms ({twin_front_ms / twin_busy_ms:.1%}) + "
              f"the rest {twin_busy_ms - twin_front_ms:.3f} ms; largest: " + ", ".join(
                  f"{k[:40]} {t:.3f} ms x{n}" for k, t, n in twin_kernels[:5]) + f" | {card}")
    else:
        print(f"[time] bench-twin call: {twin_wall_ms:.3f} ms wall; the profiler recorded "
              "no device time, so the split is not measured")
    report["bench_twin_split"] = twin_split

    k5_params = init_params(*dims[:3], 128, seed=SEED, device=dev)
    k5_args = (k5_params, k5_x, k5_y, k5_w, N_SPEAKERS)
    k5_ops, k5_tf32, k5_bytes = k5_ops_and_bytes(k5_w, dims)
    k5_fp32_ms, k5_fp32_by = bound(k5_ops, k5_bytes)
    k5_bound_ms, k5_bound_by = bound(0.0, k5_bytes, tf32_ops=k5_tf32)
    k5_ms = time_ms(lambda: tk.corpus_grads_k5(*k5_args), iters=50)
    k5_plain_ms = time_ms(lambda: tk.corpus_grads_plain(*k5_args), iters=50)
    k5_ms_2 = time_ms(lambda: tk.corpus_grads_k5(*k5_args), iters=50)
    # The step form on the main path's first step: the pool route, dropout.
    step_rows = k5_pool_rows[4096]
    step_p = {k: v.clone() for k, v in k5_params.items()}
    plain_p = {k: v.clone() for k, v in k5_params.items()}
    s_ops, s_tf32, s_bytes = k5_ops_and_bytes(tk.rows_plain(step_rows).weights, dims)
    k5_step_bound_ms, _ = bound(0.0, s_bytes, tf32_ops=s_tf32)
    k5_step_ms = time_ms(lambda: tk.corpus_step_k5(step_p, step_rows, N_SPEAKERS, K5_LR),
                         iters=50)
    k5_step_plain_ms = time_ms(lambda: tk._apply_step(
        plain_p, *tk.corpus_grads_plain(plain_p, *tk.rows_plain(step_rows), N_SPEAKERS),
        K5_LR), iters=20)
    k5_step_ms_2 = time_ms(lambda: tk.corpus_step_k5(step_p, step_rows, N_SPEAKERS, K5_LR),
                           iters=50)
    print(f"[time] K5 sums form [4096, 60] cap 128: {k5_ms:.4f} ms, again {k5_ms_2:.4f} ms; "
          f"plain {k5_plain_ms:.3f} ms; 3xTF32 bound {k5_bound_ms:.4f} ms by {k5_bound_by} "
          f"({k5_tf32 / 1e9:.2f} GFLOP TF32), FP32 bound {k5_fp32_ms:.4f} ms by "
          f"{k5_fp32_by} ({k5_ops / 1e9:.2f} GFLOP, {k5_bytes / 1e6:.2f} MB); "
          f"{k5_ops / (min(k5_ms, k5_ms_2) * 1e-3) / 1e12:.1f} TFLOP/s of the function | "
          f"{card}")
    print(f"[time] K5 step form, pool route, step 0 of the corpus phase (4096 rows, dropout "
          f"{config.DEFAULT_DROPOUT:g}, {s_ops / mlp_row_ops(*dims):.0f} with weight): "
          f"{k5_step_ms:.4f} ms, again {k5_step_ms_2:.4f} ms; plain gather + sums + "
          f"_apply_step {k5_step_plain_ms:.3f} ms; 3xTF32 bound {k5_step_bound_ms:.4f} ms | "
          f"{card}")

    live = int((k6_masks.sum(dim=1) > 0).sum())
    k6_timed = {}
    for cap in K6_CAPS:
        k6_p = {k: v.clone() for k, v in k6_params[cap].items()}
        k6_args = (k6_p, k6_chunks, k6_masks, k6_tvecs[cap], N_SPEAKERS + 1,
                   config.LR_EARLY)
        k6_ops, k6_bytes = k6_ops_and_bytes(k6_masks, (*dims[:3], cap))
        k6_bound_ms, k6_bound_by = bound(k6_ops, k6_bytes)
        cluster, route = k6_plans[cap]
        # One cluster's bound: the operations over its share of the FP32 peak.
        cluster_bound_ms = k6_ops / (PEAK_FP32 * cluster / SMS) * 1e3
        k6_ms = time_ms(lambda: tk.train_windows_k6(*k6_args), iters=10)
        k6_plain_ms = time_ms(lambda: tk.train_windows_plain(*k6_args), iters=1)
        k6_ms_2 = time_ms(lambda: tk.train_windows_k6(*k6_args), iters=10)
        k6_timed[f"cap{cap}"] = {"ms": [k6_ms, k6_ms_2], "plain_ms": k6_plain_ms,
                                 "bound_ms": k6_bound_ms, "bound_by": k6_bound_by,
                                 "cluster_bound_ms": cluster_bound_ms, "cluster": cluster,
                                 "route": route, "steps": int(k6_chunks.shape[0])}
        print(f"[time] K6 file_train at capacity {cap} ({cluster} CTAs, route: {route}), "
              f"{k6_chunks.shape[0]} chunks ({live} with a surviving window): "
              f"{k6_ms:.3f} ms, again {k6_ms_2:.3f} ms per file "
              f"({min(k6_ms, k6_ms_2) * 1e3 / live:.2f} us per live step); plain "
              f"{k6_plain_ms:.3f} ms; card bound {k6_bound_ms:.4f} ms by {k6_bound_by}, "
              f"one cluster's bound {cluster_bound_ms:.4f} ms ({cluster} of {SMS} SMs "
              f"at the FP32 peak; {k6_ops / 1e9:.2f} GFLOP, {k6_bytes / 1e6:.2f} MB) "
              f"| {card}")
    for label, e in k6_short.items():
        k6_p = {k: v.clone() for k, v in e["params"].items()}
        k6_args = (k6_p, e["chunks"], e["masks"], k6_tvecs[128], N_SPEAKERS + 1,
                   config.LR_EARLY)
        k6_ops, k6_bytes = k6_ops_and_bytes(e["masks"], e["dims"])
        k6_bound_ms, k6_bound_by = bound(k6_ops, k6_bytes)
        cluster, route = e["plan"]
        cluster_bound_ms = k6_ops / (PEAK_FP32 * cluster / SMS) * 1e3
        k6_ms = time_ms(lambda: tk.train_windows_k6(*k6_args), iters=5)
        k6_plain_ms = time_ms(lambda: tk.train_windows_plain(*k6_args), iters=1)
        k6_ms_2 = time_ms(lambda: tk.train_windows_k6(*k6_args), iters=5)
        s_live = int((e["masks"].sum(dim=1) > 0).sum())
        k6_timed[label] = {"ms": [k6_ms, k6_ms_2], "plain_ms": k6_plain_ms,
                           "bound_ms": k6_bound_ms, "bound_by": k6_bound_by,
                           "cluster_bound_ms": cluster_bound_ms, "cluster": cluster,
                           "route": route, "steps": int(e["chunks"].shape[0])}
        print(f"[time] K6 file_train {label} ({e['dims'][1]} -> {e['dims'][2]}, chunks of "
              f"{e['B']}; route: {route}), {e['chunks'].shape[0]} chunks ({s_live} live): "
              f"{k6_ms:.3f} ms, again {k6_ms_2:.3f} ms per file "
              f"({min(k6_ms, k6_ms_2) * 1e3 / s_live:.2f} us per live step); plain "
              f"{k6_plain_ms:.3f} ms; card bound {k6_bound_ms:.4f} ms, one cluster's "
              f"{cluster_bound_ms:.4f} ms | {card}")

    mark("corpus pass")
    # Where the corpus phase's time goes: the phase once more (100 epochs of
    # the labelled pool, a fresh net) under torch.profiler, its wall time
    # split into K5's kernels, the uploads and the device's idle time.
    from streamz_tpu_torch.nn.model import SpeakerNet

    corpus_net = SpeakerNet.new(output=N_SPEAKERS, device=dev)
    zero_counts()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_corpus(corpus_net, pool, pool_y, epochs=config.TRAIN_EPOCHS, lr=K5_LR,
                     dropout=config.DEFAULT_DROPOUT, seed=0)
        torch.cuda.synchronize()
        corpus_s = time.perf_counter() - t0
    corpus_k5 = tk.corpus_grads_k5.launches
    # The host's own share: the same numpy draws (permutation and dropout
    # mask per epoch, in train_corpus's order) with no device work.
    t0 = time.perf_counter()
    draw_rng = np.random.default_rng(0)
    for _ in range(config.TRAIN_EPOCHS):
        draw_rng.permutation(len(pool)).astype(np.int32)
        draw_rng.random(pool.shape, dtype=np.float32) >= config.DEFAULT_DROPOUT
    draws_s = time.perf_counter() - t0
    c_kernels = [(e.key, e.self_device_time_total * 1e-6, e.count)
                 for e in prof.key_averages() if e.self_device_time_total > 0]
    c_busy = sum(t for _, t, _ in c_kernels)
    k5_names = ("layer1_kernel", "layer_kernel", "softmax_kernel", "grads_kernel",
                "finish_kernel")
    c_k5 = sum(t for k, t, _ in c_kernels if any(n in k for n in k5_names))
    corpus_split = {"wall_s": corpus_s, "device_busy_s": c_busy, "k5_s": c_k5,
                    "other_device_s": c_busy - c_k5, "idle_s": corpus_s - c_busy,
                    "k5_launches": corpus_k5, "host_draws_s": draws_s}
    print(f"[time] corpus pass under the profiler ({config.TRAIN_EPOCHS} epochs, "
          f"{corpus_k5} K5 step launches): {corpus_s:.3f} s = K5 {c_k5:.3f} s + other "
          f"device work {c_busy - c_k5:.3f} s + idle (host) {corpus_s - c_busy:.3f} s; "
          f"device busy {c_busy / corpus_s:.1%}; the host's numpy draws alone "
          f"{draws_s:.3f} s | {card}")
    if corpus_k5 != steps:
        fail(f"the corpus pass launched K5 {corpus_k5} times, expected {steps}")
    k5_parts = sorted(((k.replace("(anonymous namespace)::", "").replace("void ", "")[:48],
                        t / steps * 1e6, n // steps) for k, t, n in c_kernels
                       if any(n_ in k for n_ in k5_names)), key=lambda e: -e[1])
    print("[time] K5's kernels in the corpus pass, us per step: " + ", ".join(
        f"{k} {t:.1f} (x{n})" for k, t, n in k5_parts) + f" | {card}")
    corpus_split["k5_kernels_us_per_step"] = k5_parts
    report["corpus_pass"] = corpus_split

    mark("discovery pass")
    # Where a discovery file's time goes: one more pass of the discovery loop
    # over the training clips, on a copy of the trained model, under
    # torch.profiler (device activity only; everything is warm from the
    # default run).  Its wall time splits into K6, the other kernels and the
    # device's idle time.
    train_feats = dict(zip(names, extractor.extract_batch(list(train_pcm))))
    train_files = [(p, int(s)) if i % CLIPS_PER_SPEAKER < LABELLED_PER_SPEAKER else (p, None)
                   for i, (p, s) in enumerate(zip(names, spk))]
    burn_in = min(max(math.ceil(len(names) * config.DEFAULT_BURN_IN_FRAC), 10), 50)
    pass_net = copy.deepcopy(net)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_incremental(pass_net, list(train_files), train_feats, burn_in_limit=burn_in,
                        max_speakers=N_SPEAKERS + 10, show_progress=False)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
    by_kernel = sorted(((e.key, e.self_device_time_total * 1e-6, e.count)
                        for e in prof.key_averages() if e.self_device_time_total > 0),
                       key=lambda t: -t[1])
    busy_s = sum(t for _, t, _ in by_kernel)
    k6_pass_s = sum(t for k, t, _ in by_kernel if "file_train_kernel" in k)
    per_file = {"wall_ms": pass_s / len(names) * 1e3,
                "k6_ms": k6_pass_s / len(names) * 1e3,
                "other_kernels_ms": (busy_s - k6_pass_s) / len(names) * 1e3,
                "idle_ms": (pass_s - busy_s) / len(names) * 1e3,
                "launches": sum(n for _, _, n in by_kernel) / len(names)}
    if busy_s > 0:
        print(f"[time] discovery pass under the profiler: {pass_s:.3f} s, device busy "
              f"{busy_s / pass_s:.1%}; per file {per_file['wall_ms']:.2f} ms = K6 "
              f"{per_file['k6_ms']:.2f} + other kernels {per_file['other_kernels_ms']:.2f} "
              f"({per_file['launches']:.0f} launches) + idle {per_file['idle_ms']:.2f} ms; "
              "largest: " + ", ".join(f"{k[:40]} {t * 1e3:.1f} ms x{n}"
                                      for k, t, n in by_kernel[:4]) + f" | {card}")
    else:
        print(f"[time] discovery pass: {pass_s:.3f} s; the profiler recorded no device "
              "time, so the busy share is not measured")
    report["discovery_pass"] = {"s": pass_s, "device_busy_s": busy_s, "per_file": per_file,
                                "kernels": by_kernel[:12]}
    print("[time] default run by phase: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phases.items()) + f"; total {train_s:.3f} s | {card}")
    print(f"[time] --identify end to end: {n_windows / identify_s:,.0f} windows/s "
          f"({n_windows} windows, {identify_s:.3f} s, host decode included); vote "
          f"pipeline {n_windows / vote_s:,.0f} windows/s ({vote_s:.3f} s) | {card}")
    total_s = time.perf_counter() - t_start
    mark("end")
    by_phase = {a: t1 - t0 for (a, t0), (_, t1) in zip(marks, marks[1:])}
    print(f"[time] chip_smoke phases 1-9: {total_s:.1f} s after a {build_s:.1f} s build; "
          "by phase " + ", ".join(f"{k} {v:.1f} s" for k, v in by_phase.items()))
    report.update({
        "identify_s": identify_s, "identify_windows": n_windows,
        "identify_windows_per_s": n_windows / identify_s,
        "identify_launches": identify_launches, "identify_correct": correct,
        "identify_unknown": unknown, "vote_s": vote_s,
        "vote_windows_per_s": n_windows / vote_s, "vote_launches": vote_launches,
        "gpu_vs_cpu": checks,
        "k5_ms": [k5_ms, k5_ms_2], "k5_plain_ms": k5_plain_ms,
        "k5_step_ms": [k5_step_ms, k5_step_ms_2], "k5_step_plain_ms": k5_step_plain_ms,
        "k5_bounds_ms": {"fp32": k5_fp32_ms, "3xtf32": k5_bound_ms,
                         "step_3xtf32": k5_step_bound_ms},
        "k6": k6_timed, "k6_live_chunks": live,
        "k6_chunks": int(k6_chunks.shape[0]), "total_s": total_s, "timed": timed,
        "script_s_by_phase": by_phase,
    })
    kernels = {"kernels": [
        {"name": "corpus_grads_k5", "route": "cuda",
         "source": "streamz_tpu_torch/csrc/corpus_grads.cu",
         "replaces": "streamz_tpu/nn/pallas_train.py:67",
         "launches": launches["K5"], "max_abs_err": k5_abs,
         "ms": min(k5_step_ms, k5_step_ms_2), "plain_ms": k5_step_plain_ms,
         "bound_ms": k5_step_bound_ms, "bound_by": "operations", "library_ms": None,
         "formulation": "3xTF32 on the tensor cores (mma.sync m16n8k8); step form, rows "
                        "gathered on the card",
         "sums_ms": min(k5_ms, k5_ms_2), "sums_plain_ms": k5_plain_ms,
         "sums_bound_ms": k5_bound_ms, "fp32_bound_ms": k5_fp32_ms,
         "step_max_abs_err": k5_step_err},
        {"name": "train_windows_k6", "route": "cuda",
         "source": "streamz_tpu_torch/csrc/file_train.cu",
         "replaces": "streamz_tpu/nn/pallas_train.py:237",
         "launches": launches["K6"], "max_abs_err": k6_err,
         "ms": min(k6_timed["cap128"]["ms"]), "plain_ms": k6_timed["cap128"]["plain_ms"],
         "bound_ms": k6_timed["cap128"]["bound_ms"],
         "bound_by": k6_timed["cap128"]["bound_by"], "library_ms": None,
         "cluster": k6_timed["cap128"]["cluster"], "k6_route": k6_timed["cap128"]["route"],
         "cluster_bound_ms": k6_timed["cap128"]["cluster_bound_ms"],
         "routes": {k: {"route": v["route"], "steps": v["steps"], "ms": min(v["ms"]),
                        "bound_ms": v["bound_ms"]} for k, v in k6_timed.items()}},
    ]}
    for kid, name, src, replaces, err in (
            ("K1", "mfcc_base_v4", "mfcc_base.cu", "dsp/pallas_mfcc.py:612",
             max(mfcc_errs["K1"].values())),
            ("K2", "mfcc_base_v3", "mfcc_v3.cu", "dsp/pallas_mfcc.py:383",
             max(mfcc_errs["K2"].values())),
            ("K3", "mfcc_base_v2", "mfcc_v2.cu", "dsp/pallas_mfcc.py:218",
             max(mfcc_errs["K3"].values())),
            ("K4", "mfcc_base_frames", "mfcc_frames.cu", "dsp/pallas_mfcc.py:95",
             max(mfcc_errs["K4"].values())),
            ("K7", "forward_probs_k7", "forward_probs.cu", "nn/pallas_forward.py:35",
             max(exact_errs.values()))):
        t = timed[kid]
        kernels["kernels"].append({
            "name": name, "route": "cuda", "source": f"streamz_tpu_torch/csrc/{src}",
            "replaces": f"streamz_tpu/{replaces}", "launches": launches[kid],
            "max_abs_err": err, "ms": min(t["ms"]), "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        if kid == "K7":
            kernels["kernels"][-1].update({
                "library": "the three products alone as bf16 torch.matmul (cuBLAS)",
                "bound": "bf16 operations on the tensor cores",
                **{k: t[k] for k in ("fp32_bound_ms", "wrapper_ms", "fp32_forward_ms", "route")},
                "max_abs_err_on": "inputs whose sums are exact in any order, every shape",
                "identify_batch_max_abs_err": max(k7_errs.values())})
        else:
            kernels["kernels"][-1].update({
                "library": "bf16x3 block DFT stage, one bf16 torch.matmul of the split planes",
                "fp32_library_ms": t["fp32_library_ms"], "twin_ms": min(t["twin_ms"]),
                "twin_bound_ms": t["twin_bound_ms"]})
            if kid == "K4":
                kernels["kernels"][-1].update({
                    k: t[k] for k in ("formulation_bound_ms", "formulation_library_ms",
                                      "formulation_fp32_library_ms")})
    for entry, kid in zip(kernels["kernels"], ("K5", "K6", "K1", "K2", "K3", "K4", "K7")):
        entry["path"] = own_path[kid]
        entry["launches_by_path"] = {p: c[kid] for p, c in by_path.items() if c[kid]}
    report.update(kernels)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    cache_dir.cleanup()
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--dist-worker":
        sys.exit(dist_worker(sys.argv[2:]))
    sys.exit(main())
