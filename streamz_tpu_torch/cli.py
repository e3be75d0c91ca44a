"""The StreamZ CLI of the PyTorch/CUDA port.

  python -m streamz_tpu_torch [--threshold <v>] [--burn-in-limit <n>]
                              [--max-speakers <n>] [--no-cache-wav]
                              [--force] [--retrain] [--no-autotune]
                              [--device cuda|cpu]
  python -m streamz_tpu_torch --identify <file>... [--threshold <v>]
                              [--no-autotune] [--device cuda|cpu]

A bare run is the default training run, as ``python -m streamz_tpu`` is:
in a directory holding ``train_files.txt`` (one ``path`` or
``path,label`` per line) it ingests the clips, trains a new model on the
labelled files (or resumes ``model.npz``; ``--force``/``--retrain`` start
over), runs the discovery loop over every file in list order, then writes
``model.npz``, the relabelled ``train_files.txt`` and ``target_files.txt``
(``streamz-rs/src/main.rs:627-891``).

``--identify`` matches each clip against the speakers stored in
``model.npz`` with the adaptive cosine gate (``src/lib.rs:1634-1661``),
printing one verdict line per clip.

Both run on ``cuda`` unless ``--device cpu`` is given, and fail when CUDA
is missing rather than falling back to the CPU.  On the card the frontend is
the measured winner of K1 and K2 (``dsp/features.py``), probed at first use
and cached per card; ``--no-autotune`` skips the probe, so a cold cache
takes K1.  The other modes of the JAX
package's CLI (``--eval``, ``--check-embeddings``, ``--cluster-embeddings``,
``--encode``/``--decode``/``--checksum``, ``--serve``, ``--profile``, the
multi-host flags) are not yet ported: they print so and return 2.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from streamz_tpu_torch import config
from streamz_tpu_torch.app import corpus
from streamz_tpu_torch.app.incremental import finalize_and_save, run_incremental
from streamz_tpu_torch.dsp.features import FeatureExtractor
from streamz_tpu_torch.infer.cosine import (
    compute_speaker_embeddings,
    cosine_matrix_many,
    identify_sims_cosine,
)
from streamz_tpu_torch.infer.embed import batch_clip_embeddings
from streamz_tpu_torch.io import audio
from streamz_tpu_torch.io import filelists as fl
from streamz_tpu_torch.nn import checkpoint
from streamz_tpu_torch.nn.model import SpeakerNet

_VALUE_FLAGS = ("--threshold", "--device", "--burn-in-limit", "--max-speakers")
_SWITCHES = ("--identify", "--force", "--retrain", "--no-cache-wav", "--no-autotune")


@contextlib.contextmanager
def _phase(times: Dict[str, float], name: str, device: torch.device):
    """Record the seconds of a phase that ends in a device synchronisation."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times[name] = time.perf_counter() - t0


def _flag_value(args: List[str], flag: str) -> Optional[str]:
    if flag in args:
        idx = args.index(flag)
        if idx + 1 < len(args):
            return args[idx + 1]
        print(f"Missing value for {flag}", file=sys.stderr)
    return None


def _parse_float(args: List[str], flag: str, default: float) -> float:
    raw = _flag_value(args, flag)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        print(
            f"Invalid value for {flag} '{raw}', using default {default}",
            file=sys.stderr,
        )
        return default


def _parse_int(args: List[str], flag: str) -> Optional[int]:
    raw = _flag_value(args, flag)
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        print(
            f"Invalid value for {flag} '{raw}', using automatic setting",
            file=sys.stderr,
        )
        return None


def _unported(args: List[str]) -> List[str]:
    """Flags of the JAX CLI this port does not handle yet."""
    known = {*_VALUE_FLAGS, *_SWITCHES}
    return [a for a in args if a.startswith("--") and a not in known]


def main(argv: Optional[List[str]] = None, report: Optional[dict] = None) -> int:
    """Run the CLI on ``argv``.  A default run fills ``report``, when given,
    with ``phase_seconds`` (ingest, features, corpus, discovery, finalize)
    and ``decision_margins`` (one per processed file, app/device_loop.py)."""
    args = list(sys.argv[1:] if argv is None else argv)
    if "--help" in args or "-h" in args:
        try:
            print((__doc__ or "usage: python -m streamz_tpu_torch [--identify "
                   "<file>...] [--device cuda|cpu]").strip())
            sys.stdout.flush()
        except BrokenPipeError:  # `... --help | head` closed the pipe
            try:
                sys.stdout.close()
            except BrokenPipeError:
                pass
        return 0

    identify_paths: List[str] = []
    if "--identify" in args:
        j = args.index("--identify") + 1
        while j < len(args) and not args[j].startswith("--"):
            identify_paths.append(args[j])
            j += 1
        if not identify_paths:
            print("Missing value for --identify", file=sys.stderr)
            return 1
    unported = _unported(args)
    if unported:
        print(f"{' '.join(unported)}: not yet ported to streamz_tpu_torch",
              file=sys.stderr)
        return 2

    threshold = _parse_float(args, "--threshold", config.DEFAULT_CONF_THRESHOLD)
    device = _flag_value(args, "--device") or "cuda"
    config.set_wav_cache_enabled("--no-cache-wav" not in args)
    if "--no-autotune" in args:
        # Skip the frontend's first-use probe: cached decisions still apply,
        # a cold cache takes the static default.  Exported so worker
        # subprocesses inherit it.
        os.environ["STREAMZ_NO_AUTOTUNE"] = "1"
    try:
        extractor = FeatureExtractor(device=device)
    except (RuntimeError, ValueError) as e:  # no CUDA, or an unknown device
        print(f"Cannot run on device {device!r}: {e}", file=sys.stderr)
        return 1
    if identify_paths:
        return _identify_mode(identify_paths, threshold, extractor)
    return _train_mode(
        extractor, threshold,
        burn_in_limit=_parse_int(args, "--burn-in-limit"),
        max_speakers=_parse_int(args, "--max-speakers"),
        force_retrain="--force" in args or "--retrain" in args,
        report={} if report is None else report,
    )


def _train_mode(extractor: FeatureExtractor, conf_threshold: float, *,
                burn_in_limit: Optional[int], max_speakers: Optional[int],
                force_retrain: bool, report: dict) -> int:
    """The default run (``streamz_tpu/cli.py:335-554``): ingest, the
    frontend (K1 or K2, whichever 'auto' measured faster), corpus
    training of the labelled files (K5), the discovery loop (K6), then
    centroids, ``model.npz`` and the lists."""
    times: Dict[str, float] = {}
    report["phase_seconds"] = times
    dev = extractor.device
    train_files = fl.load_train_files(config.TRAIN_FILE_LIST)
    if not train_files:
        print(f"{config.TRAIN_FILE_LIST} is empty", file=sys.stderr)
        return 1
    original_paths = [p for p, _ in train_files]
    audio.precache_mp3_files(train_files)

    with _phase(times, "ingest", dev):
        resampled = audio.batch_resample([p for p, _ in train_files])
    with _phase(times, "features", dev):
        feats = extractor.extract_batch([pcm for _, pcm in resampled])
    feature_map = {p: f for (p, _), f in zip(resampled, feats)}
    for p, _ in train_files:
        if p not in feature_map:
            print(f"No features found for training path: {p}", file=sys.stderr)

    dataset_size = len(train_files)
    burn_in_default = int(np.ceil(dataset_size * config.DEFAULT_BURN_IN_FRAC))
    burn_in_limit_val = (burn_in_limit if burn_in_limit is not None
                         else min(max(burn_in_default, 10), 50))
    max_speakers_val = (max_speakers if max_speakers is not None
                        else fl.count_speakers(train_files) + 10)

    num_speakers = fl.count_speakers(train_files)
    model_exists = os.path.exists(config.MODEL_PATH) and not force_retrain
    if model_exists:
        try:
            net = checkpoint.load(config.MODEL_PATH, device=dev)
            print(f"Loaded saved model from {config.MODEL_PATH}")
            net.set_embeddings(
                compute_speaker_embeddings(net, extractor, feature_map=feature_map))
        except Exception as e:
            print(f"Failed to load model: {e}", file=sys.stderr)
            net = SpeakerNet.new(output=max(num_speakers, 1), device=dev)
            model_exists = False
    else:
        if num_speakers == 0:
            num_speakers = 1
            p0, _ = train_files[0]
            train_files[0] = (p0, 0)
            print("No labeled speakers found - assigned speaker 0 to first file.")
        net = SpeakerNet.new(output=max(num_speakers, 1), device=dev)

    if not model_exists:
        train_refs = [(p, c) for p, c in train_files if c is not None]
        if train_refs:
            with _phase(times, "corpus", dev):
                pool_x, pool_y = corpus.build_window_pool(feature_map, train_refs)
                losses = corpus.train_corpus(
                    net, pool_x, pool_y, epochs=config.TRAIN_EPOCHS, lr=0.01,
                    dropout=config.DEFAULT_DROPOUT, seed=0,
                )
            for p, c in train_refs:
                net.record_training_file(c, p)
            if losses:
                print(f"Initial training loss: {float(np.mean(losses)):.4f}")

    with _phase(times, "discovery", dev):
        result = run_incremental(
            net, train_files, feature_map, burn_in_limit=burn_in_limit_val,
            conf_threshold=conf_threshold, max_speakers=max_speakers_val,
        )
    report["decision_margins"] = result.decision_margins
    with _phase(times, "finalize", dev):
        finalize_and_save(net, result, feature_map=feature_map)
        updated = list(zip(original_paths, (c for _, c in train_files)))
        fl.write_train_files(config.TRAIN_FILE_LIST, updated)
        fl.write_target_files(config.TARGET_FILE_LIST, train_files)

    print("Updated training file labels:")
    for p, c in updated:
        if c is not None:
            print(f"{p} -> speaker {c + 1}")
        else:
            print(f"{p} -> speaker unknown")
    print(f"Processed {fl.count_speakers(train_files)} speakers in this batch.")
    print(f"Number of speakers discovered: {net.output_size()}")
    for i in range(net.output_size()):
        n = len(result.speaker_features.get(i, []))
        print(f"Speaker {i}: {n} samples")
    return 0


def _identify_mode(paths: List[str], threshold: float,
                   extractor: FeatureExtractor) -> int:
    """One-shot identification of ``paths`` against the saved model: host
    decode/resample, the frontend (the 'auto' winner on CUDA), mean-pooled ReLU-h2
    embeddings, cosine against the stored centroids, the adaptive gate."""
    try:
        net = checkpoint.load(config.MODEL_PATH, device=extractor.device)
    except Exception as e:
        print(f"Failed to load model: {e}", file=sys.stderr)
        return 1
    if not net.embeddings:
        # Older checkpoints may lack stored embeddings: rebuild them from
        # the per-speaker training file lists.
        net.set_embeddings(compute_speaker_embeddings(net, extractor))
    if not net.embeddings:
        print("Model has no speaker embeddings to match against", file=sys.stderr)
        return 1
    print(
        f"Loaded {config.MODEL_PATH} "
        f"({net.output_size()} speakers, {len(net.embeddings)} embeddings)"
    )

    resampled = audio.batch_resample(paths)
    feats = extractor.extract_batch([pcm for _, pcm in resampled])
    feature_map = {p: f for (p, _), f in zip(resampled, feats)}
    present = [p for p in paths if p in feature_map]
    embeddings = batch_clip_embeddings(net, [feature_map[p] for p in present])
    centroids = np.stack([np.asarray(m, np.float32) for m, _, _ in net.embeddings])
    sims = (
        cosine_matrix_many(np.stack(embeddings), centroids)
        if present
        else np.zeros((0, len(net.embeddings)), np.float32)
    )
    sims_by_path = dict(zip(present, sims))

    for p in paths:
        if p not in sims_by_path:
            print(f"{p}: failed to load", file=sys.stderr)
            continue
        sim_row = sims_by_path[p]
        sid = identify_sims_cosine(sim_row, net.embeddings, threshold)
        best = int(np.argmax(sim_row))
        if sid is not None:
            print(f"{p}: speaker {sid} (similarity {float(sim_row[sid]):.3f})")
        else:
            print(
                f"{p}: unknown (best similarity {float(sim_row[best]):.3f} "
                f"to speaker {best})"
            )
    if not present:
        print("No input file could be loaded", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
