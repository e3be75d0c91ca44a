"""The StreamZ CLI of the PyTorch/CUDA port: one-shot identification.

  python -m streamz_tpu_torch --identify <file>... [--threshold <v>]
                              [--device cuda|cpu]

``--identify`` matches each clip against the speakers stored in
``model.npz`` (in the working directory) with the adaptive cosine gate
(``streamz-rs/src/lib.rs:1634-1661``), printing one verdict line per clip,
as ``python -m streamz_tpu --identify`` does.  It runs on ``cuda`` unless
``--device cpu`` is given, and fails when CUDA is missing rather than
falling back to the CPU.

Every other flag of the JAX package's CLI — and a bare run, which there
starts training — is not yet ported: it prints so on stderr and returns 2.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from streamz_tpu_torch import config
from streamz_tpu_torch.dsp.features import FeatureExtractor
from streamz_tpu_torch.infer.cosine import (
    compute_speaker_embeddings,
    cosine_matrix_many,
    identify_sims_cosine,
)
from streamz_tpu_torch.infer.embed import batch_clip_embeddings
from streamz_tpu_torch.io import audio
from streamz_tpu_torch.nn import checkpoint

_VALUE_FLAGS = ("--threshold", "--device")


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


def _unported(args: List[str], identify_paths: List[str]) -> List[str]:
    """Flags of the JAX CLI this port does not handle yet."""
    skip = set(identify_paths)
    for flag in _VALUE_FLAGS:
        if flag in args and args.index(flag) + 1 < len(args):
            skip.add(args[args.index(flag) + 1])
    known = {"--identify", *_VALUE_FLAGS}
    return [a for a in args if a not in known and a not in skip]


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if "--help" in args or "-h" in args:
        print((__doc__ or "usage: python -m streamz_tpu_torch --identify "
               "<file>... [--threshold <v>] [--device cuda|cpu]").strip())
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
    unported = _unported(args, identify_paths)
    if unported or not identify_paths:
        what = " ".join(unported) if unported else "a run without --identify"
        print(f"{what}: not yet ported to streamz_tpu_torch", file=sys.stderr)
        return 2

    threshold = _parse_float(args, "--threshold", config.DEFAULT_CONF_THRESHOLD)
    device = _flag_value(args, "--device") or "cuda"
    return _identify_mode(identify_paths, threshold, device)


def _identify_mode(paths: List[str], threshold: float, device: str) -> int:
    """One-shot identification of ``paths`` against the saved model: host
    decode/resample, the frontend (K1 on CUDA), mean-pooled ReLU-h2
    embeddings, cosine against the stored centroids, the adaptive gate."""
    try:
        extractor = FeatureExtractor(device=device)
    except (RuntimeError, ValueError) as e:  # no CUDA, or an unknown device
        print(f"Cannot run on device {device!r}: {e}", file=sys.stderr)
        return 1
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
