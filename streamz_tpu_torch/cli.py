"""The StreamZ CLI of the PyTorch/CUDA port.

  python -m streamz_tpu_torch [--threshold <v>] [--burn-in-limit <n>]
                              [--max-speakers <n>] [--no-cache-wav]
                              [--eval] [--eval-split <frac>]
                              [--check-embeddings] [--cluster-embeddings <k>]
                              [--force] [--retrain] [--no-autotune]
                              [--profile [dir]] [--device cuda|cpu]
                              [--encode <file>] [--checksum <hex>]
                              [--coordinator <host:port>] [--num-processes <n>]
                              [--process-id <i>]
  python -m streamz_tpu_torch --decode <out> [--checksum <hex>]
  python -m streamz_tpu_torch --identify <file>... [--threshold <v>]
                              [--no-autotune] [--device cuda|cpu]
  python -m streamz_tpu_torch --serve [port] [--serve-streams <n>]
                              [--serve-max-buffer <seconds>]
                              [--serve-idle-timeout <seconds>]
                              [--threshold <v>] [--device cuda|cpu]

A bare run is the default training run, as ``python -m streamz_tpu`` is:
in a directory holding ``train_files.txt`` (one ``path`` or
``path,label`` per line) it ingests the clips, trains a new model on the
labelled files (or resumes ``model.npz``; ``--force``/``--retrain`` start
over), runs the discovery loop over every file in list order, then writes
``model.npz``, the relabelled ``train_files.txt`` and ``target_files.txt``
(``streamz-rs/src/main.rs:627-891``).

``--eval`` scores ``model.npz`` on ``target_files.txt`` (or, without one,
on the tail ``--eval-split`` fraction of the labelled training files):
accuracy, precision, recall and F1 of the plain ``sim > threshold`` match
(``src/main.rs:522-625``).  ``--check-embeddings`` prints the stored
speakers' similarity stats (``src/main.rs:243-279``) and
``--cluster-embeddings <k>`` runs cosine k-means over them.  ``--profile
[dir]`` prints the seconds of each phase and, with a directory, writes a
``torch.profiler`` trace there.

``--identify`` matches each clip against the speakers stored in
``model.npz`` with the adaptive cosine gate (``src/lib.rs:1634-1661``),
printing one verdict line per clip.

``--encode <file>`` hides a file in the trained model
(``src/main.rs:671-701``): when an MP3 of ``train_files.txt`` has the
SHA-512 of the active checksum (``--checksum <hex>`` overrides the built-in
constant), the default run prints "Hiding <file> in neural network" after
the corpus phase, trains the steganography layer on the card and stores it
in ``model.npz`` as ``w4``/``b4``; a failed encode is reported and training
carries on.  ``--decode <out>`` reads ``model.npz``, recovers the hidden
bytes with the same checksum and writes them to ``<out>``, before and
instead of any training (``src/main.rs:450-469``).

``--serve [port]`` (default 7071; 0 binds an ephemeral port) runs the TCP
live-identification daemon (:mod:`streamz_tpu_torch.app.server`, the JAX
daemon's wire protocol) on ``model.npz``: ``--serve-streams`` concurrent
streams (default 64) batched into shared device dispatches, at most
``--serve-max-buffer`` seconds of audio queued per stream (default 30),
connections silent for ``--serve-idle-timeout`` seconds dropped (default
off), and the model hot-swapped whenever ``model.npz`` changes.

Every mode runs on ``cuda`` unless ``--device cpu`` is given, and fails
when CUDA is missing rather than falling back to the CPU.  On the card the
frontend is the measured winner of K1 and K2 (``dsp/features.py``), probed
at first use and cached per card; ``--no-autotune`` skips the probe, so a
cold cache takes K1.  The frontend's outputs stay on the card in a
``DeviceFeatureStore`` for the discovery loop, ``--eval``, ``--identify``
and finalize; ``STREAMZ_STORE_MAX_MB`` caps it (default 4096, 0 or less
turns it off).

A multi-process run passes ``--coordinator <host:port> --num-processes <n>
--process-id <i>`` to each of its ``n`` processes (all three or none: a
partial set raises ``ValueError``), or runs under ``torchrun`` with
``STREAMZ_DIST_AUTO=1`` and no flags.  Each process is one rank of a
``torch.distributed`` group on one device (``cuda:<local rank % cards>``;
NCCL when each rank has a card of its own, gloo when ranks share one or
under ``--device cpu``), and the batched stages run data-parallel over a
mesh of every rank (``streamz_tpu/cli.py:211-239``): ingest's frontend and
the embedding batches shard their clip axis, corpus training shards every
step and all-reduces the gradient sums, long clips shard their window
axis.  Under a mesh the frontend takes its static default (no probe), the
device store is off, and the discovery loop runs replicated on every rank.
Every rank reads the same files and writes its own working directory's
``model.npz`` and lists, with the same labels as a single-process run.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Set

import numpy as np

from streamz_tpu_torch import config
from streamz_tpu_torch.app import corpus
from streamz_tpu_torch.app.embedquality import print_embedding_quality
from streamz_tpu_torch.app.evaluate import evaluate, resolve_eval_targets
from streamz_tpu_torch.app.incremental import finalize_and_save, run_incremental
from streamz_tpu_torch.dsp.features import FeatureExtractor
from streamz_tpu_torch.dsp.mfcc import DeviceFeatureStore
from streamz_tpu_torch.infer.cluster import cluster_embeddings
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
from streamz_tpu_torch.parallel import comm
from streamz_tpu_torch.parallel import mesh as meshmod
from streamz_tpu_torch.runtime.profiler import PhaseTimer, trace
from streamz_tpu_torch.runtime.watchdog import watchdog
from streamz_tpu_torch.stego import codec

_VALUE_FLAGS = ("--threshold", "--device", "--burn-in-limit", "--max-speakers",
                "--eval-split", "--cluster-embeddings", "--encode", "--decode",
                "--checksum", "--serve-streams", "--serve-max-buffer",
                "--serve-idle-timeout", "--coordinator", "--num-processes",
                "--process-id")
_SWITCHES = ("--identify", "--force", "--retrain", "--no-cache-wav", "--no-autotune",
             "--eval", "--check-embeddings", "--profile", "--serve")


def _flag_value(args: List[str], flag: str, warn: bool = True) -> Optional[str]:
    if flag in args:
        idx = args.index(flag)
        if idx + 1 < len(args):
            return args[idx + 1]
        if warn:
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


def build_feature_map(
    paths: List[str], extractor: FeatureExtractor, timer: PhaseTimer,
    store_paths: Optional[Set[str]] = None, mesh=None,
):
    """Decode and resample ``paths`` on the host (the ``ingest`` phase),
    then one batched frontend call per length bucket (``features``), its
    clip axis sharded over ``mesh`` when given.

    Returns ``(feature_map, store)``, ``store`` a path-keyed
    :class:`DeviceFeatureStore` of the frontend's device outputs for the
    consumers on the device, or None where there is none: the ``'numpy'``
    backend, a mesh, or ``STREAMZ_STORE_MAX_MB`` (default 4096) at 0 or
    less.
    ``store_paths`` keeps only those clips in the store (``--eval`` pins
    only its targets, the only rows it gathers); the rest are extracted in
    a separate call, so that no bucket of theirs stays resident.
    """
    with timer.phase("ingest"), watchdog("ingest", 600.0):
        resampled = audio.batch_resample(paths)
    try:
        cap_mb = float(os.environ.get("STREAMZ_STORE_MAX_MB", "4096"))
    except ValueError:
        cap_mb = 4096.0
    store = (DeviceFeatureStore(max_bytes=int(cap_mb * 1e6))
             if extractor.backend != "numpy" and cap_mb > 0 and mesh is None else None)
    with timer.phase("features"):
        if store is not None and store_paths is not None:
            kept = [i for i, (p, _) in enumerate(resampled) if p in store_paths]
            rest = [i for i, (p, _) in enumerate(resampled) if p not in store_paths]
            feats: List = [None] * len(resampled)
            for idxs, st in ((rest, None), (kept, store)):
                if idxs:
                    got = extractor.extract_batch([resampled[i][1] for i in idxs], store=st)
                    for i, f in zip(idxs, got):
                        feats[i] = f
            rekey_map = {row: resampled[i][0] for row, i in enumerate(kept)}
        else:
            feats = extractor.extract_batch([s for _, s in resampled], mesh=mesh,
                                            store=store)
            rekey_map = {i: p for i, (p, _) in enumerate(resampled)}
    if store is not None:
        store.rekey(rekey_map)
    return {p: f for (p, _), f in zip(resampled, feats)}, store


def main(argv: Optional[List[str]] = None, report: Optional[dict] = None) -> int:
    """Run the CLI on ``argv``.  A default run or ``--eval`` fills
    ``report``, when given, with ``phase_seconds`` (ingest, features, then
    corpus, stego when it encodes, discovery and finalize, or eval),
    ``store_stats`` (the ``DeviceFeatureStore``'s, None without one), and
    for a default run ``decision_margins`` (one per processed file,
    app/device_loop.py), for ``--eval`` ``metrics``."""
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
    device = _flag_value(args, "--device") or "cuda"
    # The multi-process bootstrap precedes any device access: each process
    # passes the same coordinator and its own id (or none of the three).
    try:
        rank_device = comm.initialize_distributed(
            _flag_value(args, "--coordinator"),
            _parse_int(args, "--num-processes"),
            _parse_int(args, "--process-id"),
            device=device,
        )
    except RuntimeError as e:  # no CUDA, or an unknown device
        print(f"Cannot start on device {device!r}: {e}", file=sys.stderr)
        return 1
    try:
        return _main(args, identify_paths, rank_device or device, report)
    finally:
        if rank_device is not None:
            meshmod.reset_active_mesh()
            comm.shutdown()


def _main(args: List[str], identify_paths: List[str], device, report: Optional[dict]) -> int:
    """:func:`main` after the process group is up (or needs none)."""
    mesh = meshmod.auto_mesh()
    if mesh is not None:
        print(f"Running on {mesh.size()} devices (data-parallel mesh across "
              f"{comm.world_size()} hosts, {comm.backend()})")

    threshold = _parse_float(args, "--threshold", config.DEFAULT_CONF_THRESHOLD)
    eval_split = _parse_float(args, "--eval-split", 0.2)
    burn_in_limit = _parse_int(args, "--burn-in-limit")
    max_speakers = _parse_int(args, "--max-speakers")
    cluster_k = _parse_int(args, "--cluster-embeddings")
    encode_path = _flag_value(args, "--encode")
    decode_path = _flag_value(args, "--decode")
    checksum_arg = _flag_value(args, "--checksum")
    config.set_wav_cache_enabled("--no-cache-wav" not in args)
    if "--no-autotune" in args:
        # Skip the frontend's first-use probe: cached decisions still apply,
        # a cold cache takes the static default.  Exported so worker
        # subprocesses inherit it.
        os.environ["STREAMZ_NO_AUTOTUNE"] = "1"
    profile_dir = None
    if "--profile" in args:
        # The directory is optional: a bare --profile is valid.
        maybe = _flag_value(args, "--profile", warn=False)
        if maybe and not maybe.startswith("--"):
            profile_dir = maybe
    if checksum_arg:
        config.set_checksum_constant_override(checksum_arg)
    # Fresh trigger state per invocation (the reference is a fresh process).
    audio.CHECKSUM_TRIGGERED.clear()
    try:
        extractor = FeatureExtractor(device=device)
    except (RuntimeError, ValueError) as e:  # no CUDA, or an unknown device
        print(f"Cannot run on device {device!r}: {e}", file=sys.stderr)
        return 1
    dev = extractor.device
    timer = PhaseTimer(dev)
    report = {} if report is None else report
    report["phase_seconds"] = timer.phases

    if "--check-embeddings" in args:
        try:
            net = checkpoint.load(config.MODEL_PATH, device=dev)
        except Exception as e:
            print(f"Failed to load model from {config.MODEL_PATH}: {e}", file=sys.stderr)
            return 1
        print(f"Loaded {config.MODEL_PATH} for embedding check")
        print_embedding_quality(net, extractor, mesh=mesh)
        return 0

    if cluster_k is not None:
        if cluster_k < 0:
            print(f"--cluster-embeddings expects a non-negative k, got {cluster_k}",
                  file=sys.stderr)
            return 1
        try:
            net = checkpoint.load(config.MODEL_PATH, device=dev)
        except Exception as e:
            print(f"Failed to load model: {e}", file=sys.stderr)
            return 1
        embeds = [np.asarray(m) for m, _, _ in net.embeddings]
        if not embeds:
            print("No embeddings available to cluster")
            return 0
        for i, lab in enumerate(cluster_embeddings(embeds, cluster_k, 20, device=dev)):
            print(f"Speaker {i} -> cluster {lab}")
        return 0

    if decode_path:
        # --decode always decodes standalone and exits before any training
        # (src/main.rs:450-469; the in-training decode branch at :672-685 is
        # unreachable because of this early return).
        return _standalone_decode(decode_path, dev)

    if identify_paths:
        return _identify_mode(identify_paths, threshold, extractor, timer, mesh)

    if "--serve" in args:
        return _serve_mode(args, threshold, dev)

    train_files = fl.load_train_files(config.TRAIN_FILE_LIST)
    if not train_files:
        print(f"{config.TRAIN_FILE_LIST} is empty", file=sys.stderr)
        return 1
    # The list as read: train_files.txt is written back with these paths,
    # not the cache WAVs the precache rewrites MP3 entries to.
    original_paths = [p for p, _ in train_files]
    target_files = fl.load_target_files(config.TARGET_FILE_LIST)
    eval_mode = "--eval" in args
    audio.precache_mp3_files(train_files)
    if eval_mode:
        audio.precache_target_files(target_files)
    profile = "--profile" in args
    with trace(profile_dir, dev):
        if eval_mode:
            return _eval_mode(train_files, target_files, eval_split, threshold,
                              extractor, timer, report, profile=profile, mesh=mesh)
        return _train_mode(
            train_files, original_paths, extractor, threshold, timer,
            burn_in_limit=burn_in_limit, max_speakers=max_speakers,
            force_retrain="--force" in args or "--retrain" in args,
            encode_path=encode_path, report=report, profile=profile, mesh=mesh,
        )


def _eval_mode(train_files, target_files, eval_split: float, threshold: float,
               extractor: FeatureExtractor, timer: PhaseTimer, report: dict, *,
               profile: bool, mesh=None) -> int:
    """``--eval`` (``src/main.rs:522-625``): features of the training and
    target clips, only the targets kept on the card, then the metrics of
    ``model.npz`` on the targets."""
    dev = extractor.device
    # Resolved once: the store pins, and evaluate scores, the same list.
    targets = resolve_eval_targets(train_files, target_files, eval_split)
    feature_map, store = build_feature_map(
        [p for p, _ in train_files] + [p for p, _ in target_files], extractor, timer,
        store_paths={p for p, _ in targets}, mesh=mesh)
    report["store_stats"] = None if store is None else store.stats
    for p, _ in train_files:
        if p not in feature_map:
            print(f"No features found for training path: {p}", file=sys.stderr)
    print(f"Evaluating with threshold = {threshold}")
    # The in-memory lists, whose MP3 entries the precache rewrote to the
    # cache-WAV paths the feature map is keyed by.  The reference re-loads
    # the raw lists here (src/main.rs:525) and so evaluates no file of an
    # MP3 target list: consciously fixed (QUIRKS.md).
    label_map = fl.build_label_map(train_files, targets)
    norm_targets = fl.normalize_with_map(targets, label_map)
    try:
        if not os.path.exists(config.MODEL_PATH):
            print(f"Model file {config.MODEL_PATH} not found. Please train first.",
                  file=sys.stderr)
            return 1
        print(f"Loading model from {config.MODEL_PATH}")
        try:
            net = checkpoint.load(config.MODEL_PATH, device=dev)
        except Exception as e:
            print(f"Failed to load model: {e}", file=sys.stderr)
            return 1
        print(f"Model contains {len(net.embeddings)} saved embeddings")
        with timer.phase("eval"):
            report["metrics"] = evaluate(net, feature_map, norm_targets, threshold,
                                         store=store, mesh=mesh)
    finally:
        if store is not None:
            store.release()
    if profile:
        print(timer.report())
    return 0


def _train_mode(train_files, original_paths: List[str], extractor: FeatureExtractor,
                conf_threshold: float, timer: PhaseTimer, *, burn_in_limit: Optional[int],
                max_speakers: Optional[int], force_retrain: bool,
                encode_path: Optional[str], report: dict, profile: bool,
                mesh=None) -> int:
    """The default run (``streamz_tpu/cli.py:335-554``): ingest, the
    frontend (the 'auto' choice of K1 or K2) with its outputs kept on the
    card, corpus training of the labelled files (K5), the steganography
    encode when triggered, the discovery loop (K6) fed from the card, then
    centroids, ``model.npz`` and the lists."""
    feature_map, store = build_feature_map([p for p, _ in train_files], extractor, timer,
                                           mesh=mesh)
    report["store_stats"] = None if store is None else store.stats
    try:
        net, result = _train(train_files, feature_map, store, extractor, conf_threshold,
                             timer, burn_in_limit=burn_in_limit,
                             max_speakers=max_speakers, force_retrain=force_retrain,
                             encode_path=encode_path, mesh=mesh)
        report["decision_margins"] = result.decision_margins
        with timer.phase("finalize"):
            # Every rank writes its own working directory's files, with the
            # same labels (streamz_tpu/cli.py:535-541).
            finalize_and_save(net, result, feature_map=feature_map, store=store,
                              mesh=mesh)
            updated = list(zip(original_paths, (c for _, c in train_files)))
            fl.write_train_files(config.TRAIN_FILE_LIST, updated)
            fl.write_target_files(config.TARGET_FILE_LIST, train_files)
    finally:
        if store is not None:
            store.release()  # free the card's copies of the features
    if profile:
        print(timer.report())

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


def _train(train_files, feature_map, store, extractor, conf_threshold, timer, *,
           burn_in_limit, max_speakers, force_retrain, encode_path, mesh=None):
    """Load or train the net on the corpus, hide ``encode_path`` in it when
    the checksum trigger fired, then the discovery loop over every file;
    returns (net, the loop's result)."""
    dev = extractor.device
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
            net.set_embeddings(compute_speaker_embeddings(
                net, extractor, feature_map=feature_map, store=store, mesh=mesh))
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
            with timer.phase("corpus"):
                pool_x, pool_y = corpus.build_window_pool(feature_map, train_refs)
                losses = corpus.train_corpus(
                    net, pool_x, pool_y, epochs=config.TRAIN_EPOCHS, lr=0.01,
                    dropout=config.DEFAULT_DROPOUT, mesh=mesh, seed=0,
                )
            for p, c in train_refs:
                net.record_training_file(c, p)
            if losses:
                print(f"Initial training loss: {float(np.mean(losses)):.4f}")

    if audio.CHECKSUM_TRIGGERED.is_set() and encode_path:
        print(f"Hiding {encode_path} in neural network")
        with timer.phase("stego"):
            try:
                enc_net = codec.encode_file(encode_path, device=dev)
                net.set_encoding_layer(*enc_net.encoding_layer())
            except Exception as e:
                print(f"Encoding failed: {e}", file=sys.stderr)
        # training continues after encoding (src/main.rs:699)

    with timer.phase("discovery"):
        result = run_incremental(
            net, train_files, feature_map, burn_in_limit=burn_in_limit_val,
            conf_threshold=conf_threshold, max_speakers=max_speakers_val,
            device_store=store, mesh=mesh,
        )
    return net, result


def _identify_mode(paths: List[str], threshold: float, extractor: FeatureExtractor,
                   timer: PhaseTimer, mesh=None) -> int:
    """One-shot identification of ``paths`` against the saved model: host
    decode/resample, the frontend (the 'auto' winner on CUDA) with its
    outputs kept on the card, mean-pooled ReLU-h2 embeddings gathered
    there, cosine against the stored centroids, the adaptive gate."""
    try:
        net = checkpoint.load(config.MODEL_PATH, device=extractor.device)
    except Exception as e:
        print(f"Failed to load model: {e}", file=sys.stderr)
        return 1
    if not net.embeddings:
        # Older checkpoints may lack stored embeddings: rebuild them from
        # the per-speaker training file lists.
        net.set_embeddings(compute_speaker_embeddings(net, extractor, mesh=mesh))
    if not net.embeddings:
        print("Model has no speaker embeddings to match against", file=sys.stderr)
        return 1
    print(
        f"Loaded {config.MODEL_PATH} "
        f"({net.output_size()} speakers, {len(net.embeddings)} embeddings)"
    )

    feature_map, store = build_feature_map(paths, extractor, timer, mesh=mesh)
    present = [p for p in paths if p in feature_map]
    try:
        embeddings = batch_clip_embeddings(net, [feature_map[p] for p in present],
                                           store=store, keys=present, mesh=mesh)
    finally:
        if store is not None:
            store.release()
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


def _serve_mode(args: List[str], threshold: float, dev) -> int:
    """``--serve [port]``: the TCP live-identification daemon on ``dev``
    (``streamz_tpu/cli.py:557-629``).  Loads ``model.npz`` (required),
    serves ``--serve-streams`` concurrent streams batched into shared
    dispatches (:mod:`streamz_tpu_torch.app.server`), and hot-swaps the
    model whenever the checkpoint changes."""
    from streamz_tpu_torch.app.server import SpeakerServer

    port = 7071
    maybe = _flag_value(args, "--serve", warn=False)
    if maybe and not maybe.startswith("--"):
        try:
            port = int(maybe)
        except ValueError:
            print(f"Invalid value for --serve '{maybe}', using default {port}",
                  file=sys.stderr)
    n_streams = _parse_int(args, "--serve-streams")
    if n_streams is None:
        n_streams = 64
    elif n_streams < 1:
        print(f"Invalid value for --serve-streams '{n_streams}', using default 64",
              file=sys.stderr)
        n_streams = 64
    # Per-slot backlog cap (transport backpressure): seconds of 44.1 kHz
    # audio a client may queue ahead of the ticker before FEEDs are refused.
    max_buffer_s = _parse_float(args, "--serve-max-buffer", 30.0)
    if max_buffer_s <= 0:
        print(f"Invalid value for --serve-max-buffer '{max_buffer_s}', using "
              "default 30.0", file=sys.stderr)
        max_buffer_s = 30.0
    # Idle reaping: unset or <= 0 keeps slots for the life of the connection.
    idle_timeout = _parse_float(args, "--serve-idle-timeout", 0.0)
    try:
        net = checkpoint.load(config.MODEL_PATH, device=dev)
    except Exception as e:
        print(f"Failed to load model: {e}", file=sys.stderr)
        return 1
    srv = SpeakerServer(
        net,
        port=port,
        n_streams=n_streams,
        threshold=threshold,
        watch_model=config.MODEL_PATH,
        max_buffered_samples=int(max_buffer_s * config.DEFAULT_SAMPLE_RATE),
        idle_timeout=idle_timeout if idle_timeout > 0 else None,
    )
    srv.start()
    print(
        f"Serving {n_streams} stream slots on 127.0.0.1:{srv.port} "
        f"({net.output_size()} speakers; watching {config.MODEL_PATH})",
        flush=True,
    )
    srv.serve_forever()
    return 0


def _standalone_decode(out_path: str, dev) -> int:
    """``--decode``: the payload hidden in ``model.npz`` to ``out_path``."""
    try:
        net = checkpoint.load(config.MODEL_PATH, device=dev)
    except Exception as e:
        print(f"Failed to load model: {e}", file=sys.stderr)
        return 1
    print(f"Loaded model from {config.MODEL_PATH}")
    data = codec.extract_file_from_classifier(net)
    try:
        with open(out_path, "wb") as f:
            f.write(data)
        print(f"Decoded {len(data)} bytes")
    except OSError as e:
        print(f"Failed to create {out_path}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
