"""FeatureExtractor facade + the ``feature_cache/*.npy`` load-or-compute layer.

The port of ``streamz_tpu/dsp/features.py`` (reference
``streamz-rs/src/lib.rs:231-276``, ``:558-579``), with the JAX package's
backend names.  Each kernel backend runs its own hand-written CUDA kernel on
the card (:mod:`streamz_tpu_torch.dsp.mfcc_kernel`):

- ``'pallas_v4'``: K1, ``csrc/mfcc_base.cu`` (K2 with v4's tail: the tail
  bins' squares split before the mel);
- ``'pallas_v3'``: K2, ``csrc/mfcc_v3.cu`` (bf16x3 DFT and mel, tensor cores);
- ``'pallas_v2'``: K3, ``csrc/mfcc_v2.cu`` (bf16x3 DFT, tensor cores; f32 mel);
- ``'pallas'``: K4, ``csrc/mfcc_frames.cu`` (bf16x3 frame-major 800-tap
  DFT, tensor cores; f32 mel);
- ``'plain'``: the plain PyTorch formulation, the counterpart of the JAX
  package's ``'jax'`` backend; it runs on the card only when asked for by
  name;
- ``'numpy'``: the host golden spec (:mod:`streamz_tpu_torch.dsp.mfcc_ref`);
- ``'auto'`` (default): on a card, K1 unless K2 measures faster by more
  than the probe's run-to-run spread (:func:`autotune_frontend`, cached
  per card by
  :mod:`streamz_tpu_torch.runtime.autotune`); on the CPU, ``'plain'``.

A kernel backend on a CPU device runs its kernel's plain version, since
there is no kernel there.  Nothing falls back: a kernel that fails to build
or launch, in a probe or in a run, raises.
"""

from __future__ import annotations

import os
import tempfile
import threading
from functools import lru_cache
from typing import Callable, List, Optional, Sequence, TypeVar

import numpy as np
import torch

from streamz_tpu_torch import _cuda_build
from streamz_tpu_torch.device import resolve_device
from streamz_tpu_torch.dsp import mfcc, mfcc_kernel, mfcc_ref
from streamz_tpu_torch.io import audio
from streamz_tpu_torch.runtime import autotune
from streamz_tpu_torch.runtime.measure import chain_times

R = TypeVar("R")

_BACKENDS = (
    "auto", "plain", "pallas", "pallas_v2", "pallas_v3", "pallas_v4", "numpy"
)
_CORES = {
    "plain": mfcc.mfcc_features,
    "pallas": mfcc_kernel.mfcc_features_frames,
    "pallas_v2": mfcc_kernel.mfcc_features_v2,
    "pallas_v3": mfcc_kernel.mfcc_features_v3,
    "pallas_v4": mfcc_kernel.mfcc_features_v4,
}


def _core_for(backend: str) -> mfcc.Core:
    return _CORES[backend]


def _time_frontend(core, pcm, n_samples, iters: int = 8) -> List[float]:
    """The device seconds of each of 3 runs of ``iters`` frontend calls (the
    shared timer of :mod:`streamz_tpu_torch.runtime.measure`); the probe's
    time is their median."""
    with torch.inference_mode():
        return [t * iters for t in chain_times(core, pcm, n_samples, iters=iters)]


@lru_cache(maxsize=None)
def _probe_versions() -> tuple:
    """The probe's candidates with the hash of each one's kernel sources, so
    that a cached decision holds only for the builds it measured."""
    return tuple(
        (backend, _cuda_build.source_hash(mfcc_kernel.SOURCES[kid]))
        for backend, kid in (("pallas_v3", "K2"), ("pallas_v4", "K1"))
    )


def autotune_frontend(force: bool = False) -> str:
    """Measure K2 (``'pallas_v3'``) against K1 (``'pallas_v4'``) on this
    card and return the winner.  K1 is the static default, the TPU
    package's frontend: K2 wins only when its median is faster than K1's by
    more than the probe's run-to-run spread (the runs of both candidates),
    and that spread is cached with the decision.  A cold cache with probing
    disabled gives ``'pallas_v4'``.  Without a card ``'plain'``, without
    probing.  Cached in-process and on disk per card."""
    # The JAX package's probe: 32 clips x 10 s of N(0, 0.1) noise from seed
    # 0, 16 calls per timing, median of 3.  The input is built on the first
    # probe and shared by both candidates.
    shared = {}

    def _setup():
        if shared:
            return
        rng = np.random.default_rng(0)
        B, T = 32, 441600
        dev = resolve_device(None)
        shared["pcm"] = torch.from_numpy(
            rng.normal(0, 0.1, size=(B, T)).astype(np.float32)).to(dev)
        shared["ns"] = torch.full((B,), T, dtype=torch.int64, device=dev)

    def probe_for(backend):
        def probe():
            _setup()
            return _time_frontend(_core_for(backend), shared["pcm"], shared["ns"],
                                  iters=16)
        return probe

    return autotune.measured_choice(
        "frontend",
        {"pallas_v3": probe_for("pallas_v3"), "pallas_v4": probe_for("pallas_v4")},
        default="pallas_v4" if autotune.on_cuda() else "plain",
        force=force,
        versions=dict(_probe_versions()),
    )


def frontend_core(backend: str = "auto") -> mfcc.Core:
    """A frontend implementation by backend name; ``'auto'`` resolves to the
    measured winner (see :func:`autotune_frontend`)."""
    if backend == "numpy":
        raise ValueError(
            "the 'numpy' backend is the host-side golden spec "
            "(dsp/mfcc_ref.py) and has no device core; use "
            "FeatureExtractor(backend='numpy') for host extraction"
        )
    if backend not in _BACKENDS:
        raise ValueError(f"unknown frontend backend {backend!r}")
    if backend == "auto":
        backend = autotune_frontend()
    return _core_for(backend)


class FeatureExtractor:
    """Stateless MFCC frontend facade bound to one device (``cuda`` unless
    ``'cpu'`` is asked for); ``backend`` is one of the module's names."""

    def __init__(self, backend: str = "auto", device=None):
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.device = resolve_device(device)

    def resolved(self) -> str:
        """The backend a call runs: ``'auto'`` is the measured winner on a
        card and ``'plain'`` on the CPU."""
        if self.backend != "auto":
            return self.backend
        return autotune_frontend() if self.device.type == "cuda" else "plain"

    def extract(self, samples: np.ndarray) -> np.ndarray:
        """PCM (i16 or f32) → [n_windows, 60] float32."""
        return self.extract_batch([samples])[0]

    def extract_device(self, pcm: torch.Tensor) -> torch.Tensor:
        """One clip on this extractor's device, f32 at the [-1, 1] scale →
        [n_windows, 60] on the device; the features :meth:`extract` gives
        for the same samples.  The ``'numpy'`` backend computes on the host
        and has no device form."""
        if self.backend == "numpy":
            raise ValueError("the 'numpy' backend computes on the host; use extract")
        return mfcc.extract_features_device(pcm.to(self.device),
                                            _core_for(self.resolved()))

    def extract_batch(
        self, clips: Sequence[np.ndarray], mesh=None,
        store: Optional[mfcc.DeviceFeatureStore] = None,
    ) -> List[np.ndarray]:
        """Batched extraction: one frontend call per padded-length bucket.
        With ``mesh`` every rank runs the frontend on its share of each
        bucket's clips (the ``'numpy'`` golden spec stays on the host); a
        very long clip takes the PCM-halo route through the same kernel
        under ``'auto'`` or ``'plain'``, while a kernel backend asked for by
        name keeps the bucket path for every clip
        (``streamz_tpu/dsp/features.py:156-177``).  With ``store`` the
        device outputs are also kept there for the consumers on the device;
        the ``'numpy'`` backend takes none."""
        if self.backend == "numpy":
            if store is not None:
                raise ValueError("the 'numpy' backend computes on the host "
                                 "and fills no device store")
            return [mfcc_ref.extract_features_np(c) for c in clips]
        resolved = self.resolved()
        return mfcc.extract_features_batch(
            clips, core=_core_for(resolved), device=self.device, store=store,
            mesh=mesh,
            allow_pcm_sharded=self.backend == "auto" or resolved == "plain",
        )


_global: Optional[FeatureExtractor] = None
_global_lock = threading.Lock()


def _global_extractor() -> FeatureExtractor:
    """The process-global extractor, built at first use: a CUDA extractor
    cannot be built at import on a machine without a card."""
    global _global
    with _global_lock:
        if _global is None:
            _global = FeatureExtractor()
        return _global


def with_thread_extractor(f: Callable[[FeatureExtractor], R]) -> R:
    """Run a closure with the process-global extractor (src/lib.rs:271-276)."""
    return f(_global_extractor())


def extract_with(extractor: Optional[FeatureExtractor], samples: np.ndarray) -> np.ndarray:
    """One clip's [n_windows, 60] features through ``extractor``, or through
    the process-global one when it is None."""
    return (extractor or _global_extractor()).extract(np.asarray(samples))


def save_cached_features(path: str, feats: np.ndarray) -> None:
    """Publish ``feature_cache/<sanitized>.npy`` atomically (temp + rename
    in the cache dir): a concurrent reader must never observe a
    partially-written .npy."""
    cache = audio.feature_cache_path(path)
    fd, tmp = tempfile.mkstemp(
        prefix=cache.name + ".", suffix=".tmp", dir=str(cache.parent)
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.save(f, feats)
        os.replace(tmp, cache)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_cached_features(
    path: str, extractor: Optional[FeatureExtractor] = None
) -> np.ndarray:
    """Load ``feature_cache/<sanitized>.npy`` or compute+store it
    (src/lib.rs:558-579), with the process-global extractor unless one is
    given.  Returns [n_windows, 60] float32."""
    cache = audio.feature_cache_path(path)
    if cache.exists():
        try:
            return np.load(cache).astype(np.float32)
        except (OSError, ValueError):
            # Torn cache file (a writer interrupted mid-save): recompute
            # and overwrite instead of failing every later run.
            pass
    feats = extract_with(extractor, audio.load_audio_samples(path))
    save_cached_features(path, feats)
    return feats
