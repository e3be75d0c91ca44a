"""StreamZ on PyTorch and CUDA: the port of ``streamz_tpu`` to an NVIDIA H100.

A package beside the JAX one, with the same layout (``config``, ``io/``,
``dsp/``, ``nn/``, ``infer/``, ``stego/``, ``cli``).  It imports ``torch``
and numpy, never ``jax`` and nothing of ``streamz_tpu``: it keeps its own
copies.  Every TPU kernel on a ported path becomes a hand-written Hopper
kernel under ``csrc/``, built with ``nvcc`` at first use.

Ported so far: every entry point of the Rust reference and the JAX
package's streaming and serving layer.  The default
training run (corpus training through K5, the discovery loop through K6,
its features kept on the card in a ``DeviceFeatureStore``), ``--eval``,
``--check-embeddings``, ``--cluster-embeddings``, ``--profile``,
one-shot ``--identify`` and the steganography modes ``--encode``,
``--decode`` and ``--checksum``, all through ``python -m
streamz_tpu_torch``; the MFCC frontend through K1 (``csrc/mfcc_base.cu``)
or K2 (``csrc/mfcc_v3.cu``) as measured; the reference's library surface
below, with ``pretrain_network`` and ``train_from_files`` augmenting on the
card; the gated vote pipeline
(:func:`streamz_tpu_torch.infer.identify.identify_speaker_list_batch`) and
the bench twin (``python -m streamz_tpu_torch.bench``, with K7); live
streams (``StreamingIdentifier``, ``MultiStreamIdentifier`` with its f32,
i16 and G.711 wires) and the TCP daemon behind ``--serve`` with its local
fleet (``app/fleet.py``).  Still to port: the JAX package's host runtime
and its multi-device paths.  Entry points run on ``cuda`` unless the
caller asks for ``cpu``.

The names exported here mirror the reference crate's ``pub`` surface
(``streamz-rs/src/lib.rs``) plus the streaming and serving names, as the
JAX package's ``__all__`` does.
"""

from streamz_tpu_torch.config import (
    CHECKSUM_CONSTANT,
    DEFAULT_DROPOUT,
    DEFAULT_SAMPLE_RATE,
    FEATURE_SIZE,
    MFCC_SIZE,
    WINDOW_SIZE,
    WITH_DELTAS,
    get_checksum_constant,
    set_checksum_constant_override,
    set_wav_cache_enabled,
    wav_cache_enabled,
)
from streamz_tpu_torch.dsp.features import (
    FeatureExtractor,
    load_cached_features,
    save_cached_features,
    with_thread_extractor,
)
from streamz_tpu_torch.dsp.mfcc import DeviceFeatureStore
from streamz_tpu_torch.dsp.resample import resample_to_44100
from streamz_tpu_torch.infer.cluster import cluster_embeddings
from streamz_tpu_torch.infer.cosine import (
    compute_speaker_embeddings,
    cosine_similarity,
    identify_embedding_cosine,
    identify_sims_cosine,
    identify_speaker_cosine,
    identify_speaker_cosine_feats,
    identify_speaker_from_embedding,
)
from streamz_tpu_torch.infer.embed import (
    average_features,
    average_vectors,
    extract_embedding,
    extract_embedding_from_features,
    median_embedding_from_features,
    normalize,
)
from streamz_tpu_torch.infer.identify import (
    identify_speaker,
    identify_speaker_list,
    identify_speaker_list_batch,
    identify_speaker_with_threshold,
    identify_speaker_with_threshold_feats,
)
from streamz_tpu_torch.io.audio import (
    audio_metadata,
    batch_resample,
    downmix_to_mono,
    i16_to_f32,
    load_and_resample_file,
    load_audio_samples,
    load_mp3_samples,
    load_wav_samples,
)
from streamz_tpu_torch.app.corpus import train_corpus
from streamz_tpu_torch.io.g711 import (
    alaw_decode,
    alaw_encode,
    ulaw_decode,
    ulaw_encode,
)
from streamz_tpu_torch.app.serve import MultiStreamIdentifier
from streamz_tpu_torch.app.server import SpeakerServer, StreamClient
from streamz_tpu_torch.app.stream import StreamingIdentifier
from streamz_tpu_torch.nn.drivers import (
    pretrain_from_features,
    pretrain_network,
    train_from_feature_map,
    train_from_files,
)
from streamz_tpu_torch.nn.model import SpeakerNet
from streamz_tpu_torch.nn.train import corpus_step
from streamz_tpu_torch.stego.codec import (
    encode_file,
    extract_file,
    extract_file_from_classifier,
)

# The reference exports `SimpleNeuralNet`; SpeakerNet is its equivalent.
SimpleNeuralNet = SpeakerNet

__all__ = [
    "CHECKSUM_CONSTANT",
    "DEFAULT_DROPOUT",
    "DEFAULT_SAMPLE_RATE",
    "FEATURE_SIZE",
    "MFCC_SIZE",
    "WINDOW_SIZE",
    "WITH_DELTAS",
    "DeviceFeatureStore",
    "FeatureExtractor",
    "MultiStreamIdentifier",
    "SimpleNeuralNet",
    "SpeakerNet",
    "SpeakerServer",
    "StreamClient",
    "StreamingIdentifier",
    "corpus_step",
    "train_corpus",
    "audio_metadata",
    "average_features",
    "average_vectors",
    "alaw_decode",
    "alaw_encode",
    "batch_resample",
    "cluster_embeddings",
    "compute_speaker_embeddings",
    "cosine_similarity",
    "downmix_to_mono",
    "encode_file",
    "extract_embedding",
    "extract_embedding_from_features",
    "extract_file",
    "extract_file_from_classifier",
    "get_checksum_constant",
    "i16_to_f32",
    "identify_speaker",
    "identify_embedding_cosine",
    "identify_sims_cosine",
    "identify_speaker_cosine",
    "identify_speaker_cosine_feats",
    "identify_speaker_from_embedding",
    "identify_speaker_list",
    "identify_speaker_list_batch",
    "identify_speaker_with_threshold",
    "identify_speaker_with_threshold_feats",
    "load_and_resample_file",
    "load_audio_samples",
    "load_cached_features",
    "load_mp3_samples",
    "load_wav_samples",
    "median_embedding_from_features",
    "save_cached_features",
    "normalize",
    "pretrain_from_features",
    "pretrain_network",
    "resample_to_44100",
    "set_checksum_constant_override",
    "set_wav_cache_enabled",
    "train_from_feature_map",
    "train_from_files",
    "ulaw_decode",
    "ulaw_encode",
    "wav_cache_enabled",
    "with_thread_extractor",
]
