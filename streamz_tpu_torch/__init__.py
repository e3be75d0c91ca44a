"""StreamZ on PyTorch and CUDA: the port of ``streamz_tpu`` to an NVIDIA H100.

A package beside the JAX one, with the same layout (``config``, ``io/``,
``dsp/``, ``nn/``, ``infer/``, ``cli``).  It imports ``torch`` and numpy,
never ``jax`` and nothing of ``streamz_tpu``: it keeps its own copies.
Every TPU kernel on a ported path becomes a hand-written Hopper kernel
under ``csrc/``, built with ``nvcc`` at first use.

Ported so far: the default training run (corpus training through K5,
the discovery loop through K6, its features kept on the card in a
``DeviceFeatureStore``), ``--eval``, ``--check-embeddings``,
``--cluster-embeddings``, ``--profile`` and one-shot ``--identify``, all
through ``python -m streamz_tpu_torch``; the MFCC frontend through the
measured winner of the CUDA kernels K1 (``csrc/mfcc_base.cu``) and K2
(``csrc/mfcc_v3.cu``); the gated vote pipeline
(:func:`streamz_tpu_torch.infer.identify.identify_speaker_list_batch`) and
the bench twin (``python -m streamz_tpu_torch.bench``, with K7).
Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""
