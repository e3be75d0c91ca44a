"""StreamZ on PyTorch and CUDA: the port of ``streamz_tpu`` to an NVIDIA H100.

A package beside the JAX one, with the same layout (``config``, ``io/``,
``dsp/``, ``nn/``, ``infer/``, ``cli``).  It imports ``torch`` and numpy,
never ``jax`` and nothing of ``streamz_tpu``: it keeps its own copies.
Every TPU kernel on a ported path becomes a hand-written Hopper kernel
under ``csrc/``, built with ``nvcc`` at first use.

Ported so far: one-shot identification, ``python -m streamz_tpu_torch
--identify <clips>`` — host decode/resample, the MFCC frontend through the
measured winner of the CUDA kernels K1 (``csrc/mfcc_base.cu``) and K2
(``csrc/mfcc_v3.cu``), both bf16x3 on the tensor cores, Δ/ΔΔ + z-norm,
mean-pooled ReLU-h2
embeddings of the 60→512→256 MLP, the cosine gate — and the gated vote
pipeline (:func:`streamz_tpu_torch.infer.identify.identify_speaker_list_batch`).
Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""
