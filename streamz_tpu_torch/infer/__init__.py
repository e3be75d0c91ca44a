"""Embeddings, cosine gate and votes of the PyTorch/CUDA port (counterpart of ``streamz_tpu.infer``)."""
