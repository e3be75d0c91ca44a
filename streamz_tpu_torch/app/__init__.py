"""Application loops of the PyTorch/CUDA port (counterpart of ``streamz_tpu.app``)."""
