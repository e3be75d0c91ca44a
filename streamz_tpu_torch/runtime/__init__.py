"""Runtime helpers of the PyTorch/CUDA port (counterpart of ``streamz_tpu.runtime``)."""
