"""Speaker MLP and checkpoints of the PyTorch/CUDA port (counterpart of ``streamz_tpu.nn``)."""
