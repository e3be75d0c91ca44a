"""MFCC frontend of the PyTorch/CUDA port (counterpart of ``streamz_tpu.dsp``)."""
