"""Audio ingest of the PyTorch/CUDA port (counterpart of ``streamz_tpu.io``)."""
