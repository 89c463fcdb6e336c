"""PyTorch/CUDA port of the s2s_tpu serving cascade (see README: PyTorch/CUDA port)."""
