"""Device ops: preprocessing and the hand-written CUDA kernels (``csrc/``)."""
