"""Device resolution (one CUDA device in this slice)."""
