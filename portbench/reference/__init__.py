"""The plain reference that decides ``correct``: plain PyTorch and NumPy
(with cv2 and PIL for JPEG and the resize), imports neither JAX nor anything
of the port, and works out for itself everything the port derives from the
benchmark's seeded weights and slides.

``precision`` is "float32" (TF32 off: the reference) or "fp8" (every matmul
and convolution operand rounded to float8 e4m3 with a per-tensor scale: the
control, one step below bf16)."""
