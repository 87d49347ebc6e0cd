"""DSP + match kernels: NumPy golden model, JAX/XLA, and Pallas (Triton) paths."""
