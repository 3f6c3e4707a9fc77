"""Hand-written GPU kernels of the port, each beside its plain PyTorch twin.

- `append` — the log-append write phase (CUDA, `csrc/append.cu`).
"""
