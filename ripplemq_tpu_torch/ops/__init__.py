"""Hand-written GPU kernels of the port, each beside its plain PyTorch twin.

- `append` — the log-append write phase (CUDA, `csrc/append.cu`);
- `rs` — the GF(2⁸) Reed–Solomon matrix product (CUDA, `csrc/rs.cu`).
"""
