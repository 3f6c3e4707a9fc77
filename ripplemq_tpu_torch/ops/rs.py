"""Reed–Solomon GF(2⁸) erasure coding (PyTorch port): a CUDA kernel and
its plain twin.

Twin of `ripplemq_tpu/ops/rs.py`. Encoding IS a matmul over GF(2⁸):
parity[m, n] = G[m, k] ·_gf data[k, n], and reconstruction is the same
product with rows of the inverted extended generator.

- The host field math (tables, `gf_mul`, `gf_inv`, `gf_matmul_ref`, the
  generator and extended matrices, `gf_invert`) is plain Python/numpy,
  as in the reference.
- `gf_matmul` on a CUDA tensor launches the hand-written kernel in
  `csrc/rs.cu` (built by `ops.cuda_build`) on the current stream; a
  build or launch failure raises. On a CPU tensor it runs
  `gf_matmul_plain`, the reference's bit-linear XLA fallback as torch
  int32 ops. Any other device raises. Numpy input goes to `device`, or
  to CUDA when none is given; with no GPU and no `device` it raises.

Field: GF(2⁸) with the 0x11D polynomial (the usual RS/ISA-L field).
Generator: extended-Cauchy [I_k; C], C[i,j] = (x_i ⊕ y_j)⁻¹ — every k×k
submatrix of an extended Cauchy matrix is invertible, so ANY k of the
k+m shards reconstruct the data (MDS property).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ripplemq_tpu_torch.ops import cuda_build

_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1

# Launches of the CUDA kernel: incremented where the wrapper launches it
# and nowhere else (the plain path does not count). "gf_matmul" counts
# every launch; the other two split them by path (`_launch_shape`).
LAUNCHES = {"gf_matmul": 0, "gf_matmul_vec16": 0, "gf_matmul_realign": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# Host-side field arithmetic (table-based; used for matrices + reference)
# --------------------------------------------------------------------------


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[:255]
    return exp, log


_EXP, _LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[(_LOG[a] + _LOG[b]) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(_EXP[255 - _LOG[a]])


def gf_matmul_ref(coeffs, shards: np.ndarray) -> np.ndarray:
    """Numpy reference: [M, K] constant matrix ·_gf [K, N] uint8 shards."""
    shards = np.asarray(shards, np.uint8)
    out = np.zeros((len(coeffs), shards.shape[1]), np.uint8)
    for i, row in enumerate(coeffs):
        acc = np.zeros(shards.shape[1], np.uint8)
        for j, c in enumerate(row):
            if c == 0:
                continue
            table = np.array([gf_mul(c, v) for v in range(256)], np.uint8)
            acc ^= table[shards[j]]
        out[i] = acc
    return out


def generator_matrix(k: int, m: int) -> tuple[tuple[int, ...], ...]:
    """The m×k Cauchy parity matrix C: C[i][j] = (x_i ⊕ y_j)⁻¹ with
    x = {0..m-1}, y = {m..m+k-1} (disjoint, so never singular)."""
    return tuple(
        tuple(gf_inv(i ^ (m + j)) for j in range(k)) for i in range(m)
    )


def extended_matrix(k: int, m: int) -> tuple[tuple[int, ...], ...]:
    """[I_k; C]: row r < k emits data shard r verbatim, row k+i emits
    parity i. Any k rows are invertible (extended-Cauchy MDS property)."""
    ident = tuple(
        tuple(1 if i == j else 0 for j in range(k)) for i in range(k)
    )
    return ident + generator_matrix(k, m)


def gf_invert(matrix) -> tuple[tuple[int, ...], ...]:
    """Invert a k×k matrix over GF(2⁸) (Gauss–Jordan; k is tiny)."""
    k = len(matrix)
    a = [list(row) + [1 if i == j else 0 for j in range(k)]
         for i, row in enumerate(matrix)]
    for col in range(k):
        pivot = next((r for r in range(col, k) if a[r][col]), None)
        if pivot is None:
            raise ValueError("singular matrix over GF(2^8)")
        a[col], a[pivot] = a[pivot], a[col]
        inv_p = gf_inv(a[col][col])
        a[col] = [gf_mul(inv_p, v) for v in a[col]]
        for r in range(k):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [v ^ gf_mul(f, w) for v, w in zip(a[r], a[col])]
    return tuple(tuple(row[k:]) for row in a)


# --------------------------------------------------------------------------
# The plain twin: the reference's bit-linear XLA fallback as torch ops
# --------------------------------------------------------------------------

_ONES = 0x01010101  # bit b of every byte lane of a packed int32 word


def _gf_combine(coeffs, xs):
    """The bit-linear GF matmul body over int32 tensors of PACKED bytes
    (4 field elements per word). x·c = XOR_{b: bit b of x set} c·2^b;
    `(x >> b) & 0x01010101` extracts bit b of each byte (int32 sign
    extension never reaches the mask positions for b ≤ 7), and
    `bits · v` with v ≤ 255 never carries across byte lanes."""
    bits = [[(x >> b) & _ONES for b in range(8)] for x in xs]
    outs = []
    for row in coeffs:
        acc = torch.zeros_like(xs[0])
        for j, c in enumerate(row):
            if c == 0:
                continue
            for b in range(8):
                acc = acc ^ (bits[j][b] * gf_mul(int(c), 1 << b))
        outs.append(acc)
    return outs


def gf_matmul_plain(coeffs, shards: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch GF(2⁸) product of a uint8 [K, N] tensor (on any
    device), ported from the reference's XLA fallback: byte planes
    packed as shard quarters (plane q = bytes [q·n/4, (q+1)·n/4) of the
    zero-padded shard) into int32 words."""
    K, n = shards.shape
    M = len(coeffs)
    npad = -(-n // 4) * 4
    padded = torch.zeros((K, npad), dtype=torch.int32, device=shards.device)
    padded[:, :n] = shards
    planes = padded.view(K, 4, npad // 4)
    packed = (planes[:, 0] | (planes[:, 1] << 8)
              | (planes[:, 2] << 16) | (planes[:, 3] << 24))
    out = torch.stack(_gf_combine(coeffs, list(packed)))
    planes_out = torch.stack([(out >> (8 * q)) & 0xFF for q in range(4)],
                             dim=1)
    return planes_out.reshape(M, npad)[:, :n].to(torch.uint8)


# --------------------------------------------------------------------------
# The kernel
# --------------------------------------------------------------------------

_TILE = 4      # rows and columns of C per kernel launch (csrc/rs.cu kTile)
_MAX_DIM = 16  # largest M and K the wrapper tiles
_COLS = 4096   # columns a block computes (csrc/rs.cu kCols)
_STEP = _COLS - 16  # columns a realigned block owns (csrc/rs.cu kStep)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ripplemq_gf_matmul
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ctypes.c_longlong, ci, ci, vp, ci, ci,
                   ctypes.c_longlong, ci, vp]
    fn.restype = ci


def build() -> ctypes.CDLL:
    """Build (or load the cached) kernel library and bind its symbol."""
    lib = cuda_build.load("rs")
    _bind(lib)
    return lib


def _products(coeffs) -> np.ndarray:
    """v[i, j, b] = c_ij · 2^b in all four byte lanes, uint32 [M, K, 8]."""
    v = np.array([[[gf_mul(c, 1 << b) for b in range(8)] for c in row]
                  for row in coeffs], np.uint32)
    return v * np.uint32(_ONES)


@functools.lru_cache(maxsize=64)
def _plan(coeffs) -> tuple:
    """The launches of one coefficient matrix: (row tile i0, column tile
    j0, rows, columns, the tile's products as a [4, 4, 8] uint32 array).
    Cached, since the repo's callers use 11 matrices in all (the encode
    generator and the 10 inverses) and building a plan costs host time
    comparable to a launch."""
    prods = _products(coeffs)
    plan = []
    for i0 in range(0, len(coeffs), _TILE):
        for j0 in range(0, len(coeffs[0]), _TILE):
            sub = prods[i0:i0 + _TILE, j0:j0 + _TILE]
            tile = np.zeros((_TILE, _TILE, 8), np.uint32)
            tile[:sub.shape[0], :sub.shape[1]] = sub
            plan.append((i0, j0, sub.shape[0], sub.shape[1], tile))
    return tuple(plan)


def _launch_shape(n: int, in_ptr: int, out_ptr: int) -> tuple[bool, int]:
    """(aligned path?, blocks) of one launch over rows of n bytes.

    The aligned path needs every row on a 16-byte boundary: n % 16 == 0
    and both base pointers aligned. Its blocks cover 4096 columns each.
    Every other case (misaligned rows, ragged widths, n < 16) takes the
    realigned path, whose blocks own 4080 columns each: block b owns
    columns [b*4080 - e, (b+1)*4080 - e) of an output row misaligned by
    e = address % 16, so that all of its stores but the row's head and
    tail are aligned 16-byte vectors; ceil((n + 15) / 4080) blocks cover
    every e in 0..15."""
    if n % 16 == 0 and in_ptr % 16 == 0 and out_ptr % 16 == 0:
        return True, -(-n // _COLS)
    return False, -(-(n + 15) // _STEP)


def _launch(coeffs, shards: torch.Tensor, out=None) -> torch.Tensor:
    """Launch the kernel tile by tile into `out` (a fresh [M, N] tensor
    unless given: a contiguous uint8 view on the same device, at any
    address)."""
    N = shards.shape[1]
    if out is None:
        out = torch.empty((len(coeffs), N), dtype=torch.uint8,
                          device=shards.device)
    elif (out.dtype != torch.uint8 or tuple(out.shape) != (len(coeffs), N)
          or out.device != shards.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous uint8 [{len(coeffs)}, "
                         f"{N}] tensor on {shards.device}")
    lib = build()
    vec16, blocks = _launch_shape(N, shards.data_ptr(), out.data_ptr())
    path = "gf_matmul_vec16" if vec16 else "gf_matmul_realign"
    stream = torch.cuda.current_stream(shards.device).cuda_stream
    for i0, j0, m, k, tile in _plan(coeffs):
        err = lib.ripplemq_gf_matmul(
            shards.data_ptr() + j0 * N, out.data_ptr() + i0 * N, N, m, k,
            tile.ctypes.data, int(j0 > 0), int(vec16), blocks,
            shards.device.index, stream)
        if err != 0:
            raise RuntimeError(
                f"GF(2^8) matmul kernel launch failed: cudaError {err}")
        LAUNCHES["gf_matmul"] += 1
        LAUNCHES[path] += 1
    return out


# --------------------------------------------------------------------------
# The wrapper
# --------------------------------------------------------------------------


def indexed_device(device) -> torch.device:
    """`device` as a `torch.device`; a CUDA device without an index gets
    the current one. A tensor's `.device` always carries its index, and
    `torch.device("cuda")` equals no indexed device, so devices that are
    compared with tensors' devices must be indexed."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def default_device(device=None) -> torch.device:
    """`device`, or the current CUDA device when none is given; raises when
    none is given and no GPU is present (there is no silent CPU path)."""
    if device is not None:
        return indexed_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' to run the "
            "erasure code on the CPU explicitly")
    return indexed_device("cuda")


def _as_u8(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.uint8)
        if not x.flags.writeable:
            x = x.copy()  # torch refuses to share read-only host memory
        x = torch.from_numpy(x)
    return x.to(device=device, dtype=torch.uint8)


def _check_coeffs(coeffs) -> tuple[tuple[int, ...], ...]:
    coeffs = tuple(tuple(int(c) for c in row) for row in coeffs)
    if not coeffs or not coeffs[0]:
        raise ValueError("coeffs must be a non-empty M x K matrix")
    if any(len(row) != len(coeffs[0]) for row in coeffs):
        raise ValueError("coeffs rows differ in length")
    if any(not 0 <= c <= 255 for row in coeffs for c in row):
        raise ValueError("coeffs must be field elements in [0, 255]")
    if len(coeffs) > _MAX_DIM or len(coeffs[0]) > _MAX_DIM:
        raise ValueError(f"coeffs {len(coeffs)}x{len(coeffs[0])} exceeds the "
                         f"supported {_MAX_DIM}x{_MAX_DIM}")
    return coeffs


def gf_matmul(coeffs, shards, *, device=None) -> torch.Tensor:
    """[M, K] coefficient matrix ·_gf [K, N] uint8 shards → uint8 [M, N]
    tensor on the device (M, K ≤ 16).

    `shards` is a tensor or anything numpy takes. The product runs on
    `device` if given, else on the tensor's own device, else (numpy
    input) on CUDA. A CUDA device launches the kernel; the CPU runs the
    plain version; any other device raises."""
    coeffs = _check_coeffs(coeffs)
    dev = (shards.device if device is None and isinstance(shards, torch.Tensor)
           else default_device(device))
    shards = _as_u8(shards, dev)
    if shards.ndim != 2 or len(coeffs[0]) != shards.shape[0]:
        raise ValueError(
            f"coeffs {len(coeffs)}x{len(coeffs[0])} does not match shards "
            f"{tuple(shards.shape)}"
        )
    if shards.shape[1] == 0:
        return torch.zeros((len(coeffs), 0), dtype=torch.uint8, device=dev)
    if dev.type == "cuda":
        return _launch(coeffs, shards.contiguous())
    if dev.type == "cpu":
        return gf_matmul_plain(coeffs, shards)
    raise ValueError(f"no GF(2^8) matmul path for device {dev}")


# --------------------------------------------------------------------------
# RS(k, m) encode / reconstruct on top of the matmul
# --------------------------------------------------------------------------


def rs_encode(data_shards, k: int = 3, m: int = 2, **kw) -> torch.Tensor:
    """[k, N] data shards → [m, N] parity shards."""
    if data_shards.shape[0] != k:
        raise ValueError(
            f"expected {k} data shards, got {tuple(data_shards.shape)}")
    return gf_matmul(generator_matrix(k, m), data_shards, **kw)


def rs_reconstruct(present: dict, k: int = 3, m: int = 2,
                   **kw) -> torch.Tensor:
    """Rebuild the [k, N] data block from ANY k available shards.

    `present` maps shard index (0..k-1 data, k..k+m-1 parity) → [N] bytes
    (numpy arrays or tensors). Raises if fewer than k shards are supplied.
    """
    if len(present) < k:
        raise ValueError(f"need {k} shards to reconstruct, have {len(present)}")
    rows = sorted(present)[:k]
    ext = extended_matrix(k, m)
    inv = gf_invert([ext[r] for r in rows])
    vals = [present[r] for r in rows]
    if all(isinstance(v, torch.Tensor) for v in vals):
        stacked = torch.stack([v.to(torch.uint8) for v in vals])
    else:
        stacked = np.stack([np.asarray(v, np.uint8) for v in vals])
    return gf_matmul(inv, stacked, **kw)
