// GF(2^8) matrix product for Hopper (sm_90a): out[M, N] = C[M, K] . in[K, N].
//
// Replaces the reference's Pallas TPU kernel `_rs_kernel`
// (ripplemq_tpu/ops/rs.py, launched by `_gf_matmul_pallas`). The field is
// GF(2^8) with the 0x11D polynomial; addition is XOR. Reed-Solomon encode
// is this product with the 2x3 Cauchy generator, reconstruction with the
// inverse of a 3x3 submatrix of the extended generator.
//
// Design: the bit-linear form the reference uses (`_gf_combine`), on
// packed 32-bit words, four byte columns per word. x * c is the XOR, over
// the set bits b of x, of c * 2^b; so with v[i][j][b] = c_ij * 2^b (a
// field product the host computes, repeated in all four byte lanes),
//
//   out_i = XOR_j XOR_b (mask_b(x_j) AND v[i][j][b]),
//
// where mask_b(x) is 0xFF in each byte lane whose bit b is set. Per word
// of an input row: eight masks (shift, and, multiply), then one AND-XOR
// (a single LOP3) per output row. No tables: the
// coefficients are a launch argument, so one library serves the encode
// matrix and every inverse, and the products sit in the parameter bank,
// which the LOP3s read directly. A zero coefficient's products are zero
// and add nothing.
//
// What bounds it: bytes. Each input byte is read once and each output
// byte written once, (K + M) * N bytes over 3.35 TB/s: at a 64 MiB
// segment's shard length (N = 22,369,622) that is 33 us for the 2x3
// encode and 40 us for a 3x3 reconstruct. The arithmetic is not far
// behind: (24 + 8M) integer ops per input word, about 6 per byte moved
// for the encode, against some 33e12 thread-instructions/s the card can
// issue, so the kernel may end up bound by instruction issue at up to
// ~2x the byte bound. Cutting ops (sharing masks, byte tables) is later
// work. An earlier byte path assembled every word of a misaligned row
// from four guarded byte loads and wrote single bytes back: four times
// the memory instructions of the aligned path, at 2.6x the byte bound.
// The realigned path below replaces it.
//
// Two paths, chosen by the wrapper (`ops/rs.py` `_launch_shape`):
// - Aligned path (N % 16 == 0 and both pointers 16-byte aligned, as the
//   stripe codec's padded widths give): one block of 256 threads covers
//   4096 columns; each thread loads one 16-byte vector per input row and
//   stores one per output row.
// - Realigned path (every other case: the segment encoder shards at
//   ceil(len / 3) with no padding, so its rows start at arbitrary
//   addresses, and ragged widths). A block of 256 threads computes a
//   frame of 4096 columns starting 16 columns before the 4080 it owns
//   (255 aligned 16-byte vectors of each output row). For input row j,
//   misaligned by d_j, thread t loads the aligned 16-byte vectors t and
//   t + 1 of the frame (the aligned floor of the frame's first byte, plus
//   16 t) and builds its four words with __funnelshift_r of adjacent
//   words, shifted by 8 * d_j; the second vector is its neighbour's
//   first, so it mostly comes from L1. Results go to a shared tile, and
//   each output row, misaligned by e_i, leaves by aligned 16-byte stores
//   built the same way from two conflict-free 16-byte shared loads. A
//   block owns columns [b * 4080 - e_i, (b + 1) * 4080 - e_i) of row i,
//   so consecutive blocks meet on 16-byte boundaries of that row, and
//   byte stores remain only for the row's head (before its first aligned
//   address, block 0) and its tail past N (the last block), at most 15
//   bytes each. An aligned load that holds at least one byte of the row
//   lies in the row's allocation; its bytes outside the row are never
//   stored.
// Offsets are 64-bit. One launch takes M, K <= 4; the wrapper tiles a
// larger matrix (up to 16 x 16) into 4 x 4 tiles, and tiles after the
// first column tile XOR into `out` (`accumulate`).
//
// Interface: plain C, called through ctypes on PyTorch's current stream.
// Returns the cudaError_t of the launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4;                      // rows of C and of in per launch
constexpr int kWords = 4;                     // 32-bit words per thread per row
constexpr int kCols = kThreads * kWords * 4;  // columns per block (its frame)
constexpr int kStep = kCols - 16;             // columns a realigned block owns

struct Products {
  uint32_t v[kTile][kTile][8];  // c_ij * 2^b in all four byte lanes
};

// acc[i] ^= c_ij * x for the four words of one input row j.
template <int M>
__device__ __forceinline__ void combine(uint32_t (&acc)[M][kWords],
                                        const uint32_t (&x)[kWords], int j,
                                        const Products& p) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint32_t mask = ((x[w] >> b) & 0x01010101u) * 0xFFu;
#pragma unroll
      for (int i = 0; i < M; ++i) acc[i][w] ^= mask & p.v[i][j][b];
    }
  }
}

// ------------------------------------------------------------ aligned path

__device__ __forceinline__ void load_vec(const uint8_t* __restrict__ row,
                                         long long n, long long c0,
                                         uint32_t x[kWords]) {
  const long long c = c0 + 16LL * threadIdx.x;
  if (c < n) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + c);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
    x[0] = x[1] = x[2] = x[3] = 0u;
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
gf_matmul_vec16_kernel(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out, long long n, int k,
                       int accumulate, const Products p) {
  const long long c0 = (long long)blockIdx.x * kCols;
  uint32_t acc[M][kWords];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (accumulate) {
      load_vec(out + i * n, n, c0, acc[i]);
    } else {
#pragma unroll
      for (int w = 0; w < kWords; ++w) acc[i][w] = 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (j >= k) break;
    uint32_t x[kWords];
    load_vec(in + j * n, n, c0, x);
    combine<M>(acc, x, j, p);
  }
  const long long c = c0 + 16LL * threadIdx.x;
  if (c < n) {
#pragma unroll
    for (int i = 0; i < M; ++i)
      *reinterpret_cast<uint4*>(out + i * n + c) =
          make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ---------------------------------------------------------- realigned path

__device__ __forceinline__ unsigned misalign(const uint8_t* p) {
  return (unsigned)(reinterpret_cast<uintptr_t>(p) & 15);
}

// Aligned vector v of a row's frame: the 16 bytes at (row - d) + f0 + 16 v,
// i.e. columns f0 - d + 16 v .. + 16; zero when none of them is in
// [0, n). Such a load holds at least one byte of the row, so it lies in
// the row's allocation.
__device__ __forceinline__ uint4 frame_vec(const uint8_t* row, long long n,
                                           long long f0, int v) {
  const long long c = f0 - (long long)misalign(row) + 16LL * v;
  if (c >= n || c + 16 <= 0) return make_uint4(0u, 0u, 0u, 0u);
  return *reinterpret_cast<const uint4*>(row + c);
}

// The 16 bytes at byte offset s (0..16) of the 32 bytes a:b, as four
// words: a funnel shift of adjacent words. s is the same for the whole
// block, so the word choice is a uniform branch.
__device__ __forceinline__ void realign(const uint4& a, const uint4& b,
                                        unsigned s, uint32_t (&x)[kWords]) {
  uint32_t w0, w1, w2, w3, w4;
  switch (s >> 2) {
    case 0: w0 = a.x; w1 = a.y; w2 = a.z; w3 = a.w; w4 = b.x; break;
    case 1: w0 = a.y; w1 = a.z; w2 = a.w; w3 = b.x; w4 = b.y; break;
    case 2: w0 = a.z; w1 = a.w; w2 = b.x; w3 = b.y; w4 = b.z; break;
    case 3: w0 = a.w; w1 = b.x; w2 = b.y; w3 = b.z; w4 = b.w; break;
    default: w0 = b.x; w1 = b.y; w2 = b.z; w3 = b.w; w4 = 0u; break;
  }
  const unsigned sh = (s & 3u) * 8u;
  x[0] = __funnelshift_r(w0, w1, sh);
  x[1] = __funnelshift_r(w1, w2, sh);
  x[2] = __funnelshift_r(w2, w3, sh);
  x[3] = __funnelshift_r(w3, w4, sh);
}

// Thread t's words: frame columns f0 + 16 t .. + 16 of a row misaligned
// by d, from the aligned vectors t and t + 1 of its frame (the second is
// the next thread's first, so it mostly comes from L1).
__device__ __forceinline__ void load_realigned(const uint8_t* row,
                                               long long n, long long f0,
                                               int t, uint32_t (&x)[kWords]) {
  const unsigned d = misalign(row);
  const uint4 a = frame_vec(row, n, f0, t);
  const uint4 b = d ? frame_vec(row, n, f0, t + 1) : a;
  realign(a, b, d, x);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
gf_matmul_realign_kernel(const uint8_t* __restrict__ in,
                         uint8_t* __restrict__ out, long long n, int k,
                         int accumulate, const Products p) {
  // Results, word w of thread t at [t][w]: the frame's columns in order.
  __shared__ __align__(16) uint4 tile[M][kThreads];
  const long long f0 = (long long)blockIdx.x * kStep - 16;  // frame start
  const int t = threadIdx.x;

  uint32_t acc[M][kWords];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (accumulate) {
      load_realigned(out + i * n, n, f0, t, acc[i]);
    } else {
#pragma unroll
      for (int w = 0; w < kWords; ++w) acc[i][w] = 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (j >= k) break;
    uint32_t x[kWords];
    load_realigned(in + j * n, n, f0, t, x);
    combine<M>(acc, x, j, p);
  }
#pragma unroll
  for (int i = 0; i < M; ++i)
    tile[i][t] = make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();

  // Store: thread t writes the t-th aligned vector this block owns of
  // each output row, bytes 16 - e_i + 16 t of the frame; byte stores only
  // where the row starts or ends.
  if (t >= kStep / 16) return;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    uint8_t* row = out + i * n;
    const unsigned e = misalign(row);
    const long long c = f0 + 16 - e + 16LL * t;  // column of the vector
    uint32_t y[kWords];
    realign(tile[i][t], tile[i][t + 1], 16u - e, y);
    if (c >= 0 && c + 16 <= n) {
      *reinterpret_cast<uint4*>(row + c) = make_uint4(y[0], y[1], y[2], y[3]);
    } else if (c < n && c + 16 > 0) {
#pragma unroll
      for (int m = 0; m < 16; ++m)
        if (c + m >= 0 && c + m < n)
          row[c + m] = (uint8_t)(y[m >> 2] >> (8 * (m & 3)));
    }
  }
}

template <int M>
void launch(bool vec, unsigned blocks, cudaStream_t s, const uint8_t* in,
            uint8_t* out, long long n, int k, int accumulate,
            const Products& p) {
  if (vec) {
    gf_matmul_vec16_kernel<M><<<blocks, kThreads, 0, s>>>(in, out, n, k,
                                                          accumulate, p);
  } else {
    gf_matmul_realign_kernel<M><<<blocks, kThreads, 0, s>>>(in, out, n, k,
                                                             accumulate, p);
  }
}

}  // namespace

// in: uint8 [k, n] rows of stride n; out: uint8 [m, n] rows of stride n;
// products: host array uint32 [4][4][8] (rows/columns past m, k ignored);
// blocks: the grid the wrapper computed, checked here to cover n.
extern "C" int ripplemq_gf_matmul(const void* in, void* out, long long n,
                                  int m, int k, const void* products,
                                  int accumulate, int vec16, long long blocks,
                                  int device, void* stream) {
  if (n <= 0) return 0;
  if (m < 1 || m > kTile || k < 1 || k > kTile) return (int)cudaErrorInvalidValue;
  const bool vec = vec16 != 0;
  const long long need = vec ? (n + kCols - 1) / kCols
                             : (n + 15 + kStep - 1) / kStep;
  if (blocks != need || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // This library carries its own CUDA runtime: select the tensors' device
  // (the primary context PyTorch uses) before launching on its stream.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Products p;
  memcpy(&p, products, sizeof(p));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  const unsigned g = (unsigned)blocks;
  switch (m) {
    case 1: launch<1>(vec, g, s, src, dst, n, k, accumulate, p); break;
    case 2: launch<2>(vec, g, s, src, dst, n, k, accumulate, p); break;
    case 3: launch<3>(vec, g, s, src, dst, n, k, accumulate, p); break;
    default: launch<4>(vec, g, s, src, dst, n, k, accumulate, p); break;
  }
  return (int)cudaGetLastError();
}
