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
// (a single LOP3) per output row. No tables and no shared memory: the
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
// work.
//
// Layout: one block of 256 threads covers 4096 columns.
// - Aligned path (N % 16 == 0 and both pointers 16-byte aligned, as the
//   stripe codec's padded widths give): each thread loads one 16-byte
//   vector per input row and stores one per output row.
// - Byte path (any N, any alignment; the segment encoder shards at
//   ceil(len / 3) with no padding, so its rows start misaligned): each
//   thread assembles four words from byte loads at columns
//   4 * (t + 256 w), so a warp's loads of one byte lane fall in one
//   128-byte line, and every byte is guarded by column < N. It issues
//   four times the memory instructions of the aligned path, which makes
//   it the slower of the two; realigning word loads with funnel shifts
//   is the known remedy, left for later.
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
constexpr int kCols = kThreads * kWords * 4;  // columns per block

struct Products {
  uint32_t v[kTile][kTile][8];  // c_ij * 2^b in all four byte lanes
};

template <bool kVec>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ row,
                                         long long n, long long c0,
                                         uint32_t x[kWords]) {
  if (kVec) {
    const long long c = c0 + 16LL * threadIdx.x;
    if (c < n) {
      const uint4 q = *reinterpret_cast<const uint4*>(row + c);
      x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
    } else {
      x[0] = x[1] = x[2] = x[3] = 0u;
    }
  } else {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const long long c = c0 + 4LL * (threadIdx.x + kThreads * w);
      uint32_t word = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (c + b < n) word |= (uint32_t)row[c + b] << (8 * b);
      x[w] = word;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_row(uint8_t* __restrict__ row,
                                          long long n, long long c0,
                                          const uint32_t y[kWords]) {
  if (kVec) {
    const long long c = c0 + 16LL * threadIdx.x;
    if (c < n)
      *reinterpret_cast<uint4*>(row + c) = make_uint4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const long long c = c0 + 4LL * (threadIdx.x + kThreads * w);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (c + b < n) row[c + b] = (uint8_t)(y[w] >> (8 * b));
    }
  }
}

template <int M, bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 long long n, int k, int accumulate, const Products p) {
  const long long c0 = (long long)blockIdx.x * kCols;
  uint32_t acc[M][kWords];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (accumulate) {
      load_row<kVec>(out + i * n, n, c0, acc[i]);
    } else {
#pragma unroll
      for (int w = 0; w < kWords; ++w) acc[i][w] = 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (j >= k) break;
    uint32_t x[kWords];
    load_row<kVec>(in + j * n, n, c0, x);
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
#pragma unroll
  for (int i = 0; i < M; ++i) store_row<kVec>(out + i * n, n, c0, acc[i]);
}

template <int M>
void launch(bool vec, unsigned blocks, cudaStream_t s, const uint8_t* in,
            uint8_t* out, long long n, int k, int accumulate,
            const Products& p) {
  if (vec) {
    gf_matmul_kernel<M, true><<<blocks, kThreads, 0, s>>>(in, out, n, k,
                                                          accumulate, p);
  } else {
    gf_matmul_kernel<M, false><<<blocks, kThreads, 0, s>>>(in, out, n, k,
                                                           accumulate, p);
  }
}

}  // namespace

// in: uint8 [k, n] rows of stride n; out: uint8 [m, n] rows of stride n;
// products: host array uint32 [4][4][8] (rows/columns past m, k ignored).
extern "C" int ripplemq_gf_matmul(const void* in, void* out, long long n,
                                  int m, int k, const void* products,
                                  int accumulate, int vec16, int device,
                                  void* stream) {
  if (n <= 0) return 0;
  if (m < 1 || m > kTile || k < 1 || k > kTile) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kCols - 1) / kCols;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // This library carries its own CUDA runtime: select the tensors' device
  // (the primary context PyTorch uses) before launching on its stream.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Products p;
  memcpy(&p, products, sizeof(p));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  const bool vec = vec16 != 0;
  const unsigned g = (unsigned)blocks;
  switch (m) {
    case 1: launch<1>(vec, g, s, src, dst, n, k, accumulate, p); break;
    case 2: launch<2>(vec, g, s, src, dst, n, k, accumulate, p); break;
    case 3: launch<3>(vec, g, s, src, dst, n, k, accumulate, p); break;
    default: launch<4>(vec, g, s, src, dst, n, k, accumulate, p); break;
  }
  return (int)cudaGetLastError();
}
