// Log-append write phase for Hopper (sm_90a): the active-set append.
//
// Replaces the reference's Pallas TPU kernels `_kernel_active` and
// `_kernel_active_packed` (ripplemq_tpu/ops/append.py, launched by
// `_append_active_pallas`). It computes what they compute, not how: for
// each replica r and active entry a with p = slot_ids[a] >= 0 and
// do_write[r, p], copy entries[a] into log[r, p, base[p] : base[p] + rows]
// in place. rows is B, or in packed mode 8 * class(p), where class(p) is
// the smallest member of {1, 2, 4, ... < B/8} U {B/8} that is >= the
// partition's extent in 8-row blocks (clipped to [1, B/8]). Rows past the
// class keep their bytes.
//
// What bounds it: bytes. Every launched (r, a) block moves rows * SB
// bytes from entries to the log and does no arithmetic to speak of, so
// the floor is (bytes read + bytes written) over device-memory bandwidth.
// The design answers that with wide, coalesced traffic: one block per
// (entry, replica) window, 16-byte vector loads and stores when SB and
// the pointers allow (a row of 128 bytes is eight 16-byte lanes, so a
// warp covers four rows per step), a byte loop otherwise. The TPU
// kernel's "uniform" path (one DMA for a run of lockstep partitions)
// only cut DMA-issue cost on the TPU and has no counterpart here.
//
// Guards: ids past P-1 are clipped to P-1 (as the reference launcher
// clips them), and every row is written only if 0 <= base[p] + i < SP
// (the log's physical row count), so a bad base drops rows instead of
// writing outside the log — the plain version's drop semantics.
//
// Interface: plain C, called through ctypes on PyTorch's current stream.
// Returns the cudaError_t of the launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAlign = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ int extent_class(int eb, int ba) {
  // eb: extent in ALIGN-row blocks; classes are powers of two below ba,
  // plus ba itself.
  eb = eb < 1 ? 1 : (eb > ba ? ba : eb);
  int c = 1;
  while (c < eb) c <<= 1;
  return c >= ba ? ba : c;
}

template <typename Lane>
__global__ void __launch_bounds__(kThreads)
append_active_kernel(uint8_t* __restrict__ log,
                     const uint8_t* __restrict__ entries,
                     const int32_t* __restrict__ slot_ids,
                     const int32_t* __restrict__ base,
                     const uint8_t* __restrict__ do_write,
                     const int32_t* __restrict__ ext_blocks,  // null = legacy
                     int P, long long SP, int SB, int B) {
  const int a = blockIdx.x;
  const int r = blockIdx.y;
  int p = slot_ids[a];
  if (p < 0) return;
  if (p >= P) p = P - 1;
  if (!do_write[(long long)r * P + p]) return;

  const int rows = ext_blocks ? kAlign * extent_class(ext_blocks[p], B / kAlign)
                              : B;
  const long long b0 = base[p];
  const int lanes = SB / (int)sizeof(Lane);  // lanes per row
  const Lane* src = reinterpret_cast<const Lane*>(entries + (long long)a * B * SB);
  Lane* dst = reinterpret_cast<Lane*>(log + ((long long)r * P + p) * SP * SB);

  const int n = rows * lanes;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int i = k / lanes;
    const long long row = b0 + i;
    if (row < 0 || row >= SP) continue;
    dst[row * lanes + (k - i * lanes)] = src[k];
  }
}

}  // namespace

extern "C" int ripplemq_append_active(
    void* log, const void* entries, const void* slot_ids, const void* base,
    const void* do_write, const void* ext_blocks, int R, int P,
    long long SP, int SB, int A, int B, int vec16, int device, void* stream) {
  if (A <= 0 || R <= 0) return 0;
  // This library carries its own CUDA runtime: select the tensors' device
  // (the primary context PyTorch uses) before launching on its stream.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)A, (unsigned)R);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto* lg = static_cast<uint8_t*>(log);
  auto* en = static_cast<const uint8_t*>(entries);
  auto* ids = static_cast<const int32_t*>(slot_ids);
  auto* bs = static_cast<const int32_t*>(base);
  auto* dw = static_cast<const uint8_t*>(do_write);
  auto* eb = static_cast<const int32_t*>(ext_blocks);
  if (vec16) {
    append_active_kernel<uint4><<<grid, kThreads, 0, s>>>(
        lg, en, ids, bs, dw, eb, P, SP, SB, B);
  } else {
    append_active_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        lg, en, ids, bs, dw, eb, P, SP, SB, B);
  }
  return (int)cudaGetLastError();
}
