// Log-append write phase for Hopper (sm_90a): the active-set append.
//
// Replaces the reference's Pallas TPU kernels `_kernel_active` and
// `_kernel_active_packed` (ripplemq_tpu/ops/append.py, launched by
// `_append_active_pallas`). It computes what they compute, not how: for
// each replica r and active entry a with p = slot_ids[a] >= 0 and
// do_write[r, p], copy entries[a] into log[r, p, base[p] : base[p] + rows]
// in place. rows is B, or in packed mode 8 * class(p), where class(p) is
// the smallest member of {1, 2, 4, ... < B/8} U {B/8} that is >= the
// partition's extent in 8-row blocks (extent clipped to [0, B], rounded
// up to 8-row blocks, then to [1, B/8]); the kernel computes it from the
// raw int32 extents. Rows past the class keep their bytes.
//
// What bounds it: bytes. The floor is each active entry's window read
// once plus one copy of it written per writing replica, over
// device-memory bandwidth; there is no arithmetic. An earlier design ran
// one block per (entry, replica) and so read every entry once per
// replica (5x the entry bytes through L2 at R = 5), with a short window
// of 16-byte loads per thread. This design:
// - One CTA per active entry. Padding ids and entries that no replica
//   writes return before moving a byte.
// - The window log[r, p, base : base + rows, :] is one contiguous run of
//   bytes in the [R, P, S+B, SB] layout, and so is its source in
//   entries[a]; rows outside [0, SP) are clipped off both ends (the
//   plain version's drop rule), leaving one 1-D copy per replica.
// - Bulk path (every address and the length 16-byte aligned): one thread
//   streams the window through a two-stage ring of `chunk`-byte buffers
//   in dynamic shared memory. Each chunk comes in by one TMA bulk load
//   (cp.async.bulk ... mbarrier::complete_tx) and goes out by one TMA
//   bulk store per writing replica (cp.async.bulk ... bulk_group); the
//   next chunk's load is in flight while the current one is stored. So
//   entry bytes leave device memory once, and no thread spends registers
//   or instructions on the bytes. The wrapper picks `chunk`: the whole
//   window up to 32 KiB, so a CTA holds up to 64 KiB of shared memory
//   and keeps a whole headline window in flight (more bytes in flight a
//   CTA beat more CTAs an SM on the card).
// - Register path (SB % 16 != 0 with misaligned windows, or misaligned
//   pointers): the CTA's threads load each 16-byte lane of the entry
//   once, kUnroll lanes in flight per thread, and store it to every
//   writing replica; bytes only at a misaligned head and tail, or
//   throughout when source and destinations disagree mod 16. No runtime
//   divide.
//
// Guards: ids past P-1 are clipped to P-1 (as the reference launcher
// clips them); rows outside [0, SP) are dropped; rows past the class are
// untouched; a partition appears at most once per round (the caller's
// contract, as in the reference), so no two CTAs write one window.
//
// Interface: plain C, called through ctypes on PyTorch's current stream.
// Returns the cudaError_t of the launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAlign = 8;
constexpr int kThreads = 128;
constexpr int kUnroll = 4;
constexpr int kMaxReplicas = 64;  // writing replicas ride a 64-bit mask
constexpr int kStages = 2;  // buffers in the shared ring

__device__ __forceinline__ int extent_class(int ext, int B) {
  // Raw row extent -> rows written: clip to [0, B], round up to ALIGN-row
  // blocks, clip to [1, B/ALIGN], then the power-of-two class rule.
  const int ba = B / kAlign;
  ext = ext < 0 ? 0 : (ext > B ? B : ext);
  int eb = (ext + kAlign - 1) / kAlign;
  eb = eb < 1 ? 1 : (eb > ba ? ba : eb);
  int c = 1;
  while (c < eb) c <<= 1;
  return kAlign * (c >= ba ? ba : c);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One thread moves the window: src -> shared ring -> every writing
// replica. kStages buffers of `chunk` bytes: kStages - 1 loads run
// ahead of the chunk being stored, and a buffer is refilled once the
// stores of the chunk it held have read it (the group before the newest).
__device__ void copy_bulk(uint8_t* dst0, long long rstride,
                          const uint8_t* src, long long nbytes, int chunk,
                          uint64_t wmask, uint8_t* ring, uint64_t* bars) {
  const uint32_t bar0 = smem_addr(bars), buf0 = smem_addr(ring);
  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar0 + 8u * s));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  auto size_at = [&](long long off) -> uint32_t {
    const long long left = nbytes - off;
    return (uint32_t)(left < chunk ? left : chunk);
  };
  long long ahead = 0;  // offset of the next chunk to load
  int load_stage = 0;
  for (; load_stage < kStages - 1 && ahead < nbytes; ++load_stage) {
    bulk_load(buf0 + (uint32_t)(load_stage * chunk), src + ahead,
              size_at(ahead), bar0 + 8u * load_stage);
    ahead += chunk;
  }
  int s = 0;
  uint32_t parity = 0;
  for (long long off = 0; off < nbytes; off += chunk) {
    const uint32_t buf = buf0 + (uint32_t)(s * chunk);
    const uint32_t bytes = size_at(off);
    mbar_wait(bar0 + 8u * s, parity);
    for (uint64_t m = wmask; m; m &= m - 1) {
      const int r = __ffsll((long long)m) - 1;
      bulk_store(dst0 + r * rstride + off, buf, bytes);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (ahead < nbytes) {
      // load_stage held the chunk before this one: wait for its stores
      // (the group before the newest) to have read it.
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      if (load_stage == kStages) load_stage = 0;
      bulk_load(buf0 + (uint32_t)(load_stage * chunk), src + ahead,
                size_at(ahead), bar0 + 8u * load_stage);
      ahead += chunk;
      ++load_stage;
    }
    if (++s == kStages) {
      s = 0;
      parity ^= 1u;
    }
  }
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// All threads: bytes [lo, hi) of the window, one at a time.
__device__ __forceinline__ void copy_bytes(uint8_t* dst0, long long rstride,
                                           const uint8_t* src, long long lo,
                                           long long hi, uint64_t wmask) {
  for (long long k = lo + threadIdx.x; k < hi; k += kThreads * kUnroll) {
    uint8_t v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = k + j * kThreads;
      v[j] = i < hi ? src[i] : 0;
    }
    for (uint64_t m = wmask; m; m &= m - 1) {
      uint8_t* d = dst0 + (__ffsll((long long)m) - 1) * rstride;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long i = k + j * kThreads;
        if (i < hi) d[i] = v[j];
      }
    }
  }
}

// All threads: the window through registers, 16-byte lanes where source
// and every destination share their misalignment, bytes elsewhere.
__device__ void copy_registers(uint8_t* dst0, long long rstride,
                               const uint8_t* src, long long nbytes,
                               uint64_t wmask) {
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const bool co = ((reinterpret_cast<uintptr_t>(dst0) - sa) & 15) == 0 &&
                  (rstride & 15) == 0;
  if (!co) {
    copy_bytes(dst0, rstride, src, 0, nbytes, wmask);
    return;
  }
  long long head = (long long)((16 - (sa & 15)) & 15);
  if (head > nbytes) head = nbytes;
  const long long lanes = (nbytes - head) >> 4;
  const long long body_end = head + (lanes << 4);
  copy_bytes(dst0, rstride, src, 0, head, wmask);
  copy_bytes(dst0, rstride, src, body_end, nbytes, wmask);
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  for (long long k = threadIdx.x; k < lanes; k += kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = k + j * kThreads;
      if (i < lanes) v[j] = s4[i];
    }
    for (uint64_t m = wmask; m; m &= m - 1) {
      uint4* d4 = reinterpret_cast<uint4*>(
          dst0 + (__ffsll((long long)m) - 1) * rstride + head);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long i = k + j * kThreads;
        if (i < lanes) d4[i] = v[j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
append_active_kernel(uint8_t* __restrict__ log,
                     const uint8_t* __restrict__ entries,
                     const int32_t* __restrict__ slot_ids,
                     const int32_t* __restrict__ base,
                     const uint8_t* __restrict__ do_write,
                     const int32_t* __restrict__ extents,  // null = legacy
                     int R, int P, long long SP, int SB, int B, int chunk) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t bars[kStages];
  const int a = blockIdx.x;
  int p = slot_ids[a];
  if (p < 0) return;
  if (p >= P) p = P - 1;
  uint64_t wmask = 0;
  for (int r = 0; r < R; ++r)
    if (do_write[(long long)r * P + p]) wmask |= 1ull << r;
  if (!wmask) return;

  // The window, clipped to the log's rows [0, SP).
  const int rows = extents ? extent_class(extents[p], B) : B;
  const long long b0 = base[p];
  const long long lo = b0 < 0 ? -b0 : 0;
  const long long hi = (SP - b0) < rows ? (SP - b0) : rows;
  if (hi <= lo) return;
  const long long nbytes = (hi - lo) * SB;
  const long long rstride = (long long)P * SP * SB;
  const uint8_t* src = entries + ((long long)a * B + lo) * SB;
  uint8_t* dst0 = log + ((long long)p * SP + b0 + lo) * SB;

  const bool bulk = ((reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst0) |
                      (uintptr_t)nbytes | (uintptr_t)rstride) & 15) == 0;
  if (bulk) {
    if (threadIdx.x == 0)
      copy_bulk(dst0, rstride, src, nbytes, chunk, wmask, ring, bars);
  } else {
    copy_registers(dst0, rstride, src, nbytes, wmask);
  }
}

}  // namespace

extern "C" int ripplemq_append_active(
    void* log, const void* entries, const void* slot_ids, const void* base,
    const void* do_write, const void* extents, int R, int P,
    long long SP, int SB, int A, int B, int chunk, int device,
    void* stream) {
  if (A <= 0 || R <= 0 || B <= 0) return 0;
  if (R > kMaxReplicas || chunk <= 0 || chunk % 16) {
    return (int)cudaErrorInvalidValue;
  }
  // This library carries its own CUDA runtime: select the tensors' device
  // (the primary context PyTorch uses) before launching on its stream.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = kStages * chunk;
  static int smem_set[64] = {0};  // per device: the attribute's last value
  if (device >= 0 && device < 64 && smem_set[device] != smem) {
    err = cudaFuncSetAttribute(append_active_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[device] = smem;
  }
  append_active_kernel<<<(unsigned)A, kThreads, smem,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(log), static_cast<const uint8_t*>(entries),
      static_cast<const int32_t*>(slot_ids), static_cast<const int32_t*>(base),
      static_cast<const uint8_t*>(do_write),
      static_cast<const int32_t*>(extents), R, P, SP, SB, B, chunk);
  return (int)cudaGetLastError();
}
