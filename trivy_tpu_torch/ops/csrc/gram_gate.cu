// License gram gate for Hopper (sm_90a): one thread block per row of the
// secret feed's resident [B, C] uint8 batch flags the 256-byte blocks where
// a corpus gram or a short-phrase anchor word starts, one bit per lane.
//
// Replaces trivy_tpu/ops/gram_gate.py:73 build_byte_gate_fn (an XLA device
// computation). The plain PyTorch version of the same function is
// trivy_tpu_torch/ops/gram_gate.py::gram_gate_plain. Flag k of row b holds
//   - bit 0 (gram lane) when a valid gram key (the fold of five consecutive
//     word hashes, see license_words.cuh) whose first word starts in block k
//     is in `gate`,
//   - bit 1 (anchor lane) when the hash of a word that starts in the block
//     is in `anchor`,
//   - bit 2 (non-ASCII lane) when the block holds a byte of 0x80 or above.
// The JAX computation's boolean flag is "any bit set". All arithmetic is
// native uint32, wrapping.
//
// What bounds it on an H100. The function reads the batch once and writes
// B * C / 256 flags: 16.8 MB for a [1024, 16384] batch, 5.0 us at 3.35
// TB/s. This first kernel is simple and right, not yet fast:
//
// 1. One block of 512 threads per row. The LUT sits in shared memory while
//    the row is staged as its LUT image (one byte per byte); the non-ASCII
//    lane is stored into the output flags during the staging.
// 2. Word starts are compacted by a block-wide scan over contiguous
//    stretches of the row (warp shuffles, then one warp over the warp
//    totals), as 16-bit offsets.
// 3. One thread per word sums the word to its separator (or the row end)
//    and hashes it; long words serialise on their thread.
// 4. One thread per word folds the gram key from the hashes of the next
//    words and binary-searches `gate` (23,644 keys, 92 KB, L2-resident) and
//    `anchor`; a hit ORs its lane's bit into the block's flag, kept in
//    shared memory where the row's LUT image was (dead after step 3).
// 5. Those flags are ORed into the output flags.
// About 4C + 0.5 KB of shared memory per block (65.7 KB at C = 16384). Keep
// it so: with the lanes in a region of their own (204 bytes more per block)
// the kernel took a third longer on an H100 at the same occupancy of three
// blocks per SM, most likely because the driver then leaves less of the SM's
// 256 KB to the L1 that caches the upper levels of the binary searches.

#include <cstdint>
#include <cuda_runtime.h>

#include "license_words.cuh"

namespace {

using namespace license_words;

constexpr int kThreads = 512;
// the bits of an output flag
constexpr uint32_t kGram = 1u, kAnchor = 2u, kNonAscii = 4u;

// shared memory of one block: hashes (and the LUT while staging), word
// starts, the LUT image of the row (then the gram and anchor flags), scan
// scratch
__host__ __device__ constexpr int hash_cap(int C) { return C / 2 + 1 > 256 ? C / 2 + 1 : 256; }
__host__ __device__ constexpr int off_starts(int C) { return 4 * hash_cap(C); }
__host__ __device__ constexpr int off_row(int C) { return align16(off_starts(C) + 2 * (C / 2 + 1)); }
__host__ __device__ constexpr int off_scratch(int C) { return align16(off_row(C) + C); }
__host__ __device__ constexpr int smem_bytes(int C) { return off_scratch(C) + 4 * (kThreads / 32 + 1); }

// ORs `bit` into byte k of the flags held in 32-bit shared words
__device__ __forceinline__ void set_flag(uint32_t* words, int k, uint32_t bit) {
  atomicOr(words + (k >> 2), bit << (8 * (k & 3)));
}

__global__ void __launch_bounds__(kThreads)
gram_gate_kernel(const uint8_t* __restrict__ x, int C, int blk, const uint32_t* __restrict__ lut,
                 const uint32_t* __restrict__ gate, int n_gate, const uint32_t* __restrict__ anchor,
                 int n_anchor, uint32_t P1, uint32_t P2, uint32_t HP, int ngram,
                 uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  uint32_t* H = reinterpret_cast<uint32_t*>(base);
  uint16_t* starts = reinterpret_cast<uint16_t*>(base + off_starts(C));
  uint8_t* v = base + off_row(C);
  int* scratch = reinterpret_cast<int*>(base + off_scratch(C));
  // the gram and anchor flags, one byte per output block, over the row's
  // LUT image once it is dead (nb <= C bytes; rounded up to whole words
  // they still end before the scan scratch, which is dead too)
  uint32_t* lanes = reinterpret_cast<uint32_t*>(v);
  const int nb = C / blk;

  const long long row = blockIdx.x;
  const uint8_t* src = x + row * C;
  uint8_t* flags = out + row * nb;

  // 1. the LUT, then the row's LUT image and the non-ASCII lane
  for (int k = threadIdx.x; k < 256; k += kThreads) H[k] = lut[k];
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += kThreads) {
    const uint8_t b = src[i];
    v[i] = static_cast<uint8_t>(H[b]);
    if (b >= 128) flags[i / blk] = kNonAscii;
  }
  __syncthreads();

  // 2. word starts, 3. word hashes (the LUT is dead)
  const int nwords = compact_starts<kThreads>(v, C, starts, scratch);
  word_hashes(v, C, starts, nwords, P1, P2, H);
  __syncthreads();
  for (int w = threadIdx.x; w < (nb + 3) / 4; w += kThreads) lanes[w] = 0u;
  __syncthreads();

  // 4. gram keys and anchor words against the tables
  for (int j = threadIdx.x; j < nwords; j += kThreads) {
    if (j + ngram - 1 < nwords && member(gate, n_gate, gram_key(H, j, ngram, HP))) {
      set_flag(lanes, starts[j] / blk, kGram);
    }
    if (n_anchor > 0 && member(anchor, n_anchor, H[j])) set_flag(lanes, starts[j] / blk, kAnchor);
  }
  __syncthreads();

  // 5. the gram and anchor lanes into the output flags (the staging's
  //    non-ASCII stores are visible to the whole block after the barriers)
  const uint8_t* lane_bytes = v;
  for (int k = threadIdx.x; k < nb; k += kThreads) {
    if (lane_bytes[k]) flags[k] |= lane_bytes[k];
  }
}

}  // namespace

extern "C" {

// Launches the gate on `stream` (PyTorch's current stream): x [B, C] uint8,
// lut [256] (values below 256), gate [n_gate] and anchor [n_anchor] sorted
// uint32 tables, all on the current device; out [B, C / blk] uint8 must be
// zeroed by the caller (the kernel only sets lane bits). C <= 65536 and blk
// divides C. Returns the first CUDA error (cudaGetLastError() after the
// launch), or 0.
int trivy_gram_gate_launch(const uint8_t* x, int B, int C, int blk, const uint32_t* lut,
                           const uint32_t* gate, int n_gate, const uint32_t* anchor, int n_anchor,
                           uint32_t P1, uint32_t P2, uint32_t HP, int ngram, uint8_t* out,
                           void* stream) {
  const int smem = smem_bytes(C);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gram_gate_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, C, blk, lut, gate, n_gate, anchor, n_anchor, P1, P2, HP, ngram, out);
  return static_cast<int>(cudaGetLastError());
}

const char* trivy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
