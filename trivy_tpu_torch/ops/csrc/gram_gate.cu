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
// TB/s. The first kernel (0.213 ms) ran a binary search over the 23,644
// gate keys (92 KB, about 15 dependent loads, the lower levels from L2) for
// every word of every row, some 3 million per batch. This one screens first:
//
// 1. One block of 512 threads per row. The LUT sits in shared memory while
//    the row is staged as its LUT image with 16-byte loads (byte loads when
//    the row is not 16-byte aligned); the non-ASCII lane is stored into the
//    output flags during the staging.
// 2. Word starts are compacted by warps over neighbouring 4-byte words of
//    the row (popc and a warp scan, then a block-wide scan of the warps'
//    counts: no bank conflicts), as 16-bit offsets.
// 3. One thread per word sums the word to its separator (or the row end)
//    and hashes it; long words serialise on their thread.
// 4. One thread per word folds the gram key and tests two bits of a 2^18-bit
//    bitset of the gate keys (`screen`, 32 KiB, built on the host beside the
//    table and read through the read-only path; a copy in shared memory
//    costs a block per SM and was slower): a key with a clear bit is
//    not in the table. Only a key whose two bits are set runs the exact
//    binary search, so the flags are those of the search alone; the search
//    reads a directory of the table by the keys' top 12 bits (16 KiB, built
//    on the host) and runs over the ~6 keys of its run, not all 23,644.
//    The 37-key `anchor` table is copied into shared memory (into the dead
//    row image, after the lanes) and searched there. A hit ORs its lane's
//    bit into the block's flag, kept in shared memory where the row's LUT
//    image was.
// 5. Those flags are ORed into the output flags.
// About 4C + 0.5 KB of shared memory per block (65.7 KB at C = 16384, three
// blocks per SM). Keep it so: with the lanes in a region of their own (204
// bytes more per block) the first kernel took a third longer at the same
// occupancy, most likely because the driver then leaves less of the SM's
// 256 KB to the L1 that caches the bitset and the upper levels of the
// searches.

#include <cstdint>
#include <cuda_runtime.h>

#include "license_words.cuh"

namespace {

using namespace license_words;

constexpr int kThreads = 512;
// the bits of an output flag
constexpr uint32_t kGram = 1u, kAnchor = 2u, kNonAscii = 4u;

// shared memory of one block: hashes (and the LUT while staging), word
// starts, the LUT image of the row (then the gram and anchor flags and the
// anchor table), scan scratch
__host__ __device__ constexpr int hash_cap(int C) { return C / 2 + 1 > 256 ? C / 2 + 1 : 256; }
__host__ __device__ constexpr int off_starts(int C) { return 4 * hash_cap(C); }
__host__ __device__ constexpr int off_row(int C) { return align16(off_starts(C) + 2 * (C / 2 + 1)); }
__host__ __device__ constexpr int off_scratch(int C) { return align16(off_row(C) + C); }
__host__ __device__ constexpr int smem_bytes(int C) {
  return off_scratch(C) + 4 * (kThreads / 32 + 1);
}

// ORs `bit` into byte k of the flags held in 32-bit shared words
__device__ __forceinline__ void set_flag(uint32_t* words, int k, uint32_t bit) {
  atomicOr(words + (k >> 2), bit << (8 * (k & 3)));
}

// four row bytes (one 32-bit word) to their LUT values
__device__ __forceinline__ uint32_t lut4(const uint32_t* lut, uint32_t w) {
  return lut[w & 0xFFu] | lut[(w >> 8) & 0xFFu] << 8 | lut[(w >> 16) & 0xFFu] << 16 |
         lut[w >> 24] << 24;
}

__global__ void __launch_bounds__(kThreads)
gram_gate_kernel(const uint8_t* __restrict__ x, int C, int blk, const uint32_t* __restrict__ lut,
                 const uint32_t* __restrict__ gate, int n_gate, const uint32_t* __restrict__ anchor,
                 int n_anchor, const uint32_t* __restrict__ screen,
                 const uint32_t* __restrict__ dir,
                 uint32_t P1, uint32_t P2, uint32_t HP, int ngram, uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  uint32_t* H = reinterpret_cast<uint32_t*>(base);
  uint16_t* starts = reinterpret_cast<uint16_t*>(base + off_starts(C));
  uint8_t* v = base + off_row(C);
  int* scratch = reinterpret_cast<int*>(base + off_scratch(C));
  // the gram and anchor flags, one byte per output block, over the row's
  // LUT image once it is dead (nb <= C bytes; rounded up to whole words
  // they still end before the scan scratch, which is dead too), then the
  // anchor table where it fits
  uint32_t* lanes = reinterpret_cast<uint32_t*>(v);
  const int nb = C / blk;
  const bool anchor_here = align16(nb) + 4 * n_anchor <= C;
  uint32_t* anchor_s = reinterpret_cast<uint32_t*>(v + align16(nb));
  const uint32_t* anch = anchor_here ? anchor_s : anchor;

  const long long row = blockIdx.x;
  const uint8_t* src = x + row * C;
  uint8_t* flags = out + row * nb;

  // 1. the LUT, then the row's LUT image and the non-ASCII lane
  for (int k = threadIdx.x; k < 256; k += kThreads) H[k] = lut[k];
  __syncthreads();
  if (C % 16 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // blk divides C, so blk >= 16 and each 16 bytes lie in one block
    for (int i = threadIdx.x; i < C / 16; i += kThreads) {
      const uint4 w = reinterpret_cast<const uint4*>(src)[i];
      if ((w.x | w.y | w.z | w.w) & 0x80808080u) flags[16 * i / blk] = kNonAscii;
      reinterpret_cast<uint4*>(v)[i] = make_uint4(lut4(H, w.x), lut4(H, w.y), lut4(H, w.z),
                                                  lut4(H, w.w));
    }
  } else {
    for (int i = threadIdx.x; i < C; i += kThreads) {
      const uint8_t b = src[i];
      v[i] = static_cast<uint8_t>(H[b]);
      if (b >= 128) flags[i / blk] = kNonAscii;
    }
  }
  __syncthreads();

  // 2. word starts, 3. word hashes (the LUT is dead)
  const int nwords = compact_starts<kThreads>(v, C, starts, scratch);
  word_hashes(v, C, starts, nwords, P1, P2, H);
  __syncthreads();
  for (int w = threadIdx.x; w < (nb + 3) / 4; w += kThreads) lanes[w] = 0u;
  if (anchor_here) {
    for (int k = threadIdx.x; k < n_anchor; k += kThreads) anchor_s[k] = anchor[k];
  }
  __syncthreads();

  // 4. gram keys through the screen to the gate table, anchor words
  for (int j = threadIdx.x; j < nwords; j += kThreads) {
    if (j + ngram - 1 < nwords) {
      const uint32_t k = gram_key(H, j, ngram, HP);
      if (screened(screen, k) && find_dir(gate, dir, k) >= 0) {
        set_flag(lanes, starts[j] / blk, kGram);
      }
    }
    if (n_anchor > 0 && member(anch, n_anchor, H[j])) set_flag(lanes, starts[j] / blk, kAnchor);
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
// uint32 tables, screen [2^13] uint32 (the prescreen bitset of `gate`) and
// dir [2^12 + 1] uint32 (its directory), all on the current device;
// out [B, C / blk] uint8 must be zeroed by the caller (the kernel only sets
// lane bits). C <= 65536 and blk divides C.
// Returns the first CUDA error (cudaGetLastError() after the launch), or 0.
int trivy_gram_gate_launch(const uint8_t* x, int B, int C, int blk, const uint32_t* lut,
                           const uint32_t* gate, int n_gate, const uint32_t* anchor, int n_anchor,
                           const uint32_t* screen, const uint32_t* dir, uint32_t P1,
                           uint32_t P2, uint32_t HP, int ngram, uint8_t* out, void* stream) {
  const int smem = smem_bytes(C);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gram_gate_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, C, blk, lut, gate, n_gate, anchor, n_anchor, screen, dir, P1, P2, HP, ngram, out);
  return static_cast<int>(cudaGetLastError());
}

const char* trivy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
