// Raw-bytes license scorer for Hopper (sm_90a): one thread block per text
// row tokenizes, hashes, sorts and dedups the row's gram keys and sums the
// corpus credit of the first `gcap` distinct ones.
//
// Replaces trivy_tpu/ops/ngram_score.py:754 build_bytes_score_fn (an XLA
// device computation), with one difference: the cap counts distinct keys
// (the reference credits the first gcap sorted entries, duplicates
// included). The plain PyTorch version of the same function is
// trivy_tpu_torch/ops/bytes_score.py::bytes_score_plain. Per row:
//   - the gram keys of license_words.cuh, clamped to 0xFFFFFFFE;
//   - n_uniq, the number of distinct keys;
//   - for each of the first gcap distinct keys in ascending order that is
//     in `keys` [Ku] (sorted uint32), its row of `credit` [Ku, 2 * ls] f32
//     added into the sum; columns [0, ls) are full_w, [ls, 2 ls) phrase.
// No matrix product: each column is a float32 sum taken in ascending key
// order, as the plain version on the CPU takes it.
//
// What bounds it on an H100. The function reads the rows once, gathers one
// credit row (944 bytes at ls = 118) per credited key and writes the sums:
// bytes-bound, and the gathered rows depend on the text. The sort costs
// O(n log^2 n) shared-memory steps per row. This first kernel is simple and
// right, not yet fast:
//
// 1. One block of 1024 threads per row. The LUT sits in shared memory while
//    the row (at most 49,152 bytes) is staged as its LUT image.
// 2. Word starts are compacted by a block-wide scan (16-bit offsets); one
//    thread per word hashes it.
// 3. The valid gram keys are written, padded with 0xFFFFFFFF to a power of
//    two n, into a buffer that reuses the row's and the starts' space, and
//    sorted there by a bitonic sort (n <= 32,768 at the widest rung).
// 4. A block-wide scan over the sorted keys ranks the distinct ones; each
//    of the first gcap looks itself up in `keys` by binary search and
//    stores its index (or -1) at its rank, reusing the hashes' space.
// 5. One thread per credit column walks the ranks in order and sums.
// Shared memory: max(row + starts, sort buffer) + hashes, 224.1 KB at the
// 49,152-byte rung, inside the 227 KB a block may use.

#include <cstdint>
#include <cuda_runtime.h>

#include "license_words.cuh"

namespace {

using namespace license_words;

constexpr int kThreads = 1024;
constexpr uint32_t kSent = 0xFFFFFFFFu;

__host__ __device__ constexpr int half_cap(int C) { return C / 2 + 1; }
__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}
__host__ __device__ constexpr int front_bytes(int C) {
  return align16(align16(C) + align16(2 * half_cap(C))) > 4 * pow2_at_least(half_cap(C))
             ? align16(align16(C) + align16(2 * half_cap(C)))
             : 4 * pow2_at_least(half_cap(C));
}
__host__ __device__ constexpr int hash_cap(int C) { return half_cap(C) > 256 ? half_cap(C) : 256; }
__host__ __device__ constexpr int off_scratch(int C) {
  return align16(front_bytes(C)) + align16(4 * hash_cap(C));
}
__host__ __device__ constexpr int smem_bytes(int C) { return off_scratch(C) + 4 * (kThreads / 32 + 1); }

__device__ void bitonic_sort(uint32_t* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int p = i ^ j;
        if (p > i) {
          const uint32_t a = s[i], b = s[p];
          if ((a > b) == ((i & k) == 0)) {
            s[i] = b;
            s[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bytes_score_kernel(const uint8_t* __restrict__ x, int C, const uint32_t* __restrict__ lut,
                   const uint32_t* __restrict__ keys, int Ku, const float* __restrict__ credit,
                   int ls, int gcap, uint32_t P1, uint32_t P2, uint32_t HP, int ngram,
                   float* __restrict__ full_w, float* __restrict__ phrase,
                   int32_t* __restrict__ n_uniq) {
  extern __shared__ uint4 smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  uint8_t* v = base;                                                     // [C], then dead
  uint16_t* starts = reinterpret_cast<uint16_t*>(base + align16(C));    // [C/2 + 1], then dead
  uint32_t* sorted = reinterpret_cast<uint32_t*>(base);                  // [n], over v and starts
  uint32_t* H = reinterpret_cast<uint32_t*>(base + align16(front_bytes(C)));  // LUT, hashes, hits
  int32_t* hitpos = reinterpret_cast<int32_t*>(H);
  int* scratch = reinterpret_cast<int*>(base + off_scratch(C));

  const long long row = blockIdx.x;
  const uint8_t* src = x + row * C;

  // 1. the LUT, then the row's LUT image
  for (int k = threadIdx.x; k < 256; k += kThreads) H[k] = lut[k];
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += kThreads) v[i] = static_cast<uint8_t>(H[src[i]]);
  __syncthreads();

  // 2. word starts, word hashes (the LUT is dead)
  const int nwords = compact_starts<kThreads>(v, C, starts, scratch);
  word_hashes(v, C, starts, nwords, P1, P2, H);
  __syncthreads();

  // 3. valid gram keys, padded to a power of two, sorted (row and starts are dead)
  const int nvalid = nwords - ngram + 1 > 0 ? nwords - ngram + 1 : 0;
  const int n = pow2_at_least(nvalid > 0 ? nvalid : 1);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    uint32_t k = kSent;
    if (j < nvalid) k = min(gram_key(H, j, ngram, HP), kSent - 1u);
    sorted[j] = k;
  }
  __syncthreads();
  bitonic_sort(sorted, n);

  // 4. rank the distinct keys; the first gcap find their credit row (the
  // hashes are dead: the scan's barriers order their last reads first)
  const int per = (n + kThreads - 1) / kThreads;
  const int i0 = min(static_cast<int>(threadIdx.x) * per, n);
  const int i1 = min(i0 + per, n);
  int fresh = 0;
  for (int i = i0; i < i1; ++i) {
    fresh += sorted[i] != kSent && (i == 0 || sorted[i] != sorted[i - 1]);
  }
  int total;
  int rank = block_scan<kThreads>(fresh, scratch, &total);
  for (int i = i0; i < i1 && rank < gcap; ++i) {
    if (sorted[i] != kSent && (i == 0 || sorted[i] != sorted[i - 1])) {
      hitpos[rank++] = find(keys, Ku, sorted[i]);
    }
  }
  __syncthreads();

  // 5. one thread per credit column, ranks in ascending key order
  const int m = min(total, gcap);
  for (int c = threadIdx.x; c < 2 * ls; c += kThreads) {
    float acc = 0.0f;
    for (int r = 0; r < m; ++r) {
      const int p = hitpos[r];
      if (p >= 0) acc += credit[static_cast<long long>(p) * (2 * ls) + c];
    }
    if (c < ls) full_w[row * ls + c] = acc;
    else phrase[row * ls + c - ls] = acc;
  }
  if (threadIdx.x == 0) n_uniq[row] = total;
}

}  // namespace

extern "C" {

// Launches the scorer on `stream` (PyTorch's current stream): x [B, C]
// uint8 (C <= 49152), lut [256] (values below 256), keys [Ku] sorted uint32,
// credit [Ku, 2 * ls] f32, all on the current device; writes full_w [B, ls],
// phrase [B, ls] and n_uniq [B]. Returns the first CUDA error
// (cudaGetLastError() after the launch), or 0.
int trivy_bytes_score_launch(const uint8_t* x, int B, int C, const uint32_t* lut,
                             const uint32_t* keys, int Ku, const float* credit, int ls, int gcap,
                             uint32_t P1, uint32_t P2, uint32_t HP, int ngram, float* full_w,
                             float* phrase, int32_t* n_uniq, void* stream) {
  const int smem = smem_bytes(C);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        bytes_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bytes_score_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, C, lut, keys, Ku, credit, ls, gcap, P1, P2, HP, ngram, full_w, phrase, n_uniq);
  return static_cast<int>(cudaGetLastError());
}

const char* trivy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
