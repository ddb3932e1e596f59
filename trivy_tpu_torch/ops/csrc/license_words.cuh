// Word and gram hashing of the license classifier, for one row held in
// shared memory by one thread block. Shared by gram_gate.cu and
// bytes_score.cu.
//
// A row is staged as its LUT image: each byte replaced by its lowered value
// (every value fits a byte; separators are 0). A word is a run of non-zero
// values; its hash is s0 * P1 + s1 * P2 mod 2^32, with s0 the sum of its
// values and s1 their sum weighted by the offset in the word, summed to the
// next separator or to the row end. This is the low 32 bits of the
// classifier's int64 hash, and equals the JAX package's prefix-sum
// formulation (differences of prefix sums are exact mod 2^32). The gram key
// of word j folds the hashes of words j .. j + ngram - 1 as k = k * HP + h,
// valid when all of those words start inside the row.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace license_words {

constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// inclusive prefix sum over the lanes of a warp
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Block-wide exclusive prefix sum of one int per thread; *total receives the
// sum over the block. `scratch` holds THREADS / 32 + 1 ints. Every thread of
// the block must call it.
template <int THREADS>
__device__ int block_scan(int v, int* scratch, int* total) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_scan(v);
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? scratch[lane] : 0;
    const int wi = warp_scan(w);
    if (lane < kWarps) scratch[lane] = wi - w;
    if (lane == kWarps - 1) scratch[kWarps] = wi;
  }
  __syncthreads();
  const int excl = scratch[warp] + incl - v;
  *total = scratch[kWarps];
  __syncthreads();  // scratch may be reused at once
  return excl;
}

// Compacts the word starts of the staged row v[0, C) into starts[], in
// order, with a block-wide scan over contiguous stretches of the row;
// returns the number of words.
template <int THREADS>
__device__ int compact_starts(const uint8_t* v, int C, uint16_t* starts, int* scratch) {
  const int per = (C + THREADS - 1) / THREADS;
  const int i0 = min(static_cast<int>(threadIdx.x) * per, C);
  const int i1 = min(i0 + per, C);
  int n = 0;
  for (int i = i0; i < i1; ++i) n += v[i] != 0 && (i == 0 || v[i - 1] == 0);
  int total;
  int at = block_scan<THREADS>(n, scratch, &total);
  for (int i = i0; i < i1; ++i) {
    if (v[i] != 0 && (i == 0 || v[i - 1] == 0)) starts[at++] = static_cast<uint16_t>(i);
  }
  __syncthreads();
  return total;
}

// H[j] = hash of word j, one thread per word
__device__ __forceinline__ void word_hashes(const uint8_t* v, int C, const uint16_t* starts,
                                            int nwords, uint32_t P1, uint32_t P2, uint32_t* H) {
  for (int j = threadIdx.x; j < nwords; j += blockDim.x) {
    const int i = starts[j];
    uint32_t s0 = 0u, s1 = 0u;
    for (int k = i; k < C && v[k] != 0; ++k) {
      s0 += v[k];
      s1 += static_cast<uint32_t>(v[k]) * static_cast<uint32_t>(k - i);
    }
    H[j] = s0 * P1 + s1 * P2;
  }
}

// key of the gram whose first word is word j (j + ngram - 1 < nwords)
__device__ __forceinline__ uint32_t gram_key(const uint32_t* H, int j, int ngram, uint32_t HP) {
  uint32_t k = H[j];
  for (int t = 1; t < ngram; ++t) k = k * HP + H[j + t];
  return k;
}

// membership of v in the sorted table t[0, n)
__device__ __forceinline__ bool member(const uint32_t* __restrict__ t, int n, uint32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo < n && t[lo] == v;
}

// index of v in the sorted table t[0, n), or -1
__device__ __forceinline__ int find(const uint32_t* __restrict__ t, int n, uint32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo < n && t[lo] == v ? lo : -1;
}

}  // namespace license_words
