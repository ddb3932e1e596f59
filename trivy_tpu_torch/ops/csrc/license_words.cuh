// Word and gram hashing of the license classifier, for one row held in
// shared memory by one thread block. Shared by gram_gate.cu and
// bytes_score.cu (which holds a slice of a row in each block of a cluster
// and sums its words as differences of prefix sums, with the same hash).
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

// The formats of the key tables' side tables, built on the host by
// ops/gram_gate.py (DIR_BITS, SCREEN_BITS, SCREEN_MUL there):
// - the directory of a sorted key table by its keys' top 12 bits
//   (key_directory), read by find_dir;
// - the gate keys' prescreen, bits k >> kScreenShift and
//   (k * kScreenMul) >> kScreenShift of a 2^18-bit set (screen_bits), read
//   by screened.
constexpr int kDirShift = 32 - 12;
constexpr int kScreenShift = 32 - 18;
constexpr uint32_t kScreenMul = 0x9E3779B1u;

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

// The word-start bits of the four bytes of 4-byte word q of the staged row
// v[0, n) (bit j: byte 4q + j starts a word). Zero for q >= q1.
__device__ __forceinline__ uint32_t start_bits(const uint8_t* v, int n, int q, int q1) {
  if (q >= q1) return 0u;
  const uint32_t w = reinterpret_cast<const uint32_t*>(v)[q];
  uint32_t prev = q == 0 ? 0u : v[4 * q - 1];
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t b = (w >> (8 * j)) & 0xFFu;
    if (4 * q + j < n && b != 0u && prev == 0u) bits |= 1u << j;
    prev = b;
  }
  return bits;
}

// Compacts the word starts of the staged row v[0, n) (4-byte aligned) into
// starts[], in order, and returns their number. Each warp owns a contiguous
// run of 4-byte words; its lanes read neighbouring words (no bank
// conflicts), count starts with popc, and place them with a warp scan
// after a block-wide scan of the warps' counts.
template <int THREADS>
__device__ int compact_starts(const uint8_t* v, int n, uint16_t* starts, int* scratch) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nq = (n + 3) >> 2;
  const int per = ((nq + kWarps - 1) / kWarps + 31) & ~31;
  const int q0 = min(warp * per, nq);
  const int q1 = min(q0 + per, nq);
  int count = 0;
  for (int q = q0 + lane; q - lane < q1; q += 32) count += __popc(start_bits(v, n, q, q1));
  count = __reduce_add_sync(0xffffffffu, count);
  int total;
  const int base = block_scan<THREADS>(lane == 0 ? count : 0, scratch, &total);
  int at = __shfl_sync(0xffffffffu, base, 0);
  for (int q = q0 + lane; q - lane < q1; q += 32) {
    uint32_t bits = start_bits(v, n, q, q1);
    const int c = __popc(bits);
    const int incl = warp_scan(c);
    int pos = at + incl - c;
    while (bits) {
      starts[pos++] = static_cast<uint16_t>(4 * q + __ffs(bits) - 1);
      bits &= bits - 1u;
    }
    at += __shfl_sync(0xffffffffu, incl, 31);
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

// membership of v in the sorted table t[0, n) (a generic pointer: shared or
// device memory)
__device__ __forceinline__ bool member(const uint32_t* __restrict__ t, int n, uint32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo < n && t[lo] == v;
}

// false when key k is surely not in the table whose prescreen is `screen`
// (device memory, read through the read-only path)
__device__ __forceinline__ bool screened(const uint32_t* __restrict__ screen, uint32_t k) {
  const uint32_t a = k >> kScreenShift, b = (k * kScreenMul) >> kScreenShift;
  return (__ldg(screen + (a >> 5)) >> (a & 31)) & (__ldg(screen + (b >> 5)) >> (b & 31)) & 1u;
}

// index of v in the sorted table t, or -1, searching only the run of keys
// that share v's top 32 - kDirShift bits: dir[b] is the index of the first
// key whose top bits are b or more
__device__ __forceinline__ int find_dir(const uint32_t* __restrict__ t,
                                        const uint32_t* __restrict__ dir, uint32_t v) {
  const uint32_t b = v >> kDirShift;
  int lo = static_cast<int>(__ldg(dir + b));
  const int end = static_cast<int>(__ldg(dir + b + 1));
  int hi = end;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(t + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo < end && __ldg(t + lo) == v ? lo : -1;
}

}  // namespace license_words
