// Raw-bytes license scorer for Hopper (sm_90a): a cluster of S thread blocks
// per text row tokenizes, hashes, sorts and dedups the row's gram keys and
// sums the corpus credit of the first `gcap` distinct ones.
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
// What bounds it on an H100. The function reads the rows and the key column
// once, gathers each credited credit row (944 bytes at ls = 118) once and
// writes the sums: bytes-bound, some microseconds per 1 MiB dispatch. The
// first kernel (one block of 1024 threads per row, a bitonic sort, one
// thread per column over every rank) took 0.08-0.50 ms, 29-79 times that,
// for three reasons; this design answers each:
//
// 1. The grid did not fill the card (21-64 blocks at the wide rungs and for
//    gathered batches). Now a cluster of S blocks (S = 1, 2, 4 or 8, chosen
//    by the wrapper from the width so that a slice holds at most 8 KiB)
//    works on each row. Block r stages slice r of the row
//    (C / S bytes, rounded up to 16) as its LUT image with 16-byte loads.
//    Each thread scans a stretch of the slice, four bytes per load: its
//    word starts and its sums of v[k] and k v[k] (k the position in the
//    row); a block scan and the slices' totals, exchanged after a cluster
//    barrier, give every position's prefix sums in the row. A word's two
//    sums are the differences of those prefixes at its start and after its
//    last byte: the thread holding the start subtracts, the thread holding
//    the last byte adds (atomics; when the word goes on past the slice, a
//    later block adds into the owner's shared memory). So no thread walks a
//    word, however long (the first kernel's one thread per word serialised
//    a row that is one long word). After another
//    barrier each block folds the gram keys of its words; the next
//    ngram - 1 word hashes may lie in later blocks (a long word may span
//    several slices) and are read through distributed shared memory.
// 2. The bitonic network took O(n log^2 n) steps with a barrier each (120
//    at the widest rung). Now the keys are split by value across the
//    cluster: bucket q holds the keys whose top log2 S bits are q, so
//    copies of a key meet in one bucket and the buckets are ordered. Each
//    block counts its keys per bucket, the counts are exchanged, and each
//    key is stored into its bucket in the owner's shared memory (or, when a
//    skewed row overfills a bucket, into a per-row region of the device
//    scratch, which always has room). Each block sorts its bucket with a
//    shared-memory LSD radix sort (four passes of 8-bit digits: a
//    histogram, a block scan, and a stable scatter of each tile of T keys
//    ranked within its warp by __match_any_sync). A key's distinct rank is
//    its rank in the bucket plus the distinct counts of the buckets before
//    it; only keys ranked below gcap look themselves up in `keys`.
// 3. The column sum walked every rank on 236 threads, one dependent load at
//    a time. Now each block compacts its credited corpus indices (found
//    keys only, looked up through a directory of `keys` by their top 12
//    bits: ~6 keys to search, not 23,644) in ascending order. The columns
//    are split across the cluster's blocks; one thread per column walks
//    the lists of blocks 0 .. S-1 in order (ascending key order, as before,
//    so each column's float sum is the plain version's), with 16 credit
//    values and the next 16 positions in flight ahead of the ordered adds.
// The kernel ends with a cluster barrier, so no block exits while another
// reads its shared memory. Blocks have 256 threads when a slice holds at
// most 2 KiB, else 512. Shared memory per block, for a slice of Cs bytes:
// 5.9 KB (256 threads) or 10.0 KB (512) of control, scan and radix
// scratch, region A (the slice image and starts, then the bucket: about
// 2 Cs at S = 1, 4 Cs at S > 1, where the bucket holds twice a slice's
// words) and region B (about 4 Cs). With the wrapper's choice of S (the
// smallest with slices of at most 8 KiB): 12.0 KB at [1024, 1024] and
// 18.2 KB at [512, 2048] (256 threads), 34.7 KB at [256, 4096] and 59.2 KB
// at [128, 8192] (S = 1), 75.6 KB at [64, 16384] (S = 2) and [32, 32768]
// (S = 4), 59.2 KB at [21, 49152] (S = 8);
// ops/bytes_score_cuda.py::CudaBytesScorer.plan reports it with the blocks
// that fit on an SM.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

#include "license_words.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace license_words;

constexpr uint32_t kSent = 0xFFFFFFFFu;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kAhead = 16;      // credit rows in flight per column thread

// what one block of a cluster holds and shares
struct Ctl {
  int nwords;                  // word starts in this block's slice
  uint32_t sum0, sum1;         // sums of v[k] and k v[k] over the slice (mod 2^32)
  uint32_t pre0[kMaxCluster + 1], pre1[kMaxCluster + 1];  // the same before each slice
  int cnt[kMaxCluster];        // this block's keys per bucket
  int nuniq;                   // distinct keys in this block's bucket
  int nhits;                   // entries of this block's credited list
  int base[kMaxCluster + 1];   // first word of each block; base[S] = words in the row
  int ntot[kMaxCluster];       // keys per bucket
  int goff[kMaxCluster];       // offset of each bucket in the row's device scratch
  int myoff[kMaxCluster];      // this block's first slot in each bucket
  int slot[kMaxCluster];       // slots taken so far
  int ubase;                   // distinct keys in the buckets before this one
  int utot;                    // distinct keys in the row
  uint32_t* dest[kMaxCluster];  // where each bucket lies
};

__host__ __device__ constexpr int slice_len(int C, int S) { return align16((C + S - 1) / S); }
__host__ __device__ constexpr int word_cap(int Cs) { return Cs / 2 + 1; }
// keys a bucket holds in shared memory (at S = 1 the bucket is the row's
// keys, which fit; at S > 1 twice a slice's words)
__host__ __device__ constexpr int bucket_cap(int Cs, int S) {
  return S == 1 ? word_cap(Cs) : 2 * word_cap(Cs);
}
// keys of a whole row at most: the stride of a half of its device scratch
__host__ __device__ constexpr int row_keys(int C) { return C / 2 + 1; }
__host__ __device__ constexpr int threads_for(int C, int S) {
  return slice_len(C, S) <= 2048 ? 256 : 512;
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// the shared memory layout: control, LUT, scan scratch, radix histogram and
// per-warp digit counts, region A (the slice's LUT image and word starts,
// then the bucket), region B (word sums, hashes and own keys, then the
// sort's second buffer and the dense ranks' lookups)
template <int T> struct Layout {
  int lut, scan, hist, wc, a, b, bytes;
  __host__ __device__ Layout(int C, int S) {
    const int Cs = slice_len(C, S), Wc = word_cap(Cs), Kc = bucket_cap(Cs, S);
    lut = align16(static_cast<int>(sizeof(Ctl)));
    scan = lut + 256;
    hist = scan + align16(12 * (T / 32 + 1));
    wc = hist + 4 * 256;
    a = wc + align16(2 * (T / 32) * 256);
    b = a + align16(cmax(align16(Cs) + 2 * Wc, 4 * Kc));
    bytes = b + align16(cmax(8 * Wc, 4 * Kc));
  }
};

// Block-wide exclusive prefix sums (mod 2^32) of three values per thread;
// *total receives the sums over the block. `scratch` holds T / 32 + 1
// uint3. Every thread of the block must call it.
template <int T>
__device__ uint3 block_scan3(uint3 v, uint3* scratch, uint3* total) {
  constexpr int kWarps = T / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint3 in = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t x = __shfl_up_sync(0xffffffffu, in.x, d);
    const uint32_t y = __shfl_up_sync(0xffffffffu, in.y, d);
    const uint32_t z = __shfl_up_sync(0xffffffffu, in.z, d);
    if (lane >= d) in = make_uint3(in.x + x, in.y + y, in.z + z);
  }
  if (lane == 31) scratch[warp] = in;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint3 run = make_uint3(0u, 0u, 0u);
    for (int w = 0; w < kWarps; ++w) {
      const uint3 c = scratch[w];
      scratch[w] = run;
      run = make_uint3(run.x + c.x, run.y + c.y, run.z + c.z);
    }
    scratch[kWarps] = run;
  }
  __syncthreads();
  const uint3 base = scratch[warp];
  *total = scratch[kWarps];
  __syncthreads();  // scratch may be reused at once
  return make_uint3(base.x + in.x - v.x, base.y + in.y - v.y, base.z + in.z - v.z);
}

// Sorts a[0, n) ascending (a stable LSD radix sort, four passes of 8-bit
// digits through t[0, n)); the result ends in a. a and t may lie in shared
// or device memory. Every thread of the block must call it.
template <int T>
__device__ void radix_sort(uint32_t* a, uint32_t* t, int n, int* hist, uint16_t* wc,
                           int* scratch) {
  constexpr int kWarps = T / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int shift = 0; shift < 32; shift += 8) {
    for (int d = threadIdx.x; d < 256; d += T) hist[d] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += T) atomicAdd(&hist[(a[i] >> shift) & 0xFFu], 1);
    __syncthreads();
    int total;
    const int ex = block_scan<T>(threadIdx.x < 256 ? hist[threadIdx.x] : 0, scratch, &total);
    if (threadIdx.x < 256) hist[threadIdx.x] = ex;  // first slot of each digit
    __syncthreads();
    for (int t0 = 0; t0 < n; t0 += T) {
      const int i = t0 + threadIdx.x;
      const bool ok = i < n;
      const uint32_t key = ok ? a[i] : 0u;
      const int d = ok ? static_cast<int>((key >> shift) & 0xFFu) : 256;
      for (int k = threadIdx.x; k < kWarps * 256; k += T) wc[k] = 0;
      __syncthreads();
      // the lanes of this warp with the same digit, and this lane's place
      // among them
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (ok && (peers & lt) == 0u) wc[warp * 256 + d] = static_cast<uint16_t>(__popc(peers));
      __syncthreads();
      if (threadIdx.x < 256) {  // warps in order within each digit
        int run = hist[threadIdx.x];
        for (int w = 0; w < kWarps; ++w) {
          const int c = wc[w * 256 + threadIdx.x];
          wc[w * 256 + threadIdx.x] = static_cast<uint16_t>(run);
          run += c;
        }
        hist[threadIdx.x] = run;
      }
      __syncthreads();
      if (ok) t[wc[warp * 256 + d] + __popc(peers & lt)] = key;
      __syncthreads();
    }
    uint32_t* s = a;
    a = t;
    t = s;
  }
}

template <int T>
__global__ void __launch_bounds__(T)
bytes_score_kernel(const uint8_t* __restrict__ x, int C, int S, const uint32_t* __restrict__ lut,
                   const uint32_t* __restrict__ keys, const uint32_t* __restrict__ kdir,
                   const float* __restrict__ credit,
                   int ls, int gcap, uint32_t P1, uint32_t P2, uint32_t HP, int ngram,
                   float* __restrict__ full_w, float* __restrict__ phrase,
                   int32_t* __restrict__ n_uniq, uint32_t* __restrict__ scratch_rows) {
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / S;
  const int Cs = slice_len(C, S), Wc = word_cap(Cs), Kc = bucket_cap(Cs, S), KT = row_keys(C);
  const int top = S == 1 ? 32 : 32 - (31 - __clz(S));  // bucket of k: k >> top
  const Layout<T> L(C, S);
  extern __shared__ uint4 smem[];
  uint8_t* sb = reinterpret_cast<uint8_t*>(smem);
  Ctl* ctl = reinterpret_cast<Ctl*>(sb);
  uint8_t* lut8 = sb + L.lut;
  int* scan = reinterpret_cast<int*>(sb + L.scan);
  uint3* scan3 = reinterpret_cast<uint3*>(sb + L.scan);
  int* hist = reinterpret_cast<int*>(sb + L.hist);
  uint16_t* wc = reinterpret_cast<uint16_t*>(sb + L.wc);
  uint8_t* v = sb + L.a;
  uint16_t* starts = reinterpret_cast<uint16_t*>(sb + L.a + align16(Cs));
  uint32_t* bucket = reinterpret_cast<uint32_t*>(sb + L.a);
  uint32_t* H = reinterpret_cast<uint32_t*>(sb + L.b);  // word sums of v, then word hashes
  uint32_t* A1 = H + Wc;  // word sums of k v[k]
  uint32_t* own = A1;     // then the slice's gram keys
  uint32_t* temp = reinterpret_cast<uint32_t*>(sb + L.b);
  uint32_t* far = scratch_rows + row * 2 * KT;  // the row's device scratch

  const uint8_t* src = x + row * C;
  const int lo = min(r * Cs, C);
  const int n = min(lo + Cs, C) - lo;

  // 1. the LUT, then the slice's LUT image
  for (int k = threadIdx.x; k < 256; k += T) lut8[k] = static_cast<uint8_t>(lut[k]);
  if (threadIdx.x < kMaxCluster) ctl->cnt[threadIdx.x] = ctl->slot[threadIdx.x] = 0;
  for (int j = threadIdx.x; j < Wc; j += T) H[j] = A1[j] = 0u;
  __syncthreads();
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src + lo) & 15) == 0) {
    done = n & ~15;
    for (int i = threadIdx.x; i < n / 16; i += T) {
      const uint4 w = reinterpret_cast<const uint4*>(src + lo)[i];
      uint32_t o[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t u = o[q];
        o[q] = lut8[u & 0xFFu] | lut8[(u >> 8) & 0xFFu] << 8 | lut8[(u >> 16) & 0xFFu] << 16 |
               static_cast<uint32_t>(lut8[u >> 24]) << 24;
      }
      reinterpret_cast<uint4*>(v)[i] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  for (int i = done + threadIdx.x; i < n; i += T) v[i] = lut8[src[lo + i]];
  const uint32_t prev0 = lo > 0 ? lut8[src[lo - 1]] : 0u;
  __syncthreads();

  // 2. each thread's stretch of the slice (whole 4-byte words): its word
  //    starts and the sums of v[k] and k v[k] (k the position in the row),
  //    scanned across the block
  const int per = ((n + 3) / 4 + T - 1) / T * 4;
  const int k0 = min(static_cast<int>(threadIdx.x) * per, n);
  const int k1 = min(k0 + per, n);
  const uint32_t before = k0 == 0 ? prev0 : v[k0 - 1];
  uint3 mine = make_uint3(0u, 0u, 0u);
  uint32_t prev = before;
  for (int q = k0; q < k1; q += 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(v + q);
#pragma unroll
    for (int e = 0; e < 4 && q + e < k1; ++e) {
      const uint32_t b = (w >> (8 * e)) & 0xFFu;
      mine.x += b != 0u && prev == 0u;
      mine.y += b;
      mine.z += b * static_cast<uint32_t>(lo + q + e);
      prev = b;
    }
  }
  uint3 tot;
  const uint3 ex = block_scan3<T>(mine, scan3, &tot);
  const int nw = static_cast<int>(tot.x);
  if (threadIdx.x == 0) {
    ctl->nwords = nw;
    ctl->sum0 = tot.y;
    ctl->sum1 = tot.z;
  }
  cluster.sync();

  // the first word and the prefix sums of each block's slice
  if (threadIdx.x <= S) {
    int w = 0;
    uint32_t p0 = 0u, p1 = 0u;
    for (int q = 0; q < static_cast<int>(threadIdx.x); ++q) {
      w += *cluster.map_shared_rank(&ctl->nwords, q);
      p0 += *cluster.map_shared_rank(&ctl->sum0, q);
      p1 += *cluster.map_shared_rank(&ctl->sum1, q);
    }
    ctl->base[threadIdx.x] = w;
    ctl->pre0[threadIdx.x] = p0;
    ctl->pre1[threadIdx.x] = p1;
  }
  __syncthreads();

  // 3. word sums as differences of the row's prefix sums: a word's start
  //    subtracts the prefixes before it, its last byte adds the prefixes
  //    through it (atomics: the two may lie in other threads, and the last
  //    byte in a later block, which adds into the owner's shared memory).
  //    No thread walks a word, however long.
  {
    uint32_t P0 = ctl->pre0[r] + ex.y, P1s = ctl->pre1[r] + ex.z;
    int j = static_cast<int>(ex.x) - 1;
    const uint32_t after = lo + n < C ? lut8[src[lo + n]] : 0u;  // the byte past the slice
    prev = before;
    for (int q = k0; q < k1; q += 4) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(v + q);
#pragma unroll
      for (int e = 0; e < 4 && q + e < k1; ++e) {
        const int k = q + e;
        const uint32_t b = (w >> (8 * e)) & 0xFFu;
        if (b != 0u && prev == 0u) {
          starts[++j] = static_cast<uint16_t>(k);
          atomicAdd(&H[j], 0u - P0);
          atomicAdd(&A1[j], 0u - P1s);
        }
        P0 += b;
        P1s += b * static_cast<uint32_t>(lo + k);
        const uint32_t next =
            k + 1 >= n ? after : (e < 3 ? (w >> (8 * e + 8)) & 0xFFu : v[k + 1]);
        if (b != 0u && next == 0u) {  // the last byte of a word
          uint32_t *h0 = H + j, *h1 = A1 + j;
          if (j < 0) {  // a word of an earlier block
            const int g = ctl->base[r] - 1;
            int o = r - 1;
            while (ctl->base[o] > g) --o;
            h0 = cluster.map_shared_rank(H, o) + (g - ctl->base[o]);
            h1 = cluster.map_shared_rank(A1, o) + (g - ctl->base[o]);
          }
          atomicAdd(h0, P0);
          atomicAdd(h1, P1s);
        }
        prev = b;
      }
    }
  }
  cluster.sync();
  for (int j = threadIdx.x; j < nw; j += T) {
    const uint32_t s0 = H[j];
    const uint32_t s1 = A1[j] - static_cast<uint32_t>(lo + starts[j]) * s0;
    H[j] = s0 * P1 + s1 * P2;
  }
  cluster.sync();

  // 4. the gram keys of the slice's words, counted per bucket
  const int first = ctl->base[r];
  const int nk = max(0, min(nw, ctl->base[S] - ngram + 1 - first));
  for (int j = threadIdx.x; j < nk; j += T) {
    uint32_t k = H[j];
    for (int t = 1; t < ngram; ++t) {
      uint32_t h;
      if (j + t < nw) {
        h = H[j + t];
      } else {  // a word of a later block
        const int g = first + j + t;
        int q = r + 1;
        while (g >= ctl->base[q + 1]) ++q;
        h = cluster.map_shared_rank(H, q)[g - ctl->base[q]];
      }
      k = k * HP + h;
    }
    k = min(k, kSent - 1u);
    own[j] = k;
    atomicAdd(&ctl->cnt[top == 32 ? 0 : k >> top], 1);
  }
  cluster.sync();

  // 5. bucket sizes and places; each key into its bucket
  if (threadIdx.x < S) {
    int tot = 0, mine = 0;
    for (int p = 0; p < S; ++p) {
      const int c = *cluster.map_shared_rank(&ctl->cnt[threadIdx.x], p);
      if (p < r) mine += c;
      tot += c;
    }
    ctl->ntot[threadIdx.x] = tot;
    ctl->myoff[threadIdx.x] = mine;
  }
  __syncthreads();
  if (threadIdx.x < S) {
    int g = 0;
    for (int q = 0; q < static_cast<int>(threadIdx.x); ++q) g += ctl->ntot[q];
    ctl->goff[threadIdx.x] = g;
    ctl->dest[threadIdx.x] =
        ctl->ntot[threadIdx.x] > Kc ? far + g : cluster.map_shared_rank(bucket, threadIdx.x);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nk; j += T) {
    const uint32_t k = own[j];
    const int q = top == 32 ? 0 : static_cast<int>(k >> top);
    ctl->dest[q][ctl->myoff[q] + atomicAdd(&ctl->slot[q], 1)] = k;
  }
  cluster.sync();

  // 6. sort this block's bucket
  const int m = ctl->ntot[r];
  const bool spilled = m > Kc;
  uint32_t* a = spilled ? far + ctl->goff[r] : bucket;
  uint32_t* t2 = spilled ? a + KT : temp;
  radix_sort<T>(a, t2, m, hist, wc, scan);

  // 7. distinct ranks within the bucket, then across the cluster
  const int mper = (m + T - 1) / T;
  const int i0 = min(static_cast<int>(threadIdx.x) * mper, m);
  const int i1 = min(i0 + mper, m);
  int fresh = 0;
  for (int i = i0; i < i1; ++i) fresh += i == 0 || a[i] != a[i - 1];
  int u;
  int rank = block_scan<T>(fresh, scan, &u);
  if (threadIdx.x == 0) ctl->nuniq = u;
  cluster.sync();
  if (threadIdx.x == 0) {
    int ub = 0, ut = 0;
    for (int q = 0; q < S; ++q) {
      const int uq = *cluster.map_shared_rank(&ctl->nuniq, q);
      if (q < r) ub += uq;
      ut += uq;
    }
    ctl->ubase = ub;
    ctl->utot = ut;
  }
  __syncthreads();

  // 8. the credited keys (global rank below gcap) find their corpus row;
  //    the found ones are compacted in rank order over the sorted keys
  const int lim = min(u, max(0, gcap - ctl->ubase));
  int32_t* found = reinterpret_cast<int32_t*>(t2);  // per credited rank
  for (int i = i0; i < i1 && rank < lim; ++i) {
    if (i == 0 || a[i] != a[i - 1]) found[rank++] = find_dir(keys, kdir, a[i]);
  }
  __syncthreads();
  const int fper = (lim + T - 1) / T;
  const int f0 = min(static_cast<int>(threadIdx.x) * fper, lim);
  const int f1 = min(f0 + fper, lim);
  int hits = 0;
  for (int k = f0; k < f1; ++k) hits += found[k] >= 0;
  int nh;
  int at = block_scan<T>(hits, scan, &nh);
  int32_t* list = reinterpret_cast<int32_t*>(a);
  for (int k = f0; k < f1; ++k) {
    if (found[k] >= 0) list[at++] = found[k];
  }
  if (threadIdx.x == 0) ctl->nhits = nh;
  cluster.sync();

  // 9. the credit columns, split across the cluster's blocks: one thread
  //    per column walks the lists of blocks 0 .. S-1 in order, loading
  //    kAhead credit values, and the positions of the next kAhead, ahead
  //    of the ordered adds
  {
    const int L2 = 2 * ls;
    for (int c = r * L2 / S + static_cast<int>(threadIdx.x); c < (r + 1) * L2 / S; c += T) {
      float acc = 0.0f;
      for (int q = 0; q < S; ++q) {
        const int len = *cluster.map_shared_rank(&ctl->nhits, q);
        const uint32_t* at_q = ctl->ntot[q] > Kc ? far + ctl->goff[q]
                                                  : cluster.map_shared_rank(bucket, q);
        const int32_t* lq = reinterpret_cast<const int32_t*>(at_q);
        int p[kAhead];
        int i = 0;
        if (len >= kAhead) {
#pragma unroll
          for (int e = 0; e < kAhead; ++e) p[e] = lq[e];
        }
        for (; i + kAhead <= len; i += kAhead) {
          float w[kAhead];
#pragma unroll
          for (int e = 0; e < kAhead; ++e) {
            w[e] = __ldg(credit + static_cast<long long>(p[e]) * L2 + c);
          }
          if (i + 2 * kAhead <= len) {
#pragma unroll
            for (int e = 0; e < kAhead; ++e) p[e] = lq[i + kAhead + e];
          }
#pragma unroll
          for (int e = 0; e < kAhead; ++e) acc += w[e];
        }
        for (; i < len; ++i) acc += __ldg(credit + static_cast<long long>(lq[i]) * L2 + c);
      }
      if (c < ls) full_w[row * ls + c] = acc;
      else phrase[row * ls + c - ls] = acc;
    }
    if (r == 0 && threadIdx.x == 0) n_uniq[row] = ctl->utot;
  }
  cluster.sync();  // every block has read every block's list
}

template <int T>
cudaLaunchConfig_t config(int blocks, int C, int S, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = Layout<T>(C, S).bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Raises the kernel's dynamic shared memory limit to at least `smem`. The
// limit only grows: a launch fails when it needs more than the limit, even
// below the 48 KB default, so a lower setting would break larger shapes. A
// refusal (more than a block may have) is returned and cleared, so that it
// does not resurface as a later launch's cudaGetLastError().
template <int T>
cudaError_t allow_smem(int smem) {
  static std::mutex lock;
  static int allowed = 0;
  const std::lock_guard<std::mutex> guard(lock);
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      bytes_score_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed = smem;
  else cudaGetLastError();
  return err;
}

template <int T>
int plan_t(int C, int S, int* out) {
  const int smem = Layout<T>(C, S).bytes;
  cudaError_t err = allow_smem<T>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T>(S, C, S, nullptr, &attr);
  int clusters = 0, blocks = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, bytes_score_kernel<T>, &cfg);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bytes_score_kernel<T>, T, smem);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // returned here, not to a later launch
    return static_cast<int>(err);
  }
  out[0] = T;
  out[1] = smem;
  out[2] = clusters;
  out[3] = blocks;
  return 0;
}

template <int T>
int launch_t(const uint8_t* x, int B, int C, int S, const uint32_t* lut, const uint32_t* keys,
             const uint32_t* kdir, const float* credit, int ls, int gcap, uint32_t P1,
             uint32_t P2, uint32_t HP, int ngram, float* full_w, float* phrase, int32_t* n_uniq,
             uint32_t* scratch, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T>(B * S, C, S, stream, &attr);
  cudaError_t err = allow_smem<T>(static_cast<int>(cfg.dynamicSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, bytes_score_kernel<T>, x, C, S, lut, keys, kdir, credit, ls,
                           gcap, P1, P2, HP, ngram, full_w, phrase, n_uniq, scratch);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error too
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// The launch shape for rows of C bytes in clusters of S blocks: writes
// out[0] threads per block, out[1] dynamic shared memory per block (bytes),
// out[2] clusters that can be active at once on the device
// (cudaOccupancyMaxActiveClusters; 0 when such a cluster cannot be
// scheduled), out[3] blocks per SM. Raises the kernel's shared memory
// limit (a shape that needs more than a block may have returns its error).
// Returns the first CUDA error, or 0.
int trivy_bytes_score_plan(int C, int S, int* out) {
  return threads_for(C, S) == 256 ? plan_t<256>(C, S, out) : plan_t<512>(C, S, out);
}

// Launches the scorer on `stream` (PyTorch's current stream) in clusters of
// S blocks (1, 2, 4 or 8) per row, after trivy_bytes_score_plan(C, S):
// x [B, C] uint8 (C <= 65536), lut [256] (values below 256), keys [Ku]
// sorted uint32 with kdir [2^12 + 1] uint32 its directory by top 12 bits
// (ops/gram_gate.py::key_directory), credit [Ku, 2 * ls] f32, scratch [B, 2 * (C / 2 + 1)]
// uint32 (device scratch for buckets that overflow shared memory), all on
// the current device; writes full_w [B, ls], phrase [B, ls] and
// n_uniq [B]. Returns the first CUDA error (of the launch, or
// cudaGetLastError() after it), or 0.
int trivy_bytes_score_launch(const uint8_t* x, int B, int C, int S, const uint32_t* lut,
                             const uint32_t* keys, const uint32_t* kdir, const float* credit,
                             int ls, int gcap,
                             uint32_t P1, uint32_t P2, uint32_t HP, int ngram, float* full_w,
                             float* phrase, int32_t* n_uniq, uint32_t* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return threads_for(C, S) == 256
             ? launch_t<256>(x, B, C, S, lut, keys, kdir, credit, ls, gcap, P1, P2, HP, ngram,
                             full_w, phrase, n_uniq, scratch, s)
             : launch_t<512>(x, B, C, S, lut, keys, kdir, credit, ls, gcap, P1, P2, HP, ngram,
                             full_w, phrase, n_uniq, scratch, s);
}

const char* trivy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
