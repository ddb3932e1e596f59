// Version-constraint check for Hopper (sm_90a): lane groups with 16-byte
// loads, many rows in flight per warp, verdicts stored as whole words.
//
// Replaces trivy_tpu/ops/verscmp.py:37 _check_ops_gather (an XLA device
// computation, jitted at :65), and through the null-index entry also _lexcmp
// (:22) and _check_ops (:30). The plain PyTorch version of the same function
// is trivy_tpu_torch/ops/verscmp.py::check_ops_gather_plain. For every row r:
//   a = inst[a_idx[r]] and b = bounds[b_idx[r]], rows of L int32;
//   s = the sign of a[j] - b[j] at the first j where they differ, else 0;
//   verdict[r] = (s<0, s<=0, s>0, s>=0, s==0, s!=0)[ops[r]] as 0 or 1.
// A null a_idx (b_idx) means row r of inst (bounds) itself; a null ops
// writes no verdict, a null sign no sign. Indices are clamped into their
// matrix and ops into 0..5 (the callers give them in range).
// The encodings are non-negative int32 (trivy_tpu_torch/version/encode.py),
// so comparing a[j] with b[j] directly equals the reference's sign(a - b).
//
// What bounds it on an H100. Bytes: the R rows of indices and ops (12 bytes
// each) and verdicts (1 byte), and each distinct inst and bound row the
// gather reaches (4 L bytes), once each at 3.35 TB/s. For one SBOM's
// dispatch, [536800, 16] with 1,867 inst rows: 2.1 us when the advisories
// share 500 bound rows, 6.2 us when every advisory has its own two (212,000
// rows, 13.6 MB, which a cold L2 serves from device memory). The rows are
// gathered, so what a kernel has to hide is latency: each row is a chain of
// two dependent reads (its indices, then its two rows). One warp per row
// kept about 64 rows in flight on an SM and paid that chain some 64 times a
// dispatch. The design:
//
// 1. A lane group of G lanes per row, G the smallest power of two >=
//    ceil(L / 4), at most kMaxGroup = 8: each lane loads one int4 (4
//    columns) of each side, so at L = 16 a row is 4 lanes and a warp holds
//    8 rows. Rows wider than 32 columns walk 32-column chunks in order, the
//    warp's rows together, until none is still equal: versions mostly
//    differ early, and groups of up to 32 lanes (128 columns at once) read
//    whole rows for nothing (on an H100, 1.8 times slower on 72-column rows;
//    tools/kernel_study.py verscmp, variant g32). Rows that are not 16-byte
//    aligned (L % 4 != 0, or a matrix off 16 bytes) take the same walk with
//    scalar loads.
// 2. Each lane finds the first of its 4 columns that differs; the group's
//    segment of __ballot_sync and __ffs give the first such lane, and
//    __shfl_sync(width G) its sign.
// 3. Many rows in flight: a persistent grid (the blocks that fit at once,
//    registers bounded for kBlocksPerSM of them an SM) walks steps of rows;
//    in a step a warp takes 32 / G * U contiguous rows, each group U = 4
//    consecutive ones. It loads all their indices and ops (a 16-byte load
//    each), then issues all 2 U row loads, and only then compares, so the
//    chain is paid once per step for all of them.
// 4. The verdicts and signs of a step come out of ballots (bit G * g of
//    ballot u is group g's row u): lane i packs the verdicts of the step's
//    rows 4i..4i+3 into one 32-bit store and stores its rows' int32 signs.
//    A ragged tail or an output pointer off 4 bytes stores bytes.
// Nothing is staged in shared memory: the repeated-bound DB's bound (32 KB)
// and inst (120 KB) matrices stay in L1, and a copy of the bound matrix in
// each block was slower (variant shared).

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSM = 4;  // at least: 64 registers a thread at most
constexpr int kRowsPerGroup = 4;  // U: consecutive rows a lane group takes per step
constexpr int kMaxGroup = 8;  // lanes a row's group has at most: chunks of 32 columns
constexpr unsigned kAll = 0xffffffffu;

// Columns col..col+3 of a row: one 16-byte load, or four scalar loads;
// columns past L read as 0 on both sides, so they never differ.
template <bool kVec>
__device__ __forceinline__ int4 load_cols(const int32_t* row, int col, int L) {
  if (kVec) {
    return col < L ? __ldg(reinterpret_cast<const int4*>(row + col)) : make_int4(0, 0, 0, 0);
  }
  int4 v;
  v.x = col < L ? __ldg(row + col) : 0;
  v.y = col + 1 < L ? __ldg(row + col + 1) : 0;
  v.z = col + 2 < L ? __ldg(row + col + 2) : 0;
  v.w = col + 3 < L ? __ldg(row + col + 3) : 0;
  return v;
}

// The sign of the first of a lane's four columns where a and b differ, or 0.
__device__ __forceinline__ int lane_sign(const int4& a, const int4& b) {
  if (a.x != b.x) return a.x < b.x ? -1 : 1;
  if (a.y != b.y) return a.y < b.y ? -1 : 1;
  if (a.z != b.z) return a.z < b.z ? -1 : 1;
  if (a.w != b.w) return a.w < b.w ? -1 : 1;
  return 0;
}

// The sign of the group's row: that of the group's first lane whose
// columns differ, or 0. The whole warp calls it.
template <int G>
__device__ __forceinline__ int group_sign(int ls, int lane) {
  constexpr unsigned kSegment = G == 32 ? kAll : (1u << (G % 32)) - 1;
  const unsigned seg = (__ballot_sync(kAll, ls != 0) >> (lane & ~(G - 1))) & kSegment;
  const int first = __shfl_sync(kAll, ls, seg ? __ffs(seg) - 1 : 0, G);
  return seg ? first : 0;
}

__device__ __forceinline__ bool verdict_of(int s, int op) {
  switch (op) {
    case 0: return s < 0;
    case 1: return s <= 0;
    case 2: return s > 0;
    case 3: return s >= 0;
    case 4: return s == 0;
    default: return s != 0;
  }
}

// Words r0..r0+U-1 of an index or op row (null: r itself; past R: 0), as
// one 16-byte load when U == 4 and they are all there and aligned.
template <int U>
__device__ __forceinline__ void load_words(const int32_t* p, long long r0, int R, int (&w)[U]) {
  if (p == nullptr) {
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = static_cast<int>(r0 + u);
    return;
  }
  if (U == 4 && r0 + 4 <= R && ((reinterpret_cast<uintptr_t>(p + r0) & 15) == 0)) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p + r0));
    w[0] = v.x;
    w[U > 1 ? 1 : 0] = v.y;
    w[U > 2 ? 2 : 0] = v.z;
    w[U > 3 ? 3 : 0] = v.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) w[u] = r0 + u < R ? __ldg(p + r0 + u) : 0;
}

// The indices and op of rows r0..r0+U-1, clamped; -1 for a row past R.
template <int U>
__device__ __forceinline__ void fetch_index(const int32_t* a_idx, const int32_t* b_idx,
                                            const int32_t* ops, long long r0, int R, int n_inst,
                                            int n_bounds, int (&ai)[U], int (&bi)[U],
                                            int (&op)[U]) {
  load_words<U>(a_idx, r0, R, ai);
  load_words<U>(b_idx, r0, R, bi);
  load_words<U>(ops, r0, R, op);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool live = r0 + u < R;
    ai[u] = live ? min(max(ai[u], 0), n_inst - 1) : -1;
    bi[u] = live ? min(max(bi[u], 0), n_bounds - 1) : -1;
    op[u] = min(max(op[u], 0), 5);
  }
}

// The lane's columns of the first chunk of each of the U rows, all issued
// before any is used.
template <int U, bool kVec>
__device__ __forceinline__ void fetch_rows(const int32_t* inst, const int32_t* bounds, int L,
                                           int col, const int (&ai)[U], const int (&bi)[U],
                                           int4 (&ra)[U], int4 (&rb)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    ra[u] = rb[u] = make_int4(0, 0, 0, 0);
    if (ai[u] >= 0) {
      ra[u] = load_cols<kVec>(inst + static_cast<size_t>(ai[u]) * L, col, L);
      rb[u] = load_cols<kVec>(bounds + static_cast<size_t>(bi[u]) * L, col, L);
    }
  }
}

// The sign of each row: the first chunk's; then, for rows wider than a
// chunk (G == kMaxGroup), the later chunks of the rows still equal, loaded
// into ra and rb together, in order, until no row of the warp needs one.
// Every lane takes part in each ballot; the loops over u unroll, so the
// arrays stay in registers.
template <int G, int U, bool kVec>
__device__ __forceinline__ void compare_rows(const int32_t* inst, const int32_t* bounds, int L,
                                             int col, int lane, const int (&ai)[U],
                                             const int (&bi)[U], int4 (&ra)[U], int4 (&rb)[U],
                                             int (&s)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) s[u] = group_sign<G>(lane_sign(ra[u], rb[u]), lane);
  if (G < kMaxGroup) return;  // L <= 4 G: one chunk
  for (int c = 4 * G; c < L; c += 4 * G) {
    bool open = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ra[u] = rb[u] = make_int4(0, 0, 0, 0);
      if (s[u] == 0 && ai[u] >= 0) {
        open = true;
        ra[u] = load_cols<kVec>(inst + static_cast<size_t>(ai[u]) * L, c + col, L);
        rb[u] = load_cols<kVec>(bounds + static_cast<size_t>(bi[u]) * L, c + col, L);
      }
    }
    if (!__any_sync(kAll, open)) break;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = group_sign<G>(lane_sign(ra[u], rb[u]), lane);
      s[u] = s[u] != 0 ? s[u] : t;
    }
  }
}

// Bit k of the step's rows in ballots m (one per u): row k is group k / U's
// row k % U, the bit at lane G * (k / U).
template <int G, int U>
__device__ __forceinline__ unsigned row_bit(const unsigned (&m)[U], int k) {
  unsigned word = m[0];
#pragma unroll
  for (int u = 1; u < U; ++u) word = k % U == u ? m[u] : word;
  return (word >> (G * (k / U))) & 1u;
}

// The verdicts (and signs) of the warp's step rows w0..: packed from
// ballots, four verdicts to a 32-bit store.
template <int G, int U>
__device__ __forceinline__ void store_rows(uint8_t* verdict, int32_t* sign, long long w0, int R,
                                           int lane, const int (&op)[U], const int (&s)[U]) {
  constexpr int kWarpRows = 32 / G * U;
  if (verdict) {
    unsigned v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = __ballot_sync(kAll, verdict_of(s[u], op[u]));
    const int k0 = 4 * lane;
    const long long r = w0 + k0;
    if (k0 < kWarpRows && r < R) {
      if (kWarpRows % 4 == 0 && r + 4 <= R &&
          (reinterpret_cast<uintptr_t>(verdict + r) & 3) == 0) {
        // U == 4: rows k0..k0+3 are group lane's rows 0..3, bit G * lane
        const int at = G * (k0 / U);
        *reinterpret_cast<uint32_t*>(verdict + r) =
            U == 4 ? (v[0] >> at & 1u) | (v[U > 1 ? 1 : 0] >> at & 1u) << 8 |
                         (v[U > 2 ? 2 : 0] >> at & 1u) << 16 | (v[U > 3 ? 3 : 0] >> at & 1u) << 24
                   : row_bit<G, U>(v, k0) | row_bit<G, U>(v, k0 + 1) << 8 |
                         row_bit<G, U>(v, k0 + 2) << 16 | row_bit<G, U>(v, k0 + 3) << 24;
      } else {
        for (int j = 0; j < 4 && k0 + j < kWarpRows && r + j < R; ++j) {
          verdict[r + j] = static_cast<uint8_t>(row_bit<G, U>(v, k0 + j));
        }
      }
    }
  }
  if (sign) {
    unsigned neg[U], pos[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      neg[u] = __ballot_sync(kAll, s[u] < 0);
      pos[u] = __ballot_sync(kAll, s[u] > 0);
    }
    for (int k = lane; k < kWarpRows && w0 + k < R; k += 32) {
      sign[w0 + k] = row_bit<G, U>(pos, k) ? 1 : (row_bit<G, U>(neg, k) ? -1 : 0);
    }
  }
}

template <int G, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
verscmp_kernel(const int32_t* __restrict__ inst, int n_inst,
               const int32_t* __restrict__ bounds, int n_bounds, int L,
               const int32_t* __restrict__ a_idx, const int32_t* __restrict__ b_idx,
               const int32_t* __restrict__ ops, int R,
               uint8_t* __restrict__ verdict, int32_t* __restrict__ sign) {
  constexpr int U = kRowsPerGroup;
  constexpr int kWarpRows = 32 / G * U;
  constexpr int kBlockRows = kWarps * kWarpRows;
  const int lane = threadIdx.x & 31;
  const int col = 4 * (lane % G);  // the lane's first column in each chunk
  const long long steps = (static_cast<long long>(R) + kBlockRows - 1) / kBlockRows;
  for (long long step = blockIdx.x; step < steps; step += gridDim.x) {
    const long long w0 = step * kBlockRows + (threadIdx.x >> 5) * kWarpRows;
    int ai[U], bi[U], op[U];
    fetch_index<U>(a_idx, b_idx, ops, w0 + lane / G * U, R, n_inst, n_bounds, ai, bi, op);
    int4 ra[U], rb[U];
    fetch_rows<U, kVec>(inst, bounds, L, col, ai, bi, ra, rb);
    int s[U];
    compare_rows<G, U, kVec>(inst, bounds, L, col, lane, ai, bi, ra, rb, s);
    store_rows<G, U>(verdict, sign, w0, R, lane, op, s);
  }
}

// The lanes of a row's group at width L: the smallest power of two that
// holds ceil(L / 4) lanes, at most kMaxGroup.
int group_lanes(int L) {
  int g = 1;
  while (g < kMaxGroup && 4 * g < L) g <<= 1;
  return g;
}

bool vector_path(const void* inst, const void* bounds, int L) {
  return L % 4 == 0 && (reinterpret_cast<uintptr_t>(inst) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(bounds) & 15) == 0;
}

// Calls f(G, kVec) with both as compile-time constants
// (std::integral_constant), for the kernel of lane groups of G lanes
// (group_lanes: 1, 2, 4 or kMaxGroup) and of the vector (kVec) or scalar
// path.
template <bool kVec, class F>
int with_group(int G, F&& f) {
  using kv = std::integral_constant<bool, kVec>;
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>{}, kv{});
    case 2: return f(std::integral_constant<int, 2>{}, kv{});
    case 4: return f(std::integral_constant<int, 4>{}, kv{});
    default: return f(std::integral_constant<int, kMaxGroup>{}, kv{});
  }
}

template <class F>
int with_kernel(int L, const void* inst, const void* bounds, F&& f) {
  return vector_path(inst, bounds, L) ? with_group<true>(group_lanes(L), f)
                                      : with_group<false>(group_lanes(L), f);
}

// The persistent grid: the blocks that fit on the card at once, no more
// than the steps.
template <int G, bool kVec>
cudaError_t grid_for(int R, size_t smem, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, verscmp_kernel<G, kVec>,
                                                        kThreads, smem);
  }
  const long long block_rows = kWarps * (32 / G) * kRowsPerGroup;
  const long long steps = (static_cast<long long>(R) + block_rows - 1) / block_rows;
  const long long fit = 1LL * per_sm * sms;
  *grid = static_cast<int>(steps < fit ? steps : fit);
  return err;
}

}  // namespace

extern "C" {

// The launch's plan for R rows of width L over matrices at inst and bounds:
// out = [G (lanes per row), U (rows a group takes per step), 1 for the
// vector path or 0 for the scalar one, blocks in the grid]. Returns a CUDA
// error, or 0.
int trivy_verscmp_plan(int L, int R, const void* inst, const void* bounds, int* out) {
  return with_kernel(L, inst, bounds, [&](auto g, auto vec) {
    out[0] = decltype(g)::value;
    out[1] = kRowsPerGroup;
    out[2] = decltype(vec)::value ? 1 : 0;
    return static_cast<int>(grid_for<decltype(g)::value, decltype(vec)::value>(R, 0, &out[3]));
  });
}

// Launches the check on `stream` (PyTorch's current stream) over R rows:
// inst [n_inst, L] and bounds [n_bounds, L] int32 (n_inst, n_bounds, L >= 1),
// a_idx/b_idx/ops [R] int32 or null, verdict [R] uint8 or null, sign [R]
// int32 or null, all on the current device. The vector path needs L % 4 ==
// 0 and both matrices 16-byte aligned; otherwise the scalar path runs.
// Returns the first CUDA error (cudaGetLastError() after the launch), or 0.
int trivy_verscmp_launch(const int32_t* inst, int n_inst, const int32_t* bounds, int n_bounds,
                         int L, const int32_t* a_idx, const int32_t* b_idx,
                         const int32_t* ops, int R, uint8_t* verdict, int32_t* sign,
                         void* stream) {
  if (R <= 0) return 0;
  return with_kernel(L, inst, bounds, [&](auto g, auto vec) {
    constexpr int G = decltype(g)::value;
    constexpr bool kVec = decltype(vec)::value;
    const size_t smem = 0;  // dynamic shared memory: none, the rows come through L1 and L2
    int grid = 0;
    cudaError_t err = grid_for<G, kVec>(R, smem, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    verscmp_kernel<G, kVec><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        inst, n_inst, bounds, n_bounds, L, a_idx, b_idx, ops, R, verdict, sign);
    return static_cast<int>(cudaGetLastError());
  });
}

const char* trivy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
