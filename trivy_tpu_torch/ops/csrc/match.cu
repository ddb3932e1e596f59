// Secret matcher for Hopper (sm_90a): a bucket-mask literal screen over rows
// staged in shared memory, then an exact verify of the candidates.
//
// Replaces the Pallas TPU kernel trivy_tpu/ops/match_pallas.py:109
// build_match_fn_pallas. For every row b of chunks [B, C] uint8 and every
// rule r it sets out[b, r] = 1 when some position p in [0, C) starts a hit:
//   - an anchored variant: the anchor literal at p (case-sensitive); each
//     check window [p+delta, p+delta+count) inside its byte class; and, with
//     the boundary flag, a non-alphanumeric byte at p-pre_len-1;
//   - a keyword: the A-Z-folded row equals the (lowered) keyword at p.
// Bytes outside [0, C) read as 0, the exact meaning of the zero-padded planes
// of the JAX kernels, so negated classes hold at the row edges and the
// boundary test passes at offset 0. The plain PyTorch version of the same
// function is trivy_tpu_torch/ops/match.py::match_plain; the tables are
// packed by trivy_tpu_torch/ops/match_cuda.py::pack_tables.
//
// What bounds it on an H100. The function must read the B*C row bytes once
// and write B*R flags: (B*C + B*R) / 3.35 TB/s, 5.0 us for the scanner's
// 1024 x 16384 batch. The kernel does not reach that: each position costs
// kScreen table lookups in shared memory (2 x 32-bit each), so the shared
// memory pipe (32 banks x 4 bytes a cycle per SM) bounds the screen near
// 4 positions a cycle per SM. The design, point by point:
//
// 1. Rows staged in shared memory. The grid is persistent (as many blocks
//    as fit on the card); block i takes an equal slice of the B*C positions
//    and walks it in segments of at most `seg` positions that never cross a
//    row. Each segment is copied into shared memory with its `halo` bytes
//    on either side, 16 bytes per cp.async, and zeros written for bytes
//    outside [0, C). The zeros are the padded-row meaning above, and every
//    read of the inner loops (literal words, class windows, the boundary
//    byte) lands inside the tile, so no read is bounds-checked. The halo
//    covers the tables' widest reach plus the screen's look-ahead and the
//    word reads' slack (match_cuda.launch_plan).
// 2. A bucket-mask screen (the "Teddy" multi-literal screen that Hyperscan
//    publishes). Every literal sits in one of 64 buckets; T_j[256] holds the
//    buckets that admit byte value v at offset j. Bucket b is a candidate at
//    p when its bit is set in T_0[s[p]] & T_1[s[p+1]] & T_2[s[p+2]] &
//    T_3[s[p+3]]. Keyword tables admit both cases of a letter, so folding
//    costs nothing per byte, and a literal shorter than 4 bytes admits every
//    byte past its end, so the screen never drops a real hit. Each thread
//    screens 16 consecutive positions from one 16-byte load plus the next
//    word, with byte extracts for the look-ahead. The tables live in shared
//    memory (not __constant__, which serialises lanes on distinct
//    addresses), each mask split into a low and a high 32-bit table so that
//    a byte value maps to one bank.
// 3. Verify only what passes. A warp skips the verify step when no lane
//    has a candidate (__any_sync); on source text few positions have one
//    (chip_smoke.py reports the share). A candidate bucket's literals are compared 4 bytes at a
//    time as packed words from the tile (funnel shift of two aligned
//    words), ((w | fold) ^ lit) & live == 0, where `fold` sets 0x20 on the
//    a-z bytes of a keyword (this is exactly A-Z folding against a lowered
//    keyword). An anchored variant then checks its class windows against
//    class bitsets in shared memory and its boundary byte, which the halo
//    covers. Hits go to per-block rule flags in shared memory; a set flag
//    skips that rule's literals.
// 4. Table-driven. The ruleset is runtime data (custom rules), so nothing
//    is generated per ruleset: the block copies one packed word image
//    (header of offsets, screen, buckets, literals, words, checks, classes)
//    from its resident device copy into shared memory once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                   // positions a thread screens per pass
constexpr int kPass = kThreads * kRun;     // positions a block screens per pass

// the image layout, shared with trivy_tpu_torch/ops/match_cuda.py
constexpr int kScreen = 4;                 // screen tables T_0..T_3
constexpr int kBuckets = 64;
constexpr int kLitFields = 6;              // word_off, n_words, rule, chk_begin, chk_end, back
enum { H_SCREEN, H_BUCKET, H_LITS, H_WORDS, H_CHECKS, H_CLASSES };  // header words

struct Tables {
  const uint32_t* screen;   // [kScreen][2][256]: low, then high words of the masks
  const int32_t* bucket;    // [kBuckets + 1]: literals of bucket b
  const int32_t* lits;      // [n_lits][kLitFields]
  const uint32_t* words;    // [n_words][3]: literal word, fold mask, live mask
  const int32_t* checks;    // [n_chk][3]: class, count, delta
  const uint32_t* classes;  // [n_classes][8] bitsets over byte values
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four tile bytes from i (any alignment), little-endian
__device__ __forceinline__ uint32_t ld4(const uint8_t* tile, int i) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(tile + (i & ~3));
  return __funnelshift_r(a[0], a[1], (i & 3) * 8);
}

__device__ __forceinline__ bool is_alnum(uint32_t b) {
  return (b - 48u < 10u) || ((b | 32u) - 97u < 26u);
}

// candidate buckets of a position whose four bytes are b0..b3
__device__ __forceinline__ uint64_t screen_mask(const uint32_t* t, uint32_t b0, uint32_t b1,
                                                uint32_t b2, uint32_t b3) {
  const uint32_t lo = t[b0] & t[512 + b1] & t[1024 + b2] & t[1536 + b3];
  const uint32_t hi = t[256 + b0] & t[768 + b1] & t[1280 + b2] & t[1792 + b3];
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

__device__ bool literal_hit(const Tables& t, const uint8_t* tile, int i, const int32_t* lit) {
  const uint32_t* w = t.words + 3 * lit[0];
  for (int k = 0; k < lit[1]; ++k, w += 3) {
    if (((ld4(tile, i + 4 * k) | w[1]) ^ w[0]) & w[2]) return false;
  }
  for (int c = lit[3]; c < lit[4]; ++c) {
    const int32_t* ck = t.checks + 3 * c;
    const uint32_t* bits = t.classes + 8 * ck[0];
    const int q0 = i + ck[2];
    for (int q = q0; q < q0 + ck[1]; ++q) {
      const uint32_t b = tile[q];
      if (!((bits[b >> 5] >> (b & 31)) & 1u)) return false;
    }
  }
  return !lit[5] || !is_alnum(tile[i - lit[5]]);
}

__device__ void verify(const Tables& t, const uint8_t* tile, int i, uint64_t cand,
                       uint8_t* flags) {
  while (cand) {
    const int b = __ffsll(static_cast<long long>(cand)) - 1;
    cand &= cand - 1;
    for (int l = t.bucket[b]; l < t.bucket[b + 1]; ++l) {
      const int32_t* lit = t.lits + kLitFields * l;
      if (!flags[lit[2]] && literal_hit(t, tile, i, lit)) flags[lit[2]] = 1;
    }
  }
}

// copies row bytes [col - halo, col + n - halo) into tile[0, n), zeros
// outside [0, C); `vec` when the row and every segment start are 16-aligned
__device__ void stage(uint8_t* tile, const uint8_t* row, int C, int col, int n, int halo,
                      bool vec) {
  const int g0 = col - halo;
  if (vec) {
    for (int i = threadIdx.x * 16; i < n; i += kThreads * 16) {
      const int g = g0 + i;
      if (g >= 0 && g + 16 <= C) {
        cp_async16(tile + i, row + g);
      } else {
        *reinterpret_cast<uint4*>(tile + i) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_wait_all();
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int g = g0 + i;
      tile[i] = (g >= 0 && g < C) ? row[g] : 0;
    }
  }
}

__device__ void flush(uint8_t* flags, int R, uint8_t* out_row) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    if (flags[r]) out_row[r] = 1;
    flags[r] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
match_kernel(const uint8_t* __restrict__ x, int B, int C, int R,
             const uint4* __restrict__ image, int image_words, int seg, int halo,
             uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  uint32_t* img = reinterpret_cast<uint32_t*>(smem);
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem) + 4 * image_words;
  uint8_t* flags = tile + seg + 2 * halo;

  for (int i = threadIdx.x; i < image_words / 4; i += kThreads) cp_async16(smem + i, image + i);
  cp_async_wait_all();
  for (int r = threadIdx.x; r < R; r += kThreads) flags[r] = 0;
  __syncthreads();
  const Tables t{
      img + img[H_SCREEN],
      reinterpret_cast<const int32_t*>(img + img[H_BUCKET]),
      reinterpret_cast<const int32_t*>(img + img[H_LITS]),
      img + img[H_WORDS],
      reinterpret_cast<const int32_t*>(img + img[H_CHECKS]),
      img + img[H_CLASSES],
  };

  // this block's slice of the flattened positions, 16-aligned
  const int64_t total = static_cast<int64_t>(B) * C;
  const int64_t per = ((total + gridDim.x - 1) / gridDim.x + 15) & ~int64_t{15};
  int64_t s = per * blockIdx.x;
  const int64_t e = s + per < total ? s + per : total;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && (C & 15) == 0;
  int64_t cur = -1;
  while (s < e) {
    const int64_t rowi = s / C;
    const int col = static_cast<int>(s - rowi * C);
    int len = C - col;
    if (e - s < len) len = static_cast<int>(e - s);
    if (seg < len) len = seg;
    if (rowi != cur) {
      if (cur >= 0) {
        flush(flags, R, out + cur * R);
        __syncthreads();
      }
      cur = rowi;
    }
    stage(tile, x + rowi * C, C, col, ((len + 15) & ~15) + 2 * halo, halo, vec);
    __syncthreads();

    for (int pass = 0; pass < len; pass += kPass) {
      const int q0 = pass + kRun * threadIdx.x;  // segment offset of this run
      uint32_t have = 0;                         // bit k: position q0+k has a candidate
      if (q0 < len) {
        const uint8_t* run = tile + halo + q0;
        const uint4 v = *reinterpret_cast<const uint4*>(run);
        const uint32_t w[5] = {v.x, v.y, v.z, v.w, *reinterpret_cast<const uint32_t*>(run + 16)};
        uint32_t b[kRun + kScreen - 1];
#pragma unroll
        for (int q = 0; q < kRun + kScreen - 1; ++q) b[q] = (w[q >> 2] >> (8 * (q & 3))) & 0xffu;
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
          if (screen_mask(t.screen, b[k], b[k + 1], b[k + 2], b[k + 3])) have |= 1u << k;
        }
        if (len - q0 < kRun) have &= (1u << (len - q0)) - 1;  // starts past the segment
      }
      if (__any_sync(0xffffffffu, have)) {
        while (have) {
          const int k = __ffs(have) - 1;
          have &= have - 1;
          const int i = halo + q0 + k;
          verify(t, tile, i, screen_mask(t.screen, tile[i], tile[i + 1], tile[i + 2], tile[i + 3]),
                 flags);
        }
      }
    }
    __syncthreads();
    s += len;
  }
  if (cur >= 0) flush(flags, R, out + cur * R);
}

static_assert(kScreen == 4 && kBuckets == 64, "screen_mask is written for 4 tables of 64 bits");

}  // namespace

extern "C" {

// Prepares the current device once per matcher: lets match_kernel take up
// to `smem_limit` bytes of dynamic shared memory (the card's opt-in limit, so
// matchers of any size share the setting) and writes to *grid how many
// blocks of `smem` bytes are resident on the card at once. Returns the
// first CUDA error, or 0.
int trivy_match_grid(int smem_limit, int smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_limit);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, match_kernel, kThreads, smem);
  }
  *grid = per_sm * sms;
  return static_cast<int>(err);
}

// Launches the matcher on `stream` (PyTorch's current stream) into `out`
// [B, R], which the caller zeroes: the kernel writes only the flags it
// finds. `image` is the packed table image of image_words words (a multiple
// of 4); seg, halo and smem come from match_cuda.launch_plan, and `grid`
// (the resident blocks, from trivy_match_grid) caps the blocks launched.
// Returns cudaGetLastError() after the launch; 0 means it was accepted.
int trivy_match_launch(const uint8_t* x, int B, int C, int R, const uint32_t* image,
                       int image_words, int seg, int halo, int smem, int grid, uint8_t* out,
                       void* stream) {
  const int64_t total = static_cast<int64_t>(B) * C;
  int64_t blocks = (total + kPass - 1) / kPass;
  if (blocks > grid) blocks = grid;
  match_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, B, C, R, reinterpret_cast<const uint4*>(image), image_words, seg, halo, out);
  return static_cast<int>(cudaGetLastError());
}

const char* trivy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
