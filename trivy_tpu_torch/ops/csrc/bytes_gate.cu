// Two-lane shingle gate of the license classifier for Hopper (sm_90a): a
// block per 8 KiB tile of [B, C] uint8 text rows, counting per
// 512-byte block the 8-byte windows found in `bloom8` and per row the 4-byte
// windows found in `bloom4` and the word bytes, in one launch.
//
// Replaces trivy_tpu/ops/ngram_score.py:696 build_bytes_gate_fn (an XLA
// device computation). The plain PyTorch version of the same function is
// trivy_tpu_torch/ops/bytes_gate.py::bytes_gate_plain. With sv the row's
// LUT image where separators (LUT value 0) and bytes past the row end read
// as a space (32), at each position i:
//   wlo = sv[i] | sv[i+1] << 8 | sv[i+2] << 16 | sv[i+3] << 24,
//   whi = the same over sv[i+4 .. i+7],
//   h8 = (wlo * 2654435761 + whi * 40503) >> 10,  h4 = (wlo * 2654435761) >> 10,
// a window counting only where the LUT value at i is non-zero. Outputs:
// block_hits[b, k] (bloom8 hits in block k), anchor_hits[b] (bloom4 hits)
// and word_bytes[b] (non-zero LUT values).
//
// What bounds it on an H100. The function reads the rows once and writes
// 4 bytes per 512 (the blooms, 512 KiB each as bitsets, stay in L2): about
// 2 MiB per [R, W] dispatch with R * W = 2^20, 0.63 us at 3.35 TB/s, so a
// dispatch costs what one launch and a few dependent memory round trips
// cost. The design, point by point:
//
// 1. One launch. The kernel writes every output itself: block counts, and
//    the row counts of rows that lie inside one tile, directly; a row that
//    spans tiles leaves one partial (anchor hits, word bytes) per piece in
//    a scratch, and the last block to finish (a ticket from a device
//    counter, behind __threadfence) sums each such row's pieces in order
//    and resets the counter for the next launch. The wrapper allocates the
//    outputs with torch.empty: no fill kernel runs before it.
// 2. A block per tile. A tile is 8 KiB of the flattened rows: sixteen
//    512-byte blocks, one per warp, 16 positions per lane (blocks of 256
//    threads, twice as many, staged twice the tables and were slower on the
//    H100). A tile and a 16-byte halo are staged with 16-byte cp.async in
//    the same copy group as the LUT and the screens, which are loaded into
//    shared memory once per 8 KiB. The classifier's dispatches are at most
//    2^20 bytes, 128 tiles: fewer than the card's SMs, so a block never has
//    a second tile to overlap with its first.
// 3. Screens in shared memory ahead of the L2 bitsets. A screen of 2^s bits
//    folds the 2^22-bit bloom by its top s bits (screen bit h >> (22 - s) is
//    the OR of the bloom bits it covers), so it never rejects a set bit;
//    only windows that pass it read the 512 KiB bitset (__ldg). Each bloom
//    has one (bloom4: 533 bits set; bloom8: 51,945). The lookups of a
//    lane's 16 windows are issued together.
// 4. Window words in registers. A lane turns its 16 staged bytes into LUT
//    values, packs them as four little-endian words, takes the next 8 bytes
//    from its neighbour lane (__shfl_down_sync; lane 31 reads them itself,
//    or spaces at a row end) and cuts each window out with funnel shifts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 16;                   // positions per lane
constexpr int kBlock = 512;                // SHINGLE_BLOCK: one warp's positions
constexpr int kTile = kThreads * kRun;     // bytes per tile (kWarps blocks)
constexpr int kStage = kTile + 16;         // a tile and its halo piece
constexpr int kBits = 22;                  // SHINGLE_BITS
constexpr int kShift = 32 - kBits;
constexpr uint32_t kMix = 2654435761u;
constexpr uint32_t kP2 = 40503u;
constexpr uint32_t kSpaces = 0x20202020u;

static_assert(kWarps * kBlock == kTile, "a warp covers one density block");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the shared-memory layout of a block: the LUT, the two screens, the tile,
// per-warp sums and the last-block flag
struct Smem {
  uint32_t* lut;
  uint32_t* s4;
  uint32_t* s8;
  uint8_t* tile;
  int* warp;  // [kWarps][2]: anchor hits, word bytes
  int* last;
};

__host__ __device__ constexpr int smem_bytes(int s4_words, int s8_words) {
  return 4 * (256 + s4_words + s8_words) + kStage + 4 * (2 * kWarps + 4);
}

__device__ __forceinline__ Smem carve(uint8_t* base, int s4_words, int s8_words) {
  Smem m;
  m.lut = reinterpret_cast<uint32_t*>(base);
  m.s4 = m.lut + 256;
  m.s8 = m.s4 + s4_words;
  m.tile = reinterpret_cast<uint8_t*>(m.s8 + s8_words);
  m.warp = reinterpret_cast<int*>(m.tile + kStage);
  m.last = m.warp + 2 * kWarps;
  return m;
}

// copies `words` uint32 words (a multiple of 4) into shared memory
__device__ __forceinline__ void stage_words(uint32_t* dst, const uint32_t* src, int words) {
  for (int k = threadIdx.x * 4; k < words; k += kThreads * 4) cp_async16(dst + k, src + k);
}

// stages flat bytes [t0, t0 + kStage) of the rows, those below `total`, into
// `tile`: 16-byte cp.async when the rows are 16-byte aligned, else bytes
__device__ __forceinline__ void stage_tile(uint8_t* tile, const uint8_t* x, long long total,
                                           long long t0, bool vec) {
  for (int q = threadIdx.x; q < kStage / 16; q += kThreads) {
    const long long g = t0 + 16 * q;
    if (vec) {
      if (g + 16 <= total) cp_async16(tile + 16 * q, x + g);
    } else {
      for (int b = 0; b < 16 && g + b < total; ++b) tile[16 * q + b] = x[g + b];
    }
  }
}

// the space-substituted LUT image of four bytes, packed little-endian, and
// the mask of those whose LUT value is non-zero (bit j: byte j)
__device__ __forceinline__ uint32_t image4(const uint32_t* lut, uint32_t raw, uint32_t& valid,
                                           int j0) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t v = lut[(raw >> (8 * b)) & 0xFFu];
    valid |= (v != 0u) << (j0 + b);
    w |= (v ? v : 32u) << (8 * b);
  }
  return w;
}

// screen bit of hash h in a 2^sbits-bit screen
__device__ __forceinline__ bool screened(const uint32_t* s, uint32_t h, int sbits) {
  const uint32_t b = h >> (kBits - sbits);
  return (s[b >> 5] >> (b & 31)) & 1u;
}

// the bitset word of hash h, read through the read-only path only when
// `pred` (else 0): a predicated load, so a lane's reads issue together
__device__ __forceinline__ uint32_t bloom_word(const uint32_t* __restrict__ bloom, uint32_t h,
                                               uint32_t pred) {
  uint32_t w = 0;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p ld.global.nc.b32 %0, [%1];\n}\n"
      : "+r"(w)
      : "l"(bloom + (h >> 5)), "r"(pred));
  return w;
}

__global__ void __launch_bounds__(kThreads)
bytes_gate_kernel(const uint8_t* __restrict__ x, int B, int C, const uint32_t* __restrict__ lut,
                  const uint32_t* __restrict__ bloom8, const uint32_t* __restrict__ bloom4,
                  const uint32_t* __restrict__ screen4, int s4_bits,
                  const uint32_t* __restrict__ screen8, int s8_bits,
                  int32_t* __restrict__ blk, int32_t* __restrict__ ah, int32_t* __restrict__ nb,
                  int32_t* __restrict__ partial, unsigned* __restrict__ ticket) {
  extern __shared__ uint4 smem_raw[];
  const int s4_words = (1 << s4_bits) / 32;
  const int s8_words = (1 << s8_bits) / 32;
  const Smem sm = carve(reinterpret_cast<uint8_t*>(smem_raw), s4_words, s8_words);
  const uint32_t* s4 = sm.s4;  // the screens in shared memory
  const uint32_t* s8 = sm.s8;

  const int nblk = C / kBlock;  // density blocks per row
  const int blocks = B * nblk;  // density blocks in all
  const long long total = static_cast<long long>(B) * C;
  const int t = blockIdx.x;     // this block's tile
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the tables and the tile: one copy group
  stage_words(sm.lut, lut, 256);
  stage_words(sm.s4, screen4, s4_words);
  stage_words(sm.s8, screen8, s8_words);
  stage_tile(sm.tile, x, total, static_cast<long long>(t) * kTile, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this lane's 16 positions: density block d, bytes [16 lane, 16 lane + 16) of it
  const int d = t * kWarps + warp;
  const bool live = d < blocks;
  const bool row_end = live && d % nblk == nblk - 1;
  const uint4 raw = *reinterpret_cast<const uint4*>(sm.tile + 16 * threadIdx.x);
  uint32_t valid = 0;
  uint32_t S[6];
  S[0] = image4(sm.lut, raw.x, valid, 0);
  S[1] = image4(sm.lut, raw.y, valid, 4);
  S[2] = image4(sm.lut, raw.z, valid, 8);
  S[3] = image4(sm.lut, raw.w, valid, 12);
  S[4] = __shfl_down_sync(0xffffffffu, S[0], 1);
  S[5] = __shfl_down_sync(0xffffffffu, S[1], 1);
  if (lane == 31) {
    if (row_end) {
      S[4] = S[5] = kSpaces;
    } else {
      const uint2 h = *reinterpret_cast<const uint2*>(sm.tile + 16 * threadIdx.x + 16);
      uint32_t unused = 0;
      S[4] = image4(sm.lut, h.x, unused, 0);
      S[5] = image4(sm.lut, h.y, unused, 0);
    }
  }
  if (!live) valid = 0;

  // hashes and screens, then the bitset reads of the windows that passed,
  // all issued before any is used
  uint32_t h4[kRun], h8[kRun], need4 = 0, need8 = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int w = j >> 2, sh = 8 * (j & 3);
    const uint32_t wlo = __funnelshift_r(S[w], S[w + 1], sh);
    const uint32_t whi = __funnelshift_r(S[w + 1], S[w + 2], sh);
    const uint32_t m = wlo * kMix;
    h4[j] = m >> kShift;
    h8[j] = (m + whi * kP2) >> kShift;
    if ((valid >> j) & 1u) {
      need4 |= static_cast<uint32_t>(screened(s4, h4[j], s4_bits)) << j;
      need8 |= static_cast<uint32_t>(screened(s8, h8[j], s8_bits)) << j;
    }
  }
  uint32_t w4[kRun], w8[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    w4[j] = bloom_word(bloom4, h4[j], (need4 >> j) & 1u);
    w8[j] = bloom_word(bloom8, h8[j], (need8 >> j) & 1u);
  }
  int h8n = 0, h4n = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    h4n += (w4[j] >> (h4[j] & 31)) & 1u;
    h8n += (w8[j] >> (h8[j] & 31)) & 1u;
  }
  h8n = __reduce_add_sync(0xffffffffu, h8n);
  h4n = __reduce_add_sync(0xffffffffu, h4n);
  const int vn = __reduce_add_sync(0xffffffffu, __popc(valid));
  if (lane == 0) {
    if (live) blk[d] = h8n;
    sm.warp[2 * warp] = h4n;
    sm.warp[2 * warp + 1] = vn;
  }
  __syncthreads();

  // row counts: a row inside the tile is written here, the piece of a row
  // that spans tiles goes to the scratch at its first block
  if (threadIdx.x < kWarps) {
    const int w = threadIdx.x;
    const int dw = t * kWarps + w;
    if (dw < blocks && (w == 0 || dw % nblk == 0)) {
      const int row = dw / nblk;
      const int row_last = (row + 1) * nblk - 1;
      int a = 0, n = 0, e = w;
      for (; e < kWarps && t * kWarps + e <= row_last; ++e) {
        a += sm.warp[2 * e];
        n += sm.warp[2 * e + 1];
      }
      if (dw % nblk == 0 && t * kWarps + e - 1 == row_last) {
        ah[row] = a;
        nb[row] = n;
      } else {
        partial[2 * dw] = a;
        partial[2 * dw + 1] = n;
        __threadfence();  // before this block's ticket
      }
    }
  }
  __syncthreads();

  // rows that span tiles: the last block to finish sums their pieces, a
  // thread per row, its pieces' reads issued together
  if (nblk > kWarps || kWarps % nblk != 0) {
    if (threadIdx.x == 0) *sm.last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (*sm.last) {
      __threadfence();
      for (int row = threadIdx.x; row < B; row += kThreads) {
        const int first = row * nblk;
        const int end = first + nblk;  // one past the row's last block
        const int b1 = (first / kWarps + 1) * kWarps;  // the next tile's first block
        if (b1 >= end) continue;  // inside one tile: written directly
        int a = __ldcg(partial + 2 * first), n = __ldcg(partial + 2 * first + 1);
        for (int dp = b1; dp < end; dp += kWarps) {
          a += __ldcg(partial + 2 * dp);
          n += __ldcg(partial + 2 * dp + 1);
        }
        ah[row] = a;
        nb[row] = n;
      }
      if (threadIdx.x == 0) *ticket = 0u;  // ready for the next launch
    }
  }
}

}  // namespace

extern "C" {

// Prepares the current device once per gate: lets bytes_gate_kernel take
// up to the card's opt-in shared memory (so gates with any screens share
// the setting) and writes to *smem the dynamic shared memory of a block
// with screens of s4_bits and s8_bits. Returns the first CUDA error, or 0.
int trivy_bytes_gate_smem(int s4_bits, int s8_bits, int* smem) {
  *smem = smem_bytes((1 << s4_bits) / 32, (1 << s8_bits) / 32);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(bytes_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  return static_cast<int>(err);
}

// Launches the gate on `stream` (PyTorch's current stream), a block per 8
// KiB tile: x [B, C] uint8 with C a positive multiple of 512, lut [256]
// (values below 256), bloom8 and bloom4 as [2^17] uint32 bitsets, screen4 of
// 2^s4_bits bits and screen8 of 2^s8_bits bits (both from 7 to 22), all on
// the current device; writes blk [B, C/512], ah [B] and nb [B]. B * C / 512
// must be below 2^31. `partial` holds 2 * B * C / 512 int32 of scratch and
// `ticket` one uint32 that is 0 before the launch and 0 again after it;
// launches that share them must be ordered (one stream). `smem` comes from
// trivy_bytes_gate_smem. Returns cudaGetLastError() after the launch.
int trivy_bytes_gate_launch(const uint8_t* x, int B, int C, const uint32_t* lut,
                            const uint32_t* bloom8, const uint32_t* bloom4,
                            const uint32_t* screen4, int s4_bits, const uint32_t* screen8,
                            int s8_bits, int32_t* blk, int32_t* ah, int32_t* nb,
                            int32_t* partial, unsigned* ticket, int smem, void* stream) {
  const long long tiles = (static_cast<long long>(B) * (C / kBlock) + kWarps - 1) / kWarps;
  bytes_gate_kernel<<<static_cast<unsigned>(tiles), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x, B, C, lut, bloom8, bloom4, screen4, s4_bits, screen8, s8_bits, blk, ah, nb, partial,
      ticket);
  return static_cast<int>(cudaGetLastError());
}

const char* trivy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
