// Slab decompressor for Hopper (sm_90a): one thread block per row expands
// the secret feed's compressed wire frame into the raw [B, C] uint8 rows the
// matcher reads.
//
// Replaces trivy_tpu/ops/decompress.py:47 build_decompress_fn (an XLA device
// computation, vmapped over rows). The wire format and the static TOKEN
// tables are those of trivy_tpu_torch/secret/compress.py; the plain PyTorch
// version of the same function is trivy_tpu_torch/ops/decompress.py::
// decompress_plain. For every row i, with n = clamp(clen[i], 0, C), stream
// byte j is buf[clamp(offs[i] + j, 0, W - 1)] for j < n and 0 otherwise, and
//   - mode 1 (PACK7): out[j] = ((s[p] << 8 | s[p+1]) >> (9 - (7j & 7))) & 0x7F
//     with p = 7j >> 3 (s[p+1] reads the masked zero past the stream);
//   - mode 2 (TOKEN): token k writes tab_bytes[tok, 0..tab_len[tok]) at the
//     exclusive prefix sum of the lengths of tokens 0..k-1; output bytes at or
//     past C are dropped, positions no token reaches are 0;
//   - any other mode (RAW): out[j] = s[j].
// A row with n == 0 (bucket padding) is a zero row.
//
// What bounds it on an H100. The function reads each row's stream once and
// writes B*C bytes: about (0.875 + 1) * 16 MiB for a [1024, 16384] batch of
// text, 9.4 us at 3.35 TB/s. This first kernel is simple and right, not yet
// fast; the design, point by point:
//
// 1. One block of 512 threads per row. The row's stream (at most C bytes)
//    is staged in shared memory with coalesced byte loads, each clamped into
//    [0, W): streams start at any offset, so nothing is assumed about
//    alignment and nothing past W is read. The staged stream is padded with
//    zeros, which is the masked meaning of every read past n (PACK7's spill
//    byte included).
// 2. TOKEN: each thread sums the lengths of a contiguous stretch of tokens;
//    a block-wide exclusive scan of those sums (warp shuffles, then one warp
//    over the warp totals, written here by hand) gives each stretch its
//    output position; each thread then expands its stretch into a zeroed row
//    in shared memory, dropping bytes at or past C. The two 256-entry
//    tables sit in shared memory: their lookups are data-dependent, which
//    constant memory would serialise.
// 3. The row leaves shared memory in 16-byte stores (8-byte ones when C is
//    no multiple of 16). PACK7 and RAW rows are written straight from the
//    staged stream.
// About 2C + 3 KB of shared memory per block (35.9 KB at C = 16384), so
// four blocks fit on an SM. A faster design (several rows per block,
// aligned vector staging, TMA) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxExpansion = 8;  // MAX_EXPANSION of secret/compress.py
constexpr int kModePack7 = 1;
constexpr int kModeToken = 2;
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

// shared memory of one block: stream, row, tab_bytes, tab_len, warp sums
__host__ __device__ constexpr int smem_bytes(int C) {
  return 2 * (pad16(C) + 16) + 256 * kMaxExpansion + 256 * 4 + kWarps * 4;
}

// writes the `cnt` (8 or 16) bytes of v at p: one 16-byte store when rows are
// 16-byte aligned (C % 16 == 0), else 8-byte stores
__device__ __forceinline__ void put(uint8_t* p, uint4 v, int cnt, bool vec16) {
  if (vec16) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  reinterpret_cast<uint2*>(p)[0] = make_uint2(v.x, v.y);
  if (cnt > 8) reinterpret_cast<uint2*>(p)[1] = make_uint2(v.z, v.w);
}

// copies C bytes from shared memory (16-byte aligned) to the output row
__device__ __forceinline__ void write_row(uint8_t* dst, const uint8_t* src, int C, bool vec16) {
  for (int j = threadIdx.x * 16; j < C; j += kThreads * 16) {
    put(dst + j, *reinterpret_cast<const uint4*>(src + j), C - j < 16 ? C - j : 16, vec16);
  }
}

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

__global__ void __launch_bounds__(kThreads)
decompress_kernel(const uint8_t* __restrict__ buf, long long W, const int32_t* __restrict__ offs,
                  const int32_t* __restrict__ clen, const uint8_t* __restrict__ mode,
                  const uint8_t* __restrict__ tab_bytes, const int32_t* __restrict__ tab_len,
                  int C, uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  uint8_t* s = reinterpret_cast<uint8_t*>(smem);           // stream, pad16(C) + 16
  uint8_t* row = s + pad16(C) + 16;                         // TOKEN output, pad16(C) + 16
  uint8_t* tb = row + pad16(C) + 16;                        // [256][kMaxExpansion]
  int32_t* tl = reinterpret_cast<int32_t*>(tb + 256 * kMaxExpansion);  // [256]
  int32_t* warp_off = tl + 256;                             // [kWarps]

  const int i = blockIdx.x;
  const int n = min(max(clen[i], 0), C);
  const int m = mode[i];
  const bool vec16 = (C & 15) == 0;
  uint8_t* dst = out + static_cast<long long>(i) * C;

  if (n == 0) {  // padding row: zeros in every mode
    for (int j = threadIdx.x * 16; j < C; j += kThreads * 16) {
      put(dst + j, make_uint4(0, 0, 0, 0), C - j < 16 ? C - j : 16, vec16);
    }
    return;
  }

  // 1. the masked stream, zero-padded to the end of its buffer
  const long long off = offs[i];
  for (int j = threadIdx.x; j < pad16(C) + 16; j += kThreads) {
    uint8_t v = 0;
    if (j < n) {
      long long g = off + j;
      g = g < 0 ? 0 : (g >= W ? W - 1 : g);
      v = buf[g];
    }
    s[j] = v;
  }
  if (m == kModeToken) {
    for (int k = threadIdx.x; k < 256 * kMaxExpansion; k += kThreads) tb[k] = tab_bytes[k];
    for (int k = threadIdx.x; k < 256; k += kThreads) tl[k] = tab_len[k];
    for (int j = threadIdx.x * 16; j < pad16(C) + 16; j += kThreads * 16) {
      *reinterpret_cast<uint4*>(row + j) = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  if (m == kModePack7) {
    for (int j0 = threadIdx.x * 16; j0 < C; j0 += kThreads * 16) {
      uint32_t w4[4] = {0u, 0u, 0u, 0u};  // the 16 output bytes, little-endian
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int j = j0 + k;
        const int p = (7 * j) >> 3;
        const uint32_t nxt = p + 1 < C ? s[p + 1] : 0u;
        const uint32_t w = (static_cast<uint32_t>(s[p]) << 8) | nxt;
        w4[k >> 2] |= ((w >> (9 - ((7 * j) & 7))) & 0x7Fu) << (8 * (k & 3));
      }
      put(dst + j0, make_uint4(w4[0], w4[1], w4[2], w4[3]), C - j0 < 16 ? C - j0 : 16, vec16);
    }
    return;
  }
  if (m != kModeToken) {  // RAW
    write_row(dst, s, C, vec16);
    return;
  }

  // 2. TOKEN: this thread's stretch of tokens, its total length, then the
  // block-wide exclusive scan of the totals
  const int per = (n + kThreads - 1) / kThreads;
  const int t0 = min(static_cast<int>(threadIdx.x) * per, n);
  const int t1 = min(t0 + per, n);
  int total = 0;
  for (int k = t0; k < t1; ++k) total += tl[s[k]];
  const int incl = warp_scan(total);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_off[lane] : 0;
    const int wi = warp_scan(w);
    if (lane < kWarps) warp_off[lane] = wi - w;
  }
  __syncthreads();
  int pos = warp_off[warp] + incl - total;
  for (int k = t0; k < t1 && pos < C; ++k) {
    const int tok = s[k];
    const int len = tl[tok];
    for (int e = 0; e < len && pos + e < C; ++e) row[pos + e] = tb[tok * kMaxExpansion + e];
    pos += len;
  }
  __syncthreads();

  // 3. the row out, 16 bytes a store
  write_row(dst, row, C, vec16);
}

}  // namespace

extern "C" {

// Launches the decompressor on `stream` (PyTorch's current stream): out
// [B, C] from buf [W] (W >= 1), offs/clen [B] int32, mode [B] uint8 and the
// codec's tab_bytes [256, 8] uint8 and tab_len [256] int32, all on the
// current device. C must be a multiple of 8 and out 16-byte aligned. Returns
// the first CUDA error (cudaGetLastError() after the launch), or 0.
int trivy_decompress_launch(const uint8_t* buf, long long W, const int32_t* offs,
                            const int32_t* clen, const uint8_t* mode, int B, int C,
                            const uint8_t* tab_bytes, const int32_t* tab_len, uint8_t* out,
                            void* stream) {
  const int smem = smem_bytes(C);
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(decompress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decompress_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      buf, W, offs, clen, mode, tab_bytes, tab_len, C, out);
  return static_cast<int>(cudaGetLastError());
}

const char* trivy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
