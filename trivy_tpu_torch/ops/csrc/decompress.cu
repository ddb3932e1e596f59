// Slab decompressor for Hopper (sm_90a): a persistent grid expands the
// secret feed's compressed wire frame into the raw [B, C] uint8 rows the
// matcher reads, staging each row's stream in 16-byte pieces while the
// block expands the row before it.
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
// text, 9.4 us at 3.35 TB/s. The design, point by point:
//
// 1. Persistent blocks (the card's resident count G, capped by the rows):
//    block b expands row b, then its share of the other rows in an order
//    that deals the TOKEN rows out one a block (`order_rows`: a TOKEN row
//    of source text costs about four RAW rows, and rows b, b + G, ... left
//    some blocks with several; a device counter balanced them too, but its
//    atomic's round trip, queued behind the kernel's own traffic, cost more
//    on the H100). It stages its next row's stream while it expands this
//    one (two stream buffers, cp.async groups), and ranks the rows while
//    its first row loads. The TOKEN tables are staged once per block.
// 2. Vector staging. A stream is copied as the 16-byte-aligned pieces of
//    memory that hold it, with 16-byte cp.async, to shared memory at the
//    stream's shift (its address mod 16), so stream byte j lies at
//    shift + j. A piece that is not wholly inside [buf, buf + W) (a stream
//    that starts before the buffer, runs past its end, or a buffer whose
//    length is no multiple of 16) is read byte by byte with the clamp
//    above: nothing outside the buffer is read. Bytes past n are not
//    cleared in shared memory: every read masks them to 0 in registers.
// 3. PACK7 from registers: seven stream bytes give eight output bytes, so a
//    thread reads the 14 bytes of two groups (two aligned 16-byte shared
//    words, then selects and funnel shifts), decodes them as two 56-bit
//    big-endian values and writes the 16 output bytes in one store.
// 4. TOKEN: each warp sums the lengths of a contiguous stretch of tokens;
//    an exclusive scan of the warp totals gives each stretch its output
//    position and the row's expanded length L. A warp then expands its
//    stretch 128 tokens at a time, four neighbouring tokens a lane, placed
//    by one shuffle scan of the lanes' lengths, into a row in shared memory
//    (each table entry read as one 8-byte word; a token written in aligned
//    32-bit stores where it can be, bytes elsewhere; bytes at or past C
//    dropped): neighbouring lanes write neighbouring bytes, where lanes
//    that each walked a long stretch of their own wrote a stretch apart, on
//    few banks, and the shuffles per token stay few. The row goes out in
//    16-byte stores with the bytes past L masked to 0: nothing is zeroed
//    first.
// 5. RAW: written from the staged stream in 16-byte stores (8-byte ones
//    when C is no multiple of 16), masked past n.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxExpansion = 8;  // MAX_EXPANSION of secret/compress.py
constexpr int kModePack7 = 1;
constexpr int kModeToken = 2;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

// a stream buffer: the stream at a shift of up to 15 bytes, and the 16
// bytes past it that the last chunk's two-word read may touch
__host__ __device__ constexpr int stream_bytes(int C) { return pad16(C) + 32; }

// shared memory of one block: two stream buffers, the TOKEN row, tab_bytes,
// tab_len as bytes, the warp offsets and the row's total (or the ranking's
// warp counts), and the block's list of `slots` rows
__host__ __device__ constexpr int smem_bytes(int C, int slots) {
  return 2 * stream_bytes(C) + pad16(C) + 16 + 256 * kMaxExpansion + 256 +
         (2 * kWarps + 4) * 4 + 4 * slots;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the row's stream length and where its byte 0 lies in a stream buffer
struct Row {
  long long off;
  int n;
  int shift;
};

__device__ __forceinline__ Row row_of(const uint8_t* buf, const int32_t* offs, const int32_t* clen,
                                      int i, int C) {
  Row r;
  r.off = offs[i];
  r.n = min(max(clen[i], 0), C);
  r.shift = static_cast<int>((static_cast<long long>(reinterpret_cast<uintptr_t>(buf)) + r.off) & 15);
  return r;
}

// issues the copy of a row's stream into `s`: stream byte j lands at
// s[r.shift + j]; the pieces wholly inside the buffer by cp.async, the
// others byte by byte with the clamp
__device__ __forceinline__ void stage_row(uint8_t* s, const uint8_t* __restrict__ buf,
                                          long long W, Row r) {
  const long long base = static_cast<long long>(reinterpret_cast<uintptr_t>(buf));
  const long long a0 = base + r.off - r.shift;  // 16-byte aligned
  const int pieces = r.n ? (r.shift + r.n + 15) >> 4 : 0;
  for (int q = threadIdx.x; q < pieces; q += kThreads) {
    const long long g = a0 + 16LL * q;
    if (g >= base && g + 16 <= base + W) {
      cp_async16(s + 16 * q, reinterpret_cast<const void*>(g));
    } else {
      for (int e = 0; e < 16; ++e) {
        const int j = 16 * q + e - r.shift;
        uint8_t v = 0;
        if (j >= 0 && j < r.n) {
          long long k = r.off + j;
          k = k < 0 ? 0 : (k >= W ? W - 1 : k);
          v = buf[k];
        }
        s[16 * q + e] = v;
      }
    }
  }
}

// 16 bytes of shared memory from byte p (any alignment), little-endian: the
// two aligned 16-byte words that hold them (lanes reading neighbouring
// chunks touch neighbouring words, so the loads meet no bank twice), then
// the words selected and funnel-shifted in registers
__device__ __forceinline__ uint4 load16(const uint8_t* s, int p) {
  const uint4* a = reinterpret_cast<const uint4*>(s + (p & ~15));
  const uint4 lo = a[0], hi = a[1];
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = (p >> 2) & 3, sh = 8 * (p & 3);
  uint32_t o[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    o[k] = q == 0 ? w[k] : q == 1 ? w[k + 1] : q == 2 ? w[k + 2] : w[min(k + 3, 7)];
  }
  return make_uint4(__funnelshift_r(o[0], o[1], sh), __funnelshift_r(o[1], o[2], sh),
                    __funnelshift_r(o[2], o[3], sh), __funnelshift_r(o[3], o[4], sh));
}

// the low v bytes of a word (v clamped to [0, 4])
__device__ __forceinline__ uint32_t keep(int v) {
  return v >= 4 ? 0xffffffffu : (v <= 0 ? 0u : (1u << (8 * v)) - 1u);
}

// the first v bytes of x, the rest 0
__device__ __forceinline__ uint4 first_bytes(uint4 x, int v) {
  return make_uint4(x.x & keep(v), x.y & keep(v - 4), x.z & keep(v - 8), x.w & keep(v - 12));
}

__device__ __forceinline__ uint32_t bswap32(uint32_t v) { return __byte_perm(v, 0, 0x0123); }

// eight 7-bit outputs of a 56-bit big-endian group, as two little-endian words
__device__ __forceinline__ uint2 unpack7(uint64_t v) {
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    lo |= static_cast<uint32_t>((v >> (49 - 7 * k)) & 0x7F) << (8 * k);
    hi |= static_cast<uint32_t>((v >> (21 - 7 * k)) & 0x7F) << (8 * k);
  }
  return make_uint2(lo, hi);
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

// writes the first n bytes of v (little-endian) at row[pos..]: 32-bit
// stores where pos is 4-byte aligned, bytes elsewhere
__device__ __forceinline__ void put_bytes(uint8_t* row, int pos, uint64_t v, int n) {
  while (n > 0) {
    if ((pos & 3) == 0 && n >= 4) {
      *reinterpret_cast<uint32_t*>(row + pos) = static_cast<uint32_t>(v);
      v >>= 32;
      pos += 4;
      n -= 4;
    } else {
      row[pos] = static_cast<uint8_t>(v);
      v >>= 8;
      pos += 1;
      n -= 1;
    }
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

// The rows this block expands after row blockIdx.x, in order, into rows[]
// (returns how many): rows G..B-1 ordered TOKEN rows first (ascending), the
// others after them (descending), and of those the positions blockIdx.x,
// blockIdx.x + G, ...: TOKEN rows, which cost several of the others, are
// dealt out one a block. Ranks come from ballots and one warp scan of the
// warps' TOKEN counts, 512 rows a pass; `first` holds the modes of this
// thread's rows in the first two passes, loaded as the kernel started.
// `scratch` holds kWarps ints.
__device__ int order_rows(const uint8_t* __restrict__ mode, int B, int32_t* rows,
                          int32_t* scratch, const int first[2]) {
  const int G = gridDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rest = B - G;  // rows past the first G: positions [0, rest)
  int tok_base = 0;
  for (int c0 = G, pass = 0; c0 < B; c0 += kThreads, ++pass) {
    const int r = c0 + threadIdx.x;
    const int m = pass == 0 ? first[0] : pass == 1 ? first[1] : (r < B ? mode[r] : 0);
    const bool tok = r < B && m == kModeToken;
    const unsigned bt = __ballot_sync(0xffffffffu, tok);
    if (lane == 0) scratch[warp] = __popc(bt);
    __syncthreads();
    const int t = lane < kWarps ? scratch[lane] : 0;
    const int ti = warp_scan(t);
    const int t_before = __shfl_sync(0xffffffffu, ti - t, warp);
    const int t_all = __shfl_sync(0xffffffffu, ti, kWarps - 1);
    const int tok_rank = t_before + __popc(bt & ((1u << lane) - 1u));
    // rows before r in this pass that are not TOKEN rows
    const int other_rank = static_cast<int>(threadIdx.x) - tok_rank;
    int p = -1;
    if (r < B) p = tok ? tok_base + tok_rank : rest - 1 - ((c0 - G - tok_base) + other_rank);
    if (p >= 0 && p % G == static_cast<int>(blockIdx.x)) rows[p / G] = r;
    tok_base += t_all;
    __syncthreads();
  }
  return rest > static_cast<int>(blockIdx.x) ? (rest - static_cast<int>(blockIdx.x) + G - 1) / G
                                              : 0;
}

__global__ void __launch_bounds__(kThreads, 2)
decompress_kernel(const uint8_t* __restrict__ buf, long long W, const int32_t* __restrict__ offs,
                  const int32_t* __restrict__ clen, const uint8_t* __restrict__ mode,
                  const uint8_t* __restrict__ tab_bytes, const int32_t* __restrict__ tab_len,
                  int B, int C, uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  uint8_t* sbuf[2];
  sbuf[0] = reinterpret_cast<uint8_t*>(smem);
  sbuf[1] = sbuf[0] + stream_bytes(C);
  uint8_t* row = sbuf[1] + stream_bytes(C);                      // TOKEN output, pad16(C) + 16
  uint8_t* tb = row + pad16(C) + 16;                              // [256][kMaxExpansion]
  uint8_t* tl = tb + 256 * kMaxExpansion;                        // [256], lengths as bytes
  int32_t* warp_off = reinterpret_cast<int32_t*>(tl + 256);  // [kWarps], the row's total
  int32_t* rows = warp_off + 2 * kWarps + 4;  // the block's rows after its first: [slots]

  const bool vec16 = (C & 15) == 0;
  const int chunks = (C + 15) >> 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the modes order_rows reads first, in flight while the tables and the
  // first row are staged
  int first[2];
  for (int k = 0; k < 2; ++k) {
    const int r = gridDim.x + k * kThreads + threadIdx.x;
    first[k] = r < B ? mode[r] : 0;
  }

  // the tables and the first row's stream: one copy group (the lengths as
  // bytes: random lookups of a 256-byte table meet a bank at most twice)
  for (int k = threadIdx.x; k < 256 * kMaxExpansion / 16; k += kThreads) {
    cp_async16(tb + 16 * k, tab_bytes + 16 * k);
  }
  int i = blockIdx.x;
  if (i < B) stage_row(sbuf[0], buf, W, row_of(buf, offs, clen, i, C));
  cp_async_commit();
  for (int k = threadIdx.x; k < 256; k += kThreads) tl[k] = static_cast<uint8_t>(tab_len[k]);
  const int count = order_rows(mode, B, rows, warp_off, first);

  for (int it = 0; i < B; ++it) {
    const int nx = it < count ? rows[it] : B;
    if (nx < B) stage_row(sbuf[(it + 1) & 1], buf, W, row_of(buf, offs, clen, nx, C));
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();

    const uint8_t* s = sbuf[it & 1];
    const Row r = row_of(buf, offs, clen, i, C);
    const int m = mode[i];
    uint8_t* dst = out + static_cast<long long>(i) * C;
    if (r.n == 0) {  // padding row: zeros in every mode
      for (int c = threadIdx.x; c < chunks; c += kThreads) {
        put(dst + 16 * c, make_uint4(0, 0, 0, 0), C - 16 * c, vec16);
      }
    } else if (m == kModePack7) {
      for (int c = threadIdx.x; c < chunks; c += kThreads) {
        const uint4 x = first_bytes(load16(s, r.shift + 14 * c), r.n - 14 * c);
        const uint64_t ga = (static_cast<uint64_t>(bswap32(x.x)) << 24) | (bswap32(x.y) >> 8);
        const uint64_t gb = (static_cast<uint64_t>(bswap32(__funnelshift_r(x.y, x.z, 24))) << 24) |
                            (bswap32(__funnelshift_r(x.z, x.w, 24)) >> 8);
        const uint2 a = unpack7(ga), b = unpack7(gb);
        put(dst + 16 * c, make_uint4(a.x, a.y, b.x, b.y), C - 16 * c, vec16);
      }
    } else if (m != kModeToken) {  // RAW
      for (int c = threadIdx.x; c < chunks; c += kThreads) {
        put(dst + 16 * c, first_bytes(load16(s, r.shift + 16 * c), r.n - 16 * c), C - 16 * c,
            vec16);
      }
    } else {
      // TOKEN: each warp takes a contiguous stretch of tokens and sums their
      // lengths; a scan of the warp totals places the stretches
      const uint8_t* tok = s + r.shift;
      const int per = (r.n + kWarps - 1) / kWarps;
      const int t0 = min(warp * per, r.n);
      const int t1 = min(t0 + per, r.n);
      int total = 0;
      for (int k = t0 + 4 * lane; k < t1; k += 128) {  // four tokens a lane
#pragma unroll
        for (int u = 0; u < 4; ++u) total += k + u < t1 ? tl[tok[k + u]] : 0;
      }
      total = __reduce_add_sync(0xffffffffu, total);
      if (lane == 0) warp_off[warp] = total;
      __syncthreads();
      if (warp == 0) {
        const int w = lane < kWarps ? warp_off[lane] : 0;
        const int wi = warp_scan(w);
        if (lane < kWarps) warp_off[lane] = wi - w;
        if (lane == kWarps - 1) warp_off[kWarps] = wi;  // the row's expanded length
      }
      __syncthreads();
      // the stretch 128 tokens at a time, four neighbouring tokens a lane:
      // one shuffle scan of the lanes' lengths places them, so neighbouring
      // lanes write neighbouring bytes
      const uint64_t* entry = reinterpret_cast<const uint64_t*>(tb);
      int base = warp_off[warp];
      for (int k0 = t0; k0 < t1 && base < C; k0 += 128) {
        int len[4], sum = 0;
        uint64_t e[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + 4 * lane + u;
          const int t = k < t1 ? tok[k] : 0;
          len[u] = k < t1 ? tl[t] : 0;
          e[u] = entry[t];
          sum += len[u];
        }
        const int incl = warp_scan(sum);
        int pos = base + incl - sum;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          put_bytes(row, pos, e[u], min(len[u], C - pos));
          pos += len[u];
        }
        base += __shfl_sync(0xffffffffu, incl, 31);
      }
      __syncthreads();
      const int L = min(warp_off[kWarps], C);
      for (int c = threadIdx.x; c < chunks; c += kThreads) {
        put(dst + 16 * c, first_bytes(*reinterpret_cast<const uint4*>(row + 16 * c), L - 16 * c),
            C - 16 * c, vec16);
      }
    }
    __syncthreads();  // this row's buffers are free for the row after next
    i = nx;
  }
}

}  // namespace

extern "C" {

// Prepares the current device once per decompressor: lets decompress_kernel
// take up to the card's opt-in shared memory and writes to *grid how many
// blocks for rows of C bytes are resident on the card at once, and to *smem
// the dynamic shared memory of each before its list of rows. Returns the
// first CUDA error, or 0.
int trivy_decompress_grid(int C, int* grid, int* smem) {
  *smem = smem_bytes(C, 0);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(decompress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decompress_kernel, kThreads,
                                                        *smem);
  }
  *grid = per_sm * sms;
  return static_cast<int>(err);
}

// Launches the decompressor on `stream` (PyTorch's current stream): out
// [B, C] from buf [W] (W >= 1), offs/clen [B] int32, mode [B] uint8 and the
// codec's tab_bytes [256, 8] uint8 and tab_len [256] int32, all on the
// current device. C must be a multiple of 8, out 16-byte aligned, the
// tables 16-byte aligned and every tab_len at most 8. `grid` and `smem`
// come from trivy_decompress_grid.
// Returns cudaGetLastError() after the launch, or 0.
int trivy_decompress_launch(const uint8_t* buf, long long W, const int32_t* offs,
                            const int32_t* clen, const uint8_t* mode, int B, int C,
                            const uint8_t* tab_bytes, const int32_t* tab_len, uint8_t* out,
                            int grid, int smem, void* stream) {
  const int blocks = B < grid ? B : grid;
  const int slots = (B - 1) / blocks;  // at most the rows past each block's first
  smem += 4 * slots;
  decompress_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      buf, W, offs, clen, mode, tab_bytes, tab_len, B, C, out);
  return static_cast<int>(cudaGetLastError());
}

const char* trivy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
