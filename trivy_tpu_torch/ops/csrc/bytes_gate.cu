// Two-lane shingle gate of the license classifier for Hopper (sm_90a): one
// thread block per 512-byte block of a [B, C] uint8 text row counts the
// 8-byte windows found in `bloom8` and, per row, the 4-byte windows found in
// `bloom4` and the word bytes.
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
// 4 bytes per 512 (the blooms, 512 KiB each as bitsets, stay in L2): 1 MiB
// per [R, W] dispatch with R * W = 2^20, 0.31 us at 3.35 TB/s, so launch
// overhead dominates. This first kernel is simple and right:
//
// 1. One block of 256 threads per (512-byte block, row). The block and its
//    7-byte halo are staged in shared memory as LUT bytes; the LUT sits in
//    shared memory beside them.
// 2. Each thread packs the windows of two positions and tests one bit of
//    each bitset.
// 3. Counts are reduced per warp with __reduce_add_sync, then across the
//    8 warps; the block writes its block count and adds its two row counts
//    with one atomicAdd each (integer sums: the result does not depend on
//    the order).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 512;  // SHINGLE_BLOCK
constexpr int kHalo = 7;
constexpr int kShift = 32 - 22;  // 32 - SHINGLE_BITS
constexpr uint32_t kMix = 2654435761u;
constexpr uint32_t kP2 = 40503u;

__device__ __forceinline__ uint32_t space(uint8_t v) { return v ? v : 32u; }

__device__ __forceinline__ bool bit(const uint32_t* __restrict__ bits, uint32_t h) {
  return (bits[h >> 5] >> (h & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
bytes_gate_kernel(const uint8_t* __restrict__ x, int C, const uint32_t* __restrict__ lut,
                  const uint32_t* __restrict__ bloom8, const uint32_t* __restrict__ bloom4,
                  int32_t* __restrict__ blk, int32_t* __restrict__ ah, int32_t* __restrict__ nb) {
  __shared__ uint32_t lut_s[256];
  __shared__ uint8_t v[kBlock + kHalo + 1];
  __shared__ int sums[3][kThreads / 32];

  const long long row = blockIdx.y;
  const int b0 = blockIdx.x * kBlock;
  const uint8_t* src = x + row * C;
  for (int k = threadIdx.x; k < 256; k += kThreads) lut_s[k] = lut[k];
  __syncthreads();
  for (int i = threadIdx.x; i < kBlock + kHalo; i += kThreads) {
    const int g = b0 + i;
    v[i] = g < C ? static_cast<uint8_t>(lut_s[src[g]]) : 0;  // past the row end: a space
  }
  __syncthreads();

  int h8n = 0, h4n = 0, vn = 0;
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    if (v[i] == 0) continue;
    const uint32_t wlo = space(v[i]) | space(v[i + 1]) << 8 | space(v[i + 2]) << 16 |
                         space(v[i + 3]) << 24;
    const uint32_t whi = space(v[i + 4]) | space(v[i + 5]) << 8 | space(v[i + 6]) << 16 |
                         space(v[i + 7]) << 24;
    const uint32_t m = wlo * kMix;
    h8n += bit(bloom8, (m + whi * kP2) >> kShift);
    h4n += bit(bloom4, m >> kShift);
    vn += 1;
  }
  h8n = __reduce_add_sync(0xffffffffu, h8n);
  h4n = __reduce_add_sync(0xffffffffu, h4n);
  vn = __reduce_add_sync(0xffffffffu, vn);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sums[0][warp] = h8n;
    sums[1][warp] = h4n;
    sums[2][warp] = vn;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int t = 0;
    for (int w = 0; w < kThreads / 32; ++w) t += sums[threadIdx.x][w];
    if (threadIdx.x == 0) blk[row * (C / kBlock) + blockIdx.x] = t;
    else if (threadIdx.x == 1) atomicAdd(ah + row, t);
    else atomicAdd(nb + row, t);
  }
}

}  // namespace

extern "C" {

// Launches the gate on `stream` (PyTorch's current stream): x [B, C] uint8
// with C a multiple of 512, lut [256] (values below 256), bloom8 and bloom4
// as [2^17] uint32 bitsets, all on the current device; writes blk [B, C/512]
// and adds into ah [B] and nb [B], which the caller zeroes. Returns the
// first CUDA error (cudaGetLastError() after the launch), or 0.
int trivy_bytes_gate_launch(const uint8_t* x, int B, int C, const uint32_t* lut,
                            const uint32_t* bloom8, const uint32_t* bloom4, int32_t* blk,
                            int32_t* ah, int32_t* nb, void* stream) {
  const dim3 grid(C / kBlock, B);
  bytes_gate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, C, lut, bloom8, bloom4, blk, ah, nb);
  return static_cast<int>(cudaGetLastError());
}

const char* trivy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
