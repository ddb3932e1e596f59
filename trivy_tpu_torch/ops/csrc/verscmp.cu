// Version-constraint check for Hopper (sm_90a): one warp per constraint row
// compares an installed version's encoding with a bound's and evaluates the
// row's operator.
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
// What bounds it on an H100. The R rows of indices and ops (12 bytes each),
// the distinct inst and bound rows the gather reaches (4 L bytes each) and
// the R verdict bytes, each read or written once at 3.35 TB/s: for the
// several hundred thousand rows of one SBOM's dispatch, a few microseconds.
// The design is the simple one:
//
// 1. One warp per row, eight rows per block of 256 threads. Lane j reads
//    column c + j of both gathered rows, so a row is one 128-byte coalesced
//    load per side for each 32-column chunk.
// 2. __ballot_sync(a != b) and __ffs give the first differing column of the
//    chunk; its lane's (a < b) is broadcast with __shfl_sync. The warp walks
//    the chunks in order when L > 32 and stops at the first that differs.
// 3. Lane 0 writes the sign and the verdict. Nothing is staged in shared
//    memory: each row is read once, and the gathered bound rows that repeat
//    across rows are served by L2 (the matrix of a full advisory DB is a few
//    MB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
verscmp_kernel(const int32_t* __restrict__ inst, int n_inst,
               const int32_t* __restrict__ bounds, int n_bounds, int L,
               const int32_t* __restrict__ a_idx, const int32_t* __restrict__ b_idx,
               const int32_t* __restrict__ ops, int R,
               uint8_t* __restrict__ verdict, int32_t* __restrict__ sign) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // r is the same for the whole warp
  int ai = a_idx ? a_idx[r] : static_cast<int>(r);
  int bi = b_idx ? b_idx[r] : static_cast<int>(r);
  ai = min(max(ai, 0), n_inst - 1);
  bi = min(max(bi, 0), n_bounds - 1);
  const int32_t* a = inst + static_cast<size_t>(ai) * L;
  const int32_t* b = bounds + static_cast<size_t>(bi) * L;
  int s = 0;
  for (int c = 0; c < L; c += 32) {
    const int j = c + lane;
    int32_t av = 0, bv = 0;
    if (j < L) {
      av = __ldg(a + j);
      bv = __ldg(b + j);
    }
    const unsigned diff = __ballot_sync(kAll, av != bv);
    if (diff) {  // the same for the whole warp
      const int lt = __shfl_sync(kAll, av < bv ? 1 : 0, __ffs(diff) - 1);
      s = lt ? -1 : 1;
      break;
    }
  }
  if (lane != 0) return;
  if (sign) sign[r] = s;
  if (verdict) {
    bool v;
    switch (min(max(ops[r], 0), 5)) {
      case 0: v = s < 0; break;
      case 1: v = s <= 0; break;
      case 2: v = s > 0; break;
      case 3: v = s >= 0; break;
      case 4: v = s == 0; break;
      default: v = s != 0; break;
    }
    verdict[r] = v ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Launches the check on `stream` (PyTorch's current stream) over R rows:
// inst [n_inst, L] and bounds [n_bounds, L] int32 (n_inst, n_bounds, L >= 1),
// a_idx/b_idx/ops [R] int32 or null, verdict [R] uint8 or null, sign [R]
// int32 or null, all on the current device. Returns the first CUDA error
// (cudaGetLastError() after the launch), or 0.
int trivy_verscmp_launch(const int32_t* inst, int n_inst, const int32_t* bounds, int n_bounds,
                         int L, const int32_t* a_idx, const int32_t* b_idx,
                         const int32_t* ops, int R, uint8_t* verdict, int32_t* sign,
                         void* stream) {
  if (R <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((static_cast<long long>(R) + kWarps - 1) / kWarps);
  verscmp_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      inst, n_inst, bounds, n_bounds, L, a_idx, b_idx, ops, R, verdict, sign);
  return static_cast<int>(cudaGetLastError());
}

const char* trivy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
