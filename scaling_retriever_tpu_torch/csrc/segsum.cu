// Fused segmented sum + run-end mask for the segsort rank tail.
//
// Replaces scaling_retriever_tpu/ops/pallas_segsum.py::_segsum_kernel (B4).
// Input: per query, doc ids sorted ascending (srow) and their f32
// contributions. Output: each run's sum at the run's last slot; -inf at
// every other slot and at every slot of a sentinel run.
//
// What bounds it on an H100: bytes. It reads two [nq, P] 4-byte slabs and
// writes one; the adds are a handful per slot. The least time is
// 12 * nq * P bytes / HBM bandwidth.
//
// Design: one thread per slot, grid-stride. A slot that ends a non-sentinel
// run walks back over its run and sums it; runs hold at most one posting per
// query term, so the walk is short (the caller's eligible() bounds real runs
// at max_run <= 128) and its reads hit lines the neighbouring threads have
// just loaded. Sentinel runs, which can span most of a row, are never
// walked. There is no carry between blocks and no second pass. The sum runs
// right to left, so it rounds differently from the reference's
// Hillis-Steele tree; on dyadic inputs the two agree bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) segsum_kernel(
    const int32_t* __restrict__ srow, const float* __restrict__ scontrib,
    float* __restrict__ out, int64_t n, int64_t P, int32_t sentinel) {
  const float neg_inf = -__int_as_float(0x7f800000);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < n; g += stride) {
    const int64_t i = g % P;
    const int32_t k = srow[g];
    float r = neg_inf;
    if (k != sentinel && (i == P - 1 || srow[g + 1] != k)) {
      float s = scontrib[g];
      for (int64_t j = g - 1, left = i; left > 0 && srow[j] == k; --j, --left) {
        s = __fadd_rn(s, scontrib[j]);
      }
      r = s;
    }
    out[g] = r;
  }
}

}  // namespace

extern "C" int srt_segsum(const int32_t* srow, const float* scontrib,
                          float* out, int64_t nq, int64_t P, int32_t sentinel,
                          cudaStream_t stream) {
  const int64_t n = nq * P;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = 1 << 20;
  segsum_kernel<<<static_cast<unsigned>(blocks < cap ? blocks : cap), kThreads,
                  0, stream>>>(srow, scontrib, out, n, P, sentinel);
  return static_cast<int>(cudaGetLastError());
}
