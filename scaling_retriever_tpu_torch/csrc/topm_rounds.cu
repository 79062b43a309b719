// The earlier design of the per-block top-m kernel (B5), kept only so that
// chip_smoke.py can time it beside the kernel that replaced it (topm.cu)
// in the same run. No wrapper of the port calls it and it has no launch
// count.
//
// One CTA of 256 threads per (row, block), the block in shared memory; m
// rounds of (warp-shuffle argmax over each thread's best, argmax across the
// 8 warps, rescan of its lanes by the thread that owned the winner). Ties
// break to the lower index at every step, as in the reference.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void argmax_shfl(float* v, int* i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, *v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, *i, o);
    if (better(ov, oi, *v, *i)) {
      *v = ov;
      *i = oi;
    }
  }
}

// Best of this thread's lanes; lanes are visited in increasing order, so a
// strict > keeps the lowest index among equal values.
__device__ __forceinline__ void local_best(const float* x, int block, float* bv,
                                           int* bi) {
  *bv = x[threadIdx.x];
  *bi = threadIdx.x;
  for (int j = threadIdx.x + kThreads; j < block; j += kThreads) {
    if (x[j] > *bv) {
      *bv = x[j];
      *bi = j;
    }
  }
}

__global__ void __launch_bounds__(kThreads) topm_rounds_kernel(
    const float* __restrict__ s, float* __restrict__ vals,
    int32_t* __restrict__ idxs, int32_t nblk, int32_t block, int32_t m) {
  extern __shared__ float4 smem4[];
  float* x = reinterpret_cast<float*>(smem4);
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int winner;
  const float neg_inf = -__int_as_float(0x7f800000);

  const int64_t slab = static_cast<int64_t>(blockIdx.y) * nblk + blockIdx.x;
  const float4* src = reinterpret_cast<const float4*>(s + slab * block);
  for (int i = threadIdx.x; i < block / 4; i += kThreads) {
    smem4[i] = __ldcs(src + i);
  }
  __syncthreads();

  float bv;
  int bi;
  local_best(x, block, &bv, &bi);
  float* vout = vals + slab * m;
  int32_t* iout = idxs + slab * m;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = 0; r < m; ++r) {
    float v = bv;
    int i = bi;
    argmax_shfl(&v, &i);
    if (lane == 0) {
      warp_v[warp] = v;
      warp_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? warp_v[lane] : neg_inf;
      i = lane < kWarps ? warp_i[lane] : block;
      argmax_shfl(&v, &i);
      if (lane == 0) {
        vout[r] = v;
        iout[r] = i;
        winner = i;
      }
    }
    __syncthreads();
    const int w = winner;
    if (w % kThreads == static_cast<int>(threadIdx.x)) {
      x[w] = neg_inf;
      local_best(x, block, &bv, &bi);
    }
  }
}

}  // namespace

// Takes block % 1024 == 0, block <= 12288, 1 <= m <= block, nq <= 65535;
// returns cudaErrorInvalidValue otherwise.
extern "C" int srt_topm_rounds(const float* s, float* vals, int32_t* idxs,
                               int64_t nq, int32_t nblk, int32_t block,
                               int32_t m, cudaStream_t stream) {
  const int smem = block * static_cast<int>(sizeof(float));
  if (block % (4 * kThreads) != 0 || smem > 48 * 1024 || m < 1 || m > block ||
      nq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(nblk), static_cast<unsigned>(nq));
  topm_rounds_kernel<<<grid, kThreads, smem, stream>>>(s, vals, idxs, nblk,
                                                      block, m);
  return static_cast<int>(cudaGetLastError());
}
