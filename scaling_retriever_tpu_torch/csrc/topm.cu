// Per-block top-m selection.
//
// Replaces scaling_retriever_tpu/ops/pallas_topm.py::_topm_kernel (B5).
// For every row and every `block`-wide block of an f32 [nq, n] slab: m
// rounds of (block max -> lowest index holding it -> mask it to -inf).
// Outputs the m values in extraction order and their block-local indices.
// Once a block has fewer than m finite values left, every later round
// finds only -inf lanes and returns lane 0 (the lowest -inf lane, already
// taken); this is the reference's behaviour and is kept exactly.
//
// What bounds it on an H100: bytes. It reads the slab once (4 B per slot)
// and writes 8 B per kept entry; at block 4096 and m 32 the per-slot work
// is a few compares, far below the card's compute rate.
//
// Design: one CTA of 256 threads per (row, block). The block is loaded into
// shared memory with 16-byte loads (16 KB at block 4096). Each thread owns
// the lanes tid, tid + 256, ... and keeps the best (value, lowest index) of
// them; a round is one warp-shuffle argmax plus one across the 8 warps, and
// only the thread owning the winner rescans its 16 lanes. Ties break to the
// lower index at every step, as in the reference.
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

__global__ void __launch_bounds__(kThreads) topm_kernel(
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

// Returns cudaErrorInvalidValue for shapes the kernel does not take; the
// Python wrapper checks them first and raises with a message.
extern "C" int srt_topm(const float* s, float* vals, int32_t* idxs, int64_t nq,
                        int32_t nblk, int32_t block, int32_t m,
                        cudaStream_t stream) {
  const int smem = block * static_cast<int>(sizeof(float));
  if (block % (4 * kThreads) != 0 || smem > 48 * 1024 || m < 1 || m > block ||
      nq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(nblk), static_cast<unsigned>(nq));
  topm_kernel<<<grid, kThreads, smem, stream>>>(s, vals, idxs, nblk, block, m);
  return static_cast<int>(cudaGetLastError());
}
