// A Kimi Delta Attention layer's mixing after its projections, as one launch
// a layer: for each (text, head), from the raw projections q, k, v (bf16),
//
//   x_t     = the projection at t, 0 at a pad position
//   y_t     = SiLU(sum_i w[K - 1 - i] x_{t - i})        (causal conv, K = 4)
//   q, k    = y's, L2-normalised over the head's 128 channels (eps 1e-6),
//             q also times 128**-0.5; v = y's
//   alpha_t = exp(-exp(A_log[h]) softplus(f_t + dt_bias))   per channel
//   S_t     = (I - beta_t k_t k_t^T) Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T
//   o_t     = S_t^T q_t
//   out_t   = RMSNorm(o_t) w_norm sigmoid(gate_t)            (eps given)
//
// with S [128 x 128] zero at the first position (the gated delta rule).
// ops/kda.py holds the same steps in plain PyTorch.
//
// Replaces no TPU kernel: the JAX package has no linear-attention layer. It
// exists because the serving tile runs as one CUDA graph
// (models/tile_graphs.py), and a token loop of PyTorch ops would be
// thousands of tiny launches a tile; and because the convolutions, norms
// and gates around the recurrence, run as PyTorch ops, each pass over
// [tokens, 4096] activations in float32, cost a 64 x 64 tile several times
// the recurrence's own time.
//
// What bounds it on an H100: the recurrence is 3 multiply-adds a state entry
// a position (decay and read k, write the rank-1 update, read q), 2 * 3 *
// 128 * 128 FLOP a (position, head) on CUDA cores in float32, against q, k,
// v, f, the gate and the output (bf16) read or written once. At a 64 x 64
// tile that is 17 GFLOP against 201 MB: ~0.25 ms on the float32 cores at
// full rate, ~60 us at the memory's rate, so this recurrent form is bound
// by the float32 cores; only a chunked form on the tensor cores gets near
// the bytes.
//
// Design: one block of 128 threads a (text, head). Thread (kq, cg), kq =
// lane / 8 the row group, cg = (lane % 8) + 8 * warp the column group, holds
// S's rows 32 kq .. 32 kq + 31 of columns 4 cg .. 4 cg + 3 in registers (128
// floats) for the whole sequence: the state never leaves the chip. Positions
// are staged 16 at a time in shared memory, 16 threads a position and 8
// channels a thread: each convolves its channels over the position and the
// 3 before it (read from global memory, pads as 0), applies SiLU, and the
// 16 threads' sums of squares meet by shuffles for the norms; q, k and alpha
// go to shared memory in float32, each row group padded to 36 floats so the
// four groups a warp reads lie in other banks. Each position then runs with
// no block barrier: a thread decays its rows and sums its part of S^T
// (alpha k) for its four columns, the four row groups' parts meet by warp
// shuffles, each thread writes its rows of the rank-1 update and sums its
// part of S^T q, which meet the same way. A chunk's outputs are normed and
// gated by the staging threads and rounded once to bf16. Every output is the
// same sums in the same order on every run: no atomics.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D = 128;          // head dim of keys and values
constexpr int K = 4;            // the convolutions' width
constexpr int kThreads = 128;
constexpr int kRows = 32;       // key rows a thread holds
constexpr int kCols = 4;        // value columns a thread holds
constexpr int kChunk = 16;      // positions staged in shared memory at a time
constexpr int kPad = 36;        // a row group's stride in shared memory
constexpr int kRowF = 4 * kPad; // one position's q, k or alpha, in floats
constexpr float kNormEps = 1e-6f;
constexpr float kQScale = 0.08838834764831845f;  // 128 ** -0.5

struct Args {
  const __nv_bfloat16 *q, *k, *v;     // raw projections [B, S, H * D]
  const __nv_bfloat16 *f, *gate;      // decay and output-gate inputs, same
  const __nv_bfloat16 *q_conv, *k_conv, *v_conv;  // [H * D, K]
  const __nv_bfloat16* o_norm;        // [D]
  const float* beta;                  // [B, S, H]
  const float *a_log, *dt_bias;       // [H], [H * D]
  const int32_t* mask;                // [B, S], 0 at pads
  __nv_bfloat16* out;                 // [B, S, H * D]
  int S, H;
  float eps;
};

struct Stage {
  float q[kChunk][kRowF];
  float k[kChunk][kRowF];
  float a[kChunk][kRowF];
  float v[kChunk][D];
  float o[kChunk][D];
  float beta[kChunk];
  float keep[kChunk + K - 1];  // positions t0 - 3 .. t0 + 15: 1 real, 0 not
};

__device__ __forceinline__ void load8_bf16(const __nv_bfloat16* src,
                                           float f[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void load8_f32(const float* src, float f[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float f[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// the sum over the 16 lanes that hold one position's row (lanes 0-15 or
// 16-31 of the warp)
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int d = 8; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

// SiLU of the causal convolution at position t of channels c .. c + 7 of
// x [B, S, W] (row ``row`` of a text's first position); keep[i] is 1 where
// position t - K + 1 + i is real, 0 at a pad or before the text. The K
// loads are issued together; 0 where ``valid`` is false.
__device__ __forceinline__ void conv8(const __nv_bfloat16* __restrict__ x,
                                      const __nv_bfloat16* __restrict__ w,
                                      const float* keep, int64_t row, int t,
                                      int c, int W, bool valid, float y[8]) {
  for (int e = 0; e < 8; ++e) y[e] = 0.f;
  if (!valid) return;
  uint4 raw[K];
#pragma unroll
  for (int i = 0; i < K; ++i)
    raw[i] = *reinterpret_cast<const uint4*>(x + (row + max(t - i, 0)) * W +
                                             c);
  float wf[8][K];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint2 wr = *reinterpret_cast<const uint2*>(w + (c + e) * K);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&wr);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    wf[e][0] = a.x, wf[e][1] = a.y, wf[e][2] = b.x, wf[e][3] = b.y;
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float kp = keep[K - 1 - i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 xv = __bfloat1622float2(h[e]);
      y[2 * e] = fmaf(wf[2 * e][K - 1 - i], xv.x * kp, y[2 * e]);
      y[2 * e + 1] = fmaf(wf[2 * e + 1][K - 1 - i], xv.y * kp, y[2 * e + 1]);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) y[e] = y[e] / (1.f + expf(-y[e]));
}

__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));  // torch's threshold
}

// the sum over the four row groups that share a thread's columns
__device__ __forceinline__ float sum_rows(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 16);
  return x;
}

__global__ void __launch_bounds__(kThreads) kda_recurrent_kernel(
    const Args args) {
  __shared__ __align__(16) Stage st;
  const int S = args.S, H = args.H, W = H * D;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kq = lane >> 3;
  const int c0 = ((lane & 7) + 8 * warp) * kCols;
  const int64_t row = static_cast<int64_t>(b) * S;  // the text's first
  const float a_h = expf(args.a_log[h]);
  float s[kRows][kCols];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[j][c] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();  // the last chunk's stage is read out
    if (tid < kChunk + K - 1) {
      const int t = t0 - (K - 1) + tid;
      st.keep[tid] = t >= 0 && t < S && args.mask[row + t] != 0 ? 1.f : 0.f;
    }
    __syncthreads();
    // stage: 16 threads a position, 8 channels a thread
#pragma unroll
    for (int pass = 0; pass < kChunk * 16 / kThreads; ++pass) {
      const int idx = pass * kThreads + tid;
      const int p = idx >> 4, c8 = (idx & 15) * 8;
      const bool valid = p < n;
      const int t = t0 + p, c = h * D + c8;
      const int off = (c8 >> 5) * kPad + (c8 & 31);
      float f[8];
      // q: normalised, then scaled
      conv8(args.q, args.q_conv, &st.keep[p], row, t, c, W, valid, f);
      float ss = 0.f;
      for (int i = 0; i < 8; ++i) ss += f[i] * f[i];
      float r = rsqrtf(sum16(ss) + kNormEps) * kQScale;
      for (int i = 0; i < 8; ++i) f[i] *= r;
      store8(&st.q[p][off], f);
      // k: normalised
      conv8(args.k, args.k_conv, &st.keep[p], row, t, c, W, valid, f);
      ss = 0.f;
      for (int i = 0; i < 8; ++i) ss += f[i] * f[i];
      r = rsqrtf(sum16(ss) + kNormEps);
      for (int i = 0; i < 8; ++i) f[i] *= r;
      store8(&st.k[p][off], f);
      conv8(args.v, args.v_conv, &st.keep[p], row, t, c, W, valid, f);
      store8(&st.v[p][c8], f);
      // the decay factor exp(-exp(A_log) softplus(f + dt_bias))
      if (valid) {
        float dt[8];
        load8_bf16(args.f + (row + t) * W + c, f);
        load8_f32(args.dt_bias + c, dt);
        for (int i = 0; i < 8; ++i) f[i] = expf(-a_h * softplus(f[i] + dt[i]));
      } else {
        for (int i = 0; i < 8; ++i) f[i] = 0.f;
      }
      store8(&st.a[p][off], f);
    }
    if (tid < kChunk)
      st.beta[tid] = tid < n ? args.beta[(row + t0 + tid) * H + h] : 0.f;
    __syncthreads();

    for (int p = 0; p < n; ++p) {
      const float* qa = &st.q[p][kq * kPad];
      const float* ka = &st.k[p][kq * kPad];
      const float* aa = &st.a[p][kq * kPad];
      float u[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kRows; j += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(aa + j);
        const float4 k4 = *reinterpret_cast<const float4*>(ka + j);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            s[j + jj][c] *= av[jj];
            u[c] = fmaf(s[j + jj][c], kv[jj], u[c]);
          }
      }
      const float4 v4 = *reinterpret_cast<const float4*>(&st.v[p][c0]);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
      const float bt = st.beta[p];
      float dlt[kCols], o[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dlt[c] = bt * (vv[c] - sum_rows(u[c]));
        o[c] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRows; j += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(ka + j);
        const float4 q4 = *reinterpret_cast<const float4*>(qa + j);
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
        const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            s[j + jj][c] = fmaf(kv[jj], dlt[c], s[j + jj][c]);
            o[c] = fmaf(s[j + jj][c], qv[jj], o[c]);
          }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[c] = sum_rows(o[c]);
      if (kq == 0)
        *reinterpret_cast<float4*>(&st.o[p][c0]) =
            make_float4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();
    // the chunk's outputs: normed over the head, gated, rounded once
#pragma unroll
    for (int pass = 0; pass < kChunk * 16 / kThreads; ++pass) {
      const int idx = pass * kThreads + tid;
      const int p = idx >> 4, c8 = (idx & 15) * 8;
      float o[8];
      load8_f32(&st.o[p][c8], o);
      float ss = 0.f;
      for (int i = 0; i < 8; ++i) ss += o[i] * o[i];
      const float r = rsqrtf(sum16(ss) / D + args.eps);
      if (p >= n) continue;
      const int64_t at = (row + t0 + p) * W + h * D + c8;
      float gt[8], wn[8];
      load8_bf16(args.gate + at, gt);
      load8_bf16(args.o_norm + c8, wn);
      uint4 raw;
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = o[2 * i] * r * wn[2 * i] / (1.f + expf(-gt[2 * i]));
        const float z = o[2 * i + 1] * r * wn[2 * i + 1] /
                        (1.f + expf(-gt[2 * i + 1]));
        hv[i] = __floats2bfloat162_rn(a, z);
      }
      *reinterpret_cast<uint4*>(args.out + at) = raw;
    }
  }
}

}  // namespace

// q, k, v, f, gate, out bf16 [B, S, H * 128]; the convolutions bf16 [H * 128,
// 4]; o_norm bf16 [128]; beta float32 [B, S, H]; a_log float32 [H]; dt_bias
// float32 [H * 128]; mask int32 [B, S]; all contiguous.
extern "C" int srt_kda(const void* q, const void* k, const void* v,
                       const void* f, const void* gate, const void* q_conv,
                       const void* k_conv, const void* v_conv,
                       const void* o_norm, const float* beta,
                       const float* a_log, const float* dt_bias,
                       const int32_t* mask, void* out, int32_t B, int32_t S,
                       int32_t H, int32_t d, float eps, cudaStream_t stream) {
  if (d != D || B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  using bf = const __nv_bfloat16*;
  const Args args{static_cast<bf>(q), static_cast<bf>(k), static_cast<bf>(v),
                  static_cast<bf>(f), static_cast<bf>(gate),
                  static_cast<bf>(q_conv), static_cast<bf>(k_conv),
                  static_cast<bf>(v_conv), static_cast<bf>(o_norm), beta,
                  a_log, dt_bias, mask, static_cast<__nv_bfloat16*>(out), S,
                  H, eps};
  kda_recurrent_kernel<<<B * H, kThreads, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}
