// Posting fetch for the segsort engine: one CHUNK-posting window per job.
//
// Replaces scaling_retriever_tpu/ops/pallas_fetch.py::_fetch_kernel (B1,
// two streams: doc rows and f32 value bits) and ::_fetch_kernel_q8 (B2,
// one stream of (row24 << 8) | code8 words).
//
// What bounds it on an H100: bytes. Each job reads at most CHUNK postings
// (8 B each for f32, 4 B for q8) and writes CHUNK (row, contribution)
// pairs (8 B each); there is no arithmetic to speak of. The least time is
// (valid postings read + slots written) / HBM bandwidth.
//
// Design: one CTA per job (grid-stride over jobs), 256 threads, each
// thread owning 4 consecutive slots, so every load and store is one
// 16-byte vector access. Job sources are ALIGN(=1024)-aligned, which keeps
// the int4 loads aligned. The valid-range mask, the sentinel row and the
// query-weight multiply that the JAX package runs as separate passes over
// the [nq, J * CHUNK] slab are fused here: slots outside the job's valid
// range are written without reading the index at all, so idle job slots
// cost only their stores. Addresses are 64-bit: byte offsets into a
// 1.13B-posting array exceed 2^31.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;
constexpr int kThreads = kChunk / 4;

// Valid slots of this job, in job-local coordinates [lo, hi).
__device__ __forceinline__ void job_window(const int32_t* jv_start,
                                           const int32_t* jv_end,
                                           int64_t job, int32_t jobs_per_query,
                                           int32_t* lo, int32_t* hi) {
  const int32_t base = static_cast<int32_t>(job % jobs_per_query) * kChunk;
  *lo = jv_start[job] - base;
  *hi = jv_end[job] - base;
}

__global__ void __launch_bounds__(kThreads) fetch_f32_kernel(
    const int64_t* __restrict__ src, const int32_t* __restrict__ jv_start,
    const int32_t* __restrict__ jv_end, const float* __restrict__ jqv,
    const int32_t* __restrict__ rows_flat,
    const int32_t* __restrict__ valbits_flat, int32_t* __restrict__ rows_out,
    float* __restrict__ contrib_out, int64_t total_jobs,
    int32_t jobs_per_query, int32_t sentinel) {
  const int e = threadIdx.x * 4;
  for (int64_t job = blockIdx.x; job < total_jobs; job += gridDim.x) {
    int32_t lo, hi;
    job_window(jv_start, jv_end, job, jobs_per_query, &lo, &hi);
    int4 r = make_int4(sentinel, sentinel, sentinel, sentinel);
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e + 4 > lo && e < hi) {
      const float qw = jqv[job];
      const int64_t off = src[job] + e;
      if (e >= lo && e + 4 <= hi) {
        r = __ldcs(reinterpret_cast<const int4*>(rows_flat + off));
        const int4 v = __ldcs(reinterpret_cast<const int4*>(valbits_flat + off));
        c = make_float4(__fmul_rn(__int_as_float(v.x), qw),
                        __fmul_rn(__int_as_float(v.y), qw),
                        __fmul_rn(__int_as_float(v.z), qw),
                        __fmul_rn(__int_as_float(v.w), qw));
      } else {  // ragged edge of the valid range
        int32_t rv[4];
        float cv[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const bool ok = e + t >= lo && e + t < hi;
          rv[t] = ok ? rows_flat[off + t] : sentinel;
          cv[t] = ok ? __fmul_rn(__int_as_float(valbits_flat[off + t]), qw)
                     : 0.f;
        }
        r = make_int4(rv[0], rv[1], rv[2], rv[3]);
        c = make_float4(cv[0], cv[1], cv[2], cv[3]);
      }
    }
    const int64_t dst = job * kChunk + e;
    *reinterpret_cast<int4*>(rows_out + dst) = r;
    *reinterpret_cast<float4*>(contrib_out + dst) = c;
  }
}

// q8 word -> (row, code); the shift is on the unsigned word, since rows
// >= 2^23 set the sign bit of the packed int32.
__device__ __forceinline__ void decode_q8(int32_t w, float qw, int32_t* row,
                                          float* contrib) {
  const uint32_t u = static_cast<uint32_t>(w);
  *row = static_cast<int32_t>(u >> 8);
  *contrib = __fmul_rn(static_cast<float>(u & 0xFFu), qw);
}

__global__ void __launch_bounds__(kThreads) fetch_q8_kernel(
    const int64_t* __restrict__ src, const int32_t* __restrict__ jv_start,
    const int32_t* __restrict__ jv_end, const float* __restrict__ jqv,
    const int32_t* __restrict__ packed_flat, int32_t* __restrict__ rows_out,
    float* __restrict__ contrib_out, int64_t total_jobs,
    int32_t jobs_per_query, int32_t sentinel) {
  const int e = threadIdx.x * 4;
  for (int64_t job = blockIdx.x; job < total_jobs; job += gridDim.x) {
    int32_t lo, hi;
    job_window(jv_start, jv_end, job, jobs_per_query, &lo, &hi);
    int32_t rv[4] = {sentinel, sentinel, sentinel, sentinel};
    float cv[4] = {0.f, 0.f, 0.f, 0.f};
    if (e + 4 > lo && e < hi) {
      const float qw = jqv[job];
      const int64_t off = src[job] + e;
      if (e >= lo && e + 4 <= hi) {
        const int4 w = __ldcs(reinterpret_cast<const int4*>(packed_flat + off));
        decode_q8(w.x, qw, &rv[0], &cv[0]);
        decode_q8(w.y, qw, &rv[1], &cv[1]);
        decode_q8(w.z, qw, &rv[2], &cv[2]);
        decode_q8(w.w, qw, &rv[3], &cv[3]);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (e + t >= lo && e + t < hi) {
            decode_q8(packed_flat[off + t], qw, &rv[t], &cv[t]);
          }
        }
      }
    }
    const int64_t dst = job * kChunk + e;
    *reinterpret_cast<int4*>(rows_out + dst) = make_int4(rv[0], rv[1], rv[2], rv[3]);
    *reinterpret_cast<float4*>(contrib_out + dst) =
        make_float4(cv[0], cv[1], cv[2], cv[3]);
  }
}

unsigned grid_for(int64_t total_jobs) {
  const int64_t cap = 1 << 20;
  return static_cast<unsigned>(total_jobs < cap ? total_jobs : cap);
}

}  // namespace

extern "C" int srt_fetch_f32(const int64_t* src, const int32_t* jv_start,
                             const int32_t* jv_end, const float* jqv,
                             const int32_t* rows_flat,
                             const int32_t* valbits_flat, int32_t* rows_out,
                             float* contrib_out, int64_t total_jobs,
                             int32_t jobs_per_query, int32_t sentinel,
                             cudaStream_t stream) {
  fetch_f32_kernel<<<grid_for(total_jobs), kThreads, 0, stream>>>(
      src, jv_start, jv_end, jqv, rows_flat, valbits_flat, rows_out,
      contrib_out, total_jobs, jobs_per_query, sentinel);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_fetch_q8(const int64_t* src, const int32_t* jv_start,
                            const int32_t* jv_end, const float* jqv,
                            const int32_t* packed_flat, int32_t* rows_out,
                            float* contrib_out, int64_t total_jobs,
                            int32_t jobs_per_query, int32_t sentinel,
                            cudaStream_t stream) {
  fetch_q8_kernel<<<grid_for(total_jobs), kThreads, 0, stream>>>(
      src, jv_start, jv_end, jqv, packed_flat, rows_out, contrib_out,
      total_jobs, jobs_per_query, sentinel);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
