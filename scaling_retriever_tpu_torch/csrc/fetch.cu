// Posting fetch for the segsort engine: one CHUNK-posting window per job.
//
// Replaces scaling_retriever_tpu/ops/pallas_fetch.py::_fetch_kernel (B1,
// two streams: doc rows and f32 value bits; called from fetch_postings_dma
// and from ops/blockmax.py::blockmax_retrieve_dma), ::_fetch_kernel_q8
// (B2, one stream of (row24 << 8) | code8 words) and ::_fetch_kernel_bf16
// (B3, doc rows plus one int32 word per two little-endian bf16 values,
// CHUNK2 = 2048-posting jobs).
//
// What bounds it on an H100: bytes. Each job reads at most one window of
// postings (8 B each for f32, 4 B for q8, 6 B for bf16 pairs) and writes
// one (row, contribution) pair of 8 B per slot; there is no arithmetic to
// speak of. The least time is (valid postings read + slots written) / HBM
// bandwidth.
//
// Design: one CTA per job (grid-stride over jobs), 256 threads, each
// thread owning 4 consecutive slots per pass, so every load and store is
// one 16-byte vector access (8 bytes for the bf16 value words). Job
// sources are aligned to the job size (1024, or 2048 for bf16), which
// keeps the vector loads aligned and puts a bf16 job's value words at
// src / 2, itself 1024-word aligned. The valid-range mask, the sentinel
// row and the query-weight multiply that the JAX package runs as separate
// passes over the [nq, J * chunk] slab are fused here: slots outside the
// job's valid range are written without reading the index at all, so idle
// job slots cost only their stores. Addresses are 64-bit: byte offsets
// into a 1.13B-posting array exceed 2^31.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;
constexpr int kChunk2 = 2048;  // bf16-pair jobs
constexpr int kThreads = kChunk / 4;

// Valid slots of this job, in job-local coordinates [lo, hi).
template <int kJob = kChunk>
__device__ __forceinline__ void job_window(const int32_t* jv_start,
                                           const int32_t* jv_end,
                                           int64_t job, int32_t jobs_per_query,
                                           int32_t* lo, int32_t* hi) {
  const int32_t base = static_cast<int32_t>(job % jobs_per_query) * kJob;
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

// bf16 halves -> f32: a bf16 is the top 16 bits of an f32. Unsigned
// shifts only; the high half keeps its sign bit through the mask.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// Job j: 2048 rows from src[j] and 1024 value words from src[j] / 2, in two
// passes of 1024 slots (thread t owns slots p*1024 + 4t .. +3 of pass p).
__global__ void __launch_bounds__(kThreads) fetch_bf16_kernel(
    const int64_t* __restrict__ src, const int32_t* __restrict__ jv_start,
    const int32_t* __restrict__ jv_end, const float* __restrict__ jqv,
    const int32_t* __restrict__ rows_flat,
    const int32_t* __restrict__ valpacked_flat,
    int32_t* __restrict__ rows_out, float* __restrict__ contrib_out,
    int64_t total_jobs, int32_t jobs_per_query, int32_t sentinel) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(valpacked_flat);
  for (int64_t job = blockIdx.x; job < total_jobs; job += gridDim.x) {
    int32_t lo, hi;
    job_window<kChunk2>(jv_start, jv_end, job, jobs_per_query, &lo, &hi);
#pragma unroll
    for (int pass = 0; pass < kChunk2 / kChunk; ++pass) {
      const int e = pass * kChunk + threadIdx.x * 4;
      int4 r = make_int4(sentinel, sentinel, sentinel, sentinel);
      float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e + 4 > lo && e < hi) {
        const float qw = jqv[job];
        const int64_t off = src[job] + e;  // even: src and e are
        if (e >= lo && e + 4 <= hi) {
          r = __ldcs(reinterpret_cast<const int4*>(rows_flat + off));
          const uint2 w = __ldcs(reinterpret_cast<const uint2*>(words + off / 2));
          c = make_float4(__fmul_rn(bf16_lo(w.x), qw),
                          __fmul_rn(bf16_hi(w.x), qw),
                          __fmul_rn(bf16_lo(w.y), qw),
                          __fmul_rn(bf16_hi(w.y), qw));
        } else {  // ragged edge of the valid range
          int32_t rv[4];
          float cv[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const bool ok = e + t >= lo && e + t < hi;
            const int64_t p = off + t;
            const uint32_t w = ok ? words[p >> 1] : 0u;
            rv[t] = ok ? rows_flat[p] : sentinel;
            cv[t] = ok ? __fmul_rn((p & 1) ? bf16_hi(w) : bf16_lo(w), qw) : 0.f;
          }
          r = make_int4(rv[0], rv[1], rv[2], rv[3]);
          c = make_float4(cv[0], cv[1], cv[2], cv[3]);
        }
      }
      const int64_t dst = job * kChunk2 + e;
      *reinterpret_cast<int4*>(rows_out + dst) = r;
      *reinterpret_cast<float4*>(contrib_out + dst) = c;
    }
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

extern "C" int srt_fetch_bf16(const int64_t* src, const int32_t* jv_start,
                              const int32_t* jv_end, const float* jqv,
                              const int32_t* rows_flat,
                              const int32_t* valpacked_flat, int32_t* rows_out,
                              float* contrib_out, int64_t total_jobs,
                              int32_t jobs_per_query, int32_t sentinel,
                              cudaStream_t stream) {
  fetch_bf16_kernel<<<grid_for(total_jobs), kThreads, 0, stream>>>(
      src, jv_start, jv_end, jqv, rows_flat, valpacked_flat, rows_out,
      contrib_out, total_jobs, jobs_per_query, sentinel);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
