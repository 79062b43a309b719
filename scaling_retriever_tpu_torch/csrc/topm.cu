// Per-block top-m selection, exact, with no extraction rounds.
//
// Replaces scaling_retriever_tpu/ops/pallas_topm.py::_topm_kernel (B5).
// For every row and every `block`-wide block of an f32 [nq, n] slab, the
// reference runs m rounds of (block max -> lowest lane holding it -> mask
// it to -inf). On its domain (f32, no NaN) that equals a closed form:
//   F = the lanes whose value is > -inf, ordered by (value desc, lane asc);
//   slot j < min(m, |F|) holds (value, lane) of F[j];
//   every slot j >= |F| holds (-inf, 0): once the finite values are gone
//   every lane is -inf, and the lowest lane holding the max is lane 0.
// Equal values tie to the lower lane, and -0.0 equals +0.0 (the reference
// compares floats with == and max). A kept -0.0 comes out as +0.0, which
// compares equal. The form is order-free, so any exact parallel selection
// gives the reference's output bit for bit.
//
// What bounds it on an H100: bytes. It reads the slab once (4 B per slot)
// and writes 8 B per kept entry; the selection is a few integer operations
// per slot. A design that runs the reference's m serial rounds per block
// (each two warp-shuffle argmax trees, two __syncthreads() and a 16-lane
// rescan by the one thread that owned the winner while the other 255
// wait) is bound by latency and barriers, not bytes: on an H100 it took
// 3.8x this kernel's time on the engine slab.
//
// Design: persistent CTAs of 256 threads, as many as fit on the card at
// once, each walking the (row, block) pairs with the grid's stride.
//   1. A block reaches shared memory by cp.async, issued while the CTA is
//      still selecting its previous block, so loads overlap selection.
//      Each thread moves its float4s (16 floats at block 4096) into
//      registers as order-preserving uint32 keys: -0.0 -> +0.0 first; -inf
//      gets the lowest key of any value and is never kept.
//   2. Bounds: H, the block's largest key, and L, a lower bound on K, the
//      m-th largest key (in each warp, ceil(m/8) lanes hold a key >= the
//      warp's ceil(m/8)-th largest lane maximum, so at least m keys are >=
//      the least of those over the 8 warps). Every winner lies in [L, H]:
//      keys below L are never counted, and the bits above the highest bit
//      where L and H differ are K's already. A block of ties has L == H and
//      needs no radix pass.
//   3. Radix-select K over the bits left, 8 at a time from the top: a
//      256-bin shared histogram per pass, filled with predicated shared
//      atomics by the keys of the current bucket (on scored slabs the bound
//      leaves from m to a few m of them, so conflicts are rare), then one
//      warp scans the bins for the digit that holds the rank still sought.
//      Two barriers a pass, at most four passes, all over registers. The
//      search ends early when the chosen bin holds exactly the keys still
//      needed (all of them are kept) or when the bucket's keys are all
//      equal (they are K). Fewer than m finite lanes: every one is kept.
//   4. The keys > K (fewer than m) go to shared memory through a shared
//      counter; the lanes holding K are marked in a bitmap in lane order.
//   5. A kept key's slot is the number of kept keys that beat it on (key
//      desc, lane asc). One warp walks the bitmap with a warp prefix count
//      and writes the lowest tied lanes into the next slots (exact when
//      every lane ties), or (-inf, 0) past |F|.
// Limits: block a multiple of 128 in [128, 16384], 1 <= m <= min(128,
// block), nq * n/block < 2^31.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;  // one bin per thread
constexpr int kMaxBlock = 16384;
constexpr int kMaxM = 128;
constexpr unsigned kFull = 0xffffffffu;

constexpr uint32_t kNegInf = 0x007fffffu;  // the key of -inf

// Order-preserving: positive floats set the top bit, negative ones flip
// every bit. x + 0.0f maps -0.0 to +0.0 and leaves every other value.
__device__ __forceinline__ uint32_t to_key(float x) {
  const uint32_t b = __float_as_uint(x + 0.0f);
  return b ^ (static_cast<uint32_t>(static_cast<int32_t>(b) >> 31) |
              0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

__device__ __forceinline__ int warp_incl_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ uint32_t low_bits(int r) {
  return r >= 32 ? 0xffffffffu : (1u << r) - 1u;
}

// Copy this thread's float4s of block `slab` into `stage` asynchronously
// (cp.async, 16 bytes each, cached in L2 only).
template <int V4>
__device__ __forceinline__ void stage_block(float4* stage, const float* s,
                                            int64_t slab, int block, int n4) {
  const float4* src = reinterpret_cast<const float4*>(s + slab * block);
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const int f = threadIdx.x + j * kThreads;
    if (f < n4) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(stage + f));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(src + f)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// V4: float4s per thread (block <= V4 * 4 * kThreads). Float4 f = tid + j *
// kThreads holds lanes 4f .. 4f + 3; key[4j + c] is lane 4f + c. Each CTA
// walks blocks blockIdx.x, + gridDim.x, ...; the next block's copy into
// `stage` runs while this one is selected.
template <int V4>
__global__ void __launch_bounds__(kThreads, V4 <= 4 ? 8 : 32 / V4)
    topm_kernel(const float* __restrict__ s, float* __restrict__ vals,
                int32_t* __restrict__ idxs, int32_t block, int32_t m,
                int32_t nslab) {
  extern __shared__ float4 stage[];
  __shared__ __align__(16) int hist[2][kBins];
  __shared__ __align__(16) uint32_t bnd_lo[kWarps];
  __shared__ __align__(16) uint32_t bnd_hi[kWarps];
  __shared__ uint32_t wmin[kWarps], wmax[kWarps];
  __shared__ uint32_t tie_bits[kMaxBlock / 32];
  __shared__ uint32_t skey[kMaxM];
  __shared__ int slane[kMaxM];
  __shared__ int part[kMaxM];
  __shared__ int sel_digit, sel_above, sel_count, nkept;
  __shared__ uint32_t sel_min, sel_max;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n4 = block >> 2;

  if (static_cast<int>(blockIdx.x) < nslab) {
    stage_block<V4>(stage, s, blockIdx.x, block, n4);
  }
  for (int64_t slab = blockIdx.x; slab < nslab; slab += gridDim.x) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    uint32_t key[4 * V4];
    uint32_t mx = 0u;
#pragma unroll
    for (int j = 0; j < V4; ++j) {
      const int f = tid + j * kThreads;
      if (f < n4) {
        const float4 x = stage[f];
        key[4 * j] = to_key(x.x);
        key[4 * j + 1] = to_key(x.y);
        key[4 * j + 2] = to_key(x.z);
        key[4 * j + 3] = to_key(x.w);
      } else {  // past the block: below every key
        key[4 * j] = key[4 * j + 1] = key[4 * j + 2] = key[4 * j + 3] = 0u;
      }
      mx = max(mx, max(max(key[4 * j], key[4 * j + 1]),
                       max(key[4 * j + 2], key[4 * j + 3])));
    }

    // L, a lower bound on K: in each warp, ceil(m / kWarps) lanes hold a
    // key >= the warp's ceil(m / kWarps)-th largest lane maximum, so at
    // least m keys are >= the least of those. H, the block's largest key.
    // Every key that can win lies in [L, H], so the bits above the highest
    // bit where L and H differ are K's and the search starts below them.
    {
      uint32_t x = mx, wl = 0u;
      for (int t = 0; t <= (m - 1) / kWarps; ++t) {  // drop the largest
        wl = __reduce_max_sync(kFull, x);
        if (lane == __ffs(__ballot_sync(kFull, x == wl)) - 1) x = 0u;
      }
      const uint32_t wh = __reduce_max_sync(kFull, mx);
      if (lane == 0) {
        bnd_lo[warp] = wl;
        bnd_hi[warp] = wh;
      }
    }
    hist[0][tid] = 0;
    if (tid == 0) nkept = 0;
    __syncthreads();
    // every thread has read its part of `stage`: fetch the next block
    if (slab + gridDim.x < nslab) {
      stage_block<V4>(stage, s, slab + gridDim.x, block, n4);
    }
    uint32_t lo0, hi;
    {
      const uint4 l0 = reinterpret_cast<const uint4*>(bnd_lo)[0];
      const uint4 l1 = reinterpret_cast<const uint4*>(bnd_lo)[1];
      const uint4 h0 = reinterpret_cast<const uint4*>(bnd_hi)[0];
      const uint4 h1 = reinterpret_cast<const uint4*>(bnd_hi)[1];
      lo0 = min(min(min(l0.x, l0.y), min(l0.z, l0.w)),
                min(min(l1.x, l1.y), min(l1.z, l1.w)));
      hi = max(max(max(h0.x, h0.y), max(h0.z, h0.w)),
               max(max(h1.x, h1.y), max(h1.z, h1.w)));
    }
    lo0 = max(lo0, kNegInf + 1u);  // -inf is never kept

    // radix select; the bucket is the keys in [max(prefix, lo0), prefix |
    // low_bits(r)], r the bits of K still unknown, rem the rank (from 1) of
    // K inside the bucket
    int r = hi <= kNegInf ? 0 : 32 - __clz(lo0 ^ hi);
    uint32_t prefix = hi & ~low_bits(r);
    int rem = m;
    uint32_t lo = lo0;  // keys >= lo are kept outright
    bool done = hi <= kNegInf;  // every lane is -inf: nothing is kept
#pragma unroll 1
    for (int pass = 0; !done && r > 0; ++pass) {
      const int width = r < 8 ? r : 8;
      const int shift = r - width;
      const uint32_t a = max(prefix, lo0);
      const uint32_t span = (prefix | low_bits(r)) - a;
      int* h = hist[pass & 1];
      uint32_t bmin = 0xffffffffu, bmax = 0u;
#pragma unroll
      for (int i = 0; i < 4 * V4; ++i) {
        if (key[i] - a <= span) {
          atomicAdd(&h[(key[i] >> shift) & low_bits(width)], 1);
          bmin = min(bmin, key[i]);
          bmax = max(bmax, key[i]);
        }
      }
      bmin = __reduce_min_sync(kFull, bmin);
      bmax = __reduce_max_sync(kFull, bmax);
      if (lane == 0) {
        wmin[warp] = bmin;
        wmax[warp] = bmax;
      }
      hist[(pass + 1) & 1][tid] = 0;
      __syncthreads();
      if (warp == 0) {
        // lane l sums bins 255 - 8l down to 248 - 8l; a warp scan finds the
        // bin holding the rem-th key from the top
        const int4* hv = reinterpret_cast<const int4*>(h);
        const int4 u = hv[63 - 2 * lane];
        const int4 v = hv[62 - 2 * lane];
        const int c[8] = {u.w, u.z, u.y, u.x, v.w, v.z, v.y, v.x};
        int sum = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) sum += c[q];
        const int incl = warp_incl_scan(sum, lane);
        int acc = incl - sum;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (acc < rem && acc + c[q] >= rem) {
            sel_digit = 255 - 8 * lane - q;
            sel_above = acc;
            sel_count = c[q];
          }
          acc += c[q];
        }
        if (lane == 31 && incl < rem) sel_digit = -1;  // first pass only
        bmin = __reduce_min_sync(kFull, lane < kWarps ? wmin[lane] : 0xffffffffu);
        bmax = __reduce_max_sync(kFull, lane < kWarps ? wmax[lane] : 0u);
        if (lane == 0) {
          sel_min = bmin;
          sel_max = bmax;
        }
      }
      __syncthreads();
      const int digit = sel_digit;
      if (digit < 0) break;  // fewer than m finite lanes: keep every one
      rem -= sel_above;
      r = shift;
      prefix |= static_cast<uint32_t>(digit) << shift;
      if (sel_min == sel_max) {  // every key of the bucket is K
        prefix = sel_min;
        r = 0;
      }
      if (sel_count == rem) {  // the whole bucket is kept
        lo = max(prefix, lo0);
        done = true;
      }
    }
    uint32_t tie = 0u;  // K, when its lowest `need` lanes fill the last slots
    int need = 0;
    if (!done && r == 0) {
      lo = prefix + 1u;
      tie = prefix;
      need = rem;
    }

    // compact the kept keys; mark the tied lanes in lane order
#pragma unroll
    for (int i = 0; i < 4 * V4; ++i) {
      if (key[i] >= lo) {
        const int pos = atomicAdd(&nkept, 1);
        skey[pos] = key[i];
        slane[pos] = 4 * (tid + (i >> 2) * kThreads) + (i & 3);
      }
    }
    if (need > 0) {
#pragma unroll
      for (int j = 0; j < V4; ++j) {
        uint32_t w = 0u;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          w |= static_cast<uint32_t>(key[4 * j + c] == tie) << c;
        }
        w <<= 4 * (lane & 7);
        w |= __shfl_xor_sync(kFull, w, 1);
        w |= __shfl_xor_sync(kFull, w, 2);
        w |= __shfl_xor_sync(kFull, w, 4);
        const int f = tid + j * kThreads;
        if ((lane & 7) == 0 && f < n4) tie_bits[f >> 3] = w;
      }
    }
    __syncthreads();

    // rank = the kept keys that beat this one on (key desc, lane asc);
    // entry i is counted by thread i over the first half of the kept keys
    // and by thread i + 128 over the second
    const int kept = nkept;
    const int half = (kept + 1) >> 1;
    const int i = tid & (kMaxM - 1);
    int rank = 0;
    uint32_t ki = 0u;
    int li = 0;
    if (i < kept) {
      ki = skey[i];
      li = slane[i];
      const int j1 = tid < kMaxM ? half : kept;
      for (int j = tid < kMaxM ? 0 : half; j < j1; ++j) {
        const uint32_t kj = skey[j];
        rank += kj > ki || (kj == ki && slane[j] < li);
      }
      if (tid >= kMaxM) part[i] = rank;
    }
    __syncthreads();
    float* vout = vals + slab * m;
    int32_t* iout = idxs + slab * m;
    if (tid < kMaxM && i < kept) {
      rank += part[i];
      vout[rank] = from_key(ki);
      iout[rank] = li;
    }
    if (warp == kWarps - 1) {
      if (need > 0) {
        const float tv = from_key(tie);
        const int nwords = block >> 5;
        int taken = 0;
        for (int w0 = 0; w0 < nwords && taken < need; w0 += 32) {
          uint32_t word = w0 + lane < nwords ? tie_bits[w0 + lane] : 0u;
          const int c = __popc(word);
          const int incl = warp_incl_scan(c, lane);
          int q = taken + incl - c;
          while (word != 0u && q < need) {
            const int b = __ffs(word) - 1;
            word &= word - 1u;
            vout[kept + q] = tv;
            iout[kept + q] = 32 * (w0 + lane) + b;
            ++q;
          }
          taken += __shfl_sync(kFull, incl, 31);
        }
      } else {
        for (int j = kept + lane; j < m; j += 32) {
          vout[j] = __uint_as_float(0xff800000u);
          iout[j] = 0;
        }
      }
    }
  }
}

template <int V4>
int launch(const float* s, float* vals, int32_t* idxs, int32_t nslab,
           int32_t block, int32_t m, cudaStream_t stream) {
  // one wave of resident CTAs, each walking the blocks with a stride
  static int per_sm = 0, sms = 0;
  const int max_smem = V4 * 4 * kThreads * static_cast<int>(sizeof(float));
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaFuncSetAttribute(
        topm_kernel<V4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        max_smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, topm_kernel<V4>, kThreads, max_smem);
    }
    if (e != cudaSuccess || per_sm < 1) {
      per_sm = 0;
      return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
    }
  }
  const int grid = nslab < per_sm * sms ? nslab : per_sm * sms;
  const int smem = block * static_cast<int>(sizeof(float));
  topm_kernel<V4><<<grid, kThreads, smem, stream>>>(s, vals, idxs, block, m,
                                                   nslab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaErrorInvalidValue for shapes the kernel does not take; the
// Python wrapper checks them first and raises with a message.
extern "C" int srt_topm(const float* s, float* vals, int32_t* idxs, int64_t nq,
                        int32_t nblk, int32_t block, int32_t m,
                        cudaStream_t stream) {
  const int64_t nslab = nq * nblk;
  if (block < 128 || block > kMaxBlock || block % 128 != 0 || m < 1 ||
      m > kMaxM || m > block || nq < 1 || nblk < 1 || nslab > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int v4 = (block / 4 + kThreads - 1) / kThreads;
  const int32_t n = static_cast<int32_t>(nslab);
  if (v4 <= 1) return launch<1>(s, vals, idxs, n, block, m, stream);
  if (v4 <= 2) return launch<2>(s, vals, idxs, n, block, m, stream);
  if (v4 <= 4) return launch<4>(s, vals, idxs, n, block, m, stream);
  if (v4 <= 8) return launch<8>(s, vals, idxs, n, block, m, stream);
  return launch<16>(s, vals, idxs, n, block, m, stream);
}
