// The routed-expert layer of a mixture of experts (DeepSeek-V2's MoE), as
// four kernels over device-side offsets: route, the grouped gate/up
// product, the grouped down product, and the combine.
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. It
// exists because the serving tile runs as one CUDA graph
// (models/tile_graphs.py), and a graph cannot read each expert's token
// count back to the host, so the eager per-expert product loop cannot run
// there. Every size a launch depends on is the worst case (N * k slots),
// so one captured graph serves every routing.
//
// What bounds it on an H100: per layer it reads all E experts' weights
// (E * 3 * H * I bf16: 1.107 GB at DeepSeek-V2-Lite's widths) and does
// 2 * 3 * H * I multiply-adds a slot. At N * k slots spread over E
// experts that is 6 * N * k * H * I FLOP over E * 6 * H * I bytes, or
// N * k / E FLOP a byte: above the card's ridge (~295) from about 300 slots
// an expert (a 64 x 64 tile), bound by bytes below it (an 8 x 64 tile).
//
// Design:
//  * moe_route_kernel: one block an expert. Expert e's offset is the count
//    of slots routed to experts below e; a second pass compacts its slots
//    in slot order with warp ballots (no atomics, so the order is
//    deterministic), writing the expert-sorted slot list and its inverse,
//    and adds the expert's count to a persistent load counter.
//  * moe_expert_up_kernel / moe_expert_down_kernel: a 128 x 128 output
//    tile a block, 8 warps of mma.sync m16n8k16 (bf16 in, f32 sums),
//    operands staged through a 4-deep cp.async ring in shared memory with
//    an XOR swizzle (ldmatrix reads without bank conflicts). A block finds
//    its expert and rows from the offsets (a warp scan over the experts'
//    tile counts); blocks past the last expert's rows exit. The up kernel
//    gathers its A rows (token = slot / k) while staging, with no copy of
//    the gathered rows, and interleaves gate and up rows in blocks of 8 in
//    its B tile, so each thread holds gate and up of the same output and
//    applies silu(g) * u in the epilogue. The down kernel scales its rows
//    by their routing weight in the epilogue.
//  * moe_combine_kernel: each token sums its k slots' rows in slot order
//    (deterministic, no atomics) in float32, rounds to bf16, adds the
//    shared experts' row and rounds again, as HF's bf16 MoE does.
// The design is right and simple first: the [N * k, I] intermediate and the
// [N * k, H] expert outputs go through device memory, and mma.sync reaches
// a fraction of wgmma's rate.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRouteThreads = 1024;
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int kStages = 4;
// the staging ring, in dynamic shared memory (64 KB: over the 48 KB a
// block gets without asking)
constexpr int kSmemBytes = kStages * (BM + BN) * BK * 2;
constexpr int kThreads = 256;
constexpr int kMaxExperts = 64;

// ---- route -----------------------------------------------------------------

__global__ void __launch_bounds__(kRouteThreads) moe_route_kernel(
    const int64_t* __restrict__ ids, int32_t n_slots, int32_t* __restrict__ offsets,
    int32_t* __restrict__ order, int32_t* __restrict__ inv,
    int64_t* __restrict__ load) {
  const int e = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kRouteThreads / 32;
  __shared__ int s_lt[kWarps], s_eq[kWarps];
  __shared__ int s_warp[kWarps];
  int lt = 0, eq = 0;
  for (int i = tid; i < n_slots; i += kRouteThreads) {
    const int64_t v = ids[i];
    lt += v < e;
    eq += v == e;
  }
  for (int d = 16; d > 0; d >>= 1) {
    lt += __shfl_down_sync(0xffffffffu, lt, d);
    eq += __shfl_down_sync(0xffffffffu, eq, d);
  }
  if (lane == 0) {
    s_lt[warp] = lt;
    s_eq[warp] = eq;
  }
  __syncthreads();
  int base = 0, count = 0;
  for (int w = 0; w < kWarps; ++w) {
    base += s_lt[w];
    count += s_eq[w];
  }
  if (tid == 0) {
    offsets[e] = base;
    if (e == static_cast<int>(gridDim.x) - 1) offsets[e + 1] = base + count;
    if (load != nullptr) load[e] += count;
  }
  // compaction in slot order: rank = matches before i in the chunk
  for (int c0 = 0; c0 < n_slots; c0 += kRouteThreads) {
    const int i = c0 + tid;
    const bool hit = i < n_slots && ids[i] == e;
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    __syncthreads();  // s_warp is free again
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int n = s_warp[w];
      before += w < warp ? n : 0;
      total += n;
    }
    if (hit) {
      const int pos = base + before + __popc(m & ((1u << lane) - 1u));
      order[pos] = i;
      inv[i] = pos;
    }
    base += total;
  }
}

// ---- the grouped products ----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory; bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// element offset of (row, 16-byte chunk) in a [rows][BK] bf16 tile: rows
// are 64 bytes, so 8 rows at one chunk fall on 2 bank lines unless the
// chunk is XORed with (row / 2) % 4
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * BK + ((chunk ^ ((row >> 1) & 3)) << 3);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct TileRows {
  int expert;  // -1: no rows for this block
  int row0;    // first sorted position of the tile
  int row_end;  // one past the expert's last sorted position
};

// Which expert and rows block ``b`` computes: expert e owns
// ceil(count_e / BM) consecutive row tiles, in expert order.
__device__ TileRows find_tile(const int32_t* __restrict__ offsets,
                              int n_experts, int b) {
  __shared__ TileRows s_tile;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    int o[2], t[2], s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = lane + 32 * h;
      if (e < n_experts) {
        o[h] = offsets[e];
        t[h] = (offsets[e + 1] - o[h] + BM - 1) / BM;
      } else {
        o[h] = 0;
        t[h] = 0;
      }
      s[h] = t[h];
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, s[h], d);
        if (lane >= d) s[h] += v;
      }
    }
    s[1] += __shfl_sync(0xffffffffu, s[0], 31);
    if (lane == 0) s_tile.expert = -1;
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = lane + 32 * h;
      if (t[h] > 0 && b >= s[h] - t[h] && b < s[h]) {
        s_tile.expert = e;
        s_tile.row0 = o[h] + (b - (s[h] - t[h])) * BM;
        s_tile.row_end = offsets[e + 1];
      }
    }
  }
  __syncthreads();
  return s_tile;
}

// One block's [BM, BN] tile of A[rows] . B^T over K, both K-contiguous
// bf16. ``a_row[r]`` is the A row pointer of tile row r (nullptr: zero),
// ``b_row(r)`` the B row pointer of tile row r.
template <typename BRow>
__device__ __forceinline__ void tile_product(
    const __nv_bfloat16* const* a_row, BRow b_row, int K,
    __nv_bfloat16 (*As)[BM * BK], __nv_bfloat16 (*Bs)[BN * BK],
    float (&acc)[4][4][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  for (int mi = 0; mi < 4; ++mi)
    for (int ni = 0; ni < 4; ++ni)
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  auto stage = [&](int s, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = tid + h * kThreads;  // 512 chunks of 16 bytes a tile
      const int r = c >> 2, ch = c & 3;
      const __nv_bfloat16* a = a_row[r];
      cp_async16(&As[s][swz(r, ch)], a ? a + k0 + ch * 8 : a_row[0],
                 a ? 16 : 0);
      cp_async16(&Bs[s][swz(r, ch)], b_row(r) + k0 + ch * 8, 16);
    }
  };

  const int kt_n = K / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n) stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < kt_n)
      stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const int s = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = lane >> 3;
        const int r = wm * 64 + mi * 16 + (m & 1) * 8 + (lane & 7);
        ldmatrix_x4(af[mi], &As[s][swz(r, kk * 2 + (m >> 1))]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int m = lane >> 3;
        const int r = wn * 32 + np * 16 + (m >> 1) * 8 + (lane & 7);
        uint32_t t[4];
        ldmatrix_x4(t, &Bs[s][swz(r, kk * 2 + (m & 1))]);
        bf[np * 2][0] = t[0];
        bf[np * 2][1] = t[1];
        bf[np * 2 + 1][0] = t[2];
        bf[np * 2 + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();
}

// hmid[p, j] = silu(x[tok] . Wg[e, j]) * (x[tok] . Wu[e, j]) for each sorted
// position p of expert e, tok = order[p] / k; w_gu is [E, 2 * I, H], gate
// rows then up rows. Grid (row tiles, I / 64).
__global__ void __launch_bounds__(kThreads) moe_expert_up_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w_gu,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ order,
    __nv_bfloat16* __restrict__ hmid, int n_experts, int k, int H, int I) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto As = reinterpret_cast<__nv_bfloat16(*)[BM * BK]>(smem);
  auto Bs = reinterpret_cast<__nv_bfloat16(*)[BN * BK]>(
      smem + kStages * BM * BK * sizeof(__nv_bfloat16));
  __shared__ const __nv_bfloat16* a_row[BM];
  const TileRows t = find_tile(offsets, n_experts, blockIdx.x);
  if (t.expert < 0) return;
  const int j0 = blockIdx.y * (BN / 2);
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int p = t.row0 + r;
    a_row[r] = p < t.row_end ? x + static_cast<int64_t>(order[p] / k) * H
                             : nullptr;
  }
  __syncthreads();
  // tile row r: gate (0) or up (1) row by (r / 8) % 2, column
  // j0 + (r / 16) * 8 + r % 8
  const __nv_bfloat16* wb = w_gu + static_cast<int64_t>(t.expert) * 2 * I * H;
  auto b_row = [&](int r) {
    const int half = (r >> 3) & 1, j = j0 + (r >> 4) * 8 + (r & 7);
    return wb + (static_cast<int64_t>(half) * I + j) * H;
  };
  float acc[4][4][4];
  tile_product(a_row, b_row, H, As, Bs, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int pr = 0; pr < 2; ++pr)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * 64 + mi * 16 + (lane >> 2) + hh * 8;
        const int p = t.row0 + r;
        if (p >= t.row_end) continue;
        const int j = j0 + wn * 16 + pr * 8 + (lane & 3) * 2;
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float g = acc[mi][2 * pr][hh * 2 + q];
          const float u = acc[mi][2 * pr + 1][hh * 2 + q];
          v[q] = g / (1.f + __expf(-g)) * u;
        }
        *reinterpret_cast<__nv_bfloat162*>(
            hmid + static_cast<int64_t>(p) * I + j) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
}

// y[p, n] = weight[order[p]] * (hmid[p] . Wd[e, n]) for each sorted
// position p of expert e; w_d is [E, H, I]. Grid (row tiles, H / 128).
__global__ void __launch_bounds__(kThreads) moe_expert_down_kernel(
    const __nv_bfloat16* __restrict__ hmid, const __nv_bfloat16* __restrict__ w_d,
    const float* __restrict__ weights, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ order, __nv_bfloat16* __restrict__ y,
    int n_experts, int H, int I) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto As = reinterpret_cast<__nv_bfloat16(*)[BM * BK]>(smem);
  auto Bs = reinterpret_cast<__nv_bfloat16(*)[BN * BK]>(
      smem + kStages * BM * BK * sizeof(__nv_bfloat16));
  __shared__ const __nv_bfloat16* a_row[BM];
  __shared__ float s_w[BM];
  const TileRows t = find_tile(offsets, n_experts, blockIdx.x);
  if (t.expert < 0) return;
  const int n0 = blockIdx.y * BN;
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int p = t.row0 + r;
    const bool ok = p < t.row_end;
    a_row[r] = ok ? hmid + static_cast<int64_t>(p) * I : nullptr;
    s_w[r] = ok ? weights[order[p]] : 0.f;
  }
  __syncthreads();
  const __nv_bfloat16* wb =
      w_d + (static_cast<int64_t>(t.expert) * H + n0) * I;
  auto b_row = [&](int r) { return wb + static_cast<int64_t>(r) * I; };
  float acc[4][4][4];
  tile_product(a_row, b_row, I, As, Bs, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * 64 + mi * 16 + (lane >> 2) + hh * 8;
      const int p = t.row0 + r;
      if (p >= t.row_end) continue;
      const float w = s_w[r];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
        *reinterpret_cast<__nv_bfloat162*>(y + static_cast<int64_t>(p) * H +
                                           n) =
            __floats2bfloat162_rn(w * acc[mi][ni][hh * 2],
                                  w * acc[mi][ni][hh * 2 + 1]);
      }
    }
}

// out[t] = bf16(bf16(sum_j y[inv[t * k + j]]) + shared[t]); one block a
// token, 8 columns a thread.
__global__ void __launch_bounds__(kThreads) moe_combine_kernel(
    const __nv_bfloat16* __restrict__ y, const int32_t* __restrict__ inv,
    const __nv_bfloat16* __restrict__ shared, __nv_bfloat16* __restrict__ out,
    int k, int H) {
  const int64_t tok = blockIdx.x;
  for (int c = threadIdx.x * 8; c < H; c += kThreads * 8) {
    float acc[8];
    for (int q = 0; q < 8; ++q) acc[q] = 0.f;
    for (int j = 0; j < k; ++j) {
      const int64_t p = inv[tok * k + j];
      const uint4 raw = *reinterpret_cast<const uint4*>(y + p * H + c);
      const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(v[q]);
        acc[2 * q] += f.x;
        acc[2 * q + 1] += f.y;
      }
    }
    const uint4 sraw = *reinterpret_cast<const uint4*>(shared + tok * H + c);
    const __nv_bfloat162* sv = reinterpret_cast<const __nv_bfloat162*>(&sraw);
    uint4 oraw;
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(&oraw);
    for (int q = 0; q < 4; ++q) {
      const float2 s = __bfloat1622float2(sv[q]);
      const float a = __bfloat162float(__float2bfloat16_rn(acc[2 * q]));
      const float b = __bfloat162float(__float2bfloat16_rn(acc[2 * q + 1]));
      ov[q] = __floats2bfloat162_rn(a + s.x, b + s.y);
    }
    *reinterpret_cast<uint4*>(out + tok * H + c) = oraw;
  }
}

}  // namespace

extern "C" int srt_moe_route(const int64_t* ids, int32_t n_slots,
                             int32_t n_experts, int32_t* offsets,
                             int32_t* order, int32_t* inv, int64_t* load,
                             cudaStream_t stream) {
  moe_route_kernel<<<n_experts, kRouteThreads, 0, stream>>>(
      ids, n_slots, offsets, order, inv, load);
  return static_cast<int>(cudaGetLastError());
}

static int row_tiles(int n_slots, int n_experts) {
  return (n_slots + BM - 1) / BM + n_experts;
}

// the products' shared memory above 48 KB, asked for once (at the first,
// eager call: never while a graph is captured)
static cudaError_t allow_smem() {
  static cudaError_t rc = [] {
    cudaError_t e = cudaFuncSetAttribute(
        moe_expert_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(moe_expert_down_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBytes);
  }();
  return rc;
}

extern "C" int srt_moe_expert_up(const void* x, const void* w_gu,
                                 const int32_t* offsets, const int32_t* order,
                                 void* hmid, int32_t n_slots, int32_t n_experts,
                                 int32_t k, int32_t H, int32_t I,
                                 cudaStream_t stream) {
  if (n_experts > kMaxExperts || H % BK || I % (BN / 2)) return 1;  // invalid value
  if (cudaError_t e = allow_smem()) return static_cast<int>(e);
  dim3 grid(row_tiles(n_slots, n_experts), I / (BN / 2));
  moe_expert_up_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w_gu), offsets, order,
      static_cast<__nv_bfloat16*>(hmid), n_experts, k, H, I);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_moe_expert_down(const void* hmid, const void* w_d,
                                   const float* weights, const int32_t* offsets,
                                   const int32_t* order, void* y,
                                   int32_t n_slots, int32_t n_experts,
                                   int32_t H, int32_t I, cudaStream_t stream) {
  if (n_experts > kMaxExperts || H % BN || I % BK) return 1;
  if (cudaError_t e = allow_smem()) return static_cast<int>(e);
  dim3 grid(row_tiles(n_slots, n_experts), H / BN);
  moe_expert_down_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(hmid),
      static_cast<const __nv_bfloat16*>(w_d), weights, offsets, order,
      static_cast<__nv_bfloat16*>(y), n_experts, H, I);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_moe_combine(const void* y, const int32_t* inv,
                               const void* shared, void* out, int32_t n_tokens,
                               int32_t k, int32_t H, cudaStream_t stream) {
  if (H % 8) return 1;
  moe_combine_kernel<<<n_tokens, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(y), inv,
      static_cast<const __nv_bfloat16*>(shared),
      static_cast<__nv_bfloat16*>(out), k, H);
  return static_cast<int>(cudaGetLastError());
}
