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
// So the products have to run the tensor cores near their rate where
// experts hold many rows, and stream every expert's weights once at the
// memory's rate where they hold few.
//
// Design:
//  * moe_route_kernel: one block an expert. Expert e's offset is the count
//    of slots routed to experts below e; a second pass compacts its slots
//    in slot order with warp ballots (no atomics, so the order is
//    deterministic), writing the expert-sorted slot list and its inverse,
//    and adds the expert's count to a persistent load counter. It also
//    zeroes the products' work-item counters.
//  * moe_expert_up_kernel / moe_expert_down_kernel: persistent blocks (one
//    an SM) of three warpgroups. A work item is (expert, column tile, row
//    tile), numbered expert by expert, within an expert column tile by
//    column tile, within that row tile by row tile, so the blocks that run
//    side by side read the same weight tile (from L2 after the first).
//    Blocks claim items from a counter as they free up (the count of items
//    comes from the offsets, so an empty expert or a short routing costs
//    no block a wave): a fixed assignment lets blocks with cheaper items
//    drift apart, and the weight tiles then come from device memory once
//    an item. The counter only hands out work; each output's arithmetic
//    is the same whichever block computes it, and the block that makes a
//    launch's last claim sets it back to 0, so a replay needs no fill. The
//    producer warpgroup keeps a ring of 4 stages of K = 64 full through
//    TMA (the weights' 256 rows a stage; down's A rows, which lie
//    contiguous in sorted order) and mbarriers; the up kernel's A rows are
//    gathered (token = slot / k), which tiled TMA cannot do, so its
//    producer threads copy them with cp.async into the same 128-byte
//    swizzle. Two consumer warpgroups issue wgmma (m64, N 256 or 128, bf16
//    in, float32 sums in registers, the K order fixed), each warp handing a
//    stage back once its products are done. A row tile is 128 rows. One
//    of more than 64 puts a warpgroup on each half and both on all 256
//    weight rows, so each weight byte serves 128 rows; one of 64 or fewer
//    (an expert's last, or its only one where experts hold few rows) puts
//    both warpgroups on its rows and 128 weight rows each (decided per item
//    on the device), since one warpgroup's chain of dependent products
//    alone runs at about half the SM's rate.
//    The up kernel's weight tile holds the gate and the up rows
//    of the same 128 output columns, in blocks of 64, so each thread holds
//    gate and up of its outputs and applies silu(g) * u before the one
//    bf16 rounding; the down kernel scales its rows by their routing
//    weight before its one rounding. Every output is one thread's sum in
//    one order: the same bits every run, no atomics, no split K.
//  * moe_combine_kernel: each token sums its k slots' rows in slot order
//    (deterministic, no atomics) in float32, rounds to bf16, adds the
//    shared experts' row and rounds again, as HF's bf16 MoE does.
// The [N * k, I] intermediate and the [N * k, H] expert outputs go through
// device memory, and the row tiles of pad positions are computed like any
// other.
#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRouteThreads = 1024;
constexpr int kThreads = 256;  // the combine's block
constexpr int kMaxExperts = 64;

// ---- route -----------------------------------------------------------------

__global__ void __launch_bounds__(kRouteThreads) moe_route_kernel(
    const int64_t* __restrict__ ids, int32_t n_slots, int32_t* __restrict__ offsets,
    int32_t* __restrict__ order, int32_t* __restrict__ inv,
    int64_t* __restrict__ load, int32_t* __restrict__ work) {
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
    if (e == 0) work[0] = work[1] = 0;  // the products' work counters
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

constexpr int BM = 128;  // rows a work item
constexpr int BK = 64;   // K a stage: one 128-byte swizzle row of bf16
constexpr int BN = 256;  // weight rows a stage
constexpr int kStages = 4;
constexpr int kABytes = BM * BK * 2;
constexpr int kBBytes = BN * BK * 2;
constexpr int kStageBytes = kABytes + kBBytes;
// 1 KB to align the ring to the swizzle's period, the ring, its full and
// empty barriers, the expert tables, each stage's work item and the
// producer's claimed item
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8 +
                           2 * (kMaxExperts + 1) * 4 + (kStages + 1) * 4;
constexpr int kProductThreads = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int kConsumerWarps = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's shared-memory writes before wgmma's reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the up producer warpgroup's own barrier (id 1: 0 is __syncthreads')
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// one arrival that also expects ``bytes`` of TMA data
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: the box at (k, row) of ``map`` to shared ``dst``, counted on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(row)
      : "memory");
}

// wgmma's view of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1,024 bytes apart (the leading offset is unused)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving the sums' reads and writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void keep(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] (+)= A[64 x 16] . B[256 x 16]^T, both K-major in shared
// memory (the sums' layout: acc_row)
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same over B[128 x 16]
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The block's shared memory: the ring's A and B stages (shared addresses),
// its barriers, and the expert tables.
struct Smem {
  uint32_t a, b;
  uint64_t* full;
  uint64_t* empty;
  int* off;    // [E + 1] the experts' offsets
  int* first;  // [E + 1] each expert's first row tile (prefix of ceil(n / BM))
  int* item;   // [stages] the work item a stage starts (-1: no more)
  int* next;   // the up producer's claimed item, for its 128 threads
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  const uint32_t base = smem_u32(raw);
  const uint32_t pad = ((base + 1023u) & ~1023u) - base;
  Smem s;
  s.a = base + pad;
  s.b = s.a + kStages * kABytes;
  s.full = reinterpret_cast<uint64_t*>(raw + pad + kStages * kStageBytes);
  s.empty = s.full + kStages;
  s.off = reinterpret_cast<int*>(s.empty + kStages);
  s.first = s.off + kMaxExperts + 1;
  s.item = s.first + kMaxExperts + 1;
  s.next = s.item + kStages;
  return s;
}

// Everything before the roles split: the expert tables and the barriers
// (a full stage waits for ``full_count`` arrivals and its TMA bytes, an
// empty one for every consumer warp: a warp that has not yet seen a stage
// whole keeps it from being refilled, so no warp falls a phase behind the
// parity it waits on).
__device__ __forceinline__ void setup(const Smem& s,
                                      const int32_t* __restrict__ offsets,
                                      int n_experts, int full_count) {
  if (threadIdx.x <= n_experts) s.off[threadIdx.x] = offsets[threadIdx.x];
  if (threadIdx.x == 32) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(&s.full[i], full_count);
      bar_init(&s.empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int t[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = lane + 32 * h;
      t[h] = e < n_experts ? (s.off[e + 1] - s.off[e] + BM - 1) / BM : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, t[h], d);
        if (lane >= d) t[h] += v;
      }
    }
    t[1] += __shfl_sync(0xffffffffu, t[0], 31);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (lane + 32 * h < n_experts) s.first[lane + 32 * h + 1] = t[h];
    if (lane == 0) s.first[0] = 0;
  }
  __syncthreads();
}

struct Work {
  int expert, col, row0, row_end;
};

// Work item i of ``n_col`` column tiles an expert; ``e`` is the caller's
// cursor (a block's items rise).
//
// Blocks claim items from a counter as they free up, so the items that run
// side by side are always neighbours, the row tiles of one weight tile,
// and share it through L2 whatever each item costs; with a fixed
// assignment, items of unequal cost (an expert's short last tile) let the
// blocks drift apart and each read its weight tile from device memory.
// Which block computes an item does not change its arithmetic. The
// producer tells the consumers each item in the stage that starts it.
__device__ __forceinline__ Work work_item(const Smem& s, int i, int n_col,
                                          int& e) {
  while (s.first[e + 1] * n_col <= i) ++e;
  const int tiles = s.first[e + 1] - s.first[e];
  const int local = i - s.first[e] * n_col;
  return {e, local / tiles, s.off[e] + (local % tiles) * BM, s.off[e + 1]};
}

// A consumer warpgroup's K loop over one work item: acc = the ring's A rows
// [a_row, a_row + 64) times its B rows [b_row, b_row + N), stage after
// stage, each warp handing a stage back once its products are done.
template <int N>
__device__ __forceinline__ void consume(const Smem& s, int n_k, int a_row,
                                        int b_row, int& stage, int& phase,
                                        float (&acc)[N / 2]) {
  const bool leader = threadIdx.x % 32 == 0;
  int prev = -1;
  for (int kt = 0; kt < n_k; ++kt) {
    bar_wait(&s.full[stage], phase);
    __syncwarp();  // the lanes leave the wait apart; wgmma wants them together
    keep(acc);
    wgmma_fence();
    const uint32_t a = s.a + stage * kABytes + a_row * 128;
    const uint32_t b = s.b + stage * kBBytes + b_row * 128;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int accumulate = kt > 0 || kk > 0;
      if constexpr (N == 256)
        wgmma_n256(acc, wgmma_desc(a + kk * 32), wgmma_desc(b + kk * 32),
                   accumulate);
      else
        wgmma_n128(acc, wgmma_desc(a + kk * 32), wgmma_desc(b + kk * 32),
                   accumulate);
    }
    wgmma_commit();
    wgmma_wait<1>();
    keep(acc);
    if (prev >= 0 && leader) bar_arrive(&s.empty[prev]);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  keep(acc);
  if (leader) bar_arrive(&s.empty[prev]);
}

// A work item's shape for a consumer warpgroup: a tile of more than 64 rows
// puts a warpgroup on each 64-row half, both on all 256 weight rows; a tile
// of at most 64 puts both on its rows, a warpgroup on 128 weight rows, so
// neither waits idle while the other runs a chain of dependent products at
// half the SM's rate.
struct Shape {
  int a_row, b_row;
};

__device__ __forceinline__ bool tall(const Work& w) {
  return w.row_end - w.row0 > 64;
}

// the sums' place in the output: thread t of the warpgroup holds rows
// (t / 32) * 16 + t % 32 / 4 (+ 8) of its 64 and columns 8 j + 2 (t % 4)
// (+ 1) of its N at acc[4 j .. 4 j + 3]
__device__ __forceinline__ int acc_row() {
  const int t = threadIdx.x % 128;
  return (t >> 5) * 16 + ((t & 31) >> 2);
}

// hmid rows of one item: the warpgroup's weight rows hold, per 64 output
// columns h, gate at n8 blocks 16 h + j and up at 16 h + 8 + j; silu(g) * u
// rounds once to bf16
template <int N>
__device__ __forceinline__ void store_up(const float (&acc)[N / 2],
                                         __nv_bfloat16* __restrict__ hmid,
                                         const Work& w, Shape sh, int I) {
  const int r0 = acc_row(), c = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int h = 0; h < N / 128; ++h)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int p = w.row0 + sh.a_row + r0 + 8 * rr;
      if (p >= w.row_end) continue;
      __nv_bfloat16* out = hmid + static_cast<int64_t>(p) * I + w.col * 128 +
                           sh.b_row / 2 + 64 * h + c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float g = acc[4 * (16 * h + j) + 2 * rr + q];
          const float u = acc[4 * (16 * h + 8 + j) + 2 * rr + q];
          v[q] = g / (1.f + __expf(-g)) * u;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
}

// y rows of one item, each scaled by its slot's routing weight before its
// one rounding
template <int N>
__device__ __forceinline__ void store_down(const float (&acc)[N / 2],
                                           __nv_bfloat16* __restrict__ y,
                                           const float* __restrict__ weights,
                                           const int32_t* __restrict__ order,
                                           const Work& w, Shape sh, int H) {
  const int r0 = acc_row(), c = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int p = w.row0 + sh.a_row + r0 + 8 * rr;
    if (p >= w.row_end) continue;
    const float wt = weights[order[p]];
    __nv_bfloat16* out =
        y + static_cast<int64_t>(p) * H + w.col * BN + sh.b_row + c;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          wt * acc[4 * j + 2 * rr], wt * acc[4 * j + 2 * rr + 1]);
  }
}

// hmid[p, j] = silu(x[tok] . Wg[e, j]) * (x[tok] . Wu[e, j]) for each sorted
// position p of expert e, tok = order[p] / k; ``w_map`` views w_gu
// [E, 2 * I, H] (gate rows, then up rows) as [E * 2I, H] in boxes of
// 64 x 64. A work item is 128 output columns: its weight stage holds gate
// rows c..c+63, up rows c..c+63, gate c+64..c+127, up c+64..c+127.
__global__ void __launch_bounds__(kProductThreads, 1) moe_expert_up_kernel(
    const __grid_constant__ CUtensorMap w_map,
    const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ order, __nv_bfloat16* __restrict__ hmid,
    int* __restrict__ counter, int n_experts, int k, int H, int I) {
  constexpr int kLag = kStages - 1;  // stages of gathered rows in flight
  extern __shared__ unsigned char smem[];
  const Smem s = carve(smem);
  // 128 producer threads arrive once their rows of a stage have landed,
  // and one more with the weights' TMA bytes
  setup(s, offsets, n_experts, 128 + 1);
  const int n_col = I / 128, n_k = H / BK;
  const int total = s.first[n_experts] * n_col;
  const int wg = threadIdx.x / 128;
  int stage = 0, phase = 0, e = 0;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    // thread t copies 16-byte chunk t % 8 of rows t / 8 + 16 q; the chunk's
    // place in the swizzle is the same for all its rows
    const int t = threadIdx.x - 256, chunk = t & 7, r0 = t >> 3;
    const uint32_t at = r0 * 128 + ((chunk ^ (r0 & 7)) << 4);
    int issued = 0;
    for (;;) {
      if (t == 0) *s.next = atomicAdd(counter, 1);
      producer_sync();
      const int i = *s.next;
      producer_sync();
      // past the last item, one more stage with no copies tells the
      // consumers so
      const bool done = i >= total;
      // each block claims once past the last item: the last such claim is
      // the launch's last, and its block sets the counter back
      if (t == 0 && i == total + static_cast<int>(gridDim.x) - 1) *counter = 0;
      const Work w = done ? Work{} : work_item(s, i, n_col, e);
      const __nv_bfloat16* src[BM / 16];
#pragma unroll
      for (int q = 0; q < BM / 16; ++q) {
        const int p = w.row0 + r0 + 16 * q;
        src[q] = p < w.row_end
                     ? x + static_cast<int64_t>(order[p] / k) * H + chunk * 8
                     : nullptr;
      }
      const int gate = w.expert * 2 * I + w.col * 128;
      for (int kt = 0; kt < (done ? 1 : n_k); ++kt) {
        // the stage issued kLag stages ago is whole once its copies land;
        // it goes out before the wait below, since the consumers hand a
        // stage back only once the next one is whole
        if (issued >= kLag) {
          cp_async_wait<kLag - 1>();
          fence_proxy_async();
          bar_arrive(&s.full[(stage + kStages - kLag) % kStages]);
        }
        bar_wait(&s.empty[stage], phase ^ 1);
        const int k0 = kt * BK;
        if (t == 0) {
          uint64_t* bar = &s.full[stage];
          if (kt == 0) s.item[stage] = done ? -1 : i;
          if (done) {
            bar_arrive(bar);
          } else {
            const uint32_t b = s.b + stage * kBBytes;
            bar_expect_tx(bar, kBBytes);
            tma_load(b, &w_map, bar, k0, gate);
            tma_load(b + kBBytes / 4, &w_map, bar, k0, gate + I);
            tma_load(b + kBBytes / 2, &w_map, bar, k0, gate + 64);
            tma_load(b + 3 * kBBytes / 4, &w_map, bar, k0, gate + I + 64);
          }
        }
        const uint32_t a = s.a + stage * kABytes + at;
        // rows past the expert's keep what the stage held: a row's
        // products reach only its own output row, which is not stored
#pragma unroll
        for (int q = 0; q < BM / 16; ++q)
          if (src[q]) cp_async16(a + q * 16 * 128, src[q] + k0);
        cp_async_commit();
        ++issued;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (done) break;
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int d = issued < kLag ? issued : kLag; d > 0; --d)
      bar_arrive(&s.full[(stage + kStages - d) % kStages]);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    for (;;) {
      bar_wait(&s.full[stage], phase);
      const int i = s.item[stage];
      if (i < 0) break;
      const Work w = work_item(s, i, n_col, e);
      if (tall(w)) {
        const Shape sh{64 * wg, 0};
        float acc[128];
        consume<256>(s, n_k, sh.a_row, sh.b_row, stage, phase, acc);
        store_up<256>(acc, hmid, w, sh, I);
      } else {
        const Shape sh{0, 128 * wg};
        float acc[64];
        consume<128>(s, n_k, sh.a_row, sh.b_row, stage, phase, acc);
        store_up<128>(acc, hmid, w, sh, I);
      }
    }
  }
}

// y[p, n] = weight[order[p]] * (hmid[p] . Wd[e, n]) for each sorted
// position p of expert e; ``a_map`` views hmid [N * k, I] in boxes of
// BM x 64, ``w_map`` w_d [E, H, I] as [E * H, I] in boxes of 64 x 64. A
// work item is 256 output columns.
__global__ void __launch_bounds__(kProductThreads, 1) moe_expert_down_kernel(
    const __grid_constant__ CUtensorMap a_map,
    const __grid_constant__ CUtensorMap w_map,
    const float* __restrict__ weights, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ order, __nv_bfloat16* __restrict__ y,
    int* __restrict__ counter, int n_experts, int H, int I) {
  extern __shared__ unsigned char smem[];
  const Smem s = carve(smem);
  setup(s, offsets, n_experts, 1);
  const int n_col = H / BN, n_k = I / BK;
  const int total = s.first[n_experts] * n_col;
  const int wg = threadIdx.x / 128;
  int stage = 0, phase = 0, e = 0;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (;;) {
        const int i = atomicAdd(counter, 1);
        if (i >= total) {  // one more stage, with no data, says so
          if (i == total + static_cast<int>(gridDim.x) - 1) *counter = 0;
          bar_wait(&s.empty[stage], phase ^ 1);
          s.item[stage] = -1;
          bar_arrive(&s.full[stage]);
          break;
        }
        const Work w = work_item(s, i, n_col, e);
        const int wrow = w.expert * H + w.col * BN;
        for (int kt = 0; kt < n_k; ++kt) {
          bar_wait(&s.empty[stage], phase ^ 1);
          uint64_t* bar = &s.full[stage];
          const int k0 = kt * BK;
          if (kt == 0) s.item[stage] = i;
          bar_expect_tx(bar, kStageBytes);
          tma_load(s.a + stage * kABytes, &a_map, bar, k0, w.row0);
          const uint32_t b = s.b + stage * kBBytes;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load(b + j * (kBBytes / 4), &w_map, bar, k0, wrow + 64 * j);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    for (;;) {
      bar_wait(&s.full[stage], phase);
      const int i = s.item[stage];
      if (i < 0) break;
      const Work w = work_item(s, i, n_col, e);
      if (tall(w)) {
        const Shape sh{64 * wg, 0};
        float acc[128];
        consume<256>(s, n_k, sh.a_row, sh.b_row, stage, phase, acc);
        store_down<256>(acc, y, weights, order, w, sh, H);
      } else {
        const Shape sh{0, 128 * wg};
        float acc[64];
        consume<128>(s, n_k, sh.a_row, sh.b_row, stage, phase, acc);
        store_down<128>(acc, y, weights, order, w, sh, H);
      }
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
                             int32_t* work, cudaStream_t stream) {
  moe_route_kernel<<<n_experts, kRouteThreads, 0, stream>>>(
      ids, n_slots, offsets, order, inv, load, work);
  return static_cast<int>(cudaGetLastError());
}

// What the products' launches need of the device, asked for once (at the
// first, eager call: never while a graph is captured): the SM count,
// cuTensorMapEncodeTiled, and the shared memory above 48 KB.
struct ProductSetup {
  cudaError_t rc = cudaSuccess;
  int n_sm = 0;
  PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
};

static const ProductSetup& product_setup() {
  static const ProductSetup setup = [] {
    ProductSetup p;
    int dev = 0;
    if ((p.rc = cudaGetDevice(&dev))) return p;
    if ((p.rc = cudaDeviceGetAttribute(&p.n_sm, cudaDevAttrMultiProcessorCount,
                                       dev)))
      return p;
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    p.rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                            12000, cudaEnableDefault, &found);
#else
    p.rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                   cudaEnableDefault, &found);
#endif
    if (p.rc) return p;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      p.rc = cudaErrorNotSupported;
      return p;
    }
    p.encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
    const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    p.rc = cudaFuncSetAttribute(moe_expert_up_kernel, attr, kSmemBytes);
    if (!p.rc)
      p.rc = cudaFuncSetAttribute(moe_expert_down_kernel, attr, kSmemBytes);
    return p;
  }();
  return setup;
}

// A bf16 [rows, cols] matrix (cols contiguous) in boxes of box_rows x 64,
// in the 128-byte swizzle; false where the driver refuses it.
static bool tensor_map(CUtensorMap* map, const void* ptr, uint64_t rows,
                       uint64_t cols, uint32_t box_rows) {
  const cuuint64_t dim[2] = {cols, rows};
  const cuuint64_t stride[1] = {cols * 2};
  const cuuint32_t box[2] = {BK, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return product_setup().encode(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dim, stride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// persistent blocks: one an SM, or one a work item where there are fewer
// (the work items at most: every expert's last row tile partial)
static int product_grid(int n_slots, int n_experts, int n_col) {
  const int items = (n_slots / BM + n_experts) * n_col;
  const int n_sm = product_setup().n_sm;
  return items < n_sm ? items : n_sm;
}

// ``counter`` is a zeroed int the blocks claim work items from (one of
// route's ``work``); the launch leaves it zeroed.
extern "C" int srt_moe_expert_up(const void* x, const void* w_gu,
                                 const int32_t* offsets, const int32_t* order,
                                 void* hmid, int32_t* counter,
                                 int32_t n_slots, int32_t n_experts,
                                 int32_t k, int32_t H, int32_t I,
                                 cudaStream_t stream) {
  if (n_experts > kMaxExperts || n_slots <= 0 || H % BK || I % (BN / 2))
    return cudaErrorInvalidValue;
  if (cudaError_t e = product_setup().rc) return static_cast<int>(e);
  CUtensorMap w;
  if (!tensor_map(&w, w_gu, static_cast<uint64_t>(n_experts) * 2 * I, H, 64))
    return cudaErrorInvalidValue;
  const int grid = product_grid(n_slots, n_experts, I / (BN / 2));
  moe_expert_up_kernel<<<grid, kProductThreads, kSmemBytes, stream>>>(
      w, static_cast<const __nv_bfloat16*>(x), offsets, order,
      static_cast<__nv_bfloat16*>(hmid), counter, n_experts, k, H, I);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_moe_expert_down(const void* hmid, const void* w_d,
                                   const float* weights, const int32_t* offsets,
                                   const int32_t* order, void* y,
                                   int32_t* counter, int32_t n_slots,
                                   int32_t n_experts, int32_t H, int32_t I,
                                   cudaStream_t stream) {
  if (n_experts > kMaxExperts || n_slots <= 0 || H % BN || I % BK)
    return cudaErrorInvalidValue;
  if (cudaError_t e = product_setup().rc) return static_cast<int>(e);
  CUtensorMap a, w;
  if (!tensor_map(&a, hmid, n_slots, I, BM) ||
      !tensor_map(&w, w_d, static_cast<uint64_t>(n_experts) * H, I, 64))
    return cudaErrorInvalidValue;
  const int grid = product_grid(n_slots, n_experts, H / BN);
  moe_expert_down_kernel<<<grid, kProductThreads, kSmemBytes, stream>>>(
      a, w, weights, offsets, order, static_cast<__nv_bfloat16*>(y), counter,
      n_experts, H, I);
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
