// The Llama-family attention block as one kernel, for a forward no
// gradient flows through: rope on q and k, then GQA attention
// softmax(q k^T / sqrt(hd) + bias) v, from the projections' bf16 outputs
// to the bf16 [B, S, Nq * hd] that the output projection reads.
//
// Replaces no TPU kernel: the JAX package's attention is jnp
// (models/llama.py apply_rope and attention), which XLA fuses on the TPU.
// It exists because PyTorch runs the same block as ~25 launches whose
// float32 intermediates (rope's eight passes, repeat_interleave, the
// einsums' permute copies, the [B, N, S, S] logits, scale, bias, softmax,
// casts) move ~2.0 GB a layer at Mistral-7B's 64 x 64 serving tile,
// where the block's inputs and output are ~84 MB.
//
// What bounds it on an H100: bytes. Its products are 4 * B * Nq * S^2 *
// hd FLOP (4.3 GFLOP a Mistral layer, 4 us at the tensor cores' peak)
// against q, k, v and the output read or written once (~25 us at 3.35
// TB/s): far below the card's ridge. So each byte is moved once and
// every intermediate stays on chip.
//
// Design:
//  * A block of 8 warps takes one (batch row, KV head) pair's group of
//    Nq / Nkv query heads, or a share of it: the group's rep * S query
//    rows, ordered (position, head) so that the rows of a tile share their
//    rope rows, in tiles of 16 rows, each warp one tile a round. Where
//    pairs are few, each group's tiles are split over blocks (split_of,
//    from the shapes, the card's SMs and the instance's resident blocks
//    an SM, which the occupancy calculator reads off the compiled kernel).
//    All heads of the group read the same k and v rows from shared
//    memory: GQA by index, no repeat_interleave.
//  * Keys come in blocks of 64. k, v and q reach shared memory by
//    cp.async; each warp's next tile lands while it computes this one. k
//    and q are roped in place there: float32 products and sum, each
//    rounded, then one bf16 rounding, as apply_rope does, so the roped
//    operands are apply_rope's bit for bit.
//  * Logits are mma.sync m16n8k16 products (bf16 in, float32 sums), then
//    times 1/sqrt(hd) and plus the padding bias, each rounded in float32
//    as attention() does; keys past S are -inf. The softmax runs in float32
//    in registers with expf, as torch.softmax does: the row max, exp(x -
//    max), their sum, and each exp divided by the sum, rounded to bf16 as
//    .to(v.dtype) does. P.V is mma.sync again (float32 sums), rounded to
//    bf16 once, staged in the warp's rows and written in 16-byte rows.
//  * Where S fits one key block (the serving rungs 16 and 64), each tile
//    makes its logits once and k and v are loaded once a block; the
//    arithmetic is attention()'s in another summation order. Longer
//    encodes take two passes over the key blocks: the row max and sum
//    (online, the sum rescaled as the max grows), then the normalised
//    probabilities times v, so the probabilities are rounded after
//    normalisation there too.
//  * Where the time goes, at Mistral's 64 x 64 tile on an H100 SXM (700
//    W): 73 us against the 25 us bound. The copies, rope and stores alone
//    take 48 us; rope ~17 us of the whole, the exact division ~8 us. The
//    launch bounds (two blocks an SM) cap a thread at 128 registers, and
//    the head-dim-128 instance spills there (ptxas: 44 bytes of spill
//    stores, 92 of loads, a 32-byte stack frame).
//    A persistent, pipelined block that holds fewer accumulators a warp,
//    or runs one block an SM, without spills, is the next step.
//  * Instances: every head dim that is a multiple of 16 up to 128 (the
//    m16n8k16 products take head dims in steps of 16); others raise.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int KB = 64;    // keys a block
constexpr int kPad = 8;   // bf16 past a shared row: rows 16 bytes apart in bank order

template <int HD>
struct Layout {
  static constexpr int LD = HD + kPad;  // a shared row, in bf16
  // k and v blocks, each warp's two buffers of 16 rows, the key block's
  // bias
  static constexpr int bytes = (2 * KB + kWarps * 2 * 16) * LD * 2 + KB * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// apply_rope's x * cos + rotate_half(x) * sin: each product and the sum
// rounded in float32 (no fused multiply-add)
__device__ __forceinline__ float rope1(float x, float c, float r, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(r, s));
}

// a shared row's elements d0..d0+7 and their rotate-half partners
// d0+HD/2.., roped in place with the float32 tables' rows cs and sn
template <int HD>
__device__ __forceinline__ void rope_pair(bf16* x, const float* cs,
                                          const float* sn, int d0) {
  constexpr int half = HD / 2;
  const uint4 lo = *reinterpret_cast<const uint4*>(x + d0);
  const uint4 hi = *reinterpret_cast<const uint4*>(x + d0 + half);
  float cl[8], ch[8], sl[8], sh[8];
  load8(cs + d0, cl);
  load8(cs + d0 + half, ch);
  load8(sn + d0, sl);
  load8(sn + d0 + half, sh);
  const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&lo);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hi);
  uint4 olo, ohi;
  __nv_bfloat162* ol = reinterpret_cast<__nv_bfloat162*>(&olo);
  __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&ohi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(l2[i]);
    const float2 b = __bfloat1622float2(h2[i]);
    const int e = 2 * i;
    ol[i] = __floats2bfloat162_rn(rope1(a.x, cl[e], -b.x, sl[e]),
                                  rope1(a.y, cl[e + 1], -b.y, sl[e + 1]));
    oh[i] = __floats2bfloat162_rn(rope1(b.x, ch[e], a.x, sh[e]),
                                  rope1(b.y, ch[e + 1], a.y, sh[e + 1]));
  }
  *reinterpret_cast<uint4*>(x + d0) = olo;
  *reinterpret_cast<uint4*>(x + d0 + half) = ohi;
}

// 16 bytes from global to shared memory, asynchronously (zeros where
// !valid)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies but the newest N groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const bf16* q;       // [B, S, Nq, hd]
  const bf16* k;       // [B, S, Nkv, hd]
  const bf16* v;       // [B, S, Nkv, hd]
  const float* cos;    // [S, hd]
  const float* sin;    // [S, hd]
  const float* bias;   // [B, S]: 0 or MASK_VALUE a key
  bf16* out;           // [B, S, Nq * hd]
  int S, n_q, n_kv, split;
  float scale;
};

// keys key0.. of (b, g) on their way into shared memory: k (and v, when
// with_v) copied asynchronously, rows past S up to the next 16 zero; the
// bias stored
template <int HD>
__device__ void copy_keys(const Args& a, int b, int g, int key0, bool with_v,
                          bf16* ks, bf16* vs, float* bs) {
  constexpr int LD = Layout<HD>::LD, C = HD / 8;
  const int valid = min(KB, a.S - key0);
  const int rows = (valid + 15) & ~15;
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C, c = (i % C) * 8;
    const int64_t at =
        ((b * static_cast<int64_t>(a.S) + key0 + (r < valid ? r : 0)) * a.n_kv +
         g) * HD + c;
    cp_async16(ks + r * LD + c, a.k + at, r < valid);
    if (with_v) cp_async16(vs + r * LD + c, a.v + at, r < valid);
  }
  for (int i = threadIdx.x; i < rows; i += kThreads)
    bs[i] = i < valid ? a.bias[b * static_cast<int64_t>(a.S) + key0 + i] : 0.f;
}

// the landed k rows of keys key0.. roped in place (after a barrier)
template <int HD>
__device__ void rope_keys(const Args& a, int key0, bf16* ks) {
  constexpr int LD = Layout<HD>::LD, P = HD / 16;
  const int valid = min(KB, a.S - key0);
  for (int i = threadIdx.x; i < valid * P; i += kThreads) {
    const int r = i / P;
    const int64_t s = key0 + r;
    rope_pair<HD>(ks + r * LD, a.cos + s * HD, a.sin + s * HD, (i % P) * 8);
  }
}

// query tile t's 16 rows of the group (row s * rep + j: position s of the
// group's head j) on their way into the warp's rows, asynchronously (zero
// past the group's last row)
template <int HD>
__device__ void copy_q(const Args& a, int b, int g, int t, bf16* qs,
                       int lane) {
  constexpr int LD = Layout<HD>::LD, C = HD / 8;
  const int rep = a.n_q / a.n_kv, rows = rep * a.S;
  for (int i = lane; i < 16 * C; i += 32) {
    const int r = i / C, c = (i % C) * 8, row = t * 16 + r;
    const int in = row < rows ? row : 0;
    const int64_t at = ((b * static_cast<int64_t>(a.S) + in / rep) * a.n_q +
                        g * rep + in % rep) * HD + c;
    cp_async16(qs + r * LD + c, a.q + at, row < rows);
  }
}

// tile t's landed rows roped in place (after a warp barrier)
template <int HD>
__device__ void rope_q(const Args& a, int t, bf16* qs, int lane) {
  constexpr int LD = Layout<HD>::LD, P = HD / 16;
  const int rows = min(16, (a.n_q / a.n_kv) * a.S - t * 16);
  for (int i = lane; i < rows * P; i += 32) {
    const int r = i / P;
    const int64_t s = (t * 16 + r) / (a.n_q / a.n_kv);
    rope_pair<HD>(qs + r * LD, a.cos + s * HD, a.sin + s * HD, (i % P) * 8);
  }
}

// s = the warp's 16 rows against the block's keys (n16 steps of 16):
// thread (lane) holds rows lane / 4 and lane / 4 + 8, keys
// 8 nt + 2 (lane % 4) + {0, 1} of n-tile nt
template <int HD>
__device__ __forceinline__ void qk(float (&s)[KB / 8][4], const bf16* qs,
                                   const bf16* ks, int n16, int lane) {
  constexpr int LD = Layout<HD>::LD;
#pragma unroll
  for (int nt = 0; nt < KB / 8; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    uint32_t qa[4];
    ldmatrix_x4(qa, qs + (lane % 16) * LD + j * 16 + (lane / 16) * 8);
#pragma unroll
    for (int p = 0; p < KB / 16; ++p) {
      if (p < n16) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (p * 16 + lane % 8 + (lane / 16) * 8) * LD +
                            j * 16 + ((lane / 8) % 2) * 8);
        mma(s[2 * p], qa, kb[0], kb[1]);
        mma(s[2 * p + 1], qa, kb[2], kb[3]);
      }
    }
  }
}

// attention()'s logits: (q.k * scale) + bias, each rounded; -inf past the
// block's valid keys
__device__ __forceinline__ void logits(float (&s)[KB / 8][4], const float* bs,
                                       float scale, int valid, int lane) {
#pragma unroll
  for (int nt = 0; nt < KB / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = nt * 8 + (lane % 4) * 2 + (e & 1);
      s[nt][e] = key < valid ? __fadd_rn(__fmul_rn(s[nt][e], scale), bs[key])
                             : -__int_as_float(0x7f800000);
    }
  }
}

// the running row max m and sum l of exp(x - m) over this block too; s
// becomes exp(s - m)
__device__ __forceinline__ void stats(float (&s)[KB / 8][4], float (&m)[2],
                                      float (&l)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < KB / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int nt = 0; nt < KB / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = expf(s[nt][e] - mx[e / 2]);
      sum[e / 2] += s[nt][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * expf(m[r] - mx[r]) + sum[r];
    m[r] = mx[r];
  }
}

// acc += round_bf16(s / l) v over the block's n16 key steps; the
// probabilities' A fragments are the logits' accumulator layout
template <int HD>
__device__ __forceinline__ void pv(const float (&s)[KB / 8][4],
                                   const float (&l)[2],
                                   float (&acc)[HD / 8][4], const bf16* vs,
                                   int n16, int lane) {
  constexpr int LD = Layout<HD>::LD;
#pragma unroll
  for (int p = 0; p < KB / 16; ++p) {
    if (p < n16) {
      const float(&x)[4] = s[2 * p];
      const float(&y)[4] = s[2 * p + 1];
      const uint32_t pa[4] = {
          pack_bf16(__fdiv_rn(x[0], l[0]), __fdiv_rn(x[1], l[0])),
          pack_bf16(__fdiv_rn(x[2], l[1]), __fdiv_rn(x[3], l[1])),
          pack_bf16(__fdiv_rn(y[0], l[0]), __fdiv_rn(y[1], l[0])),
          pack_bf16(__fdiv_rn(y[2], l[1]), __fdiv_rn(y[3], l[1]))};
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (p * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                       LD +
                                   n * 16 + (lane / 16) * 8);
        mma(acc[2 * n], pa, vb[0], vb[1]);
        mma(acc[2 * n + 1], pa, vb[2], vb[3]);
      }
    }
  }
}

// the tile's output rows, rounded to bf16, through the warp's shared rows
template <int HD>
__device__ void store_out(const Args& a, int b, int g, int t,
                          const float (&acc)[HD / 8][4], bf16* qs, int lane) {
  constexpr int LD = Layout<HD>::LD, C = HD / 8;
  const int r = lane / 4;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const int c = nt * 8 + (lane % 4) * 2;
    *reinterpret_cast<__nv_bfloat162*>(qs + r * LD + c) =
        __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<__nv_bfloat162*>(qs + (r + 8) * LD + c) =
        __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
  const int rep = a.n_q / a.n_kv, rows = rep * a.S;
  for (int i = lane; i < 16 * C; i += 32) {
    const int rr = i / C, c = (i % C) * 8, row = t * 16 + rr;
    if (row < rows) {
      const int h = g * rep + row % rep;
      const int64_t s = row / rep;
      *reinterpret_cast<uint4*>(
          a.out + ((b * static_cast<int64_t>(a.S) + s) * a.n_q + h) * HD + c) =
          *reinterpret_cast<const uint4*>(qs + rr * LD + c);
    }
  }
  __syncwarp();
}

template <int HD>
// two blocks an SM: 128 registers a thread
__global__ void __launch_bounds__(kThreads, 2)
    rope_gqa_attention_kernel(Args a) {
  constexpr int LD = Layout<HD>::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + KB * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warp's two buffers of 16 rows: a tile's q, then its output
  bf16* qbuf = vs + KB * LD + warp * 2 * 16 * LD;
  float* bs = reinterpret_cast<float*>(vs + KB * LD + kWarps * 2 * 16 * LD);

  const int pair = blockIdx.x / a.split, part = blockIdx.x % a.split;
  const int b = pair / a.n_kv, g = pair % a.n_kv;
  const int tiles = ((a.n_q / a.n_kv) * a.S + 15) / 16;
  const int per = (tiles + a.split - 1) / a.split;
  const int t0 = part * per, t1 = min(tiles, t0 + per);
  const int nkb = (a.S + KB - 1) / KB;

  // one key block: its k and v stay for every tile of the block
  if (nkb == 1) copy_keys<HD>(a, b, g, 0, true, ks, vs, bs);
  if (t0 + warp < t1) copy_q<HD>(a, b, g, t0 + warp, qbuf, lane);
  cp_async_commit();
  if (nkb == 1) {
    cp_async_wait<0>();
    __syncthreads();
    rope_keys<HD>(a, 0, ks);
    __syncthreads();
  }
  for (int base = t0, round = 0; base < t1; base += kWarps, ++round) {
    const int t = base + warp;
    const bool live = t < t1;
    bf16* qs = qbuf + (round & 1) * 16 * LD;
    // the warp's next tile lands while this one computes
    if (t + kWarps < t1)
      copy_q<HD>(a, b, g, t + kWarps, qbuf + ((round + 1) & 1) * 16 * LD,
                 lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    if (live) rope_q<HD>(a, t, qs, lane);
    __syncwarp();
    float acc[HD / 8][4];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    float m[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
    float l[2] = {0.f, 0.f};
    float s[KB / 8][4];
    if (nkb == 1) {
      if (live) {
        const int n16 = (a.S + 15) / 16;
        qk<HD>(s, qs, ks, n16, lane);
        logits(s, bs, a.scale, a.S, lane);
        stats(s, m, l);
        pv<HD>(s, l, acc, vs, n16, lane);
      }
    } else {
      for (int pass = 0; pass < 2; ++pass) {
        // pass 0: the row max and sum; pass 1: the probabilities times v
        for (int kb = 0; kb < nkb; ++kb) {
          const int valid = min(KB, a.S - kb * KB), n16 = (valid + 15) / 16;
          __syncthreads();
          copy_keys<HD>(a, b, g, kb * KB, pass == 1, ks, vs, bs);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          rope_keys<HD>(a, kb * KB, ks);
          __syncthreads();
          if (live) {
            qk<HD>(s, qs, ks, n16, lane);
            logits(s, bs, a.scale, valid, lane);
            if (pass == 0) {
              stats(s, m, l);
            } else {
#pragma unroll
              for (int nt = 0; nt < KB / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  s[nt][e] = expf(s[nt][e] - m[e / 2]);
              pv<HD>(s, l, acc, vs, n16, lane);
            }
          }
        }
      }
    }
    if (live) store_out<HD>(a, b, g, t, acc, qs, lane);
  }
}

// an instance's shared memory (above 48 KB), its resident blocks an SM at
// that size and the card's SMs, asked for once (at its first, eager call:
// never while a graph is captured)
struct Setup {
  cudaError_t rc = cudaSuccess;
  int per_sm = 0, n_sm = 0;
};

template <int HD>
const Setup& setup() {
  static const Setup setup = [] {
    Setup p;
    const auto kernel = rope_gqa_attention_kernel<HD>;
    int dev = 0;
    if ((p.rc = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             Layout<HD>::bytes)))
      return p;
    if ((p.rc = cudaGetDevice(&dev))) return p;
    if ((p.rc = cudaDeviceGetAttribute(&p.n_sm,
                                       cudaDevAttrMultiProcessorCount, dev)))
      return p;
    if ((p.rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &p.per_sm, kernel, kThreads, Layout<HD>::bytes)))
      return p;
    if (p.per_sm < 1) p.rc = cudaErrorInvalidConfiguration;
    return p;
  }();
  return setup;
}

// The blocks each (batch row, KV head) group's query tiles are split over,
// from the shapes and the card: a block takes whole rounds (a tile a
// warp), as few as let every block be resident at once, so that a group's
// k and v are loaded once a block and no warp waits a round where a block
// could start; no block is left empty.
int split_of(int B, int S, int n_q, int n_kv, int resident) {
  const int64_t tiles = (static_cast<int64_t>(n_q / n_kv) * S + 15) / 16;
  const int64_t slots = static_cast<int64_t>(kWarps) * resident;
  const int64_t rounds = (tiles * B * n_kv + slots - 1) / slots;
  return static_cast<int>((tiles + rounds * kWarps - 1) / (rounds * kWarps));
}

// f(std::integral_constant<int, HD>) for the instance of head dim hd: every
// multiple of 16 up to 128
template <class F>
cudaError_t by_head_dim(int hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

bool takes(int32_t B, int32_t S, int32_t n_q, int32_t n_kv) {
  return B > 0 && S > 0 && n_kv > 0 && n_q % n_kv == 0;
}

}  // namespace

// q [B, S, Nq, hd], k and v [B, S, Nkv, hd] (bf16), cos and sin [S, hd],
// bias [B, S] (float32) -> out [B, S, Nq * hd] (bf16)
extern "C" int srt_rope_attention(const void* q, const void* k, const void* v,
                                  const float* cos, const float* sin,
                                  const float* bias, void* out, int32_t B,
                                  int32_t S, int32_t n_q, int32_t n_kv,
                                  int32_t hd, float scale,
                                  cudaStream_t stream) {
  if (!takes(B, S, n_q, n_kv)) return cudaErrorInvalidValue;
  return static_cast<int>(by_head_dim(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    const Setup& p = setup<HD>();
    if (p.rc) return p.rc;
    const int split = split_of(B, S, n_q, n_kv, p.per_sm * p.n_sm);
    const int64_t blocks = static_cast<int64_t>(B) * n_kv * split;
    if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
    const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), cos, sin, bias,
                 static_cast<bf16*>(out), S, n_q, n_kv, split, scale};
    rope_gqa_attention_kernel<HD>
        <<<static_cast<unsigned>(blocks), kThreads, Layout<HD>::bytes,
           stream>>>(a);
    return cudaGetLastError();
  }));
}

// the blocks srt_rope_attention splits each group's query tiles over on
// this card, into *split
extern "C" int srt_rope_attention_split(int32_t B, int32_t S, int32_t n_q,
                                        int32_t n_kv, int32_t hd,
                                        int32_t* split) {
  if (!takes(B, S, n_q, n_kv)) return cudaErrorInvalidValue;
  return static_cast<int>(by_head_dim(hd, [&](auto c) {
    const Setup& p = setup<decltype(c)::value>();
    if (!p.rc) *split = split_of(B, S, n_q, n_kv, p.per_sm * p.n_sm);
    return p.rc;
  }));
}
