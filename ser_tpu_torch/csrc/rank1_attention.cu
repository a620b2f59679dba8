// Per-step rank-1 cross attention of the train recurrence, with attention
// dropout, forward and backward.
//
// Replaces ser_tpu/ops/attention.py::_rank1_fused_impl, which the JAX
// package runs as fused XLA under jax.checkpoint, and its analytic backward
// _rank1_vjp_bwd. Not a Pallas kernel: the TPU path has none for training.
// Both recurrence directions at once, as the train step runs them:
//   x1 = c_l, x2 = c_a [2, B, D]; wq, wk [2, D]; D = 128; f32, or bf16 in a
//   --compute_dtype bf16 train step (the JAX package's bf16 step runs
//   _rank1_fused_impl on bf16 operands).
// Forward, for direction d, row b, query i (over keys k):
//   s = (x2 . wq) / sqrt(D), alpha = x1 * s,
//   m = alpha > 0 ? alpha * max(wk) : alpha * min(wk)   (the exact row max),
//   e = exp(alpha * wk[k] - m), den = sum_k e           (before dropout),
//   u = keep ? e / (1 - p) : 0, z = sum_k u * x2[k] / den.
// Backward (m held constant, as stop_gradient does in JAX), with
//   gn = g / den, gd = -g * z / den:
//   A2 = sum_k u x2 wk, A3 = sum_k e wk, dalpha = gn A2 + gd A3,
//   B1 = sum_i gn u, B2 = sum_i gn alpha u, B3 = sum_i gd alpha e,
//   dx1 = dalpha s, ds = sum_i dalpha x1, dx2 = B1 + ds wq / sqrt(D),
//   dwk = sum_b (x2 B2 + B3), dwq = sum_b ds x2 / sqrt(D).
//
// The dropout mask is a pure function of (seed, step, direction, b, i, k):
//   step_key = fmix32(seed + fmix32(2 step + d + SALT))
//   row_key  = fmix32(step_key + fmix32(b D + i + SALT))
//   keep     = fmix32(row_key ^ k) >= threshold,  threshold = floor(p 2^32)
// in uint32 arithmetic (fmix32 is murmur3's finaliser). Its products need only
// their low 32 bits, so ops/kernels/rank1.py draws the same mask with torch
// int64 ops on any device. The seed is read from device memory, so drawing it
// costs the host no sync. Since k < 2^16, the first step of fmix32(row_key ^ k),
// h ^= h >> 16, equals (row_key ^ (row_key >> 16)) ^ k: a row folds it in once
// (rpre below) and a pair pays the rest, fmix32_tail, bit for bit the same.
//
// What bounds it on an H100. Each of the 2 B D^2 (i, k) pairs costs one exp,
// in the forward and again in the backward (no [B, D, D] state is kept
// between the two); inputs and outputs are 2 B D floats each. At B = 80: 2.6 M
// pairs a pass, 0.63 us of exps at the SFU rate against 0.2 MB of bytes. The
// kernel's own floor lies above that: the hash is 8 integer operations a pair
// (xor k, two multiplies, two shift-xors, the compare) and the integer pipe
// issues half as fast as the float one, so about 1.3 us forward; the
// backward issues about 25 instructions a pair over its two passes, about
// 2.2 us. chip_smoke.py prints the bound, the floor and the share of each
// reached. What the card shows on top (PERF.md): the backward's serial
// tail, the last block's sum over b, and blocks that stall on their own
// dependent chains.
//
// Design, for Hopper:
// - Keys over lanes. A warp takes 8 query rows; the 128 keys of a row are
//   spread over its lanes, lane l taking keys l, l + 32, l + 64, l + 96,
//   whose wk, x2 (and x2 wk) it holds in registers for all its rows. Each
//   block first reads its inputs in one round (load_tile): x2[b] and wk into
//   shared memory, s, max(wk) and min(wk) reduced once, and each of its query
//   rows' alpha log2(e), m log2(e) and folded row key.
// - The forward is one launch of 4 blocks of 128 threads per (row b,
//   direction d), a quarter of the query rows each: 8 B blocks, about five an
//   SM at B = 80, so no SM holds twice the work of another.
// - e = 2^(alpha log2(e) wk - m log2(e)): one FFMA and ex2.approx.ftz a pair.
//   For a shifted logit x <= 0 the argument carries a relative rounding error
//   of a few 2^-24 from the two pre-scaled products and the FFMA, so e carries
//   about |x| 2^-23 relative error, plus ex2.approx's 2^-22; a term with
//   |x| > 20 is below e^-20 of the row's largest. The tolerance is 1e-4
//   relative (chip_smoke.py RANK1_RTOL). Divisions by den are products with
//   its correctly rounded reciprocal.
// - Row sums (den, num; in the backward A2, A3) are taken in registers over a
//   lane's 4 keys for a group of rows (FWD_GROUP, BWD_GROUP: the sizes the
//   card ran fastest), then summed over the warp by a reduce-scatter: each
//   shuffle round a lane keeps half its values and adds the partner's half,
//   so 8 values cost 9 shuffles instead of 40. The tree is fixed: the sums do
//   not depend on timing.
// - The backward is one launch of a block of 512 threads (16 warps) per
//   (b, d), and one sweep. Pass 1 computes each pair's e and keep bit once,
//   keeps the block's e tile (128 x 128 f32, 64 KB) and its keep bits (a
//   ballot a key group, 2 KB) in dynamic shared memory, and the row sums give
//   gn, gd and dx1. Pass 2 sums the columns B1, B2, B3 from shared memory, a
//   quarter of the rows a thread, four rows' keep words and scalars read as
//   vectors, the four quarters added in order. dwq and dwk are sums over b:
//   each block writes its row's parts to scratch, takes an integer ticket,
//   and the last block of a direction reads every part in one round of
//   16-byte loads (at B <= 80), stages them in its shared memory, adds them
//   in ascending b and resets the ticket. No float atomics: three runs on one
//   input are bit-equal.
// No tensor cores: the reductions carry a [D, D] operand that a product would
// round (the JAX package's note on _rank1_vjp_bwd).
//
// bf16. Both kernels are templates over the storage type T (float or
// __nv_bfloat16). A bf16 input is widened to f32 at its global load; the
// shared-memory tiles, ex2 and every sum stay f32, and z, dx1 and dx2 are
// rounded once at their store (__float2bfloat16_rn). The dwq and dwk parts
// stay f32 in the scratch, and the last block's in-order sum over b is
// rounded once at its store. So the bf16 kernel computes the plain bf16
// form of ops/kernels/rank1.py: the f32 function on the widened inputs, each
// output rounded once. The hash does not read T: the bf16 kernel drops
// exactly the entries the f32 kernel drops. A bf16 launch moves half the
// bytes; the exps, which bound it, are the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int THREADS = 512;                   // the backward's block: a tile
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = D / WARPS;       // 8
constexpr int KEYS_PER_LANE = D / 32;          // 4
constexpr int QUARTERS = THREADS / D;          // pass 2: row groups a column
constexpr int FWD_THREADS = D;                 // the forward's block: a quarter tile
constexpr int FWD_SPLIT = THREADS / FWD_THREADS;
constexpr int SUM_CHUNK = 80;                  // b a round of the sums over b
constexpr int FWD_GROUP = 4;                   // rows a warp sums at once, forward
constexpr int BWD_GROUP = 2;                   // and backward
constexpr uint32_t FULL = 0xffffffffu;
constexpr uint32_t FMIX_M1 = 0x85EBCA6Bu;
constexpr uint32_t FMIX_M2 = 0xC2B2AE35u;
constexpr uint32_t SALT = 0x9E3779B9u;
constexpr float SCALE = 0.08838834764831845f;  // 1 / sqrt(D), rounded once
constexpr float LOG2E = 1.4426950408889634f;
static_assert(ROWS_PER_WARP * WARPS == D && QUARTERS * D == THREADS, "tiling");
constexpr int SUM_LOADS = 2 * SUM_CHUNK * D / 4 / THREADS;  // float4s a thread
static_assert(SUM_LOADS * 4 * THREADS == 2 * SUM_CHUNK * D, "whole float4s a thread");

// the backward's dynamic shared memory: the e tile, the keep bits, the
// per-row arrays (gn, gn alpha, gd alpha, dalpha x1, and the tile's inputs:
// x2, wk, wq, alpha log2(e), m log2(e), alpha, x1, g, folded row key) and
// pass 2's column parts
constexpr int BWD_ROW_ARRAYS = 13;
constexpr int BWD_LAYOUT =
    (D * D + D * KEYS_PER_LANE + BWD_ROW_ARRAYS * D + QUARTERS * 3 * D) * 4;
// after the ticket the last block stages SUM_CHUNK rows of both parts there
constexpr int BWD_SMEM = BWD_LAYOUT > 2 * SUM_CHUNK * D * 4 ? BWD_LAYOUT
                                                            : 2 * SUM_CHUNK * D * 4;

// a global element widened to f32, and an f32 value rounded once to T
__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= FMIX_M1;
  h ^= h >> 13;
  h *= FMIX_M2;
  h ^= h >> 16;
  return h;
}

// fmix32 after its first shift-xor: fmix32(h) == fmix32_tail(h ^ (h >> 16))
__device__ __forceinline__ uint32_t fmix32_tail(uint32_t h) {
  h *= FMIX_M1;
  h ^= h >> 13;
  h *= FMIX_M2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t step_key(const int* seed, int step, int d) {
  return fmix32((uint32_t)seed[0] + fmix32(2u * (uint32_t)step + (uint32_t)d + SALT));
}

__device__ __forceinline__ uint32_t row_key(uint32_t skey, int b, int i) {
  return fmix32(skey + fmix32((uint32_t)(b * D + i) + SALT));
}

// keep bit of pair (i, k) from the row's folded key rpre = rkey ^ (rkey >> 16)
__device__ __forceinline__ bool kept(uint32_t rpre, int k, uint32_t threshold) {
  return fmix32_tail(rpre ^ (uint32_t)k) >= threshold;
}

// Sums v[n], n < N, over the warp's 32 lanes and returns the total of
// v[lane / (32 / N)] (N a power of two, 2 <= N <= 32). Round o halves the
// values a lane holds: the lane keeps the half its bit o selects and adds the
// partner's copy of it; once one value is left, plain butterflies.
template <int N>
__device__ __forceinline__ float warp_sum_scatter(float (&v)[N], int lane) {
#pragma unroll
  for (int level = 0; (N >> (level + 1)) >= 1; ++level) {
    const int h = N >> (level + 1), o = 16 >> level;
    const bool up = lane & o;
#pragma unroll
    for (int a = 0; a < h; ++a) {
      const float send = up ? v[a] : v[a + h];
      const float mine = up ? v[a + h] : v[a];
      v[a] = mine + __shfl_xor_sync(FULL, send, o);
    }
  }
  float total = v[0];
#pragma unroll
  for (int o = 16 / N; o >= 1; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
  return total;
}

// component r of a vector, r known when unrolled
__device__ __forceinline__ float at(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t at(const uint4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// The block's inputs, read in one round by its first D threads: x2[b], wk
// (and wq when wq_s is given) into shared memory, s = (x2[b] . wq) / sqrt(D)
// with max(wk) and min(wk), and for the block's query rows r0 + t, t < rows,
// at index t: alpha log2(e), m log2(e), the folded row key, and when their
// arrays are given alpha, x1 and g. Every thread of the block (at least D)
// calls it; it returns s.
struct TileIn {
  float *x2_s, *wk_s, *wq_s, *a2_s, *m2_s, *alpha_s, *x1_s, *g_s;
  uint32_t* rpre_s;
};

template <typename T>
__device__ __forceinline__ float load_tile(
    const T* __restrict__ x1, const T* __restrict__ x2,
    const T* __restrict__ wq, const T* __restrict__ wk,
    const T* __restrict__ g, const int* __restrict__ seed, int step, int B,
    int b, int d, int r0, int rows, const TileIn& in) {
  __shared__ float part[3][D / 32];
  const int t = threadIdx.x, lane = t & 31;
  const size_t row = ((size_t)d * B + b) * D;
  float x1t = 0.f, gt = 0.f;
  uint32_t rpre = 0;
  if (t < D) {
    const float x2t = ld(x2, row + t), wqt = ld(wq, d * D + t), wkt = ld(wk, d * D + t);
    if (t < rows) {
      x1t = ld(x1, row + r0 + t);
      if (in.g_s != nullptr) gt = ld(g, row + r0 + t);
      const uint32_t rkey = row_key(step_key(seed, step, d), b, r0 + t);
      rpre = rkey ^ (rkey >> 16);
    }
    in.x2_s[t] = x2t;
    in.wk_s[t] = wkt;
    if (in.wq_s != nullptr) in.wq_s[t] = wqt;
    float v_sum = x2t * wqt, v_max = wkt, v_min = wkt;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v_sum += __shfl_xor_sync(FULL, v_sum, o);
      v_max = fmaxf(v_max, __shfl_xor_sync(FULL, v_max, o));
      v_min = fminf(v_min, __shfl_xor_sync(FULL, v_min, o));
    }
    if (lane == 0) {
      part[0][t >> 5] = v_sum;
      part[1][t >> 5] = v_max;
      part[2][t >> 5] = v_min;
    }
  }
  __syncthreads();
  float s = part[0][0], wmax = part[1][0], wmin = part[2][0];
#pragma unroll
  for (int w = 1; w < D / 32; ++w) {
    s += part[0][w];
    wmax = fmaxf(wmax, part[1][w]);
    wmin = fminf(wmin, part[2][w]);
  }
  s *= SCALE;
  if (t < rows) {
    const float alpha = x1t * s;
    const float m = alpha > 0.f ? alpha * wmax : alpha * wmin;
    in.a2_s[t] = alpha * LOG2E;
    in.m2_s[t] = m * LOG2E;
    in.rpre_s[t] = rpre;
    if (in.alpha_s != nullptr) in.alpha_s[t] = alpha;
    if (in.x1_s != nullptr) in.x1_s[t] = x1t;
    if (in.g_s != nullptr) in.g_s[t] = gt;
  }
  __syncthreads();
  return s;
}

template <typename T>
__global__ void __launch_bounds__(FWD_THREADS) rank1_fwd_kernel(
    const T* __restrict__ x1, const T* __restrict__ x2,
    const T* __restrict__ wq, const T* __restrict__ wk,
    const int* __restrict__ seed, int step, int B, uint32_t threshold,
    float keep, T* __restrict__ z) {
  constexpr int ROWS = FWD_THREADS / 32 * ROWS_PER_WARP;  // a quarter of the rows
  __shared__ float x2_s[D], wk_s[D], a2_s[ROWS], m2_s[ROWS];
  __shared__ uint32_t rpre_s[ROWS];
  const int b = blockIdx.x / FWD_SPLIT, r0 = blockIdx.x % FWD_SPLIT * ROWS;
  const int d = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = ((size_t)d * B + b) * D;
  load_tile<T>(x1, x2, wq, wk, nullptr, seed, step, B, b, d, r0, ROWS,
            {x2_s, wk_s, nullptr, a2_s, m2_s, nullptr, nullptr, nullptr, rpre_s});

  float wk_j[KEYS_PER_LANE], x2_j[KEYS_PER_LANE];
#pragma unroll
  for (int j = 0; j < KEYS_PER_LANE; ++j) {
    wk_j[j] = wk_s[lane + 32 * j];
    x2_j[j] = x2_s[lane + 32 * j];
  }
  // the warp's rows in groups of FWD_GROUP; after the warp sum lane l holds
  // the total of v[l / SPREAD]: row l / (2 SPREAD), den, then num SPREAD on
  constexpr int SPREAD = 32 / (2 * FWD_GROUP);
#pragma unroll
  for (int g0 = 0; g0 < ROWS_PER_WARP; g0 += FWD_GROUP) {
    float v[2 * FWD_GROUP];  // (den, num) of the group's rows
#pragma unroll
    for (int r = 0; r < FWD_GROUP; ++r) {
      const int i = warp * ROWS_PER_WARP + g0 + r;
      const float a2 = a2_s[i], m2 = m2_s[i];
      const uint32_t rpre = rpre_s[i];
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int j = 0; j < KEYS_PER_LANE; ++j) {
        const float e = ex2(fmaf(a2, wk_j[j], -m2));
        den += e;
        num = fmaf(kept(rpre, lane + 32 * j, threshold) ? e : 0.f, x2_j[j], num);
      }
      v[2 * r] = den;
      v[2 * r + 1] = num;
    }
    const float den = warp_sum_scatter<2 * FWD_GROUP>(v, lane);
    const float num = __shfl_down_sync(FULL, den, SPREAD);
    if (lane % (2 * SPREAD) == 0)
      st(z, row + r0 + warp * ROWS_PER_WARP + g0 + lane / (2 * SPREAD),
         num * (1.f / keep) * __frcp_rn(den));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) rank1_bwd_kernel(
    const T* __restrict__ x1, const T* __restrict__ x2,
    const T* __restrict__ wq, const T* __restrict__ wk,
    const int* __restrict__ seed, int step, int B, uint32_t threshold,
    float keep, const T* __restrict__ g, T* __restrict__ dx1,
    T* __restrict__ dx2, float* __restrict__ dwq_part,
    float* __restrict__ dwk_part, int* __restrict__ ticket,
    T* __restrict__ dwq, T* __restrict__ dwk) {
  extern __shared__ float4 smem4[];
  float* e_s = (float*)smem4;                                  // [D][D]
  uint32_t* keep_s = (uint32_t*)(e_s + D * D);                 // [4][D] ballots
  float* rows_s = (float*)(keep_s + D * KEYS_PER_LANE);        // [BWD_ROW_ARRAYS][D]
  float *gn_s = rows_s, *gna_s = rows_s + D, *gda_s = rows_s + 2 * D,
        *dax_s = rows_s + 3 * D;                               // dax: dalpha x1
  const TileIn in{rows_s + 4 * D, rows_s + 5 * D, rows_s + 6 * D, rows_s + 7 * D,
                  rows_s + 8 * D, rows_s + 9 * D, rows_s + 10 * D, rows_s + 11 * D,
                  (uint32_t*)(rows_s + 12 * D)};
  float* col_s = rows_s + BWD_ROW_ARRAYS * D;                  // [QUARTERS][3][D]
  __shared__ float ds_s;
  __shared__ int last_s;

  const int b = blockIdx.x, d = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const size_t row = ((size_t)d * B + b) * D;
  const float s = load_tile(x1, x2, wq, wk, g, seed, step, B, b, d, 0, D, in);
  const float rkeep = 1.f / keep;

  // Pass 1: a warp's 8 rows in two groups of 4, keys over the lanes
  float wk_j[KEYS_PER_LANE], x2_j[KEYS_PER_LANE], x2wk_j[KEYS_PER_LANE];
#pragma unroll
  for (int j = 0; j < KEYS_PER_LANE; ++j) {
    wk_j[j] = in.wk_s[lane + 32 * j];
    x2_j[j] = in.x2_s[lane + 32 * j];
    x2wk_j[j] = x2_j[j] * wk_j[j];
  }
  // the warp's rows in groups of BWD_GROUP; after the warp sum lane l holds
  // the total of v[l / SPREAD]: row l / (4 SPREAD), den, num, A2, A3 SPREAD
  // lanes apart
  constexpr int SPREAD = 32 / (4 * BWD_GROUP);
#pragma unroll
  for (int r0 = 0; r0 < ROWS_PER_WARP; r0 += BWD_GROUP) {
    float v[4 * BWD_GROUP];  // (den, num, A2, A3) of the group's rows
#pragma unroll
    for (int r = 0; r < BWD_GROUP; ++r) {
      const int i = warp * ROWS_PER_WARP + r0 + r;
      const float a2 = in.a2_s[i], m2 = in.m2_s[i];
      const uint32_t rpre = in.rpre_s[i];
      float den = 0.f, num = 0.f, sa2 = 0.f, sa3 = 0.f;
#pragma unroll
      for (int j = 0; j < KEYS_PER_LANE; ++j) {
        const float e = ex2(fmaf(a2, wk_j[j], -m2));
        e_s[i * D + lane + 32 * j] = e;
        den += e;
        sa3 = fmaf(e, wk_j[j], sa3);
        const bool k_kept = kept(rpre, lane + 32 * j, threshold);
        const uint32_t bits = __ballot_sync(FULL, k_kept);
        if (lane == 0) keep_s[j * D + i] = bits;
        const float u = k_kept ? e : 0.f;
        num = fmaf(u, x2_j[j], num);
        sa2 = fmaf(u, x2wk_j[j], sa2);
      }
      v[4 * r] = den;
      v[4 * r + 1] = num;
      v[4 * r + 2] = sa2;
      v[4 * r + 3] = sa3;
    }
    const float den = warp_sum_scatter<4 * BWD_GROUP>(v, lane);
    const float num = __shfl_down_sync(FULL, den, SPREAD);
    const float sa2 = __shfl_down_sync(FULL, den, 2 * SPREAD);
    const float sa3 = __shfl_down_sync(FULL, den, 3 * SPREAD);
    if (lane % (4 * SPREAD) == 0) {
      const int i = warp * ROWS_PER_WARP + r0 + lane / (4 * SPREAD);
      const float rden = __frcp_rn(den);
      const float gn = in.g_s[i] * rden;
      const float gd = -gn * (num * rkeep * rden);
      const float dalpha = gn * (sa2 * rkeep) + gd * sa3;
      st(dx1, row + i, dalpha * s);
      gn_s[i] = gn;
      gna_s[i] = gn * in.alpha_s[i];
      gda_s[i] = gd * in.alpha_s[i];
      dax_s[i] = dalpha * in.x1_s[i];
    }
  }
  __syncthreads();

  // Pass 2: column k's sums over a quarter of the rows, from shared memory;
  // four rows a round, their keep words and row scalars read as vectors
  {
    const int k = t & (D - 1), q = t / D;
    const uint32_t bit = 1u << (k & 31);
    const uint32_t* kw = keep_s + (k >> 5) * D;
    float b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll 2
    for (int i = q * (D / QUARTERS); i < (q + 1) * (D / QUARTERS); i += 4) {
      const uint4 w = *(const uint4*)(kw + i);
      const float4 gn = *(const float4*)(gn_s + i);
      const float4 gna = *(const float4*)(gna_s + i);
      const float4 gda = *(const float4*)(gda_s + i);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = e_s[(i + r) * D + k];
        const float u = (at(w, r) & bit) ? e : 0.f;
        b1 = fmaf(at(gn, r), u, b1);
        b2 = fmaf(at(gna, r), u, b2);
        b3 = fmaf(at(gda, r), e, b3);
      }
    }
    col_s[(q * 3 + 0) * D + k] = b1;
    col_s[(q * 3 + 1) * D + k] = b2;
    col_s[(q * 3 + 2) * D + k] = b3;
    if (warp == 0) {
      float ds = dax_s[lane] + dax_s[lane + 32] + dax_s[lane + 64] + dax_s[lane + 96];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ds += __shfl_xor_sync(FULL, ds, o);
      if (lane == 0) ds_s = ds;
    }
  }
  __syncthreads();
  if (t < D) {
    float b1 = col_s[t], b2 = col_s[D + t], b3 = col_s[2 * D + t];
#pragma unroll
    for (int q = 1; q < QUARTERS; ++q) {
      b1 += col_s[(q * 3 + 0) * D + t];
      b2 += col_s[(q * 3 + 1) * D + t];
      b3 += col_s[(q * 3 + 2) * D + t];
    }
    const float ds = ds_s, x2t = in.x2_s[t];
    st(dx2, row + t, b1 * rkeep + ds * (SCALE * in.wq_s[t]));
    dwk_part[row + t] = x2t * (b2 * rkeep) + b3;
    dwq_part[row + t] = SCALE * (ds * x2t);
    __threadfence();  // the parts are seen before the ticket
  }

  // dwq, dwk: the last block of direction d to finish adds every block's
  // parts in ascending b, then resets the ticket for the next launch
  __syncthreads();
  if (t == 0) {
    last_s = atomicAdd(&ticket[d], 1) == B - 1;
    if (last_s) ticket[d] = 0;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // chunks of SUM_CHUNK rows of both parts (one chunk at B = 80): every
  // thread's 16-byte loads in flight at once, staged in shared memory, then
  // summed down the columns in ascending b, dwq by threads < D and dwk by the
  // next D
  float acc = 0.f;
  const int qty = t / D, k = t & (D - 1);
  for (int b0 = 0; b0 < B; b0 += SUM_CHUNK) {
    const int n4 = min(SUM_CHUNK, B - b0) * D / 4;  // float4s of one part
    float4 buf[SUM_LOADS];
#pragma unroll
    for (int u = 0; u < SUM_LOADS; ++u) {
      const int f = t + u * THREADS;
      if (f < 2 * n4)
        buf[u] = __ldcg((const float4*)((f < n4 ? dwq_part : dwk_part) +
                                        ((size_t)d * B + b0) * D) + (f < n4 ? f : f - n4));
    }
    __syncthreads();  // the previous chunk is summed
#pragma unroll
    for (int u = 0; u < SUM_LOADS; ++u) {
      const int f = t + u * THREADS;
      if (f < 2 * n4) smem4[(f < n4 ? 0 : SUM_CHUNK * D / 4) + (f < n4 ? f : f - n4)] = buf[u];
    }
    __syncthreads();
    if (t < 2 * D) {
      const float* stage = e_s + qty * SUM_CHUNK * D;
#pragma unroll 8
      for (int bb = 0; bb < n4 * 4 / D; ++bb) acc += stage[bb * D + k];
    }
  }
  if (t < 2 * D) st(qty == 0 ? dwq : dwk, d * D + k, acc);
}

// the backward's shared memory above 48 KB, allowed once per device and type
template <typename T>
cudaError_t allow_bwd_smem() {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(rank1_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T>
int launch_fwd(const T* x1, const T* x2, const T* wq, const T* wk, const int* seed,
               int step, int B, unsigned int threshold, float keep, T* z,
               void* stream) {
  rank1_fwd_kernel<T><<<dim3(FWD_SPLIT * B, 2), FWD_THREADS, 0, (cudaStream_t)stream>>>(
      x1, x2, wq, wk, seed, step, B, threshold, keep, z);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* x1, const T* x2, const T* wq, const T* wk, const int* seed,
               int step, int B, unsigned int threshold, float keep, const T* g,
               T* dx1, T* dx2, float* part, int* ticket, T* dwq, T* dwk,
               void* stream) {
  cudaError_t err = allow_bwd_smem<T>();
  if (err != cudaSuccess) return (int)err;
  rank1_bwd_kernel<T><<<dim3(B, 2), THREADS, BWD_SMEM, (cudaStream_t)stream>>>(
      x1, x2, wq, wk, seed, step, B, threshold, keep, g, dx1, dx2, part,
      part + (size_t)2 * B * D, ticket, dwq, dwk);
  return (int)cudaGetLastError();
}

}  // namespace

// z [2, B, D] = the forward. Returns a CUDA error code, 0 on success.
extern "C" int rank1_attention_fwd(const float* x1, const float* x2,
                                   const float* wq, const float* wk,
                                   const int* seed, int step, int B,
                                   unsigned int threshold, float keep, float* z,
                                   void* stream) {
  return launch_fwd(x1, x2, wq, wk, seed, step, B, threshold, keep, z, stream);
}

// The same on bf16 x1, x2, wq, wk; z bf16.
extern "C" int rank1_attention_fwd_bf16(const __nv_bfloat16* x1, const __nv_bfloat16* x2,
                                        const __nv_bfloat16* wq, const __nv_bfloat16* wk,
                                        const int* seed, int step, int B,
                                        unsigned int threshold, float keep,
                                        __nv_bfloat16* z, void* stream) {
  return launch_fwd(x1, x2, wq, wk, seed, step, B, threshold, keep, z, stream);
}

// dx1, dx2 [2, B, D] and dwq, dwk [2, D] from the output gradient g [2, B, D],
// in one launch. part is scratch of 2 * 2 * B * D floats and ticket two ints
// that are 0 before the launch (the launch leaves them 0); neither may be
// shared with a launch that runs at the same time. Returns a CUDA error code.
extern "C" int rank1_attention_bwd(const float* x1, const float* x2,
                                   const float* wq, const float* wk,
                                   const int* seed, int step, int B,
                                   unsigned int threshold, float keep,
                                   const float* g, float* dx1, float* dx2,
                                   float* part, int* ticket, float* dwq,
                                   float* dwk, void* stream) {
  return launch_bwd(x1, x2, wq, wk, seed, step, B, threshold, keep, g, dx1, dx2,
                    part, ticket, dwq, dwk, stream);
}

// The same on bf16 inputs and g; dx1, dx2, dwq, dwk bf16, part f32.
extern "C" int rank1_attention_bwd_bf16(const __nv_bfloat16* x1, const __nv_bfloat16* x2,
                                        const __nv_bfloat16* wq, const __nv_bfloat16* wk,
                                        const int* seed, int step, int B,
                                        unsigned int threshold, float keep,
                                        const __nv_bfloat16* g, __nv_bfloat16* dx1,
                                        __nv_bfloat16* dx2, float* part, int* ticket,
                                        __nv_bfloat16* dwq, __nv_bfloat16* dwk,
                                        void* stream) {
  return launch_bwd(x1, x2, wq, wk, seed, step, B, threshold, keep, g, dx1, dx2,
                    part, ticket, dwq, dwk, stream);
}

// out[0..5]: the forward's threads a block and blocks a (row, direction),
// the backward's threads a block and dynamic shared memory in bytes, and the
// blocks an SM holds of the forward and of the backward.
extern "C" int rank1_attention_occupancy(int* out) {
  cudaError_t err = allow_bwd_smem<float>();
  if (err != cudaSuccess) return (int)err;
  out[0] = FWD_THREADS;
  out[1] = FWD_SPLIT;
  out[2] = THREADS;
  out[3] = BWD_SMEM;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], rank1_fwd_kernel<float>,
                                                      FWD_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[5], rank1_bwd_kernel<float>, THREADS, BWD_SMEM);
}
