// Per-step rank-1 cross attention of the train recurrence, with attention
// dropout, forward and backward.
//
// Replaces ser_tpu/ops/attention.py::_rank1_fused_impl, which the JAX
// package runs as fused XLA under jax.checkpoint, and its analytic backward
// _rank1_vjp_bwd. Not a Pallas kernel: the TPU path has none for training.
// Both recurrence directions at once, as the train step runs them:
//   x1 = c_l, x2 = c_a [2, B, D]; wq, wk [2, D]; D = 128; f32.
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
// int64 ops on any device; the backward regenerates it instead of loading it.
// The seed is read from device memory, so drawing it costs the host no sync.
//
// What bounds it on an H100: the exponentials. Each of the 2 B D^2 (i, k)
// pairs costs one expf, a hash and a few FMAs, forward and again twice
// backward; inputs and outputs are 2 B D floats each. At B = 80: 2.6 M pairs,
// 5.2 MB of exp work against 0.2 MB of bytes. chip_smoke.py prints the bound
// from the flop, SFU and byte rates.
//
// Design (a first kernel, simple and right): a block of D threads per
// (row b, direction d). The block keeps x2[b], wk (and x2 wk) in shared
// memory, reduces s, max(wk) and min(wk) once, and a thread takes a query
// row i, walking the D keys with e in registers. No [B, D, D] tensor is ever
// written: the backward recomputes e and the mask in two sweeps, first a
// thread a row i (den, num, A2, A3), then a thread a key k (B1, B2, B3) from
// per-row scalars in shared memory. All sums are f32 in a fixed order, and
// dwq, dwk are summed over b by a second small kernel in ascending b, with
// no atomics: two runs on one input are bit-equal. No tensor cores: the
// reductions carry a [D, D] operand that a product would round (the JAX
// package's note on _rank1_vjp_bwd).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int WARPS = D / 32;
constexpr uint32_t FMIX_M1 = 0x85EBCA6Bu;
constexpr uint32_t FMIX_M2 = 0xC2B2AE35u;
constexpr uint32_t SALT = 0x9E3779B9u;
constexpr float SCALE = 0.08838834764831845f;  // 1 / sqrt(D), rounded once

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= FMIX_M1;
  h ^= h >> 13;
  h *= FMIX_M2;
  h ^= h >> 16;
  return h;
}

// exp(alpha * w - m) with the plain version's two roundings (no FMA).
__device__ __forceinline__ float logit_exp(float alpha, float w, float m) {
  return expf(__fsub_rn(__fmul_rn(alpha, w), m));
}

// Sum, max and min over the block's D threads, in a fixed order.
struct BlockReduce {
  float part[3][WARPS];

  __device__ void run(float v_sum, float v_max, float v_min, float* out_sum,
                      float* out_max, float* out_min) {
    for (int o = 16; o > 0; o >>= 1) {
      v_sum += __shfl_xor_sync(0xffffffffu, v_sum, o);
      v_max = fmaxf(v_max, __shfl_xor_sync(0xffffffffu, v_max, o));
      v_min = fminf(v_min, __shfl_xor_sync(0xffffffffu, v_min, o));
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
      part[0][warp] = v_sum;
      part[1][warp] = v_max;
      part[2][warp] = v_min;
    }
    __syncthreads();
    float s = part[0][0], mx = part[1][0], mn = part[2][0];
    for (int w = 1; w < WARPS; ++w) {
      s += part[0][w];
      mx = fmaxf(mx, part[1][w]);
      mn = fminf(mn, part[2][w]);
    }
    *out_sum = s;
    *out_max = mx;
    *out_min = mn;
    __syncthreads();  // part is reused by the next reduction
  }
};

__device__ __forceinline__ uint32_t step_key(const int* seed, int step, int d) {
  return fmix32((uint32_t)seed[0] + fmix32(2u * (uint32_t)step + (uint32_t)d + SALT));
}

__device__ __forceinline__ uint32_t row_key(uint32_t skey, int b, int i) {
  return fmix32(skey + fmix32((uint32_t)(b * D + i) + SALT));
}

__global__ void __launch_bounds__(D) rank1_fwd_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const float* __restrict__ wq, const float* __restrict__ wk,
    const int* __restrict__ seed, int step, int B, uint32_t threshold,
    float keep, float* __restrict__ z) {
  __shared__ float sx2[D], swk[D];
  __shared__ BlockReduce red;
  const int b = blockIdx.x, d = blockIdx.y, i = threadIdx.x;
  const size_t row = ((size_t)d * B + b) * D;
  const float x1i = x1[row + i], x2i = x2[row + i];
  const float wki = wk[d * D + i];
  sx2[i] = x2i;
  swk[i] = wki;
  float s, wmax, wmin;
  red.run(x2i * wq[d * D + i], wki, wki, &s, &wmax, &wmin);  // syncs sx2, swk
  s *= SCALE;
  const float alpha = x1i * s;
  const float m = alpha > 0.f ? alpha * wmax : alpha * wmin;
  const uint32_t rkey = row_key(step_key(seed, step, d), b, i);
  float den = 0.f, num = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    const float e = logit_exp(alpha, swk[k], m);
    den += e;
    if (fmix32(rkey ^ (uint32_t)k) >= threshold) num = fmaf(e, sx2[k], num);
  }
  z[row + i] = (num / keep) / den;
}

__global__ void __launch_bounds__(D) rank1_bwd_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const float* __restrict__ wq, const float* __restrict__ wk,
    const int* __restrict__ seed, int step, int B, uint32_t threshold,
    float keep, const float* __restrict__ g, float* __restrict__ dx1,
    float* __restrict__ dx2, float* __restrict__ dwq_part,
    float* __restrict__ dwk_part) {
  __shared__ float sx2[D], swk[D], sx2wk[D];
  __shared__ float s_alpha[D], s_m[D], s_gn[D], s_gna[D], s_gda[D];
  __shared__ uint32_t s_rkey[D];
  __shared__ BlockReduce red;
  const int b = blockIdx.x, d = blockIdx.y, t = threadIdx.x;
  const size_t row = ((size_t)d * B + b) * D;
  const float x1t = x1[row + t], x2t = x2[row + t];
  const float wkt = wk[d * D + t], wqt = wq[d * D + t];
  sx2[t] = x2t;
  swk[t] = wkt;
  sx2wk[t] = x2t * wkt;
  float s, wmax, wmin;
  red.run(x2t * wqt, wkt, wkt, &s, &wmax, &wmin);
  s *= SCALE;

  // Sweep 1, a thread a query row i = t: den, num, A2, A3 over k.
  const float alpha = x1t * s;
  const float m = alpha > 0.f ? alpha * wmax : alpha * wmin;
  const uint32_t rkey = row_key(step_key(seed, step, d), b, t);
  float den = 0.f, num = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    const float e = logit_exp(alpha, swk[k], m);
    den += e;
    a3 = fmaf(e, swk[k], a3);
    if (fmix32(rkey ^ (uint32_t)k) >= threshold) {
      num = fmaf(e, sx2[k], num);
      a2 = fmaf(e, sx2wk[k], a2);
    }
  }
  const float gt = g[row + t];
  const float out = (num / keep) / den;
  const float gn = gt / den, gd = -gt * out / den;
  const float dalpha = gn * (a2 / keep) + gd * a3;
  dx1[row + t] = dalpha * s;
  s_alpha[t] = alpha;
  s_m[t] = m;
  s_gn[t] = gn;
  s_gna[t] = gn * alpha;
  s_gda[t] = gd * alpha;
  s_rkey[t] = rkey;
  float ds, unused_max, unused_min;
  red.run(dalpha * x1t, 0.f, 0.f, &ds, &unused_max, &unused_min);  // syncs s_*

  // Sweep 2, a thread a key k = t: B1, B2, B3 over i.
  float b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll 4
  for (int i = 0; i < D; ++i) {
    const float e = logit_exp(s_alpha[i], wkt, s_m[i]);
    b3 = fmaf(s_gda[i], e, b3);
    if (fmix32(s_rkey[i] ^ (uint32_t)t) >= threshold) {
      b1 = fmaf(s_gn[i], e, b1);
      b2 = fmaf(s_gna[i], e, b2);
    }
  }
  b1 /= keep;
  b2 /= keep;
  dx2[row + t] = b1 + ds * (SCALE * wqt);
  dwk_part[row + t] = x2t * b2 + b3;
  dwq_part[row + t] = SCALE * (ds * x2t);
}

// dwq, dwk = the per-row parts summed over b in ascending order.
__global__ void __launch_bounds__(D) rank1_sum_rows_kernel(
    const float* __restrict__ dwq_part, const float* __restrict__ dwk_part,
    int B, float* __restrict__ dwq, float* __restrict__ dwk) {
  const int d = blockIdx.x, k = threadIdx.x;
  float q = 0.f, w = 0.f;
  for (int b = 0; b < B; ++b) {
    const size_t at = ((size_t)d * B + b) * D + k;
    q += dwq_part[at];
    w += dwk_part[at];
  }
  dwq[d * D + k] = q;
  dwk[d * D + k] = w;
}

}  // namespace

// z [2, B, D] = the forward. Returns a CUDA error code, 0 on success.
extern "C" int rank1_attention_fwd(const float* x1, const float* x2,
                                   const float* wq, const float* wk,
                                   const int* seed, int step, int B,
                                   unsigned int threshold, float keep, float* z,
                                   void* stream) {
  rank1_fwd_kernel<<<dim3(B, 2), D, 0, (cudaStream_t)stream>>>(
      x1, x2, wq, wk, seed, step, B, threshold, keep, z);
  return (int)cudaGetLastError();
}

// dx1, dx2 [2, B, D] and dwq, dwk [2, D] from the output gradient g [2, B, D];
// part is scratch of 2 * 2 * B * D floats. Returns a CUDA error code.
extern "C" int rank1_attention_bwd(const float* x1, const float* x2,
                                   const float* wq, const float* wk,
                                   const int* seed, int step, int B,
                                   unsigned int threshold, float keep,
                                   const float* g, float* dx1, float* dx2,
                                   float* part, float* dwq, float* dwk,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* dwq_part = part;
  float* dwk_part = part + (size_t)2 * B * D;
  rank1_bwd_kernel<<<dim3(B, 2), D, 0, s>>>(x1, x2, wq, wk, seed, step, B,
                                            threshold, keep, g, dx1, dx2,
                                            dwq_part, dwk_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rank1_sum_rows_kernel<<<2, D, 0, s>>>(dwq_part, dwk_part, B, dwq, dwk);
  return (int)cudaGetLastError();
}
