// Bidirectional MARN1_onlysp eval recurrence, one kernel for both directions.
//
// Replaces the Pallas kernel ser_tpu/ops/pallas/lsthm.py::
// lsthm_onlysp_recurrence_bidir (and, with one direction, its sibling
// lsthm_onlysp_recurrence). Same contract:
//   seqs   xl, xa [T,2,B,4H], gx [T,2,B,3H], qm [T,2,B,2]
//   consts Kl, Ka [2,3H,4H] (rows h|z|h_s), bl, ba [2,4H], gWhh [2,H,3H],
//          gbhh [2,3H], wq, wk [2,H]
//   out    [T,2,B,4H] = [h_l | h_a | z | h_s] per step; f32, H = 128, P = 2.
//
// What bounds it on an H100: a serial chain of T steps, each a few small
// products that depend on the step before. At the IEMOCAP eval shape
// (T = 82, B = 31, both directions) the work is about 4.9 GFLOP of f32 and
// 43 MB of inputs, outputs and weights, i.e. 0.07 ms at the 67 TFLOP/s f32
// peak and 0.013 ms at 3.35 TB/s. No amount of bandwidth helps the chain:
// what counts is how short one step is on the SMs that hold it.
//
// Design:
// - Grid: one block per (batch tile of R rows, direction). The TPU's
//   sequential grid axis over T is a loop inside the block, with
//   __syncthreads() between the phases of a step. B is not padded; the
//   ragged last tile reads zeros and writes nothing for rows >= B.
// - Carries (h_l, c_l, h_a, c_a, z, q0, q1) stay in shared memory for all T
//   steps, next to the step's state rows and gate sums (~71 KB, dynamic).
// - Weights: one direction's weights are 1.77 MB, far more than an SM's
//   227 KB of shared memory, so every step streams them from L2 (both
//   directions' 3.5 MB stay resident in the 50 MB L2). Thread j owns gate
//   column j and reads K[k, j], so a warp reads 128 contiguous bytes, and
//   every weight read feeds R = 8 rows. The later alternative is to split
//   the gate columns across a thread-block cluster so that each SM keeps its
//   slice of the weights in shared memory for all T steps.
// - Numerics: f32 throughout, expf/tanhf, no fast math. The sigmoid is
//   1/(1+expf(-x)), which saturates to 0 or 1 without NaN. The attention
//   softmax uses the exact row max of the rank-1 logits, alpha*max(wk) or
//   alpha*min(wk), so every exponent is <= 0.

#include <cuda_runtime.h>

namespace {

constexpr int H = 128;       // hidden width of every state (Hl = Ha = Hs)
constexpr int G = 4 * H;     // LSTHM gate width, f | i | o | c-hat
constexpr int GH = 3 * H;    // GRU gate width, r | z | n; also LSTHM state rows
constexpr int R = 8;         // batch rows per block
constexpr int NT = G;        // threads per block: one per LSTHM gate column
constexpr int RSTEP = NT / H;      // rows covered by one pass of the elementwise phases
constexpr int EPT = R / RSTEP;     // (row, unit) pairs per thread in those phases
constexpr float kInvSqrtH = 0.08838834764831845f;  // 1 / sqrt(128)

struct Smem {
  float X[4 * H][R];   // per row [h_l | h_a | z | h_s], k-major for the state products
  float qs[H][R];      // selected speaker memory qs0, k-major
  float cl[R][H];
  float ca[R][H];
  float q0[R][H];      // party memories
  float q1[R][H];
  float gl[R][G];      // text gate sums; first 3H columns hold the GRU h-side projection
  float ga[R][G];      // audio gate sums
  float wq[H];
  float wk[H];
  float s[R];          // (c_a . wq) / sqrt(H) per row
  float wkmax;
  float wkmin;
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void load_rows(const float (*X)[R], int k, float v[R]) {
  const float4 a = *reinterpret_cast<const float4*>(&X[k][0]);
  const float4 b = *reinterpret_cast<const float4*>(&X[k][4]);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__global__ void __launch_bounds__(NT, 1) lsthm_onlysp_bidir_kernel(
    const float* __restrict__ xl, const float* __restrict__ xa,
    const float* __restrict__ gx, const float* __restrict__ qm,
    const float* __restrict__ Kl, const float* __restrict__ bl,
    const float* __restrict__ Ka, const float* __restrict__ ba,
    const float* __restrict__ gWhh, const float* __restrict__ gbhh,
    const float* __restrict__ wq, const float* __restrict__ wk,
    float* __restrict__ out, int T, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * R;

  Kl += (size_t)d * GH * G;
  Ka += (size_t)d * GH * G;
  bl += d * G;
  ba += d * G;
  gWhh += (size_t)d * H * GH;
  gbhh += d * GH;

  for (int e = tid; e < 4 * H * R; e += NT) (&s.X[0][0])[e] = 0.f;
  for (int e = tid; e < R * H; e += NT) {
    (&s.cl[0][0])[e] = 0.f;
    (&s.ca[0][0])[e] = 0.f;
    (&s.q0[0][0])[e] = 0.f;
    (&s.q1[0][0])[e] = 0.f;
  }
  if (tid < H) {
    s.wq[tid] = wq[d * H + tid];
    s.wk[tid] = wk[d * H + tid];
  }
  __syncthreads();
  if (tid == 0) {
    float mx = s.wk[0], mn = s.wk[0];
    for (int k = 1; k < H; ++k) {
      mx = fmaxf(mx, s.wk[k]);
      mn = fminf(mn, s.wk[k]);
    }
    s.wkmax = mx;
    s.wkmin = mn;
  }

  // In the elementwise phases thread tid owns unit i of rows r0 + RSTEP*p.
  const int i = tid % H;
  const int r0 = tid / H;

  for (int t = 0; t < T; ++t) {
    const size_t row0 = ((size_t)t * 2 + d) * B;  // flat row of (t, d, b = 0)

    // 1. Speaker select: one-hot of argmax(qmask), so a tie or an
    //    all-zero (padded) row picks party 0.
    for (int p = 0; p < EPT; ++p) {
      const int r = r0 + RSTEP * p, b = b0 + r;
      float m0 = 0.f, m1 = 0.f;
      if (b < B) {
        m0 = qm[(row0 + b) * 2];
        m1 = qm[(row0 + b) * 2 + 1];
      }
      s.qs[i][r] = (m1 > m0) ? s.q1[r][i] : s.q0[r][i];
    }
    __syncthreads();

    // 2. GRU h side: qs0 @ gWhh + gbhh into gl[:, :3H].
    if (tid < GH) {
      float acc[R], v[R];
      const float bias = gbhh[tid];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = bias;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = gWhh[k * GH + tid];
        load_rows(s.qs, k, v);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(v[r], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) s.gl[r][tid] = acc[r];
    }
    __syncthreads();

    // 3. GRU gates (r, z, n), then scatter h_s into the party memory with
    //    the raw qmask, so a padded step leaves q untouched.
    for (int p = 0; p < EPT; ++p) {
      const int r = r0 + RSTEP * p, b = b0 + r;
      float xr = 0.f, xz = 0.f, xn = 0.f, m0 = 0.f, m1 = 0.f;
      if (b < B) {
        const float* g = gx + (row0 + b) * GH;
        xr = g[i];
        xz = g[H + i];
        xn = g[2 * H + i];
        m0 = qm[(row0 + b) * 2];
        m1 = qm[(row0 + b) * 2 + 1];
      }
      const float rg = sigmoid(xr + s.gl[r][i]);
      const float zg = sigmoid(xz + s.gl[r][H + i]);
      const float n = tanhf(xn + rg * s.gl[r][2 * H + i]);
      const float hs = (1.f - zg) * n + zg * s.qs[i][r];
      s.X[3 * H + i][r] = hs;
      s.q0[r][i] = s.q0[r][i] * (1.f - m0) + hs * m0;
      s.q1[r][i] = s.q1[r][i] * (1.f - m1) + hs * m1;
    }
    __syncthreads();

    // 4. Both LSTHM sums from the old h, the old z and the new h_s:
    //    x_proj + [h | z | h_s] @ K + b, column j = tid of each.
    {
      const int j = tid;
      float al[R], aa[R], v[R], u[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        al[r] = bl[j] + (b < B ? xl[(row0 + b) * G + j] : 0.f);
        aa[r] = ba[j] + (b < B ? xa[(row0 + b) * G + j] : 0.f);
      }
#pragma unroll 2
      for (int k = 0; k < H; ++k) {  // K rows 0..H-1 multiply each modality's own h
        const float wl = Kl[k * G + j];
        const float wa = Ka[k * G + j];
        load_rows(s.X, k, v);
        load_rows(s.X, H + k, u);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          al[r] = fmaf(v[r], wl, al[r]);
          aa[r] = fmaf(u[r], wa, aa[r]);
        }
      }
#pragma unroll 4
      for (int k = H; k < GH; ++k) {  // K rows H..3H-1 multiply the shared z | h_s
        const float wl = Kl[k * G + j];
        const float wa = Ka[k * G + j];
        load_rows(s.X, H + k, v);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          al[r] = fmaf(v[r], wl, al[r]);
          aa[r] = fmaf(v[r], wa, aa[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s.gl[r][j] = al[r];
        s.ga[r][j] = aa[r];
      }
    }
    __syncthreads();

    // 5. LSTHM gates in the order f, i, o, c-hat.
    for (int p = 0; p < EPT; ++p) {
      const int r = r0 + RSTEP * p;
      const float cl = sigmoid(s.gl[r][i]) * s.cl[r][i] +
                       sigmoid(s.gl[r][H + i]) * tanhf(s.gl[r][3 * H + i]);
      const float ca = sigmoid(s.ga[r][i]) * s.ca[r][i] +
                       sigmoid(s.ga[r][H + i]) * tanhf(s.ga[r][3 * H + i]);
      s.cl[r][i] = cl;
      s.ca[r][i] = ca;
      s.X[i][r] = tanhf(cl) * sigmoid(s.gl[r][2 * H + i]);
      s.X[H + i][r] = tanhf(ca) * sigmoid(s.ga[r][2 * H + i]);
    }
    __syncthreads();

    // 6. s = (c_a . wq) / sqrt(H), one warp per row.
    {
      const int warp = tid / 32, lane = tid % 32;
      if (warp < R) {
        float acc = 0.f;
        for (int k = lane; k < H; k += 32) acc = fmaf(s.ca[warp][k], s.wq[k], acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) s.s[warp] = acc * kInvSqrtH;
      }
    }
    __syncthreads();

    // 7. Rank-1 attention from c_l to c_a: alpha = c_l * s, exact row max
    //    m, z_i = sum_k e^{alpha_i wk_k - m_i} c_a[k] / sum_k e^{...}; then
    //    write [h_l | h_a | z | h_s] for the rows of this tile.
    for (int p = 0; p < EPT; ++p) {
      const int r = r0 + RSTEP * p, b = b0 + r;
      const float a = s.cl[r][i] * s.s[r];
      const float m = a > 0.f ? a * s.wkmax : a * s.wkmin;
      float num = 0.f, den = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float e = expf(a * s.wk[k] - m);
        num = fmaf(e, s.ca[r][k], num);
        den += e;
      }
      const float z = num / den;
      s.X[2 * H + i][r] = z;
      if (b < B) {
        float* o = out + (row0 + b) * G;
        o[i] = s.X[i][r];
        o[H + i] = s.X[H + i][r];
        o[2 * H + i] = z;
        o[3 * H + i] = s.X[3 * H + i][r];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
extern "C" int lsthm_onlysp_bidir(
    const float* xl, const float* xa, const float* gx, const float* qm,
    const float* Kl, const float* bl, const float* Ka, const float* ba,
    const float* gWhh, const float* gbhh, const float* wq, const float* wk,
    float* out, int T, int B, void* stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      lsthm_onlysp_bidir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + R - 1) / R, 2);
  lsthm_onlysp_bidir_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      xl, xa, gx, qm, Kl, bl, Ka, ba, gWhh, gbhh, wq, wk, out, T, B);
  return (int)cudaGetLastError();
}
