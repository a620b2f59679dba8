// Bidirectional MARN1_onlysp eval recurrence, one kernel for both directions,
// one recurrence step spread over a thread-block cluster of 16 SMs.
//
// Replaces the Pallas kernel ser_tpu/ops/pallas/lsthm.py::
// lsthm_onlysp_recurrence_bidir (and, with one direction, its sibling
// lsthm_onlysp_recurrence). Same contract:
//   seqs   xl, xa [T,2,B,4H], gx [T,2,B,3H], qm [T,2,B,P]
//   consts Kl, Ka [2,3H,4H] (rows h|z|h_s), bl, ba [2,4H], gWhh [2,H,3H],
//          gbhh [2,3H], wq, wk [2,H]
//   out    [T,2,B,4H] = [h_l | h_a | z | h_s] per step; f32, H = 128.
// P, the number of parties, is a template parameter: 2 (IEMOCAP) and 9
// (MELD) are compiled. The Pallas kernels take P = 2 only; the JAX package
// runs P = 9 through lax.scan, whose math this is.
//
// What bounds it on an H100: a serial chain of T steps, each a few small
// products that depend on the step before. At the IEMOCAP eval shape
// (T = 82, B = 31, both directions) the work is about 4.9 GFLOP of f32 and
// 43 MB of inputs, outputs and weights, i.e. 0.07 ms at the 67 TFLOP/s f32
// peak and 0.013 ms at 3.35 TB/s. Neither rate is the limit: what counts is
// how short one step is, i.e. its synchronisations and the serial work
// between them. A kernel that holds a step on one SM and streams 1.77 MB of
// weights a direction from L2 at every step spends its time on load latency.
//
// Design:
// - Split by hidden unit over a cluster of C = 16 CTAs. CTA c owns units
//   [8c, 8c+8): the four LSTHM gate columns of those units in K_l and K_a
//   (2 x 32 columns, all 384 rows) and their three GRU columns of gWhh (24
//   columns, 128 rows). The slice, 110,592 bytes, is gathered into shared
//   memory once, 16 bytes a load (a unit's 8 columns of a gate are 32
//   contiguous bytes of a weight row), and stays there for all T steps; the
//   step loop reads no weight from device memory. Gates, cell update, GRU
//   and the attention row of a unit all finish inside the CTA that owns it.
// - What crosses SMs: every CTA needs the full 128-wide h_l, h_a, c_a, z and
//   h_s. A CTA writes its 8 units of each into its own copy, then copies
//   that chunk into the 15 peers' shared memory with st.async, 16 bytes a
//   store, each store counting its bytes on an mbarrier in the receiving
//   CTA; a CTA goes on when its mbarrier has counted the bytes of all 15
//   peers. No cluster barrier and no release fence sits in the step loop
//   (a barrier.cluster with release and acquire costs more than the copies'
//   own flight time). Every exchange is all-to-all, so the data flow orders
//   the CTAs by itself: a peer that writes step t's rows has received this
//   CTA's rows of the exchange before, which were sent after the last read
//   of what the peer overwrites. h_l, h_a and h_s are double-buffered,
//   because a fast CTA writes step t's rows while a slow peer still reads
//   step t-1's in the same phase; the mbarriers alternate between two per
//   exchange, so bytes of the next use cannot land in an open phase.
// - Two points of exchange a step, not three. The GRU speaker memory is a
//   recurrence of its own (h_s(t+1) needs the party memories after step t
//   and the inputs, nothing of the LSTHM), so step t computes h_s of step
//   t+1 beside its own LSTHM:
//     P1  [h(t-1) | z(t-1) | h_s(t)] @ K + x(t) + b and h_s(t) @ gWhh; the
//         LSTHM gates of step t and the GRU gates of step t+1 for the own
//         units; send c_a and this CTA's share of s = c_a . wq (exchange
//         A1), then h_l, h_a and h_s(t+1) (A2); wait for A1;
//     P2  the rank-1 attention rows of the own units, while A2 flies; send
//         z (exchange B); wait for A2, then for B.
//   Of the products of step t+1 only the z rows of K need exchange B: the
//   h and h_s rows and h_s(t+1) @ gWhh need A2 and run between the send of
//   z and the wait, in the flight time of exchange B.
// - No party memory in shared memory. q_p changes only by the scatter
//   q_p <- q_p (1 - m_p) + h_s m_p, and the GRU needs qs0 @ gWhh for qs0 the
//   party of argmax(qmask). The product is linear, so each thread keeps
//   P_p = q_p @ gWhh for its own (row, column) in registers and applies the
//   same scatter to it with X = h_s(t) @ gWhh: P_p <- P_p (1 - m_p) + X m_p.
//   For a one-hot or zero qmask this is exactly the product of the scattered
//   memory. The party memories of the own units (the GRU's z gate needs
//   qs0 itself) live in registers too. A thread holds P of each: P products
//   of its r/z column, and for a (row, unit) pair P products of its n
//   column and P memories; 3P floats, 27 at P = 9, in registers (ptxas
//   reports no spill, chip_smoke.py prints it). The scatter runs over all P
//   parties with the raw qmask; the select is argmax with the first index
//   winning on a tie (strict >, ascending p), as torch.argmax and
//   jnp.argmax pick, so an all-zero (padded) row takes party 0. At P = 2
//   this is the compare qmask[1] > qmask[0] the kernel always made.
// - The products are bound by shared-memory loads, not by FFMA: a warp-wide
//   load costs the bytes it returns to the 32 lanes, broadcast or not. So
//   the k axis is split over the 8 warps (warp w takes k in [16w, 16w+16)
//   of each of h, z, h_s), and a lane holds a tile as square as the shapes
//   give: 4 columns x R/2 rows of the CTA's 64 x R LSTHM sums (4 + R/2
//   floats loaded for 2R FFMAs a k), 3 columns x R/4 rows of the 24 x R GRU
//   sums. The 8 partial sums of an output go through shared memory and are
//   added in warp order, after x_proj + b, by the thread that applies the
//   output's sigmoid or tanh; these activations are spread over all 256
//   threads, a warp holding one kind. The order of every sum is fixed, so
//   two runs are bit-equal; it is not ascending k, and the result differs
//   from the plain version by summation order only (2e-7 over 110 steps).
// - s = c_a . wq: each CTA sums its own 8 units (a shuffle tree) and sends
//   the 16 shares around with exchange A1; every CTA adds them in CTA order.
// - The attention sum over k of a (unit, row) pair is split over 2-8
//   neighbouring lanes (as many as 256 threads give 8R pairs), each
//   ascending over its share, then a shuffle tree.
// - Inputs one step ahead: each thread loads the x, gx and qmask values it
//   will need in the next step into registers at the top of this step, so
//   no load from device memory sits on the chain. Outputs go straight to
//   device memory.
// - Rows per cluster R = 4, 8, 12, 16 (a template over R/4): the wrapper
//   picks the one that runs a call's clusters in the fewest waves. 16 is
//   what fits: 110.6 KB of weights, 4 KB of state and 3 KB of partial sums a
//   row under 227 KB, at P = 2 and at P = 9 alike (the qmask ring is
//   3 x R x P floats, the only part of the layout that grows with P).
// - Arithmetic stays FFMA: 4-16 rows are far below a wgmma tile's 64 and
//   the contract is fp32 with TF32 off, so tensor cores are not the lever.
// - Numerics: f32 throughout, expf/tanhf, no fast math. The sigmoid is
//   1/(1+expf(-x)), which saturates to 0 or 1 without NaN. The attention
//   softmax uses the exact row max of the rank-1 logits, alpha*max(wk) or
//   alpha*min(wk), so every exponent is <= 0. The ragged last tile reads
//   zeros and writes nothing for rows >= B.
//
// Shared memory a CTA, in floats (x 4 bytes), R rows:
//   weights 27,648 | h_l, h_a, h_s 2 x 128R each | c_a, z 128R each |
//   partial sums 8 x 72R and 8 x 24R | qmask ring 3PR | wq, wk 256 |
//   shares of s 16R | c_l 8R | max, min of wk 4 | 7 mbarriers 16.
//   P = 2: R = 8 170,000 bytes, R = 16 228,304 bytes.
//   P = 9: R = 8 170,672 bytes, R = 16 229,648 bytes (of 232,448).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int H = 128;       // hidden width of every state (Hl = Ha = Hs)
constexpr int G = 4 * H;     // LSTHM gate width, f | i | o | c-hat
constexpr int GH = 3 * H;    // GRU gate width, r | z | n; also LSTHM state rows
constexpr int C = 16;        // CTAs in a cluster (non-portable size)
constexpr int U = H / C;     // hidden units owned by one CTA
constexpr int NL = 2 * 4 * U;  // LSTHM gate columns of a CTA: [K_l f,i,o,c | K_a f,i,o,c] x U
constexpr int NG = 3 * U;      // GRU gate columns of a CTA: [r,z,n] x U
constexpr int NT = 256;        // threads per CTA
constexpr int NW = NT / 32;    // warps; each takes 1/NW of a product's k axis
constexpr int KW = H / NW;     // k per warp in each 128-row segment of a product
constexpr int SL = NL + 8;     // row stride of the LSTHM partial sums (bank spread)
constexpr float kInvSqrtH = 0.08838834764831845f;  // 1 / sqrt(128)
static_assert(NL == 4 * 16 && NG == 3 * 8, "lane tiles: 16 x 4 LSTHM, 8 x 3 GRU columns");
static_assert(U == 8, "a unit's columns of a gate are two 16-byte loads");

template <int RQ, int P>
struct Layout {  // offsets in floats into the dynamic shared memory
  static constexpr int R = 4 * RQ;
  static constexpr int HR = H * R;
  static constexpr int W = 0;               // [GH][NL]
  static constexpr int WG = W + GH * NL;    // [H][NG]
  static constexpr int HL = WG + H * NG;    // [2][H][R], k-major like all states
  static constexpr int HA = HL + 2 * HR;
  static constexpr int HS = HA + 2 * HR;
  static constexpr int CA = HS + 2 * HR;    // [H][R]
  static constexpr int Z = CA + HR;
  static constexpr int PS = Z + HR;         // [NW][R][SL] LSTHM partial sums; [0] the gates
  static constexpr int PG = PS + NW * R * SL;  // [NW][R][NG] GRU partial sums; [0] gates r, z
  static constexpr int QM = PG + NW * R * NG;  // [3][R][P] qmask of steps t, t+1, t+2
  static constexpr int WQ = QM + 3 * R * P;
  static constexpr int WK = WQ + H;
  static constexpr int SP = WK + H;         // [C][R] every CTA's share of c_a . wq
  static constexpr int CL = SP + C * R;     // [R][U] c_l of the own pairs
  static constexpr int MM = CL + U * R;     // max(wk), min(wk)
  static constexpr int MB = MM + 4;         // 7 mbarriers of 8 bytes: 2 each for A1, A2, B; set-up
  static constexpr int FLOATS = MB + 16;
  static constexpr unsigned kBytesUnits = (C - 1) * U * R * sizeof(float);  // one state from all peers
  static constexpr unsigned kBytesA1 = kBytesUnits + (C - 1) * R * sizeof(float);  // c_a, shares of s
  static constexpr unsigned kBytesA2 = 3 * kBytesUnits;                            // h_l, h_a, h_s
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Cluster barrier with release and acquire; outside the step loop only.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

typedef unsigned long long Mbarrier;

// One arrival completes a phase, once the bytes it expects have landed.
__device__ __forceinline__ void mbarrier_init(Mbarrier* mb) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(mb)) : "memory");
}

__device__ __forceinline__ void mbarrier_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbarrier_expect(Mbarrier* mb, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(mb)), "r"(bytes) : "memory");
}

// Spins until the phase of the given parity is complete; acquires the bytes
// that completed it.
__device__ __forceinline__ void mbarrier_wait(Mbarrier* mb, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(mb)), "r"(parity) : "memory");
  } while (!done);
}

// Stores v at the address of `local` in the shared memory of CTA `peer` and
// counts its 16 bytes on that CTA's mbarrier at the address of `mb`.
__device__ __forceinline__ void store_peer(const float* local, Mbarrier* mb, unsigned peer,
                                           float4 v) {
  unsigned ra, rm;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(smem_addr(local)), "r"(peer));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rm) : "r"(smem_addr(mb)), "r"(peer));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(ra), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rm) : "memory");
}

// Copies N floats at `chunk` (written locally and synchronised before) to
// the same place in all 15 peers.
template <int N>
__device__ __forceinline__ void send(float* chunk, Mbarrier* mb, unsigned rank, int tid) {
  constexpr int V = N / 4;  // float4s
  for (int e = tid; e < (C - 1) * V; e += NT) {
    const int f = e % V;
    const unsigned peer = (rank + 1 + e / V) % C;
    store_peer(chunk + 4 * f, mb, peer, *reinterpret_cast<const float4*>(chunk + 4 * f));
  }
}

// This CTA's units of the [H][R] state `arr`, rows U*rank .. U*rank+U.
template <int R>
__device__ __forceinline__ void send_units(float* arr, Mbarrier* mb, unsigned rank, int tid) {
  send<U * R>(arr + U * rank * R, mb, rank, tid);
}

// N consecutive floats at p, which is aligned to the widest load N allows.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 a = *reinterpret_cast<const float2*>(p + i);
      v[i] = a.x; v[i + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <int RQ, int P>
__global__ void __launch_bounds__(NT, 1) lsthm_onlysp_cluster_kernel(
    const float* __restrict__ xl, const float* __restrict__ xa,
    const float* __restrict__ gx, const float* __restrict__ qm,
    const float* __restrict__ Kl, const float* __restrict__ bl,
    const float* __restrict__ Ka, const float* __restrict__ ba,
    const float* __restrict__ gWhh, const float* __restrict__ gbhh,
    const float* __restrict__ wq, const float* __restrict__ wk,
    float* __restrict__ out, int T, int B) {
  using L = Layout<RQ, P>;
  constexpr int R = L::R, HR = L::HR;
  static_assert(P * R <= NT, "one thread a (row, party) loads the qmask");
  // lanes that share the attention sum of one (unit, row) pair
  constexpr int LP = RQ == 1 ? 8 : RQ == 2 ? 4 : 2;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned rank = cluster_rank();
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * R;
  const int u0 = U * rank;  // first unit of this CTA

  float* const W = sm + L::W;
  float* const WG = sm + L::WG;
  float* const HL = sm + L::HL;
  float* const HA = sm + L::HA;
  float* const HS = sm + L::HS;
  float* const CA = sm + L::CA;
  float* const Z = sm + L::Z;
  float* const PS = sm + L::PS;
  float* const PG = sm + L::PG;
  float* const QM = sm + L::QM;
  float* const WQ = sm + L::WQ;
  float* const WK = sm + L::WK;
  float* const SP = sm + L::SP;
  float* const CL = sm + L::CL;
  float* const MM = sm + L::MM;

  auto flat_row = [&](int t, int b) { return ((size_t)t * 2 + d) * B + b; };

  // Three roles of thread tid beside its share of the products.
  // (1) LSTHM activations: RQ of the CTA's 64R (row, column) sums; item
  //     tid + NT*i is gate ig (the same for a whole warp), row ir[i],
  //     modality and unit by lane.
  const int imu = tid % (2 * U);  // modality * U + unit
  int ir[RQ], ij[RQ], ig[RQ];
  float ibias[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int id = tid + NT * i;
    ig[i] = id / (2 * U * R);
    ir[i] = id % (2 * U * R) / (2 * U);
    ij[i] = (imu / U) * 4 * U + ig[i] * U + imu % U;
    ibias[i] = (imu / U ? ba : bl)[d * G + ig[i] * H + u0 + imu % U];
  }
  auto load_x = [&](int t, float (&x)[RQ]) {
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int b = b0 + ir[i];
      x[i] = (t < T && b < B)
          ? (imu / U ? xa : xl)[flat_row(t, b) * G + ig[i] * H + u0 + imu % U] : 0.f;
    }
  };
  // (2) GRU gates r and z (tid < 2*U*R): gate rz_g, row rz_r, unit rz_u.
  const bool rz_thread = tid < 2 * U * R;
  const int rz_g = tid / (U * R), rz_r = tid % (U * R) / U, rz_u = tid % U;
  const float rz_bias = rz_thread ? gbhh[d * GH + rz_g * H + u0 + rz_u] : 0.f;
  auto load_gx_rz = [&](int t) {
    const int b = b0 + rz_r;
    return (rz_thread && t < T && b < B)
        ? gx[flat_row(t, b) * GH + rz_g * H + u0 + rz_u] : 0.f;
  };
  // (3) The pair (row prow, unit punit) for tid < U*R: cell updates, the GRU's n
  //     gate and h_s, outputs; pe is the pair's place in a [H][R] state.
  const bool pair_thread = tid < U * R;
  const int prow = tid / U, punit = tid % U;
  const int pbatch = b0 + prow;
  const int pe = (u0 + punit) * R + prow;
  const float n_bias = gbhh[d * GH + 2 * H + u0 + punit];
  auto load_gx_n = [&](int t) {
    return (pair_thread && t < T && pbatch < B)
        ? gx[flat_row(t, pbatch) * GH + 2 * H + u0 + punit] : 0.f;
  };
  const bool qm_thread = tid < P * R;  // loads qmask[row tid/P][party tid%P]
  auto load_qm = [&](int t) {
    const int b = b0 + tid / P;
    return (qm_thread && t < T && b < B) ? qm[flat_row(t, b) * P + tid % P] : 0.f;
  };

  Mbarrier* const mbar = reinterpret_cast<Mbarrier*>(sm + L::MB);

  // A lane's tiles in the products: LSTHM columns 4*lcq .. +3 (text for
  // lcq < 8, audio above) x rows lrh*R/2 .. +R/2; GRU columns 3*gc3 .. +2 x
  // rows grq*RQ .. +RQ. acc carries the LSTHM tile from the early products
  // of a step to its late ones.
  const int lcq = lane % 16, lrh = lane / 16;
  const int gc3 = lane % 8, grq = lane / 8;
  float acc[4][R / 2];
  auto lsthm_mac = [&](const float* state, int segment) {
    const float* const wrow = W + segment * H * NL + 4 * lcq;
    const float* const st = state + lrh * (R / 2);
#pragma unroll 8
    for (int k = warp * KW; k < (warp + 1) * KW; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(wrow + k * NL);
      float v[R / 2];
      load_n(st + k * R, v);
#pragma unroll
      for (int r = 0; r < R / 2; ++r) {
        acc[0][r] = fmaf(v[r], w.x, acc[0][r]);
        acc[1][r] = fmaf(v[r], w.y, acc[1][r]);
        acc[2][r] = fmaf(v[r], w.z, acc[2][r]);
        acc[3][r] = fmaf(v[r], w.w, acc[3][r]);
      }
    }
  };
  // What step tn's products can take before z(tn-1) is there: this warp's
  // share of the h and h_s rows of K into acc, and of X = h_s(tn) @ gWhh
  // into PG.
  auto early_products = [&](int tn) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < R / 2; ++r) acc[c][r] = 0.f;
    const float* const hs = HS + (tn & 1) * HR;
    lsthm_mac((lcq < 8 ? HL : HA) + ((tn + 1) & 1) * HR, 0);
    lsthm_mac(hs, 2);
    float g[3][RQ];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int r = 0; r < RQ; ++r) g[c][r] = 0.f;
#pragma unroll 8
    for (int k = warp * KW; k < (warp + 1) * KW; ++k) {
      const float* const w = WG + k * NG + 3 * gc3;
      float v[RQ];
      load_n(hs + k * R + grq * RQ, v);
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int r = 0; r < RQ; ++r) g[c][r] = fmaf(v[r], w[c], g[c][r]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int r = 0; r < RQ; ++r)
        PG[(warp * R + grq * RQ + r) * NG + 3 * gc3 + c] = g[c][r];
  };

  // Rank-1 attention from c_l to c_a for step t: s = (c_a . wq) / sqrt(H)
  // from the 16 shares, alpha = c_l * s, exact row max mx,
  // z = sum_k e^{alpha wk_k - mx} c_a[k] / sum_k e^{...}. LP neighbouring
  // lanes share a pair, each over H / LP consecutive k.
  auto attention = [&](int t) {
    if (tid >= U * R * LP) return;
    const int p = tid / LP, sub = tid % LP;
    const int ar = p / U, au = p % U;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) s += SP[c * R + ar];
    const float a = CL[p] * (s * kInvSqrtH);
    const float mx = a > 0.f ? a * MM[0] : a * MM[1];
    float num = 0.f, den = 0.f;
#pragma unroll 8
    for (int k = sub * (H / LP); k < (sub + 1) * (H / LP); ++k) {
      const float e = expf(a * WK[k] - mx);
      num = fmaf(e, CA[k * R + ar], num);
      den += e;
    }
#pragma unroll
    for (int off = LP / 2; off > 0; off >>= 1) {
      num += __shfl_xor_sync(0xffffffffu, num, off);
      den += __shfl_xor_sync(0xffffffffu, den, off);
    }
    if (sub == 0) {
      const float z = num / den;
      Z[(u0 + au) * R + ar] = z;
      if (b0 + ar < B) out[flat_row(t, b0 + ar) * G + 2 * H + u0 + au] = z;
    }
  };

  // Set-up: zero every state, gather the weight slice (W[k] = K_l[k] then
  // K_a[k], WG[k] = gWhh[k], each at gate g the columns g*H + u0 .. + U),
  // copy the attention vectors and the qmask of steps 0 and 1.
  for (int e = tid; e < L::PS - L::HL; e += NT) HL[e] = 0.f;
  for (int e = tid; e < GH * NL / 4; e += NT) {
    const int k = e / (NL / 4), q = e % (NL / 4);  // q: modality, gate, half of the units
    const float* const src = (q < 8 ? Kl : Ka) + ((size_t)d * GH + k) * G;
    reinterpret_cast<float4*>(W)[e] =
        *reinterpret_cast<const float4*>(src + (q % 8 / 2) * H + u0 + 4 * (q % 2));
  }
  for (int e = tid; e < H * NG / 4; e += NT) {
    const int k = e / (NG / 4), q = e % (NG / 4);  // q: gate, half of the units
    reinterpret_cast<float4*>(WG)[e] = *reinterpret_cast<const float4*>(
        gWhh + ((size_t)d * H + k) * GH + (q / 2) * H + u0 + 4 * (q % 2));
  }
  if (tid < H) {
    WQ[tid] = wq[d * H + tid];
    WK[tid] = wk[d * H + tid];
  }
  if (qm_thread) {
    QM[tid] = load_qm(0);
    QM[P * R + tid] = load_qm(1);
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 7; ++i) mbarrier_init(mbar + i);
    mbarrier_fence_init();
  }
  __syncthreads();
  if (warp == 0) {  // exact max and min of wk
    float mx = WK[lane], mn = mx;
    for (int k = lane + 32; k < H; k += 32) {
      mx = fmaxf(mx, WK[k]);
      mn = fminf(mn, WK[k]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    }
    if (lane == 0) {
      MM[0] = mx;
      MM[1] = mn;
    }
  }
  // No CTA may write into a peer that is still zeroing its states or
  // setting up its mbarriers.
  cluster_sync();

  // Carries in registers: the pair's cell states, its own party memories and
  // n-gate products; the r/z thread's products. P_p = q_p @ gWhh per party.
  float cl = 0.f, ca = 0.f, q[P], pn[P], prz[P];
#pragma unroll
  for (int p = 0; p < P; ++p) q[p] = pn[p] = prz[p] = 0.f;
  float hs_cur = 0.f;
  if (pair_thread) {  // h_s(0) from q = 0: the h side is gbhh alone
    const bool ok = pbatch < B;
    const float xr = ok ? gx[flat_row(0, pbatch) * GH + u0 + punit] : 0.f;
    const float xz = ok ? gx[flat_row(0, pbatch) * GH + H + u0 + punit] : 0.f;
    const float rgate = sigmoid(xr + gbhh[d * GH + u0 + punit]);
    const float zgate = sigmoid(xz + gbhh[d * GH + H + u0 + punit]);
    const float n = tanhf(load_gx_n(0) + rgate * n_bias);
    hs_cur = (1.f - zgate) * n;
    HS[pe] = hs_cur;
  }
  float xcur[RQ];
  load_x(0, xcur);
  float grz = load_gx_rz(1), gn = load_gx_n(1);
  __syncthreads();
  if (tid == 0) mbarrier_expect(mbar + 6, L::kBytesUnits);
  send_units<R>(HS, mbar + 6, rank, tid);
  mbarrier_wait(mbar + 6, 0);
  early_products(0);

  for (int t = 0; t < T; ++t) {
    // This step's exchanges count on mbarriers that alternate from step to
    // step; each is in its (t / 2)-th use.
    Mbarrier* const mbar_a1 = mbar + (t & 1);
    Mbarrier* const mbar_a2 = mbar + 2 + (t & 1);
    Mbarrier* const mbar_b = mbar + 4 + (t & 1);
    const unsigned parity = (t >> 1) & 1;
    // Loads for the steps ahead; nothing in this step waits on them but the
    // qmask store at its end.
    float xnext[RQ];
    load_x(t + 1, xnext);
    const float grz_next = load_gx_rz(t + 2), gn_next = load_gx_n(t + 2);
    const float qnext = load_qm(t + 2);

    // P1. The late products: the z rows of K, from z(t-1). With them acc is
    //     this warp's share of [h | z | h_s] @ K for both modalities.
    lsthm_mac(Z, 1);
#pragma unroll
    for (int r = 0; r < R / 2; ++r)
      *reinterpret_cast<float4*>(PS + (warp * R + lrh * (R / 2) + r) * SL + 4 * lcq) =
          make_float4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
    __syncthreads();

    // Activations, spread over all threads. LSTHM: x_proj + b + the 8
    // partial sums, sigmoid for f, i, o and tanh for c-hat, left in PS[0].
    const float* const qmt = QM + (t % 3) * P * R;        // qmask of step t
    const float* const qmn = QM + ((t + 1) % 3) * P * R;  // and of step t+1
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float* const p = PS + ir[i] * SL + ij[i];
      float s = ibias[i] + xcur[i];
#pragma unroll
      for (int w = 0; w < NW; ++w) s += p[w * R * SL];
      *p = ig[i] == 3 ? tanhf(s) : sigmoid(s);
    }
    // GRU gates r and z of step t+1: scatter X into the party products with
    // the raw qmask of step t (a padded step leaves them untouched), take
    // the party of argmax(qmask(t+1)), so a tie or a padded row picks party
    // 0; left in PG[0].
    if (rz_thread) {
      float* const p = PG + rz_r * NG + rz_g * U + rz_u;
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) x += p[w * R * NG];
      const float* const mt = qmt + P * rz_r;
      const float* const mn = qmn + P * rz_r;
#pragma unroll
      for (int k = 0; k < P; ++k) prz[k] = prz[k] * (1.f - mt[k]) + x * mt[k];
      float best = mn[0], ps = prz[0];
#pragma unroll
      for (int k = 1; k < P; ++k)
        if (mn[k] > best) {
          best = mn[k];
          ps = prz[k];
        }
      *p = sigmoid(grz + (rz_bias + ps));
    }
    __syncthreads();

    // The own pairs: LSTHM cell updates of step t, then the GRU's n gate and
    // h_s of step t+1; h_l, h_a, h_s of step t go out.
    float hs_next = 0.f;
    if (pair_thread) {
      const float* const gl = PS + prow * SL + punit;  // f, i, o, c-hat at stride U
      const float* const ga = gl + 4 * U;
      cl = gl[0] * cl + gl[U] * gl[3 * U];
      ca = ga[0] * ca + ga[U] * ga[3 * U];
      const float hl = tanhf(cl) * gl[2 * U];
      const float ha = tanhf(ca) * ga[2 * U];
      HL[(t & 1) * HR + pe] = hl;
      HA[(t & 1) * HR + pe] = ha;
      CA[pe] = ca;
      CL[tid] = cl;
      // this CTA's share of c_a . wq for row prow: the 8 lanes of the row
      float share = ca * WQ[u0 + punit];
#pragma unroll
      for (int off = U / 2; off > 0; off >>= 1)
        share += __shfl_xor_sync(0xffffffffu, share, off);
      if (punit == 0) SP[rank * R + prow] = share;

      const float* const mt = qmt + P * prow;
      const float* const mn = qmn + P * prow;
      const float* const gg = PG + prow * NG + punit;  // r, z, partial n at stride U
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) x += gg[w * R * NG + 2 * U];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        pn[k] = pn[k] * (1.f - mt[k]) + x * mt[k];
        q[k] = q[k] * (1.f - mt[k]) + hs_cur * mt[k];
      }
      float best = mn[0], pns = pn[0], qs = q[0];
#pragma unroll
      for (int k = 1; k < P; ++k)
        if (mn[k] > best) {
          best = mn[k];
          pns = pn[k];
          qs = q[k];
        }
      const float n = tanhf(gn + gg[0] * (n_bias + pns));
      hs_next = (1.f - gg[U]) * n + gg[U] * qs;
      HS[((t + 1) & 1) * HR + pe] = hs_next;
      if (pbatch < B) {
        float* const o = out + flat_row(t, pbatch) * G + u0 + punit;
        o[0] = hl;
        o[H] = ha;
        o[3 * H] = hs_cur;
      }
    }
    __syncthreads();
    // Exchange A, in two parts: c_a of step t and the shares of s, which
    // the attention waits for, then h_l, h_a of step t and h_s(t+1), which
    // fly while the attention runs.
    if (tid == 0) {
      mbarrier_expect(mbar_a1, L::kBytesA1);
      mbarrier_expect(mbar_a2, L::kBytesA2);
    }
    send_units<R>(CA, mbar_a1, rank, tid);
    send<R>(SP + rank * R, mbar_a1, rank, tid);
    send_units<R>(HL + (t & 1) * HR, mbar_a2, rank, tid);
    send_units<R>(HA + (t & 1) * HR, mbar_a2, rank, tid);
    send_units<R>(HS + ((t + 1) & 1) * HR, mbar_a2, rank, tid);
    mbarrier_wait(mbar_a1, parity);

    // P2. The attention rows of the own units.
    attention(t);
    __syncthreads();
    // Exchange B: z of step t; the early products of step t+1 in its flight.
    if (tid == 0) mbarrier_expect(mbar_b, L::kBytesUnits);
    send_units<R>(Z, mbar_b, rank, tid);
    mbarrier_wait(mbar_a2, parity);
    early_products(t + 1);
    if (qm_thread) QM[((t + 2) % 3) * P * R + tid] = qnext;
#pragma unroll
    for (int i = 0; i < RQ; ++i) xcur[i] = xnext[i];
    grz = grz_next;
    gn = gn_next;
    hs_cur = hs_next;
    mbarrier_wait(mbar_b, parity);
  }
  // No CTA exits while a peer's copy into it may be in flight.
  cluster_sync();
}

// The exchanges of `rounds` steps and nothing else: the copies, the
// mbarrier waits and the block barriers before them, placed as in the
// kernel above. Its time over `rounds` is the chain floor of one step: what
// the synchronisation alone costs.
template <int RQ, int P>
__global__ void __launch_bounds__(NT, 1) exchange_rounds_kernel(int rounds) {
  using L = Layout<RQ, P>;
  constexpr int R = L::R, HR = L::HR;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const unsigned rank = cluster_rank();
  Mbarrier* const mbar = reinterpret_cast<Mbarrier*>(sm + L::MB);
  float* const states = sm + L::HL;  // five [H][R] states; the shares where the kernel has them
  for (int e = tid; e < 5 * HR; e += NT) states[e] = 0.f;
  if (tid < C * R) sm[L::SP + tid] = 0.f;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) mbarrier_init(mbar + i);
    mbarrier_fence_init();
  }
  cluster_sync();
  for (int t = 0; t < rounds; ++t) {
    Mbarrier* const mbar_a1 = mbar + (t & 1);
    Mbarrier* const mbar_a2 = mbar + 2 + (t & 1);
    Mbarrier* const mbar_b = mbar + 4 + (t & 1);
    const unsigned parity = (t >> 1) & 1;
    __syncthreads();
    if (tid == 0) {
      mbarrier_expect(mbar_a1, L::kBytesA1);
      mbarrier_expect(mbar_a2, L::kBytesA2);
    }
    send_units<R>(states, mbar_a1, rank, tid);
    send<R>(sm + L::SP + rank * R, mbar_a1, rank, tid);
#pragma unroll
    for (int i = 1; i < 4; ++i) send_units<R>(states + i * HR, mbar_a2, rank, tid);
    mbarrier_wait(mbar_a1, parity);
    __syncthreads();
    if (tid == 0) mbarrier_expect(mbar_b, L::kBytesUnits);
    send_units<R>(states + 4 * HR, mbar_b, rank, tid);
    mbarrier_wait(mbar_a2, parity);
    mbarrier_wait(mbar_b, parity);
  }
  cluster_sync();
}

// Launch configuration of a kernel on `tiles` clusters a direction, with the
// attributes a cluster of 16 needs. `attr` must outlive the launch call.
template <typename K>
cudaError_t cluster_config(K kernel, int smem, int tiles, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C * tiles, 2);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int RQ, int P>
constexpr int kSmemBytes = (int)sizeof(float) * Layout<RQ, P>::FLOATS;

// Calls f with rows / 4 as a compile-time constant; -1 where `rows` is not
// a compiled tile height.
template <typename F>
int for_rows(int rows, F f) {
  switch (rows) {
    case 4: return (int)f(std::integral_constant<int, 1>{});
    case 8: return (int)f(std::integral_constant<int, 2>{});
    case 12: return (int)f(std::integral_constant<int, 3>{});
    case 16: return (int)f(std::integral_constant<int, 4>{});
  }
  return -1;
}

// Calls f with rows / 4 and the party count as compile-time constants; -1
// where either is not compiled.
template <typename F>
int for_tile(int parties, int rows, F f) {
  if (parties == 2) return for_rows(rows, [&](auto rq) {
    return f(rq, std::integral_constant<int, 2>{});
  });
  if (parties == 9) return for_rows(rows, [&](auto rq) {
    return f(rq, std::integral_constant<int, 9>{});
  });
  return -1;
}

}  // namespace

// Launches on `stream` for `parties` parties (2, 9) with `rows` batch rows
// a cluster (4, 8, 12, 16) on `tiles` clusters a direction, and returns the
// CUDA error of the launch; never synchronises. -1: `parties` or `rows` is
// not compiled.
extern "C" int lsthm_onlysp_bidir(
    const float* xl, const float* xa, const float* gx, const float* qm,
    const float* Kl, const float* bl, const float* Ka, const float* ba,
    const float* gWhh, const float* gbhh, const float* wq, const float* wk,
    float* out, int T, int B, int parties, int rows, int tiles, void* stream) {
  return for_tile(parties, rows, [&](auto rq, auto pp) {
    constexpr int RQ = decltype(rq)::value, P = decltype(pp)::value;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_config(lsthm_onlysp_cluster_kernel<RQ, P>, kSmemBytes<RQ, P>,
                                     tiles, (cudaStream_t)stream, &cfg, &attr);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, lsthm_onlysp_cluster_kernel<RQ, P>, xl, xa, gx, qm,
                             Kl, bl, Ka, ba, gWhh, gbhh, wq, wk, out, T, B);
    return err != cudaSuccess ? err : cudaGetLastError();
  });
}

// Shared memory a CTA and the number of 16-CTA clusters the card holds at
// once, for the kernel of `parties` parties with `rows` rows a cluster.
extern "C" int lsthm_onlysp_occupancy(int parties, int rows, int* smem_bytes,
                                      int* max_clusters) {
  return for_tile(parties, rows, [&](auto rq, auto pp) {
    constexpr int RQ = decltype(rq)::value, P = decltype(pp)::value;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    *smem_bytes = kSmemBytes<RQ, P>;
    cudaError_t err = cluster_config(lsthm_onlysp_cluster_kernel<RQ, P>, kSmemBytes<RQ, P>,
                                     1, nullptr, &cfg, &attr);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(max_clusters,
                                          lsthm_onlysp_cluster_kernel<RQ, P>, &cfg);
  });
}

// `rounds` steps' worth of cluster exchanges and barriers with no work
// between them, on the grid the recurrence would use.
extern "C" int lsthm_onlysp_exchange_rounds(int rounds, int parties, int rows, int tiles,
                                            void* stream) {
  return for_tile(parties, rows, [&](auto rq, auto pp) {
    constexpr int RQ = decltype(rq)::value, P = decltype(pp)::value;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_config(exchange_rounds_kernel<RQ, P>, kSmemBytes<RQ, P>, tiles,
                                     (cudaStream_t)stream, &cfg, &attr);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, exchange_rounds_kernel<RQ, P>, rounds);
    return err != cudaSuccess ? err : cudaGetLastError();
  });
}
