// Fused MFCC front end: waveforms to cepstral coefficients in one kernel.
//
// Replaces the Pallas kernel ser_tpu/ops/pallas/mfcc.py::mfcc_pallas. Same
// contract, x [N, T] f32 -> out [N, F, n_mfcc] f32 with
// F = 1 + (T - 400) / hop, and the same function:
//   pre-emphasis y[t] = x[t] - p*x[t-1] (reflect pad: y[0] = x[0] - p*x[1]),
//   frames of 400 samples at hop, Hamming window, zero pad to 512, power
//   spectrum (257 bins), mel filterbank, log(. + eps), DCT-II.
// The Pallas kernel forms the spectrum as two dense [frames, 400] @ [400, 257]
// products because a butterfly does not map onto a systolic array. An SM has
// no such constraint, so this kernel computes the spectrum by an FFT:
// about 18 kflop a frame in place of 451 kflop.
//
// What bounds the function on an H100: bytes. At the IEMOCAP eval shape
// (2542 rows of 4096 samples, 24 frames each) it reads 41.6 MB of waveform
// and writes 12.2 MB of coefficients, 0.016 ms at 3.35 TB/s; the least work
// (an FFT, the filterbank's nonzeros, a fast DCT) is 0.92 GFLOP, 0.014 ms at
// the 67 TFLOP/s f32 peak. chip_smoke.py prints the bound, this kernel's own
// operation time and a bytes floor (mfcc_bytes_floor below: the same grid,
// loads and stores with no arithmetic between them).
//
// Design:
// - Tiles. A tile is R consecutive frames of one row: (R - 1) * hop + 400
//   contiguous samples. The block loads that segment once (16 bytes a thread
//   where the segment start is 16-byte aligned, 4 bytes otherwise),
//   pre-emphasises it on the way into shared memory with the plain version's
//   two roundings, and every frame is a view into the segment: no sample is
//   fetched twice and no frame array exists anywhere. The last tile of a row
//   may hold fewer than R frames and writes nothing past F.
// - Persistent blocks. The grid is as many blocks as the card holds at once
//   (or the tile count if smaller); a block walks tiles blockIdx.x,
//   blockIdx.x + gridDim.x, ... and loads the constants (window, twiddles,
//   banded filterbank, DCT matrix: about 20 KB) into shared memory once, not
//   once a tile. Several blocks an SM keep waveform loads in flight while
//   others compute.
// - Spectrum. A warp takes a frame at a time. The 512-point real FFT is a
//   256-point complex FFT of z[n] = v[2n] + i v[2n+1] (v the windowed,
//   zero-padded frame), 8 points a lane in registers, passes of radix 8, 8
//   and 4 (n = l + 32 j, k = q + 8 q2 + 64 k2) with two exchanges through a
//   per-warp scratch in shared memory (strides 36 and 68 complex, so no
//   access has a bank conflict; __syncwarp only). The spectrum of the real
//   frame follows from
//     X[k] = (Z[k] + conj Z[256-k])/2 - (i/2) e^{-2 pi i k/512} (Z[k] - conj Z[256-k])
//   and X[256-k] = conj(same with the sign of the second term flipped), so a
//   lane forms bins k and 256-k from one pair. power = re^2 + im^2 with
//   three roundings, as the plain version.
// - Constants come from the caller (numpy in float64, rounded once): the
//   window, e^{-2 pi i k/512} for k < 256 (it serves the passes' twiddles
//   and the split; the other half of the circle is its negative), the
//   filterbank as bands, the DCT matrix. Nothing here computes a sine. They
//   sit in shared memory, not __constant__: lanes index them divergently.
//   A lane's 14 pass twiddles and 4 split twiddles are the same for every
//   frame and stay in registers, so the table is read once a block. The window is halved on the way in, which halves Z exactly
//   and saves the split its factors 1/2.
// - Mel step. Every filterbank column is one triangle, so its nonzeros are
//   contiguous bins. Columns go in rounds of 32, a lane a column; a lane
//   sums its band in ascending k with fmaf. Every lane of a round takes the
//   same number of steps, with zero weights outside its own band, so the
//   loop has one trip count a warp; the caller lets a lane start a few bins
//   before its band so that the 32 starts of a round lie in 32 different
//   banks, and lays the weights out [step][lane]: neither load has a bank
//   conflict (a warp-wide shared-memory load costs a cycle for every 128
//   bytes it moves, conflicts counted, and this kernel is bound by that).
//   The skipped and the padded terms are exact zeros, so the sum equals the
//   dense ascending sum bit for bit. Then logf(acc + eps).
// - DCT: dense [n_mels, n_mfcc] in ascending m, after the tile's frames are
//   all in shared memory as logmel[m][frame]. A thread owns 2 coefficients
//   for 4 frames: an 8-byte and a 16-byte shared-memory load for 8 FMAs. The
//   tile's [frames, n_mfcc] block is staged in shared memory and written to
//   device memory contiguously.
// - No atomics, fixed summation orders: two launches on one input are
//   bit-equal. All-zero rows give power exactly 0 and log(eps) features.
// - No tensor cores: the function's least work needs none, and the dense
//   products on wgmma would need a 3xTF32 split to hold the f32 contract,
//   82 GFLOP, 0.17 ms at the 495 TFLOP/s TF32 peak: ten times the bound at
//   best, for a function that an FFT brings under the byte time.
// - What it waits on. At the eval shape the kernel takes about 6.5 times its
//   byte time and about 2.7 times its own bytes floor. A frame costs a warp
//   about 800 instructions and about 220 cycles of the SM's shared-memory
//   pipe (the three exchanges of the FFT 97, the mel step 62, the DCT 40,
//   window and samples 28), and four warp schedulers share one pipe, so the
//   pipe, not the FMA units, sets the pace; every change that removed
//   shared-memory traffic made the kernel faster and none that only removed
//   arithmetic did. 80 registers a thread hold 3 blocks (24 warps) an SM.
// - Tried and dropped, each measured on an H100 against the version before
//   it (PERF.md has the record): the dense-product kernel this file held
//   before (a thread a DFT bin, both DFT matrices streamed from L2 by every
//   block; ten times slower); the pass twiddles read from the table for
//   every frame (a sixth slower than registers); the split through warp
//   shuffles in place of the third exchange (no gain: more arithmetic for
//   less traffic); a lane's own trip count in the mel loop (divergent, a
//   tenth slower than rounds with one trip count and banks kept apart) and
//   two columns a lane in one predicated loop (slower still); the window in
//   registers (spills); one block a tile in place of persistent blocks, and
//   2 blocks an SM at 128 registers (both slower); an L2 prefetch of the
//   next tile's samples (no gain: the loads already overlap other blocks'
//   arithmetic); the last round's tiles cut in three to even out the tail
//   (slower: the blocks that remain run faster on an emptier SM anyway).

#include <cuda_runtime.h>

namespace {

constexpr int R = 24;        // frames a tile
constexpr int WIN = 400;     // samples a frame (25 ms at 16 kHz)
constexpr int NFFT = 512;    // real FFT length; the complex FFT has NFFT / 2 points
constexpr int NT = 256;      // threads a block: 8 warps, a warp a frame at a time
constexpr int NWARP = NT / 32;
constexpr int SCR = 288;     // complex slots of a warp's scratch (8 * 36 >= 4 * 68)
constexpr int FG = 4;        // frames a thread in the DCT
constexpr int RP = R + 4;    // row stride of logmel[m][frame]: 8 banks under a warp's store, not 4
constexpr int MIN_BLOCKS = 3;  // blocks an SM the register budget allows
static_assert(R % FG == 0 && R % NWARP == 0, "tile height");
static_assert(NFFT == 512 && WIN <= NFFT && WIN % 2 == 0, "FFT passes are written for 512");

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int up32(int n) { return (n + 31) & ~31; }

// Shared-memory layout, in floats; every part starts 16-byte aligned.
struct Layout {
  int tw, win, scratch, stage, logmel, dct, melw, melidx, seg, total;
  int cp;  // row stride of the DCT matrix in shared memory (n_mfcc made even)
  __host__ __device__ Layout(int hop, int n_mels, int n_mfcc, int nw) {
    cp = (n_mfcc + 1) & ~1;
    tw = 0;
    win = tw + NFFT;  // 256 complex
    scratch = win + WIN;
    stage = scratch + NWARP * SCR * 2;
    logmel = stage + up4(R * n_mfcc);
    dct = logmel + n_mels * RP;
    melw = dct + up4(n_mels * cp);
    melidx = melw + up4(nw);
    seg = melidx + 4 * up32(n_mels);
    total = seg + up4((R - 1) * hop + WIN);
  }
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// e^{-2 pi i k/512} for k in [0, 512) from the half-circle table
__device__ __forceinline__ float2 twiddle(const float2* tw, int k) {
  float2 t = tw[k & 255];
  if (k & 256) t = make_float2(-t.x, -t.y);
  return t;
}

// 4-point DFT in place, outputs in natural order
__device__ __forceinline__ void fft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 c0 = cadd(a0, a2), c1 = cadd(a1, a3), d0 = csub(a0, a2);
  const float2 e = csub(a1, a3), d1 = make_float2(e.y, -e.x);  // times -i
  a0 = cadd(c0, c1);
  a1 = cadd(d0, d1);
  a2 = csub(c0, c1);
  a3 = csub(d0, d1);
}

// 8-point DFT in place, outputs in natural order (decimation in frequency)
__device__ __forceinline__ void fft8(float2 (&v)[8]) {
  const float h = 0.70710678118654752440f;
  float2 a0 = cadd(v[0], v[4]), a1 = cadd(v[1], v[5]), a2 = cadd(v[2], v[6]), a3 = cadd(v[3], v[7]);
  float2 b0 = csub(v[0], v[4]), b1 = csub(v[1], v[5]), b2 = csub(v[2], v[6]), b3 = csub(v[3], v[7]);
  b1 = make_float2((b1.x + b1.y) * h, (b1.y - b1.x) * h);   // times e^{-i pi/4}
  b2 = make_float2(b2.y, -b2.x);                            // times -i
  b3 = make_float2((b3.y - b3.x) * h, (-b3.x - b3.y) * h);  // times e^{-3 i pi/4}
  fft4(a0, a1, a2, a3);
  fft4(b0, b1, b2, b3);
  v[0] = a0; v[2] = a1; v[4] = a2; v[6] = a3;
  v[1] = b0; v[3] = b1; v[5] = b2; v[7] = b3;
}

// Power spectrum of one frame by one warp. fr: the frame's WIN samples in
// shared memory; win: half the window, so Z below is half the transform and
// the split needs no factor 1/2 (exact: a power of two); tw1, tw2, tws: the
// lane's twiddles of passes 1 and 2 and of the split; sc: the warp's
// scratch; on return sc holds power[0..256] as floats. Every lane of the
// warp calls it.
__device__ __forceinline__ void frame_power(const float* fr, const float* win,
                                            const float2 (&tw1)[7], const float2 (&tw2)[7],
                                            const float2 (&tws)[4], float2* sc, int lane) {
  // pass 1: lane l holds z[l + 32 j], j < 8; radix 8 over j gives q
  float2 v[8];
  // a frame starts 8-byte aligned unless hop is odd; two loops, so that
  // neither executes the other's loads under a predicate
  if ((reinterpret_cast<size_t>(fr) & 7) == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 2 * (lane + 32 * j);
      v[j] = make_float2(0.f, 0.f);
      if (n < WIN) {
        const float2 w = *reinterpret_cast<const float2*>(win + n);
        const float2 s = *reinterpret_cast<const float2*>(fr + n);
        v[j] = make_float2(w.x * s.x, w.y * s.y);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 2 * (lane + 32 * j);
      v[j] = make_float2(0.f, 0.f);
      if (n < WIN) {
        const float2 w = *reinterpret_cast<const float2*>(win + n);
        v[j] = make_float2(w.x * fr[n], w.y * fr[n + 1]);
      }
    }
  }
  fft8(v);
  __syncwarp();  // the previous frame's power has been read
  sc[lane] = v[0];
#pragma unroll
  for (int q = 1; q < 8; ++q)  // times W256^{l q}
    sc[q * 36 + lane] = cmul(v[q], tw1[q - 1]);
  __syncwarp();

  // pass 2: lane (q, l0) holds l = l0 + 4 j2; radix 8 over j2 gives q2
  const int q = lane >> 2, l0 = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = sc[q * 36 + l0 + 4 * j];
  fft8(v);
  __syncwarp();
  sc[l0 * 68 + q] = v[0];
#pragma unroll
  for (int q2 = 1; q2 < 8; ++q2)  // times W32^{l0 q2}
    sc[l0 * 68 + q2 * 8 + q] = cmul(v[q2], tw2[q2 - 1]);
  __syncwarp();

  // pass 3: lane holds p = q + 8 q2 for p = lane and lane + 32; radix 4 over
  // l0 gives Z[p + 64 k2]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = lane + 32 * h;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[4 * h + j] = sc[j * 68 + p];
  }
  fft4(v[0], v[1], v[2], v[3]);
  fft4(v[4], v[5], v[6], v[7]);
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[lane + 32 * h + 64 * j] = v[4 * h + j];
  __syncwarp();

  // split: bins k and 256 - k from Z[k] and Z[256 - k], k = lane + 32 j;
  // bin 128 pairs with itself and is |2 Z[128]|^2
  float pk[4], pn[4], p128 = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = lane + 32 * j;
    const float2 a = sc[k], b = sc[(NFFT / 2 - k) & 255];
    const float2 xe = make_float2(a.x + b.x, a.y - b.y);
    const float2 xo = make_float2(a.y + b.y, b.x - a.x);
    const float2 u = cmul(tws[j], xo);
    const float2 xp = cadd(xe, u), xn = csub(xe, u);
    pk[j] = __fadd_rn(__fmul_rn(xp.x, xp.x), __fmul_rn(xp.y, xp.y));
    pn[j] = __fadd_rn(__fmul_rn(xn.x, xn.x), __fmul_rn(xn.y, xn.y));
  }
  if (lane == 0) {
    const float2 z = sc[NFFT / 4], x = cadd(z, z);
    p128 = __fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y));
  }
  __syncwarp();
  float* power = reinterpret_cast<float*>(sc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    power[lane + 32 * j] = pk[j];
    power[NFFT / 2 - lane - 32 * j] = pn[j];
  }
  if (lane == 0) power[NFFT / 4] = p128;
  __syncwarp();
}

__device__ __forceinline__ float emphasise(float cur, float prev, float p) {
  return __fsub_rn(cur, __fmul_rn(p, prev));  // no contraction: as the plain version rounds
}

// kCompute = false is the bytes floor: the same grid, the same loads into
// shared memory and the same stores, with no arithmetic between them.
template <bool kCompute>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) mfcc_kernel(
    const float* __restrict__ x, const float* __restrict__ g_win,
    const float* __restrict__ g_tw, const int* __restrict__ g_melidx,
    const float* __restrict__ g_melw, const float* __restrict__ g_dct,
    float* __restrict__ out, int T, int F, int hop, int n_mels, int n_mfcc,
    int nw, int tiles_per_row, long long tiles, float preemph, float eps) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(hop, n_mels, n_mfcc, nw);
  float2* tw = reinterpret_cast<float2*>(smem + lay.tw);
  float* win = smem + lay.win;
  float* stage = smem + lay.stage;
  float* logmel = smem + lay.logmel;
  float* dct = smem + lay.dct;
  float* melw = smem + lay.melw;
  int* melidx = reinterpret_cast<int*>(smem + lay.melidx);
  float* seg = smem + lay.seg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float2* sc = reinterpret_cast<float2*>(smem + lay.scratch) + warp * SCR;

  // the constants, once a block
  for (int i = tid; i < NFFT; i += NT) smem[lay.tw + i] = g_tw[i];
  for (int i = tid; i < WIN; i += NT) win[i] = 0.5f * g_win[i];
  for (int i = tid; i < nw; i += NT) melw[i] = g_melw[i];
  const int n_lanes = up32(n_mels);  // mel columns and the idle lanes of the last round
  for (int i = tid; i < 4 * n_lanes; i += NT) melidx[i] = g_melidx[i];
  for (int i = tid; i < n_mels * lay.cp; i += NT) {
    const int m = i / lay.cp, c = i - m * lay.cp;
    dct[i] = c < n_mfcc ? g_dct[m * n_mfcc + c] : 0.f;
  }
  __syncthreads();
  // the lane's twiddles stay in registers: W256^{l q} for pass 1 (l = lane),
  // W32^{l0 q2} for pass 2 (l0 = lane & 3), e^{-2 pi i k/512} for the split
  // (k = lane + 32 j)
  float2 tw1[7], tw2[7], tws[4];
#pragma unroll
  for (int q = 1; q < 8; ++q) {
    tw1[q - 1] = twiddle(tw, (2 * lane * q) & 511);
    tw2[q - 1] = twiddle(tw, (16 * (lane & 3) * q) & 511);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) tws[j] = tw[lane + 32 * j];

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long n = tile / tiles_per_row;
    const int f0 = (int)(tile - n * tiles_per_row) * R;
    const int nf = min(R, F - f0);
    const int seglen = (nf - 1) * hop + WIN;
    const int s0 = f0 * hop;
    const float* row = x + n * T;
    const float* src = row + s0;

    // 1. the tile's samples, pre-emphasised, into shared memory. A thread
    //    takes 4 samples and the one before them from its neighbour lane.
    int done = 0;
    if ((reinterpret_cast<size_t>(src) & 15) == 0) {
      const int nq = seglen >> 2;
      for (int base = 0; base < nq; base += NT) {
        const int i = base + tid;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < nq) v = __ldg(reinterpret_cast<const float4*>(src) + i);
        float prev = __shfl_up_sync(0xffffffffu, v.w, 1);
        if (i < nq) {
          if (lane == 0) {
            const int t = s0 + 4 * i;
            prev = t > 0 ? __ldg(row + t - 1) : __ldg(row + 1);
          }
          if (kCompute)
            v = make_float4(emphasise(v.x, prev, preemph), emphasise(v.y, v.x, preemph),
                            emphasise(v.z, v.y, preemph), emphasise(v.w, v.z, preemph));
          else if (lane == 0)
            v.x = prev;
          reinterpret_cast<float4*>(seg)[i] = v;
        }
      }
      done = 4 * nq;
    }
    for (int i = done + tid; i < seglen; i += NT) {
      const int t = s0 + i;
      const float cur = __ldg(row + t);
      const float prev = t > 0 ? __ldg(row + t - 1) : __ldg(row + 1);
      seg[i] = kCompute ? emphasise(cur, prev, preemph) : (i & 1 ? cur : prev);
    }
    __syncthreads();

    if (kCompute) {
      // 2. a warp a frame: spectrum, mel bands, log
      for (int r = warp; r < nf; r += NWARP) {
        frame_power(seg + r * hop, win, tw1, tw2, tws, sc, lane);
        const float* power = reinterpret_cast<const float*>(sc);
        const float* w = melw + lane;
        for (int m0 = 0; m0 < n_mels; m0 += 32) {
          // 32 columns a round, a lane a column; every lane takes the
          // round's steps (zero weights outside its own band), so no lane
          // diverges, and the lanes' starts lie in 32 different banks
          const int m = m0 + lane, steps = melidx[3 * n_lanes + m0];
          const float* p = power + melidx[m];
          float acc = 0.f;
#pragma unroll 4
          for (int i = 0; i < steps; ++i) acc = fmaf(p[i], w[32 * i], acc);
          if (m < n_mels) logmel[m * RP + r] = logf(acc + eps);
          w += 32 * steps;
        }
      }
      __syncthreads();

      // 3. DCT: a thread owns coefficients 2c, 2c + 1 for FG frames
      const int ncp = lay.cp / 2;
      for (int i = tid; i < ncp * (R / FG); i += NT) {
        const int g = i / ncp, c = 2 * (i - g * ncp);
        if (g * FG >= nf) continue;
        float a0[FG], a1[FG];
#pragma unroll
        for (int j = 0; j < FG; ++j) a0[j] = a1[j] = 0.f;
        for (int m = 0; m < n_mels; ++m) {
          const float2 d = *reinterpret_cast<const float2*>(dct + m * lay.cp + c);
          const float4 l = *reinterpret_cast<const float4*>(logmel + m * RP + g * FG);
          a0[0] = fmaf(l.x, d.x, a0[0]); a1[0] = fmaf(l.x, d.y, a1[0]);
          a0[1] = fmaf(l.y, d.x, a0[1]); a1[1] = fmaf(l.y, d.y, a1[1]);
          a0[2] = fmaf(l.z, d.x, a0[2]); a1[2] = fmaf(l.z, d.y, a1[2]);
          a0[3] = fmaf(l.w, d.x, a0[3]); a1[3] = fmaf(l.w, d.y, a1[3]);
        }
#pragma unroll
        for (int j = 0; j < FG; ++j) {
          stage[(g * FG + j) * n_mfcc + c] = a0[j];
          if (c + 1 < n_mfcc) stage[(g * FG + j) * n_mfcc + c + 1] = a1[j];
        }
      }
    } else {
      for (int i = tid; i < nf * n_mfcc; i += NT) stage[i] = seg[i % seglen];
    }
    __syncthreads();

    // 4. the tile's coefficients, contiguous in out
    const int count = nf * n_mfcc;
    float* dst = out + (n * F + f0) * n_mfcc;
    int sent = 0;
    if ((reinterpret_cast<size_t>(dst) & 15) == 0) {
      for (int i = tid; i < count / 4; i += NT)
        reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(stage)[i];
      sent = count & ~3;
    }
    for (int i = sent + tid; i < count; i += NT) dst[i] = stage[i];
    // the next tile's first barrier comes before anything overwrites stage
  }
}

struct Launch {
  int smem, blocks_per_sm, sms;
};

template <bool kCompute>
cudaError_t prepare(int hop, int n_mels, int n_mfcc, int nw, Launch* l) {
  l->smem = (int)sizeof(float) * Layout(hop, n_mels, n_mfcc, nw).total;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&l->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mfcc_kernel<kCompute>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, l->smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &l->blocks_per_sm, mfcc_kernel<kCompute>, NT, l->smem);
}

template <bool kCompute>
int launch(const float* x, const float* win, const float* tw, const int* melidx,
           const float* melw, const float* dct, float* out, long long N, int T,
           int F, int win_length, int hop, int n_fft, int n_mels, int n_mfcc,
           int nw, float preemph, float eps, void* stream) {
  if (win_length != WIN || n_fft != NFFT || hop < 1 || F < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  Launch l;
  cudaError_t err = prepare<kCompute>(hop, n_mels, n_mfcc, nw, &l);
  if (err != cudaSuccess) return (int)err;
  if (l.blocks_per_sm < 1) return (int)cudaErrorInvalidValue;
  const int tiles_per_row = (F + R - 1) / R;
  const long long tiles = N * tiles_per_row;
  const long long resident = (long long)l.blocks_per_sm * l.sms;
  const unsigned blocks = (unsigned)(tiles < resident ? tiles : resident);
  mfcc_kernel<kCompute><<<blocks, NT, l.smem, (cudaStream_t)stream>>>(
      x, win, tw, melidx, melw, dct, out, T, F, hop, n_mels, n_mfcc, nw,
      tiles_per_row, tiles, preemph, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError(); neither
// synchronises. The caller checks shapes: N >= 1, T >= 400, F as above.
// win [400], tw [256][2] (cos, sin of -2 pi k/512), melidx [4][n_mels
// rounded up to 32] (the bin a lane starts at, the band's first bin and
// length, which the kernel does not read, and the steps of the lane's round
// of 32), melw [nw]: for each round steps x 32 weights, [step][lane], zero
// outside a column's own band; start + steps must stay inside the 512
// floats of a warp's scratch that every frame writes (Z in natural order,
// then the power spectrum over its start). dct [n_mels][n_mfcc].
// Another frame width or FFT length is refused with cudaErrorInvalidValue.
extern "C" int mfcc_forward(
    const float* x, const float* win, const float* tw, const int* melidx,
    const float* melw, const float* dct, float* out, long long N, int T, int F,
    int win_length, int hop, int n_fft, int n_mels, int n_mfcc, int nw,
    float preemph, float eps, void* stream) {
  return launch<true>(x, win, tw, melidx, melw, dct, out, N, T, F, win_length,
                      hop, n_fft, n_mels, n_mfcc, nw, preemph, eps, stream);
}

// The bytes floor of mfcc_forward: its grid, loads and stores, no arithmetic.
extern "C" int mfcc_bytes_floor(
    const float* x, const float* win, const float* tw, const int* melidx,
    const float* melw, const float* dct, float* out, long long N, int T, int F,
    int win_length, int hop, int n_fft, int n_mels, int n_mfcc, int nw,
    float preemph, float eps, void* stream) {
  return launch<false>(x, win, tw, melidx, melw, dct, out, N, T, F, win_length,
                       hop, n_fft, n_mels, n_mfcc, nw, preemph, eps, stream);
}

// Dynamic shared memory of a block and the blocks an SM holds at once, for
// the given configuration on the current device.
extern "C" int mfcc_occupancy(int hop, int n_mels, int n_mfcc, int nw,
                              int* smem_bytes, int* blocks_per_sm) {
  Launch l;
  cudaError_t err = prepare<true>(hop, n_mels, n_mfcc, nw, &l);
  *smem_bytes = l.smem;
  *blocks_per_sm = err == cudaSuccess ? l.blocks_per_sm : 0;
  return (int)err;
}
