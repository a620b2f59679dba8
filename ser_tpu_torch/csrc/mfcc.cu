// Fused MFCC front end: waveforms to cepstral coefficients in one kernel.
//
// Replaces the Pallas kernel ser_tpu/ops/pallas/mfcc.py::mfcc_pallas. Same
// contract, x [N, T] f32 -> out [N, F, n_mfcc] f32 with
// F = 1 + (T - win) / hop, and the same pipeline:
//   pre-emphasis y[t] = x[t] - p*x[t-1] (reflect pad: y[0] = x[0] - p*x[1]),
//   frames of win samples at hop, re = frames @ dcos, im = frames @ dsin
//   ([win, nbins], the Hamming window and the zero pad to n_fft folded in),
//   power = re^2 + im^2, @ mel [nbins, n_mels], log(. + eps), @ dct
//   [n_mels, n_mfcc].
// The constant matrices come from the caller (numpy, copied to the card once
// per configuration); nothing here computes a sine.
//
// What bounds the function on an H100: bytes. At the IEMOCAP eval shape
// (2542 rows of 4096 samples, 24 frames each) it reads 41.6 MB of waveform
// and writes 12.2 MB of coefficients, 0.016 ms at 3.35 TB/s. Its least work
// is an FFT's: about 14.8 kflop a frame (a 512-point real FFT 11.5k, the
// filterbank's 501 nonzeros, a fast DCT), 0.92 GFLOP, 0.014 ms at the 67
// TFLOP/s f32 peak. This kernel's algorithm is dense products instead:
// 2*2*win*nbins flops a frame for the window+DFT (411,200), 2*nbins*n_mels
// for the mel step, 2*n_mels*n_mfcc for the DCT, about 451 kflop a frame,
// 27.5 GFLOP, 0.41 ms at the f32 peak: 25x the function's bound before any
// inefficiency. chip_smoke.py prints both.
//
// Design (a simple kernel that is right; f32 FMA only, no tensor cores, so
// the fp32 contract holds):
// - Grid: one block per tile of R consecutive frames of the flattened
//   [N*F] frame index; a tile may span rows. The ragged last tile computes on
//   zero frames and writes nothing past N*F. There is no padding of N.
// - Framing is fused into the load: the block pre-emphasises and frames its
//   own samples into shared memory straight from the waveform, a warp per
//   frame, so the [N*F, win] frame array never exists in device memory.
// - Window+DFT: thread k owns bin k and keeps re, im for the R frames in
//   registers. It reads dcos[w, k], dsin[w, k] (a warp reads 128 contiguous
//   bytes; both matrices, 822 KB, stay in the 50 MB L2), the next 4 rows
//   while it uses the current 4, and each read feeds R frames; the frame
//   samples are shared-memory broadcasts, 4 at a time.
// - power [R, nbins] goes to shared memory (nbins odd: no bank conflicts when
//   threads of a warp read one bin of different frames); then a thread owns
//   one mel column for RG frames, then one DCT column for RG frames.
// - The frame width (400) and bin count (257, n_fft 512) are compile-time
//   constants, so shared-memory and L2 addresses are immediate offsets;
//   n_mels and n_mfcc stay runtime values.
// - Padded rows (all-zero waveforms) are computed like any other row and give
//   log(eps) features, as the plain version does.
// - R = 32 frames a block. Tiles of 16 and 8 frames were slower on an H100:
//   every block reads the 822 KB of constants, so smaller tiles read more
//   of them. PERF.md has the designs that lost.

#include <cuda_runtime.h>

namespace {

constexpr int R = 32;       // frames per block
constexpr int WIN = 400;   // samples per frame (25 ms at 16 kHz)
constexpr int NBINS = 257; // rfft bins of n_fft = 512
constexpr int NT = 288;    // threads per block: 9 warps, one thread per DFT bin
constexpr int RG = 8;      // frames per thread in the mel and DCT products
constexpr int NG = R / RG;
static_assert(R % RG == 0, "R must be a multiple of RG");
static_assert(WIN % 4 == 0, "frames are read 4 samples at a time");

__global__ void __launch_bounds__(NT, 2) mfcc_kernel(
    const float* __restrict__ x, const float* __restrict__ dcos,
    const float* __restrict__ dsin, const float* __restrict__ mel,
    const float* __restrict__ dct, float* __restrict__ out,
    long long total, int T, int F, int hop, int n_mels, int n_mfcc,
    float preemph, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* frames = smem;                 // [R][WIN]
  float* power = frames + R * WIN;      // [R][NBINS]
  float* logmel = power + R * NBINS;    // [R][n_mels]
  const long long g0 = (long long)blockIdx.x * R;
  const int tid = threadIdx.x;

  // 1. Pre-emphasis and framing into shared memory: a warp takes whole
  //    frames and its lanes walk the samples (coalesced reads, one division
  //    per frame).
  for (int r = tid / 32; r < R; r += NT / 32) {
    const long long g = g0 + r;
    float* fr = frames + r * WIN;
    if (g < total) {
      const long long n = g / F;
      const int t0 = (int)(g - n * F) * hop;
      const float* row = x + n * T;
      for (int w = tid % 32; w < WIN; w += 32) {
        const int t = t0 + w;
        const float prev = t > 0 ? row[t - 1] : row[1];
        fr[w] = __fsub_rn(row[t], __fmul_rn(preemph, prev));  // no contraction: as the plain version rounds
      }
    } else {
      for (int w = tid % 32; w < WIN; w += 32) fr[w] = 0.f;
    }
  }
  __syncthreads();

  // 2. Window+DFT and power: thread k owns bin k for all R frames. The next
  //    4 rows of the constants are loaded while the current 4 are used.
  for (int k = tid; k < NBINS; k += NT) {
    const float* pc = dcos + k;
    const float* ps = dsin + k;
    float re[R], im[R], c[4], s[4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      re[r] = 0.f;
      im[r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = __ldg(pc + j * NBINS);
      s[j] = __ldg(ps + j * NBINS);
    }
    for (int w = 0; w < WIN; w += 4) {
      const int wn = w + 4 < WIN ? w + 4 : w;  // the last step reloads its own rows
      float cn[4], sn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cn[j] = __ldg(pc + (wn + j) * NBINS);
        sn[j] = __ldg(ps + (wn + j) * NBINS);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(frames + r * WIN + w);
        re[r] = fmaf(v.x, c[0], re[r]);
        im[r] = fmaf(v.x, s[0], im[r]);
        re[r] = fmaf(v.y, c[1], re[r]);
        im[r] = fmaf(v.y, s[1], im[r]);
        re[r] = fmaf(v.z, c[2], re[r]);
        im[r] = fmaf(v.z, s[2], im[r]);
        re[r] = fmaf(v.w, c[3], re[r]);
        im[r] = fmaf(v.w, s[3], im[r]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = cn[j];
        s[j] = sn[j];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      power[r * NBINS + k] = __fadd_rn(__fmul_rn(re[r], re[r]), __fmul_rn(im[r], im[r]));
  }
  __syncthreads();

  // 3. Mel product and log: a thread owns mel column m for RG frames.
  for (int i = tid; i < n_mels * NG; i += NT) {
    const int m = i % n_mels, r0 = (i / n_mels) * RG;
    float acc[RG];
#pragma unroll
    for (int j = 0; j < RG; ++j) acc[j] = 0.f;
    for (int k = 0; k < NBINS; ++k) {
      const float fb = __ldg(mel + k * n_mels + m);
#pragma unroll
      for (int j = 0; j < RG; ++j) acc[j] = fmaf(power[(r0 + j) * NBINS + k], fb, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < RG; ++j) logmel[(r0 + j) * n_mels + m] = logf(acc[j] + eps);
  }
  __syncthreads();

  // 4. DCT product: a thread owns coefficient c for RG frames.
  for (int i = tid; i < n_mfcc * NG; i += NT) {
    const int c = i % n_mfcc, r0 = (i / n_mfcc) * RG;
    float acc[RG];
#pragma unroll
    for (int j = 0; j < RG; ++j) acc[j] = 0.f;
    for (int m = 0; m < n_mels; ++m) {
      const float d = __ldg(dct + m * n_mfcc + c);
#pragma unroll
      for (int j = 0; j < RG; ++j) acc[j] = fmaf(logmel[(r0 + j) * n_mels + m], d, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < RG; ++j) {
      const long long g = g0 + r0 + j;
      if (g < total) out[g * n_mfcc + c] = acc[j];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
// The caller checks shapes: N >= 1, T >= WIN, F as above. Another frame
// width or bin count is refused with cudaErrorInvalidValue.
extern "C" int mfcc_forward(
    const float* x, const float* dcos, const float* dsin, const float* mel,
    const float* dct, float* out, long long N, int T, int F, int win, int hop,
    int nbins, int n_mels, int n_mfcc, float preemph, float eps, void* stream) {
  if (win != WIN || nbins != NBINS) return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(float) * R * (WIN + NBINS + n_mels));
  cudaError_t err = cudaFuncSetAttribute(
      mfcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = N * F;
  const unsigned blocks = (unsigned)((total + R - 1) / R);
  mfcc_kernel<<<blocks, NT, smem, (cudaStream_t)stream>>>(
      x, dcos, dsin, mel, dct, out, total, T, F, hop, n_mels, n_mfcc,
      preemph, eps);
  return (int)cudaGetLastError();
}
