/* Padded-batch assembly for the host data path (the port's copy of the JAX
 * package's collate.c; the reference gets the same from torch's
 * pad_sequence in its DataLoader).
 *
 * pad_time_major: B ragged [T_b, D] float32 arrays scattered into a
 * time-major [L, B, D] buffer, zero-padded (the layout every model reads).
 * pad_batch_first_f32 / _i32: B ragged [T_b] rows into a zeroed [B, L]
 * buffer (umask, label).
 *
 * Bound with ctypes by ser_tpu_torch/native/__init__.py and built at first
 * use with cc -O3 -shared -fPIC.
 */

#include <stdint.h>
#include <string.h>

void pad_time_major(const float **srcs, const int32_t *lens, int32_t n_src,
                    int32_t B, int32_t D, int32_t L, float *out) {
  /* out may be uninitialised: each output byte is written once, a source
   * row copied or a padding row zeroed. B is the padded batch (the row
   * stride), n_src <= B the real sequences. t outer, b inner: the writes
   * run in out's order and each source row read is one 4*D-byte block. */
  for (int32_t t = 0; t < L; ++t) {
    float *row = out + (size_t)t * B * D;
    for (int32_t b = 0; b < B; ++b) {
      if (b < n_src && t < lens[b]) {
        memcpy(row + (size_t)b * D, srcs[b] + (size_t)t * D,
               (size_t)D * sizeof(float));
      } else {
        memset(row + (size_t)b * D, 0, (size_t)D * sizeof(float));
      }
    }
  }
}

void pad_batch_first_f32(const float **srcs, const int32_t *lens, int32_t B,
                         int32_t L, float *out) {
  for (int32_t b = 0; b < B; ++b) {
    memcpy(out + (size_t)b * L, srcs[b], (size_t)lens[b] * sizeof(float));
  }
}

void pad_batch_first_i32(const int32_t **srcs, const int32_t *lens, int32_t B,
                         int32_t L, int32_t *out) {
  for (int32_t b = 0; b < B; ++b) {
    memcpy(out + (size_t)b * L, srcs[b], (size_t)lens[b] * sizeof(int32_t));
  }
}
