// K2: backward of the per-pixel max-logit raster (soft-silhouette path).
//
// Replaces the TPU kernel vistracker_tpu/ops/pallas_raster.py:_bwd_kernel
// (pallas_call in _ml_bwd). The forward (max_logit_fwd.cu) gives per pixel
//     m = max over faces f of  min over the 5 planes j of  e_fj,
//     e_fj = a_fj * px + (b_fj * py + c_fj),
// and cnt, the number of faces tied at m. Given gw = g / max(cnt, 1), the
// cotangent of m already split among tied faces, this kernel returns
//     dc[f, 3j + {0, 1, 2}] = sum over pixels where face f wins (its
//         min equals the saved m BITWISE) of  (gw / den) * [px, py, 1]
//         for every plane j tied at the face's min, den = number of such
//         planes (1..5): the equal-split convention of min's vjp.
// Planes are recomputed with plane_eval.cuh, the forward's own arithmetic,
// so the == against the saved max selects exactly the forward's winners.
// Dead and padding faces ([0, 0, -1e9] per plane) never win in a live cell
// (a live block has a face above -1e9 at every pixel), so their rows of dc
// stay zero, as do all rows of a block with no live cell.
//
// Design. The TPU kernel revisits a dc block over a sequential (strip,
// x tile) grid; here one thread block owns one (view, face block) and
// loops over that block's live (strip, x tile) cells itself, one thread
// per face, the 15 sums of a face in registers, written once at the end:
// no atomics, so the result is the same bits on every run. The strip's m
// and gw rows and the tile's pixel x coordinates are staged in shared
// memory (17 KB); every thread reads the same pixel at the same time (a
// broadcast). Per row the thread first sums gw/den and gw/den * px per
// plane, then folds the row into the face's sums with py, so the order of
// summation is pixels, then rows, then strips -- another order than the
// TPU kernel's or the plain version's, hence a tolerance between them.
//
// Bound on an H100: over the live cells, per (pixel, face) 5 FMAs + 4 mins
// + 1 compare with the saved max = 15 fp32 operations (winners are a
// vanishing share: one or two faces per pixel), plus 10 per (row, face)
// for the row terms, against 67 TFLOP/s; the bytes (planes, liveness, m,
// gw, dc) are far smaller. Known limit of this layout: views x face
// blocks thread blocks of 128 threads (16 x 20 = 320 at the stage-6 shape)
// fill the card's 132 SMs only partly, and all 128 faces of a block walk
// every pixel of a live cell whether or not their own bbox reaches it.

#include <cuda_runtime.h>

#include "plane_eval.cuh"

namespace {

using vt::kCw;
using vt::kFblk;
using vt::kNpl;
using vt::kRblk;
constexpr int kMaxXblk = 256;  // widest x tile (ops/coverage.py:_xblk)

__global__ void __launch_bounds__(kFblk)
max_logit_bwd_kernel(const float* __restrict__ cpl,
                     const int* __restrict__ active,
                     const float* __restrict__ m_in,
                     const float* __restrict__ gw_in,
                     float* __restrict__ dc_out, int n_faces, int size,
                     int xblk, float scale) {
  __shared__ float m_s[kRblk * kMaxXblk];
  __shared__ float gw_s[kRblk * kMaxXblk];
  __shared__ float px_s[kMaxXblk];
  const int f_idx = blockIdx.x;
  const int b_idx = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_strips = size / kRblk;
  const int n_xblk = size / xblk;
  const int n_fblk = n_faces / kFblk;

  const long long face = static_cast<long long>(b_idx) * n_faces
                         + static_cast<long long>(f_idx) * kFblk + tid;
  float a[kNpl], b[kNpl], c[kNpl];
#pragma unroll
  for (int j = 0; j < kNpl; ++j) {
    a[j] = cpl[face * kCw + 3 * j];
    b[j] = cpl[face * kCw + 3 * j + 1];
    c[j] = cpl[face * kCw + 3 * j + 2];
  }
  float acc[kCw];
#pragma unroll
  for (int k = 0; k < kCw; ++k) acc[k] = 0.0f;

  const int* live = active + static_cast<long long>(b_idx) * n_strips
                                 * (n_xblk * n_fblk);
  const float* m_img = m_in + static_cast<long long>(b_idx) * size * size;
  const float* gw_img = gw_in + static_cast<long long>(b_idx) * size * size;
  for (int r_idx = 0; r_idx < n_strips; ++r_idx) {
    for (int x_idx = 0; x_idx < n_xblk; ++x_idx) {
      // uniform across the block
      if (live[r_idx * (n_xblk * n_fblk) + x_idx * n_fblk + f_idx] == 0) {
        continue;
      }
      __syncthreads();  // the previous cell's reads are done
      for (int i = tid; i < kRblk * xblk; i += kFblk) {
        const int row = r_idx * kRblk + i / xblk;
        const int col = x_idx * xblk + i % xblk;
        m_s[i] = m_img[row * size + col];
        gw_s[i] = gw_img[row * size + col];
      }
      for (int i = tid; i < xblk; i += kFblk) {
        px_s[i] = vt::pixel_coord(x_idx * xblk + i, scale);
      }
      __syncthreads();
      for (int r = 0; r < kRblk; ++r) {
        const float py = vt::pixel_coord(r_idx * kRblk + r, scale);
        float inner[kNpl], dsum[kNpl], dpx[kNpl];
#pragma unroll
        for (int j = 0; j < kNpl; ++j) {
          inner[j] = vt::row_term(b[j], py, c[j]);
          dsum[j] = 0.0f;
          dpx[j] = 0.0f;
        }
        const float* m_row = m_s + r * xblk;
        const float* gw_row = gw_s + r * xblk;
        for (int i = 0; i < xblk; ++i) {
          const float px = px_s[i];
          float e[kNpl];
          e[0] = vt::plane_value(a[0], px, inner[0]);
          float mv = e[0];
#pragma unroll
          for (int j = 1; j < kNpl; ++j) {
            e[j] = vt::plane_value(a[j], px, inner[j]);
            mv = fminf(mv, e[j]);
          }
          if (mv == m_row[i]) {  // this face is a winner of the pixel
            int den = 0;
#pragma unroll
            for (int j = 0; j < kNpl; ++j) den += (e[j] == mv) ? 1 : 0;
            const float gm = __fdiv_rn(gw_row[i], static_cast<float>(den));
#pragma unroll
            for (int j = 0; j < kNpl; ++j) {
              if (e[j] == mv) {
                dsum[j] += gm;
                dpx[j] += gm * px;
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kNpl; ++j) {
          acc[3 * j] += dpx[j];
          acc[3 * j + 1] += dsum[j] * py;
          acc[3 * j + 2] += dsum[j];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kCw; ++k) dc_out[face * kCw + k] = acc[k];
}

}  // namespace

// cpl (B, F, 15) f32, active (B * S/8, (S/xblk) * (F/128)) int32, m and gw
// (B, S, S) f32, dc (B, F, 15) f32, every row written. Returns
// cudaGetLastError() after the launch.
extern "C" int vt_max_logit_bwd(const float* cpl, const int* active,
                                const float* m_in, const float* gw_in,
                                float* dc_out, int batch, int n_faces,
                                int size, int xblk, float scale,
                                void* stream) {
  if (xblk > kMaxXblk || size % xblk != 0 || size % kRblk != 0
      || n_faces % kFblk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_faces / kFblk, batch);
  max_logit_bwd_kernel<<<grid, kFblk, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      cpl, active, m_in, gw_in, dc_out, n_faces, size, xblk, scale);
  return static_cast<int>(cudaGetLastError());
}
