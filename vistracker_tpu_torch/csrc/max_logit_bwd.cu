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
// stay zero, as do all rows of a block with no live cell. The planes are
// compared bitwise, so no tensor core takes part: a reduced-precision
// product would move the winners.
//
// Design: one block per live cell, then a fixed-order second pass.
//   - Pass 1 (max_logit_bwd_cell_kernel) has one block per (view, 8-row
//     strip, x tile, 128-face block), 10,240 at the stage-6 shape. A cell
//     whose liveness is 0 (the forward's own liveness) returns at once;
//     the 4,008 live ones fill the card with many small blocks instead of
//     320 long ones.
//   - A live block has 512 threads: 128 faces x 4 column groups (a warp
//     is 32 faces of one group, so every lane reads the same pixels: a
//     shared-memory broadcast). The cell's m and gw rows, the pixel x
//     coordinates and each 16-column chunk's least m are staged in shared
//     memory. Group g takes every 4th chunk from chunk g, row by row.
//   - Per (face, row, chunk) a bound first: each plane value e_j is a
//     rounded linear function of the rounded, ascending px, so over the
//     chunk it peaks at one of its two end pixels, where the kernel
//     computes it exactly as it would at any pixel; the face's min over
//     planes is at most min_j of those peaks. Below the chunk's least m
//     the face wins no pixel of the chunk, and the chunk is skipped: an
//     exact test (no margin is needed, the bound is made of values the
//     kernel itself rounds), so the winners are those of the full walk.
//     On the stage-6 scene about 1 (face, row, chunk) in 30, and in a
//     warp of 32 faces about 1 in 9, needs the walk (PERF.md).
//   - The walk compares each pixel's plane min with m; a winner adds
//     gw/den and gw/den * px per tied plane to the row's sums, which
//     fold into the face's 15 sums with py.
//   - The 4 groups' sums are added in shared memory in a fixed order
//     ((g0 + g1) + g2) + g3 and written, coalesced, to the cell's slot of
//     a partial buffer (every cell has a slot; dead cells' slots are
//     neither written nor read).
//   - Pass 2 (max_logit_bwd_sum_kernel) has one thread per dc entry and
//     sums that face's live cells in ascending (strip, x tile) order.
// No atomics: the result has the same bits on every run. The order of
// summation (columns, rows, groups, cells) is not the plain version's,
// hence a tolerance between them.
//
// Bound on an H100: over the live cells, per (pixel, face) 5 FMAs + 4 mins
// + 1 compare with the saved max = 15 fp32 operations (winners are a
// vanishing share: one or two faces per pixel), plus 10 per (row, face)
// for the row terms, against 67 TFLOP/s; the bytes (planes, liveness, m,
// gw, dc, the live cells' partials written and read) are far smaller.
// That bound counts every face of a live cell at every pixel; the skip
// test leaves the kernel a bound test per (face, row, chunk) instead.

#include <cuda_runtime.h>

#include "plane_eval.cuh"

namespace {

using vt::kCw;
using vt::kFblk;
using vt::kNpl;
using vt::kRblk;
constexpr int kMaxXblk = 256;  // widest x tile (ops/coverage.py:_xblk)
constexpr int kGroups = 4;     // column groups of a cell
constexpr int kChunk = 16;     // columns a face's bound test covers
constexpr int kMaxChunks = kMaxXblk / kChunk;
constexpr int kCellThreads = kFblk * kGroups;
constexpr int kCellOut = kFblk * kCw;  // a cell's partial sums
constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kCellThreads)
max_logit_bwd_cell_kernel(const float* __restrict__ cpl,
                          const int* __restrict__ active,
                          const float* __restrict__ m_in,
                          const float* __restrict__ gw_in,
                          float* __restrict__ partial, int n_faces, int size,
                          int xblk, float scale) {
  __shared__ float m_s[kRblk * kMaxXblk];
  __shared__ float gw_s[kRblk * kMaxXblk];
  __shared__ float px_s[kMaxXblk];
  __shared__ float mmin_s[kRblk * kMaxChunks];
  __shared__ float red_s[kGroups - 1][kCellOut];
  const int f_idx = blockIdx.x;
  const int n_xblk = size / xblk;
  const int r_idx = blockIdx.y / n_xblk;
  const int x_idx = blockIdx.y % n_xblk;
  const int b_idx = blockIdx.z;
  const int n_strips = size / kRblk;
  const int n_fblk = n_faces / kFblk;
  const long long cell =
      ((static_cast<long long>(b_idx) * n_strips + r_idx) * n_xblk + x_idx)
      * n_fblk + f_idx;
  // uniform across the block: a dead cell has nothing to add
  if (active[cell] == 0) return;

  const int tid = threadIdx.x;
  const int face_in = tid % kFblk;
  const int group = tid / kFblk;
  const long long face = static_cast<long long>(b_idx) * n_faces
                         + static_cast<long long>(f_idx) * kFblk + face_in;
  float a[kNpl], b[kNpl], c[kNpl];
#pragma unroll
  for (int j = 0; j < kNpl; ++j) {
    a[j] = cpl[face * kCw + 3 * j];
    b[j] = cpl[face * kCw + 3 * j + 1];
    c[j] = cpl[face * kCw + 3 * j + 2];
  }
  const float* m_img = m_in + static_cast<long long>(b_idx) * size * size;
  const float* gw_img = gw_in + static_cast<long long>(b_idx) * size * size;
  for (int i = tid; i < kRblk * xblk; i += kCellThreads) {
    const int row = r_idx * kRblk + i / xblk;
    const int col = x_idx * xblk + i % xblk;
    m_s[i] = m_img[row * size + col];
    gw_s[i] = gw_img[row * size + col];
  }
  for (int i = tid; i < xblk; i += kCellThreads) {
    px_s[i] = vt::pixel_coord(x_idx * xblk + i, scale);
  }
  __syncthreads();
  for (int i = tid; i < kRblk * kMaxChunks; i += kCellThreads) {
    const int r = i / kMaxChunks, q = i % kMaxChunks;
    float lo = m_s[r * xblk + min(q * kChunk, xblk - 1)];
    for (int k = q * kChunk + 1; k < min(q * kChunk + kChunk, xblk); ++k) {
      lo = fminf(lo, m_s[r * xblk + k]);
    }
    mmin_s[i] = lo;  // the chunk's least saved max
  }
  __syncthreads();

  float acc[kCw];
#pragma unroll
  for (int k = 0; k < kCw; ++k) acc[k] = 0.0f;
  const int chunks = (xblk + kChunk - 1) / kChunk;
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
    for (int q = group; q < chunks; q += kGroups) {
      const int i0 = q * kChunk;
      const int i1 = min(i0 + kChunk, xblk);
      // the face's min over its planes is at most `bound` anywhere in the
      // chunk: each plane value is a rounded linear function of the
      // (rounded, ascending) px, so it peaks at an end of the chunk. Below
      // the chunk's least m the face wins no pixel of it.
      float bound = fmaxf(vt::plane_value(a[0], px_s[i0], inner[0]),
                          vt::plane_value(a[0], px_s[i1 - 1], inner[0]));
#pragma unroll
      for (int j = 1; j < kNpl; ++j) {
        bound = fminf(bound,
                      fmaxf(vt::plane_value(a[j], px_s[i0], inner[j]),
                            vt::plane_value(a[j], px_s[i1 - 1], inner[j])));
      }
      if (bound < mmin_s[r * kMaxChunks + q]) continue;
      for (int i = i0; i < i1; ++i) {
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
    }
#pragma unroll
    for (int j = 0; j < kNpl; ++j) {
      acc[3 * j] += dpx[j];
      acc[3 * j + 1] += dsum[j] * py;
      acc[3 * j + 2] += dsum[j];
    }
  }

  // groups 1..3 hand their sums to group 0 through shared memory (stride
  // 15, odd: no bank conflicts); the cell's 1,920 sums leave coalesced
  if (group > 0) {
#pragma unroll
    for (int k = 0; k < kCw; ++k) red_s[group - 1][face_in * kCw + k] = acc[k];
  }
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int k = 0; k < kCw; ++k) {
      const int o = face_in * kCw + k;
      red_s[0][o] = ((acc[k] + red_s[0][o]) + red_s[1][o]) + red_s[2][o];
    }
  }
  __syncthreads();
  float* out = partial + cell * kCellOut;
  for (int o = tid; o < kCellOut; o += kCellThreads) out[o] = red_s[0][o];
}

// dc[b, f, k] = the sum of face f's partials over its live cells, strips
// and x tiles ascending; 0 for a face whose block has no live cell.
__global__ void __launch_bounds__(kSumThreads)
max_logit_bwd_sum_kernel(const int* __restrict__ active,
                         const float* __restrict__ partial,
                         float* __restrict__ dc_out, int batch, int n_faces,
                         int n_cells) {
  const long long e = static_cast<long long>(blockIdx.x) * kSumThreads
                      + threadIdx.x;
  const long long per_view = static_cast<long long>(n_faces) * kCw;
  if (e >= batch * per_view) return;
  const int b_idx = static_cast<int>(e / per_view);
  const int in_view = static_cast<int>(e % per_view);
  const int f_idx = in_view / kCellOut;
  const int o = in_view % kCellOut;
  const int n_fblk = n_faces / kFblk;
  const long long first = static_cast<long long>(b_idx) * n_cells * n_fblk
                          + f_idx;
  float sum = 0.0f;
  for (int s = 0; s < n_cells; ++s) {
    const long long cell = first + static_cast<long long>(s) * n_fblk;
    if (active[cell] != 0) sum += partial[cell * kCellOut + o];
  }
  dc_out[e] = sum;
}

}  // namespace

// cpl (B, F, 15) f32, active (B * S/8, (S/xblk) * (F/128)) int32, m and gw
// (B, S, S) f32, partial (B * S/8 * S/xblk * F/128, 128 * 15) f32 scratch
// (only live cells' slots are written and read), dc (B, F, 15) f32, every
// row written. Two launches on `stream`; returns cudaGetLastError() after
// them.
extern "C" int vt_max_logit_bwd(const float* cpl, const int* active,
                                const float* m_in, const float* gw_in,
                                float* partial, float* dc_out, int batch,
                                int n_faces, int size, int xblk, float scale,
                                void* stream) {
  if (xblk > kMaxXblk || size % xblk != 0 || size % kRblk != 0
      || n_faces % kFblk != 0 || batch < 1
      || batch > 65535 || (size / kRblk) * (size / xblk) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int n_cells = (size / kRblk) * (size / xblk);  // per view and block
  const dim3 grid(n_faces / kFblk, n_cells, batch);
  max_logit_bwd_cell_kernel<<<grid, kCellThreads, 0, s>>>(
      cpl, active, m_in, gw_in, partial, n_faces, size, xblk, scale);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long total = static_cast<long long>(batch) * n_faces * kCw;
  max_logit_bwd_sum_kernel<<<static_cast<unsigned>(
                                 (total + kSumThreads - 1) / kSumThreads),
                             kSumThreads, 0, s>>>(active, partial, dc_out,
                                                  batch, n_faces, n_cells);
  return static_cast<int>(cudaGetLastError());
}
