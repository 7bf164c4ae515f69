// K1: per-pixel max-logit coverage raster, forward (hard-mask path).
//
// Replaces the TPU kernel vistracker_tpu/ops/pallas_raster.py:_fwd_kernel
// (pallas_call in _ml_fwd). For every pixel of B images of size S x S it
// computes
//     m   = max over faces f of  min over the 5 planes j of
//               a_fj * px + (b_fj * py + c_fj)
//     cnt = number of faces whose value equals m
// with pixel centres px = col * (2/(S-1)) - 1, py = row * (2/(S-1)) - 1.
// Faces come in blocks of 128 (dead rows read [0, 0, -1e9] per plane), and
// a (strip of 8 rows, x tile, face block) cell is evaluated only if its
// liveness entry is non-zero -- the same cell geometry as the TPU kernel,
// so the liveness array is shared and m / cnt are bit-comparable with it
// everywhere, culled cells included (they keep m = -1e9, cnt = 0 unless a
// live block writes them).
//
// Design: one thread block per (view, strip, x tile); the TPU's sequential
// face-block grid axis becomes a loop inside the block (Hopper blocks run
// in no order, so nothing can be carried between blocks). Each live block's
// 128 x 15 coefficients are staged in shared memory, padded to 16 floats a
// face (8 KB) so that a face is four float4 broadcast reads. Each thread
// owns PPT consecutive pixels of ONE row, so the row term b*py + c is
// computed once per (face, plane) and shared by its pixels, as the TPU
// kernel hoists it per row; PPT is the least power of two that keeps a
// block at <= 256 threads. The thread keeps a running max and tie count
// per pixel in registers; taking faces one at a time gives the same
// (max, count) as the TPU's block-wise rule (beats -> count = bc; ties ->
// count + bc; loses -> unchanged), because both keep "count of faces equal
// to the running max".
//
// Rounding: each plane is fma(a, px, fma(b, py, c)) with px, py =
// fma(index, 2/(S-1), -1): that is how the JAX reference evaluates the
// kernel body on the CPU (XLA contracts each product into an FMA; with
// separate roundings pixels of m differ from it). plane_eval.cuh pins it
// with __fmaf_rn for this kernel and for the backward kernel, which
// recomputes the same values; the plain PyTorch version (ops/coverage.py)
// emulates the same FMAs. A different rounding flips edge pixels of the
// hard mask.
//
// The soft silhouette (stage 6) uses this kernel too: at <= 256 px the x
// tile is the whole row, the liveness comes from the interval bound
// (ops/coverage.py:_strip_active) and the sigmoid runs outside.
//
// Bound on an H100: fp32 work on CUDA cores over the LIVE cells only --
// per (pixel, face) 5 FMAs (10 flops) + 4 mins + 1 compare = 15
// operations, plus per (row, face) the 5 row-term FMAs (10 flops) --
// against 67 TFLOP/s; the bytes (coefficients, liveness, two f32 outputs)
// are far smaller at the stage-3 shape (24 views, 13,776 faces, 512^2), so
// the kernel is bound by operations.

#include <cuda_runtime.h>

#include "plane_eval.cuh"

namespace {

using vt::kBig;
using vt::kCw;
using vt::kFblk;
using vt::kNpl;
using vt::kRblk;
constexpr int kPad = 16;      // shared-memory floats per face
constexpr int kMaxThreads = 256;

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
max_logit_fwd_kernel(const float* __restrict__ cpl,
                     const int* __restrict__ active,
                     float* __restrict__ m_out, float* __restrict__ cnt_out,
                     int n_faces, int size, int xblk, float scale) {
  __shared__ float4 coef[kFblk * kPad / 4];
  float* coef_f = reinterpret_cast<float*>(coef);
  const int x_idx = blockIdx.x;
  const int r_idx = blockIdx.y;
  const int b_idx = blockIdx.z;
  const int n_strips = size / kRblk;
  const int n_xblk = size / xblk;
  const int n_fblk = n_faces / kFblk;
  const int tid = threadIdx.x;

  // PPT divides xblk, so the thread's pixels share one row
  const int p0 = tid * PPT;
  const int row = r_idx * kRblk + p0 / xblk;
  const int col0 = x_idx * xblk + p0 % xblk;
  const float py = vt::pixel_coord(row, scale);
  float px[PPT], best[PPT];
  int count[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    px[k] = vt::pixel_coord(col0 + k, scale);
    best[k] = -kBig;
    count[k] = 0;
  }

  const int* live = active + (static_cast<long long>(b_idx) * n_strips
                              + r_idx) * (n_xblk * n_fblk)
                    + x_idx * n_fblk;
  const float* base = cpl + static_cast<long long>(b_idx) * n_faces * kCw;
  for (int f = 0; f < n_fblk; ++f) {
    if (live[f] == 0) continue;  // uniform across the block
    __syncthreads();             // previous block's reads are done
    const float* src = base + static_cast<long long>(f) * kFblk * kCw;
    for (int i = tid; i < kFblk * kCw; i += blockDim.x) {
      coef_f[(i / kCw) * kPad + i % kCw] = src[i];
    }
    __syncthreads();
    for (int i = 0; i < kFblk; ++i) {
      const float4 q0 = coef[4 * i], q1 = coef[4 * i + 1];
      const float4 q2 = coef[4 * i + 2], q3 = coef[4 * i + 3];
      // plane j is (a, b, c) at floats 3j .. 3j + 2 of the face
      const float a[kNpl] = {q0.x, q0.w, q1.z, q2.y, q3.x};
      const float inner[kNpl] = {
          vt::row_term(q0.y, py, q0.z), vt::row_term(q1.x, py, q1.y),
          vt::row_term(q1.w, py, q2.x), vt::row_term(q2.z, py, q2.w),
          vt::row_term(q3.y, py, q3.z)};
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        float mv = vt::plane_value(a[0], px[k], inner[0]);
#pragma unroll
        for (int j = 1; j < kNpl; ++j) {
          mv = fminf(mv, vt::plane_value(a[j], px[k], inner[j]));
        }
        if (mv > best[k]) {
          best[k] = mv;
          count[k] = 1;
        } else if (mv == best[k]) {
          count[k] += 1;
        }
      }
    }
  }

  const long long o = (static_cast<long long>(b_idx) * size + row) * size
                      + col0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    m_out[o + k] = best[k];
    cnt_out[o + k] = static_cast<float>(count[k]);
  }
}

}  // namespace

// cpl (B, F, 15) f32, active (B * S/8, (S/xblk) * (F/128)) int32,
// m / cnt (B, S, S) f32. Returns cudaGetLastError() after the launch.
extern "C" int vt_max_logit_fwd(const float* cpl, const int* active,
                                float* m_out, float* cnt_out, int batch,
                                int n_faces, int size, int xblk, float scale,
                                void* stream) {
  const int n_pix = kRblk * xblk;
  int ppt = 1;
  while (ppt <= 8 && (n_pix / ppt > kMaxThreads || xblk % ppt != 0)) {
    ppt *= 2;
  }
  if (ppt > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(size / xblk, size / kRblk, batch);
  const int threads = n_pix / ppt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ppt) {
    case 1:
      max_logit_fwd_kernel<1><<<grid, threads, 0, s>>>(
          cpl, active, m_out, cnt_out, n_faces, size, xblk, scale);
      break;
    case 2:
      max_logit_fwd_kernel<2><<<grid, threads, 0, s>>>(
          cpl, active, m_out, cnt_out, n_faces, size, xblk, scale);
      break;
    case 4:
      max_logit_fwd_kernel<4><<<grid, threads, 0, s>>>(
          cpl, active, m_out, cnt_out, n_faces, size, xblk, scale);
      break;
    default:
      max_logit_fwd_kernel<8><<<grid, threads, 0, s>>>(
          cpl, active, m_out, cnt_out, n_faces, size, xblk, scale);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
