// K1: per-pixel max-logit coverage raster, forward (hard mask and soft
// silhouette).
//
// Replaces the TPU kernel vistracker_tpu/ops/pallas_raster.py:_fwd_kernel
// (pallas_call in _ml_fwd). For every pixel of B images of size S x S it
// computes
//     m   = max over faces f of  min over the 5 planes j of
//               a_fj * px + (b_fj * py + c_fj)
//     cnt = number of faces whose value equals m
// with pixel centres px = col * (2/(S-1)) - 1, py = row * (2/(S-1)) - 1.
// Faces come in blocks of 128 (dead rows read [0, 0, -1e9] per plane), and
// a (strip of 8 rows, x tile, face block) cell counts only if its liveness
// entry is non-zero -- the same cell geometry as the TPU kernel, so the
// liveness array is shared and m / cnt are bit-comparable with it
// everywhere: a pixel with no live cell reads m = -1e9, cnt = 0. Stage 3
// (ops/coverage.py:coverage_mask_batch) takes m >= 0; stage 6
// (soft_silhouette_batch) takes sigmoid(m / sigma) outside, with the
// interval-bound liveness of ops/coverage.py:_strip_active.
//
// Design: one warp per tile of 8 rows x 16 columns, over all live face
// blocks of the tile's (view, strip, x tile), with an exact skip test.
//   - A lane owns 4 consecutive pixels of one row (lane / 4 is the row),
//     so the row term b*py + c is computed once per (face, plane) and
//     shared by its pixels, as the TPU kernel hoists it per row; it keeps a
//     running max and tie count per pixel in registers. Each pixel belongs
//     to one warp, which sees every face of its cells: no partial result
//     leaves a warp, so there is nothing to merge and no scratch buffer.
//   - A block is 4 warps, the 4 tiles of 64 neighbouring columns. It
//     lists its row's live face blocks in shared memory (one coalesced
//     read of the liveness) and stages each one's 1,920 coefficients
//     (7.5 KB) for its warps. Work is cut into those
//     tiles: at the stage-6 shape 8,192 warps, 2,048 blocks, with no host
//     sync and a grid sized from the shapes alone; a row whose cells are
//     all dead only writes -1e9 / 0.
//   - Skip test. Each plane value is a rounded FMA of rounded, monotone
//     pixel coordinates, so over the tile it lies between its values at
//     the tile's corners: with i0, i1 = fma(b, py, c) at the first and last
//     row, every e = fma(a, px, inner) of the tile is at most
//     ub = max over the first and last column of fma(a, px, max(i0, i1))
//     and at least lb = min over them of fma(a, px, min(i0, i1)). A face's
//     value is at most bound = min_j ub_j and at least low = min_j lb_j.
//     Lanes test 32 faces at once, one a lane.
//   - Pass 1 takes T0 = max over the tile's faces of `low`: every pixel of
//     the tile has m >= T0 (m is a max over those faces). Pass 2 walks the
//     faces in ascending order, 32 at a time; the batch's threshold is
//     max(T0, the tile's least running max); a face whose bound is below
//     it can neither raise a pixel's max nor tie the final one, so only
//     the faces with bound >= threshold (a ballot) are walked, pixel by
//     pixel. Equal is walked, so ties are kept; skipped faces change no
//     bit, and the (max, tie count) over the walked faces is the plain
//     version's block-wise rule (beats -> count = bc; ties -> count + bc),
//     which does not depend on the order of faces.
//   - `stats`, when given, counts the tested and the walked (face, tile)
//     pairs (the skip share; chip_smoke.py's record). The counters live
//     only in the kStats instance; a null `stats` launches the one
//     without them.
//
// Rounding: each plane is fma(a, px, fma(b, py, c)) with px, py =
// fma(index, 2/(S-1), -1): that is how the JAX reference evaluates the
// kernel body on the CPU (XLA contracts each product into an FMA; with
// separate roundings pixels of m differ from it). plane_eval.cuh pins it
// with __fmaf_rn for this kernel and for the backward kernel, which
// recomputes the same values and selects winners with ==; the plain
// PyTorch version (ops/coverage.py) emulates the same FMAs.
//
// Bound on an H100: fp32 work on CUDA cores over the LIVE cells -- per
// (pixel, face) 5 FMAs (10 flops) + 4 mins + 1 compare = 15 operations,
// plus per (row, face) the 5 row-term FMAs (10 flops) -- against 67
// TFLOP/s; the bytes (coefficients, liveness, two f32 outputs) are far
// smaller at both shapes, so the bound is by operations. The skip test
// leaves the kernel about 110 operations per (face, tile) for the two
// tests, and the walk of the kept (face, tile) pairs.

#include <cuda_runtime.h>

#include "plane_eval.cuh"

namespace {

using vt::kBig;
using vt::kCw;
using vt::kFblk;
using vt::kNpl;
using vt::kRblk;
constexpr int kPpt = 4;                          // pixels a lane, one row
constexpr int kTileCols = 32 / kRblk * kPpt;     // 16 columns a warp
constexpr int kWarps = 4;                        // tiles a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// Face i of a staged block: its 15 coefficients, stride 15 (odd, so 32
// lanes reading 32 neighbouring faces hit 32 banks; one face read by
// every lane is a broadcast).
__device__ __forceinline__ void load_face(const float* coef, int i,
                                          float (&a)[kNpl], float (&b)[kNpl],
                                          float (&c)[kNpl]) {
#pragma unroll
  for (int j = 0; j < kNpl; ++j) {  // plane j is floats 3j .. 3j + 2
    a[j] = coef[i * kCw + 3 * j];
    b[j] = coef[i * kCw + 3 * j + 1];
    c[j] = coef[i * kCw + 3 * j + 2];
  }
}

// A face's least (`low`) and greatest (returned) value over a tile with
// corner coordinates px0 <= px1, py0 <= py1, in the kernel's own
// rounding: no pixel of the tile is outside them.
__device__ __forceinline__ float face_range(const float (&a)[kNpl],
                                            const float (&b)[kNpl],
                                            const float (&c)[kNpl],
                                            float px0, float px1, float py0,
                                            float py1, float& low) {
  float hi = __int_as_float(0x7f800000), lo = hi;  // +inf
#pragma unroll
  for (int j = 0; j < kNpl; ++j) {
    const float i0 = vt::row_term(b[j], py0, c[j]);
    const float i1 = vt::row_term(b[j], py1, c[j]);
    const float ih = fmaxf(i0, i1), il = fminf(i0, i1);
    hi = fminf(hi, fmaxf(vt::plane_value(a[j], px0, ih),
                         vt::plane_value(a[j], px1, ih)));
    lo = fminf(lo, fminf(vt::plane_value(a[j], px0, il),
                         vt::plane_value(a[j], px1, il)));
  }
  low = lo;
  return hi;
}

// A face block's 1,920 coefficients into shared memory as float4, for
// the whole block (the planes start on 16 bytes, so every block does).
__device__ __forceinline__ void stage(float4* coef4, const float* src,
                                      int tid) {
  __syncthreads();  // the previous block's reads are done
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int i = tid; i < kFblk * kCw / 4; i += kThreads) coef4[i] = s4[i];
  __syncthreads();
}

// The live face blocks among [f0, f0 + kThreads), ascending, into `list`;
// returns how many (the same in every thread).
__device__ __forceinline__ int live_blocks(const int* live, int f0,
                                           int n_fblk, int* list,
                                           int* warp_cnt, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const bool on = f0 + tid < n_fblk && live[f0 + tid] != 0;
  const unsigned bal = __ballot_sync(kAll, on);
  __syncthreads();  // the previous list is read
  if (lane == 0) warp_cnt[warp] = __popc(bal);
  __syncthreads();
  int off = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? warp_cnt[w] : 0;
    total += warp_cnt[w];
  }
  if (on) list[off + __popc(bal & ((1u << lane) - 1u))] = f0 + tid;
  __syncthreads();
  return total;
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads, 8)
max_logit_fwd_kernel(const float* __restrict__ cpl,
                     const int* __restrict__ active,
                     float* __restrict__ m_out, float* __restrict__ cnt_out,
                     unsigned long long* __restrict__ stats, int n_faces,
                     int size, int xblk, float scale) {
  __shared__ float4 coef4[kFblk * kCw / 4];  // 16-byte aligned
  __shared__ int list[kThreads];
  __shared__ int warp_cnt[kWarps];
  float* coef = reinterpret_cast<float*>(coef4);
  const int n_tiles = (xblk + kTileCols - 1) / kTileCols;  // per x tile
  const int groups = (n_tiles + kWarps - 1) / kWarps;
  const int x_idx = blockIdx.x / groups;
  const int r_idx = blockIdx.y;
  const int b_idx = blockIdx.z;
  const int n_strips = size / kRblk;
  const int n_xblk = size / xblk;
  const int n_fblk = n_faces / kFblk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tile = (blockIdx.x % groups) * kWarps + (tid >> 5);
  const bool has_tile = tile < n_tiles;  // uniform across the warp

  // the tile's columns t0..last of the x tile (a ragged last tile repeats
  // its last column); the lane's row and first column
  const int t0 = min(tile * kTileCols, xblk - 1);
  const int last = min(t0 + kTileCols, xblk) - 1;
  const int x0 = x_idx * xblk;
  const int row = r_idx * kRblk + lane / (kTileCols / kPpt);
  const int c0 = t0 + (lane % (kTileCols / kPpt)) * kPpt;
  const float py = vt::pixel_coord(row, scale);
  const float px0 = vt::pixel_coord(x0 + t0, scale);
  const float px1 = vt::pixel_coord(x0 + last, scale);
  const float py0 = vt::pixel_coord(r_idx * kRblk, scale);
  const float py1 = vt::pixel_coord(r_idx * kRblk + kRblk - 1, scale);
  float px[kPpt], best[kPpt];
  int count[kPpt];
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    px[k] = vt::pixel_coord(x0 + min(c0 + k, last), scale);
    best[k] = -kBig;
    count[k] = 0;
  }

  const int* live = active + (static_cast<long long>(b_idx) * n_strips
                              + r_idx) * (n_xblk * n_fblk)
                    + x_idx * n_fblk;
  const float* base = cpl + static_cast<long long>(b_idx) * n_faces * kCw;
  float a[kNpl], b[kNpl], c[kNpl];

  // pass 1: T0, a lower bound of m at every pixel of the tile
  float low_max = -kBig;
  for (int f0 = 0; f0 < n_fblk; f0 += kThreads) {
    const int n_live = live_blocks(live, f0, n_fblk, list, warp_cnt, tid);
    for (int l = 0; l < n_live; ++l) {
      stage(coef4, base + static_cast<long long>(list[l]) * kFblk * kCw,
            tid);
      if (!has_tile) continue;
#pragma unroll
      for (int q = 0; q < kFblk / 32; ++q) {
        float low;
        load_face(coef, q * 32 + lane, a, b, c);
        face_range(a, b, c, px0, px1, py0, py1, low);
        low_max = fmaxf(low_max, low);
      }
    }
  }
  const float t_low = warp_max(low_max);

  // pass 2: walk the faces that can reach the threshold
  unsigned long long tested = 0, walked = 0;
  for (int f0 = 0; f0 < n_fblk; f0 += kThreads) {
    const int n_live = live_blocks(live, f0, n_fblk, list, warp_cnt, tid);
    for (int l = 0; l < n_live; ++l) {
      stage(coef4, base + static_cast<long long>(list[l]) * kFblk * kCw,
            tid);
      if (!has_tile) continue;
      for (int q = 0; q < kFblk / 32; ++q) {
        float lo = best[0];
#pragma unroll
        for (int k = 1; k < kPpt; ++k) lo = fminf(lo, best[k]);
        const float thr = fmaxf(t_low, warp_min(lo));
        float low;
        load_face(coef, q * 32 + lane, a, b, c);
        const float hi = face_range(a, b, c, px0, px1, py0, py1, low);
        unsigned mask = __ballot_sync(kAll, hi >= thr);
        if (kStats) {
          tested += 32;
          walked += __popc(mask);
        }
        while (mask != 0) {
          const int i = __ffs(mask) - 1;
          mask &= mask - 1;
          load_face(coef, q * 32 + i, a, b, c);  // a broadcast read
          float inner[kNpl];
#pragma unroll
          for (int j = 0; j < kNpl; ++j) {
            inner[j] = vt::row_term(b[j], py, c[j]);
          }
#pragma unroll
          for (int k = 0; k < kPpt; ++k) {
            float mv = vt::plane_value(a[0], px[k], inner[0]);
#pragma unroll
            for (int j = 1; j < kNpl; ++j) {
              mv = fminf(mv, vt::plane_value(a[j], px[k], inner[j]));
            }
            // greater replaces, equal adds (no branch)
            const float was = best[k];
            best[k] = fmaxf(was, mv);
            count[k] = mv > was ? 1 : count[k] + (mv == was ? 1 : 0);
          }
        }
      }
    }
  }

  if (!has_tile) return;
  if (kStats && lane == 0) {
    atomicAdd(stats, tested);
    atomicAdd(stats + 1, walked);
  }
  const long long o = (static_cast<long long>(b_idx) * size + row) * size
                      + x0 + c0;
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    if (c0 + k <= last) {
      m_out[o + k] = best[k];
      cnt_out[o + k] = static_cast<float>(count[k]);
    }
  }
}

}  // namespace

// cpl (B, F, 15) f32 on 16 bytes, active (B * S/8, (S/xblk) * (F/128))
// int32, m / cnt (B, S, S) f32, every pixel written; stats null or two uint64
// (tested, walked (face, tile) pairs), added to. Returns
// cudaGetLastError() after the launch.
extern "C" int vt_max_logit_fwd(const float* cpl, const int* active,
                                float* m_out, float* cnt_out,
                                unsigned long long* stats, int batch,
                                int n_faces, int size, int xblk, float scale,
                                void* stream) {
  if (batch < 1 || batch > 65535 || n_faces < kFblk || n_faces % kFblk != 0
      || xblk < 1 || size % xblk != 0 || size % kRblk != 0
      || size / kRblk > 65535
      || reinterpret_cast<unsigned long long>(cpl) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (xblk + kTileCols - 1) / kTileCols;
  const int groups = (n_tiles + kWarps - 1) / kWarps;
  const dim3 grid((size / xblk) * groups, size / kRblk, batch);
  const auto s = static_cast<cudaStream_t>(stream);
  if (stats == nullptr) {
    max_logit_fwd_kernel<false><<<grid, kThreads, 0, s>>>(
        cpl, active, m_out, cnt_out, stats, n_faces, size, xblk, scale);
  } else {
    max_logit_fwd_kernel<true><<<grid, kThreads, 0, s>>>(
        cpl, active, m_out, cnt_out, stats, n_faces, size, xblk, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
