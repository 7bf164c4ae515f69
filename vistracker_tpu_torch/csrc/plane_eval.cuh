// Plane evaluation shared by the max-logit forward (max_logit_fwd.cu) and
// backward (max_logit_bwd.cu) kernels.
//
// The backward selects winning faces with a bitwise == between the plane
// values it recomputes and the per-pixel max the forward saved, so both
// kernels must round identically: a one-ulp difference silently drops a
// pixel's gradient. Every step is one single-rounded FMA (__fmaf_rn, which
// the compiler may neither split nor re-associate):
//     px    = fma(col, 2/(S-1), -1)      py = fma(row, 2/(S-1), -1)
//     inner = fma(b, py, c)              (the row term, shared by a row)
//     e     = fma(a, px, inner)
// This is also what the plain PyTorch version emulates (ops/coverage.py:
// fma32) and how the JAX reference evaluates the kernel body on the CPU.
#pragma once

#include <cuda_runtime.h>

namespace vt {

constexpr int kFblk = 128;     // faces per block
constexpr int kRblk = 8;       // image rows per strip
constexpr int kNpl = 5;        // planes per face
constexpr int kCw = 3 * kNpl;  // coefficients per face
constexpr float kBig = 1e9f;

__device__ __forceinline__ float pixel_coord(int index, float scale) {
  return __fmaf_rn(static_cast<float>(index), scale, -1.0f);
}

__device__ __forceinline__ float row_term(float b, float py, float c) {
  return __fmaf_rn(b, py, c);
}

__device__ __forceinline__ float plane_value(float a, float px, float inner) {
  return __fmaf_rn(a, px, inner);
}

}  // namespace vt
