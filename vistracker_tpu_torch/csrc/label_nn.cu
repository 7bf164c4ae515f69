// K3: labelled nearest neighbour -- per x point the min squared distance
// to the valid y points of the same label, and the index of the first y
// point that attains it. K4: the same without labels.
//
// K3 replaces the TPU kernel vistracker_tpu/ops/pallas_nn.py:
// _labelnn_kernel (pallas_call in _labelnn_call), the contact-pairing
// primitive of the stage-6 joint phase; entry vt_label_nn. K4 replaces
// pallas_nn.py:_nn_kernel (pallas_call in nn_min_sqdist_pallas, behind
// chamfer_pallas), the y-masked min of the evaluation chamfer; entry
// vt_nn_min. For x (B, N, 3), y (B, M, 3), integer labels (K3 only) and
// a validity flag per y point:
//     d_ij   = max((|x_i|^2 + |y_j|^2) - 2 (x_i . y_j), 0)
//     min_i  = min over j with valid_j and label_j == label_i of d_ij,
//              1e10 when there is no such j
//     idx_i  = the least j attaining min_i (0 when there is none)
//
// Arithmetic. Every operation is rounded once and in a fixed order,
//     |v|^2 = (v0 v0 + v1 v1) + v2 v2,   x.y = (x0 y0 + x1 y1) + x2 y2,
// written with __fmul_rn / __fadd_rn / __fsub_rn so the compiler cannot
// contract a product into an FMA. The plain PyTorch version
// (ops/label_nn.py:label_nn_plain) spells out the same operations, so min
// and idx are bit-equal between the two on the card; an argmin is
// decided by the last bit when two candidates are close.
//
// Design. One thread per x point, the batch in the grid. y is staged
// through shared memory in tiles of 1024 points as (y0, y1, y2, |y|^2)
// plus label and validity, read by all threads of the block at the same
// address (a broadcast). Each thread keeps a running (min, idx) and takes
// a candidate only on strict <, walking j upwards, which is
// first-occurrence argmin within and across tiles. The inner size is 3:
// plain FP32 instructions, no tensor cores (reduced-precision products
// flip argmins).
//
// Bound on an H100: N x M pairs per batch element at 12 fp32 operations a
// pair for K3 (5 for x.y, 3 for the distance, 2 for the mask, 2 for the
// running min; the max at 0 is not counted) and 11 for K4 (no label
// compare) against 67 TFLOP/s; the bytes (both clouds, labels, validity,
// two outputs) are far smaller.
//
// The label test is a template parameter: K4 is this kernel with the test
// compiled out; it reads and indexes no label array (null pointers). One
// thread per x point underfills the card at B = 1 (the evaluation's
// 10,000 points are 79 blocks of 128 threads on 132 SMs).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // x points per block
constexpr int kTile = 1024;     // y points staged at a time
constexpr float kNone = 1e10f;  // distance when no compatible y exists

__device__ __forceinline__ float sq_norm(float v0, float v1, float v2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(v0, v0), __fmul_rn(v1, v1)),
                   __fmul_rn(v2, v2));
}

template <bool kLabels>
__global__ void __launch_bounds__(kThreads)
label_nn_kernel(const float* __restrict__ x, const int* __restrict__ lx,
                const float* __restrict__ y, const int* __restrict__ ly,
                const unsigned char* __restrict__ y_valid,
                float* __restrict__ min_out, int* __restrict__ idx_out,
                int n, int m) {
  __shared__ float4 ys[kTile];
  __shared__ int ls[kTile];
  __shared__ unsigned char vs[kTile];
  const int b_idx = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const bool has_point = i < n;
  const long long xi = static_cast<long long>(b_idx) * n + (has_point ? i : 0);
  const float x0 = x[xi * 3], x1 = x[xi * 3 + 1], x2 = x[xi * 3 + 2];
  const float xx = sq_norm(x0, x1, x2);
  int label = 0;
  const int* lb = nullptr;
  if constexpr (kLabels) {
    label = lx[xi];
    lb = ly + static_cast<long long>(b_idx) * m;
  }
  const float* yb = y + static_cast<long long>(b_idx) * m * 3;
  const unsigned char* vb = y_valid + static_cast<long long>(b_idx) * m;

  float best = kNone;
  int best_j = 0;
  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int count = min(kTile, m - j0);
    __syncthreads();  // the previous tile's reads are done
    for (int j = tid; j < count; j += kThreads) {
      const float y0 = yb[(j0 + j) * 3], y1 = yb[(j0 + j) * 3 + 1];
      const float y2 = yb[(j0 + j) * 3 + 2];
      ys[j] = make_float4(y0, y1, y2, sq_norm(y0, y1, y2));
      if constexpr (kLabels) ls[j] = lb[j0 + j];
      vs[j] = vb[j0 + j];
    }
    __syncthreads();
    for (int j = 0; j < count; ++j) {
      const float4 q = ys[j];
      const float xy = __fadd_rn(
          __fadd_rn(__fmul_rn(x0, q.x), __fmul_rn(x1, q.y)),
          __fmul_rn(x2, q.z));
      float d = fmaxf(__fsub_rn(__fadd_rn(xx, q.w), __fmul_rn(2.0f, xy)),
                      0.0f);
      bool ok = vs[j] != 0;
      if constexpr (kLabels) ok = ok && ls[j] == label;
      d = ok ? d : kNone;
      if (d < best) {
        best = d;
        best_j = j0 + j;
      }
    }
  }
  if (has_point) {
    min_out[xi] = best;
    idx_out[xi] = best_j;
  }
}

}  // namespace

// x (B, N, 3) f32, lx (B, N) int32, y (B, M, 3) f32, ly (B, M) int32,
// y_valid (B, M) uint8, min_out (B, N) f32, idx_out (B, N) int32. Returns
// cudaGetLastError() after the launch.
extern "C" int vt_label_nn(const float* x, const int* lx, const float* y,
                           const int* ly, const unsigned char* y_valid,
                           float* min_out, int* idx_out, int batch, int n,
                           int m, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  label_nn_kernel<true><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, lx, y, ly, y_valid, min_out, idx_out, n, m);
  return static_cast<int>(cudaGetLastError());
}

// K4: x (B, N, 3) f32, y (B, M, 3) f32, y_valid (B, M) uint8, min_out
// (B, N) f32, idx_out (B, N) int32. Returns cudaGetLastError() after the
// launch.
extern "C" int vt_nn_min(const float* x, const float* y,
                         const unsigned char* y_valid, float* min_out,
                         int* idx_out, int batch, int n, int m, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  label_nn_kernel<false><<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, nullptr, y, nullptr, y_valid, min_out, idx_out, n, m);
  return static_cast<int>(cudaGetLastError());
}
