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
// decided by the last bit when two candidates are close. The inner size
// is 3: plain FP32 instructions, no tensor cores (reduced-precision
// products would flip argmins).
//
// K3 design: search only compatible pairs. In the joint phase about 7% of
// the N x M pairs share a label with a valid y point; the rest can only
// yield 1e10, which never wins the strict <, so skipping them changes no
// bit. A plan (entry vt_label_nn_plan; its plain version is
// ops/label_nn.py:label_nn_plan_plain) gives each y point the key label
// (valid) or a sentinel above every label (invalid), sorts y stably by
// key and x by label, and gives each sorted x the range [lo, hi) of sorted
// y positions holding its label. Inside one key, sorted positions ascend
// with the original index j.
//   - The plan is one block per batch element. Where the element's labels
//     (x, and valid y) span fewer than 32 values (part labels span 14) it
//     sorts both clouds by counting: each warp counts its segment per
//     bucket, the counts become each (warp, bucket)'s first position, and
//     each warp places its segment 32 points at a time, a point's rank
//     among its lanes of the same bucket from __match_any_sync; an x
//     point's range is its label's y bucket. Any wider element keeps
//     the index order with every x's range the whole of y, which the
//     search below takes with a label test per pair: the first design's
//     cost, and the same bits. One launch, no host sync, any row length.
//   - A block owns 128 consecutive sorted x points, 4 per lane, held in
//     registers by every one of its 8 warps; its y range is the union
//     [lo(first x), hi(last x)).
//   - The range is staged through shared memory in tiles of 512 points as
//     (y0, y1, y2, |y|^2) and the key; a tile whose keys and the block's x
//     labels are all one value (__syncthreads_and) skips the label test.
//     Each tile is split into 8 contiguous slices, one per warp, so a long
//     range (the dense case: one label, all valid) keeps every warp busy.
//     One staged point feeds the 4 x points of a lane.
//   - Each warp walks its slices upwards and takes a candidate only on a
//     strict <: the least sorted position among its ties. The 8 partial
//     (min, position) are merged in shared memory: the smaller distance
//     wins and the smaller position wins a tie, which is the smaller j
//     since positions ascend with j among the points of one key. So min
//     and argmin equal the plain version's bit for bit. A row with no
//     compatible y reads (1e10, 0).
//   - Results are scattered back to the original x order; the argmin is
//     translated from sorted position to j.
// Bound on an H100: the compatible pairs at 12 fp32 operations a pair (5
// for x.y, 3 for the distance, 2 for the label test, 2 for the running
// min; the max at 0 is not counted) against 67 TFLOP/s, or the bytes of
// both clouds read once, whichever is larger. A uniform tile does 10 of
// the 12; every one is a plain FP32 instruction, so the kernel cannot pass
// about half of a bound that counts an FMA as two operations.
//
// K4 design (nn_min_kernel, entry vt_nn_min): fill the card at one cloud
// a call. The evaluation chamfer calls it with one cloud of 10,000 points
// against another; one thread per x point would be 79 blocks on 132 SMs.
//   - A block owns 128 x points, 4 per lane, held in registers by each of
//     its 8 warps, and one of `splits` contiguous ranges of y; each warp
//     takes an eighth of the range, ascending. The wrapper picks `splits`
//     from the shapes alone (ops/chamfer.py:_splits): the most that keep
//     the grid within three blocks an SM, each range at least 256 points
//     (5 at 10,000 x 10,000: 395 blocks on 132 SMs).
//   - A warp stages 128 y points at a time in its own shared memory as
//     (y0, y1, y2, |y|^2), |y|^2 = +inf for an invalid point, so its
//     distance is +inf and never wins: no validity test in the loop. One
//     staged point (a broadcast read) feeds the 4 x points of a lane.
//   - Each warp takes a candidate only on a strict <, so it keeps the least
//     j among its ties; a warp with no candidate keeps (1e10, 0). The
//     block merges its 8 warps in ascending order with a strict <, and so
//     does a second launch over the splits ((splits, B, N) partial minima
//     and indices, 8 bytes a slot: 400 KB at 10,000 points x 5 splits;
//     none with one split). Earlier ranges hold smaller j, so every tie
//     goes to the least j: min and argmin are the plain version's, with the
//     same bits on every run (no atomics).
// Bound: N x M pairs at 11 operations a pair (x.y 5, distance 3, the
// running min 2, 1 for the mask, which the +inf encoding removes) against
// 67 TFLOP/s; plain FP32 instructions, so about half of it at best.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr float kNone = 1e10f;  // distance when no compatible y exists

constexpr int kWarps = 8;               // K3: warps splitting a y range
constexpr int kPer = 4;                 // K3: x points per lane
constexpr int kXBlock = 32 * kPer;      // K3: x points per block
constexpr int kYTile = 2 * 32 * kWarps;  // K3: y points staged at a time

constexpr int kSortThreads = 1024;          // plan: threads of an element
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kBuckets = 32;                // plan: widest counted labels
constexpr long long kSentinel = LLONG_MAX;  // plan: key of an invalid y

constexpr int kNnWarps = 8;            // K4: warps splitting a y range
constexpr int kNnPer = 4;              // K4: x points per lane
constexpr int kNnX = 32 * kNnPer;      // K4: x points per block
constexpr int kNnStage = 32 * kNnPer;  // K4: y points a warp stages at once

__device__ __forceinline__ float sq_norm(float v0, float v1, float v2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(v0, v0), __fmul_rn(v1, v1)),
                   __fmul_rn(v2, v2));
}

// K4: block (x tile, split, batch element); see the design note. With
// one split the block writes min_out / idx_out, else its split's slot of
// part_d / part_j (splits, B, N).
__global__ void __launch_bounds__(kNnWarps * 32)
nn_min_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const unsigned char* __restrict__ y_valid,
              float* __restrict__ part_d, int* __restrict__ part_j,
              float* __restrict__ min_out, long long* __restrict__ idx_out,
              int n, int m, int splits) {
  __shared__ float4 ys[kNnWarps][kNnStage];
  __shared__ float warp_d[kNnWarps][kNnX];
  __shared__ int warp_j[kNnWarps][kNnX];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.y;
  const long long b_idx = blockIdx.z;
  const int p0 = blockIdx.x * kNnX;
  const float* xb = x + b_idx * n * 3;
  const float* yb = y + b_idx * m * 3;
  const unsigned char* vb = y_valid + b_idx * m;

  float x0[kNnPer], x1[kNnPer], x2[kNnPer], xx[kNnPer], best[kNnPer];
  int best_j[kNnPer];
#pragma unroll
  for (int r = 0; r < kNnPer; ++r) {
    const int p = min(p0 + lane + 32 * r, n - 1);  // a ragged tail repeats
    x0[r] = xb[p * 3];
    x1[r] = xb[p * 3 + 1];
    x2[r] = xb[p * 3 + 2];
    xx[r] = sq_norm(x0[r], x1[r], x2[r]);
    best[r] = kNone;
    best_j[r] = 0;
  }
  // the block's y range, then the warp's eighth of it
  const long long y_lo = static_cast<long long>(m) * split / splits;
  const long long y_hi = static_cast<long long>(m) * (split + 1) / splits;
  const int w_lo = static_cast<int>(y_lo + (y_hi - y_lo) * warp / kNnWarps);
  const int w_hi =
      static_cast<int>(y_lo + (y_hi - y_lo) * (warp + 1) / kNnWarps);
  float4* stage = ys[warp];
  for (int s0 = w_lo; s0 < w_hi; s0 += kNnStage) {
    const int count = min(kNnStage, w_hi - s0);
    __syncwarp();  // the previous stage's reads are done
    for (int q = lane; q < count; q += 32) {
      const int j = s0 + q;
      const float v0 = yb[j * 3], v1 = yb[j * 3 + 1], v2 = yb[j * 3 + 2];
      stage[q] = make_float4(v0, v1, v2, vb[j] != 0
                                             ? sq_norm(v0, v1, v2)
                                             : __int_as_float(0x7f800000));
    }
    __syncwarp();
    for (int q = 0; q < count; ++q) {
      const float4 v = stage[q];
#pragma unroll
      for (int r = 0; r < kNnPer; ++r) {
        const float xy = __fadd_rn(
            __fadd_rn(__fmul_rn(x0[r], v.x), __fmul_rn(x1[r], v.y)),
            __fmul_rn(x2[r], v.z));
        const float d = fmaxf(
            __fsub_rn(__fadd_rn(xx[r], v.w), __fmul_rn(2.0f, xy)), 0.0f);
        if (d < best[r]) {
          best[r] = d;
          best_j[r] = s0 + q;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kNnPer; ++r) {
    warp_d[warp][lane + 32 * r] = best[r];
    warp_j[warp][lane + 32 * r] = best_j[r];
  }
  __syncthreads();
  const int p = p0 + tid;
  if (tid < kNnX && p < n) {
    float d = warp_d[0][tid];
    int j = warp_j[0][tid];
    for (int w = 1; w < kNnWarps; ++w) {  // ascending y: a tie keeps j
      if (warp_d[w][tid] < d) {
        d = warp_d[w][tid];
        j = warp_j[w][tid];
      }
    }
    const long long o = b_idx * n + p;
    if (splits == 1) {
      min_out[o] = d;
      idx_out[o] = j;
    } else {
      const long long slot = static_cast<long long>(split) * gridDim.z * n + o;
      part_d[slot] = d;
      part_j[slot] = j;
    }
  }
}

// K4's second pass: per x point the splits in ascending order, a strict <.
__global__ void __launch_bounds__(256)
nn_min_merge_kernel(const float* __restrict__ part_d,
                    const int* __restrict__ part_j,
                    float* __restrict__ min_out,
                    long long* __restrict__ idx_out, long long total,
                    int splits) {
  const long long o = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (o >= total) return;
  float d = part_d[o];
  int j = part_j[o];
  for (int s = 1; s < splits; ++s) {
    const float ds = part_d[s * total + o];
    if (ds < d) {
      d = ds;
      j = part_j[s * total + o];
    }
  }
  min_out[o] = d;
  idx_out[o] = j;
}

// One warp's slice [q0, q1) of a staged K3 tile against the lane's kPer x
// points; `base` is the tile's first sorted position. kMixed adds the
// label test (a tile whose keys or x labels are not all one value).
template <bool kMixed>
__device__ __forceinline__ void scan_slice(
    const float4* ys, const long long* ks, int q0, int q1, int base,
    const float (&x0)[kPer], const float (&x1)[kPer], const float (&x2)[kPer],
    const float (&xx)[kPer], const long long (&key)[kPer],
    float (&best)[kPer], int (&best_q)[kPer]) {
  for (int q = q0; q < q1; ++q) {
    const float4 v = ys[q];
    long long k = 0;
    if constexpr (kMixed) k = ks[q];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const float xy = __fadd_rn(
          __fadd_rn(__fmul_rn(x0[r], v.x), __fmul_rn(x1[r], v.y)),
          __fmul_rn(x2[r], v.z));
      float d = fmaxf(
          __fsub_rn(__fadd_rn(xx[r], v.w), __fmul_rn(2.0f, xy)), 0.0f);
      if constexpr (kMixed) d = (k == key[r]) ? d : kNone;
      if (d < best[r]) {
        best[r] = d;
        best_q[r] = base + q;
      }
    }
  }
}

// K3 over the plan of ops/label_nn.py:label_nn_plan: key_x, perm_x, lo,
// hi (B, N) and key_y, perm_y (B, M), all int64, as described above
// (lo and hi ascending along the x order; inside [lo, hi) the points of
// one key ascend with j). Grid (ceil(N / 128), B), 256 threads.
__global__ void __launch_bounds__(kWarps * 32)
label_nn_sorted_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const long long* __restrict__ key_x,
                       const long long* __restrict__ perm_x,
                       const long long* __restrict__ key_y,
                       const long long* __restrict__ perm_y,
                       const long long* __restrict__ lo,
                       const long long* __restrict__ hi,
                       float* __restrict__ min_out,
                       long long* __restrict__ idx_out, int n, int m) {
  __shared__ float4 ys[kYTile];
  __shared__ long long ks[kYTile];
  __shared__ float part_d[kWarps][kXBlock];
  __shared__ int part_q[kWarps][kXBlock];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long xoff = static_cast<long long>(blockIdx.y) * n;
  const long long yoff = static_cast<long long>(blockIdx.y) * m;
  const int p0 = blockIdx.x * kXBlock;
  const int p_last = min(p0 + kXBlock, n) - 1;
  const int y_lo = static_cast<int>(lo[xoff + p0]);
  const int y_hi = static_cast<int>(hi[xoff + p_last]);
  const long long key0 = key_x[xoff + p0];

  float x0[kPer], x1[kPer], x2[kPer], xx[kPer], best[kPer];
  long long key[kPer];
  int best_q[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int p = min(p0 + lane + 32 * r, p_last);  // a ragged tail repeats
    const long long i = xoff + perm_x[xoff + p];
    x0[r] = x[i * 3];
    x1[r] = x[i * 3 + 1];
    x2[r] = x[i * 3 + 2];
    xx[r] = sq_norm(x0[r], x1[r], x2[r]);
    key[r] = key_x[xoff + p];
    best[r] = kNone;
    best_q[r] = -1;
  }
  bool x_one = true;  // this lane's x labels are all key0
#pragma unroll
  for (int r = 0; r < kPer; ++r) x_one = x_one && key[r] == key0;

  for (int t0 = y_lo; t0 < y_hi; t0 += kYTile) {
    const int count = min(kYTile, y_hi - t0);
    __syncthreads();  // the previous tile's reads are done
    bool one = x_one;
    for (int q = tid; q < count; q += kWarps * 32) {
      const long long s = yoff + t0 + q;
      const float* v = y + (yoff + perm_y[s]) * 3;
      const float v0 = v[0], v1 = v[1], v2 = v[2];
      ys[q] = make_float4(v0, v1, v2, sq_norm(v0, v1, v2));
      const long long k = key_y[s];
      ks[q] = k;
      one = one && k == key0;
    }
    const bool mixed = __syncthreads_and(one) == 0;
    const int slice = (count + kWarps - 1) / kWarps;
    const int q0 = min(warp * slice, count);
    const int q1 = min(q0 + slice, count);
    if (mixed) {
      scan_slice<true>(ys, ks, q0, q1, t0, x0, x1, x2, xx, key, best,
                       best_q);
    } else {
      scan_slice<false>(ys, ks, q0, q1, t0, x0, x1, x2, xx, key, best,
                        best_q);
    }
  }

#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    part_d[warp][lane + 32 * r] = best[r];
    part_q[warp][lane + 32 * r] = best_q[r];
  }
  __syncthreads();
  const int p = p0 + tid;
  if (tid < kXBlock && p <= p_last) {
    float d = part_d[0][tid];
    int q = part_q[0][tid];
    for (int w = 1; w < kWarps; ++w) {  // (distance, position) order
      const float dw = part_d[w][tid];
      const int qw = part_q[w][tid];
      if (dw < d || (dw == d && qw < q)) {
        d = dw;
        q = qw;
      }
    }
    const long long i = xoff + perm_x[xoff + p];
    min_out[i] = d;
    idx_out[i] = q >= 0 ? perm_y[yoff + q] : 0;
  }
}

// One cloud's stable counting sort inside the plan block: the key of
// point i is labels[i] where valid[i] (or valid is null), else kSentinel;
// bucket key - base, the sentinel last. Writes key_out, perm_out and,
// unless null, each bucket's first sorted position to bucket_first.
__device__ void counting_sort(const long long* __restrict__ labels,
                              const unsigned char* __restrict__ valid,
                              int count, long long base, long long* key_out,
                              long long* perm_out,
                              int (&first)[kSortWarps][kBuckets + 1],
                              int (&bucket_total)[kBuckets + 1],
                              int* bucket_first) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  auto key_of = [&](int i) {
    return (valid == nullptr || valid[i]) ? labels[i] : kSentinel;
  };
  auto bucket = [&](long long k) {
    return k == kSentinel ? kBuckets : static_cast<int>(k - base);
  };
  for (int b = lane; b <= kBuckets; b += 32) first[warp][b] = 0;
  __syncwarp();
  const int seg = ((count + kSortWarps - 1) / kSortWarps + 31) / 32 * 32;
  const int s0 = min(warp * seg, count);
  const int s1 = min(s0 + seg, count);
  for (int i = s0 + lane; i < s1; i += 32) {
    atomicAdd(&first[warp][bucket(key_of(i))], 1);
  }
  __syncthreads();
  if (tid <= kBuckets) {
    int total = 0;
    for (int w = 0; w < kSortWarps; ++w) total += first[w][tid];
    bucket_total[tid] = total;
  }
  __syncthreads();
  if (tid <= kBuckets) {  // counts -> first positions, buckets then warps
    int start = 0;
    for (int b = 0; b < tid; ++b) start += bucket_total[b];
    if (bucket_first != nullptr) bucket_first[tid] = start;
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = first[w][tid];
      first[w][tid] = start;
      start += c;
    }
  }
  __syncthreads();
  for (int c = s0; c < s1; c += 32) {
    const int i = c + lane;
    const long long k = i < s1 ? key_of(i) : 0;
    const int b = i < s1 ? bucket(k) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, b);
    if (b >= 0) {
      const int pos = first[warp][b] + __popc(same & ((1u << lane) - 1u));
      key_out[pos] = k;
      perm_out[pos] = i;
    }
    __syncwarp();
    if (b >= 0 && lane == 31 - __clz(same)) first[warp][b] += __popc(same);
    __syncwarp();
  }
}

// The plan of batch element blockIdx.x (see the design note): counting
// sorts where its labels span fewer than kBuckets values, each x's range
// its label's y bucket; else the index order with every range all of y.
__global__ void __launch_bounds__(kSortThreads)
label_nn_plan_kernel(const long long* __restrict__ lx,
                     const long long* __restrict__ ly,
                     const unsigned char* __restrict__ y_valid,
                     long long* key_x, long long* perm_x, long long* key_y,
                     long long* perm_y, long long* lo, long long* hi, int n,
                     int m) {
  __shared__ int first[kSortWarps][kBuckets + 1];  // last bucket: sentinel
  __shared__ int bucket_total[kBuckets + 1];
  __shared__ int y_first[kBuckets + 1];  // y's bucket starts
  __shared__ long long key_lo, key_hi;
  const int tid = threadIdx.x;
  const long long xoff = static_cast<long long>(blockIdx.x) * n;
  const long long yoff = static_cast<long long>(blockIdx.x) * m;
  lx += xoff;
  key_x += xoff;
  perm_x += xoff;
  lo += xoff;
  hi += xoff;
  ly += yoff;
  y_valid += yoff;
  key_y += yoff;
  perm_y += yoff;
  if (tid == 0) {
    key_lo = kSentinel;
    key_hi = LLONG_MIN;
  }
  __syncthreads();
  long long k_lo = kSentinel, k_hi = LLONG_MIN;  // the labels, no sentinels
  for (int i = tid; i < n; i += kSortThreads) {
    k_lo = min(k_lo, lx[i]);
    k_hi = max(k_hi, lx[i]);
  }
  for (int j = tid; j < m; j += kSortThreads) {
    if (y_valid[j]) {
      k_lo = min(k_lo, ly[j]);
      k_hi = max(k_hi, ly[j]);
    }
  }
  atomicMin(&key_lo, k_lo);
  atomicMax(&key_hi, k_hi);
  __syncthreads();
  // n >= 1, so key_hi >= key_lo; the unsigned difference is the span
  if (static_cast<unsigned long long>(key_hi)
          - static_cast<unsigned long long>(key_lo)
      >= kBuckets) {
    for (int i = tid; i < n; i += kSortThreads) {
      key_x[i] = lx[i];
      perm_x[i] = i;
      lo[i] = 0;
      hi[i] = m;
    }
    for (int j = tid; j < m; j += kSortThreads) {
      key_y[j] = y_valid[j] ? ly[j] : kSentinel;
      perm_y[j] = j;
    }
    return;
  }
  counting_sort(ly, y_valid, m, key_lo, key_y, perm_y, first, bucket_total,
                y_first);
  __syncthreads();
  counting_sort(lx, nullptr, n, key_lo, key_x, perm_x, first, bucket_total,
                nullptr);
  __syncthreads();  // this block's sorted x keys are visible to it
  for (int i = tid; i < n; i += kSortThreads) {
    const int b = static_cast<int>(key_x[i] - key_lo);  // never the sentinel
    lo[i] = y_first[b];
    hi[i] = y_first[b + 1];  // buckets are contiguous, the sentinel's last
  }
}

}  // namespace

// K3's plan: labels lx (B, N), ly (B, M) int64, y_valid (B, M) uint8 ->
// key_x, perm_x, lo, hi (B, N) and key_y, perm_y (B, M), all int64 (the
// fields of ops/label_nn.py:LabelNNPlan). One launch on `stream`; returns
// cudaGetLastError() after it.
extern "C" int vt_label_nn_plan(const long long* lx, const long long* ly,
                                const unsigned char* y_valid,
                                long long* key_x, long long* perm_x,
                                long long* key_y, long long* perm_y,
                                long long* lo, long long* hi, int batch,
                                int n, int m, void* stream) {
  if (batch < 1 || n < 1 || m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  label_nn_plan_kernel<<<batch, kSortThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lx, ly, y_valid, key_x, perm_x, key_y, perm_y, lo, hi, n, m);
  return static_cast<int>(cudaGetLastError());
}

// K3: x (B, N, 3) f32, y (B, M, 3) f32, the plan's key_x, perm_x (B, N),
// key_y, perm_y (B, M), lo, hi (B, N), all int64; min_out (B, N) f32,
// idx_out (B, N) int64. Returns cudaGetLastError() after the launch.
extern "C" int vt_label_nn(const float* x, const float* y,
                           const long long* key_x, const long long* perm_x,
                           const long long* key_y, const long long* perm_y,
                           const long long* lo, const long long* hi,
                           float* min_out, long long* idx_out, int batch,
                           int n, int m, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kXBlock - 1) / kXBlock, batch);
  label_nn_sorted_kernel<<<grid, kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, y, key_x, perm_x, key_y, perm_y, lo, hi, min_out, idx_out, n, m);
  return static_cast<int>(cudaGetLastError());
}

// K4: x (B, N, 3) f32, y (B, M, 3) f32, y_valid (B, M) uint8, part_d /
// part_j (splits, B, N) f32 / int32 scratch (unused, may be null, with one
// split), min_out (B, N) f32, idx_out (B, N) int64. One launch, a second
// with more than one split; returns cudaGetLastError() after them.
extern "C" int vt_nn_min(const float* x, const float* y,
                         const unsigned char* y_valid, float* part_d,
                         int* part_j, float* min_out, long long* idx_out,
                         int batch, int n, int m, int splits, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || batch > 65535 || splits < 1
      || splits > 65535 || (splits > 1 && (part_d == nullptr
                                           || part_j == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kNnX - 1) / kNnX, splits, batch);
  nn_min_kernel<<<grid, kNnWarps * 32, 0, s>>>(
      x, y, y_valid, part_d, part_j, min_out, idx_out, n, m, splits);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  const long long total = static_cast<long long>(batch) * n;
  nn_min_merge_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                        s>>>(part_d, part_j, min_out, idx_out, total, splits);
  return static_cast<int>(cudaGetLastError());
}
