// Per-class feature sums and counts (CoRS prototype statistics), for sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel` / `proto_accum` of
// src/repro/kernels/proto_accum.py, which builds a one-hot tile and runs
// one_hot^T @ features on the MXU because the TPU has no fast scatter. On the
// GPU the natural form is a scatter by label, which that module's docstring
// names.
//
//   sums[c, :] = sum_{i : labels_i == c} features[i, :]     (C, d) f32
//   counts[c]  = #{i : labels_i == c}                       (C,)   f32
//   labels outside [0, C) contribute nothing.
//
// What bounds it: one add per input element, so it is bound by reading the
// n*d features (f32 or bf16) once; at the main path's shape (n 240, d 84,
// C 10) by launch latency.
//
// Design: deterministic, no float atomics. The relay's global prototypes
// feed the next round, so two runs must agree bit for bit. One block owns a
// tile of PA_CT classes and a chunk of PA_THREADS feature columns (one column
// a thread, its PA_CT partial sums in shared memory). The block scans the
// labels PA_THREADS at a time, compacts the rows whose label falls in its
// class tile into a list in row order (warp ballot + prefix of warp counts),
// then adds those rows' columns in that order, with the loads of PA_UNROLL
// rows issued before their adds (one row at a time left the block waiting on
// each load in turn). Every sum is therefore taken in ascending row order
// whatever the scheduling, and each feature element is read by exactly one
// block. Counts are exact integers in f32.
// Known limit: with few classes (the main path's C = 10) the grid is one
// block per 128 feature columns, so one SM scans all n rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int PA_THREADS = 128;        // feature columns per block
constexpr int PA_CT = 16;              // classes per block
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_UNROLL = 8;           // matched rows whose loads overlap

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
proto_accum_kernel(const T* __restrict__ feats, const int* __restrict__ labels,
                   float* __restrict__ sums, float* __restrict__ counts,
                   int n, int d, int C) {
  __shared__ float acc[PA_CT][PA_THREADS];
  __shared__ float cnt[PA_CT];
  __shared__ int rows[PA_THREADS];
  __shared__ int cls[PA_THREADS];
  __shared__ int warp_cnt[PA_WARPS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * PA_CT;
  const int col = blockIdx.y * PA_THREADS + tid;
  const int c_hi = min(c0 + PA_CT, C);

#pragma unroll
  for (int k = 0; k < PA_CT; ++k) acc[k][tid] = 0.f;
  if (tid < PA_CT) cnt[tid] = 0.f;

  for (int base = 0; base < n; base += PA_THREADS) {
    const int i = base + tid;
    const int lab = (i < n) ? labels[i] : -1;
    const bool hit = lab >= c0 && lab < c_hi;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_cnt[warp] = __popc(mask);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) {
      if (w < warp) off += warp_cnt[w];
      total += warp_cnt[w];
    }
    if (hit) {
      const int pos = off + __popc(mask & ((1u << lane) - 1u));
      rows[pos] = i;
      cls[pos] = lab - c0;
    }
    __syncthreads();
    // PA_UNROLL rows' loads in flight, then their adds in row order
    for (int j0 = 0; j0 < total; j0 += PA_UNROLL) {
      const int nj = min(PA_UNROLL, total - j0);
      float v[PA_UNROLL];
#pragma unroll
      for (int u = 0; u < PA_UNROLL; ++u)
        v[u] = (u < nj && col < d) ? to_f32(feats[(size_t)rows[j0 + u] * d + col])
                                   : 0.f;
#pragma unroll
      for (int u = 0; u < PA_UNROLL; ++u) {
        if (u < nj) {
          const int k = cls[j0 + u];
          acc[k][tid] += v[u];
          if (tid == 0) cnt[k] += 1.f;
        }
      }
    }
    __syncthreads();
  }

  if (col < d) {
    for (int c = c0; c < c_hi; ++c) sums[(size_t)c * d + col] = acc[c - c0][tid];
  }
  if (blockIdx.y == 0 && tid < c_hi - c0) counts[c0 + tid] = cnt[tid];
}

template <typename T>
int launch(const T* feats, const int* labels, float* sums, float* counts,
           int n, int d, int C, cudaStream_t stream) {
  dim3 grid((C + PA_CT - 1) / PA_CT, (d + PA_THREADS - 1) / PA_THREADS);
  proto_accum_kernel<T><<<grid, PA_THREADS, 0, stream>>>(feats, labels, sums,
                                                         counts, n, d, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int proto_accum_f32(const float* feats, const int* labels, float* sums,
                               float* counts, int n, int d, int C,
                               cudaStream_t stream) {
  return launch(feats, labels, sums, counts, n, d, C, stream);
}

extern "C" int proto_accum_bf16(const void* feats, const int* labels, float* sums,
                                float* counts, int n, int d, int C,
                                cudaStream_t stream) {
  return launch(static_cast<const __nv_bfloat16*>(feats), labels, sums, counts,
                n, d, C, stream);
}
