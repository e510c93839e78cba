// CoRS discriminator loss L_disc (paper Eq. 7), forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel` / `disc_loss` of
// src/repro/kernels/disc_loss.py (forward only there; the backward is new:
// training differentiates L_disc through both the student logits and the
// teacher probabilities).
//
//   forward:  p = softmax(s) (B, C),  h_raw = p q^T (B, M),
//             h = clip(h_raw, 1e-7, 1 - 1e-7),
//             loss_i = sum_m v_m (-pos_im log h_im - (1 - pos_im) log(1 - h_im))
//   backward: G_im = g_i v_m kappa_im (-pos_im / h_im + (1 - pos_im) / (1 - h_im)),
//             kappa = 0 where the clip is active,
//             ds = p * (G q - sum_m G_im h_raw_im),   dq = G^T p
//
// What bounds it: the work is two (forward) or four (backward) B*C*M
// multiply-adds in float32 over inputs of B*C + M*C floats, so at the LM shape
// (B 2048, C 4096, M 256) it is bound by float32 operations; at the paper's
// shape (B 32, C 10, M 10) it is bound by launch latency.
//
// Design. The Pallas grid carries a (block_b, M) accumulator across a
// SEQUENTIAL class axis; Hopper blocks run in no order, so here one block owns
// ROWS student rows and loops over the class axis itself:
//   1. warp w computes row w's max and softmax denominator (two passes over
//      C, as softmax does, so a row of -inf logits cannot make a NaN);
//   2. per class tile of CT columns, the block writes the normalised p tile
//      to shared memory, and warp w accumulates h for teacher rows
//      m = w, w + ROWS, ...: each q element is read once for all ROWS rows,
//      which cuts q traffic by ROWS against one row per block;
//   3. warp w writes row w's h_raw (kept for the backward: B*M floats) and
//      reduces its BCE over m.
// M is a runtime argument; h for ROWS rows lives in dynamic shared memory
// (ROWS*M floats beside the ROWS*CT p tile), which bounds M at 6752.
// The backward is two kernels with no atomics, so results do not depend on
// scheduling: `disc_bwd_rows` (per row block: G into a (B, M) scratch, then
// ds with one thread per class column looping over m) and `disc_bwd_dq`
// (per (class tile, teacher-row tile): dq by a loop over all B rows,
// recomputing p from the saved row max and log-denominator).
// A later PR replaces the inner products with wgmma tiles; this one is the
// simple correct kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 8;                // student rows per block = warps per block
constexpr int THREADS = ROWS * 32;
constexpr int CT = 512;                // class tile of p held in shared memory
constexpr int DQ_MT = 32;              // teacher rows per dq block
constexpr int DQ_IB = 32;              // student rows staged per dq step
constexpr float EPS = 1e-7f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float clip_h(float h) {
  return fminf(fmaxf(h, EPS), 1.0f - EPS);
}

__global__ void __launch_bounds__(THREADS)
disc_fwd(const float* __restrict__ s, const float* __restrict__ q,
         const int* __restrict__ labels, const float* __restrict__ valid,
         float* __restrict__ loss, float* __restrict__ row_max,
         float* __restrict__ log_z, float* __restrict__ h_raw,
         int B, int C, int M) {
  extern __shared__ float smem[];
  float* p_t = smem;                   // [ROWS][CT]
  float* h_s = smem + ROWS * CT;       // [ROWS][M]
  __shared__ float mx_s[ROWS], z_s[ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS;
  const int r = row0 + warp;

  if (r < B) {
    const float* sr = s + (size_t)r * C;
    float m = -INFINITY;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, sr[c]);
    m = warp_max(m);
    float z = 0.f;
    for (int c = lane; c < C; c += 32) z += expf(sr[c] - m);
    z = warp_sum(z);
    if (lane == 0) { mx_s[warp] = m; z_s[warp] = z; }
  }
  for (int i = threadIdx.x; i < ROWS * M; i += THREADS) h_s[i] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < C; c0 += CT) {
    const int ct = min(CT, C - c0);
    for (int i = threadIdx.x; i < ROWS * CT; i += THREADS) {
      const int rr = i / CT, cc = i % CT, row = row0 + rr;
      float v = 0.f;
      if (row < B && cc < ct)
        v = expf(s[(size_t)row * C + c0 + cc] - mx_s[rr]) / z_s[rr];
      p_t[i] = v;
    }
    __syncthreads();
    for (int m = warp; m < M; m += ROWS) {
      const float* qm = q + (size_t)m * C + c0;
      float acc[ROWS];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) acc[rr] = 0.f;
      for (int cc = lane; cc < ct; cc += 32) {
        const float qv = qm[cc];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) acc[rr] += p_t[rr * CT + cc] * qv;
      }
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float a = warp_sum(acc[rr]);
        if (lane == 0) h_s[rr * M + m] += a;
      }
    }
    __syncthreads();
  }

  if (r < B) {
    const int y = labels[r];
    float tot = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float hr = h_s[warp * M + m];
      h_raw[(size_t)r * M + m] = hr;
      const float h = clip_h(hr);
      const float per = (m == y) ? -logf(h) : -log1pf(-h);
      tot += per * valid[m];
    }
    tot = warp_sum(tot);
    if (lane == 0) {
      loss[r] = tot;
      row_max[r] = mx_s[warp];
      log_z[r] = logf(z_s[warp]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
disc_bwd_rows(const float* __restrict__ g, const float* __restrict__ s,
              const float* __restrict__ q, const int* __restrict__ labels,
              const float* __restrict__ valid, const float* __restrict__ row_max,
              const float* __restrict__ log_z, const float* __restrict__ h_raw,
              float* __restrict__ G, float* __restrict__ ds, int B, int C, int M) {
  extern __shared__ float G_s[];       // [ROWS][M]
  __shared__ float gh_s[ROWS], sh_s[ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS;
  const int r = row0 + warp;

  if (r < B) {
    const int y = labels[r];
    const float gr = g[r];
    float gh = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float hr = h_raw[(size_t)r * M + m];
      float Gv = 0.f;
      if (hr > EPS && hr < 1.0f - EPS)
        Gv = gr * valid[m] * ((m == y) ? -1.0f / hr : 1.0f / (1.0f - hr));
      G_s[warp * M + m] = Gv;
      G[(size_t)r * M + m] = Gv;
      gh += Gv * hr;
    }
    gh = warp_sum(gh);
    if (lane == 0) { gh_s[warp] = gh; sh_s[warp] = row_max[r] + log_z[r]; }
  } else {
    for (int m = lane; m < M; m += 32) G_s[warp * M + m] = 0.f;
  }
  __syncthreads();

  for (int c = threadIdx.x; c < C; c += THREADS) {
    float t[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) t[rr] = 0.f;
    for (int m = 0; m < M; ++m) {
      const float qv = q[(size_t)m * C + c];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) t[rr] += G_s[rr * M + m] * qv;
    }
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int row = row0 + rr;
      if (row < B) {
        const float p = expf(s[(size_t)row * C + c] - sh_s[rr]);
        ds[(size_t)row * C + c] = p * (t[rr] - gh_s[rr]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
disc_bwd_dq(const float* __restrict__ s, const float* __restrict__ row_max,
            const float* __restrict__ log_z, const float* __restrict__ G,
            float* __restrict__ dq, int B, int C, int M) {
  __shared__ float Gt[DQ_IB][DQ_MT];
  __shared__ float sh_t[DQ_IB];
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int m0 = blockIdx.y * DQ_MT;
  float acc[DQ_MT];
#pragma unroll
  for (int k = 0; k < DQ_MT; ++k) acc[k] = 0.f;

  for (int i0 = 0; i0 < B; i0 += DQ_IB) {
    for (int idx = threadIdx.x; idx < DQ_IB * DQ_MT; idx += THREADS) {
      const int ii = idx / DQ_MT, mm = idx % DQ_MT;
      const int i = i0 + ii, m = m0 + mm;
      Gt[ii][mm] = (i < B && m < M) ? G[(size_t)i * M + m] : 0.f;
    }
    if (threadIdx.x < DQ_IB) {
      const int i = i0 + threadIdx.x;
      sh_t[threadIdx.x] = (i < B) ? row_max[i] + log_z[i] : 0.f;
    }
    __syncthreads();
    if (c < C) {
      const int ib = min(DQ_IB, B - i0);
      for (int ii = 0; ii < ib; ++ii) {
        const float p = expf(s[(size_t)(i0 + ii) * C + c] - sh_t[ii]);
#pragma unroll
        for (int k = 0; k < DQ_MT; ++k) acc[k] += Gt[ii][k] * p;
      }
    }
    __syncthreads();
  }
  if (c < C) {
#pragma unroll
    for (int k = 0; k < DQ_MT; ++k)
      if (m0 + k < M) dq[(size_t)(m0 + k) * C + c] = acc[k];
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

extern "C" int disc_loss_fwd(const float* s, const float* q, const int* labels,
                             const float* valid, float* loss, float* row_max,
                             float* log_z, float* h_raw, int B, int C, int M,
                             cudaStream_t stream) {
  const size_t smem = (size_t)(ROWS * CT + ROWS * M) * sizeof(float);
  int err = set_smem((const void*)disc_fwd, smem);
  if (err) return err;
  disc_fwd<<<(B + ROWS - 1) / ROWS, THREADS, smem, stream>>>(
      s, q, labels, valid, loss, row_max, log_z, h_raw, B, C, M);
  return (int)cudaGetLastError();
}

extern "C" int disc_loss_bwd(const float* g, const float* s, const float* q,
                             const int* labels, const float* valid,
                             const float* row_max, const float* log_z,
                             const float* h_raw, float* G, float* ds, float* dq,
                             int B, int C, int M, cudaStream_t stream) {
  const size_t smem = (size_t)(ROWS * M) * sizeof(float);
  int err = set_smem((const void*)disc_bwd_rows, smem);
  if (err) return err;
  disc_bwd_rows<<<(B + ROWS - 1) / ROWS, THREADS, smem, stream>>>(
      g, s, q, labels, valid, row_max, log_z, h_raw, G, ds, B, C, M);
  err = (int)cudaGetLastError();
  if (err) return err;
  dim3 grid((C + THREADS - 1) / THREADS, (M + DQ_MT - 1) / DQ_MT);
  disc_bwd_dq<<<grid, THREADS, 0, stream>>>(s, row_max, log_z, G, dq, B, C, M);
  return (int)cudaGetLastError();
}

// Largest M the shared-memory layout takes (227 KB a block on the H100).
extern "C" int disc_loss_max_m() { return (232448 / 4 - ROWS * CT) / ROWS; }
