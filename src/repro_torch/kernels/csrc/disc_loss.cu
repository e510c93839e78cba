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
// What bounds it: two (forward) or four (backward) B*C*M float32 operations
// over inputs of B*C + M*C floats, so at the LM shape (B 2048, C 4096, M 256)
// it is bound by the float32 rate of the CUDA cores; at the paper's shape
// (B 32, C 10, M 10) by the latency of one launch. The float32 contract keeps
// the tensor cores out: one TF32 pass rounds h to about 5e-4 relative.
//
// Forward, one launch (`disc_fwd`, or `disc_fwd_small` where M <= 64 and
// the class axis is not split: the main path). The TPU kernel's grid carries
// a running (max, denominator, h) across a sequential class axis
// (disc_loss.py:40-49); Hopper blocks run in no order, so a block walks the
// class axis itself, in tiles of FB_K = 32 brought in with cp.async one tile
// ahead (16 bytes a thread where rows are 16-byte aligned; only the rows and
// columns that exist). Each tile is softmaxed with a running max: two (small
// kernel: four) threads a row find the tile's row max by a shuffle, rescale
// the running denominator and write exp(s - max) transposed into shared
// memory (a row whose running max is still -inf uses 0 in its place, so a
// tile of -inf logits gives 0, not NaN); q's tile is transposed beside it.
//   - `disc_fwd`: block tile FB_M = 128 rows x FB_N = 128 teacher rows, 256
//     threads, each an 8 x 8 register tile of h fed by four 16-byte shared
//     loads per 64 FMAs (a warp's 16-byte load costs four shared-memory
//     cycles, so smaller tiles leave the FMA units waiting on shared
//     memory). Where the row and M tiles give fewer blocks than SMs (the LM
//     shape: 32), the class axis is split (`fwd_plan`: 4 there); each split
//     writes its unnormalised h, max and denominator to a workspace and the
//     last split of the tile to finish (an integer counter after
//     __threadfence()) rescales them to their common max and adds them in
//     split order.
//   - `disc_fwd_small`: a 64 x 64 tile, 256 threads, 4 x 4 register tiles: at
//     the paper's shape every phase is a latency, and more threads on the
//     tile shorten each.
// The epilogue divides by the denominator, writes h_raw, and takes the BCE
// spread over all threads (its logs dominate a small block), then sums each
// row over the block's teacher rows by shuffles. With more than one M tile
// each block writes its row sums to a workspace and the last block of the
// row tile adds them in M-tile order. Any M is taken. row_max and log_z are
// written by M tile 0.
//
// Backward, one launch (`disc_bwd`, no atomics on floats). Block per (class
// tile of BB_C = 64 columns, row split); it walks M in tiles of BB_M = 256
// (one at the LM shape) and, within each, its rows in tiles of BB_R = 32,
// staged with cp.async two tiles deep together with the rows' g, row_max,
// log_z and labels:
//   - q[m tile, class tile] stays in shared memory for the M tile;
//   - h_raw's row tile is turned into G in place (one hardware reciprocal and
//     a Newton step an element), with gh = sum_m G h_raw per row by warp
//     shuffles, and s's tile into p = exp(s - row_max - log_z), one expf per
//     (i, c); G is never stored in device memory;
//   - G q: warp w takes an eighth of the teacher rows, a lane an 8 x 8
//     register tile; ds = p (G q - gh) adds the eighths in order; with
//     several M tiles ds accumulates p (G q - gh) of each, in order;
//   - dq[m tile, class tile] += G^T p in 8 x 8 register tiles over the row
//     loop; with at most 64 teacher rows in the tile (the main path's M = 10)
//     the row loop is split over four thread groups whose sums are added in
//     group order.
//   Where the class tiles give fewer blocks than SMs (the LM shape: 64), the
//   rows are split (`bwd_plan`: 2 there); each split writes its dq to a
//   workspace and the last split of the class tile adds them in split order.
// Both kernels are deterministic: every sum is taken in a fixed order.
//
// Client axis. Every input and output may carry a leading axis of N clients
// (the vectorized engine's whole fleet in one launch, as `jax.vmap` adds a
// leading grid axis to a `pallas_call`). The client is folded into the
// grid's z axis (`disc_fwd_small`: z = client; `disc_fwd`: z = client *
// splits + split; `disc_bwd`: z = client) and each block first moves every
// pointer to its client's slice (`at_client`), workspace and counters
// included. The plan is that of one client, so each client's blocks do the
// work of a launch for that client alone, in the same order: the result is
// bit-equal to N separate launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float EPS = 1e-7f;

// forward tiles
constexpr int FB_M = 128, FB_N = 128, FB_K = 32, F_THREADS = 256, F_STAGES = 2;
constexpr int F_RAW = FB_K + 4;              // raw tile pitch: 16-byte rows, 4 banks apart
constexpr int F_SMS = 132, F_MAX_SPLITS = 8;
// the small forward's tile (disc_fwd_small)
constexpr int SB_M = 64, SB_N = 64, S_THREADS = 256, S_T = SB_M + 8;
// backward tiles
constexpr int BB_R = 32, BB_C = 64, BB_M = 256, B_THREADS = 256;
constexpr int B_PITCH = BB_M + 4;            // G row pitch

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Called by every thread of a block after it wrote its partials: true in
// the last of `n` blocks to arrive at `counter` (an int after a fence), which
// then reads the others' partials and resets the counter.
__device__ __forceinline__ bool arrive_last(int* counter, int n, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == n - 1;
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

__device__ __forceinline__ float clip_h(float h) { return fminf(fmaxf(h, EPS), 1.0f - EPS); }

// 1/x for normal x: the hardware's approximation and one Newton step, within
// an ulp of the rounded quotient and without the branches of the IEEE
// reciprocal (the backward's G takes one per (i, m) in every class tile).
__device__ __forceinline__ float rcp_nr(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 8 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Copy rows [r0, r0 + rows) x columns [c0, c0 + cols) of a row-major (R, ld)
// array into dst (pitch `pitch` floats), zero-filling what lies outside
// (R, ncols). V = 4: 16-byte copies (ld, c0 and the base 16-byte aligned);
// V = 1: 4-byte copies.
template <int V, int THREADS>
__device__ __forceinline__ void tile_async(float* dst, int pitch, const float* src, int ld,
                                           int R, int ncols, int r0, int rows, int c0,
                                           int cols) {
  const int vpr = cols / V;
  for (int op = threadIdx.x; op < rows * vpr; op += THREADS) {
    const int r = op / vpr, c = (op - r * vpr) * V;
    const bool in = r0 + r < R && c0 + c < ncols;
    const float* g = in ? src + (size_t)(r0 + r) * ld + c0 + c : src;
    if constexpr (V == 4) cp_async16(dst + r * pitch + c, g, in);
    else cp_async4(dst + r * pitch + c, g, in);
  }
}

__device__ __forceinline__ int read_label(const void* labels, int lab64, int i) {
  const long long l = lab64 ? static_cast<const long long*>(labels)[i]
                            : (long long)static_cast<const int*>(labels)[i];
  return (l >= 0 && l < 0x7fffffff) ? (int)l : -1;   // out of [0, M) matches no m
}

// ---------------------------------------------------------------- forward
struct FwdArgs {
  const float* s;
  const float* q;
  const void* labels;
  int lab64;
  const unsigned char* valid;  // (M,) bool, or null: all valid
  float* loss;
  float* row_max;
  float* log_z;
  float* h_raw;
  float* ws;                   // part (n_mb, B) | acc, (m, z) of each split
  int* counters;               // n_rb * n_mb split counters | n_rb M-tile counters
  int B, C, M;
  int n_mb, n_rb, splits, tps; // M tiles, row tiles, class-axis splits, tiles a split
  int part_floats;             // the M tiles' row sums, ahead of the splits' partials
  long long ws_client;         // workspace floats a client
  int cnt_client;              // counters a client
};

// The slice of client n: every pointer moved past the clients before it.
__device__ __forceinline__ FwdArgs at_client(FwdArgs a, int n) {
  const long long B = a.B, C = a.C, M = a.M;
  a.s += n * B * C;
  a.q += n * M * C;
  a.labels = static_cast<const char*>(a.labels) + n * B * (a.lab64 ? 8 : 4);
  if (a.valid) a.valid += n * M;
  a.loss += n * B;
  a.row_max += n * B;
  a.log_z += n * B;
  a.h_raw += n * B * M;
  if (a.ws) a.ws += n * a.ws_client;
  if (a.counters) a.counters += (long long)n * a.cnt_client;
  return a;
}

struct FwdPlan {
  int n_mb, n_rb, splits, tps;
  int ws_floats, part_floats;
  int counters;
};

// Splits of the class axis bring the grid to about one block an SM where
// the row and M tiles alone give fewer (the LM shape: 32 tiles, 4 splits).
FwdPlan fwd_plan(int B, int C, int M) {
  FwdPlan p;
  p.n_mb = M > FB_N ? (M + FB_N - 1) / FB_N : 1;
  p.n_rb = (B + FB_M - 1) / FB_M;
  const int nt = (C + FB_K - 1) / FB_K, tiles = p.n_mb * p.n_rb;
  int S = (F_SMS + tiles / 2) / tiles;
  S = max(1, min(S, min(nt, F_MAX_SPLITS)));
  p.tps = nt > 0 ? (nt + S - 1) / S : 0;
  p.splits = p.tps > 0 ? (nt + p.tps - 1) / p.tps : 1;
  const int per_split = tiles * FB_M * (FB_N + 2);
  p.part_floats = p.n_mb > 1 ? (p.n_mb * B + 3) / 4 * 4 : 0;   // 16-byte aligned after
  p.ws_floats = p.part_floats + (p.splits > 1 ? p.splits * per_split : 0);
  p.counters = (p.splits > 1 ? tiles : 0) + (p.n_mb > 1 ? p.n_rb : 0);
  return p;
}

struct FwdSmem {
  float raw_s[F_STAGES][FB_M][F_RAW];     // s's tile as copied
  float raw_q[F_STAGES][FB_N][F_RAW];     // q's tile as copied
  float As[FB_K][FB_M + 4];               // exp(s - running max), transposed
  float Bs[FB_K][FB_N + 4];               // q, transposed
  float alpha[FB_M];
  float mrow[FB_M];                       // the rows' (combined) max
  float z[FB_M];                          // and denominator
  int y[FB_M];                            // the rows' labels
  float vf[FB_N];                         // the teacher rows' valid flags
  int last;
};
static_assert(FB_M * (FB_N + 1) <= F_STAGES * (FB_M + FB_N) * F_RAW,
              "h's tile must fit over the raw stages");

template <int V>
__global__ void __launch_bounds__(F_THREADS, 1)
disc_fwd(FwdArgs a0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const FwdArgs a = at_client(a0, blockIdx.z / a0.splits);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mb = blockIdx.x, rb = blockIdx.y, ks = blockIdx.z % a0.splits;
  const int n0 = mb * FB_N, r0 = rb * FB_M;
  // h: rows ty*4 + i (i < 4) and 64 + ty*4 + i; teacher rows tx*4 + j and
  // 64 + tx*4 + j, so that a quarter-warp's 16-byte loads hit 32 banks
  const int ty = tid >> 4, tx = tid & 15;
  const bool active = r0 + ty * 4 < a.B && n0 + tx * 4 < a.M;
  const int cr = tid >> 1, ch = tid & 1;            // softmax: row cr, columns ch*16..
  const bool row_in = r0 + cr < a.B;
  const int nt = (a.C + FB_K - 1) / FB_K;
  const int t_begin = ks * a.tps, t_end = min(nt, t_begin + a.tps);

  // the tile's labels and valid flags, in shared memory by the first barrier
  if (tid < FB_M) sm.y[tid] = r0 + tid < a.B ? read_label(a.labels, a.lab64, r0 + tid) : -1;
  if (tid < FB_N) {
    const int n = n0 + tid;
    sm.vf[tid] = n < a.M ? (a.valid ? (a.valid[n] ? 1.f : 0.f) : 1.f) : 0.f;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float m_run = -INFINITY, z_part = 0.f;            // row cr, this thread's columns

  auto fetch = [&](int t) {
    if (t < t_end) {         // only what exists: the softmax step masks the rest
      const int st = (t - t_begin) % F_STAGES, kt = min(FB_K, a.C - t * FB_K);
      tile_async<V, F_THREADS>(&sm.raw_s[st][0][0], F_RAW, a.s, a.C, a.B, a.C, r0,
                               min(FB_M, a.B - r0), t * FB_K, kt);
      tile_async<V, F_THREADS>(&sm.raw_q[st][0][0], F_RAW, a.q, a.C, a.M, a.C, n0,
                               min(FB_N, a.M - n0), t * FB_K, kt);
    }
    cp_commit();             // empty past the end: the wait count stays uniform
  };

#pragma unroll
  for (int t = 0; t < F_STAGES - 1; ++t) fetch(t_begin + t);
  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) % F_STAGES, kt = min(FB_K, a.C - t * FB_K);
    fetch(t + F_STAGES - 1);
    cp_wait<F_STAGES - 1>();
    __syncthreads();
    // softmax the tile with a running max (two threads a row, one shuffle);
    // transpose p and q into As, Bs
    {
      float x[16];
      float tmax = -INFINITY;
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
        const float4 v = *reinterpret_cast<const float4*>(&sm.raw_s[st][cr][ch * 16 + i4 * 4]);
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = ch * 16 + i4 * 4 + u;
          x[i4 * 4 + u] = (c < kt && row_in) ? vv[u] : -INFINITY;
          tmax = fmaxf(tmax, x[i4 * 4 + u]);
        }
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_new = fmaxf(m_run, tmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float al = expf(m_run - m_use);
      float zs = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float e = expf(x[i] - m_use);
        zs += e;
        sm.As[ch * 16 + i][cr] = e;
      }
      z_part = z_part * al + zs;
      m_run = m_new;
      if (ch == 0) sm.alpha[cr] = al;
      const bool n_in = n0 + cr < a.M;                 // q: row cr, columns ch*16..
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int c = ch * 16 + c4 * 4;
        const float4 v = *reinterpret_cast<const float4*>(&sm.raw_q[st][cr][c]);
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) sm.Bs[c + u][cr] = (c + u < kt && n_in) ? vv[u] : 0.f;
      }
    }
    __syncthreads();
    if (!active) continue;   // a thread wholly past B or M (small shapes)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float al = sm.alpha[(i < 4 ? 0 : 64) + ty * 4 + (i & 3)];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= al;
    }
    auto step = [&](int k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.Bs[k][64 + tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    };
    if (kt == FB_K) {
#pragma unroll
      for (int k = 0; k < FB_K; ++k) step(k);
    } else {
#pragma unroll 2
      for (int k = 0; k < kt; ++k) step(k);
    }
  }
  cp_wait<0>();              // only empty copy groups remain: the stages are free

  // the rows' max and denominator over this split's classes
  const float z = z_part + __shfl_xor_sync(0xffffffffu, z_part, 1);
  // h in shared memory over the raw stages (raw_s, raw_q: adjacent)
  float(*hs)[FB_N + 1] = reinterpret_cast<float(*)[FB_N + 1]>(&sm.raw_s[0][0][0]);
  auto row_of = [&](int i) { return (i < 4 ? 0 : 64) + ty * 4 + (i & 3); };
  auto col_of = [&](int j) { return (j < 4 ? 0 : 64) + tx * 4 + (j & 3); };
  auto in_tile = [&](int i, int j) { return r0 + row_of(i) < a.B && n0 + col_of(j) < a.M; };

  if (a.splits == 1) {
    if (ch == 0) { sm.mrow[cr] = m_run; sm.z[cr] = z; }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float zr = sm.z[row_of(i)];
#pragma unroll
      for (int j = 0; j < 8; ++j)       // no 0/0 past B or M: the IEEE slow path
        hs[row_of(i)][col_of(j)] = in_tile(i, j) ? acc[i][j] / zr : 0.f;
    }
  } else {
    // this split's partial to the workspace; the last split of the tile to
    // finish rescales the splits to their common max and adds them in order
    const int tile = rb * a.n_mb + mb;
    const long long per = (long long)FB_M * (FB_N + 2);
    float* part_ws = a.ws + a.part_floats;
    float* mine = part_ws + ((long long)ks * a.n_rb * a.n_mb + tile) * per;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2)
        *reinterpret_cast<float4*>(&mine[row_of(i) * FB_N + col_of(j2 * 4)]) =
            make_float4(acc[i][j2 * 4], acc[i][j2 * 4 + 1], acc[i][j2 * 4 + 2], acc[i][j2 * 4 + 3]);
    if (ch == 0) {
      mine[FB_M * FB_N + 2 * cr] = m_run;
      mine[FB_M * FB_N + 2 * cr + 1] = z;
    }
    if (!arrive_last(&a.counters[tile], a.splits, &sm.last)) return;
    if (tid == 0) a.counters[tile] = 0;
    if (tid < FB_M) {        // the rows' common max and denominator
      float mx = -INFINITY;
      for (int k = 0; k < a.splits; ++k)
        mx = fmaxf(mx, __ldcg(part_ws + ((long long)k * a.n_rb * a.n_mb + tile) * per +
                              FB_M * FB_N + 2 * tid));
      const float mu = mx == -INFINITY ? 0.f : mx;
      float zt = 0.f;
      for (int k = 0; k < a.splits; ++k) {
        const float* p = part_ws + ((long long)k * a.n_rb * a.n_mb + tile) * per + FB_M * FB_N;
        zt += __ldcg(p + 2 * tid + 1) * expf(__ldcg(p + 2 * tid) - mu);
      }
      sm.mrow[tid] = mx;
      sm.z[tid] = zt;
      sm.alpha[tid] = mu;
    }
    __syncthreads();
    float h[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) h[i][j] = 0.f;
    for (int k = 0; k < a.splits; ++k) {
      const float* p = part_ws + ((long long)k * a.n_rb * a.n_mb + tile) * per;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float sc = expf(__ldcg(p + FB_M * FB_N + 2 * row_of(i)) - sm.alpha[row_of(i)]);
#pragma unroll
        for (int j2 = 0; j2 < 2; ++j2) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(&p[row_of(i) * FB_N + col_of(j2 * 4)]));
          h[i][j2 * 4] += v.x * sc;
          h[i][j2 * 4 + 1] += v.y * sc;
          h[i][j2 * 4 + 2] += v.z * sc;
          h[i][j2 * 4 + 3] += v.w * sc;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float zr = sm.z[row_of(i)];
#pragma unroll
      for (int j = 0; j < 8; ++j) hs[row_of(i)][col_of(j)] = in_tile(i, j) ? h[i][j] / zr : 0.f;
    }
  }
  // M tile 0 writes the rows' max and log-denominator
  if (mb == 0 && tid < FB_M && r0 + tid < a.B) {
    a.row_max[r0 + tid] = sm.mrow[tid];
    a.log_z[r0 + tid] = logf(sm.z[tid]);
  }
  __syncthreads();

  // h_raw and the BCE spread over all threads (the logs are the epilogue's
  // cost: a few elements each)
  const int rows = min(FB_M, a.B - r0), cols = min(FB_N, a.M - n0);
  for (int e = tid; e < rows * cols; e += F_THREADS) {
    const int r = e / cols, c = e - r * cols;
    const float hr = hs[r][c];
    a.h_raw[(size_t)(r0 + r) * a.M + n0 + c] = hr;
    const float hc = clip_h(hr);
    float per = 0.f;
    if (sm.vf[c] != 0.f) per = (n0 + c == sm.y[r]) ? -logf(hc) : -log1pf(-hc);
    hs[r][c] = per;
  }
  __syncthreads();
  // the rows' sums over this block's teacher rows: warp w takes rows w + 4 j
  constexpr int RPW = FB_M / (F_THREADS / 32);
  float rs[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = warp + (F_THREADS / 32) * j;
    float t = 0.f;
    if (r < rows) {
#pragma unroll
      for (int u = 0; u < FB_N / 32; ++u) t += lane + 32 * u < cols ? hs[r][lane + 32 * u] : 0.f;
      t = warp_sum(t);
    }
    rs[j] = t;
  }

  if (a.n_mb == 1) {
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int r = warp + (F_THREADS / 32) * j;
        if (r < rows) a.loss[r0 + r] = rs[j];
      }
    return;
  }
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = warp + (F_THREADS / 32) * j;
      if (r < rows) a.ws[(size_t)mb * a.B + r0 + r] = rs[j];
    }
  int* mt_counter = a.counters + (a.splits > 1 ? a.n_rb * a.n_mb : 0) + rb;
  if (!arrive_last(mt_counter, a.n_mb, &sm.last)) return;
  if (tid < FB_M && r0 + tid < a.B) {          // the M tiles' sums, in order
    float tot = 0.f;
    for (int m8 = 0; m8 < a.n_mb; m8 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = m8 + u < a.n_mb ? __ldcg(a.ws + (size_t)(m8 + u) * a.B + r0 + tid) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (m8 + u < a.n_mb) tot += v[u];
    }
    a.loss[r0 + tid] = tot;
  }
  if (tid == 0) *mt_counter = 0;
}

// The forward for small problems (M <= SB_N, no split of the class axis,
// the main path's (32, 10, 10)): one 64 x 64 tile a block of 256 threads, 4 x 4
// register tiles, four threads a row in the softmax step. At such shapes
// every phase is a latency, and more threads on the tile shorten each.
struct FwdSmallSmem {
  float raw_s[F_STAGES][SB_M][F_RAW];     // s's tile as copied
  float raw_q[F_STAGES][SB_N][F_RAW];     // q's tile as copied
  float As[FB_K][S_T];                    // exp(s - running max), transposed
  float Bs[FB_K][S_T];                    // q, transposed
  float alpha[SB_M];
  float z[SB_M];
  int y[SB_M];                            // the rows' labels
  float vf[SB_N];                         // the teacher rows' valid flags
};

template <int V>
__global__ void __launch_bounds__(S_THREADS)
disc_fwd_small(FwdArgs a0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmallSmem& sm = *reinterpret_cast<FwdSmallSmem*>(smem_raw);
  const FwdArgs a = at_client(a0, blockIdx.z);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * SB_N, r0 = blockIdx.y * SB_M;
  const int ty = tid >> 4, tx = tid & 15;           // h: rows ty*4.., teacher rows tx*4..
  const int cr = tid >> 2, cq = tid & 3;            // softmax: row cr, columns cq + 4 i
  const bool active = r0 + ty * 4 < a.B && n0 + tx * 4 < a.M;

  // the tile's labels and valid flags, in shared memory by the first barrier
  if (tid < SB_M) {
    sm.y[tid] = r0 + tid < a.B ? read_label(a.labels, a.lab64, r0 + tid) : -1;
  } else if (tid < SB_M + SB_N) {
    const int n = n0 + tid - SB_M;
    sm.vf[tid - SB_M] = n < a.M ? (a.valid ? (a.valid[n] ? 1.f : 0.f) : 1.f) : 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float m_run = -INFINITY, z_part = 0.f;            // row cr, this thread's columns
  const bool row_in = r0 + cr < a.B;

  const int nt = (a.C + FB_K - 1) / FB_K;
  auto fetch = [&](int t) {
    if (t < nt) {            // only what exists: the softmax step masks the rest
      const int st = t % F_STAGES, kt = min(FB_K, a.C - t * FB_K);
      tile_async<V, S_THREADS>(&sm.raw_s[st][0][0], F_RAW, a.s, a.C, a.B, a.C, r0,
                               min(SB_M, a.B - r0), t * FB_K, kt);
      tile_async<V, S_THREADS>(&sm.raw_q[st][0][0], F_RAW, a.q, a.C, a.M, a.C, n0,
                               min(SB_N, a.M - n0), t * FB_K, kt);
    }
    cp_commit();                                    // empty past the end: counts stay uniform
  };

#pragma unroll
  for (int t = 0; t < F_STAGES - 1; ++t) fetch(t);
  for (int t = 0; t < nt; ++t) {
    const int st = t % F_STAGES, kt = min(FB_K, a.C - t * FB_K);
    fetch(t + F_STAGES - 1);
    cp_wait<F_STAGES - 1>();
    __syncthreads();
    // softmax the tile with a running max (4 threads a row, 2 shuffles);
    // transpose p and q into As, Bs
    {
      float x[8];
      float tmax = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = cq + 4 * i;
        x[i] = (c < kt && row_in) ? sm.raw_s[st][cr][c] : -INFINITY;
        tmax = fmaxf(tmax, x[i]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_run, tmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float al = expf(m_run - m_use);
      float zs = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float e = expf(x[i] - m_use);
        zs += e;
        sm.As[cq + 4 * i][cr] = e;
        sm.Bs[cq + 4 * i][cr] = (cq + 4 * i < kt && n0 + cr < a.M) ? sm.raw_q[st][cr][cq + 4 * i]
                                                                    : 0.f;
      }
      z_part = z_part * al + zs;
      m_run = m_new;
      if (cq == 0) sm.alpha[cr] = al;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float al = sm.alpha[ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= al;
      }
      auto step = [&](const float4& av, const float4& bv) {
        const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      };
      auto ld_a = [&](int k) { return *reinterpret_cast<const float4*>(&sm.As[k][ty * 4]); };
      auto ld_b = [&](int k) { return *reinterpret_cast<const float4*>(&sm.Bs[k][tx * 4]); };
      if (kt == FB_K) {
        float4 av = ld_a(0), bv = ld_b(0);          // next step's operands in flight
#pragma unroll
        for (int k = 0; k < FB_K - 1; ++k) {
          const float4 an = ld_a(k + 1), bn = ld_b(k + 1);
          step(av, bv);
          av = an;
          bv = bn;
        }
        step(av, bv);
      } else {
#pragma unroll 4
        for (int k = 0; k < kt; ++k) step(ld_a(k), ld_b(k));
      }
    }
  }

  // the rows' max and denominator; M tile 0 writes them
  float z = z_part + __shfl_xor_sync(0xffffffffu, z_part, 1);
  z += __shfl_xor_sync(0xffffffffu, z, 2);
  if (cq == 0) sm.z[cr] = z;
  if (blockIdx.x == 0 && cq == 0 && row_in) {
    a.row_max[r0 + cr] = m_run;
    a.log_z[r0 + cr] = logf(z);
  }
  cp_wait<0>();                // only empty copy groups remain: the stages are free
  __syncthreads();

  // h = acc / z into shared memory, then h_raw and the BCE spread over all
  // threads (the logs are the epilogue's cost: one element or a few each)
  float(*hs)[SB_N + 1] = reinterpret_cast<float(*)[SB_N + 1]>(&sm.raw_s[0][0][0]);
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float zr = sm.z[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j)       // no 0/0 past B or M: the IEEE slow path
        hs[ty * 4 + i][tx * 4 + j] =
            (r0 + ty * 4 + i < a.B && n0 + tx * 4 + j < a.M) ? acc[i][j] / zr : 0.f;
    }
  }
  __syncthreads();
  const int rows = min(SB_M, a.B - r0), cols = min(SB_N, a.M - n0);
  for (int e = tid; e < rows * cols; e += S_THREADS) {
    const int r = e / cols, c = e - r * cols;
    const float hr = hs[r][c];
    a.h_raw[(size_t)(r0 + r) * a.M + n0 + c] = hr;
    const float h = clip_h(hr);
    float per = 0.f;
    if (sm.vf[c] != 0.f) per = (n0 + c == sm.y[r]) ? -logf(h) : -log1pf(-h);
    hs[r][c] = per;
  }
  __syncthreads();
  // the rows' sums over this block's teacher rows: warp w takes rows w + 8 j
  float rs[SB_M / 8];
#pragma unroll
  for (int j = 0; j < SB_M / 8; ++j) {
    const int r = warp + 8 * j;
    float t = 0.f;
    if (r < rows) {
      t = (lane < cols ? hs[r][lane] : 0.f) + (lane + 32 < cols ? hs[r][lane + 32] : 0.f);
      t = warp_sum(t);
    }
    rs[j] = t;
  }

  if (lane == 0)
#pragma unroll
    for (int j = 0; j < SB_M / 8; ++j)
      if (warp + 8 * j < rows) a.loss[r0 + warp + 8 * j] = rs[j];
}

// --------------------------------------------------------------- backward
struct BwdArgs {
  const float* g;
  const float* s;
  const float* q;
  const void* labels;
  int lab64;
  const unsigned char* valid;
  const float* row_max;
  const float* log_z;
  const float* h_raw;
  float* ds;
  float* dq;
  float* ws;                   // the row splits' dq partials (splits, M, C)
  int* counters;               // one a class tile, zero between launches
  int B, C, M;
  int splits, rows_per_split;  // row splits of the grid, rows each
  long long ws_client;         // workspace floats a client
  int cnt_client;              // counters a client
};

__device__ __forceinline__ BwdArgs at_client(BwdArgs a, int n) {
  const long long B = a.B, C = a.C, M = a.M;
  a.g += n * B;
  a.s += n * B * C;
  a.q += n * M * C;
  a.labels = static_cast<const char*>(a.labels) + n * B * (a.lab64 ? 8 : 4);
  if (a.valid) a.valid += n * M;
  a.row_max += n * B;
  a.log_z += n * B;
  a.h_raw += n * B * M;
  a.ds += n * B * C;
  a.dq += n * M * C;
  if (a.ws) a.ws += n * a.ws_client;
  if (a.counters) a.counters += (long long)n * a.cnt_client;
  return a;
}

struct BwdPlan {
  int n_ct, splits, rows_per_split, ws_floats, counters;
};

// Row splits bring the grid to about one block an SM where the class tiles
// alone give fewer (the LM shape: 64 class tiles, 2 splits).
BwdPlan bwd_plan(int B, int C, int M) {
  BwdPlan p;
  p.n_ct = (C + BB_C - 1) / BB_C;
  const int nrt = (B + BB_R - 1) / BB_R;
  int S = max(1, (F_SMS + p.n_ct / 2) / max(1, p.n_ct));
  S = M > 0 ? min(S, max(1, nrt)) : 1;          // M 0: no dq to add up
  const int rt_per = (nrt + S - 1) / S;
  p.rows_per_split = rt_per * BB_R;
  p.splits = rt_per > 0 ? (nrt + rt_per - 1) / rt_per : 1;
  p.ws_floats = p.splits > 1 ? p.splits * M * C : 0;
  p.counters = p.splits > 1 ? p.n_ct : 0;
  return p;
}

struct BwdSmem {
  float G[2][BB_R][B_PITCH];      // h_raw's row tile, then G in place
  float P[2][BB_R][BB_C];         // s's row tile, then p in place
  float Q[BB_M][BB_C];            // q[m tile, class tile]
  float T[8][BB_R][BB_C];         // G q, an eighth of the teacher rows each
  float rg[2][BB_R], rm[2][BB_R], rz[2][BB_R];   // the rows' g, row_max, log_z
  long long ry[2][BB_R];          // the rows' labels (int32 in the low half)
  float gh[BB_R];
  float vs[BB_M];
  int last;
};

// VH: copy width of h_raw rows (stride M); VS: of s and q rows (stride C)
template <int VH, int VS>
__global__ void __launch_bounds__(B_THREADS)
disc_bwd(BwdArgs a0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const BwdArgs a = at_client(a0, blockIdx.z);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * BB_C;
  const int row_begin = blockIdx.y * a.rows_per_split;
  const int row_end = min(a.B, row_begin + a.rows_per_split);
  const int nrt = (row_end - row_begin + BB_R - 1) / BB_R;
  const int nmt = max(1, (a.M + BB_M - 1) / BB_M);   // M 0: ds = 0
  const int lsz = a.lab64 ? 8 : 4;
  const int ccnt = min(BB_C, a.C - c0);
  // a thread's 8 columns: c4 * 4 + j and 32 + c4 * 4 + j, so that a
  // quarter-warp's 16-byte loads hit 32 banks
  auto col_of = [](int c4, int j) { return (j < 4 ? 0 : 32) + c4 * 4 + (j & 3); };
  float* dq_out = a.splits > 1 ? a.ws + (size_t)blockIdx.y * a.M * a.C : a.dq;

  for (int mt = 0; mt < nmt; ++mt) {
    const int m0 = mt * BB_M, mcnt = min(BB_M, a.M - m0);
    const int mcnt4 = (mcnt + 3) & ~3;
    const int nw = min(8, (mcnt4 + max(4, (mcnt4 / 4 + 7) / 8 * 4) - 1) /
                              max(4, (mcnt4 / 4 + 7) / 8 * 4));   // warps with teacher rows
    // dq: m mg*8.., 8 columns of cg; with at most 64 teacher rows the row
    // loop is split over 4 groups of 64 threads (rows rgp, rgp + 4, ...),
    // whose sums are added in group order at the end of the M tile
    const bool split = mcnt <= 64;
    const int rgp = split ? tid >> 6 : 0, rstep = split ? 4 : 1;
    const int mg = split ? (tid & 63) >> 3 : tid >> 3, cg = tid & 7;
    for (int m = tid; m < BB_M; m += B_THREADS)
      sm.vs[m] = m < mcnt ? (a.valid ? (a.valid[m0 + m] ? 1.f : 0.f) : 1.f) : 0.f;
    // copy only what exists (Q's rows to mcnt4, zero past M); the G and p
    // steps write zeros over the rest of their tiles
    tile_async<VS, B_THREADS>(&sm.Q[0][0], BB_C, a.q, a.C, a.M, a.C, m0, mcnt4, c0, ccnt);
    auto fetch = [&](int rt) {
      const int st = rt & 1, r0 = row_begin + rt * BB_R, rows = min(BB_R, row_end - r0);
      tile_async<VH, B_THREADS>(&sm.G[st][0][0], B_PITCH, a.h_raw, a.M, a.B, a.M, r0, rows, m0,
                                mcnt);
      tile_async<VS, B_THREADS>(&sm.P[st][0][0], BB_C, a.s, a.C, a.B, a.C, r0, rows, c0, ccnt);
      if (tid < BB_R) {                         // the rows' scalars beside them
        const int r = r0 + tid;
        const bool in = r < row_end;
        cp_async4(&sm.rg[st][tid], in ? a.g + r : a.g, in);
        cp_async4(&sm.rm[st][tid], in ? a.row_max + r : a.row_max, in);
        cp_async4(&sm.rz[st][tid], in ? a.log_z + r : a.log_z, in);
        const char* lp = static_cast<const char*>(a.labels) + (size_t)(in ? r : 0) * lsz;
        if (a.lab64) cp_async8(&sm.ry[st][tid], lp, in);
        else cp_async4(&sm.ry[st][tid], lp, in);
      }
      cp_commit();
    };

    float dq[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dq[i][j] = 0.f;

    if (nrt > 0) fetch(0);
    for (int rt = 0; rt < nrt; ++rt) {
      const int st = rt & 1, r0 = row_begin + rt * BB_R, rcnt = min(BB_R, row_end - r0);
      if (rt + 1 < nrt) {
        fetch(rt + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      // G and gh from h_raw, p from s, in place; warp w takes rows w + 8 j,
      // all at once so that their reciprocals and shuffles overlap
      float gh[BB_R / 8];
#pragma unroll
      for (int j = 0; j < BB_R / 8; ++j) {
        const int rl = warp + 8 * j;
        gh[j] = 0.f;
        if (rl < rcnt) {
          const long long yl = a.lab64 ? sm.ry[st][rl]
                                       : (long long)*reinterpret_cast<const int*>(&sm.ry[st][rl]);
          const int ym = (yl >= m0 && yl < m0 + mcnt) ? (int)(yl - m0) : -1;
          const float gr = sm.rg[st][rl];
#pragma unroll
          for (int u = 0; u < BB_M / 32; ++u) {
            const int m = lane + 32 * u;
            if (32 * u >= mcnt) break;                 // uniform: past the M tile
            const float hr = m < mcnt ? sm.G[st][rl][m] : 0.f;
            const bool pos = m == ym;
            float Gv = 0.f;
            if (hr > EPS && hr < 1.0f - EPS && sm.vs[m] != 0.f) {
              const float rc = rcp_nr(pos ? hr : 1.0f - hr);
              Gv = pos ? -gr * rc : gr * rc;
            }
            gh[j] += Gv * hr;
            sm.G[st][rl][m] = Gv;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cl = lane + 32 * h;
            const float sv = sm.P[st][rl][cl];
            sm.P[st][rl][cl] =
                cl < ccnt ? expf((sv - sm.rm[st][rl]) - sm.rz[st][rl]) : 0.f;
          }
        } else {
#pragma unroll
          for (int u = 0; u < BB_M / 32; ++u) sm.G[st][rl][lane + 32 * u] = 0.f;
          sm.P[st][rl][lane] = 0.f;
          sm.P[st][rl][lane + 32] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < BB_R / 8; ++j) {
        const float t = warp_sum(gh[j]);
        if (lane == 0) sm.gh[warp + 8 * j] = t;
      }
      __syncthreads();

      // G q: warp w takes an eighth of the tile's teacher rows, a lane 8
      // rows x 8 columns of all 32 x 64; the eighths' sums are added in
      // order when ds is formed
      {
        const int tr = lane >> 3, tc = lane & 7;
        const int mq = max(4, (mcnt4 / 4 + 7) / 8 * 4);   // teacher rows a warp
        const int mb = warp * mq, me = min(mcnt4, mb + mq);
        float t[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) t[i][j] = 0.f;
        if (tr * 8 < rcnt) {
          for (int m = mb; m < me; m += 4) {
            float qv[4][8];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 q0 = *reinterpret_cast<const float4*>(&sm.Q[m + u][tc * 4]);
              const float4 q1 = *reinterpret_cast<const float4*>(&sm.Q[m + u][32 + tc * 4]);
              qv[u][0] = q0.x; qv[u][1] = q0.y; qv[u][2] = q0.z; qv[u][3] = q0.w;
              qv[u][4] = q1.x; qv[u][5] = q1.y; qv[u][6] = q1.z; qv[u][7] = q1.w;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float4 gv = *reinterpret_cast<const float4*>(&sm.G[st][tr * 8 + i][m]);
              const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
              for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int j = 0; j < 8; ++j) t[i][j] = fmaf(gr[u], qv[u][j], t[i][j]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float4*>(&sm.T[warp][tr * 8 + i][h * 32 + tc * 4]) =
                make_float4(t[i][h * 4], t[i][h * 4 + 1], t[i][h * 4 + 2], t[i][h * 4 + 3]);
      }

      // dq += G^T p for m mg*8.., columns col_of(cg, 0..7)
      if (mg * 8 < mcnt) {
#pragma unroll 2
        for (int rl = rgp; rl < rcnt; rl += rstep) {
          const float4 g0 = *reinterpret_cast<const float4*>(&sm.G[st][rl][mg * 8]);
          const float4 g1 = *reinterpret_cast<const float4*>(&sm.G[st][rl][mg * 8 + 4]);
          const float4 p0 = *reinterpret_cast<const float4*>(&sm.P[st][rl][cg * 4]);
          const float4 p1 = *reinterpret_cast<const float4*>(&sm.P[st][rl][32 + cg * 4]);
          const float gr[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
          const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) dq[i][j] = fmaf(gr[i], pr[j], dq[i][j]);
        }
      }
      __syncthreads();
      // ds = p (G q - gh), coalesced: element e = tid + 256 k of the tile
#pragma unroll
      for (int k = 0; k < BB_R * BB_C / B_THREADS; ++k) {
        const int e = tid + B_THREADS * k, rl = e / BB_C, cl = e % BB_C;
        const int r = r0 + rl, c = c0 + cl;
        if (rl < rcnt && cl < ccnt) {
          float tv = sm.T[0][rl][cl];
          for (int w = 1; w < nw; ++w) tv += sm.T[w][rl][cl];
          const float v = sm.P[st][rl][cl] * (tv - sm.gh[rl]);
          float* dst = a.ds + (size_t)r * a.C + c;
          if (mt == 0) *dst = v;       // a branch, not a select: no load of ds
          else *dst += v;
        }
      }
      __syncthreads();     // stage st and T are refilled next
    }

    if (split) {           // the 4 row groups' sums, added in group order
      float* part = &sm.T[0][0][0];              // [4][64][BB_C], the tiles are done
      if (mg * 8 < mcnt)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            part[(rgp * 64 + mg * 8 + i) * BB_C + col_of(cg, j)] = dq[i][j];
      __syncthreads();
      for (int e = tid; e < mcnt * BB_C; e += B_THREADS) {
        const int m = m0 + e / BB_C, c = c0 + e % BB_C;
        const float v = ((part[e] + part[64 * BB_C + e]) + part[2 * 64 * BB_C + e]) +
                        part[3 * 64 * BB_C + e];
        if (m < a.M && c < a.C) dq_out[(size_t)m * a.C + c] = v;
      }
      __syncthreads();     // part is the next M tile's T
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + mg * 8 + i;
        if (m >= a.M) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c0 + col_of(cg, j);
          if (c < a.C) dq_out[(size_t)m * a.C + c] = dq[i][j];
        }
      }
    }
  }

  if (a.splits == 1) return;
  // the row splits' dq partials of this class tile, added in split order by
  // the last split to finish
  if (!arrive_last(&a.counters[blockIdx.x], a.splits, &sm.last)) return;
  for (int e = tid; e < a.M * ccnt; e += B_THREADS) {
    const int m = e / ccnt, c = c0 + e % ccnt;
    float v = 0.f;
    for (int k = 0; k < a.splits; ++k) v += __ldcg(a.ws + ((size_t)k * a.M + m) * a.C + c);
    a.dq[(size_t)m * a.C + c] = v;
  }
  if (tid == 0) a.counters[blockIdx.x] = 0;
}

// Raises a kernel's dynamic shared memory limit once per device and process.
int smem_once(const void* fn, size_t bytes, bool (&done)[16]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return (int)err;
  if (dev < 16 && done[dev]) return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (!err && dev < 16) done[dev] = true;
  return (int)err;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

constexpr int MAX_GRID_Z = 65535;

template <int V>
int launch_fwd(const FwdArgs& a, int N, cudaStream_t stream) {
  if (a.M <= SB_N && a.splits == 1) {
    static bool done[16] = {};
    const int err = smem_once((const void*)disc_fwd_small<V>, sizeof(FwdSmallSmem), done);
    if (err) return err;
    disc_fwd_small<V><<<dim3(1, (a.B + SB_M - 1) / SB_M, N), S_THREADS, sizeof(FwdSmallSmem),
                        stream>>>(a);
    return (int)cudaGetLastError();
  }
  if ((long long)N * a.splits > MAX_GRID_Z) return (int)cudaErrorInvalidConfiguration;
  static bool done[16] = {};
  const int err = smem_once((const void*)disc_fwd<V>, sizeof(FwdSmem), done);
  if (err) return err;
  disc_fwd<V><<<dim3(a.n_mb, a.n_rb, N * a.splits), F_THREADS, sizeof(FwdSmem), stream>>>(a);
  return (int)cudaGetLastError();
}

template <int VH, int VS>
int launch_bwd(const BwdArgs& a, int n_ct, int N, cudaStream_t stream) {
  static bool done[16] = {};
  const int err = smem_once((const void*)disc_bwd<VH, VS>, sizeof(BwdSmem), done);
  if (err) return err;
  disc_bwd<VH, VS><<<dim3(n_ct, a.splits, N), B_THREADS, sizeof(BwdSmem), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The forward's workspace floats and zeroed int counters for one client of
// (B, C, M); 0 where it needs none (one M tile, no split of the class axis).
// A launch of N clients needs N times each.
extern "C" int disc_loss_fwd_workspace(int B, int C, int M) {
  return fwd_plan(B, C, M).ws_floats;
}
extern "C" int disc_loss_fwd_counters(int B, int C, int M) { return fwd_plan(B, C, M).counters; }

// N clients of (B, C, M), each a contiguous slice of every array; N = 1 is
// the call for one client.
extern "C" int disc_loss_fwd(const float* s, const float* q, const void* labels, int lab64,
                             const void* valid, float* loss, float* row_max, float* log_z,
                             float* h_raw, float* ws, int* counters, int N, int B, int C,
                             int M, cudaStream_t stream) {
  if (N < 1 || N > MAX_GRID_Z) return (int)cudaErrorInvalidConfiguration;
  const FwdPlan p = fwd_plan(B, C, M);
  FwdArgs a{s, q, labels, lab64, static_cast<const unsigned char*>(valid), loss, row_max,
            log_z, h_raw, ws, counters, B, C, M, p.n_mb, p.n_rb, p.splits, p.tps,
            p.part_floats, p.ws_floats, p.counters};
  if (C % 4 == 0 && aligned16(s) && aligned16(q)) return launch_fwd<4>(a, N, stream);
  return launch_fwd<1>(a, N, stream);
}

// The backward's workspace floats and zeroed int counters for one client
// (0 for none); N clients need N times each.
extern "C" int disc_loss_bwd_workspace(int B, int C, int M) { return bwd_plan(B, C, M).ws_floats; }
extern "C" int disc_loss_bwd_counters(int B, int C, int M) { return bwd_plan(B, C, M).counters; }

extern "C" int disc_loss_bwd(const float* g, const float* s, const float* q, const void* labels,
                             int lab64, const void* valid, const float* row_max,
                             const float* log_z, const float* h_raw, float* ds, float* dq,
                             float* ws, int* counters, int N, int B, int C, int M,
                             cudaStream_t stream) {
  if (N < 1 || N > MAX_GRID_Z) return (int)cudaErrorInvalidConfiguration;
  const BwdPlan p = bwd_plan(B, C, M);
  BwdArgs a{g, s, q, labels, lab64, static_cast<const unsigned char*>(valid), row_max, log_z,
            h_raw, ds, dq, ws, counters, B, C, M, p.splits, p.rows_per_split,
            p.ws_floats, p.counters};
  const bool vh = M % 4 == 0 && aligned16(h_raw);
  const bool vs = C % 4 == 0 && aligned16(s) && aligned16(q);
  if (vh && vs) return launch_bwd<4, 4>(a, p.n_ct, N, stream);
  if (vh) return launch_bwd<4, 1>(a, p.n_ct, N, stream);
  if (vs) return launch_bwd<1, 4>(a, p.n_ct, N, stream);
  return launch_bwd<1, 1>(a, p.n_ct, N, stream);
}
