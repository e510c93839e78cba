// Per-class feature sums and counts (CoRS prototype statistics), for sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel` / `proto_accum` of
// src/repro/kernels/proto_accum.py, which builds a one-hot tile and runs
// one_hot^T @ features on the MXU because the TPU has no fast scatter. On the
// GPU the natural form is a scatter by label, which that module's docstring
// names; the one-hot product would buy nothing here.
//
//   sums[c, :] = sum_{i : labels_i == c} features[i, :]     (C, d) f32
//   counts[c]  = #{i : labels_i == c}                       (C,)   f32
//   labels (int32 or int64) outside [0, C) contribute nothing.
//
// What bounds it: one add per element read, far below the card's ~295
// operations a byte, so it is bound by reading the n*d features once; at the
// main path's shape (n 240, d 84, C 10: 80 KB) by the latency of the loads
// and of the launch, not by bandwidth.
//
// Design: deterministic, no float atomics (the relay's global prototypes feed
// the next round, so two runs must agree bit for bit).
//  - Grid (K row chunks, class tiles, column chunks of PA_COLS). The row axis
//    is split into K chunks so that few classes (the main path's C = 10, one
//    class tile) still spread over many SMs; `proto_accum_plan` picks K from
//    n, d and C: about 32 rows a chunk, a workspace (K*C*d floats) no larger
//    than the features, a grid of about two blocks an SM.
//  - A block stages its rows in shared memory with cp.async (16 bytes a
//    thread where rows are 16-byte aligned), two groups deep, so every load
//    of a group is in flight before its adds and the next group's loads
//    overlap this group's adds. Each thread then adds its column of the
//    staged rows, in row order, into per-class accumulators in shared memory.
//  - Up to PA_CT_DENSE classes (dense: one class tile, groups of 32 rows) a
//    block stages every row of its chunk with its label. With more (sparse:
//    tiles of PA_CT classes, groups of 16 rows) a block first compacts the
//    rows of its chunk whose label falls in its tile into a row-ordered list
//    (warp ballots over PA_SEG labels a step, the next step's labels already
//    loading) and stages only those rows.
//  - Counts come from warp ballots (one per class of the tile and group) into
//    integer counts held by warp 0's lanes.
//  - Up to 16 chunks (K <= PA_CLUSTER) the K blocks of a tile are one thread
//    block cluster: after a cluster barrier each adds a slice of the tile's
//    K partials, in chunk order, from the others' shared memory, and no
//    partial leaves the SMs. Past 16, each block writes its partials to a
//    workspace and the last block of the tile to finish, found by an integer
//    counter after __threadfence(), adds them in chunk order and resets the
//    counter to 0. Every sum is thus taken in a fixed order whatever the
//    scheduling.
//  - Client axis: features (N, n, d) and labels (N, n) give sums (N, C, d)
//    and counts (N, C) in one launch (the vectorized engine's whole fleet,
//    as `jax.vmap` adds a leading grid axis to a `pallas_call`). The grid's
//    x axis holds N * K blocks, client-major, so each cluster of K blocks
//    is one client's chunks; a block moves every pointer to its client's
//    slice (workspace and counters included) and then does the work of a
//    launch for that client alone, in the same order: bit-equal to N
//    separate launches. Clients are never folded into the class axis, which
//    would change the kernel's plan.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PA_THREADS = 128;
constexpr int PA_COLS = 128;            // feature columns per block (one a thread)
constexpr int PA_CT = 32;               // classes per block
constexpr int PA_CT_DENSE = 16;         // up to this many classes: one tile
constexpr int PA_R = 16;                // rows per staged group
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_U = 8;                 // labels a thread scans per step
constexpr int PA_SEG = PA_U * PA_THREADS;
constexpr int PA_LIST = 2 * PA_SEG;     // row-list capacity
constexpr int PA_ROWS_PER_CHUNK = 32;   // target rows a block
constexpr int PA_SMS = 132;
constexpr int PA_CLUSTER = 16;          // largest cluster of the H100 (non-portable)
constexpr int PA_CLUSTER_ROWS = 4096;   // up to n this, K <= PA_CLUSTER

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes_const16,
                                         int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes_const16 == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes));
  else if (bytes_const16 == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ long long read_label(const void* labels, int lab64, int i) {
  return lab64 ? static_cast<const long long*>(labels)[i]
               : (long long)static_cast<const int*>(labels)[i];
}

struct PAArgs {
  const void* feats;
  const void* labels;
  int lab64;
  float* sums;
  float* counts;
  float* ws;          // K*C*d partial sums, then K*C partial counts (K > 1)
  int* counters;      // one a (class tile, column chunk), zero between launches
  int n, d, C, K, chunk;
  long long ws_client; // workspace floats a client
  int cnt_client;      // counters a client
};

// Dense (C <= PA_CT_DENSE, one class tile): groups of 32 rows, no row list.
// Sparse: PA_CT classes a tile, groups of 16 rows and the row list.
template <typename T, bool DENSE>
struct PASmem {
  static constexpr int CT = DENSE ? PA_CT_DENSE : PA_CT;
  static constexpr int R = DENSE ? 2 * PA_R : PA_R;
  static constexpr int LIST = DENSE ? 1 : PA_LIST;
  T stage[2][R][PA_COLS];
  float acc[CT][PA_COLS];
  long long lab[2][R];                 // dense: the staged rows' labels
  int list_row[LIST];                  // sparse: matched rows in row order
  signed char list_cls[LIST];
  int wcnt[PA_WARPS];
  int cnt[CT];
  int last;
};

// VB: bytes a cp.async moves (16 or 4), or 0 for plain element copies.
// CLUSTER: the K row chunks of a tile are one thread block cluster (K <= 16)
// and add their partials through distributed shared memory.
template <typename T, int VB, bool DENSE, bool CLUSTER>
__global__ void __launch_bounds__(PA_THREADS)
proto_accum_kernel(PAArgs a) {
  using Smem = PASmem<T, DENSE>;
  constexpr int NS = 2, CT = Smem::CT, R = Smem::R;
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int client = blockIdx.x / a.K, k = blockIdx.x - client * a.K;
  {                          // this client's slice of every array
    const long long cn = client;
    a.feats = static_cast<const T*>(a.feats) + cn * a.n * a.d;
    a.labels = static_cast<const char*>(a.labels) + cn * a.n * (a.lab64 ? 8 : 4);
    a.sums += cn * a.C * a.d;
    a.counts += cn * a.C;
    if (a.ws) a.ws += cn * a.ws_client;
    if (a.counters) a.counters += cn * a.cnt_client;
  }
  const int c0 = blockIdx.y * CT, c_hi = min(c0 + CT, a.C);
  const int col0 = blockIdx.z * PA_COLS, ncol = min(PA_COLS, a.d - col0);
  const int r_begin = min(a.n, k * a.chunk), r_end = min(a.n, r_begin + a.chunk);
  const bool do_counts = blockIdx.z == 0;
  const T* feats = static_cast<const T*>(a.feats);
  const int lsz = a.lab64 ? 8 : 4;

#pragma unroll
  for (int c = 0; c < CT; ++c) sm.acc[c][tid] = 0.f;
  int my_cnt = 0;                        // warp 0, lane c: rows of class c0 + c

  // Row and class of item j of the current row source (dense: the chunk's
  // rows in order; sparse: the compacted list).
  auto row_at = [&](int j) {
    if constexpr (DENSE) return r_begin + j;
    else return sm.list_row[j];
  };

  auto fetch = [&](int g, int total, int s) {
    const int j0 = g * R, cnt = max(0, min(R, total - j0));
    if constexpr (VB > 0) {
      constexpr int EPV = VB / (int)sizeof(T);
      const int vpr = ncol / EPV;      // whole vectors: ncol*sizeof(T) % VB == 0
      for (int op = tid; op < cnt * vpr; op += PA_THREADS) {
        const int j = op / vpr, v = op - j * vpr;
        const T* src = feats + (size_t)row_at(j0 + j) * a.d + col0 + v * EPV;
        cp_async(&sm.stage[s][j][v * EPV], src, VB, VB);
      }
    } else {
      for (int op = tid; op < cnt * ncol; op += PA_THREADS) {
        const int j = op / ncol, c = op - j * ncol;
        sm.stage[s][j][c] = feats[(size_t)row_at(j0 + j) * a.d + col0 + c];
      }
    }
    if (DENSE && tid < cnt) {   // the rows' labels beside them
      const char* src = static_cast<const char*>(a.labels) + (size_t)(r_begin + j0 + tid) * lsz;
      cp_async(&sm.lab[s][tid], src, lsz, lsz);
    }
    cp_commit();
  };

  auto cls_of = [&](int s, int jj, int j) -> int {
    if constexpr (DENSE) {
      const long long l = a.lab64 ? sm.lab[s][jj]
                                  : (long long)*reinterpret_cast<const int*>(&sm.lab[s][jj]);
      return (l >= c0 && l < c_hi) ? (int)(l - c0) : -1;
    }
    return sm.list_cls[j];
  };

  // Stage rows [0, total) of the source R at a time, NS - 1 groups ahead,
  // and add each group in row order. Every step commits one copy group
  // (empty past the end), so the wait count stays NS - 1.
  auto run_groups = [&](int total) {
    const int ng = (total + R - 1) / R;
#pragma unroll
    for (int g = 0; g < NS - 1; ++g) fetch(g, total, g);
    for (int g = 0; g < ng; ++g) {
      const int s = g % NS;
      fetch(g + NS - 1, total, (g + NS - 1) % NS);
      cp_wait<NS - 1>();
      __syncthreads();
      const int j0 = g * R, cnt = min(R, total - j0);
      if (do_counts && warp == 0) {
        const int c = lane < cnt ? cls_of(s, lane, j0 + lane) : -1;
#pragma unroll
        for (int kk = 0; kk < CT; ++kk) {
          const unsigned b = __ballot_sync(0xffffffffu, c == kk);
          if (lane == kk) my_cnt += __popc(b);
        }
      }
      if (tid < ncol) {
        for (int jj = 0; jj < cnt; ++jj) {
          const int c = cls_of(s, jj, j0 + jj);
          if (c >= 0) sm.acc[c][tid] += to_f32(sm.stage[s][jj][tid]);
        }
      }
      __syncthreads();
    }
  };

  if constexpr (DENSE) {
    run_groups(r_end - r_begin);
  } else {
    // compact the chunk's rows of this class tile, PA_SEG labels a step
    long long nxt[PA_U];
#pragma unroll
    for (int u = 0; u < PA_U; ++u) {
      const int i = r_begin + warp * (PA_U * 32) + u * 32 + lane;
      nxt[u] = i < r_end ? read_label(a.labels, a.lab64, i) : -1;
    }
    int list_n = 0;
    for (int seg0 = r_begin; seg0 < r_end; seg0 += PA_SEG) {
      int cls[PA_U];
      unsigned mask[PA_U];
      int wc = 0;
#pragma unroll
      for (int u = 0; u < PA_U; ++u) {
        cls[u] = (nxt[u] >= c0 && nxt[u] < c_hi) ? (int)(nxt[u] - c0) : -1;
        mask[u] = __ballot_sync(0xffffffffu, cls[u] >= 0);
        wc += __popc(mask[u]);
      }
#pragma unroll
      for (int u = 0; u < PA_U; ++u) {     // the next step's labels, in flight
        const int i = seg0 + PA_SEG + warp * (PA_U * 32) + u * 32 + lane;
        nxt[u] = i < r_end ? read_label(a.labels, a.lab64, i) : -1;
      }
      if (lane == 0) sm.wcnt[warp] = wc;
      __syncthreads();
      int pos = list_n, total = list_n;
#pragma unroll
      for (int w = 0; w < PA_WARPS; ++w) {
        if (w < warp) pos += sm.wcnt[w];
        total += sm.wcnt[w];
      }
      const unsigned lt = (1u << lane) - 1u;
#pragma unroll
      for (int u = 0; u < PA_U; ++u) {
        if (cls[u] >= 0) {
          const int idx = pos + __popc(mask[u] & lt);
          sm.list_row[idx] = seg0 + warp * (PA_U * 32) + u * 32 + lane;
          sm.list_cls[idx] = (signed char)cls[u];
        }
        pos += __popc(mask[u]);
      }
      __syncthreads();
      list_n = total;
      if (list_n > PA_LIST - PA_SEG || seg0 + PA_SEG >= r_end) {
        run_groups(list_n);
        list_n = 0;
      }
    }
  }

  if constexpr (CLUSTER) {
    // the K partials of this tile, added in chunk (cluster rank) order by
    // the K blocks, each a slice of the tile, reading each other's acc
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    if (do_counts && warp == 0 && lane < CT) sm.cnt[lane] = my_cnt;
    cluster.sync();
    const int K = a.K, nc = c_hi - c0, E = nc * ncol;
    for (int e = k * PA_THREADS + tid; e < E; e += K * PA_THREADS) {
      const int c = e / ncol, col = e - c * ncol;
      float v[PA_CLUSTER];
#pragma unroll
      for (int kk = 0; kk < PA_CLUSTER; ++kk)
        v[kk] = kk < K ? *cluster.map_shared_rank(&sm.acc[c][col], kk) : 0.f;
      float tot = v[0];
#pragma unroll
      for (int kk = 1; kk < PA_CLUSTER; ++kk)
        if (kk < K) tot += v[kk];
      a.sums[(size_t)(c0 + c) * a.d + col0 + col] = tot;
    }
    if (do_counts && k == 0 && tid < nc) {
      int tot = 0;
      for (int kk = 0; kk < K; ++kk) tot += *cluster.map_shared_rank(&sm.cnt[tid], kk);
      a.counts[c0 + tid] = (float)tot;
    }
    cluster.sync();        // no block leaves while another reads its acc
    return;
  }

  if (a.K == 1) {
    if (tid < ncol)
      for (int c = c0; c < c_hi; ++c) a.sums[(size_t)c * a.d + col0 + tid] = sm.acc[c - c0][tid];
    if (do_counts && warp == 0 && lane < c_hi - c0) a.counts[c0 + lane] = (float)my_cnt;
    return;
  }

  // K > 1: this chunk's partials to the workspace; the last block adds them
  float* ws_sums = a.ws;
  float* ws_cnt = a.ws + (size_t)a.K * a.C * a.d;
  if (tid < ncol)
    for (int c = c0; c < c_hi; ++c)
      ws_sums[((size_t)k * a.C + c) * a.d + col0 + tid] = sm.acc[c - c0][tid];
  if (do_counts && warp == 0 && lane < c_hi - c0)
    ws_cnt[(size_t)k * a.C + c0 + lane] = (float)my_cnt;
  __threadfence();           // the last block of the tile to arrive adds them
  __syncthreads();
  const int tile = blockIdx.y * gridDim.z + blockIdx.z;
  if (tid == 0) sm.last = atomicAdd(&a.counters[tile], 1) == a.K - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();

  // the K partials of this tile, added in chunk order (4 elements a thread
  // and 8 chunks in flight)
  const int nc = c_hi - c0, E = nc * ncol;
  for (int e0 = tid; e0 < E; e0 += 4 * PA_THREADS) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    size_t off[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = min(e0 + q * PA_THREADS, E - 1);
      const int c = e / ncol, col = e - c * ncol;
      off[q] = (size_t)(c0 + c) * a.d + col0 + col;
    }
    for (int kb = 0; kb < a.K; kb += 8) {
      float v[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[q][u] = kb + u < a.K ? __ldcg(ws_sums + (size_t)(kb + u) * a.C * a.d + off[q]) : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (kb + u < a.K) acc[q] += v[q][u];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (e0 + q * PA_THREADS < E) a.sums[off[q]] = acc[q];
  }
  if (do_counts && tid < nc) {
    float cnt = 0.f;
    for (int kk = 0; kk < a.K; ++kk) cnt += __ldcg(ws_cnt + (size_t)kk * a.C + c0 + tid);
    a.counts[c0 + tid] = cnt;
  }
  if (tid == 0) a.counters[tile] = 0;
}

template <typename T, int VB, bool DENSE>
cudaError_t launch_mode(const PAArgs& a, dim3 grid, cudaStream_t stream) {
  if (a.K > 1 && a.K <= PA_CLUSTER) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(PA_THREADS);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    static bool nonportable[16] = {};   // clusters past 8 blocks: once a device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err) return err;
    if (a.K > 8 && !(dev < 16 && nonportable[dev])) {
      err = cudaFuncSetAttribute(proto_accum_kernel<T, VB, DENSE, true>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err) return err;
      if (dev < 16) nonportable[dev] = true;
    }
    return cudaLaunchKernelEx(&cfg, proto_accum_kernel<T, VB, DENSE, true>, a);
  }
  proto_accum_kernel<T, VB, DENSE, false><<<grid, PA_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int VB>
cudaError_t launch_vb(const PAArgs& a, dim3 grid, cudaStream_t stream) {
  if (a.C <= PA_CT_DENSE) return launch_mode<T, VB, true>(a, grid, stream);
  return launch_mode<T, VB, false>(a, grid, stream);
}

int ws_floats(int K, int d, int C) { return K > PA_CLUSTER ? K * C * (d + 1) : 0; }

int n_counters(int K, int d, int C) {
  const int ct = C <= PA_CT_DENSE ? C : PA_CT;
  return K > PA_CLUSTER ? ((C + ct - 1) / ct) * ((d + PA_COLS - 1) / PA_COLS) : 0;
}

template <typename T>
int launch(const void* feats, const void* labels, int lab64, float* sums, float* counts,
           float* ws, int* counters, int N, int n, int d, int C, int K, cudaStream_t stream) {
  if (N < 1 || K < 1 || (long long)N * K > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  PAArgs a{feats, labels, lab64, sums, counts, ws, counters, n, d, C, K,
           (n + K - 1) / K, ws_floats(K, d, C), n_counters(K, d, C)};
  dim3 grid(N * K, C <= PA_CT_DENSE ? 1 : (C + PA_CT - 1) / PA_CT, (d + PA_COLS - 1) / PA_COLS);
  const size_t row_bytes = (size_t)d * sizeof(T);
  const uintptr_t p = reinterpret_cast<uintptr_t>(feats);
  cudaError_t err;
  if (p % 16 == 0 && row_bytes % 16 == 0)
    err = launch_vb<T, 16>(a, grid, stream);
  else if (p % 4 == 0 && row_bytes % 4 == 0)
    err = launch_vb<T, 4>(a, grid, stream);
  else
    err = launch_vb<T, 0>(a, grid, stream);
  return (int)err;
}

}  // namespace

// Row chunks K for one client's (n, d, C). 1 < K <= 16: the chunks of a tile
// form one cluster and need no workspace; K > 16 needs a workspace of
// K*C*(d + 1) floats and one zeroed int counter per (class tile, column
// chunk), N times each for N clients.
extern "C" int proto_accum_plan(int n, int d, int C) {
  if (n <= 0 || C <= 0 || d <= 0) return 1;
  const int ct = C <= PA_CT_DENSE ? C : PA_CT;
  const int tiles = ((C + ct - 1) / ct) * ((d + PA_COLS - 1) / PA_COLS);
  int K = (n + PA_ROWS_PER_CHUNK - 1) / PA_ROWS_PER_CHUNK;
  K = K < n / C ? K : n / C;                                   // workspace <= features
  const int fill = (2 * PA_SMS + tiles - 1) / tiles;
  K = K < fill ? K : fill;
  if (n <= PA_CLUSTER_ROWS && K > PA_CLUSTER) K = PA_CLUSTER;  // add in a cluster
  return K > 1 ? K : 1;
}

// The workspace floats and zeroed counters that K chunks of one client need
// (0 for none).
extern "C" int proto_accum_workspace(int K, int d, int C) { return ws_floats(K, d, C); }

extern "C" int proto_accum_counters(int K, int d, int C) { return n_counters(K, d, C); }

// N clients of (n, d, C), each a contiguous slice of every array; N = 1 is
// the call for one client.
extern "C" int proto_accum_f32(const float* feats, const void* labels, int lab64, float* sums,
                               float* counts, float* ws, int* counters, int N, int n, int d,
                               int C, int K, cudaStream_t stream) {
  return launch<float>(feats, labels, lab64, sums, counts, ws, counters, N, n, d, C, K,
                       stream);
}

extern "C" int proto_accum_bf16(const void* feats, const void* labels, int lab64, float* sums,
                                float* counts, float* ws, int* counters, int N, int n, int d,
                                int C, int K, cudaStream_t stream) {
  return launch<__nv_bfloat16>(feats, labels, lab64, sums, counts, ws, counters, N, n, d, C,
                               K, stream);
}
