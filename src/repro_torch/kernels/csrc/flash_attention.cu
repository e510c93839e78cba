// Causal or full GQA attention with an online softmax, for sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py. The contract is that of
// src/repro/kernels/ref.py:flash_attention:
//
//   q (B, Sq, H, hd), k and v (B, Sk, G, hd), H % G == 0, float32 or bf16;
//   query head h reads KV head h / (H / G) (never repeated in memory);
//   s = (q * hd^-0.5) k^T in float32; causal mask q_pos >= k_pos, both
//   counted from 0; masked scores are -1e30; running max, sum and
//   accumulator in float32; out = acc / max(l, 1e-30) in q's dtype,
//   written straight into (B, Sq, H, hd).
//
// What bounds it: 4 * B * H * Sq * Sk * hd operations (half of that causal)
// over 2 * (B*Sq*H + B*Sk*G) * hd elements of input and output, so at the
// serving prefill shape (B 4, S 1024, H 32, G 4, hd 64) it is bound by
// operations. This kernel does them in float32 on the CUDA cores, whose peak
// (67 TFLOP/s) is a fifteenth of the bf16 tensor cores'; `mma`/`wgmma`
// tiles are a later PR's work.
//
// Design. The Pallas grid walks the key blocks SEQUENTIALLY with (m, l, acc)
// in scratch; here one block owns BQ query rows of one (batch, head) and
// walks the key tiles itself, so the running state lives in registers:
//   - a query row is split over TPR = hd / 32 neighbouring threads, each
//     holding 32 of its dims (q, pre-scaled, and acc) in registers; dims are
//     interleaved in float4 chunks (thread p owns chunks p, p + TPR, ...) so
//     the TPR threads of a row read neighbouring shared-memory words;
//   - each tile of BK keys and values is loaded once into shared memory in
//     float32 for all BQ rows; every row reads the same key at the same time,
//     so the reads are broadcasts;
//   - per tile, the BK scores of a row go to registers (a partial dot per
//     thread, summed over the row's TPR lanes by shuffles), then one rescale
//     of (l, acc) by the tile's max, then p = exp(s - m) and acc += p v;
//   - causal: tiles wholly above the diagonal are skipped. That gives the
//     Pallas kernel's result, whose fully masked tiles add exp(-1e30 - m) = 0
//     once tile 0 (which holds key 0, valid for every row) has set m;
//   - ragged lengths: query rows past Sq compute on zeros and store nothing;
//     keys past Sk are masked like causal ones.

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per shared-memory tile
constexpr int DPT = 32;                // dims of a row held by one thread
constexpr int CH = DPT / 4;            // float4 chunks a thread holds
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(BQ * (HD / DPT))
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int Sq, int Sk, int H, int G, float scale) {
  constexpr int TPR = HD / DPT;        // threads per query row
  constexpr int NT = BQ * TPR;
  __shared__ __align__(16) float Ks[BK][HD];
  __shared__ __align__(16) float Vs[BK][HD];

  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int q_pos = q0 + row;

  // this thread's dims: chunk c covers dims 4 * (part + TPR * c) + 0..3
  float qr[DPT], acc[DPT];
  const T* qrow = q + (((size_t)b * Sq + q_pos) * H + h) * HD;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + TPR * c) + e;
      qr[4 * c + e] = (q_pos < Sq) ? to_f32(qrow[d]) * scale : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = NEG_INF, l = 0.f;

  const int k_end = CAUSAL ? min(Sk, q0 + BQ) : Sk;
  const size_t kv_row = (size_t)G * HD;          // stride between key positions
  const T* kbase = k + ((size_t)b * Sk * G + g) * HD;
  const T* vbase = v + ((size_t)b * Sk * G + g) * HD;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                               // previous tile consumed
    for (int i = tid; i < BK * HD; i += NT) {
      const int j = i / HD, d = i % HD;
      const bool in = k0 + j < Sk;
      Ks[j][d] = in ? to_f32(kbase[(size_t)(k0 + j) * kv_row + d]) : 0.f;
      Vs[j][d] = in ? to_f32(vbase[(size_t)(k0 + j) * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part_dot = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][4 * (part + TPR * c)]);
        part_dot += qr[4 * c] * kk.x + qr[4 * c + 1] * kk.y +
                    qr[4 * c + 2] * kk.z + qr[4 * c + 3] * kk.w;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
        part_dot += __shfl_xor_sync(0xffffffffu, part_dot, off);
      const int k_pos = k0 + j;
      const bool valid = k_pos < Sk && (!CAUSAL || k_pos <= q_pos);
      s[j] = valid ? part_dot : NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }

    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][4 * (part + TPR * c)]);
        acc[4 * c] += p * vv.x;
        acc[4 * c + 1] += p * vv.y;
        acc[4 * c + 2] += p * vv.z;
        acc[4 * c + 3] += p * vv.w;
      }
    }
    m = m_new;
  }

  if (q_pos < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + (((size_t)b * Sq + q_pos) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&orow[4 * (part + TPR * c) + e], acc[4 * c + e] * inv);
    }
  }
}

template <typename T, int HD, bool CAUSAL>
int launch_hd(const T* q, const T* k, const T* v, T* o, int B, int Sq, int Sk,
              int H, int G, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD, CAUSAL><<<grid, BQ * (HD / DPT), 0, stream>>>(
      q, k, v, o, Sq, Sk, H, G, (float)(1.0 / std::sqrt((double)HD)));
  return (int)cudaGetLastError();
}

template <typename T, bool CAUSAL>
int launch_causal(const T* q, const T* k, const T* v, T* o, int B, int Sq,
                  int Sk, int H, int G, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<T, 32, CAUSAL>(q, k, v, o, B, Sq, Sk, H, G, stream);
    case 64: return launch_hd<T, 64, CAUSAL>(q, k, v, o, B, Sq, Sk, H, G, stream);
    case 128: return launch_hd<T, 128, CAUSAL>(q, k, v, o, B, Sq, Sk, H, G, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int B, int Sq, int Sk,
           int H, int G, int hd, int causal, cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  return causal ? launch_causal<T, true>(q, k, v, o, B, Sq, Sk, H, G, hd, stream)
                : launch_causal<T, false>(q, k, v, o, B, Sq, Sk, H, G, hd, stream);
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k, const float* v,
                                   float* o, int B, int Sq, int Sk, int H, int G,
                                   int hd, int causal, cudaStream_t stream) {
  return launch(q, k, v, o, B, Sq, Sk, H, G, hd, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int B, int Sq, int Sk, int H, int G,
                                    int hd, int causal, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  return launch(static_cast<const bf*>(q), static_cast<const bf*>(k),
                static_cast<const bf*>(v), static_cast<bf*>(o), B, Sq, Sk, H,
                G, hd, causal, stream);
}
