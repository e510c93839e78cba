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
// operations: 17.2 GFLOP, 0.0174 ms at the bf16 tensor cores' 989 TFLOP/s.
//
// Two kernels, one per input type.
//
// bf16: `flash_attention_bf16_kernel`, on the tensor cores (wgmma). One
// block owns BQ = 128 query rows of one (batch, head): two consumer
// warpgroups of 64 rows each, and a producer warpgroup that hands its
// registers to them (setmaxnreg) and of which one thread issues the copies.
// (With a lone producer warp, 288 threads, the consumers stalled in their
// first tile on the H100.) The producer fills a 2-stage ring of K and V tiles
// (BK keys, all hd dims) in shared memory by TMA, with a full and an empty
// mbarrier per stage; the Q tile is loaded once. Tiles are stored with the
// 128-byte swizzle (64-byte at hd 32) in chunks of 64 dims, the layout wgmma
// reads. TMA's zero fill covers rows past Sq and keys past Sk. Per tile a
// consumer warpgroup
//   - computes S = Q K^T by wgmma m64nBKk16, both operands in shared memory:
//     bf16 x bf16 products are exact in float32, so this is the plain
//     version's arithmetic up to summation order. Q is not pre-scaled (a
//     bf16 q * hd^-0.5 would round at hd 32 and 128); the float32 scores
//     are scaled by hd^-0.5 * log2(e) and exponentiated with exp2;
//   - keeps the running max and sum of its two rows a thread in float32,
//     masking (-1e30) only on tiles that cross the diagonal or Sk;
//   - adds P V into a float32 accumulator in registers, with P split in two
//     bf16 halves, P_hi = bf16(p) and P_lo = bf16(p - P_hi), and two wgmmas
//     per 16 keys (A from registers: the m64nN accumulator layout is the
//     m64k16 A-operand layout, so P never goes through shared memory; V is
//     the B operand, MN-major). The plain version multiplies float32 P by
//     V; rounding P to bf16 once, as FlashAttention-2/3 do, reads 17x the
//     one-bf16-step limit the port holds the kernel to (chip_smoke.py, at
//     the serving prefill shape), while the split keeps 16 bits of P's
//     mantissa and reads under 1x. It costs one more
//     product: 1.5x the attention's tensor-core work.
// Causal tiles wholly above the diagonal are skipped, and the grid starts
// the last (heaviest) query tiles first. Tiles: BK = 128 keys at hd 32 and
// 64, 64 at hd 128; 384 threads a block, one block an SM. ptxas -v (CUDA
// 12.9, sm_90a) reports 168 registers a thread at entry for every
// instantiation (setmaxnreg then leaves the producer 40 and gives the
// consumers 232), no spills but for 12 bytes stored and 36 loaded at hd 64
// causal; dynamic shared memory is 42,048 / 83,008 / 99,392 bytes at hd 32 /
// 64 / 128 (`flash_attention_bf16_smem`).
//
// float32: `flash_attention_kernel`, on the CUDA cores in float32, kept
// deliberately: TF32 tensor cores would miss the float32 checks, and this
// kernel already beats scaled_dot_product_attention in float32. One block
// owns 64 query rows of one (batch, head) and walks the key tiles itself,
// the running state in registers:
//   - a query row is split over TPR = hd / 32 neighbouring threads, each
//     holding 32 of its dims (q, pre-scaled, and acc) in registers; dims are
//     interleaved in float4 chunks (thread p owns chunks p, p + TPR, ...) so
//     the TPR threads of a row read neighbouring shared-memory words;
//   - each tile of 32 keys and values is loaded once into shared memory in
//     float32 for all rows; every row reads the same key at the same time,
//     so the reads are broadcasts;
//   - per tile, the 32 scores of a row go to registers (a partial dot per
//     thread, summed over the row's TPR lanes by shuffles), then one rescale
//     of (l, acc) by the tile's max, then p = exp(s - m) and acc += p v.
// Both kernels: causal tiles wholly above the diagonal are skipped, which
// gives the Pallas kernel's result (its fully masked tiles add
// exp(-1e30 - m) = 0 once tile 0, which holds key 0, valid for every row,
// has set m); query rows past Sq compute on zeros and store nothing; keys
// past Sk are masked like causal ones.

#include <cmath>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// -- float32: CUDA cores -----------------------------------------------------
namespace f32 {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per shared-memory tile
constexpr int DPT = 32;                // dims of a row held by one thread
constexpr int CH = DPT / 4;            // float4 chunks a thread holds
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

}  // namespace f32

// -- bf16: tensor cores -------------------------------------------------------
namespace tc {

constexpr int BQ = 128;                // query rows a block: 2 warpgroups of 64
constexpr int STAGES = 2;              // K/V ring depth
constexpr int CONSUMERS = 256;         // threads of the two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128; // and one producer warpgroup
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Tile {
  static constexpr int CW = HD < 64 ? HD : 64;        // dims of one swizzled chunk
  static constexpr int NCH = HD / CW;                 // chunks a row
  static constexpr int RB = 2 * CW;                   // bytes of a chunk row
  static constexpr int BK = HD == 128 ? 64 : 128;     // keys a tile
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;        // K or V, one stage
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  // + the mbarriers, + slack to align the base to 1024 bytes (the swizzle atom)
  static constexpr int SMEM = BAR_OFF + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits for the phase of parity `parity` to complete. A lost arrival traps
// (an error at the next synchronisation) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (i == (1u << 20)) __trap();
  }
}

// TMA: the box at (c0, c1, c2, c3) of a 4-d tensor map into shared memory;
// its bytes complete the barrier's expected transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a swizzled tile with rows of RB bytes
// (128: 128-byte swizzle, 64: 64-byte swizzle): 8-row groups SBO = 8 * RB
// apart; `lbo` is the byte stride between 64-dim chunks of an MN-major
// operand (unused for K-major ones).
template <int RB>
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo) {
  constexpr uint64_t layout = RB == 128 ? 1 : 2;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(((8 * RB) >> 4) & 0x3FFF) << 32 | layout << 62;
}

// m64nNk16 float32 accumulator: N / 2 values a thread. Value 4j + 2i + e is
// row (16 * warp + lane / 4 + 8i), column 8j + 2 (lane % 4) + e.
template <int N>
struct Acc {
  float d[N / 2];
};

// Keeps the compiler from moving register reads or writes across an
// asynchronous wgmma that owns the registers.
template <int N>
__device__ __forceinline__ void fence_regs(Acc<N>& a) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(a.d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (+)= A B, m64nNk16, bf16 in, float32 out. wgmma_ss: A and B from shared
// memory, both K-major; scale_d 0 overwrites D (N = BK). wgmma_rs_tb: A from
// registers (the m64k16 fragment: 4 registers of 2 bf16), B MN-major
// ("transposed"); N = hd.
__device__ __forceinline__ void wgmma_rs_tb(Acc<32>& acc, const uint32_t (&a)[4],
                                            uint64_t b) {
  float* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(Acc<64>& acc, uint64_t a, uint64_t b,
                                         int scale_d) {
  float* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_tb(Acc<64>& acc, const uint32_t (&a)[4],
                                            uint64_t b) {
  float* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(Acc<128>& acc, uint64_t a, uint64_t b,
                                         int scale_d) {
  float* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_tb(Acc<128>& acc, const uint32_t (&a)[4],
                                            uint64_t b) {
  float* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                            int H, int G, float scale_log2) {
  using T = Tile<HD>;
  constexpr int BK = T::BK, RB = T::RB, CW = T::CW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = base;                           // Q: NCH chunks of (BQ, CW)
  uint8_t* skv = base + T::Q_BYTES;             // stage s: K then V, NCH chunks
  uint64_t* full = reinterpret_cast<uint64_t*>(base + T::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int g = h / (H / G);
  const int k_end = CAUSAL ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer warpgroup: one thread issues every copy. ptxas gives the
    // kernel 168 registers a thread (65536 / 384); the producer drops to 40
    // and its 16384 registers take the consumers from 168 to 232.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS) {
      mbar_expect_tx(qbar, T::Q_BYTES);
      for (int c = 0; c < T::NCH; ++c)
        tma_load(sq + c * BQ * RB, &tm_q, qbar, c * CW, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);   // round 0 passes
        mbar_expect_tx(&full[s], 2 * T::KV_BYTES);
        uint8_t* kt = skv + s * 2 * T::KV_BYTES;
        for (int c = 0; c < T::NCH; ++c) {
          tma_load(kt + c * BK * RB, &tm_k, &full[s], c * CW, g, t * BK, b);
          tma_load(kt + T::KV_BYTES + c * BK * RB, &tm_v, &full[s], c * CW, g,
                   t * BK, b);
        }
      }
    }
  } else {
    // consumer warpgroups: wg owns rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int first = q0 + 64 * wg;
    const int r0 = first + 16 * warp + lane / 4;        // and r0 + 8
    const int cq = 2 * (lane % 4);
    const uint8_t* qw = sq + 64 * wg * RB;

    Acc<HD> acc;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc.d[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    mbar_wait(qbar, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES, k0 = t * BK;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const uint8_t* kt = skv + s * 2 * T::KV_BYTES;
      const uint8_t* vt = kt + T::KV_BYTES;
      if (!CAUSAL || k0 <= first + 63) {      // else wholly masked for this wg
        // S = Q K^T over hd / 16 slices of 16 dims
        Acc<BK> sc;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int ch = kk / (CW / 16), off = (kk % (CW / 16)) * 32;
          wgmma_ss(sc, desc<RB>(qw + ch * BQ * RB + off, 16),
                   desc<RB>(kt + ch * BK * RB + off, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);

        // online softmax in base 2 on the two rows this thread holds
        const bool edge = (CAUSAL && k0 + BK - 1 > first) || k0 + BK > Sk;
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = sc.d[4 * j + 2 * i + e] * scale_log2;
              if (edge) {
                const int key = k0 + 8 * j + cq + e;
                if (key >= Sk || (CAUSAL && key > r0 + 8 * i)) x = NEG_INF;
              }
              sc.d[4 * j + 2 * i + e] = x;
              mx[i] = fmaxf(mx[i], x);
            }
          }
        }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m[i], mx[i]);
          alpha[i] = exp2f(m[i] - m_new);
          m[i] = m_new;
          l[i] *= alpha[i];
        }
        // p, its row sums, and its split into two bf16 A fragments: register
        // r of slice kk holds values 8 kk + 2 r and 8 kk + 2 r + 1
        uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = r % 2;
            const float x = exp2f(sc.d[8 * kk + 2 * r] - m[i]);
            const float y = exp2f(sc.d[8 * kk + 2 * r + 1] - m[i]);
            l[i] += x + y;
            const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
            p_hi[kk][r] = bf16x2_bits(hi);
            p_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(
                x - __low2float(hi), y - __high2float(hi)));
          }
        }
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc.d[4 * j] *= alpha[0];
          acc.d[4 * j + 1] *= alpha[0];
          acc.d[4 * j + 2] *= alpha[1];
          acc.d[4 * j + 3] *= alpha[1];
        }

        // O += P_hi V + P_lo V over BK / 16 slices of 16 keys
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t vd = desc<RB>(vt + kk * 16 * RB, BK * RB);
          wgmma_rs_tb(acc, p_hi[kk], vd);
          wgmma_rs_tb(acc, p_lo[kk], vd);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          fence_regs(p_hi[kk]);
          fence_regs(p_lo[kk]);
        }
      }
      mbar_arrive(&empty[s]);
    }

    // out = acc / l, rows past Sq dropped
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = r0 + 8 * i;
      if (row >= Sq) continue;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = o + ((static_cast<size_t>(b) * Sq + row) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
            __floats2bfloat162_rn(acc.d[4 * j + 2 * i] * inv,
                                  acc.d[4 * j + 2 * i + 1] * inv);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over a (B, S, heads, hd) bf16 tensor whose box is `rows`
// positions of one head: CW dims at a time, swizzled as wgmma reads them.
template <int HD>
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int S,
            int heads, int rows) {
  constexpr int CW = Tile<HD>::CW;
  const cuuint64_t dims[4] = {HD, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {HD * 2ull, (cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)S * heads * HD * 2};
  const cuuint32_t box[4] = {CW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool CAUSAL>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int H, int G, cudaStream_t stream) {
  using T = Tile<HD>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!encode<HD>(enc, &mq, q, B, Sq, H, BQ) ||
      !encode<HD>(enc, &mk, k, B, Sk, G, T::BK) ||
      !encode<HD>(enc, &mv, v, B, Sk, G, T::BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_bf16_kernel<HD, CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, T::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, G,
      (float)(1.4426950408889634 / std::sqrt((double)HD)));
  return (int)cudaGetLastError();
}

template <bool CAUSAL>
int launch_causal(const void* q, const void* k, const void* v, void* o, int B,
                  int Sq, int Sk, int H, int G, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<32, CAUSAL>(q, k, v, o, B, Sq, Sk, H, G, stream);
    case 64: return launch_hd<64, CAUSAL>(q, k, v, o, B, Sq, Sk, H, G, stream);
    case 128: return launch_hd<128, CAUSAL>(q, k, v, o, B, Sq, Sk, H, G, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

bool bad_shape(int B, int Sq, int Sk, int H, int G) {
  return B < 1 || Sq < 1 || Sk < 1 || G < 1 || H % G != 0;
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k, const float* v,
                                   float* o, int B, int Sq, int Sk, int H, int G,
                                   int hd, int causal, cudaStream_t stream) {
  if (bad_shape(B, Sq, Sk, H, G)) return (int)cudaErrorInvalidValue;
  return causal ? f32::launch_causal<float, true>(q, k, v, o, B, Sq, Sk, H, G, hd, stream)
                : f32::launch_causal<float, false>(q, k, v, o, B, Sq, Sk, H, G, hd, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int B, int Sq, int Sk, int H, int G,
                                    int hd, int causal, cudaStream_t stream) {
  if (bad_shape(B, Sq, Sk, H, G)) return (int)cudaErrorInvalidValue;
  return causal ? tc::launch_causal<true>(q, k, v, o, B, Sq, Sk, H, G, hd, stream)
                : tc::launch_causal<false>(q, k, v, o, B, Sq, Sk, H, G, hd, stream);
}

// Dynamic shared memory of the bf16 kernel at head_dim hd, in bytes.
extern "C" int flash_attention_bf16_smem(int hd) {
  switch (hd) {
    case 32: return tc::Tile<32>::SMEM;
    case 64: return tc::Tile<64>::SMEM;
    case 128: return tc::Tile<128>::SMEM;
    default: return -1;
  }
}
