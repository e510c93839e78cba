// Causal or full GQA attention with an online softmax, for sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py. The contract is that of
// src/repro/kernels/ref.py:flash_attention:
//
//   q (B, Sq, H, hd), k (B, Sk, G, hd) and v (B, Sk, G, hv), H % G == 0,
//   float32 or bf16; hv == hd but for MLA's pairs (below);
//   query head h reads KV head h / (H / G) (never repeated in memory);
//   s = (q * hd^-0.5) k^T in float32; causal mask q_pos >= k_pos, both
//   counted from 0; with a window W > 0 also q_pos - k_pos < W (the
//   reference's sliding-window mask, `repro/nn/attention.py:full_attention`;
//   W = 0 is no window); masked scores are -1e30; running max, sum and
//   accumulator in float32; out = acc / max(l, 1e-30) in q's dtype,
//   written straight into (B, Sq, H, hv).
//
// What bounds it: 2 * B * H * Sq * Sk * (hd + hv) operations (half of that
// causal) over (B*Sq*H + B*Sk*G) * (hd + hv) elements of input and output
// (q and k at hd, v and the output at hv), so at the
// serving prefill shape (B 4, S 1024, H 32, G 4, hd 64) it is bound by
// operations: 17.2 GFLOP, 0.0174 ms at the bf16 tensor cores' 989 TFLOP/s.
// The float32 kernel's split runs three TF32 products for each: 3 x the
// operations over TF32's 495 TFLOP/s (or the float32 bytes over 3.35 TB/s,
// whichever is larger), 0.1041 ms at that shape causal, against 0.2564 ms
// for the operations over float32's 67 TFLOP/s on the CUDA cores.
//
// Three kernels: a tensor-core kernel for bf16 and one for float32 at equal
// head dims and at MLA's published split dims, and the CUDA-core kernel for
// both dtypes at the reduced configs' (80, 64). Which takes which:
//
//   (hd, hv)                      bf16                  float32
//   (32, 32) (64, 64) (128, 128)  tensor cores (bf16)   tensor cores (split TF32)
//   (192, 128) (96, 64)           tensor cores (bf16)   tensor cores (split TF32)
//   (80, 64)                      CUDA cores            CUDA cores
//   anything else                 cudaErrorInvalidValue
//
// bf16: `flash_attention_bf16_kernel<HD, HV, CAUSAL>`, on the tensor cores
// (wgmma). One block owns BQ = 128 query rows of one (batch, head): two
// consumer warpgroups of 64 rows each, and a producer warpgroup that hands
// its registers to them (setmaxnreg) and of which one thread issues the
// copies. (With a lone producer warp, 288 threads, the consumers stalled in
// their first tile on the H100.) The producer fills a 2-stage ring of K and
// V tiles (BK keys, all dims) in shared memory by TMA, with a full and an
// empty mbarrier per stage; the Q tile is loaded once. Q and K rows (hd
// dims) and V rows (hv dims) each have a tensor map and a chunk width of
// their own: chunks of 64 dims with the 128-byte swizzle, or of 32 with the
// 64-byte swizzle where the width is no multiple of 64 (hd 32, and MLA's
// 96 = 3 x 32), the layouts wgmma reads. TMA's zero fill covers rows past
// Sq and keys past Sk. Per tile a consumer warpgroup
//   - computes S = Q K^T by wgmma m64nBKk16 over hd / 16 slices, both
//     operands in shared memory: bf16 x bf16 products are exact in float32,
//     so this is the plain version's arithmetic up to summation order. Q is
//     not pre-scaled (a bf16 q * hd^-0.5 would round at hd 32 and 128); the
//     float32 scores are scaled by hd^-0.5 * log2(e) and exponentiated with
//     exp2;
//   - keeps the running max and sum of its two rows a thread in float32,
//     masking (-1e30) only on tiles that cross the diagonal, the window's
//     lower edge or Sk, in a branch of their own (the other tiles' loop
//     has no integer work);
//   - adds P V into a float32 accumulator in registers (m64nHVk16, hv / 2
//     floats a thread), with P split in two bf16 halves, P_hi = bf16(p) and
//     P_lo = bf16(p - P_hi), and two wgmmas per 16 keys (A from registers:
//     the m64nN accumulator layout is the m64k16 A-operand layout, so P
//     never goes through shared memory; V is the B operand, MN-major). The
//     plain version multiplies float32 P by V; rounding P to bf16 once, as
//     FlashAttention-2/3 do, reads 17x the one-bf16-step limit the port
//     holds the kernel to (chip_smoke.py, at the serving prefill shape),
//     while the split keeps 16 bits of P's mantissa and reads under 1x. It
//     costs one more product: 1.5x the attention's tensor-core work.
// Causal tiles wholly above the diagonal are skipped, and the grid starts
// the last (heaviest) query tiles first. Tiles: BK = 128 keys at hd 32 and
// 64, else 64 (hd 128, 192 / 128, 96 / 64), so that a consumer thread holds
// at most 64 + 64 + 32 or 32 + 32 + 64 floats of S, P_hi / P_lo and O;
// 384 threads a block, one block an SM. ptxas -v (CUDA 12.9, sm_90a)
// reports 168 registers a thread at entry for all ten instantiations
// (setmaxnreg then leaves the producer 40 and gives the consumers 232) and
// no spills (hd 64 causal spilled 12 bytes stored and 36 loaded before the
// mask took one unsigned range test a row, below); dynamic
// shared memory is 42,048 / 83,008 / 99,392 bytes at hd 32 / 64 / 128, and
// 132,160 / 66,624 at 192 / 128 and 96 / 64 (`flash_attention_bf16_smem`).
//
// float32: `flash_attention_tf32x3_kernel<HD, HV, CAUSAL>` (namespace x3),
// the bf16 kernel's skeleton on TF32 tensor cores, float32 products to
// float32 accuracy by a split: every operand x is cut into a big half b =
// tf32(x) (cvt.rna, 10 mantissa bits) and a small half s = tf32(x - b), and
// a product A B is taken as A_s B_b + A_b B_s + A_b B_b, three wgmma
// m64nNk8 tf32 chains into one float32 accumulator, small terms first
// (A_s B_s, 2^-22 of A B, is dropped). That keeps about 21-22 bits of each
// product at 495 / 3 = 165 TFLOP/s against the 67 of float32 on the CUDA
// cores; one TF32 product keeps about 11 and misses the float32 checks.
//   - Majorness: wgmma takes tf32 operands from shared memory K-major only,
//     so Q and K arrive as they are (hd contiguous), while V (keys x hv, hv
//     contiguous) is transposed to (hv x keys) by the pass that splits it.
//   - P from registers: the m64nN accumulator gives a thread columns 2t and
//     2t + 1 of each group of 8 keys, where the m64k8 A fragment wants
//     columns t and t + 4; V^T stores the keys of each group of 8 in the
//     order 0 2 4 6 1 3 5 7, so that the accumulator is the A fragment as
//     it stands (a sum over keys does not care about their order). P is
//     split too: P_s V_b + P_b V_s + P_b V_b.
//   - The tensor cores add each k8 step to their accumulator with
//     truncation, a bias that grows with the steps: a tile's P V goes to an
//     accumulator of its own (3 BK / 8 steps), added to O by an fma, O =
//     alpha O + P V. With one accumulator for the whole walk the serving
//     shape (4, 1024, 32, 4, 64), full, read 0.486 of the float32 limit on
//     the H100; this way 0.054-0.060.
//   - A block: NC consumer warpgroups of 64 query rows, and a producer
//     warpgroup. One producer thread issues the TMA copies (the Q tile once,
//     then each key tile's K and V into a raw buffer, with the 128-byte
//     swizzle for Q and K and none for V); all 128 split them: Q in place
//     (big) and beside it (small), each key tile into a stage of the ring,
//     K big, K small, V^T big, V^T small, in wgmma's 128-byte swizzled
//     layout, then fence.proxy.async and the stage's full mbarrier. The
//     consumers wait on it, run S and P V, and arrive on its empty barrier.
//     With two consumer warpgroups (384 threads) setmaxnreg leaves the
//     producer 56 registers and gives the consumers 224; ptxas still fits
//     the consumers' code in the 168 a thread has at entry.
//   - Shared memory: a float32 row with its small half takes four times the
//     bf16 kernel's bytes, so (BQ = 64 NC, BK, STAGES, RAW buffers) are
//     chosen per pair (`Cfg`): (32, 32) 128 / 64 / 2 / 2, 132,224 bytes;
//     (64, 64) 128 / 32 / 3 / 2, 197,760; (128, 128) 64 / 32 / 2 / 1,
//     230,528; (192, 128) 64 / 32 / 1 / 1, 222,336; (96, 64) 128 / 32 / 2 / 2,
//     222,336 (`flash_attention_f32_smem`; at most 232,448 a block). With
//     one stage, the split of tile i + 1 waits for the consumers to release
//     tile i; the raw buffer still lets its copy overlap their work. ptxas
//     -v (CUDA 12.8, sm_90a): 168 registers at entry at the three pairs with
//     two consumer warpgroups, 212 at (128, 128) and 200 at (192, 128) (256
//     threads, no setmaxnreg), no spills. (64, 64) spilled 72-80 bytes at
//     BK 64 once P V had its own accumulator; at BK 32 it spills nothing and
//     ran the serving shape 1.19x faster than one consumer warpgroup at
//     BK 64 (`tools/flash_ab.py`).
//   - A key split: where the query tiles B H ceil(Sq / BQ) leave SMs idle
//     (Whisper's cross attention over 1,500 frames and its decode, Sq = 32
//     and 1: 48 tiles for 132 SMs), each tile's key range (its window's,
//     where there is one) is cut in runs over several blocks
//     (`flash_attention_f32_splits`: the SMs a tile, at most half the key
//     tiles of the heaviest query tile, from the shape alone). Each block
//     writes its rows' (acc, m, l) to a workspace; the last of a tile's
//     blocks to arrive (an int counter after __threadfence, `ops._counters`)
//     rescales them to their common max, adds them in split order, writes
//     the output and resets the counter: one launch stays one kernel, and
//     the order is fixed, so two runs give equal bits. A row that sees no
//     key of a run leaves m = -1e30 there, and the combine's exp2(m - max)
//     is 0. Sq = 1 keeps wgmma's 64-row tile, the other 63 rows zeros from
//     TMA's fill that are never stored; a warpgroup whose rows all lie past
//     Sq skips its tiles.
// Where it cannot be exact: a float32 value needs 24 bits and b + s hold
// 22, so a window of 1 (p = 1 on one key) returns v to within 2^-22
// relative, not bit for bit as the bf16 kernel does.
//
// float32 and bf16 at (80, 64): `flash_attention_kernel` (namespace f32), on
// the CUDA cores in float32 (bf16 loaded through `to_f32`, rounded once in
// `store`). Its value dim HV is a template parameter of its own: MLA's
// prefill attends with query/key dim hd = qk_nope + qk_rope and value dim
// hv = v_head_dim (the reduced CPU configs' 80 / 64). One block owns 64
// query rows of one (batch, head) and walks the key tiles itself, the
// running state in registers:
//   - a query row is split over TPR = hv / 32 neighbouring threads, each
//     holding hd / TPR of its q dims (pre-scaled) and 32 of its acc dims in
//     registers; dims are interleaved in float4 chunks (thread p owns chunks
//     p, p + TPR, ...) so the TPR threads of a row read neighbouring
//     shared-memory words;
//   - each tile of 32 keys and values is loaded once into shared memory in
//     float32 for all rows; every row reads the same key at the same time,
//     so the reads are broadcasts;
//   - per tile, the 32 scores of a row go to registers (a partial dot per
//     thread, summed over the row's TPR lanes by shuffles), then one rescale
//     of (l, acc) by the tile's max, then p = exp(s - m) and acc += p v.
// All three: causal tiles wholly above the diagonal are skipped, which
// gives the Pallas kernel's result (its fully masked tiles add
// exp(-1e30 - m) = 0 once tile 0, which holds key 0, valid for every row,
// has set m); query rows past Sq compute on zeros and store nothing; keys
// past Sk are masked like causal ones.
//
// The window: a runtime int, no template parameter (0 comes in as 2^30,
// which no position difference reaches, so the window-free path runs the
// same loops with tests that never fire). A block's key loop starts at the
// tile that holds key q0 - W + 1, its first row's lowest visible key,
// rounded down to BK (the CUDA-core and split-TF32 kernels, whose ring
// counts the block's own tiles from 0) or to a multiple of 2 STAGES tiles
// (the bf16 kernel: tile t then takes stage t % STAGES and barrier
// parity (t / STAGES) & 1 in the producer and the consumers alike, as when
// the loop starts at tile 0; the up to 3 tiles more are loaded and
// skipped). A tile wholly left of the window for all of a warpgroup's rows
// is skipped like one above the diagonal; on a tile that crosses the
// window's lower edge, the diagonal or Sk, row r sees keys lo = r - W + 1 ..
// hi = min(r, Sk - 1) (causal; Sk - 1 else), one test a score:
// (unsigned)(key - lo) > hi - lo masks it. So the work is about S * W key
// pairs a head instead of S^2 / 2. A row whose first visited tile is
// wholly masked (a later row of the block, when W is no multiple of BK)
// takes m = -1e30 and p = exp(0) = 1 from it; its first valid score then
// sets m, and alpha = exp(-1e30 - m) = 0 multiplies l and acc to exact
// zeros, so the row comes out bit for bit as if that tile had been skipped.
// Every row sees a key (the wrapper requires Sq < Sk + W), so every row
// meets a valid score.

#include <cmath>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// -- CUDA cores: float32 and bf16 at (80, 64) ---------------------------------
namespace f32 {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per shared-memory tile
constexpr int DV = 32;                 // value dims of a row held by one thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);                      // round to nearest even
}

template <int HD, int HV>
struct Split {
  static constexpr int TPR = HV / DV;            // threads per query row
  static constexpr int DQ = HD / TPR;            // q dims a thread holds
  static constexpr int CHQ = DQ / 4, CHV = DV / 4;   // float4 chunks of each
  static_assert(HV % DV == 0 && HD % TPR == 0 && DQ % 4 == 0,
                "the row split must divide both head dims into float4s");
};

template <typename T, int HD, int HV, bool CAUSAL>
__global__ void __launch_bounds__(BQ * (HV / DV))
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int Sq, int Sk, int H, int G, int window, float scale) {
  using SP = Split<HD, HV>;
  constexpr int TPR = SP::TPR, DQ = SP::DQ, CHQ = SP::CHQ, CHV = SP::CHV;
  constexpr int NT = BQ * TPR;
  __shared__ __align__(16) float Ks[BK][HD];
  __shared__ __align__(16) float Vs[BK][HV];

  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int q_pos = q0 + row;

  // this thread's dims: chunk c covers dims 4 * (part + TPR * c) + 0..3
  float qr[DQ], acc[DV];
  const T* qrow = q + (((size_t)b * Sq + q_pos) * H + h) * HD;
#pragma unroll
  for (int c = 0; c < CHQ; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + TPR * c) + e;
      qr[4 * c + e] = (q_pos < Sq) ? to_f32(qrow[d]) * scale : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < DV; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  const int k_end = CAUSAL ? min(Sk, q0 + BQ) : Sk;
  const T* kbase = k + ((size_t)b * Sk * G + g) * HD;
  const T* vbase = v + ((size_t)b * Sk * G + g) * HV;
  const size_t kv_row = (size_t)G * HD;          // stride between key positions

  // the first tile holding a key in row q0's window
  for (int k0 = max(0, q0 - window + 1) / BK * BK; k0 < k_end; k0 += BK) {
    __syncthreads();                               // previous tile consumed
    if constexpr (HD == HV) {                      // one pass loads K and V
      for (int i = tid; i < BK * HD; i += NT) {
        const int j = i / HD, d = i % HD;
        const bool in = k0 + j < Sk;
        Ks[j][d] = in ? to_f32(kbase[(size_t)(k0 + j) * kv_row + d]) : 0.f;
        Vs[j][d] = in ? to_f32(vbase[(size_t)(k0 + j) * kv_row + d]) : 0.f;
      }
    } else {                                       // MLA's pairs: hv < hd
      for (int i = tid; i < BK * HD; i += NT) {
        const int j = i / HD, d = i % HD;
        Ks[j][d] = k0 + j < Sk ? to_f32(kbase[(size_t)(k0 + j) * kv_row + d]) : 0.f;
      }
      for (int i = tid; i < BK * HV; i += NT) {
        const int j = i / HV, d = i % HV;
        Vs[j][d] = k0 + j < Sk ? to_f32(vbase[(size_t)(k0 + j) * G * HV + d]) : 0.f;
      }
    }
    __syncthreads();

    float s[BK];
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part_dot = 0.f;
#pragma unroll
      for (int c = 0; c < CHQ; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][4 * (part + TPR * c)]);
        part_dot += qr[4 * c] * kk.x + qr[4 * c + 1] * kk.y +
                    qr[4 * c + 2] * kk.z + qr[4 * c + 3] * kk.w;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
        part_dot += __shfl_xor_sync(0xffffffffu, part_dot, off);
      const int k_pos = k0 + j;
      const bool valid = k_pos < Sk && (!CAUSAL || k_pos <= q_pos) &&
                         q_pos - k_pos < window;
      s[j] = valid ? part_dot : NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }

    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DV; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < CHV; ++c) {
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
    T* orow = o + (((size_t)b * Sq + q_pos) * H + h) * HV;
#pragma unroll
    for (int c = 0; c < CHV; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&orow[4 * (part + TPR * c) + e], acc[4 * c + e] * inv);
    }
  }
}

template <typename T, int HD, int HV, bool CAUSAL>
int launch_hd(const T* q, const T* k, const T* v, T* o, int B, int Sq, int Sk,
              int H, int G, int window, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD, HV, CAUSAL><<<grid, BQ * (HV / DV), 0, stream>>>(
      q, k, v, o, Sq, Sk, H, G, window, (float)(1.0 / std::sqrt((double)HD)));
  return (int)cudaGetLastError();
}

}  // namespace f32

// -- bf16: tensor cores -------------------------------------------------------
namespace tc {

constexpr int BQ = 128;                // query rows a block: 2 warpgroups of 64
constexpr int STAGES = 2;              // K/V ring depth
constexpr int CONSUMERS = 256;         // threads of the two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128; // and one producer warpgroup
constexpr float NEG_INF = -1e30f;

// Tiles of a (HD, HV) instance: Q and K rows HD dims wide, V rows HV wide,
// each cut in chunks of 64 dims with the 128-byte swizzle, or of 32 with the
// 64-byte swizzle where the width is no multiple of 64 (hd 32, and MLA's 96:
// one chunk of 64 would drop a third of it).
template <int HD, int HV>
struct Tile {
  static constexpr int CW = HD % 64 == 0 ? 64 : 32;   // Q/K dims of one chunk
  static constexpr int NCH = HD / CW;                 // Q/K chunks a row
  static constexpr int RB = 2 * CW;                   // bytes of a Q/K chunk row
  static constexpr int CWV = HV % 64 == 0 ? 64 : 32;  // the same for V
  static constexpr int NCHV = HV / CWV;
  static constexpr int RBV = 2 * CWV;
  // keys a tile: 128 at hd 32 and 64, else 64, which keeps a thread's S and
  // P_hi / P_lo at 32 registers each beside HV / 2 of O (at 96 / 64, 128
  // keys spill in the causal instance, as at hd 64)
  static constexpr int BK = HD == HV && HD <= 64 ? 128 : 64;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int K_BYTES = BK * HD * 2;         // one stage's K, then V
  static constexpr int STAGE_BYTES = K_BYTES + BK * HV * 2;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  // + the mbarriers, + slack to align the base to 1024 bytes (the swizzle atom)
  static constexpr int SMEM = BAR_OFF + 64 + 1024;
  static_assert(HD % CW == 0 && HV % CWV == 0, "chunks must tile the rows");
  static_assert(SMEM <= 232448, "one block an SM: 227 KB of shared memory");
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
// ("transposed"); N = hv.
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

template <int HD, int HV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                            int H, int G, int window, float scale_log2) {
  using T = Tile<HD, HV>;
  constexpr int BK = T::BK, RB = T::RB, CW = T::CW, RBV = T::RBV, CWV = T::CWV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = base;                           // Q: NCH chunks of (BQ, CW)
  // stage s: K in NCH chunks of (BK, CW), then V in NCHV chunks of (BK, CWV)
  uint8_t* skv = base + T::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + T::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int g = h / (H / G);
  const int k_end = CAUSAL ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  // the first tile: the one holding row q0's lowest visible key, rounded
  // down to a multiple of 2 STAGES tiles, so that tile t takes stage
  // t % STAGES and barrier parity (t / STAGES) & 1 in the producer and the
  // consumers alike, as when every block starts at tile 0
  const int t_first = max(0, q0 - window + 1) / (2 * STAGES * BK) * (2 * STAGES);
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
      for (int t = t_first; t < n_tiles; ++t) {
        const int s = t % STAGES, k0 = t * BK;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);   // round 0 passes
        mbar_expect_tx(&full[s], T::STAGE_BYTES);
        uint8_t* kt = skv + s * T::STAGE_BYTES;
        for (int c = 0; c < (T::NCH > T::NCHV ? T::NCH : T::NCHV); ++c) {
          if (c < T::NCH)
            tma_load(kt + c * BK * RB, &tm_k, &full[s], c * CW, g, k0, b);
          if (c < T::NCHV)
            tma_load(kt + T::K_BYTES + c * BK * RBV, &tm_v, &full[s], c * CWV,
                     g, k0, b);
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

    Acc<HV> acc;
#pragma unroll
    for (int i = 0; i < HV / 2; ++i) acc.d[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    mbar_wait(qbar, 0);

    for (int t = t_first; t < n_tiles; ++t) {
      const int s = t % STAGES, k0 = t * BK;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const uint8_t* kt = skv + s * T::STAGE_BYTES;
      const uint8_t* vt = kt + T::K_BYTES;
      // else wholly masked for this wg: above the diagonal, or left of the
      // window of its first (and so of every) row
      if ((!CAUSAL || k0 <= first + 63) && first - (k0 + BK - 1) < window) {
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
        const bool edge = (CAUSAL && k0 + BK - 1 > first) || k0 + BK > Sk ||
                          first + 63 - k0 >= window;
        float mx[2] = {NEG_INF, NEG_INF};
        if (edge) {
          int kof[2];
          uint32_t span[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r0 + 8 * r, lo = row - window + 1;
            const int hi = CAUSAL ? min(row, Sk - 1) : Sk - 1;
            kof[r] = k0 + cq - lo;
            span[r] = static_cast<uint32_t>(hi - lo);
          }
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float x = sc.d[4 * j + 2 * i + e] * scale_log2;
                if (static_cast<uint32_t>(8 * j + e + kof[i]) > span[i])
                  x = NEG_INF;
                sc.d[4 * j + 2 * i + e] = x;
                mx[i] = fmaxf(mx[i], x);
              }
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float x = sc.d[4 * j + 2 * i + e] * scale_log2;
                sc.d[4 * j + 2 * i + e] = x;
                mx[i] = fmaxf(mx[i], x);
              }
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
        for (int j = 0; j < HV / 8; ++j) {
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
          const uint64_t vd = desc<RBV>(vt + kk * 16 * RBV, BK * RBV);
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
      __nv_bfloat16* orow = o + ((static_cast<size_t>(b) * Sq + row) * H + h) * HV;
#pragma unroll
      for (int j = 0; j < HV / 8; ++j)
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

// A tensor map over a (B, S, heads, ROW) bf16 tensor whose box is `rows`
// positions of one head: CW dims at a time, swizzled as wgmma reads them.
template <int ROW, int CW>
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int S,
            int heads, int rows) {
  const cuuint64_t dims[4] = {ROW, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {ROW * 2ull, (cuuint64_t)heads * ROW * 2,
                                 (cuuint64_t)S * heads * ROW * 2};
  const cuuint32_t box[4] = {CW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int HV, bool CAUSAL>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int H, int G, int window, cudaStream_t stream) {
  using T = Tile<HD, HV>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!encode<HD, T::CW>(enc, &mq, q, B, Sq, H, BQ) ||
      !encode<HD, T::CW>(enc, &mk, k, B, Sk, G, T::BK) ||
      !encode<HV, T::CWV>(enc, &mv, v, B, Sk, G, T::BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_bf16_kernel<HD, HV, CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, T::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, G, window,
      (float)(1.4426950408889634 / std::sqrt((double)HD)));
  return (int)cudaGetLastError();
}

// equal dims, and MLA's published pairs
template <bool CAUSAL>
int launch_causal(const void* q, const void* k, const void* v, void* o, int B,
                  int Sq, int Sk, int H, int G, int hd, int hv, int window,
                  cudaStream_t stream) {
  if (hd == hv) {
    switch (hd) {
      case 32: return launch_hd<32, 32, CAUSAL>(q, k, v, o, B, Sq, Sk, H, G, window, stream);
      case 64: return launch_hd<64, 64, CAUSAL>(q, k, v, o, B, Sq, Sk, H, G, window, stream);
      case 128: return launch_hd<128, 128, CAUSAL>(q, k, v, o, B, Sq, Sk, H, G, window, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (hd == 192 && hv == 128)
    return launch_hd<192, 128, CAUSAL>(q, k, v, o, B, Sq, Sk, H, G, window, stream);
  if (hd == 96 && hv == 64)
    return launch_hd<96, 64, CAUSAL>(q, k, v, o, B, Sq, Sk, H, G, window, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// -- float32: split TF32 on the tensor cores ---------------------------------
namespace x3 {

using tc::Acc;
using tc::desc;
using tc::fence_regs;
using tc::mbar_arrive;
using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_u32;
using tc::tma_load;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait;

constexpr float NEG_INF = -1e30f;
constexpr int CW = 32;                 // floats of a 128-byte swizzled chunk row
constexpr int RB = 128;                // its bytes

// Per (hd, hv): consumer warpgroups NC (64 query rows each), keys a tile BK,
// depth of the ring of split tiles STAGES, and raw (unsplit) tile buffers
// RAW, chosen to fit the 227 KB a block may use (see the comment on top).
template <int HD, int HV> struct Cfg;
template <> struct Cfg<32, 32> { static constexpr int NC = 2, BK = 64, STAGES = 2, RAW = 2; };
template <> struct Cfg<64, 64> { static constexpr int NC = 2, BK = 32, STAGES = 3, RAW = 2; };
template <> struct Cfg<128, 128> { static constexpr int NC = 1, BK = 32, STAGES = 2, RAW = 1; };
template <> struct Cfg<192, 128> { static constexpr int NC = 1, BK = 32, STAGES = 1, RAW = 1; };
template <> struct Cfg<96, 64> { static constexpr int NC = 2, BK = 32, STAGES = 2, RAW = 2; };

template <int HD, int HV>
struct Tile {
  static constexpr int NC = Cfg<HD, HV>::NC, BK = Cfg<HD, HV>::BK;
  static constexpr int STAGES = Cfg<HD, HV>::STAGES, RAW = Cfg<HD, HV>::RAW;
  static constexpr int BQ = 64 * NC;
  static constexpr int CONSUMERS = 128 * NC, THREADS = CONSUMERS + 128;
  static constexpr int NCH = HD / CW, NCHV = HV / CW;  // chunks of a Q/K row, a V row
  static constexpr int Q_HALF = BQ * HD * 4;           // Q's big or small half
  static constexpr int K_HALF = BK * HD * 4;           // a tile's K, one half
  static constexpr int V_HALF = BK * HV * 4;           // a tile's V, one half
  // a stage: K big, K small, V^T big, V^T small; a raw buffer: K, then V
  static constexpr int STAGE = 2 * (K_HALF + V_HALF);
  static constexpr int RAW_BYTES = K_HALF + V_HALF;
  static constexpr int STAGE_OFF = 2 * Q_HALF;
  static constexpr int RAW_OFF = STAGE_OFF + STAGES * STAGE;
  static constexpr int BAR_OFF = RAW_OFF + RAW * RAW_BYTES;
  // + mbarriers and the last-block flag, + slack to align the base to 1024
  static constexpr int SMEM = BAR_OFF + 128 + 1024;
  static_assert(HD % CW == 0 && HV % CW == 0 && BK % CW == 0,
                "rows must cut into 128-byte chunks");
  static_assert(2 * STAGES + RAW + 2 <= 15, "mbarriers overflow their slot");
  static_assert(SMEM <= 232448, "one block an SM: 227 KB of shared memory");
};

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
// a float32 word with the low 13 bits clear
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xFFFFE000u);
}

// x -> its big half tf32(x) in place; s <- its small half tf32(x - big)
__device__ __forceinline__ void split(float4& x, float4& s) {
  float* a = reinterpret_cast<float*>(&x);
  float* b = reinterpret_cast<float*>(&s);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float big = tf32(a[e]);
    b[e] = tf32(a[e] - big);
    a[e] = big;
  }
}

// n float4s of src split into big (may be src) and small, by 128 threads
__device__ __forceinline__ void split_copy(const uint8_t* src, uint8_t* big,
                                           uint8_t* small, int n, int p) {
  for (int i = p; i < n; i += 128) {
    float4 x = reinterpret_cast<const float4*>(src)[i], s;
    split(x, s);
    reinterpret_cast<float4*>(big)[i] = x;
    reinterpret_cast<float4*>(small)[i] = s;
  }
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (+)= A B, m64nNk8, tf32 in, float32 out, both operands K-major, scale_d
// 0 overwrites D. A from shared memory or from registers (the m64k8
// fragment: a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4), g = 16 warp + lane / 4, t = lane % 4).
__device__ __forceinline__ void wgmma_tf32(Acc<32>& acc, uint64_t a, uint64_t b, int scale_d) {
  float* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(Acc<64>& acc, uint64_t a, uint64_t b, int scale_d) {
  float* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(Acc<32>& acc, const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  float* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(Acc<64>& acc, const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  float* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(Acc<128>& acc, const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  float* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The producer's copy of the block's key tile t_begin + i (K, then V) into
// raw buffer i % RAW, completing that buffer's mbarrier
template <typename T>
__device__ __forceinline__ void load_kv(uint8_t* sraw, uint64_t* loaded,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int i,
                                        int t_begin, int g, int b) {
  uint8_t* r = sraw + (i % T::RAW) * T::RAW_BYTES;
  uint64_t* bar = &loaded[i % T::RAW];
  const int k0 = (t_begin + i) * T::BK;
  mbar_expect_tx(bar, T::RAW_BYTES);
  for (int c = 0; c < T::NCH; ++c)
    tma_load(r + c * T::BK * RB, tm_k, bar, c * CW, g, k0, b);
  for (int c = 0; c < T::NCHV; ++c)
    tma_load(r + T::K_HALF + c * T::BK * RB, tm_v, bar, c * CW, g, k0, b);
}

template <int HD, int HV, bool CAUSAL>
__global__ void __launch_bounds__(Tile<HD, HV>::THREADS, 1)
flash_attention_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              float* __restrict__ o, float* __restrict__ ws,
                              int* __restrict__ counters, int Sq, int Sk,
                              int H, int G, int window, float scale_log2) {
  using T = Tile<HD, HV>;
  constexpr int BQ = T::BQ, BK = T::BK, STAGES = T::STAGES, RAW = T::RAW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // Q: NCH chunks of (BQ rows, 32 dims), its big half (TMA's tile split in
  // place), then its small half
  uint8_t* sq = base;
  // stage s: K big and K small, NCH chunks of (BK keys, 32 dims); then V^T
  // big and V^T small, BK / 32 chunks of (HV dims, 32 keys), the keys of
  // each group of 8 stored in the order 0 2 4 6 1 3 5 7
  uint8_t* sst = base + T::STAGE_OFF;
  // raw buffer r: K as TMA writes it (swizzled as K big), then V in NCHV
  // chunks of (BK keys, 32 dims), unswizzled
  uint8_t* sraw = base + T::RAW_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + T::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* loaded = empty + STAGES;
  uint64_t* qload = loaded + RAW;
  uint64_t* qready = qload + 1;
  int* last = reinterpret_cast<int*>(base + T::BAR_OFF + 120);

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int qt = gridDim.y - 1 - blockIdx.y;          // heaviest tiles first
  const int q0 = qt * BQ;
  const int g = h / (H / G);
  const int split_i = blockIdx.z, n_split = gridDim.z;
  // the block's key tiles: from the one holding row q0's lowest visible
  // key to the last one a row of the block sees, cut in n_split runs
  const int k_end = CAUSAL ? min(Sk, q0 + BQ) : Sk;
  const int t_lo = max(0, q0 - window + 1) / BK;
  const int t_hi = (k_end + BK - 1) / BK;
  const int per = (t_hi - t_lo + n_split - 1) / n_split;
  const int t_begin = min(t_hi, t_lo + split_i * per);
  const int n = min(t_hi, t_begin + per) - t_begin;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], T::CONSUMERS);
    }
    for (int r = 0; r < RAW; ++r) mbar_init(&loaded[r], 1);
    mbar_init(qload, 1);
    mbar_init(qready, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= T::CONSUMERS) {
    // producer warpgroup: one thread issues the copies, all 128 split them.
    // With two consumer warpgroups ptxas gives 168 registers a thread
    // (65536 / 384); the producer keeps 56 and the consumers take 224.
    if constexpr (T::NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int p = tid - T::CONSUMERS;
    if (p == 0) {
      mbar_expect_tx(qload, T::Q_HALF);
      for (int c = 0; c < T::NCH; ++c)
        tma_load(sq + c * BQ * RB, &tm_q, qload, c * CW, h, q0, b);
      if (n > 0) load_kv<T>(sraw, loaded, &tm_k, &tm_v, 0, t_begin, g, b);
    }
    // Q's rows past Sq (TMA's zeros) are not split: their small half is
    // left as it is, and rows do not mix in S, P or P V, nor are those
    // rows stored or combined
    const int q_rows = min(BQ, Sq - q0);
    mbar_wait(qload, 0);
    for (int c = 0; c < T::NCH; ++c) {
      uint8_t* qc = sq + c * BQ * RB;
      split_copy(qc, qc, qc + T::Q_HALF, q_rows * RB / 16, p);
    }
    fence_async_smem();
    mbar_arrive(qready);
    for (int i = 0; i < n; ++i) {
      if (RAW == 2 && p == 0 && i + 1 < n)
        load_kv<T>(sraw, loaded, &tm_k, &tm_v, i + 1, t_begin, g, b);
      const uint8_t* r = sraw + (i % RAW) * T::RAW_BYTES;
      const int s = i % STAGES;
      mbar_wait(&loaded[i % RAW], (i / RAW) & 1);
      mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);   // round 0 passes
      uint8_t* st = sst + s * T::STAGE;
      split_copy(r, st, st + T::K_HALF, T::K_HALF / 16, p);
      // V^T: item (key chunk kc, 16-byte unit u of a row, dim d), d
      // fastest: a warp reads 32 neighbouring floats of one key row and
      // writes 8 rows' units a phase, each in its own banks (the swizzle)
      const float* rv = reinterpret_cast<const float*>(r + T::K_HALF);
      uint8_t* vb = st + 2 * T::K_HALF;
      for (int it = p; it < BK * HV / 4; it += 128) {
        const int d = it % HV, u = (it / HV) % 8, kc = it / (HV * 8);
        // unit u holds positions 4u .. 4u + 3 of its 32 keys: keys 0 2 4 6
        // of group u / 2 for even u, keys 1 3 5 7 for odd u
        const int key = 32 * kc + 8 * (u / 2) + (u % 2);
        const float* src = rv + (d / CW) * BK * CW + key * CW + d % CW;
        float4 x = make_float4(src[0], src[2 * CW], src[4 * CW], src[6 * CW]), sm;
        split(x, sm);
        const int off = kc * HV * RB + d * RB + ((u ^ (d % 8)) * 16);
        *reinterpret_cast<float4*>(vb + off) = x;
        *reinterpret_cast<float4*>(vb + T::V_HALF + off) = sm;
      }
      fence_async_smem();
      mbar_arrive(&full[s]);
      bar_sync(1, 128);                       // raw i % RAW read by all
      if (RAW == 1 && p == 0 && i + 1 < n)
        load_kv<T>(sraw, loaded, &tm_k, &tm_v, i + 1, t_begin, g, b);
    }
  } else {
    // consumer warpgroups: wg owns rows q0 + 64 wg .. + 63
    if constexpr (T::NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int first = q0 + 64 * wg;
    const int r0 = first + 16 * warp + lane / 4;        // and r0 + 8
    const int cq = 2 * (lane % 4);
    const uint8_t* qb = sq + 64 * wg * RB;
    const uint8_t* qs = qb + T::Q_HALF;
    // descriptor offsets of k8 slice kk (32 bytes, 8 floats, in 128-byte
    // chunk rows): of Q's and K's hd slices, and of V^T's key slices
    auto q_slice = [](int kk) { return static_cast<uint64_t>(((kk / 4) * BQ * RB + (kk % 4) * 32) >> 4); };
    auto k_slice = [](int kk) { return static_cast<uint64_t>(((kk / 4) * BK * RB + (kk % 4) * 32) >> 4); };
    auto v_slice = [](int j) { return static_cast<uint64_t>(((j / 4) * HV * RB + (j % 4) * 32) >> 4); };

    Acc<HV> acc;
#pragma unroll
    for (int i = 0; i < HV / 2; ++i) acc.d[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    if (n > 0) mbar_wait(qready, 0);

    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES, k0 = (t_begin + i) * BK;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint8_t* kb = sst + s * T::STAGE;
      const uint8_t* ks = kb + T::K_HALF;
      const uint8_t* vb = kb + 2 * T::K_HALF;
      const uint8_t* vs = vb + T::V_HALF;
      // else wholly masked for this wg: its rows past Sq, above the
      // diagonal, or left of the window of its first (and every) row
      if (first < Sq && (!CAUSAL || k0 <= first + 63) &&
          first - (k0 + BK - 1) < window) {
        // S = Q_s K_b + Q_b K_s + Q_b K_b over hd / 8 slices, small first.
        // Each slice's descriptor is its operand's base descriptor plus the
        // slice's offset / 16 (the address field); the bases are made
        // opaque in every tile, so that the 6 hd / 8 slice descriptors are
        // not hoisted out of the loop to stay live through P V
        uint64_t dqs = desc<RB>(qs, 16), dqb = desc<RB>(qb, 16);
        uint64_t dkb = desc<RB>(kb, 16), dks = desc<RB>(ks, 16);
        asm volatile("" : "+l"(dqs), "+l"(dqb), "+l"(dkb), "+l"(dks));
        Acc<BK> sc;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk)
          wgmma_tf32(sc, dqs + q_slice(kk), dkb + k_slice(kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk)
          wgmma_tf32(sc, dqb + q_slice(kk), dks + k_slice(kk), 1);
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk)
          wgmma_tf32(sc, dqb + q_slice(kk), dkb + k_slice(kk), 1);
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);

        // online softmax in base 2 on the two rows this thread holds, as
        // the bf16 kernel
        const bool edge = (CAUSAL && k0 + BK - 1 > first) || k0 + BK > Sk ||
                          first + 63 - k0 >= window;
        float mx[2] = {NEG_INF, NEG_INF};
        if (edge) {
          int kof[2];
          uint32_t span[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r0 + 8 * r, lo = row - window + 1;
            const int hi = CAUSAL ? min(row, Sk - 1) : Sk - 1;
            kof[r] = k0 + cq - lo;
            span[r] = static_cast<uint32_t>(hi - lo);
          }
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float x = sc.d[4 * j + 2 * r + e] * scale_log2;
                if (static_cast<uint32_t>(8 * j + e + kof[r]) > span[r])
                  x = NEG_INF;
                sc.d[4 * j + 2 * r + e] = x;
                mx[r] = fmaxf(mx[r], x);
              }
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float x = sc.d[4 * j + 2 * r + e] * scale_log2;
                sc.d[4 * j + 2 * r + e] = x;
                mx[r] = fmaxf(mx[r], x);
              }
            }
          }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          alpha[r] = exp2f(m[r] - m_new);
          m[r] = m_new;
          l[r] *= alpha[r];
        }
        // p, its row sums, and its split into the A fragments of P_b and
        // P_s: slice j's fragment takes this thread's keys 8j + cq (as
        // columns t: a0 row r0, a1 row r0 + 8) and 8j + cq + 1 (as columns
        // t + 4: a2, a3), which V^T's key order 0 2 4 6 1 3 5 7 matches
        uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = exp2f(sc.d[4 * j + 2 * r + e] - m[r]);
              l[r] += x;
              const float big = tf32(x);
              pb[j][r + 2 * e] = __float_as_uint(big);
              ps[j][r + 2 * e] = __float_as_uint(tf32(x - big));
            }
          }
        }
        // the tile's P V = P_s V_b + P_b V_s + P_b V_b over BK / 8 slices,
        // small first, into an accumulator of its own: the tensor cores add
        // each k8 step to D with truncation, so D only ever sums one tile
        // (3 BK / 8 steps), and O = alpha O + the tile, rounded to nearest
        // on the CUDA cores
        uint64_t dvb = desc<RB>(vb, 16), dvs = desc<RB>(vs, 16);
        asm volatile("" : "+l"(dvb), "+l"(dvs));
        Acc<HV> pv;
        fence_regs(pv);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          wgmma_tf32(pv, ps[j], dvb + v_slice(j), j > 0);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          wgmma_tf32(pv, pb[j], dvs + v_slice(j), 1);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          wgmma_tf32(pv, pb[j], dvb + v_slice(j), 1);
        wgmma_commit();
        wgmma_wait();
        fence_regs(pv);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          fence_regs(pb[j]);
          fence_regs(ps[j]);
        }
#pragma unroll
        for (int j = 0; j < HV / 8; ++j) {
          acc.d[4 * j] = fmaf(acc.d[4 * j], alpha[0], pv.d[4 * j]);
          acc.d[4 * j + 1] = fmaf(acc.d[4 * j + 1], alpha[0], pv.d[4 * j + 1]);
          acc.d[4 * j + 2] = fmaf(acc.d[4 * j + 2], alpha[1], pv.d[4 * j + 2]);
          acc.d[4 * j + 3] = fmaf(acc.d[4 * j + 3], alpha[1], pv.d[4 * j + 3]);
        }
      }
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (n_split == 1) {                       // out = acc / l, rows past Sq dropped
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= Sq) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        float* orow = o + ((static_cast<size_t>(b) * Sq + row) * H + h) * HV;
#pragma unroll
        for (int j = 0; j < HV / 8; ++j)
          *reinterpret_cast<float2*>(orow + 8 * j + cq) =
              make_float2(acc.d[4 * j + 2 * r] * inv, acc.d[4 * j + 2 * r + 1] * inv);
      }
      return;
    }

    // a key split: this block's (acc, m, l) to the workspace; the last of
    // the tile's n_split blocks to arrive rescales them to their common max
    // and adds them in split order, then resets the tile's counter
    const int tile = (b * H + h) * gridDim.y + qt;
    constexpr int PART = BQ * (HV + 2);
    float* part = ws + (static_cast<size_t>(tile) * n_split + split_i) * PART;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r, lr = row - q0;
      if (row >= Sq) continue;
#pragma unroll
      for (int j = 0; j < HV / 8; ++j)
        *reinterpret_cast<float2*>(part + lr * HV + 8 * j + cq) =
            make_float2(acc.d[4 * j + 2 * r], acc.d[4 * j + 2 * r + 1]);
      if (cq == 0) {
        part[BQ * HV + lr] = m[r];
        part[BQ * HV + BQ + lr] = l[r];
      }
    }
    __threadfence();
    bar_sync(2, T::CONSUMERS);
    if (tid == 0) *last = atomicAdd(&counters[tile], 1) == n_split - 1;
    bar_sync(2, T::CONSUMERS);
    if (!*last) return;
    __threadfence();
    if (tid == 0) counters[tile] = 0;
    const float* tw = ws + static_cast<size_t>(tile) * n_split * PART;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r, lr = row - q0;
      if (row >= Sq) continue;
      float mu = NEG_INF;
      for (int k = 0; k < n_split; ++k)
        mu = fmaxf(mu, __ldcg(tw + k * PART + BQ * HV + lr));
      float lsum = 0.f, out[HV / 4];
#pragma unroll
      for (int c = 0; c < HV / 4; ++c) out[c] = 0.f;
      for (int k = 0; k < n_split; ++k) {
        const float* pk = tw + k * PART;
        const float w = exp2f(__ldcg(pk + BQ * HV + lr) - mu);
        lsum += __ldcg(pk + BQ * HV + BQ + lr) * w;
#pragma unroll
        for (int j = 0; j < HV / 8; ++j) {
          const float2 a = __ldcg(reinterpret_cast<const float2*>(pk + lr * HV + 8 * j + cq));
          out[2 * j] += a.x * w;
          out[2 * j + 1] += a.y * w;
        }
      }
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      float* orow = o + ((static_cast<size_t>(b) * Sq + row) * H + h) * HV;
#pragma unroll
      for (int j = 0; j < HV / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j + cq) =
            make_float2(out[2 * j] * inv, out[2 * j + 1] * inv);
    }
  }
}

// A tensor map over a (B, S, heads, row) float32 tensor whose box is `rows`
// positions of one head, 32 dims at a time: 128-byte swizzled (the layout
// wgmma reads) or plain (V, which the producer transposes).
bool encode(tc::EncodeTiled enc, CUtensorMap* map, const void* ptr, int row,
            int B, int S, int heads, int rows, bool swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)row, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {row * 4ull, (cuuint64_t)heads * row * 4,
                                 (cuuint64_t)S * heads * row * 4};
  const cuuint32_t box[4] = {(cuuint32_t)CW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// The key split of a launch, from its shape alone: 1 where the query tiles
// B H ceil(Sq / BQ) fill the card's SMs (one block an SM); else the SMs a
// tile, at most half the key tiles of the heaviest query tile (the last),
// so that each run has two tiles or more.
template <int HD, int HV>
int splits(int B, int Sq, int Sk, int H, bool causal, int window) {
  using T = Tile<HD, HV>;
  const int nq = (Sq + T::BQ - 1) / T::BQ;
  const long long tiles = (long long)B * H * nq;
  const int sms = sm_count();
  if (sms <= 0 || tiles >= sms) return 1;
  const int q0 = (nq - 1) * T::BQ;
  const int k_end = causal ? min(Sk, q0 + T::BQ) : Sk;
  const int n_kt = (k_end + T::BK - 1) / T::BK - max(0, q0 - window + 1) / T::BK;
  return max(1, min(static_cast<int>(sms / tiles), n_kt / 2));
}

template <int HD, int HV, bool CAUSAL>
int launch_hd(const float* q, const float* k, const float* v, float* o,
              float* ws, int* counters, int B, int Sq, int Sk, int H, int G,
              int window, cudaStream_t stream) {
  using T = Tile<HD, HV>;
  const tc::EncodeTiled enc = tc::encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!encode(enc, &mq, q, HD, B, Sq, H, T::BQ, true) ||
      !encode(enc, &mk, k, HD, B, Sk, G, T::BK, true) ||
      !encode(enc, &mv, v, HV, B, Sk, G, T::BK, false))
    return (int)cudaErrorInvalidValue;
  const int ns = splits<HD, HV>(B, Sq, Sk, H, CAUSAL, window);
  if (ns > 1 && (ws == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_tf32x3_kernel<HD, HV, CAUSAL>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Sq + T::BQ - 1) / T::BQ, ns);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      mq, mk, mv, o, ws, counters, Sq, Sk, H, G, window,
      (float)(1.4426950408889634 / std::sqrt((double)HD)));
  return (int)cudaGetLastError();
}

// float32 at the five published pairs; (80, 64) and anything else are
// not this kernel's
template <bool CAUSAL>
int launch_causal(const float* q, const float* k, const float* v, float* o,
                  float* ws, int* counters, int B, int Sq, int Sk, int H, int G,
                  int hd, int hv, int window, cudaStream_t stream) {
  if (hd == 32 && hv == 32)
    return launch_hd<32, 32, CAUSAL>(q, k, v, o, ws, counters, B, Sq, Sk, H, G, window, stream);
  if (hd == 64 && hv == 64)
    return launch_hd<64, 64, CAUSAL>(q, k, v, o, ws, counters, B, Sq, Sk, H, G, window, stream);
  if (hd == 128 && hv == 128)
    return launch_hd<128, 128, CAUSAL>(q, k, v, o, ws, counters, B, Sq, Sk, H, G, window, stream);
  if (hd == 192 && hv == 128)
    return launch_hd<192, 128, CAUSAL>(q, k, v, o, ws, counters, B, Sq, Sk, H, G, window, stream);
  if (hd == 96 && hv == 64)
    return launch_hd<96, 64, CAUSAL>(q, k, v, o, ws, counters, B, Sq, Sk, H, G, window, stream);
  return (int)cudaErrorInvalidValue;
}

// (key splits, workspace floats, zeroed int counters) of a launch; splits
// -1 for a pair this kernel does not take
struct Plan {
  int splits, ws, counters;
};

template <int HD, int HV>
Plan plan_hd(int B, int Sq, int Sk, int H, bool causal, int window) {
  using T = Tile<HD, HV>;
  const int ns = splits<HD, HV>(B, Sq, Sk, H, causal, window);
  const int tiles = B * H * ((Sq + T::BQ - 1) / T::BQ);
  if (ns == 1) return {1, 0, 0};
  return {ns, tiles * ns * T::BQ * (HV + 2), tiles};
}

Plan plan(int B, int Sq, int Sk, int H, int hd, int hv, bool causal, int window) {
  if (hd == 32 && hv == 32) return plan_hd<32, 32>(B, Sq, Sk, H, causal, window);
  if (hd == 64 && hv == 64) return plan_hd<64, 64>(B, Sq, Sk, H, causal, window);
  if (hd == 128 && hv == 128) return plan_hd<128, 128>(B, Sq, Sk, H, causal, window);
  if (hd == 192 && hv == 128) return plan_hd<192, 128>(B, Sq, Sk, H, causal, window);
  if (hd == 96 && hv == 64) return plan_hd<96, 64>(B, Sq, Sk, H, causal, window);
  return {-1, 0, 0};
}

int smem(int hd, int hv) {
  if (hd == 32 && hv == 32) return Tile<32, 32>::SMEM;
  if (hd == 64 && hv == 64) return Tile<64, 64>::SMEM;
  if (hd == 128 && hv == 128) return Tile<128, 128>::SMEM;
  if (hd == 192 && hv == 128) return Tile<192, 128>::SMEM;
  if (hd == 96 && hv == 64) return Tile<96, 64>::SMEM;
  return -1;
}

}  // namespace x3

// a window must leave every row a key: Sq < Sk + window
bool bad_shape(int B, int Sq, int Sk, int H, int G, int window) {
  return B < 1 || Sq < 1 || Sk < 1 || G < 1 || H % G != 0 || window < 0 ||
         (window > 0 && (long long)Sq >= (long long)Sk + window);
}

// the kernels' window: 0 (none) as 2^30, beyond any position difference
int kernel_window(int window) { return window > 0 ? window : 1 << 30; }

}  // namespace

// float32: the five published pairs on the tensor cores in split TF32 (a
// key split where the query tiles leave SMs idle: `ws` and `counters` as
// `flash_attention_f32_workspace` and `_counters` size them, null where
// those are 0); the reduced configs' (80, 64) on the CUDA cores
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v,
                                   float* o, float* ws, int* counters, int B,
                                   int Sq, int Sk, int H, int G, int hd, int hv,
                                   int causal, int window, cudaStream_t stream) {
  if (bad_shape(B, Sq, Sk, H, G, window)) return (int)cudaErrorInvalidValue;
  const int w = kernel_window(window);
  if (hd == 80 && hv == 64)
    return causal ? f32::launch_hd<float, 80, 64, true>(q, k, v, o, B, Sq, Sk, H, G, w, stream)
                  : f32::launch_hd<float, 80, 64, false>(q, k, v, o, B, Sq, Sk, H, G, w, stream);
  return causal ? x3::launch_causal<true>(q, k, v, o, ws, counters, B, Sq, Sk, H, G, hd, hv, w, stream)
                : x3::launch_causal<false>(q, k, v, o, ws, counters, B, Sq, Sk, H, G, hd, hv, w, stream);
}

// The float32 kernel's key splits at a launch's shape (1: none; -1 for a
// pair no kernel takes), and the workspace floats and zeroed int counters
// the launch needs (0 without a split).
extern "C" int flash_attention_f32_splits(int B, int Sq, int Sk, int H, int hd,
                                          int hv, int causal, int window) {
  if (hd == 80 && hv == 64) return 1;
  return x3::plan(B, Sq, Sk, H, hd, hv, causal, kernel_window(window)).splits;
}

extern "C" int flash_attention_f32_workspace(int B, int Sq, int Sk, int H, int hd,
                                             int hv, int causal, int window) {
  if (hd == 80 && hv == 64) return 0;
  return x3::plan(B, Sq, Sk, H, hd, hv, causal, kernel_window(window)).ws;
}

extern "C" int flash_attention_f32_counters(int B, int Sq, int Sk, int H, int hd,
                                            int hv, int causal, int window) {
  if (hd == 80 && hv == 64) return 0;
  return x3::plan(B, Sq, Sk, H, hd, hv, causal, kernel_window(window)).counters;
}

// Dynamic shared memory of the float32 tensor-core kernel at (hd, hv), in
// bytes; -1 for a pair it does not take.
extern "C" int flash_attention_f32_smem(int hd, int hv) { return x3::smem(hd, hv); }

// bf16: equal dims and MLA's published pairs on the tensor cores; the
// reduced configs' (80, 64) on the CUDA cores
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int B, int Sq, int Sk, int H, int G,
                                    int hd, int hv, int causal, int window,
                                    cudaStream_t stream) {
  if (bad_shape(B, Sq, Sk, H, G, window)) return (int)cudaErrorInvalidValue;
  const int w = kernel_window(window);
  if (hd == 80 && hv == 64) {
    using T = __nv_bfloat16;
    const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
            *tv = static_cast<const T*>(v);
    T* to = static_cast<T*>(o);
    return causal ? f32::launch_hd<T, 80, 64, true>(tq, tk, tv, to, B, Sq, Sk, H, G, w, stream)
                  : f32::launch_hd<T, 80, 64, false>(tq, tk, tv, to, B, Sq, Sk, H, G, w, stream);
  }
  return causal ? tc::launch_causal<true>(q, k, v, o, B, Sq, Sk, H, G, hd, hv, w, stream)
                : tc::launch_causal<false>(q, k, v, o, B, Sq, Sk, H, G, hd, hv, w, stream);
}

// Dynamic shared memory of the bf16 kernel at (hd, hv), in bytes; -1 for a
// pair it does not take.
extern "C" int flash_attention_bf16_smem(int hd, int hv) {
  if (hd == hv) {
    switch (hd) {
      case 32: return tc::Tile<32, 32>::SMEM;
      case 64: return tc::Tile<64, 64>::SMEM;
      case 128: return tc::Tile<128, 128>::SMEM;
      default: return -1;
    }
  }
  if (hd == 192 && hv == 128) return tc::Tile<192, 128>::SMEM;
  if (hd == 96 && hv == 64) return tc::Tile<96, 64>::SMEM;
  return -1;
}
