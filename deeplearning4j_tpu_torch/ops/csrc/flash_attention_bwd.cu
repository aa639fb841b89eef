// Flash-attention backward for NVIDIA Hopper (sm_90a): two kernels in the
// FlashAttention-2 split that the TPU kernels use.
//  * K4 (`dl4j_flash_bwd_dq`) replaces `_bwd_dq_kernel` in
//    deeplearning4j_tpu/ops/flash_attention.py (launched by `_flash_bwd_dq_pass`
//    from `_flash_bwd_bthd`): dQ = sum_j dS_ij K_j * scale, with the kv loop
//    innermost and dQ in f32 registers across it.
//  * K5 (`dl4j_flash_bwd_dkv`) replaces `_bwd_dkv_kernel` (`_flash_bwd_dkv_pass`):
//    dV = sum_i P_ij^T dO_i and dK = sum_i dS_ij^T Q_i * scale, with the q loop
//    innermost and dK, dV in f32 registers across it.
// Neither uses atomics: every output element has one owner, so the gradients
// are deterministic. Both also serve ring attention's backward
// (`flash_attention_bwd_partial`, which launches the TPU kernels with nonzero
// SMEM offsets and f32 outputs): q_off and k_off, the global positions of the
// q chunk's and the kv chunk's first rows, move the causal mask to
// q_off + i >= k_off + j, and the output type is a template parameter, the
// input type or f32. An f32 output is stored straight from the f32
// accumulators, so the ring rounds once after its last hop.
//
// Given the forward's residuals (q, k, v, the per-row logsumexp lse from K2)
// and delta = rowsum(dO * O) (computed once, outside), each (query i, key j)
// pair is rebuilt without a second softmax:
//   s = q_i . k_j                       f32 product of the input type
//   p = exp(s * scale - lse_i)          f32; 0 where masked (causal: k_off + j > q_off + i;
//                                       or out of bounds)
//   dp = dO_i . v_j                     f32 accumulation
//   ds = p * (dp - delta_i)             f32
// The dQ and dK products take ds rounded to the input type and the dV product
// takes p rounded to the input type, each accumulated in f32; dQ and dK are
// multiplied by scale after the product. Outputs are rounded once to the output
// type. That is where the TPU kernels round. The 16-bit kernels take the
// exponential as one ex2 of s * (scale * log2 e) - lse * log2 e, with lse
// converted to log2 units once per row; the f32 kernels as expf of the
// rounded s * scale - lse.
//
// Bound on an H100 SXM at the training shape (B=4, T=8192, H=8, D=64, bf16,
// causal), with 1.074e9 (query, key) pairs: K4 does 6*D FLOP per pair (s, dp,
// dQ), 4.12e11 FLOP, 0.417 ms at 989 TFLOP/s; K5 8*D (s, dp, dV, dK), 5.50e11,
// 0.556 ms; each moves ~0.2 GB (~0.06 ms at 3.35 TB/s). Compute-bound: the
// products go through the tensor cores. At one visible ring hop of T=8192 over
// a ring of 4 (Tq=Tk=2048, f32 outputs): K4 5.15e10 FLOP, 0.052 ms; K5
// 6.87e10, 0.069 ms; both still compute-bound. The split recomputes s and dp
// in both kernels (14*D FLOP per pair where one fused pass needs 10*D): that
// is the TPU kernels' design, kept here.
//
// Design:
//  * bf16/fp16 (D in {16, 32, 64, 128}): one Hopper kernel each, in the shape
//    of the forward's `flash_fwd_hopper_kernel` and built from the same pieces
//    (hopper.cuh):
//    - warp roles: warpgroup 0 is the producer: it drops to 24 registers
//      (setmaxnreg) and one of its threads issues every TMA load; two
//      consumer warpgroups rise to 240 registers and own 64 rows of the
//      block's own tile each: queries in K4, keys in K5;
//    - loads: TMA over 4-D tensor maps of the strided [B, T, H, D] inputs.
//      The block's own tiles (Q and dO in K4; K and V in K5) arrive once; the
//      other side (K and V in K4; Q and dO in K5) streams through a ring of
//      full/empty mbarriers, as in the forward. Rows past T arrive as zeros;
//    - K4, per kv tile of 128 keys (64 at D = 128): S = Q K^T and dP = dO V^T
//      on shared-memory wgmma (both operands K-major); dS on the accumulator
//      fragments, rounded and packed as register-A fragments; dQ += dS K on
//      register-A wgmma with K read MN-major (the transpose bit) from the tile
//      that S read K-major. lse and delta of the warp's rows are read once;
//    - K5, per q tile of 64 queries (32 at D = 128): S^T = K Q^T and
//      dP^T = V dO^T on shared-memory wgmma; P^T and dS^T on the fragments;
//      dV += P^T dO and dK += dS^T Q on register-A wgmma, dO and Q read
//      MN-major from the tiles the score products read K-major. The
//      producer's second warp stages each q tile's lse (in log2 units) and
//      delta into the ring's stage with plain loads (a TMA map over the f32
//      [B*H, T] rows needs T * 4 to be a multiple of 16) and arrives on the
//      stage's full barrier beside the TMA;
//    - a consumer waits for each tile's last products and then releases the
//      stage; every consumer runs every tile of the block's loop (a tile it
//      cannot see is masked whole). Leaving the last products in flight
//      across the next tile's score products, as the forward does, or
//      skipping a consumer's hidden tiles made ptxas serialise every wgmma
//      (C7515: a wait after each) and cost 1.4x (PERF.md, PR 5).
//  * f32: the same arithmetic in plain f32 FMA (no TF32), with small tiles in
//    shared memory and one thread per (query, key) pair for s and dp.
//  * Causal: K4's kv loop stops at the last tile holding a key its queries may
//    see; K5's q loop starts at the first tile holding a query that may see
//    its keys (the diagonal tiles at equal offsets). A block whose loop is
//    empty (a causal K4 tile before k_off, a K5 tile past the last query, the
//    ring's wholly masked hop) issues no load, waits on nothing and writes
//    zeros. The heaviest tiles are scheduled first.
//  * Any T: a padded key or query row never reaches another row's output. In
//    K4 the tiles that reach past T, or cross the causal diagonal, mask by
//    position (p = 0); in K5 a padded query's lse is staged as +inf, so its
//    p is exactly 0, and the causal diagonal tiles mask by position. The f32
//    kernels mask both axes by bounds.
#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kF32Rows = 16;  // f32 path: rows of a block's own tile
template <int D>
constexpr int kF32StreamRows = D <= 64 ? 32 : 16;
constexpr float kLog2e = 1.4426950408889634f;

// Which (query, key) pairs take part: both in bounds, and, when causal, the
// key's global position k_off + key at most the query's q_off + query
// (dlt = q_off - k_off). Every other pair gets p = 0.
struct PairMask {
  int seq_len, causal, dlt;
  __device__ __forceinline__ bool keep(int query, int key) const {
    return query < seq_len && key < seq_len && !(causal && key > query + dlt);
  }
};

// K4: the number of kv tiles of `tile` keys that hold a key which a query in
// [0, last_q] may see (all of them when not causal).
__device__ __forceinline__ int n_kv_tiles(const PairMask& m, int last_q, int tile) {
  const int last_key = m.causal ? min(m.seq_len - 1, last_q + m.dlt) : m.seq_len - 1;
  return last_key < 0 ? 0 : last_key / tile + 1;
}

// K5: the first q tile of `tile` queries that holds a query which may see a
// key at or after `first_key`.
__device__ __forceinline__ int first_q_tile(const PairMask& m, int first_key, int tile) {
  return m.causal ? max(0, first_key - m.dlt) / tile : 0;
}

// ------------------------------------------------ K4, K5: the Hopper kernels

// Tiles of the Hopper backward kernels for head dim D, K4 (kDq) or K5. A
// block: a producer warpgroup and two consumer warpgroups of 64 own rows.
template <int D, bool kDq>
struct BwdTiles {
  static constexpr int kConsumers = 2;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  // after setmaxnreg: 128 * 24 + 256 * 240 = 64,512 of the SM's 65,536
  static constexpr int kConsumerRegs = 240;
  static constexpr int kOwnRows = 64 * kConsumers;  // queries (K4) or keys (K5)
  // rows of a streamed tile: keys (K4) or queries (K5); halved at D = 128,
  // where dQ (K4) or dK and dV (K5) take twice the accumulators
  static constexpr int kStreamRows = (kDq ? 128 : 64) / (D == 128 ? 2 : 1);
  static constexpr int kStages = kDq && D == 128 ? 2 : 4;
  static constexpr int kBoxCols = D < 64 ? D : 64;  // columns of one TMA box
  static constexpr int kRowBytes = kBoxCols * 2;    // 32, 64 or 128: the swizzle
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kOwnBytes = kOwnRows * D * 2;        // one own tile
  static constexpr int kStreamBytes = kStreamRows * D * 2;  // one streamed tile
  // K5's stages also hold their q tile's lse (log2 units) and delta, f32
  static constexpr int kStatBytes = kDq ? 0 : 2 * kStreamRows * 4;
  static constexpr int kStatOffset = 2 * kOwnBytes + 2 * kStages * kStreamBytes;
  static constexpr int kBarOffset = kStatOffset + kStages * kStatBytes;
  // + 1024 to align the tiles to a 1024-byte swizzle atom; barriers after:
  // own tiles' "full", then full[kStages], empty[kStages]
  static constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

// K4 for one (batch*head, 128-query tile). q, k, v, dout are read through 4-D
// tensor maps over [B, T, H, D]; lse and delta are f32 [batch*heads, T].
template <typename Elem, typename Out, int D>
__global__ void __launch_bounds__(BwdTiles<D, true>::kThreads, 1)
    flash_bwd_dq_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               Out* __restrict__ dq, int heads, int seq_len, Strides sdq,
                               float scale, int causal, int q_off, int k_off) {
  using L = BwdTiles<D, true>;
  constexpr int BQ = L::kOwnRows, BK = L::kStreamRows, S = L::kStages, CB = L::kBoxCols;
  constexpr int kLayout = swizzle_layout(L::kRowBytes);
  constexpr uint32_t kSbo = 8 * L::kRowBytes;  // 8-row group stride
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                        // Q: kBoxes boxes of [BQ][CB]
  const uint32_t do_s = q_s + L::kOwnBytes;         // dO, the same
  const uint32_t k_s = do_s + L::kOwnBytes;         // K stage s: + s * kStreamBytes
  const uint32_t v_s = k_s + S * L::kStreamBytes;   // V stage s: + s * kStreamBytes
  const uint32_t own_full = base + L::kBarOffset;   // barriers, 8 bytes each
  const uint32_t full = own_full + 8;               // full[s]: + 8 s
  const uint32_t empty = full + 8 * S;              // empty[s]: + 8 s

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int dlt = q_off - k_off;  // causal: key j is masked for query i when j > i + dlt
  const PairMask mask{seq_len, causal, dlt};
  const int n_kv = n_kv_tiles(mask, min(seq_len, q_start + BQ) - 1, BK);

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * L::kConsumers);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread loads Q and dO once, then keeps the K/V ring full.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_kv > 0) {
      mbar_expect_tx(own_full, 2 * L::kOwnBytes);
#pragma unroll
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_4d(q_s + c * BQ * L::kRowBytes, &tq, own_full, c * CB, h, q_start, b);
        tma_load_4d(do_s + c * BQ * L::kRowBytes, &tdo, own_full, c * CB, h, q_start, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty + 8 * s, ((j / S) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kStreamBytes);
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c) {
          const uint32_t box = s * L::kStreamBytes + c * BK * L::kRowBytes;
          tma_load_4d(k_s + box, &tk, full + 8 * s, c * CB, h, j * BK, b);
          tma_load_4d(v_s + box, &tv, full + 8 * s, c * CB, h, j * BK, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<L::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int wg_row0 = q_start + 64 * cw;
    const int row0 = wg_row0 + 16 * warp + g, row1 = row0 + 8;
    // a kv tile needs no mask when every key in it is < seq_len and, causal,
    // visible to this warpgroup's first row
    const int clear_to = causal ? min(seq_len, wg_row0 + dlt + 1) : seq_len;
    // a padded row's dQ is never stored: its statistics may read as 0
    const float* lb = lse + static_cast<long long>(bh) * seq_len;
    const float* db = delta + static_cast<long long>(bh) * seq_len;
    const float lse0 = row0 < seq_len ? lb[row0] * kLog2e : 0.f;
    const float lse1 = row1 < seq_len ? lb[row1] * kLog2e : 0.f;
    const float dl0 = row0 < seq_len ? db[row0] : 0.f, dl1 = row1 < seq_len ? db[row1] : 0.f;
    const float sl = scale * kLog2e;  // scores into log2 units: each p is one ex2

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t q_wg = q_s + 64 * cw * L::kRowBytes;  // this warpgroup's rows
    const uint32_t do_wg = do_s + 64 * cw * L::kRowBytes;
    if (n_kv > 0) mbar_wait(own_full, 0);

    for (int j = 0; j < n_kv; ++j) {
      const int s = j % S;
      const int k_start = j * BK;
      mbar_wait(full + 8 * s, (j / S) & 1);

      // S = Q K^T and dP = dO V^T: D/16 slices of 16 columns, all K-major.
      float sc[BK / 2], dp[BK / 2];
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk * 16 % CB) * 2;  // bytes into a row
        const uint32_t own = (kk * 16 / CB) * BQ * L::kRowBytes + col;
        const uint32_t stream = s * L::kStreamBytes + (kk * 16 / CB) * BK * L::kRowBytes + col;
        wgmma_ss<Elem, BK>(sc, wgmma_desc(q_wg + own, 16, kSbo, kLayout),
                           wgmma_desc(k_s + stream, 16, kSbo, kLayout), kk);
        wgmma_ss<Elem, BK>(dp, wgmma_desc(do_wg + own, 16, kSbo, kLayout),
                           wgmma_desc(v_s + stream, 16, kSbo, kLayout), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // ds = p * (dp - delta), p = exp2(s * scale * log2 e - lse * log2 e); kept in sc
      const bool masked = k_start + BK > clear_to;
#pragma unroll
      for (int n8 = 0; n8 < BK / 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = ex2_approx(sc[4 * n8 + e] * sl - lse0);
          float p1 = ex2_approx(sc[4 * n8 + 2 + e] * sl - lse1);
          if (masked) {
            const int key = k_start + n8 * 8 + 2 * t + e;
            if (!mask.keep(row0, key)) p0 = 0.f;
            if (!mask.keep(row1, key)) p1 = 0.f;
          }
          sc[4 * n8 + e] = p0 * (dp[4 * n8 + e] - dl0);
          sc[4 * n8 + 2 + e] = p1 * (dp[4 * n8 + 2 + e] - dl1);
        }
      }

      // dQ += dS K: dS rounded to Elem straight from the fragments (register
      // A), K MN-major from the stage as TMA wrote it.
      uint32_t dsa[BK / 16][4];
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) c_to_a<Elem>(dsa[kc], &sc[8 * kc], &sc[8 * kc + 4]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const uint32_t kb = k_s + s * L::kStreamBytes + kc * 16 * L::kRowBytes;
        wgmma_rs_t<Elem, D>(acc, dsa[kc], wgmma_desc(kb, BK * L::kRowBytes, kSbo, kLayout));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);  // the stage's K and V have been read
    }

    Out* out = dq + b * sdq.b + h * sdq.h;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      const int c = n8 * 8 + 2 * t;
      if (row0 < seq_len)
        store2(out + row0 * sdq.t + c, acc[4 * n8] * scale, acc[4 * n8 + 1] * scale);
      if (row1 < seq_len)
        store2(out + row1 * sdq.t + c, acc[4 * n8 + 2] * scale, acc[4 * n8 + 3] * scale);
    }
  }
}

// K5 for one (batch*head, 128-key tile), on transposed panels: S^T = K Q^T and
// dP^T = V dO^T, rows = a consumer's 64 keys, columns = the q tile's queries.
template <typename Elem, typename Out, int D>
__global__ void __launch_bounds__(BwdTiles<D, false>::kThreads, 1)
    flash_bwd_dkv_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                Out* __restrict__ dk, Out* __restrict__ dv, int heads,
                                int seq_len, Strides sdk, Strides sdv, float scale, int causal,
                                int q_off, int k_off) {
  using L = BwdTiles<D, false>;
  constexpr int BK = L::kOwnRows, BQ = L::kStreamRows, S = L::kStages, CB = L::kBoxCols;
  constexpr int kLayout = swizzle_layout(L::kRowBytes);
  constexpr uint32_t kSbo = 8 * L::kRowBytes;  // 8-row group stride
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;                        // K: kBoxes boxes of [BK][CB]
  const uint32_t v_s = k_s + L::kOwnBytes;          // V, the same
  const uint32_t q_s = v_s + L::kOwnBytes;          // Q stage s: + s * kStreamBytes
  const uint32_t do_s = q_s + S * L::kStreamBytes;  // dO stage s: + s * kStreamBytes
  // stage s's lse (log2 units) at [2 s BQ, (2 s + 1) BQ), its delta after
  float* const stats = reinterpret_cast<float*>(smem_raw + (base + L::kStatOffset - raw));
  const uint32_t own_full = base + L::kBarOffset;   // barriers, 8 bytes each
  const uint32_t full = own_full + 8;               // full[s]: + 8 s
  const uint32_t empty = full + 8 * S;              // empty[s]: + 8 s

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int k_start = blockIdx.y * BK;  // causal: the first key tiles see the most queries
  const int dlt = q_off - k_off;  // causal: key j is masked for query i when j > i + dlt
  const PairMask mask{seq_len, causal, dlt};
  // the q tiles from the first holding a query that sees a key of this block;
  // none when no query does (the ring's wholly masked hop)
  const int first_tile = first_q_tile(mask, k_start, BQ);
  const int n_q = causal && k_start - dlt >= seq_len ? 0 : (seq_len + BQ - 1) / BQ - first_tile;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1 + 32);              // the TMA thread and the stats warp
      mbar_init(empty + 8 * s, 4 * L::kConsumers);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: thread 0 loads K and V once, then keeps the Q/dO ring full;
    // warp 1 stages each q tile's lse and delta into the same stage.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_q > 0) {
      mbar_expect_tx(own_full, 2 * L::kOwnBytes);
#pragma unroll
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_4d(k_s + c * BK * L::kRowBytes, &tk, own_full, c * CB, h, k_start, b);
        tma_load_4d(v_s + c * BK * L::kRowBytes, &tv, own_full, c * CB, h, k_start, b);
      }
      for (int j = 0; j < n_q; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty + 8 * s, ((j / S) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kStreamBytes);
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c) {
          const uint32_t box = s * L::kStreamBytes + c * BQ * L::kRowBytes;
          const int q_start = (first_tile + j) * BQ;
          tma_load_4d(q_s + box, &tq, full + 8 * s, c * CB, h, q_start, b);
          tma_load_4d(do_s + box, &tdo, full + 8 * s, c * CB, h, q_start, b);
        }
      }
    } else if (threadIdx.x / 32 == 1 && n_q > 0) {
      // A padded query gets lse = +inf, so its p = exp2(s - inf) is exactly
      // 0; rows at or past seq_len (the next head's) are never read.
      const int lane = threadIdx.x % 32;
      const float* lb = lse + static_cast<long long>(bh) * seq_len;
      const float* db = delta + static_cast<long long>(bh) * seq_len;
      for (int j = 0; j < n_q; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty + 8 * s, ((j / S) & 1) ^ 1);
        float* st = stats + 2 * BQ * s;
        for (int i = lane; i < BQ; i += 32) {
          const int query = (first_tile + j) * BQ + i;
          st[i] = query < seq_len ? lb[query] * kLog2e : INFINITY;
          st[BQ + i] = query < seq_len ? db[query] : 0.f;
        }
        mbar_arrive(full + 8 * s);  // release: the stores above are seen after the wait
      }
    }
  } else {
    setmaxnreg_inc<L::kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int kw0 = k_start + 64 * cw;  // this warpgroup's first key
    const int key0 = kw0 + 16 * warp + g, key1 = key0 + 8;
    const float sl = scale * kLog2e;  // scores into log2 units: each p is one ex2

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const uint32_t k_wg = k_s + 64 * cw * L::kRowBytes;  // this warpgroup's rows
    const uint32_t v_wg = v_s + 64 * cw * L::kRowBytes;
    if (n_q > 0) mbar_wait(own_full, 0);

    for (int j = 0; j < n_q; ++j) {
      const int s = j % S;
      const int q_start = (first_tile + j) * BQ;
      mbar_wait(full + 8 * s, (j / S) & 1);

      // S^T = K Q^T and dP^T = V dO^T: D/16 slices of 16 columns, all K-major.
      float st[BQ / 2], dpt[BQ / 2];
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk * 16 % CB) * 2;  // bytes into a row
        const uint32_t own = (kk * 16 / CB) * BK * L::kRowBytes + col;
        const uint32_t stream = s * L::kStreamBytes + (kk * 16 / CB) * BQ * L::kRowBytes + col;
        wgmma_ss<Elem, BQ>(st, wgmma_desc(k_wg + own, 16, kSbo, kLayout),
                           wgmma_desc(q_s + stream, 16, kSbo, kLayout), kk);
        wgmma_ss<Elem, BQ>(dpt, wgmma_desc(v_wg + own, 16, kSbo, kLayout),
                           wgmma_desc(do_s + stream, 16, kSbo, kLayout), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // p^T in st, ds^T in dpt. Columns are queries: their lse and delta come
      // from the stage.
      const float* lse2 = stats + 2 * BQ * s;
      const float* dl = lse2 + BQ;
      const bool masked = causal && kw0 + 63 > q_start + dlt;
#pragma unroll
      for (int n8 = 0; n8 < BQ / 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n8 * 8 + 2 * t + e;
          const float l2 = lse2[c], dd = dl[c];
          float p0 = ex2_approx(st[4 * n8 + e] * sl - l2);
          float p1 = ex2_approx(st[4 * n8 + 2 + e] * sl - l2);
          if (masked) {
            if (key0 > q_start + c + dlt) p0 = 0.f;
            if (key1 > q_start + c + dlt) p1 = 0.f;
          }
          st[4 * n8 + e] = p0;
          st[4 * n8 + 2 + e] = p1;
          dpt[4 * n8 + e] = p0 * (dpt[4 * n8 + e] - dd);
          dpt[4 * n8 + 2 + e] = p1 * (dpt[4 * n8 + 2 + e] - dd);
        }
      }

      // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to Elem straight
      // from the fragments (register A); dO and Q MN-major from the stage.
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        c_to_a<Elem>(pa[kc], &st[8 * kc], &st[8 * kc + 4]);
        c_to_a<Elem>(dsa[kc], &dpt[8 * kc], &dpt[8 * kc + 4]);
      }
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        const uint32_t slice = s * L::kStreamBytes + kc * 16 * L::kRowBytes;
        wgmma_rs_t<Elem, D>(dv_acc, pa[kc],
                            wgmma_desc(do_s + slice, BQ * L::kRowBytes, kSbo, kLayout));
        wgmma_rs_t<Elem, D>(dk_acc, dsa[kc],
                            wgmma_desc(q_s + slice, BQ * L::kRowBytes, kSbo, kLayout));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);  // the stage's Q and dO have been read
    }

    Out* dkb = dk + b * sdk.b + h * sdk.h;
    Out* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      const int c = n8 * 8 + 2 * t;
      if (key0 < seq_len) {
        store2(dkb + key0 * sdk.t + c, dk_acc[4 * n8] * scale, dk_acc[4 * n8 + 1] * scale);
        store2(dvb + key0 * sdv.t + c, dv_acc[4 * n8], dv_acc[4 * n8 + 1]);
      }
      if (key1 < seq_len) {
        store2(dkb + key1 * sdk.t + c, dk_acc[4 * n8 + 2] * scale, dk_acc[4 * n8 + 3] * scale);
        store2(dvb + key1 * sdv.t + c, dv_acc[4 * n8 + 2], dv_acc[4 * n8 + 3]);
      }
    }
  }
}

// ------------------------------------------------ f32: plain FMA

// Rows [row0, row0 + kRows) of an f32 [T, D] tensor into a padded shared
// tile; rows at or past seq_len are zero.
template <int D, int kRows>
__device__ __forceinline__ void stage_f32(float (*tile)[D + 1], const float* base,
                                          long long row_stride, int row0, int seq_len) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D, row = row0 + r;
    tile[r][c] = row < seq_len ? base[row * row_stride + c] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_f32(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// K4, f32 path. grid (batch*heads, 16-query tiles).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int heads, int seq_len, Strides sq,
                            Strides sk, Strides sv, Strides sdo, Strides sdq, float scale,
                            int causal, int q_off, int k_off) {
  constexpr int BQ = kF32Rows, BK = kF32StreamRows<D>;
  constexpr int kPer = BQ * D / kThreads;
  __shared__ float Qs[BQ][D + 1], dOs[BQ][D + 1], Ks[BK][D + 1], Vs[BK][D + 1];
  __shared__ float dS[BQ][BK + 1];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const PairMask mask{seq_len, causal, q_off - k_off};

  stage_f32<D, BQ>(Qs, q + b * sq.b + h * sq.h, sq.t, q_start, seq_len);
  stage_f32<D, BQ>(dOs, dout + b * sdo.b + h * sdo.h, sdo.t, q_start, seq_len);
  if (tid < BQ) {
    const int row = q_start + tid;
    lse_s[tid] = row < seq_len ? lse[static_cast<long long>(bh) * seq_len + row] : 0.f;
    delta_s[tid] = row < seq_len ? delta[static_cast<long long>(bh) * seq_len + row] : 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.f;

  const int n_kv = n_kv_tiles(mask, min(seq_len, q_start + BQ) - 1, BK);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();
    stage_f32<D, BK>(Ks, kb, sk.t, k_start, seq_len);
    stage_f32<D, BK>(Vs, vb, sv.t, k_start, seq_len);
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      float ds = 0.f;
      if (mask.keep(q_start + r, k_start + c)) {
        const float p = expf(__fmul_rn(dot_f32<D>(Qs[r], Ks[c]), scale) - lse_s[r]);
        ds = p * (dot_f32<D>(dOs[r], Vs[c]) - delta_s[r]);
      }
      dS[r][c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = tid + e * kThreads, r = i / D, c = i % D;
      float sum = acc[e];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) sum = fmaf(dS[r][j], Ks[j][c], sum);
      acc[e] = sum;
    }
  }
  float* out = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = tid + e * kThreads, r = i / D, c = i % D, row = q_start + r;
    if (row < seq_len) out[row * sdq.t + c] = acc[e] * scale;
  }
}

// K5, f32 path. grid (batch*heads, 16-key tiles).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int heads,
                             int seq_len, Strides sq, Strides sk, Strides sv, Strides sdo,
                             Strides sdk, Strides sdv, float scale, int causal, int q_off,
                             int k_off) {
  constexpr int BK = kF32Rows, BQ = kF32StreamRows<D>;
  constexpr int kPer = BK * D / kThreads;
  __shared__ float Ks[BK][D + 1], Vs[BK][D + 1], Qs[BQ][D + 1], dOs[BQ][D + 1];
  __shared__ float P[BK][BQ + 1], dS[BK][BQ + 1];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int k_start = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const PairMask mask{seq_len, causal, q_off - k_off};

  stage_f32<D, BK>(Ks, k + b * sk.b + h * sk.h, sk.t, k_start, seq_len);
  stage_f32<D, BK>(Vs, v + b * sv.b + h * sv.h, sv.t, k_start, seq_len);
  float dk_acc[kPer], dv_acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  const int first_q = first_q_tile(mask, k_start, BQ);
  const int n_q = (seq_len + BQ - 1) / BQ;
  for (int qt = first_q; qt < n_q; ++qt) {
    const int q_start = qt * BQ;
    __syncthreads();
    stage_f32<D, BQ>(Qs, qb, sq.t, q_start, seq_len);
    stage_f32<D, BQ>(dOs, dob, sdo.t, q_start, seq_len);
    if (tid < BQ) {
      const int row = q_start + tid;
      lse_s[tid] = row < seq_len ? lse[static_cast<long long>(bh) * seq_len + row] : 0.f;
      delta_s[tid] = row < seq_len ? delta[static_cast<long long>(bh) * seq_len + row] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < BK * BQ; i += kThreads) {
      const int r = i / BQ, c = i % BQ;  // r: key, c: query
      float p = 0.f, ds = 0.f;
      if (mask.keep(q_start + c, k_start + r)) {
        p = expf(__fmul_rn(dot_f32<D>(Ks[r], Qs[c]), scale) - lse_s[c]);
        ds = p * (dot_f32<D>(Vs[r], dOs[c]) - delta_s[c]);
      }
      P[r][c] = p;
      dS[r][c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = tid + e * kThreads, r = i / D, c = i % D;
      float sv_ = dv_acc[e], sk_ = dk_acc[e];
#pragma unroll 8
      for (int j = 0; j < BQ; ++j) {
        sv_ = fmaf(P[r][j], dOs[j][c], sv_);
        sk_ = fmaf(dS[r][j], Qs[j][c], sk_);
      }
      dv_acc[e] = sv_;
      dk_acc[e] = sk_;
    }
  }
  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = tid + e * kThreads, r = i / D, c = i % D, key = k_start + r;
    if (key < seq_len) {
      dkb[key * sdk.t + c] = dk_acc[e] * scale;
      dvb[key * sdv.t + c] = dv_acc[e];
    }
  }
}

// Tensors in argument order: q, k, v, dout, then the outputs (dq; or dk, dv).
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;
  int batch, heads, seq_len;
  Strides s[6];  // q, k, v, dout, out0, out1
  float scale;
  int causal, q_off, k_off;
  cudaStream_t stream;
};

template <typename Elem>
const Elem* in(const void* p) { return static_cast<const Elem*>(p); }

template <typename Out>
Out* out_ptr(void* p) { return static_cast<Out*>(p); }

// The tensor maps of q, k, v and dout for K4 (kDq) or K5: boxes of the own
// tile's rows for the block's own side, of a streamed tile's for the other.
template <typename Elem, int D, bool kDq>
int make_maps(CUtensorMap (&maps)[4], const Args& a) {
  using L = BwdTiles<D, kDq>;
  const int q_rows = kDq ? L::kOwnRows : L::kStreamRows;
  const int kv_rows = kDq ? L::kStreamRows : L::kOwnRows;
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const int rows[4] = {q_rows, kv_rows, kv_rows, q_rows};
  for (int i = 0; i < 4; ++i) {
    const int rc = make_bthd_map<Elem>(&maps[i], ptrs[i], a.batch, a.seq_len, a.heads, D,
                                       a.s[i].b, a.s[i].t, a.s[i].h, L::kBoxCols, rows[i]);
    if (rc) return rc;
  }
  return 0;
}

template <typename Elem, typename Out, int D, bool kDq>
auto hopper_kernel() {
  if constexpr (kDq) {
    return flash_bwd_dq_hopper_kernel<Elem, Out, D>;
  } else {
    return flash_bwd_dkv_hopper_kernel<Elem, Out, D>;
  }
}

// K4 (kDq) or K5 on the Hopper kernel: grid (batch*heads, own tiles).
template <typename Elem, typename Out, int D, bool kDq>
int launch_hopper(const Args& a) {
  using L = BwdTiles<D, kDq>;
  CUtensorMap m[4];
  int rc = make_maps<Elem, D, kDq>(m, a);
  if (rc) return rc;
  const auto kernel = hopper_kernel<Elem, Out, D, kDq>();
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes));
  if (rc) return rc;
  const dim3 grid(a.batch * a.heads, (a.seq_len + L::kOwnRows - 1) / L::kOwnRows);
  if constexpr (kDq) {
    kernel<<<grid, L::kThreads, L::kSmemBytes, a.stream>>>(
        m[0], m[1], m[2], m[3], a.lse, a.delta, out_ptr<Out>(a.out0), a.heads, a.seq_len,
        a.s[4], a.scale, a.causal, a.q_off, a.k_off);
  } else {
    kernel<<<grid, L::kThreads, L::kSmemBytes, a.stream>>>(
        m[0], m[1], m[2], m[3], a.lse, a.delta, out_ptr<Out>(a.out0), out_ptr<Out>(a.out1),
        a.heads, a.seq_len, a.s[4], a.s[5], a.scale, a.causal, a.q_off, a.k_off);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_f32(const Args& a) {
  const dim3 grid(a.batch * a.heads, (a.seq_len + kF32Rows - 1) / kF32Rows);
  flash_bwd_dq_f32_kernel<D><<<grid, kThreads, 0, a.stream>>>(
      in<float>(a.q), in<float>(a.k), in<float>(a.v), in<float>(a.dout), a.lse, a.delta,
      out_ptr<float>(a.out0), a.heads, a.seq_len, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4],
      a.scale, a.causal, a.q_off, a.k_off);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_f32(const Args& a) {
  const dim3 grid(a.batch * a.heads, (a.seq_len + kF32Rows - 1) / kF32Rows);
  flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, 0, a.stream>>>(
      in<float>(a.q), in<float>(a.k), in<float>(a.v), in<float>(a.dout), a.lse, a.delta,
      out_ptr<float>(a.out0), out_ptr<float>(a.out1), a.heads, a.seq_len, a.s[0], a.s[1], a.s[2],
      a.s[3], a.s[4], a.s[5], a.scale, a.causal, a.q_off, a.k_off);
  return static_cast<int>(cudaGetLastError());
}

// f32 on the FMA kernels; bf16/fp16, with outputs in the input type or f32,
// on the Hopper kernels.
template <int D, bool kDq>
int launch(int dtype, int out_dtype, const Args& a) {
  if (dtype == 0 && out_dtype == 0) return kDq ? launch_dq_f32<D>(a) : launch_dkv_f32<D>(a);
  using BF = __nv_bfloat16;
  if (dtype == 1) {
    if (out_dtype == 1) return launch_hopper<__half, __half, D, kDq>(a);
    if (out_dtype == 0) return launch_hopper<__half, float, D, kDq>(a);
  } else if (dtype == 2) {
    if (out_dtype == 2) return launch_hopper<BF, BF, D, kDq>(a);
    if (out_dtype == 0) return launch_hopper<BF, float, D, kDq>(a);
  }
  return -1;
}

template <bool kDq>
int dispatch(int dtype, int out_dtype, int head_dim, const Args& a) {
  switch (head_dim) {
    case 16:
      return launch<16, kDq>(dtype, out_dtype, a);
    case 32:
      return launch<32, kDq>(dtype, out_dtype, a);
    case 64:
      return launch<64, kDq>(dtype, out_dtype, a);
    case 128:
      return launch<128, kDq>(dtype, out_dtype, a);
  }
  return -1;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* out0, void* out1, int batch, int heads, int seq_len,
               const long long* st, int n_strided, float scale, int causal, int q_off,
               int k_off, void* stream) {
  Args a{q, k, v, dout, lse, delta, out0, out1, batch, heads, seq_len, {}, scale, causal,
         q_off, k_off, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < n_strided; ++i) a.s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  return a;
}

// Resident blocks per SM of a Hopper kernel (outputs in the input type),
// after the shared-memory opt-in; its threads and dynamic shared memory per
// block through the pointers.
template <typename Elem, int D, bool kDq>
int hopper_blocks_per_sm(int* threads, int* smem_bytes) {
  using L = BwdTiles<D, kDq>;
  *threads = L::kThreads;
  *smem_bytes = L::kSmemBytes;
  const auto kernel = hopper_kernel<Elem, Elem, D, kDq>();
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kSmemBytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, L::kThreads,
                                                    L::kSmemBytes) != cudaSuccess)
    return -1;
  return blocks;
}

template <int D, bool kDq>
int hopper_occupancy(int dtype, int* threads, int* smem_bytes) {
  if (dtype == 1) return hopper_blocks_per_sm<__half, D, kDq>(threads, smem_bytes);
  if (dtype == 2) return hopper_blocks_per_sm<__nv_bfloat16, D, kDq>(threads, smem_bytes);
  return -1;
}

template <bool kDq>
int occupancy(int dtype, int head_dim, int* threads, int* smem_bytes) {
  switch (head_dim) {
    case 16:
      return hopper_occupancy<16, kDq>(dtype, threads, smem_bytes);
    case 32:
      return hopper_occupancy<32, kDq>(dtype, threads, smem_bytes);
    case 64:
      return hopper_occupancy<64, kDq>(dtype, threads, smem_bytes);
    case 128:
      return hopper_occupancy<128, kDq>(dtype, threads, smem_bytes);
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. q, k, v, dout and the
// outputs are [batch, seq_len, heads, head_dim] addressed by `strides` (the
// (batch, time, head) strides of each, in elements, in argument order); lse
// and delta are f32 [batch, heads, seq_len] contiguous. q_off and k_off are
// the global positions of the q chunk's and the kv chunk's first rows (0, 0
// outside a ring); out_dtype is the outputs' type, dtype itself or 0 (f32).
// Each returns cudaGetLastError() after the launch, a tensor-map error
// (hopper.cuh: kNoEncoder, kEncodeFailed + CUresult), or -1 for a dtype,
// output type or head dim these kernels do not take.
extern "C" int dl4j_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* dout, const float* lse,
                                 const float* delta, void* dq, int batch, int heads,
                                 int seq_len, const long long* strides, float scale, int causal,
                                 int q_off, int k_off, int out_dtype, void* stream) {
  return dispatch<true>(dtype, out_dtype, head_dim,
                        make_args(q, k, v, dout, lse, delta, dq, nullptr, batch, heads, seq_len,
                                  strides, 5, scale, causal, q_off, k_off, stream));
}

extern "C" int dl4j_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                  const void* v, const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv, int batch, int heads,
                                  int seq_len, const long long* strides, float scale, int causal,
                                  int q_off, int k_off, int out_dtype, void* stream) {
  return dispatch<false>(dtype, out_dtype, head_dim,
                         make_args(q, k, v, dout, lse, delta, dk, dv, batch, heads, seq_len,
                                   strides, 6, scale, causal, q_off, k_off, stream));
}

// The Hopper kernel of K4 (dq = 1) or K5 (0) for a 16-bit dtype (1 = float16,
// 2 = bfloat16): its resident blocks per SM and, through the pointers, its
// threads and dynamic shared memory per block. -1 for a dtype or head dim it
// does not take.
extern "C" int dl4j_flash_bwd_occupancy(int dtype, int head_dim, int dq, int* threads,
                                        int* smem_bytes) {
  return dq ? occupancy<true>(dtype, head_dim, threads, smem_bytes)
            : occupancy<false>(dtype, head_dim, threads, smem_bytes);
}
