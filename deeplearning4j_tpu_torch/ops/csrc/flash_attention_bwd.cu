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
//   s = (q_i . k_j) * scale             f32 product of the input type, scaled after
//                                       (__fmul_rn: rounded before the subtraction)
//   p = exp(s - lse_i)                  f32; 0 where masked (causal: k_off + j > q_off + i;
//                                       or out of bounds)
//   dp = dO_i . v_j                     f32 accumulation
//   ds = p * (dp - delta_i)             f32
// The dQ and dK products take ds rounded to the input type and the dV product
// takes p rounded to the input type, each accumulated in f32; dQ and dK are
// multiplied by scale after the product. Outputs are rounded once to the output
// type. That is where the TPU kernels round.
//
// Bound on an H100 SXM at the training shape (B=4, T=8192, H=8, D=64, bf16,
// causal), with 1.074e9 (query, key) pairs: K4 does 6*D FLOP per pair (s, dp,
// dQ), 4.12e11 FLOP, 0.417 ms at 989 TFLOP/s; K5 8*D (s, dp, dV, dK), 5.50e11,
// 0.556 ms; each moves ~0.2 GB (~0.06 ms at 3.35 TB/s). Compute-bound: the
// products go through the tensor cores. At one visible ring hop of T=8192 over
// a ring of 4 (Tq=Tk=2048, f32 outputs): K4 5.15e10 FLOP, 0.052 ms; K5
// 6.87e10, 0.069 ms; both still compute-bound.
//
// Design (a first, simple version; wgmma, TMA and ldmatrix.trans come later):
//  * bf16/fp16: one block of 4 warps, each warp owning 16 rows of the block's
//    64-row tile: queries in K4, keys in K5. The tile's own operands (Q and dO
//    in K4; K and V in K5) stay in registers as mma A fragments; the other side
//    streams through shared memory in row-major tiles (K and V in K4; Q, dO,
//    lse and delta in K5). The S and dP products run on mma.sync.m16n8k16;
//    their f32 results become, rounded, the A operand of the dQ / dV / dK
//    products without leaving registers. That product's B operand runs along
//    the rows of the shared tile, and is read as column pairs (ld32_col).
//  * f32: the same arithmetic in plain f32 FMA (no TF32), with small tiles in
//    shared memory and one thread per (query, key) pair for s and dp.
//  * Causal: K4's kv loop stops at the last tile holding a key its queries may
//    see; K5's q loop starts at the first tile holding a query that may see
//    its keys (the diagonal tiles at equal offsets). A hop that is wholly
//    masked runs no inner tile and writes zeros. The heaviest tiles are
//    scheduled first.
//  * Any T: both axes are masked by bounds. A padded key gets p = 0 (as a -inf
//    score would); a padded query gets p = 0 by its bound, never through its
//    lse or delta, which read as 0 and are not used.
#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr int kTile = kWarps * 16;  // tensor-core path: rows of a block's own tile
constexpr int kF32Rows = 16;        // f32 path: rows of a block's own tile

// Keys per streamed tile in K4 and queries per streamed tile in K5. K5 holds
// two D-wide f32 accumulators besides its K and V fragments, so at D = 128 it
// streams half tiles to stay within 255 registers.
template <int D>
constexpr int kMmaStreamRows = D <= 64 ? 64 : 32;
template <int D>
constexpr int kF32StreamRows = D <= 64 ? 32 : 16;

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

// K4. grid (batch*heads, query tiles); lse and delta are f32 [batch*heads, T].
template <typename Elem, typename Out, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                            const Elem* __restrict__ v, const Elem* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            Out* __restrict__ dq, int heads, int seq_len, Strides sq,
                            Strides sk, Strides sv, Strides sdo, Strides sdq, float scale,
                            int causal, int q_off, int k_off) {
  constexpr int BK = kMmaStreamRows<D>;
  constexpr int kPitch = D + 8;
  __shared__ __align__(16) Elem Ks[BK][kPitch];
  __shared__ __align__(16) Elem Vs[BK][kPitch];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int qtile = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const Elem* kb = k + b * sk.b + h * sk.h;
  const Elem* vb = v + b * sv.b + h * sv.h;
  const int row0 = qtile * kTile + warp * 16 + g;
  const int row1 = row0 + 8;
  const PairMask mask{seq_len, causal, q_off - k_off};

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<Elem, D>(qa, q + b * sq.b + h * sq.h, sq.t, row0, seq_len, t);
  load_a<Elem, D>(da, dout + b * sdo.b + h * sdo.h, sdo.t, row0, seq_len, t);
  const float* lb = lse + static_cast<long long>(bh) * seq_len;
  const float* db = delta + static_cast<long long>(bh) * seq_len;
  const float lse0 = row0 < seq_len ? lb[row0] : 0.f, lse1 = row1 < seq_len ? lb[row1] : 0.f;
  const float dl0 = row0 < seq_len ? db[row0] : 0.f, dl1 = row1 < seq_len ? db[row1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  const int n_kv = n_kv_tiles(mask, min(seq_len, (qtile + 1) * kTile) - 1, BK);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<Elem, D, BK, kPitch>(Ks, kb, sk.t, k_start, seq_len);
    stage_rows<Elem, D, BK, kPitch>(Vs, vb, sv.t, k_start, seq_len);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows and the tile's keys.
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const Elem* kr = &Ks[nt * 8 + g][kc * 16 + 2 * t];
        Mma<Elem>::run(s[nt], qa[kc], ld32(kr), ld32(kr + 8));
        const Elem* vr = &Vs[nt * 8 + g][kc * 16 + 2 * t];
        Mma<Elem>::run(dp[nt], da[kc], ld32(vr), ld32(vr + 8));
      }
    }
    // ds = p * (dp - delta), p = exp(s * scale - lse); kept in s.
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k_start + nt * 8 + 2 * t + j;
        const float p0 = mask.keep(row0, key) ? expf(__fmul_rn(s[nt][j], scale) - lse0) : 0.f;
        const float p1 = mask.keep(row1, key) ? expf(__fmul_rn(s[nt][2 + j], scale) - lse1) : 0.f;
        s[nt][j] = p0 * (dp[nt][j] - dl0);
        s[nt][2 + j] = p1 * (dp[nt][2 + j] - dl1);
      }
    }
    // dQ += dS K: K's rows are this product's k dimension.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t dsa[4];
      c_to_a<Elem>(dsa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const Elem* kr = &Ks[kc * 16 + 2 * t][nd * 8 + g];
        Mma<Elem>::run(acc[nd], dsa, ld32_col(kr, kPitch), ld32_col(kr + 8 * kPitch, kPitch));
      }
    }
  }

  Out* out = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (row0 < seq_len) store2(out + row0 * sdq.t + c, acc[nd][0] * scale, acc[nd][1] * scale);
    if (row1 < seq_len) store2(out + row1 * sdq.t + c, acc[nd][2] * scale, acc[nd][3] * scale);
  }
}

// K5. grid (batch*heads, key tiles). Works on transposed panels: S^T = K Q^T
// and dP^T = V dO^T, rows = this warp's 16 keys, columns = the tile's queries.
template <typename Elem, typename Out, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_mma_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                             const Elem* __restrict__ v, const Elem* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             Out* __restrict__ dk, Out* __restrict__ dv, int heads,
                             int seq_len, Strides sq, Strides sk, Strides sv, Strides sdo,
                             Strides sdk, Strides sdv, float scale, int causal, int q_off,
                             int k_off) {
  constexpr int BQ = kMmaStreamRows<D>;
  constexpr int kPitch = D + 8;
  __shared__ __align__(16) Elem Qs[BQ][kPitch];
  __shared__ __align__(16) Elem dOs[BQ][kPitch];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int ktile = blockIdx.y;  // causal: the first key tiles see the most queries
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const Elem* qb = q + b * sq.b + h * sq.h;
  const Elem* dob = dout + b * sdo.b + h * sdo.h;
  const float* lb = lse + static_cast<long long>(bh) * seq_len;
  const float* db = delta + static_cast<long long>(bh) * seq_len;
  const int key0 = ktile * kTile + warp * 16 + g;
  const int key1 = key0 + 8;
  const PairMask mask{seq_len, causal, q_off - k_off};

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<Elem, D>(ka, k + b * sk.b + h * sk.h, sk.t, key0, seq_len, t);
  load_a<Elem, D>(va, v + b * sv.b + h * sv.h, sv.t, key0, seq_len, t);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[nd][j] = dv_acc[nd][j] = 0.f;

  // Queries before the tile's first key see none of its keys.
  const int first_q = first_q_tile(mask, ktile * kTile, BQ);
  const int n_q = (seq_len + BQ - 1) / BQ;
  for (int qt = first_q; qt < n_q; ++qt) {
    const int q_start = qt * BQ;
    __syncthreads();
    stage_rows<Elem, D, BQ, kPitch>(Qs, qb, sq.t, q_start, seq_len);
    stage_rows<Elem, D, BQ, kPitch>(dOs, dob, sdo.t, q_start, seq_len);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const int query = q_start + i;
      lse_s[i] = query < seq_len ? lb[query] : 0.f;
      delta_s[i] = query < seq_len ? db[query] : 0.f;
    }
    __syncthreads();

    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const Elem* qr = &Qs[nt * 8 + g][kc * 16 + 2 * t];
        Mma<Elem>::run(s[nt], ka[kc], ld32(qr), ld32(qr + 8));
        const Elem* dr = &dOs[nt * 8 + g][kc * 16 + 2 * t];
        Mma<Elem>::run(dp[nt], va[kc], ld32(dr), ld32(dr + 8));
      }
    }
    // p^T in s, ds^T in dp.
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = nt * 8 + 2 * t + j, query = q_start + c;
        const float p0 = mask.keep(query, key0) ? expf(__fmul_rn(s[nt][j], scale) - lse_s[c]) : 0.f;
        const float p1 = mask.keep(query, key1) ? expf(__fmul_rn(s[nt][2 + j], scale) - lse_s[c]) : 0.f;
        s[nt][j] = p0;
        s[nt][2 + j] = p1;
        dp[nt][j] = p0 * (dp[nt][j] - delta_s[c]);
        dp[nt][2 + j] = p1 * (dp[nt][2 + j] - delta_s[c]);
      }
    }
    // dV += P^T dO and dK += dS^T Q: the queries are these products' k dimension.
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t pa[4], dsa[4];
      c_to_a<Elem>(pa, s[2 * kc], s[2 * kc + 1]);
      c_to_a<Elem>(dsa, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const Elem* dr = &dOs[kc * 16 + 2 * t][nd * 8 + g];
        Mma<Elem>::run(dv_acc[nd], pa, ld32_col(dr, kPitch), ld32_col(dr + 8 * kPitch, kPitch));
        const Elem* qr = &Qs[kc * 16 + 2 * t][nd * 8 + g];
        Mma<Elem>::run(dk_acc[nd], dsa, ld32_col(qr, kPitch), ld32_col(qr + 8 * kPitch, kPitch));
      }
    }
  }

  Out* dkb = dk + b * sdk.b + h * sdk.h;
  Out* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (key0 < seq_len) {
      store2(dkb + key0 * sdk.t + c, dk_acc[nd][0] * scale, dk_acc[nd][1] * scale);
      store2(dvb + key0 * sdv.t + c, dv_acc[nd][0], dv_acc[nd][1]);
    }
    if (key1 < seq_len) {
      store2(dkb + key1 * sdk.t + c, dk_acc[nd][2] * scale, dk_acc[nd][3] * scale);
      store2(dvb + key1 * sdv.t + c, dv_acc[nd][2], dv_acc[nd][3]);
    }
  }
}

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

template <typename Elem, typename Out, int D>
int launch_dq_mma(const Args& a) {
  const dim3 grid(a.batch * a.heads, (a.seq_len + kTile - 1) / kTile);
  flash_bwd_dq_mma_kernel<Elem, Out, D><<<grid, kThreads, 0, a.stream>>>(
      in<Elem>(a.q), in<Elem>(a.k), in<Elem>(a.v), in<Elem>(a.dout), a.lse, a.delta,
      out_ptr<Out>(a.out0), a.heads, a.seq_len, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.scale,
      a.causal, a.q_off, a.k_off);
  return static_cast<int>(cudaGetLastError());
}

template <typename Elem, typename Out, int D>
int launch_dkv_mma(const Args& a) {
  const dim3 grid(a.batch * a.heads, (a.seq_len + kTile - 1) / kTile);
  flash_bwd_dkv_mma_kernel<Elem, Out, D><<<grid, kThreads, 0, a.stream>>>(
      in<Elem>(a.q), in<Elem>(a.k), in<Elem>(a.v), in<Elem>(a.dout), a.lse, a.delta,
      out_ptr<Out>(a.out0), out_ptr<Out>(a.out1), a.heads, a.seq_len, a.s[0], a.s[1], a.s[2],
      a.s[3], a.s[4], a.s[5], a.scale, a.causal, a.q_off, a.k_off);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(int dtype, int out_dtype, const Args& a) {
  if (dtype == 0 && out_dtype == 0) {
    const dim3 grid(a.batch * a.heads, (a.seq_len + kF32Rows - 1) / kF32Rows);
    flash_bwd_dq_f32_kernel<D><<<grid, kThreads, 0, a.stream>>>(
        in<float>(a.q), in<float>(a.k), in<float>(a.v), in<float>(a.dout), a.lse, a.delta,
        out_ptr<float>(a.out0), a.heads, a.seq_len, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4],
        a.scale, a.causal, a.q_off, a.k_off);
    return static_cast<int>(cudaGetLastError());
  }
  using BF = __nv_bfloat16;
  if (dtype == 1) {
    if (out_dtype == 1) return launch_dq_mma<__half, __half, D>(a);
    if (out_dtype == 0) return launch_dq_mma<__half, float, D>(a);
  } else if (dtype == 2) {
    if (out_dtype == 2) return launch_dq_mma<BF, BF, D>(a);
    if (out_dtype == 0) return launch_dq_mma<BF, float, D>(a);
  }
  return -1;
}

template <int D>
int launch_dkv(int dtype, int out_dtype, const Args& a) {
  if (dtype == 0 && out_dtype == 0) {
    const dim3 grid(a.batch * a.heads, (a.seq_len + kF32Rows - 1) / kF32Rows);
    flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, 0, a.stream>>>(
        in<float>(a.q), in<float>(a.k), in<float>(a.v), in<float>(a.dout), a.lse, a.delta,
        out_ptr<float>(a.out0), out_ptr<float>(a.out1), a.heads, a.seq_len, a.s[0], a.s[1], a.s[2],
        a.s[3], a.s[4], a.s[5], a.scale, a.causal, a.q_off, a.k_off);
    return static_cast<int>(cudaGetLastError());
  }
  using BF = __nv_bfloat16;
  if (dtype == 1) {
    if (out_dtype == 1) return launch_dkv_mma<__half, __half, D>(a);
    if (out_dtype == 0) return launch_dkv_mma<__half, float, D>(a);
  } else if (dtype == 2) {
    if (out_dtype == 2) return launch_dkv_mma<BF, BF, D>(a);
    if (out_dtype == 0) return launch_dkv_mma<BF, float, D>(a);
  }
  return -1;
}

template <bool kDq>
int dispatch(int dtype, int out_dtype, int head_dim, const Args& a) {
  switch (head_dim) {
    case 16:
      return kDq ? launch_dq<16>(dtype, out_dtype, a) : launch_dkv<16>(dtype, out_dtype, a);
    case 32:
      return kDq ? launch_dq<32>(dtype, out_dtype, a) : launch_dkv<32>(dtype, out_dtype, a);
    case 64:
      return kDq ? launch_dq<64>(dtype, out_dtype, a) : launch_dkv<64>(dtype, out_dtype, a);
    case 128:
      return kDq ? launch_dq<128>(dtype, out_dtype, a) : launch_dkv<128>(dtype, out_dtype, a);
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

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. q, k, v, dout and the
// outputs are [batch, seq_len, heads, head_dim] addressed by `strides` (the
// (batch, time, head) strides of each, in elements, in argument order); lse
// and delta are f32 [batch, heads, seq_len] contiguous. q_off and k_off are
// the global positions of the q chunk's and the kv chunk's first rows (0, 0
// outside a ring); out_dtype is the outputs' type, dtype itself or 0 (f32).
// Each returns cudaGetLastError() after the launch, or -1 for a dtype, output
// type or head dim these kernels do not take.
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
