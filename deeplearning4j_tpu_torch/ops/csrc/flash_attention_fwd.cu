// Flash-attention forward for NVIDIA Hopper (sm_90a), three entries:
//  * K1 (`dl4j_flash_fwd`) replaces the TPU kernel `_kernel` in
//    deeplearning4j_tpu/ops/flash_attention.py (its grid step
//    `_online_softmax_step`), which `_flash_fwd_bthd(with_lse=False)` launches
//    for inference;
//  * K2 (`dl4j_flash_fwd_lse`) replaces `_kernel_lse`, which
//    `_flash_fwd_bthd(with_lse=True)` launches for the training forward `_fwd`.
//    It is K1's kernel with kWithLse: the epilogue also writes the per-row
//    logsumexp lse = m + log(max(l, 1e-30)) as f32 [B, H, T], the one
//    residual the backward kernels (flash_attention_bwd.cu) need beyond
//    q, k, v, o. A row that saw only masked keys (m = -inf, l = 0) gets
//    lse = -inf, as on the TPU; causal self-attention has none, since the
//    diagonal is always kept;
//  * K3 (`dl4j_flash_fwd_partial`) replaces `_partial_kernel`, which
//    `flash_attention_partial` launches once per hop of ring attention
//    (parallel/ring_attention.py). It writes the UNNORMALISED partial: acc as
//    f32 [B, T, H, D] with no division, and the row max m and sum l as f32
//    [B, H, T], for the ring to fold across hops. The causal mask compares
//    global positions, q_off + row >= k_off + col, where q_off and k_off are
//    the offsets of this q chunk and of the visiting kv chunk. A masked score
//    is the finite -1e30 (kNeg) instead of -inf and p is zeroed where
//    s <= kNeg / 2, so a row that sees no key of the hop keeps m = -1e30,
//    l = 0, acc = 0 (a -inf there would give NaN in the ring's fold). A hop
//    that is wholly masked (k_off > q_off + T - 1) runs no kv tile at all and
//    writes exactly that for every row, as the TPU kernel's skipped grid does.
//
// Computes O = softmax(Q K^T * scale) V over [B, T, H, D] tensors addressed by
// strides (only the innermost stride must be 1), with an online softmax: the
// [T, T] scores never reach device memory. The TPU kernel carries its running
// max m, sum l and accumulator acc across a sequential kv grid dimension; here
// that dimension is a loop inside one thread block, and m, l, acc live in f32
// registers.
//
// Numerics follow the TPU kernel: scores accumulate in f32 and are scaled
// after the product; masked scores are -inf (causal keeps row >= col); l sums
// the f32 probabilities while the PV product takes them rounded to the input
// type, with f32 accumulation; the output is acc / max(l, 1e-30) in the input
// type.
//
// Bound on an H100 SXM: at the serving shape (B=4, T=8192, H=8, D=64, bf16,
// causal) the work is 4*B*H*D*T(T+1)/2 = 2.75e11 FLOP, 0.28 ms at 989 TFLOP/s,
// against 134 MB of q/k/v/o traffic, 0.04 ms at 3.35 TB/s: compute-bound, so
// the products go through the tensor cores, and the design is measured by its
// share of 989 TFLOP/s (PERF.md). K3 at one visible hop of T=8192
// over a ring of 4 (B=4, Tq=Tk=2048, H=8, D=64, bf16): 4*B*H*Tq*Tk*D =
// 3.44e10 FLOP, 0.035 ms, against 42 MB (q, k, v read; f32 acc, m, l
// written), 0.013 ms: compute-bound too.
//
// Three kernels, one job each:
//  * K1 and K2, 16-bit (bf16, fp16, D in {16, 32, 64, 128}): the Hopper
//    kernel `flash_fwd_hopper_kernel`. Against the compute bound it keeps the
//    tensor cores fed from shared memory without spending threads on loads
//    (0.74 ms, 372 TFLOP/s at the serving shape on an H100, PERF.md):
//    - tiles: one block per (batch*head, query tile) with 128-key kv tiles;
//      the query tile is 64 rows per consumer warpgroup: 192 rows at D <= 64
//      (three consumers), 128 at D = 128 (two);
//    - warp roles: warpgroup 0 is the producer: it drops to 24 registers
//      (setmaxnreg) and one of its threads issues every load. The consumers
//      own 64 query rows each and rise to 160 registers (three, 512 threads
//      a block) or 240 (two, 384 threads); ptxas reports the launch cap of
//      128 or 168, with no spills;
//    - loads: TMA over 4-D tensor maps of the strided [B, T, H, D] inputs,
//      built by the C entry for each launch; Q once per block, K and V through
//      a ring of 4 shared-memory stages (2 at D = 128), each with a "full"
//      mbarrier (the TMA's transaction bytes) and an "empty" one (one arrival
//      per consumer warp once its last wgmma on the stage has completed).
//      Rows of 32, 64 or 128 bytes are swizzled to their width (D = 128 loads
//      as two 64-column boxes); rows past T arrive as zeros and are masked
//      like causal keys. Shared memory: 24 KB of Q + 4 x 2 x 16 KB of K/V at
//      D = 64 (152 KB, and 1 KB of alignment), 160 KB at D = 128: one block
//      per SM;
//    - S = Q K^T on wgmma m64n128k16, both operands K-major in shared memory,
//      f32 accumulators (64 a thread);
//    - online softmax on the accumulator fragments, reductions within a quad.
//      The f32 scores are scaled after the product by scale * log2(e), so
//      each probability and each rescale factor is one ex2 (the special
//      function unit's rate, not the products', bounds the softmax at D=64);
//      the running max is kept in those units and lse converts it back;
//    - O += P V on register-A wgmma m64nDk16: P is rounded to the input type
//      straight from the S accumulators, V is read as TMA left it, as an
//      MN-major operand (the transpose bit): no transpose through registers.
//      A tile's P V is left in flight while the next tile's S is issued, and O
//      is rescaled only after both have been waited for. With three
//      consumers, one warpgroup's softmax overlaps the others' products; no
//      schedule orders them (no ping-pong).
//  * K3 (ring partial), 16-bit: `flash_fwd_partial_mma_kernel`, on mma.sync:
//    one block of 4 warps per (batch*head, 64-query tile), each warp owning
//    16 query rows; K tiles of 64 keys row-major and V tiles transposed in
//    padded shared memory; QK^T and PV on mma.sync.m16n8k16, the
//    probabilities reused from the score accumulators as PV's A operand.
//  * f32, all three modes: the same online softmax in plain f32 FMA (no
//    TF32), one block per (batch*head, 16-query tile), tiles of 32 keys.
//  * Causal: the kv loop stops at the last tile that holds a key the tile's
//    last query may see (the diagonal tile when the offsets are equal). A
//    ragged last tile is masked, so any T works. The heaviest causal tiles
//    are scheduled first.
#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBlockQ = kWarps * 16;  // K3 (mma.sync): query rows per block
constexpr int kBlockK = 64;           // K3: keys per tile
constexpr int kF32BlockQ = 16;        // f32 path
constexpr int kF32BlockK = 32;

// What a forward kernel writes: K1 o; K2 o and lse; K3 the partial.
enum Mode { kPlain = 0, kLse = 1, kPartial = 2 };

// Index of the last kv tile of `tile` keys that holds a key which a query in
// [0, last_q] may see, or -1 if none: keys run to last_q + dlt (causal,
// dlt = q_off - k_off) and to seq_len - 1.
__device__ __forceinline__ int last_kv_tile(int last_q, int dlt, int seq_len, int tile) {
  const int last_key = min(seq_len - 1, last_q + dlt);
  return last_key < 0 ? -1 : last_key / tile;
}

// ------------------------------------------------ K1, K2: the Hopper kernel

// Tiles of the Hopper kernel for head dim D. One block: a producer warpgroup
// (one thread issues every TMA load) and kConsumers warpgroups of 64 query
// rows each.
template <int D>
struct HopperTiles {
  // D <= 64: three consumers, so that while one warpgroup runs its softmax
  // the others keep the tensor cores busy; D = 128 has registers for two
  static constexpr int kConsumers = D <= 64 ? 3 : 2;
  static constexpr int kBlockQ = 64 * kConsumers;  // query rows per block
  static constexpr int kBlockK = 128;              // keys per kv tile
  static constexpr int kStages = D <= 64 ? 4 : 2;  // K/V ring depth (shared memory)
  static constexpr int kThreads = 128 * (1 + kConsumers);
  // registers after setmaxnreg: the producer's 24 and the consumers' share
  // of the rest (65536 per SM, one block per SM)
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;
  static constexpr int kBoxCols = D < 64 ? D : 64;  // columns of one TMA box
  static constexpr int kRowBytes = kBoxCols * 2;    // 32, 64 or 128: the swizzle
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kKVBytes = kBlockK * D * 2;  // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // + 1024 to align the tiles to a 1024-byte swizzle atom; barriers after
  static constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

// O = softmax(Q K^T * scale) V for one (batch*head, kBlockQ-query tile);
// with kWithLse also lse = m + log(max(l, 1e-30)) as f32 [B, H, T]. q, k, v are
// read through 4-D tensor maps over [B, T, H, D] (dims D, H, T, B); rows at or
// past seq_len load as zeros and are masked like causal keys.
template <typename Elem, int D, bool kWithLse>
__global__ void __launch_bounds__(HopperTiles<D>::kThreads, 1)
    flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, Elem* __restrict__ o,
                            float* __restrict__ lse, int heads, int seq_len, Strides so,
                            float scale, int causal) {
  using L = HopperTiles<D>;
  constexpr int BQ = L::kBlockQ, BK = L::kBlockK, S = L::kStages, CB = L::kBoxCols;
  constexpr int kLayout = swizzle_layout(L::kRowBytes);
  constexpr uint32_t kSbo = 8 * L::kRowBytes;  // 8-row group stride
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;                        // Q: kBoxes boxes of [BQ][CB]
  const uint32_t k_s = q_s + L::kQBytes;            // K stage s: + s * kKVBytes
  const uint32_t v_s = k_s + S * L::kKVBytes;       // V stage s: + s * kKVBytes
  const uint32_t q_full = base + L::kBarOffset;     // barriers, 8 bytes each
  const uint32_t full = q_full + 8;                 // full[s]: + 8 s
  const uint32_t empty = full + 8 * S;              // empty[s]: + 8 s

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int qtile = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q_start = qtile * BQ;
  // causal: the tiles up to the one holding the block's last query
  const int n_kv = ((causal ? min(seq_len, q_start + BQ) : seq_len) + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * L::kConsumers);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: give registers to the consumers; one thread keeps the ring
    // full, a stage at a time once both warpgroups have released it.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_4d(q_s + c * BQ * L::kRowBytes, &tq, q_full, c * CB, h, q_start, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty + 8 * s, ((j / S) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kKVBytes);
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c) {
          const uint32_t box = s * L::kKVBytes + c * BK * L::kRowBytes;
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
    // <= this warpgroup's first row
    const int clear_to = causal ? min(seq_len, wg_row0 + 1) : seq_len;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    // scores are scaled after the product into log2 units, so every
    // exponential is one ex2; m is kept in those units
    const float sl = scale * 1.4426950408889634f;  // log2(e)
    const uint32_t q_wg = q_s + 64 * cw * L::kRowBytes;  // this warpgroup's rows
    mbar_wait(q_full, 0);

    for (int j = 0; j < n_kv; ++j) {
      const int s = j % S;
      const int k_start = j * BK;
      mbar_wait(full + 8 * s, (j / S) & 1);

      // S = Q K^T: D/16 slices of 16 columns, both operands K-major.
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk * 16 % CB) * 2;  // bytes into a row
        const uint32_t qa = q_wg + (kk * 16 / CB) * BQ * L::kRowBytes + col;
        const uint32_t kb = k_s + s * L::kKVBytes + (kk * 16 / CB) * BK * L::kRowBytes + col;
        wgmma_ss<Elem, BK>(sc, wgmma_desc(qa, 16, kSbo, kLayout),
                           wgmma_desc(kb, 16, kSbo, kLayout), kk);
      }
      wgmma_commit();
      wgmma_wait_all();  // this S, and the previous tile's P V
      fence_regs(sc);
      fence_regs(acc);
      // the previous stage's V has been read by its last wgmma
      if (j > 0 && lane == 0) mbar_arrive(empty + 8 * ((j - 1) % S));

      float mx0 = -INFINITY, mx1 = -INFINITY;
      const bool masked = k_start + BK > clear_to;
#pragma unroll
      for (int n8 = 0; n8 < BK / 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = sc[4 * n8 + e] * sl, x1 = sc[4 * n8 + 2 + e] * sl;
          if (masked) {
            const int col = k_start + n8 * 8 + 2 * t + e;
            if (col >= seq_len || (causal && col > row0)) x0 = -INFINITY;
            if (col >= seq_len || (causal && col > row1)) x1 = -INFINITY;
          }
          sc[4 * n8 + e] = x0;
          sc[4 * n8 + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      // a row that has seen only masked keys keeps m = -inf; subtracting 0
      // instead keeps exp() free of NaN (its p and alpha are then 0)
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float alpha0 = ex2_approx(m0 - mu0), alpha1 = ex2_approx(m1 - mu1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < BK / 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = ex2_approx(sc[4 * n8 + e] - mu0),
                      p1 = ex2_approx(sc[4 * n8 + 2 + e] - mu1);
          sc[4 * n8 + e] = p0;
          sc[4 * n8 + 2 + e] = p1;
          rs0 += p0;
          rs1 += p1;
        }
      }
      l0 = l0 * alpha0 + quad_sum(rs0);
      l1 = l1 * alpha1 + quad_sum(rs1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8) {
        acc[4 * n8 + 0] *= alpha0;
        acc[4 * n8 + 1] *= alpha0;
        acc[4 * n8 + 2] *= alpha1;
        acc[4 * n8 + 3] *= alpha1;
      }

      // O += P V: P rounded to Elem straight from the S fragments (register
      // A), V MN-major from the stage as TMA wrote it.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) c_to_a<Elem>(pa[kc], &sc[8 * kc], &sc[8 * kc + 4]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const uint32_t vb = v_s + s * L::kKVBytes + kc * 16 * L::kRowBytes;
        wgmma_rs_t<Elem, D>(acc, pa[kc], wgmma_desc(vb, BK * L::kRowBytes, kSbo, kLayout));
      }
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(acc);

    // every lane of a quad holds its rows' m and l; one lane writes lse
    Elem* ob = o + b * so.b + h * so.h;
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      const int c = n8 * 8 + 2 * t;
      if (row0 < seq_len) store2(ob + row0 * so.t + c, acc[4 * n8] / d0, acc[4 * n8 + 1] / d0);
      if (row1 < seq_len)
        store2(ob + row1 * so.t + c, acc[4 * n8 + 2] / d1, acc[4 * n8 + 3] / d1);
    }
    if constexpr (kWithLse) {
      constexpr float kLn2 = 0.6931471805599453f;  // m back to natural units
      float* lb = lse + static_cast<long long>(bh) * seq_len;
      if (t == 0 && row0 < seq_len) lb[row0] = m0 * kLn2 + logf(d0);
      if (t == 0 && row1 < seq_len) lb[row1] = m1 * kLn2 + logf(d1);
    }
  }
}

// K3, the ring partial, on mma.sync (fragment layouts in flash_common.cuh):
// `acc` is f32 [B, T, H, D] addressed by `so`, m and l f32 [B, H, T].
template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_partial_mma_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                                 const Elem* __restrict__ v, float* __restrict__ acc_out,
                                 float* __restrict__ m_out, float* __restrict__ l_out,
                                 int heads, int seq_len, Strides sq, Strides sk, Strides sv,
                                 Strides so, float scale, int causal, int q_off, int k_off) {
  constexpr float neg = -1e30f;  // masked score
  constexpr int kPadK = D + 8;        // K row pitch (elements)
  constexpr int kPadV = kBlockK + 8;  // transposed-V row pitch
  constexpr int kChunks = D / 8;      // 16-byte chunks per row
  __shared__ __align__(16) Elem Ks[kBlockK][kPadK];
  __shared__ __align__(16) Elem Vt[D][kPadV];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int qtile = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const Elem* qb = q + b * sq.b + h * sq.h;
  const Elem* kb = k + b * sk.b + h * sk.h;
  const Elem* vb = v + b * sv.b + h * sv.h;
  const int row0 = qtile * kBlockQ + warp * 16 + g;
  const int row1 = row0 + 8;
  // key col is masked for query row when col > row + dlt
  const int dlt = q_off - k_off;

  // Q as the A operand of S = Q K^T, held for the whole kv loop.
  uint32_t qa[D / 16][4];
  load_a<Elem, D>(qa, qb, sq.t, row0, seq_len, t);

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m0 = neg, m1 = neg, l0 = 0.f, l1 = 0.f;

  // At dlt = 0, kBlockQ == kBlockK makes this qtile + 1: the diagonal tile.
  const int n_kv = causal ? last_kv_tile(min(seq_len, (qtile + 1) * kBlockQ) - 1, dlt, seq_len,
                                         kBlockK) + 1
                          : (seq_len + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_start = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<Elem, D, kBlockK, kPadK>(Ks, kb, sk.t, k_start, seq_len);
    for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
      const int r = i % kBlockK, c = (i / kBlockK) * 8;  // neighbours along keys
      const int key = k_start + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (key < seq_len) val = *reinterpret_cast<const uint4*>(vb + key * sv.t + c);
      const Elem* e = reinterpret_cast<const Elem*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[c + j][r] = e[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const Elem* kr = &Ks[nt * 8 + g][kc * 16 + 2 * t];
        Mma<Elem>::run(s[nt], qa[kc], ld32(kr), ld32(kr + 8));
      }
    }

    float mx0 = neg, mx1 = neg;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k_start + nt * 8 + 2 * t + j;
        float x0 = s[nt][j] * scale, x1 = s[nt][2 + j] * scale;
        if (col >= seq_len || (causal && col > row0 + dlt)) x0 = neg;
        if (col >= seq_len || (causal && col > row1 + dlt)) x1 = neg;
        s[nt][j] = x0;
        s[nt][2 + j] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    // m is finite (-1e30 for a row that has seen nothing); the masked p are
    // zeroed below
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p0 = expf(s[nt][j] - mn0), p1 = expf(s[nt][2 + j] - mn1);
        // a row still at m = -1e30 would get exp(0) = 1 for a masked key
        if (s[nt][j] <= 0.5f * neg) p0 = 0.f;
        if (s[nt][2 + j] <= 0.5f * neg) p1 = 0.f;
        s[nt][j] = p0;
        s[nt][2 + j] = p1;
        rs0 += p0;
        rs1 += p1;
      }
    }
    l0 = l0 * alpha0 + quad_sum(rs0);
    l1 = l1 * alpha1 + quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= alpha0;
      acc[nd][1] *= alpha0;
      acc[nd][2] *= alpha1;
      acc[nd][3] *= alpha1;
    }

    // acc += P V, P rounded to the input type straight from the S fragments.
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      uint32_t pa[4];
      c_to_a<Elem>(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const Elem* vr = &Vt[nd * 8 + g][kc * 16 + 2 * t];
        Mma<Elem>::run(acc[nd], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  // every lane of a quad holds its rows' m and l; one lane writes them
  float* ob = acc_out + b * so.b + h * so.h;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (row0 < seq_len) store2(ob + row0 * so.t + c, acc[nd][0], acc[nd][1]);
    if (row1 < seq_len) store2(ob + row1 * so.t + c, acc[nd][2], acc[nd][3]);
  }
  const long long stat_row = static_cast<long long>(bh) * seq_len;
  float *mb = m_out + stat_row, *lb = l_out + stat_row;
  if (t == 0 && row0 < seq_len) mb[row0] = m0, lb[row0] = l0;
  if (t == 0 && row1 < seq_len) mb[row1] = m1, lb[row1] = l1;
}

// f32 path: full-precision FMA. Each thread owns BQ*D/kThreads accumulator
// entries; the row statistics are kept in shared memory.
template <int D, int kMode>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, void* __restrict__ o,
                         float* __restrict__ st0, float* __restrict__ st1, int heads,
                         int seq_len, Strides sq, Strides sk, Strides sv, Strides so,
                         float scale, int causal, int q_off, int k_off) {
  constexpr int BQ = kF32BlockQ, BK = kF32BlockK;
  constexpr float neg = kMode == kPartial ? -1e30f : -INFINITY;  // masked score
  constexpr int kPer = BQ * D / kThreads;
  __shared__ float Qs[BQ][D + 1];
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D];
  __shared__ float Ss[BQ][BK + 1];
  __shared__ float m_s[BQ], l_s[BQ], alpha_s[BQ];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = static_cast<float*>(o) + b * so.b + h * so.h;
  const int dlt = kMode == kPartial ? q_off - k_off : 0;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q_start + r;
    Qs[r][c] = row < seq_len ? qb[row * sq.t + c] : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = neg;
    l_s[tid] = 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.f;

  const int n_kv = causal ? last_kv_tile(min(seq_len, q_start + BQ) - 1, dlt, seq_len, BK) + 1
                          : (seq_len + BK - 1) / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D, key = k_start + r;
      Ks[r][c] = key < seq_len ? kb[key * sk.t + c] : 0.f;
      Vs[r][c] = key < seq_len ? vb[key * sv.t + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[r][d], Ks[c][d], dot);
      float x = dot * scale;
      const int key = k_start + c;
      if (key >= seq_len || (causal && key > q_start + r + dlt)) x = neg;
      Ss[r][c] = x;
    }
    __syncthreads();
    if (tid < BQ) {
      float mx = neg;
      for (int c = 0; c < BK; ++c) mx = fmaxf(mx, Ss[tid][c]);
      const float mn = fmaxf(m_s[tid], mx);
      const float mu = kMode != kPartial && mn == -INFINITY ? 0.f : mn;
      const float alpha = expf(m_s[tid] - mu);
      float sum = 0.f;
      for (int c = 0; c < BK; ++c) {
        float p = expf(Ss[tid][c] - mu);
        if constexpr (kMode == kPartial) {
          if (Ss[tid][c] <= 0.5f * neg) p = 0.f;
        }
        Ss[tid][c] = p;
        sum += p;
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = mn;
      alpha_s[tid] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = tid + e * kThreads, r = i / D, c = i % D;
      float pv = 0.f;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) pv = fmaf(Ss[r][j], Vs[j][c], pv);
      acc[e] = acc[e] * alpha_s[r] + pv;
    }
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = tid + e * kThreads, r = i / D, c = i % D, row = q_start + r;
    if (row < seq_len)
      ob[row * so.t + c] = kMode == kPartial ? acc[e] : acc[e] / fmaxf(l_s[r], 1e-30f);
  }
  const int row = q_start + tid;
  if (tid < BQ && row < seq_len) {
    const long long at = static_cast<long long>(bh) * seq_len + row;
    if constexpr (kMode == kLse) st0[at] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
    if constexpr (kMode == kPartial) st0[at] = m_s[tid], st1[at] = l_s[tid];
  }
}

// The arguments every forward launch shares.
struct Args {
  const void *q, *k, *v;
  void* o;
  float *st0, *st1;
  int batch, heads, seq_len;
  Strides sq, sk, sv, so;
  float scale;
  int causal, q_off, k_off;
  cudaStream_t stream;
};

// The tensor map of a strided [B, T, H, D] input, boxes of kBoxCols columns
// by `rows` rows.
template <typename Elem, int D>
int make_map(CUtensorMap* map, const void* ptr, const Args& a, const Strides& st, int rows) {
  return make_bthd_map<Elem>(map, ptr, a.batch, a.seq_len, a.heads, D, st.b, st.t, st.h,
                             HopperTiles<D>::kBoxCols, rows);
}

template <typename Elem, int D, bool kWithLse>
int launch_hopper(const Args& a) {
  using L = HopperTiles<D>;
  CUtensorMap tq, tk, tv;
  int rc = make_map<Elem, D>(&tq, a.q, a, a.sq, L::kBlockQ);
  if (rc == 0) rc = make_map<Elem, D>(&tk, a.k, a, a.sk, L::kBlockK);
  if (rc == 0) rc = make_map<Elem, D>(&tv, a.v, a, a.sv, L::kBlockK);
  if (rc) return rc;
  const auto kernel = flash_fwd_hopper_kernel<Elem, D, kWithLse>;
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes));
  if (rc) return rc;
  const dim3 grid(a.batch * a.heads, (a.seq_len + L::kBlockQ - 1) / L::kBlockQ);
  kernel<<<grid, L::kThreads, L::kSmemBytes, a.stream>>>(
      tq, tk, tv, static_cast<Elem*>(a.o), a.st0, a.heads, a.seq_len, a.so, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the Hopper kernel, after the shared-memory opt-in.
template <typename Elem, int D, bool kWithLse>
int hopper_blocks_per_sm() {
  using L = HopperTiles<D>;
  const auto kernel = flash_fwd_hopper_kernel<Elem, D, kWithLse>;
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kSmemBytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, L::kThreads,
                                                    L::kSmemBytes) != cudaSuccess)
    return -1;
  return blocks;
}

template <int D>
int hopper_occupancy(int dtype, int with_lse) {
  if (dtype == 1) return with_lse ? hopper_blocks_per_sm<__half, D, true>()
                                  : hopper_blocks_per_sm<__half, D, false>();
  if (dtype == 2) return with_lse ? hopper_blocks_per_sm<__nv_bfloat16, D, true>()
                                  : hopper_blocks_per_sm<__nv_bfloat16, D, false>();
  return -1;
}

template <typename Elem, int D>
int launch_partial(const Args& a) {
  const dim3 grid(a.batch * a.heads, (a.seq_len + kBlockQ - 1) / kBlockQ);
  flash_fwd_partial_mma_kernel<Elem, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const Elem*>(a.q), static_cast<const Elem*>(a.k),
      static_cast<const Elem*>(a.v), static_cast<float*>(a.o), a.st0, a.st1, a.heads, a.seq_len,
      a.sq, a.sk, a.sv, a.so, a.scale, a.causal, a.q_off, a.k_off);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kMode>
int launch_f32(const Args& a) {
  const dim3 grid(a.batch * a.heads, (a.seq_len + kF32BlockQ - 1) / kF32BlockQ);
  flash_fwd_f32_kernel<D, kMode><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.o, a.st0, a.st1, a.heads, a.seq_len, a.sq, a.sk, a.sv,
      a.so, a.scale, a.causal, a.q_off, a.k_off);
  return static_cast<int>(cudaGetLastError());
}

// f32 on the FMA kernel; 16-bit K1/K2 on the Hopper kernel, K3 on mma.sync.
template <int D, int kMode>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_f32<D, kMode>(a);
  if (dtype != 1 && dtype != 2) return -1;
  if constexpr (kMode == kPartial) {
    return dtype == 1 ? launch_partial<__half, D>(a) : launch_partial<__nv_bfloat16, D>(a);
  } else {
    return dtype == 1 ? launch_hopper<__half, D, kMode == kLse>(a)
                      : launch_hopper<__nv_bfloat16, D, kMode == kLse>(a);
  }
}

template <int kMode>
int dispatch(int dtype, int head_dim, const void* q, const void* k, const void* v, void* o,
             float* st0, float* st1, int batch, int heads, int seq_len, const long long* st,
             float scale, int causal, int q_off, int k_off, void* stream) {
  const Args a{q, k, v, o, st0, st1, batch, heads, seq_len,
               Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
               Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
               scale, causal, q_off, k_off, static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 16:
      return launch<16, kMode>(dtype, a);
    case 32:
      return launch<32, kMode>(dtype, a);
    case 64:
      return launch<64, kMode>(dtype, a);
    case 128:
      return launch<128, kMode>(dtype, a);
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. `strides` holds the (batch,
// time, head) strides of q, k, v and o, in elements. Each returns
// cudaGetLastError() after the launch, or -1 for a dtype or head dim this
// kernel does not take.
extern "C" int dl4j_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                              const void* v, void* o, int batch, int heads, int seq_len,
                              const long long* strides, float scale, int causal,
                              void* stream) {
  return dispatch<kPlain>(dtype, head_dim, q, k, v, o, nullptr, nullptr, batch, heads, seq_len,
                          strides, scale, causal, 0, 0, stream);
}

// K2: as dl4j_flash_fwd, plus lse, f32 [batch, heads, seq_len] contiguous.
extern "C" int dl4j_flash_fwd_lse(int dtype, int head_dim, const void* q, const void* k,
                                  const void* v, void* o, float* lse, int batch, int heads,
                                  int seq_len, const long long* strides, float scale,
                                  int causal, void* stream) {
  return dispatch<kLse>(dtype, head_dim, q, k, v, o, lse, nullptr, batch, heads, seq_len,
                        strides, scale, causal, 0, 0, stream);
}

// K3: the unnormalised partial of one ring hop. acc is f32 [batch, seq_len,
// heads, head_dim] addressed by the fourth strides; m and l are f32 [batch,
// heads, seq_len] contiguous. q_off and k_off are the global positions of
// the q chunk's and the kv chunk's first rows (the causal mask keeps
// q_off + row >= k_off + col).
extern "C" int dl4j_flash_fwd_partial(int dtype, int head_dim, const void* q, const void* k,
                                      const void* v, float* acc, float* m, float* l,
                                      int batch, int heads, int seq_len,
                                      const long long* strides, float scale, int causal,
                                      int q_off, int k_off, void* stream) {
  return dispatch<kPartial>(dtype, head_dim, q, k, v, acc, m, l, batch, heads, seq_len, strides,
                            scale, causal, q_off, k_off, stream);
}

// The Hopper kernel of K1 (with_lse = 0) or K2 (1) for a 16-bit dtype (1 =
// float16, 2 = bfloat16): its resident blocks per SM and, through the
// pointers, its threads and dynamic shared memory per block. -1 for a dtype
// or head dim it does not take.
extern "C" int dl4j_flash_fwd_occupancy(int dtype, int head_dim, int with_lse, int* threads,
                                        int* smem_bytes) {
  switch (head_dim) {
    case 16:
      *threads = HopperTiles<16>::kThreads, *smem_bytes = HopperTiles<16>::kSmemBytes;
      return hopper_occupancy<16>(dtype, with_lse);
    case 32:
      *threads = HopperTiles<32>::kThreads, *smem_bytes = HopperTiles<32>::kSmemBytes;
      return hopper_occupancy<32>(dtype, with_lse);
    case 64:
      *threads = HopperTiles<64>::kThreads, *smem_bytes = HopperTiles<64>::kSmemBytes;
      return hopper_occupancy<64>(dtype, with_lse);
    case 128:
      *threads = HopperTiles<128>::kThreads, *smem_bytes = HopperTiles<128>::kSmemBytes;
      return hopper_occupancy<128>(dtype, with_lse);
  }
  return -1;
}
