// Flash-attention forward for NVIDIA Hopper (sm_90a), three entries:
//  * K1 (`dl4j_flash_fwd`) replaces the TPU kernel `_kernel` in
//    deeplearning4j_tpu/ops/flash_attention.py (its grid step
//    `_online_softmax_step`), which `_flash_fwd_bthd(with_lse=False)` launches
//    for inference;
//  * K2 (`dl4j_flash_fwd_lse`) replaces `_kernel_lse`, which
//    `_flash_fwd_bthd(with_lse=True)` launches for the training forward `_fwd`.
//    The epilogue also writes the per-row logsumexp lse = m + log(max(l,
//    1e-30)) as f32 [B, H, T], the one residual the backward kernels
//    (flash_attention_bwd.cu) need beyond q, k, v, o. A row that saw only
//    masked keys (m = -inf, l = 0) gets lse = -inf, as on the TPU; causal
//    self-attention has none, since the diagonal is always kept;
//  * K3 (`dl4j_flash_fwd_partial`) replaces `_partial_kernel`, which
//    `flash_attention_partial` launches once per hop of ring attention
//    (parallel/ring_attention.py). It writes the UNNORMALISED partial: acc as
//    f32 [B, T, H, D] with no division, and the row max m and sum l as f32
//    [B, H, T], for the ring to fold across hops. The causal mask compares
//    global positions, q_off + row >= k_off + col, where q_off and k_off are
//    the offsets of this q chunk and of the visiting kv chunk. A masked score
//    is the finite -1e30 (the TPU kernel's `_FINITE_NEG`) instead of -inf and
//    p is zeroed where s <= -1e30 / 2, so a row that sees no key of the hop
//    keeps m = -1e30, l = 0, acc = 0 (a -inf there would give NaN in the
//    ring's fold). A block whose queries see no key of the hop (all of a
//    wholly masked hop, k_off > q_off + T - 1) issues no load, waits on no
//    barrier and writes exactly that for every row, as the TPU kernel's
//    skipped grid does.
//
// Computes O = softmax(Q K^T * scale) V over [B, T, H, D] tensors addressed by
// strides (only the innermost stride must be 1), with an online softmax: the
// [T, T] scores never reach device memory. The TPU kernel carries its running
// max m, sum l and accumulator acc across a sequential kv grid dimension; here
// that dimension is a loop inside one thread block, and m, l, acc live in f32
// registers.
//
// Numerics follow the TPU kernel: scores accumulate in f32 and are scaled
// after the product; masked scores are -inf (causal keeps row >= col; K3
// -1e30); l sums the f32 probabilities while the PV product takes them
// rounded to the input type, with f32 accumulation; K1's output is
// acc / max(l, 1e-30) in the input type.
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
// Two kernels:
//  * 16-bit (bf16, fp16, D in {16, 32, 64, 128}), all three entries: the
//    Hopper kernel `flash_fwd_hopper_kernel`, one template with the entry's
//    mode (K1 kPlain, K2 kLse, K3 kPartial) as a parameter. Against the
//    compute bound it keeps the tensor cores fed from shared memory without
//    spending threads on loads (PERF.md):
//    - tiles: one block per (batch*head, query tile) with kv tiles of 128
//      keys (K3: 64, see below); the query tile is 64 rows per consumer
//      warpgroup: 192 rows at D <= 64 (three consumers), 128 at D = 128
//      (two);
//    - warp roles: warpgroup 0 is the producer: it drops to 24 registers
//      (setmaxnreg) and one of its threads issues every load. The consumers
//      own 64 query rows each and rise to 160 registers (three, 512 threads
//      a block) or 240 (two, 384 threads); ptxas reports the launch cap of
//      128 or 168, with no spills;
//    - loads: TMA over 4-D tensor maps of the strided [B, T, H, D] inputs,
//      built by the C entry for each launch; Q once per block, K and V through
//      a ring of 4 shared-memory stages (2 at D = 128; K3 twice as many, of
//      half the keys), each with a "full"
//      mbarrier (the TMA's transaction bytes) and an "empty" one (one arrival
//      per consumer warp once its last wgmma on the stage has completed).
//      Rows of 32, 64 or 128 bytes are swizzled to their width (D = 128 loads
//      as two 64-column boxes); rows past T arrive as zeros and are masked
//      like causal keys. Shared memory: 24 KB of Q + 4 x 2 x 16 KB of K/V at
//      D = 64 (152 KB, and 1 KB of alignment), 160 KB at D = 128: one block
//      per SM;
//    - S = Q K^T on wgmma m64n128k16 (K3 m64n64k16), both operands K-major in
//      shared memory, f32 accumulators (64 a thread; K3 32);
//    - online softmax on the accumulator fragments, reductions within a quad.
//      The f32 scores are scaled after the product by scale * log2(e), so
//      each probability and each rescale factor is one ex2 (the special
//      function unit's rate, not the products', bounds the softmax at D=64);
//      the running max is kept in those units and lse and K3's m convert it
//      back;
//    - O += P V on register-A wgmma m64nDk16: P is rounded to the input type
//      straight from the S accumulators, V is read as TMA left it, as an
//      MN-major operand (the transpose bit): no transpose through registers.
//      With three consumers, one warpgroup's softmax overlaps the others'
//      products; no schedule orders them (no ping-pong);
//    - where a tile's P V is waited for: K3 waits for it before it issues
//      the next tile's S and then releases the stage, as the backward kernels
//      do. K1 and K2 leave it in flight across the next tile's S and rescale
//      O only after both have been waited for; ptxas then serialises every
//      wgmma of theirs (its note C7515), which PERF.md keeps as an open
//      question. ptxas allots registers up to the launch's cap (128 with
//      three consumers, 168 with two), not the consumers' setmaxnreg share:
//      K3's S on 128 keys (64 accumulators a thread) beside O left it too
//      few to keep any wgmma in flight (note C7512), in either loop. On
//      64-key tiles K3's wgmma stay asynchronous (3 waits for 8 wgmma in its
//      SASS, no spills); it ran 1.09x faster than on 128 keys, and the wait
//      1.02-1.05x faster than K1's loop (chip_fwd_ab.py, PERF.md);
//    - K3's epilogue stores acc as f32 pairs through the output strides, l as
//      it is and m in natural units (m ln 2), except a row still at -1e30,
//      which writes exactly -1e30.
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

constexpr int kF32BlockQ = 16;  // f32 path
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

// ------------------------------------------------ the Hopper kernel

// Tiles of the Hopper kernel for head dim D and mode kMode. One block: a
// producer warpgroup (one thread issues every TMA load) and kConsumers
// warpgroups of 64 query rows each.
template <int D, int kMode>
struct HopperTiles {
  // D <= 64: three consumers, so that while one warpgroup runs its softmax
  // the others keep the tensor cores busy; D = 128 has registers for two
  static constexpr int kConsumers = D <= 64 ? 3 : 2;
  static constexpr int kBlockQ = 64 * kConsumers;  // query rows per block
  // keys per kv tile. K3's are 64: with 128, its S accumulators (64 a
  // thread) beside O leave ptxas too few of the launch's 128 (168)
  // registers to keep a wgmma in flight, and it waits after every one
  // (its note C7512; see the header)
  static constexpr int kBlockK = kMode == kPartial ? 64 : 128;
  // K/V ring depth: 4 stages of 128 keys at D <= 64, 2 at D = 128 (shared
  // memory); K3 keeps as many keys in flight in twice the stages
  static constexpr int kStages = (D <= 64 ? 4 : 2) * 128 / kBlockK;
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

// One (batch*head, kBlockQ-query tile) of K1, K2 or K3 (kMode). K1 writes
// o = softmax(Q K^T * scale) V in Elem through `so`; K2 also lse = m +
// log(max(l, 1e-30)) as f32 [B, H, T] (st0); K3 the unnormalised partial:
// acc in f32 through `so`, m (st0) and l (st1) as f32 [B, H, T], with the
// causal mask at the global offsets q_off, k_off (K1 and K2 take 0). q, k, v
// are read through 4-D tensor maps over [B, T, H, D] (dims D, H, T, B); rows
// at or past seq_len load as zeros and are masked like causal keys.
template <typename Elem, int D, int kMode>
__global__ void __launch_bounds__(HopperTiles<D, kMode>::kThreads, 1)
    flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, void* __restrict__ o,
                            float* __restrict__ st0, float* __restrict__ st1, int heads,
                            int seq_len, Strides so, float scale, int causal, int q_off,
                            int k_off) {
  using L = HopperTiles<D, kMode>;
  constexpr int BQ = L::kBlockQ, BK = L::kBlockK, S = L::kStages, CB = L::kBoxCols;
  constexpr int kLayout = swizzle_layout(L::kRowBytes);
  constexpr uint32_t kSbo = 8 * L::kRowBytes;  // 8-row group stride
  // K3 waits for each tile's P V before the next tile's S (see the header)
  constexpr bool kWaitPV = kMode == kPartial;
  // a masked score (in log2 units): -inf, or K3's finite -1e30
  constexpr float kNeg = kMode == kPartial ? -1e30f : -INFINITY;
  constexpr float kLn2 = 0.6931471805599453f;  // m back to natural units
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
  // causal: key col is masked for row r when col > r + dlt
  const int dlt = kMode == kPartial ? q_off - k_off : 0;
  // causal: the tiles up to the last holding a key that the block's last
  // query may see (K1, K2: the one holding it); none for a block of K3 whose
  // queries see no key
  const int n_kv = kMode == kPartial && causal
                       ? last_kv_tile(min(seq_len, q_start + BQ) - 1, dlt, seq_len, BK) + 1
                       : ((causal ? min(seq_len, q_start + BQ) : seq_len) + BK - 1) / BK;
  // K1 and K2 always have a tile to load; K3's block may have none
  const bool any_kv = kMode != kPartial || n_kv > 0;

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
    // full, a stage at a time once every consumer has released it.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && any_kv) {
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
    // visible to this warpgroup's first row
    const int clear_to = !causal             ? seq_len
                         : kMode == kPartial ? max(0, min(seq_len, wg_row0 + dlt + 1))
                                             : min(seq_len, wg_row0 + 1);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
    // scores are scaled after the product into log2 units, so every
    // exponential is one ex2; m is kept in those units
    const float sl = scale * 1.4426950408889634f;  // log2(e)
    const uint32_t q_wg = q_s + 64 * cw * L::kRowBytes;  // this warpgroup's rows
    if (any_kv) mbar_wait(q_full, 0);

    for (int j = 0; j < n_kv; ++j) {
      const int s = j % S;
      const int k_start = j * BK;
      mbar_wait(full + 8 * s, (j / S) & 1);

      // S = Q K^T: D/16 slices of 16 columns, both operands K-major.
      float sc[BK / 2];
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
      wgmma_wait_all();  // this S and, in K1 and K2, the previous tile's P V
      fence_regs(sc);
      if constexpr (!kWaitPV) {
        fence_regs(acc);
        // the previous stage's V has been read by its last wgmma
        if (j > 0 && lane == 0) mbar_arrive(empty + 8 * ((j - 1) % S));
      }

      float mx0 = kNeg, mx1 = kNeg;
      const bool masked = k_start + BK > clear_to;
#pragma unroll
      for (int n8 = 0; n8 < BK / 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = sc[4 * n8 + e] * sl, x1 = sc[4 * n8 + 2 + e] * sl;
          if (masked) {
            const int col = k_start + n8 * 8 + 2 * t + e;
            if (col >= seq_len || (causal && col > row0 + dlt)) x0 = kNeg;
            if (col >= seq_len || (causal && col > row1 + dlt)) x1 = kNeg;
          }
          sc[4 * n8 + e] = x0;
          sc[4 * n8 + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      // K1, K2: a row that has seen only masked keys keeps m = -inf;
      // subtracting 0 instead keeps ex2 free of NaN (its p and alpha are
      // then 0). K3's finite mask keeps alpha finite as it is.
      const float mu0 = kMode != kPartial && mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = kMode != kPartial && mn1 == -INFINITY ? 0.f : mn1;
      const float alpha0 = ex2_approx(m0 - mu0), alpha1 = ex2_approx(m1 - mu1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < BK / 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = ex2_approx(sc[4 * n8 + e] - mu0), p1 = ex2_approx(sc[4 * n8 + 2 + e] - mu1);
          if constexpr (kMode == kPartial) {
            // a row still at m = -1e30 would get ex2(0) = 1 for a masked key
            if (masked && sc[4 * n8 + e] <= 0.5f * kNeg) p0 = 0.f;
            if (masked && sc[4 * n8 + 2 + e] <= 0.5f * kNeg) p1 = 0.f;
          }
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
      if constexpr (kWaitPV) {
        wgmma_wait_all();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + 8 * s);  // the stage's K and V have been read
      }
    }
    wgmma_wait_all();
    fence_regs(acc);

    // every lane of a quad holds its rows' m and l; one lane writes them
    if constexpr (kMode == kPartial) {
      const long long stat_row = static_cast<long long>(bh) * seq_len;
      float* ob = static_cast<float*>(o) + b * so.b + h * so.h;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8) {
        const int c = n8 * 8 + 2 * t;
        if (row0 < seq_len) store2(ob + row0 * so.t + c, acc[4 * n8], acc[4 * n8 + 1]);
        if (row1 < seq_len) store2(ob + row1 * so.t + c, acc[4 * n8 + 2], acc[4 * n8 + 3]);
      }
      // a row that saw no key keeps exactly -1e30, in any units
      if (t == 0 && row0 < seq_len)
        st0[stat_row + row0] = m0 == kNeg ? kNeg : m0 * kLn2, st1[stat_row + row0] = l0;
      if (t == 0 && row1 < seq_len)
        st0[stat_row + row1] = m1 == kNeg ? kNeg : m1 * kLn2, st1[stat_row + row1] = l1;
    } else {
      Elem* ob = static_cast<Elem*>(o) + b * so.b + h * so.h;
      const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8) {
        const int c = n8 * 8 + 2 * t;
        if (row0 < seq_len) store2(ob + row0 * so.t + c, acc[4 * n8] / d0, acc[4 * n8 + 1] / d0);
        if (row1 < seq_len)
          store2(ob + row1 * so.t + c, acc[4 * n8 + 2] / d1, acc[4 * n8 + 3] / d1);
      }
      if constexpr (kMode == kLse) {
        float* lb = st0 + static_cast<long long>(bh) * seq_len;
        if (t == 0 && row0 < seq_len) lb[row0] = m0 * kLn2 + logf(d0);
        if (t == 0 && row1 < seq_len) lb[row1] = m1 * kLn2 + logf(d1);
      }
    }
  }
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
                             HopperTiles<D, kPlain>::kBoxCols, rows);
}

template <typename Elem, int D, int kMode>
int launch_hopper(const Args& a) {
  using L = HopperTiles<D, kMode>;
  CUtensorMap tq, tk, tv;
  int rc = make_map<Elem, D>(&tq, a.q, a, a.sq, L::kBlockQ);
  if (rc == 0) rc = make_map<Elem, D>(&tk, a.k, a, a.sk, L::kBlockK);
  if (rc == 0) rc = make_map<Elem, D>(&tv, a.v, a, a.sv, L::kBlockK);
  if (rc) return rc;
  const auto kernel = flash_fwd_hopper_kernel<Elem, D, kMode>;
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes));
  if (rc) return rc;
  const dim3 grid(a.batch * a.heads, (a.seq_len + L::kBlockQ - 1) / L::kBlockQ);
  kernel<<<grid, L::kThreads, L::kSmemBytes, a.stream>>>(tq, tk, tv, a.o, a.st0, a.st1, a.heads,
                                                         a.seq_len, a.so, a.scale, a.causal,
                                                         a.q_off, a.k_off);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the Hopper kernel, after the shared-memory opt-in.
template <typename Elem, int D, int kMode>
int hopper_blocks_per_sm() {
  using L = HopperTiles<D, kMode>;
  const auto kernel = flash_fwd_hopper_kernel<Elem, D, kMode>;
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kSmemBytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, L::kThreads,
                                                    L::kSmemBytes) != cudaSuccess)
    return -1;
  return blocks;
}

// The Hopper kernel's blocks per SM, threads and dynamic shared memory
// per block (through the pointers) for a 16-bit dtype and a mode.
template <int D, int kMode>
int mode_occupancy(int dtype, int* threads, int* smem_bytes) {
  *threads = HopperTiles<D, kMode>::kThreads, *smem_bytes = HopperTiles<D, kMode>::kSmemBytes;
  if (dtype == 1) return hopper_blocks_per_sm<__half, D, kMode>();
  if (dtype == 2) return hopper_blocks_per_sm<__nv_bfloat16, D, kMode>();
  return -1;
}

template <int D>
int hopper_occupancy(int dtype, int mode, int* threads, int* smem_bytes) {
  if (mode == kPlain) return mode_occupancy<D, kPlain>(dtype, threads, smem_bytes);
  if (mode == kLse) return mode_occupancy<D, kLse>(dtype, threads, smem_bytes);
  if (mode == kPartial) return mode_occupancy<D, kPartial>(dtype, threads, smem_bytes);
  return -1;
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

// f32 on the FMA kernel; 16-bit on the Hopper kernel.
template <int D, int kMode>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_f32<D, kMode>(a);
  if (dtype == 1) return launch_hopper<__half, D, kMode>(a);
  if (dtype == 2) return launch_hopper<__nv_bfloat16, D, kMode>(a);
  return -1;
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

// The Hopper kernel of K1 (mode 0), K2 (1) or K3 (2) for a 16-bit dtype (1 =
// float16, 2 = bfloat16): its resident blocks per SM and, through the
// pointers, its threads and dynamic shared memory per block. -1 for a dtype,
// head dim or mode it does not take.
extern "C" int dl4j_flash_fwd_occupancy(int dtype, int head_dim, int mode, int* threads,
                                        int* smem_bytes) {
  switch (head_dim) {
    case 16:
      return hopper_occupancy<16>(dtype, mode, threads, smem_bytes);
    case 32:
      return hopper_occupancy<32>(dtype, mode, threads, smem_bytes);
    case 64:
      return hopper_occupancy<64>(dtype, mode, threads, smem_bytes);
    case 128:
      return hopper_occupancy<128>(dtype, mode, threads, smem_bytes);
  }
  return -1;
}
