// Flash-attention forward for NVIDIA Hopper (sm_90a), in three modes:
//  * K1 (`dl4j_flash_fwd`) replaces the TPU kernel `_kernel` in
//    deeplearning4j_tpu/ops/flash_attention.py (its grid step
//    `_online_softmax_step`), which `_flash_fwd_bthd(with_lse=False)` launches
//    for inference;
//  * K2 (`dl4j_flash_fwd_lse`) replaces `_kernel_lse`, which
//    `_flash_fwd_bthd(with_lse=True)` launches for the training forward `_fwd`.
//    It is K1 in the compile-time mode kLse: the epilogue also writes
//    the per-row logsumexp lse = m + log(max(l, 1e-30)) as f32 [B, H, T], the
//    one residual the backward kernels (flash_attention_bwd.cu) need beyond
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
// the products go through the tensor cores. K3 at one visible hop of T=8192
// over a ring of 4 (B=4, Tq=Tk=2048, H=8, D=64, bf16): 4*B*H*Tq*Tk*D =
// 3.44e10 FLOP, 0.035 ms, against 42 MB (q, k, v read; f32 acc, m, l
// written), 0.013 ms: compute-bound too.
//
// Design (a first, simple version; wgmma, TMA and warp specialisation come
// later):
//  * bf16/fp16: one block of 4 warps per (batch*head, 64-query tile), each warp
//    owning 16 query rows. Q fragments stay in registers; K tiles of 64 keys
//    are staged row-major in shared memory and V tiles transposed, both padded
//    against bank conflicts. QK^T and PV run on mma.sync.m16n8k16 with f32
//    accumulation; the probabilities are reused from the score accumulators as
//    the A operand of PV without a trip through shared memory.
//  * f32: the same online softmax in plain f32 FMA (no TF32), one block per
//    (batch*head, 16-query tile), tiles of 32 keys in shared memory.
//  * Causal: the kv loop stops at the last tile that holds a key the tile's
//    last query may see (the diagonal tile when the offsets are equal). A
//    ragged last tile is masked by bounds, so any T works. The heaviest causal
//    tiles are scheduled first.
#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr int kBlockQ = kWarps * 16;  // tensor-core path: query rows per block
constexpr int kBlockK = 64;           // tensor-core path: keys per tile
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

// Tensor-core path (fragment layouts in flash_common.cuh). `o` is Elem
// [B, T, H, D] (K1, K2) or K3's f32 acc; `st0` is lse (K2) or m (K3), `st1`
// is l (K3), each f32 [B, H, T]; what a mode does not write is not touched.
template <typename Elem, int D, int kMode>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                         const Elem* __restrict__ v, void* __restrict__ o,
                         float* __restrict__ st0, float* __restrict__ st1, int heads,
                         int seq_len, Strides sq, Strides sk, Strides sv, Strides so,
                         float scale, int causal, int q_off, int k_off) {
  constexpr float neg = kMode == kPartial ? -1e30f : -INFINITY;  // masked score
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
  // key col is masked for query row when col > row + dlt (0 but for K3)
  const int dlt = kMode == kPartial ? q_off - k_off : 0;

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
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    // K1/K2: a row that has seen only masked keys keeps m = -inf; subtracting
    // 0 instead keeps exp() free of NaN (its p and alpha are then 0). K3's m
    // is finite, and its masked p are zeroed below instead.
    const float mu0 = kMode != kPartial && mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = kMode != kPartial && mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = expf(m0 - mu0), alpha1 = expf(m1 - mu1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p0 = expf(s[nt][j] - mu0), p1 = expf(s[nt][2 + j] - mu1);
        if constexpr (kMode == kPartial) {
          // a row still at m = -1e30 would get exp(0) = 1 for a masked key
          if (s[nt][j] <= 0.5f * neg) p0 = 0.f;
          if (s[nt][2 + j] <= 0.5f * neg) p1 = 0.f;
        }
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
  const long long stat_row = static_cast<long long>(bh) * seq_len;
  if constexpr (kMode == kPartial) {
    float* ob = static_cast<float*>(o) + b * so.b + h * so.h;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int c = nd * 8 + 2 * t;
      if (row0 < seq_len) store2(ob + row0 * so.t + c, acc[nd][0], acc[nd][1]);
      if (row1 < seq_len) store2(ob + row1 * so.t + c, acc[nd][2], acc[nd][3]);
    }
    float *mb = st0 + stat_row, *lb = st1 + stat_row;
    if (t == 0 && row0 < seq_len) mb[row0] = m0, lb[row0] = l0;
    if (t == 0 && row1 < seq_len) mb[row1] = m1, lb[row1] = l1;
  } else {
    Elem* ob = static_cast<Elem*>(o) + b * so.b + h * so.h;
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int c = nd * 8 + 2 * t;
      if (row0 < seq_len) store2(ob + row0 * so.t + c, acc[nd][0] / d0, acc[nd][1] / d0);
      if (row1 < seq_len) store2(ob + row1 * so.t + c, acc[nd][2] / d1, acc[nd][3] / d1);
    }
    if constexpr (kMode == kLse) {
      float* lse = st0 + stat_row;
      if (t == 0 && row0 < seq_len) lse[row0] = m0 + logf(d0);
      if (t == 0 && row1 < seq_len) lse[row1] = m1 + logf(d1);
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

template <typename Elem, int D, int kMode>
int launch_mma(const Args& a) {
  const dim3 grid(a.batch * a.heads, (a.seq_len + kBlockQ - 1) / kBlockQ);
  flash_fwd_mma_kernel<Elem, D, kMode><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const Elem*>(a.q), static_cast<const Elem*>(a.k),
      static_cast<const Elem*>(a.v), a.o, a.st0, a.st1, a.heads, a.seq_len, a.sq, a.sk, a.sv,
      a.so, a.scale, a.causal, a.q_off, a.k_off);
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

template <int D, int kMode>
int launch(int dtype, const Args& a) {
  switch (dtype) {
    case 0:
      return launch_f32<D, kMode>(a);
    case 1:
      return launch_mma<__half, D, kMode>(a);
    case 2:
      return launch_mma<__nv_bfloat16, D, kMode>(a);
  }
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
