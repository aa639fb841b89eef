// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): strides, the mma.sync m16n8k16 wrapper and its
// fragment helpers (the ring partial's loop; the Hopper kernels' register-A
// wgmma takes the same A fragment), paired stores, quad reductions.
//
// mma.m16n8k16 fragments, with g = lane / 4, t = lane % 4:
//   A (16x16, row-major): a0 = (row g, k 2t..2t+1), a1 = (row g+8, same k),
//                         a2 = (row g, k 2t+8..2t+9), a3 = (row g+8, same k)
//   B (16x8, col-major):  b0 = (k 2t..2t+1, col g), b1 = (k 2t+8..2t+9, col g)
//   C (16x8, f32):        c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, same cols)
// The C fragments of two neighbouring 8-column tiles are, once rounded and
// packed, the A fragment of the 16-wide k chunk they cover (`c_to_a`): a
// product's f32 result feeds the next product without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Strides {
  long long b, t, h;  // in elements; the innermost (head-dim) stride is 1
};

template <typename Elem>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// Two neighbouring f32 results stored to neighbouring elements of an output
// row: as they are for f32, rounded and packed for the 16-bit types.
template <typename Out>
__device__ __forceinline__ void store2(Out* p, float lo, float hi) {
  if constexpr (std::is_same<Out, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  } else {
    *reinterpret_cast<uint32_t*>(p) = Mma<Out>::pack(lo, hi);
  }
}

// Two neighbouring elements of a row as one 32-bit register.
template <typename Elem>
__device__ __forceinline__ uint32_t ld32(const Elem* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of k chunk kc (16 columns) from the f32 C fragments of the
// 8-column tiles 2kc and 2kc+1, rounded to Elem.
template <typename Elem>
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = Mma<Elem>::pack(lo[0], lo[1]);
  a[1] = Mma<Elem>::pack(lo[2], lo[3]);
  a[2] = Mma<Elem>::pack(hi[0], hi[1]);
  a[3] = Mma<Elem>::pack(hi[2], hi[3]);
}

// Rows r0 and r1 = r0 + 8 of a [rows, D] tile addressed by `row_stride`, as
// the A fragments of its D/16 k chunks; rows at or past `n_rows` read as 0.
template <typename Elem, int D>
__device__ __forceinline__ void load_a(uint32_t a[D / 16][4], const Elem* base,
                                       long long row_stride, int r0, int n_rows, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    a[kc][0] = r0 < n_rows ? ld32(base + r0 * row_stride + c) : 0u;
    a[kc][1] = r1 < n_rows ? ld32(base + r1 * row_stride + c) : 0u;
    a[kc][2] = r0 < n_rows ? ld32(base + r0 * row_stride + c + 8) : 0u;
    a[kc][3] = r1 < n_rows ? ld32(base + r1 * row_stride + c + 8) : 0u;
  }
}

// Rows [row0, row0 + kRows) of a [T, D] tensor addressed by `row_stride` into
// a row-major shared tile of pitch kPitch, as 16-byte vectors; rows at or past
// `n_rows` are zero.
template <typename Elem, int D, int kRows, int kPitch>
__device__ __forceinline__ void stage_rows(Elem (*tile)[kPitch], const Elem* base,
                                           long long row_stride, int row0, int n_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows) val = *reinterpret_cast<const uint4*>(base + row * row_stride + c);
    *reinterpret_cast<uint4*>(&tile[r][c]) = val;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
