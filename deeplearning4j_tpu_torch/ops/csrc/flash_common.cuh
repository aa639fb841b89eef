// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): strides, the f32 kernels' block size, the packing
// of f32 accumulators into the A fragment of a register-A wgmma, paired
// stores, quad reductions.
//
// Per-warp fragments of 16 rows (those of mma.m16n8k16, which the register-A
// wgmma takes for each warp's rows), with g = lane / 4, t = lane % 4:
//   A (16x16, row-major): a0 = (row g, k 2t..2t+1), a1 = (row g+8, same k),
//                         a2 = (row g, k 2t+8..2t+9), a3 = (row g+8, same k)
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

constexpr int kThreads = 128;  // a block of the f32 kernels: 4 warps

struct Strides {
  long long b, t, h;  // in elements; the innermost (head-dim) stride is 1
};

// Two f32 values rounded to Elem (bf16 or fp16) and packed into one 32-bit
// register, `lo` in the low half.
template <typename Elem>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<Elem, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// Two neighbouring f32 results stored to neighbouring elements of an output
// row: as they are for f32, rounded and packed for the 16-bit types.
template <typename Out>
__device__ __forceinline__ void store2(Out* p, float lo, float hi) {
  if constexpr (std::is_same<Out, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  } else {
    *reinterpret_cast<uint32_t*>(p) = pack2<Out>(lo, hi);
  }
}

// The A fragment of k chunk kc (16 columns) from the f32 C fragments of the
// 8-column tiles 2kc and 2kc+1, rounded to Elem.
template <typename Elem>
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack2<Elem>(lo[0], lo[1]);
  a[1] = pack2<Elem>(lo[2], lo[3]);
  a[2] = pack2<Elem>(hi[0], hi[1]);
  a[3] = pack2<Elem>(hi[2], hi[3]);
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
