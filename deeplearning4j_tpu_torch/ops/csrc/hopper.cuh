// Hopper (sm_90a) building blocks for hand-written kernels, as plain PTX:
// TMA tensor maps and 4-D tile loads, mbarrier rings with bounded waits,
// wgmma shared-memory descriptors and the two wgmma forms the flash kernels
// use (both operands in shared memory; A in registers, B MN-major), and
// setmaxnreg for warp specialisation.
//
// Swizzle. A TMA box whose rows are 32, 64 or 128 bytes wide is written with
// the swizzle of that width, and wgmma reads it through a descriptor of the
// same mode. A tile must start on a multiple of its swizzle atom (8 rows:
// 256, 512 or 1024 bytes); every tile here starts on 1024 bytes, so the
// descriptors' base-offset field stays 0. Wider rows (a 16-bit head of 128)
// load as two 64-column boxes, one after the other in shared memory.
//
// Descriptors (bits: start address >> 4 at 0, LBO >> 4 at 16, SBO >> 4 at
// 32, layout at 62). For a tile of `rows` rows of `cb` 16-bit columns per box:
//   K-major operand (the reduction dim runs along a row: Q, K in S = Q K^T;
//     dO, V in dP = dO V^T; and their transposes): SBO = 8 rows * row bytes,
//     the step between 8-row groups; LBO is unused; the k-th 16-column slice
//     starts (16k / cb) boxes and (16k % cb) * 2 bytes in.
//   MN-major operand (the reduction dim runs down the rows: V in O += P V, K
//     in dQ += dS K, dO and Q in dV += P^T dO and dK += dS^T Q; the transpose
//     bit of wgmma is set): SBO = 8 rows * row bytes, the step between the two
//     8-row groups of one k16 slice; LBO = one box (rows * row bytes), the step
//     between 64-column groups of N; the k-th slice of 16 rows starts
//     16k * row bytes in.
// One shared tile serves both ways: the backward reads Q, dO and K K-major
// in one product and MN-major in the next, with the same swizzle.
//
// A wait that never ends would hang the card, so each mbarrier wait gives up
// after kWaitNs and traps: the launch then fails with an error that the
// caller's synchronise reports.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned long long kWaitNs = 2000000000ull;  // 2 s

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// The barrier inits visible to the async proxy (TMA) and the other threads;
// follow with __syncthreads().
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return ns;
}

// Wait until the phase of parity `parity` has completed; trap after kWaitNs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  if (done) return;
  const unsigned long long start = global_ns();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (global_ns() - start > kWaitNs) __trap();
  }
}

// ---------------------------------------------------------------- TMA

// One box of a 4-D tensor map at coordinates (c0 innermost .. c3) into shared
// memory at `dst`, completing `bytes` of the transaction on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The wgmma / TMA swizzle mode for rows of `row_bytes` (32, 64 or 128).
__host__ __device__ constexpr int swizzle_layout(int row_bytes) {
  return row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
}

inline CUtensorMapSwizzle tma_swizzle(int row_bytes) {
  return row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// cuTensorMapEncodeTiled from the CUDA driver, through the runtime (no -lcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* ptr = nullptr;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

template <typename Elem>
struct TmaType;
template <>
struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct TmaType<__half> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

constexpr int kNoEncoder = 900;      // the CUDA driver has no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = 1000;  // + the CUDA driver's CUresult

// The tensor map of a strided [B, T, H, D] input (element strides sb, st, sh;
// the head dim's is 1), dims (D, H, T, B) innermost first, boxes of
// (box_cols, 1, rows, 1) swizzled to the box's row width; rows past T load as
// zeros. Returns 0, kNoEncoder or kEncodeFailed + the CUresult.
template <typename Elem>
int make_bthd_map(CUtensorMap* map, const void* ptr, int batch, int seq_len, int heads, int d,
                  long long sb, long long st, long long sh, int box_cols, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq_len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * sizeof(Elem),
                                 static_cast<cuuint64_t>(st) * sizeof(Elem),
                                 static_cast<cuuint64_t>(sb) * sizeof(Elem)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1, static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, TmaType<Elem>::value, 4, const_cast<void*>(ptr), dims, strides,
                             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             tma_swizzle(box_cols * static_cast<int>(sizeof(Elem))),
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(rc);
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               int layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Ties registers that an in-flight wgmma writes to this point of the
// program, so the compiler neither reads them earlier nor moves writes past.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], both K-major in shared memory;
// scale_d = 0 overwrites D. Accumulator fragment of thread (warp w, lane
// 4g + t): d[4j + 0, 1] = row 16w + g, cols 8j + 2t, +1; d[4j + 2, 3] = row
// 16w + g + 8, the same cols.
template <typename Elem, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d);

// D[64 x N] += A[64 x 16] B[16 x N], A from registers (the mma.sync m16n8k16
// A fragment of each warp's 16 rows), B MN-major in shared memory.
template <typename Elem, int N>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t b);

// The specialisations differ only in the PTX type and N. An accumulator of n
// floats is PTX operands %0..%n-1 (DL4J_D<n>, bound by DL4J_ACC<n>); the
// operands after it are numbered from n: register-A form {A0..A3}, B, then
// scale_d (DL4J_RS_AB<n>, DL4J_RS_P<n>); shared-A form A, B, then scale_d
// (DL4J_SS_AB<n>, DL4J_SS_P<n>).
#define DL4J_F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DL4J_ACC8 DL4J_F8(0)
#define DL4J_ACC16 DL4J_ACC8, DL4J_F8(8)
#define DL4J_ACC32 DL4J_ACC16, DL4J_F8(16), DL4J_F8(24)
#define DL4J_ACC64 DL4J_ACC32, DL4J_F8(32), DL4J_F8(40), DL4J_F8(48), DL4J_F8(56)
#define DL4J_D8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define DL4J_D16 DL4J_D8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define DL4J_D32 DL4J_D16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define DL4J_D64 DL4J_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
                          "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define DL4J_RS_AB8 "{%8, %9, %10, %11}, %12"
#define DL4J_RS_AB16 "{%16, %17, %18, %19}, %20"
#define DL4J_RS_AB32 "{%32, %33, %34, %35}, %36"
#define DL4J_RS_AB64 "{%64, %65, %66, %67}, %68"
#define DL4J_RS_P8 "%13"
#define DL4J_RS_P16 "%21"
#define DL4J_RS_P32 "%37"
#define DL4J_RS_P64 "%69"
#define DL4J_SS_AB16 "%16, %17"
#define DL4J_SS_AB32 "%32, %33"
#define DL4J_SS_AB64 "%64, %65"
#define DL4J_SS_P16 "%18"
#define DL4J_SS_P32 "%34"
#define DL4J_SS_P64 "%66"

#define DL4J_WGMMA_SS(Elem, ty, N, n)                                                   \
  template <>                                                                           \
  __device__ __forceinline__ void wgmma_ss<Elem, N>(float (&d)[n], uint64_t a,          \
                                                    uint64_t b, int scale_d) {          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " DL4J_SS_P##n ", 0;\n"               \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." ty "." ty " "         \
                 "{" DL4J_D##n "}, " DL4J_SS_AB##n ", p, 1, 1, 0, 0;\n}\n"               \
                 : DL4J_ACC##n                                                          \
                 : "l"(a), "l"(b), "r"(scale_d));                                       \
  }

#define DL4J_WGMMA_RS_T(Elem, ty, N, n)                                                 \
  template <>                                                                           \
  __device__ __forceinline__ void wgmma_rs_t<Elem, N>(float (&d)[n],                    \
                                                      const uint32_t (&a)[4], uint64_t b) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " DL4J_RS_P##n ", 0;\n"               \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." ty "." ty " "         \
                 "{" DL4J_D##n "}, " DL4J_RS_AB##n ", p, 1, 1, 1;\n}\n"                   \
                 : DL4J_ACC##n                                                          \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));         \
  }

DL4J_WGMMA_SS(__nv_bfloat16, "bf16", 32, 16)
DL4J_WGMMA_SS(__nv_bfloat16, "bf16", 64, 32)
DL4J_WGMMA_SS(__nv_bfloat16, "bf16", 128, 64)
DL4J_WGMMA_SS(__half, "f16", 32, 16)
DL4J_WGMMA_SS(__half, "f16", 64, 32)
DL4J_WGMMA_SS(__half, "f16", 128, 64)
DL4J_WGMMA_RS_T(__nv_bfloat16, "bf16", 16, 8)
DL4J_WGMMA_RS_T(__nv_bfloat16, "bf16", 32, 16)
DL4J_WGMMA_RS_T(__nv_bfloat16, "bf16", 64, 32)
DL4J_WGMMA_RS_T(__nv_bfloat16, "bf16", 128, 64)
DL4J_WGMMA_RS_T(__half, "f16", 16, 8)
DL4J_WGMMA_RS_T(__half, "f16", 32, 16)
DL4J_WGMMA_RS_T(__half, "f16", 64, 32)
DL4J_WGMMA_RS_T(__half, "f16", 128, 64)

}  // namespace
