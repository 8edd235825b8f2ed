// Hopper building blocks shared by the port's tensor-core walks (dense_mm,
// gmm, bs_attn, dsmm, sddmm, bsmm, bsmm_balanced): value conversions,
// mbarriers, TMA tile loads, cp.async, shared-memory matrix descriptors,
// wgmma (A from shared memory or from registers), the warp-level mma.sync
// m16n8k16 with its ldmatrix loads and swizzled block layout, and the
// tensor-map encoder.  Header only; every source that includes it is
// rebuilt when it changes (``kernels/_build.py`` hashes the headers a
// source includes).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace hopper {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

// two floats rounded to a packed pair of 16-bit values, the first in the
// low half (the lower column of a wgmma fragment)
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// cp.async (16 bytes a thread)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// one box of a tensor map into shared memory, completion counted in bytes
// on `bar`; coordinates innermost first, out-of-bounds elements zero
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor of a tile written by TMA with a
// `swizzle`-byte swizzle (128 or 64): start address, leading and stride
// byte offsets, layout type (1 = 128-byte, 2 = 64-byte swizzle)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              int swizzle = 128) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(swizzle == 128 ? 1 : 2) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving register reads and writes of an
// accumulator across the asynchronous wgmma that owns it
template <int R> __device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HP_L0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HP_L1 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HP_L2 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define HP_L3 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HP_L4 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define HP_L5 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define HP_L6                                                                            \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111"
#define HP_L7                                                                            \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "   \
  "%126, %127"
#define HP_R16 "{" HP_L0 "}"
#define HP_R32 "{" HP_L0 ", " HP_L1 "}"
#define HP_R64 "{" HP_L0 ", " HP_L1 ", " HP_L2 ", " HP_L3 "}"
#define HP_R96 "{" HP_L0 ", " HP_L1 ", " HP_L2 ", " HP_L3 ", " HP_L4 ", " HP_L5 "}"
#define HP_R128 \
  "{" HP_L0 ", " HP_L1 ", " HP_L2 ", " HP_L3 ", " HP_L4 ", " HP_L5 ", " HP_L6 ", " HP_L7 "}"

#define HP_F8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HP_D16 HP_F8(0), HP_F8(8)
#define HP_D32 HP_D16, HP_F8(16), HP_F8(24)
#define HP_D64 HP_D32, HP_F8(32), HP_F8(40), HP_F8(48), HP_F8(56)
#define HP_D96 HP_D64, HP_F8(64), HP_F8(72), HP_F8(80), HP_F8(88)
#define HP_D128 \
  HP_D64, HP_F8(64), HP_F8(72), HP_F8(80), HP_F8(88), HP_F8(96), HP_F8(104), HP_F8(112), HP_F8(120)

// d[64 x N] (+)= A[64 x 16] . B[16 x N], A and B from shared memory (A
// K-major; B K-major with TB = 0, MN-major with TB = 1); scale_d 0 ignores
// d's old value
template <int N, typename T> struct WgmmaSS;
// the same with A from registers: four 32-bit registers a thread, each a
// packed pair, in the accumulator fragment's row and column order
template <int N, typename T> struct WgmmaRS;

#define HP_SS_ASM(SHAPE, TY, REGS, IA, IB, IP, IT)                                          \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " IP ", 0;\n"                                           \
  "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " " REGS ", " IA ", " IB            \
  ", p, 1, 1, 0, " IT ";\n}\n"
#define HP_RS_ASM(SHAPE, TY, REGS, IA, IB, IP, IT)                                          \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " IP ", 0;\n"                                           \
  "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " " REGS ", " IA ", " IB            \
  ", p, 1, 1, " IT ";\n}\n"

#define HP_DEF_SS(N, CT, SHAPE, TY, REGS, OUTS, IA, IB, IP, IT)                             \
  template <> struct WgmmaSS<N, CT> {                                                       \
    template <int TB>                                                                       \
    static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b,            \
                                               uint32_t scale_d) {                          \
      asm volatile(HP_SS_ASM(SHAPE, TY, REGS, IA, IB, IP, IT)                               \
                   : OUTS                                                                   \
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TB));                                \
    }                                                                                       \
  };
#define HP_DEF_RS(N, CT, SHAPE, TY, REGS, OUTS, IA, IB, IP, IT)                             \
  template <> struct WgmmaRS<N, CT> {                                                       \
    template <int TB>                                                                       \
    static __device__ __forceinline__ void run(float* d, const uint32_t* a, uint64_t b,     \
                                               uint32_t scale_d) {                          \
      asm volatile(HP_RS_ASM(SHAPE, TY, REGS, IA, IB, IP, IT)                               \
                   : OUTS                                                                   \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),      \
                     "n"(TB));                                                              \
    }                                                                                       \
  };

HP_DEF_SS(64, __nv_bfloat16, "m64n64k16", "bf16", HP_R32, HP_D32, "%32", "%33", "%34", "%35")
HP_DEF_SS(64, __half, "m64n64k16", "f16", HP_R32, HP_D32, "%32", "%33", "%34", "%35")
HP_DEF_SS(128, __nv_bfloat16, "m64n128k16", "bf16", HP_R64, HP_D64, "%64", "%65", "%66", "%67")
HP_DEF_SS(128, __half, "m64n128k16", "f16", HP_R64, HP_D64, "%64", "%65", "%66", "%67")

HP_DEF_RS(32, __nv_bfloat16, "m64n32k16", "bf16", HP_R16, HP_D16, "{%16, %17, %18, %19}",
          "%20", "%21", "%22")
HP_DEF_RS(32, __half, "m64n32k16", "f16", HP_R16, HP_D16, "{%16, %17, %18, %19}", "%20",
          "%21", "%22")
HP_DEF_RS(64, __nv_bfloat16, "m64n64k16", "bf16", HP_R32, HP_D32, "{%32, %33, %34, %35}",
          "%36", "%37", "%38")
HP_DEF_RS(64, __half, "m64n64k16", "f16", HP_R32, HP_D32, "{%32, %33, %34, %35}", "%36",
          "%37", "%38")
HP_DEF_RS(128, __nv_bfloat16, "m64n128k16", "bf16", HP_R64, HP_D64, "{%64, %65, %66, %67}",
          "%68", "%69", "%70")
HP_DEF_RS(128, __half, "m64n128k16", "f16", HP_R64, HP_D64, "{%64, %65, %66, %67}", "%68",
          "%69", "%70")
HP_DEF_RS(192, __nv_bfloat16, "m64n192k16", "bf16", HP_R96, HP_D96, "{%96, %97, %98, %99}",
          "%100", "%101", "%102")
HP_DEF_RS(192, __half, "m64n192k16", "f16", HP_R96, HP_D96, "{%96, %97, %98, %99}", "%100",
          "%101", "%102")
HP_DEF_RS(256, __nv_bfloat16, "m64n256k16", "bf16", HP_R128, HP_D128,
          "{%128, %129, %130, %131}", "%132", "%133", "%134")
HP_DEF_RS(256, __half, "m64n256k16", "f16", HP_R128, HP_D128, "{%128, %129, %130, %131}",
          "%132", "%133", "%134")

// ---------------------------------------------------------------------------
// warp-level mma.sync and ldmatrix
// ---------------------------------------------------------------------------

// four 8 x 8 matrices of 16-bit values from shared memory: lane l gives
// the address of row l % 8 of matrix l / 8 (16 bytes); register j of lane
// t holds matrix j's elements (t / 4, 2 (t % 4)) and (t / 4, 2 (t % 4) +
// 1), with .trans (2 (t % 4), t / 4) and (2 (t % 4) + 1, t / 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d[16 x 8] += A[16 x 16] . B[16 x 8] with fp32 accumulation, one warp:
// a holds A's fragment (rows g, g + 8 and columns 2 t, + 1, + 8, + 9 of
// lane 4 g + t, in the order (g, k lo), (g + 8, k lo), (g, k hi), (g + 8,
// k hi)), b B's (rows 2 t, + 1 and 8 + 2 t, + 1 of column g), d rows g
// and g + 8, columns 2 t and 2 t + 1
template <typename T> struct Mma16816;
#define HP_DEF_MMA(CT, TY)                                                                  \
  template <> struct Mma16816<CT> {                                                         \
    static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],       \
                                               uint32_t b0, uint32_t b1) {                  \
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "                \
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"        \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                          \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));         \
    }                                                                                       \
  };
HP_DEF_MMA(__nv_bfloat16, "bf16")
HP_DEF_MMA(__half, "f16")

// byte offset of 16-byte chunk c of row r in a tile of SW-byte rows
// swizzled as TMA does (rows past 128 bytes: their 128-byte halves lie in
// tiles FS * 128 bytes apart); the layout the mma walks give the blocks
// they copy with cp.async and read with ldmatrix
template <int SW, int FS>
__device__ __forceinline__ int slab_at(int r, int c) {
  const int h = c / (SW / 16), cs = c % (SW / 16);
  return h * (FS * 128) + r * SW + 16 * (cs ^ ((r * SW >> 7) & (SW / 16 - 1)));
}

// ---------------------------------------------------------------------------
// tensor maps (host)
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime's entry-point
// query (no -lcuda at build time)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

template <typename T> constexpr CUtensorMapDataType tma_type();
template <> constexpr CUtensorMapDataType tma_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> constexpr CUtensorMapDataType tma_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// a `rank`-D map of 16-bit values: dims innermost first, strides in bytes
// of dims 1.., box in elements; `swizzle` bytes (128, 64 or 32) must hold
// the box's innermost row
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType ty, int rank, const void* base,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                       int swizzle = 128) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return fn(map, ty, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
            : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 2-D row-major [rows, cols] 16-bit tensor, box [box_rows, 64], 128-byte swizzle
inline bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                     CUtensorMapDataType ty) {
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return encode_map(map, ty, 2, base, dims, strides, box);
}

}  // namespace hopper
