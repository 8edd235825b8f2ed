// Static block-sparse matmul for Hopper, activation-major:
//
//     y[N, M] = x[N, K] . W^T,   W = [M, K] block-sparse, b x b blocks
//
// Replaces the TPU kernel src/repro/kernels/bsmm/bsmm.py `bsmm_call`
// (`_bsmm_kernel`), in the transposed form the sparse FFN needs
// (`spmm_nt`).  The TPU walked one sequential grid over the row-major
// tile list and flushed a VMEM accumulator whenever the row changed.
// Hopper's blocks run in parallel and in no order, so here every output
// tile is owned by one thread block: no carry between blocks, one write
// per output element.  Tiles are b x b (tm = tk = b), so the packed stack
// holds exactly the non-zero blocks (a 128 x 128 tile would be ~100 %
// occupied at d = 1/8 and do 8x the work).  The wrapper (ops.py `walk`)
// picks one of three walks:
//
// 1. "decode" (the fewest tokens, b <= 32): one block per row-tile, its 8
//    warps take the row's tiles in turn (a row holds ~16 tiles at d =
//    1/8), each lane multiplies one tile row straight from global memory
//    into fp32 sums for its tokens, and the warps' sums are added in
//    shared memory at the end.  The row's tile loads are in flight
//    together instead of one per step; bound by the tiles' bytes.
// 2. "mma" (bf16/fp16, b in {16, 32, 64}): tensor cores over groups of
//    block-rows sharing each TMA-fed chunk of x, on the schedule the plan
//    records on the host (bsmm_mma.cuh, shared with bsmm_balanced).
// 3. "ffma" (fp32, b in {4, 8}, and 16-bit where the caller asks): one
//    block per (row-tile, 64-token tile) walks the row's tiles through a
//    CSR row pointer built once on the host, staging each W tile and x
//    slice in shared memory as fp32, with the next tile loaded into
//    registers while the current one is multiplied, on the CUDA cores.
//
// Inputs (all device pointers):
//   x         [n, k]          activations, row-major (16-byte aligned, mma)
//   tiles     [T, tb, tb]     packed tile stack in row-major tile order
//                             (16-byte aligned, mma)
//   row_ptr   [k_rows + 1]    CSR pointer over the tiles, int32
//   tile_cols [T]             tile column of each tile, int32
//   group_rows, stage_ptr, stage_chunk, stage_runs
//                             the mma walk's schedule (bsmm_mma.cuh;
//                             null for the other walks)
//   part      [slices, n, m]  fp32 scratch of the mma walk's K slices
//                             (null where slices = 1)
//   y         [n, m]          output, fully written (an empty row writes 0)
// tb in {4, 8, 16, 32, 64}; dtype 0 = fp32, 1 = bf16, 2 = fp16; output in
// the input dtype, fp32 accumulation.
#include <stddef.h>

#include "bsmm_mma.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kBN = 64;  // tokens per thread block

template <typename T, int TB>
struct Stage {
  static constexpr int kW = (TB * TB + kThreads - 1) / kThreads;
  static constexpr int kX = (kBN * TB) / kThreads;
  float w[kW];
  float x[kX];

  // load tile s and the matching x slice into registers
  __device__ __forceinline__ void load(const T* __restrict__ xg, const T* __restrict__ tiles,
                                       const int* __restrict__ tile_cols, int s, int n0,
                                       int n, int k, int tid) {
    const T* tile = tiles + (size_t)s * TB * TB;
#pragma unroll
    for (int l = 0; l < kW; ++l) {
      const int e = tid + l * kThreads;
      w[l] = e < TB * TB ? to_f<T>(tile[e]) : 0.f;
    }
    const int c0 = tile_cols[s] * TB;
#pragma unroll
    for (int l = 0; l < kX; ++l) {
      const int e = tid + l * kThreads;
      const int tok = n0 + e / TB;
      x[l] = tok < n ? to_f<T>(xg[(size_t)tok * k + c0 + e % TB]) : 0.f;
    }
  }
};

template <typename T, int TB>
__global__ void __launch_bounds__(kThreads)
    bsmm_nt_kernel(const T* __restrict__ x, const T* __restrict__ tiles,
                   const int* __restrict__ row_ptr, const int* __restrict__ tile_cols,
                   T* __restrict__ y, int n, int k, int m) {
  constexpr int kLanes = kThreads / TB;  // token lanes
  constexpr int kPer = kBN / kLanes;     // tokens per thread
  // +1 column of padding keeps the row-strided reads on distinct banks
  __shared__ float ws[TB][TB + 1];
  __shared__ float xs[kBN][TB + 1];

  const int r = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int i = tid % TB;
  const int lane = tid / TB;
  const int s_begin = row_ptr[r];
  const int s_end = row_ptr[r + 1];

  float acc[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) acc[p] = 0.f;

  Stage<T, TB> st;
  if (s_begin < s_end) st.load(x, tiles, tile_cols, s_begin, n0, n, k, tid);
  for (int s = s_begin; s < s_end; ++s) {
#pragma unroll
    for (int l = 0; l < Stage<T, TB>::kW; ++l) {
      const int e = tid + l * kThreads;
      if (e < TB * TB) ws[e / TB][e % TB] = st.w[l];
    }
#pragma unroll
    for (int l = 0; l < Stage<T, TB>::kX; ++l) {
      const int e = tid + l * kThreads;
      xs[e / TB][e % TB] = st.x[l];
    }
    __syncthreads();
    if (s + 1 < s_end) st.load(x, tiles, tile_cols, s + 1, n0, n, k, tid);
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      const float w = ws[i][j];
#pragma unroll
      for (int p = 0; p < kPer; ++p) acc[p] += xs[lane + p * kLanes][j] * w;
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int tok = n0 + lane + p * kLanes;
    if (tok < n) y[(size_t)tok * m + (size_t)r * TB + i] = from_f<T>(acc[p]);
  }
}

constexpr int kWarps = kThreads / 32;
constexpr int kTokPerLane = 4;

// tokens the decode walk takes at tile size TB
template <int TB>
constexpr int decode_max_n() { return TB <= 32 ? (32 / TB) * kTokPerLane : 0; }

template <typename T, int TB>
__global__ void __launch_bounds__(kThreads)
    bsmm_nt_decode_kernel(const T* __restrict__ x, const T* __restrict__ tiles,
                          const int* __restrict__ row_ptr,
                          const int* __restrict__ tile_cols, T* __restrict__ y, int n,
                          int k, int m) {
  constexpr int kGroups = 32 / TB;  // token groups per warp
  constexpr int kMaxN = kGroups * kTokPerLane;
  __shared__ float part[kWarps][kMaxN][TB];

  const int r = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = lane % TB;    // tile row of this lane
  const int grp = lane / TB;  // token group of this lane
  float acc[kTokPerLane];
#pragma unroll
  for (int t = 0; t < kTokPerLane; ++t) acc[t] = 0.f;

  for (int s = row_ptr[r] + warp; s < row_ptr[r + 1]; s += kWarps) {
    const T* wrow = tiles + ((size_t)s * TB + i) * TB;
    const T* xcol = x + (size_t)tile_cols[s] * TB;
    float w[TB];
#pragma unroll
    for (int j = 0; j < TB; ++j) w[j] = to_f<T>(wrow[j]);
#pragma unroll
    for (int t = 0; t < kTokPerLane; ++t) {
      const int tok = grp + t * kGroups;
      if (tok < n) {
        const T* xr = xcol + (size_t)tok * k;
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < TB; ++j) a += to_f<T>(xr[j]) * w[j];
        acc[t] += a;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kTokPerLane; ++t) part[warp][grp + t * kGroups][i] = acc[t];
  __syncthreads();
  for (int e = threadIdx.x; e < n * TB; e += kThreads) {
    const int tok = e / TB, ii = e % TB;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) v += part[wp][tok][ii];
    y[(size_t)tok * m + (size_t)r * TB + ii] = from_f<T>(v);
  }
}

enum Walk { kDecode = 0, kMma = 1, kFfma = 2 };

template <typename T, int TB>
int launch(const void* x, const void* tiles, const void* row_ptr, const void* tile_cols,
           void* y, int n, int k, int m, int walk, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* tt = static_cast<const T*>(tiles);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* tc = static_cast<const int*>(tile_cols);
  T* yt = static_cast<T*>(y);
  if (walk == kDecode) {
    if (n > decode_max_n<TB>()) return (int)cudaErrorInvalidValue;
    bsmm_nt_decode_kernel<T, (TB <= 32 ? TB : 32)><<<m / TB, kThreads, 0, stream>>>(
        xt, tt, rp, tc, yt, n, k, m);
  } else {
    dim3 grid(m / TB, (n + kBN - 1) / kBN);
    bsmm_nt_kernel<T, TB><<<grid, kThreads, 0, stream>>>(xt, tt, rp, tc, yt, n, k, m);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* tiles, const void* row_ptr, const void* tile_cols,
             const void* group_rows, const void* stage_ptr, const void* stage_chunk,
             const void* stage_runs, void* y, float* part, int n, int k, int m, int tb,
             int groups, int rows, int wcap, int slices, int walk, cudaStream_t s) {
  if (walk == kMma) {
    if constexpr (sizeof(T) == 2) {
      return bsmm_mma::run<T>(x, tiles, group_rows, stage_ptr, stage_chunk, stage_runs, y,
                              part, n, k, m, tb, groups, rows, wcap, slices, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (walk != kDecode && walk != kFfma) return (int)cudaErrorInvalidValue;
  switch (tb) {
    case 4: return launch<T, 4>(x, tiles, row_ptr, tile_cols, y, n, k, m, walk, s);
    case 8: return launch<T, 8>(x, tiles, row_ptr, tile_cols, y, n, k, m, walk, s);
    case 16: return launch<T, 16>(x, tiles, row_ptr, tile_cols, y, n, k, m, walk, s);
    case 32: return launch<T, 32>(x, tiles, row_ptr, tile_cols, y, n, k, m, walk, s);
    case 64: return launch<T, 64>(x, tiles, row_ptr, tile_cols, y, n, k, m, walk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// walk 0 = decode (n within the decode kernel's tokens, tb <= 32), 1 = mma
// (16-bit, tb in {16, 32, 64}, with its schedule and K slices), 2 = ffma
extern "C" int bsmm_nt(const void* x, const void* tiles, const void* row_ptr,
                       const void* tile_cols, const void* group_rows, const void* stage_ptr,
                       const void* stage_chunk, const void* stage_runs, void* y, void* part,
                       int n, int k, int m, int tb, int groups, int rows, int wcap, int slices,
                       int dtype, int walk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return dispatch<float>(x, tiles, row_ptr, tile_cols, group_rows, stage_ptr, stage_chunk,
                             stage_runs, y, pt, n, k, m, tb, groups, rows, wcap, slices, walk,
                             s);
    case 1:
      return dispatch<__nv_bfloat16>(x, tiles, row_ptr, tile_cols, group_rows, stage_ptr,
                                     stage_chunk, stage_runs, y, pt, n, k, m, tb, groups, rows,
                                     wcap, slices, walk, s);
    case 2:
      return dispatch<__half>(x, tiles, row_ptr, tile_cols, group_rows, stage_ptr,
                              stage_chunk, stage_runs, y, pt, n, k, m, tb, groups, rows, wcap,
                              slices, walk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
