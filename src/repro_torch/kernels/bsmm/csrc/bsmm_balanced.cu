// Balanced-walk static block-sparse matmul for Hopper, activation-major:
//
//     y[N, M] = x[N, K] . W^T,   W = [M, K] block-sparse, b x b blocks
//
// Replaces the TPU kernel src/repro/kernels/bsmm/balanced.py
// `bsmm_balanced_call` (`_bsmm_balanced_kernel`).  It computes the same
// product as bsmm, walked over the snake-binned visit schedule of
// `partitioner.plan_packing_balanced` (tm = tk = b): row-tiles are dealt
// into bins of near-equal tile counts at plan time, and bin g visits
// tile visit_slot[g, s] at row-tile visit_rows[g, s], column-tile
// visit_cols[g, s] for s = 0 .. steps-1.  Each row-tile's tiles are
// contiguous within its bin's lane; lanes shorter than `steps` pad with
// the appended zero tile (slot T) and keep their last row, so every
// row-tile is flushed exactly once, to its original position (no
// un-permute).
//
// The TPU ran one parallel lane per bin with a sequential walk inside it,
// flushing a VMEM accumulator on a row change.  The wrapper (balanced.py
// `walk`) picks one of two walks:
//
// 1. "mma" (bf16/fp16, b in {16, 32, 64}): bsmm's tensor-core walk
//    (bsmm_mma.cuh) with the bins as its groups of block-rows: the plan
//    deals the row-tiles into ceil(mb / R) bins, so a bin fits a group,
//    and records the group schedule beside the visit schedule; each
//    row-tile is written at its original position.
// 2. "ffma" (fp32, b in {4, 8}, and 16-bit where the caller asks): one
//    thread block owns one (bin, token tile) pair, carries the fp32 sums
//    of its current row-tile in registers and writes them when the row
//    changes and at the end of the lane.  Bins x token tiles is the
//    parallelism, so the plan picks the bin count for the card (enough
//    blocks to fill the SMs); any bin count gives the same result.  Each
//    step stages its b x b tile (in chunks of 32 columns for b > 32) and
//    the matching x slice in shared memory as fp32; fp32 sums on the
//    CUDA cores.  On a skewed pattern the longest lane (steps) sets the
//    tail.
//
// Inputs (all device pointers):
//   x          [n, k]           activations, row-major (16-byte aligned, mma)
//   tiles      [T + 1, b, b]    packed tile stack + trailing zero tile
//                               (16-byte aligned, mma)
//   visit_rows [bins, steps]    int32, original row-tile per step
//   visit_cols [bins, steps]    int32
//   visit_slot [bins, steps]    int32, tile-stack slot per step
//   group_rows, stage_ptr, stage_chunk, stage_runs
//                               the mma walk's schedule (bsmm_mma.cuh;
//                               null for the ffma walk)
//   part       [slices, n, m]   fp32 scratch of the mma walk's K slices
//                               (null where slices = 1)
//   y          [n, m]           output (every row-tile the schedule
//                               visits is written once)
// b in {4, 8, 16, 32, 64}; dtype 0 = fp32, 1 = bf16, 2 = fp16; output in
// the input dtype, fp32 accumulation.  Steps whose row, col or slot lies
// outside the grid are skipped.
#include <stddef.h>

#include "bsmm_mma.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;

template <int B>
struct Cfg {
  static constexpr int BN = B <= 4 ? 256 : (B == 8 ? 128 : 64);
  static constexpr int KC = B < 32 ? B : 32;
  static constexpr int LANES = kThreads / B;
  static constexpr int PER = BN / LANES;
};

template <typename T, int B>
__device__ __forceinline__ void flush(T* __restrict__ y, int r, int n0, int n, int m,
                                      float (&acc)[Cfg<B>::PER]) {
  using C = Cfg<B>;
  const int i = threadIdx.x % B;
  const int lane = threadIdx.x / B;
#pragma unroll
  for (int p = 0; p < C::PER; ++p) {
    const int tok = n0 + lane + p * C::LANES;
    if (tok < n) y[(size_t)tok * m + (size_t)r * B + i] = from_f<T>(acc[p]);
    acc[p] = 0.f;
  }
}

template <typename T, int B>
__global__ void __launch_bounds__(kThreads)
    bsmm_balanced_kernel(const T* __restrict__ x, const T* __restrict__ tiles,
                         const int* __restrict__ visit_rows,
                         const int* __restrict__ visit_cols,
                         const int* __restrict__ visit_slot, T* __restrict__ y, int n,
                         int k, int m, int steps, int num_tiles) {
  using C = Cfg<B>;
  __shared__ float ws[B][C::KC + 1];  // +1: row-strided reads on distinct banks
  __shared__ float xs[C::BN][C::KC + 1];
  const int g = blockIdx.x;
  const int n0 = blockIdx.y * C::BN;
  const int tid = threadIdx.x;
  const int i = tid % B;
  const int lane = tid / B;
  const int mb = m / B, kb = k / B;
  const int* rows = visit_rows + (size_t)g * steps;
  const int* cols = visit_cols + (size_t)g * steps;
  const int* slots = visit_slot + (size_t)g * steps;

  float acc[C::PER];
#pragma unroll
  for (int p = 0; p < C::PER; ++p) acc[p] = 0.f;
  int cur = steps > 0 ? rows[0] : -1;
  for (int s = 0; s < steps; ++s) {
    const int r = rows[s];
    if (r != cur) {  // the same for every thread of the block
      if (cur >= 0 && cur < mb) flush<T, B>(y, cur, n0, n, m, acc);
      cur = r;
    }
    const int c = cols[s];
    const int slot = slots[s];
    if (c < 0 || c >= kb || slot < 0 || slot > num_tiles) continue;
    const T* blk = tiles + (size_t)slot * B * B;
    const T* xc = x + (size_t)c * B;
#pragma unroll 1
    for (int kc = 0; kc < B; kc += C::KC) {
      __syncthreads();  // the previous step's reads are done
      for (int e = tid; e < B * C::KC; e += kThreads) {
        const int rr = e / C::KC, j = e % C::KC;
        ws[rr][j] = to_f<T>(blk[(size_t)rr * B + kc + j]);
      }
      for (int e = tid; e < C::BN * C::KC; e += kThreads) {
        const int t = e / C::KC, j = e % C::KC;
        const int tok = n0 + t;
        xs[t][j] = tok < n ? to_f<T>(xc[(size_t)tok * k + kc + j]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < C::KC; ++j) {
        const float w = ws[i][j];
#pragma unroll
        for (int p = 0; p < C::PER; ++p) acc[p] += xs[lane + p * C::LANES][j] * w;
      }
    }
  }
  if (cur >= 0 && cur < mb) flush<T, B>(y, cur, n0, n, m, acc);
}

template <typename T, int B>
void launch(const void* x, const void* tiles, const void* vr, const void* vc,
            const void* vs, void* y, int n, int k, int m, int bins, int steps,
            int num_tiles, cudaStream_t stream) {
  dim3 grid(bins, (n + Cfg<B>::BN - 1) / Cfg<B>::BN);
  bsmm_balanced_kernel<T, B><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(tiles), static_cast<const int*>(vr),
      static_cast<const int*>(vc), static_cast<const int*>(vs), static_cast<T*>(y), n, k, m,
      steps, num_tiles);
}

template <typename T>
int ffma_b(const void* x, const void* tiles, const void* vr, const void* vc, const void* vs,
           void* y, int n, int k, int m, int b, int bins, int steps, int num_tiles,
           cudaStream_t st) {
  switch (b) {
    case 4: launch<T, 4>(x, tiles, vr, vc, vs, y, n, k, m, bins, steps, num_tiles, st); break;
    case 8: launch<T, 8>(x, tiles, vr, vc, vs, y, n, k, m, bins, steps, num_tiles, st); break;
    case 16: launch<T, 16>(x, tiles, vr, vc, vs, y, n, k, m, bins, steps, num_tiles, st); break;
    case 32: launch<T, 32>(x, tiles, vr, vc, vs, y, n, k, m, bins, steps, num_tiles, st); break;
    case 64: launch<T, 64>(x, tiles, vr, vc, vs, y, n, k, m, bins, steps, num_tiles, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

enum Walk { kMma = 0, kFfma = 1 };

template <typename T>
int dispatch(const void* x, const void* tiles, const void* vr, const void* vc,
             const void* vs, const void* group_rows, const void* stage_ptr,
             const void* stage_chunk, const void* stage_runs, void* y, float* part, int n,
             int k, int m, int b, int bins, int steps, int num_tiles, int groups, int rows,
             int wcap, int slices, int walk, cudaStream_t st) {
  if (walk == kFfma) return ffma_b<T>(x, tiles, vr, vc, vs, y, n, k, m, b, bins, steps,
                                      num_tiles, st);
  if (walk != kMma) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    return bsmm_mma::run<T>(x, tiles, group_rows, stage_ptr, stage_chunk, stage_runs, y, part,
                            n, k, m, b, groups, rows, wcap, slices, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// walk 0 = mma (16-bit, b in {16, 32, 64}, with its group schedule), 1 =
// ffma (every dtype and block, over the visit schedule)
extern "C" int bsmm_balanced_nt(const void* x, const void* tiles, const void* visit_rows,
                                const void* visit_cols, const void* visit_slot,
                                const void* group_rows, const void* stage_ptr,
                                const void* stage_chunk, const void* stage_runs, void* y,
                                void* part, int n, int k, int m, int b, int bins, int steps,
                                int num_tiles, int groups, int rows, int wcap, int slices,
                                int dtype, int walk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return dispatch<float>(x, tiles, visit_rows, visit_cols, visit_slot, group_rows,
                             stage_ptr, stage_chunk, stage_runs, y, pt, n, k, m, b, bins,
                             steps, num_tiles, groups, rows, wcap, slices, walk, s);
    case 1:
      return dispatch<__nv_bfloat16>(x, tiles, visit_rows, visit_cols, visit_slot, group_rows,
                                     stage_ptr, stage_chunk, stage_runs, y, pt, n, k, m, b,
                                     bins, steps, num_tiles, groups, rows, wcap, slices, walk,
                                     s);
    case 2:
      return dispatch<__half>(x, tiles, visit_rows, visit_cols, visit_slot, group_rows,
                              stage_ptr, stage_chunk, stage_runs, y, pt, n, k, m, b, bins,
                              steps, num_tiles, groups, rows, wcap, slices, walk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
