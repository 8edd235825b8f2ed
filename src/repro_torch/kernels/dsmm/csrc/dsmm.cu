// Dynamic block-sparse matmul for Hopper, activation-major:
//
//     y[N, M] = x[N, K] . W^T,   W = [M, K] held as runtime slots
//
// Replaces the TPU kernel src/repro/kernels/dsmm/dsmm.py `dsmm_call`
// (`_dsmm_kernel`), in the transposed form the sparse layers need.  The
// pattern is device data: slot s holds the b x b block values[s] at
// block-row rows[s], block-col cols[s]; padded slots hold zeros at
// (0, 0) and add exactly zero (they still cost a step, the paper's
// dynamic-mode overhead).  The only precondition on the slot order is
// that each block-row's slots are contiguous (the runtime encoders
// `encode_slots` and `_encode_slots_balanced` give that; rows need not
// ascend).
//
// The TPU walked one sequential grid over the slots and flushed a VMEM
// accumulator when the row changed.  Hopper's blocks run in parallel and
// in no order, so no host CSR exists to drive them: the launch is sized
// from host-known numbers only (grid_m = M / b row-tiles, N / BN token
// tiles, capacity S), and a first small kernel finds each block-row's run
// [start, end) on the device by comparing neighbouring slots.  Then one
// thread block per (row-tile, token tile) walks its run and writes its
// output tile once -- zeros for an empty run, so every output element is
// written whatever the pattern.  No value is read on the host: a new
// pattern every call never waits for the device.
//
// What bounds it: at d = 1/8, b = 16 and the FFN's N, the slots' bytes
// and the x slices they gather (bytes at N <= 256, operations on the
// CUDA cores above).  Each slot step stages its b x b block (in chunks
// of 32 columns for b > 32) and the matching x slice in shared memory as
// fp32 and every thread accumulates a strip of its row for several
// tokens in registers.  fp32 sums on the CUDA cores; tensor cores are
// later work.
//
// Inputs (all device pointers):
//   x       [n, k]       activations, row-major
//   values  [S, b, b]    slot values
//   rows    [S]          block-row of each slot, int32
//   cols    [S]          block-col of each slot, int32
//   bounds  [2 * mb]     scratch, int32, zeroed by the caller
//   y       [n, m]       output, fully written
// b in {4, 8, 16, 32, 64, 128}; dtype 0 = fp32, 1 = bf16, 2 = fp16;
// output in the input dtype, fp32 accumulation.  Slots whose row or col
// lies outside the grid are skipped.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

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

constexpr int kThreads = 256;

// tile shape at block size B: BN tokens per thread block, the block's
// columns staged KC at a time, each thread owning tile row i = tid % B
// for PER tokens (lane, lane + LANES, ...)
template <int B>
struct Cfg {
  static constexpr int BN = B <= 4 ? 256 : (B == 8 ? 128 : 64);
  static constexpr int KC = B < 32 ? B : 32;
  static constexpr int LANES = kThreads / B;
  static constexpr int PER = BN / LANES;
};

// block-row runs: bounds[r] = first slot of row r, bounds[mb + r] = one
// past its last (both stay 0 for a row without slots)
__global__ void run_bounds_kernel(const int* __restrict__ rows, int s_cap, int mb,
                                  int* __restrict__ bounds) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= s_cap) return;
  const int r = rows[s];
  if (r < 0 || r >= mb) return;
  if (s == 0 || rows[s - 1] != r) bounds[r] = s;
  if (s == s_cap - 1 || rows[s + 1] != r) bounds[mb + r] = s + 1;
}

// acc += block(values[slot]) . x[n0:n0+BN, c*B : (c+1)*B]^T for this
// thread's row and tokens
template <typename T, int B>
__device__ __forceinline__ void slot_step(const T* __restrict__ x, const T* __restrict__ blk,
                                          int c, int n0, int n, int k,
                                          float (&ws)[B][Cfg<B>::KC + 1],
                                          float (&xs)[Cfg<B>::BN][Cfg<B>::KC + 1],
                                          float (&acc)[Cfg<B>::PER]) {
  using C = Cfg<B>;
  const int tid = threadIdx.x;
  const int i = tid % B;
  const int lane = tid / B;
#pragma unroll 1
  for (int kc = 0; kc < B; kc += C::KC) {
    __syncthreads();  // the previous step's reads are done
    for (int e = tid; e < B * C::KC; e += kThreads) {
      const int r = e / C::KC, j = e % C::KC;
      ws[r][j] = to_f<T>(blk[(size_t)r * B + kc + j]);
    }
    const T* xc = x + (size_t)c * B + kc;
    for (int e = tid; e < C::BN * C::KC; e += kThreads) {
      const int t = e / C::KC, j = e % C::KC;
      const int tok = n0 + t;
      xs[t][j] = tok < n ? to_f<T>(xc[(size_t)tok * k + j]) : 0.f;
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

template <typename T, int B>
__global__ void __launch_bounds__(kThreads)
    dsmm_nt_kernel(const T* __restrict__ x, const T* __restrict__ values,
                   const int* __restrict__ cols, const int* __restrict__ bounds,
                   T* __restrict__ y, int n, int k, int m) {
  using C = Cfg<B>;
  __shared__ float ws[B][C::KC + 1];  // +1: row-strided reads on distinct banks
  __shared__ float xs[C::BN][C::KC + 1];
  const int mb = m / B;
  const int r = blockIdx.x;
  const int n0 = blockIdx.y * C::BN;
  const int i = threadIdx.x % B;
  const int lane = threadIdx.x / B;
  const int kb = k / B;

  float acc[C::PER];
#pragma unroll
  for (int p = 0; p < C::PER; ++p) acc[p] = 0.f;
  const int end = bounds[mb + r];
  for (int s = bounds[r]; s < end; ++s) {
    const int c = cols[s];
    if (c < 0 || c >= kb) continue;  // the same for every thread of the block
    slot_step<T, B>(x, values + (size_t)s * B * B, c, n0, n, k, ws, xs, acc);
  }
#pragma unroll
  for (int p = 0; p < C::PER; ++p) {
    const int tok = n0 + lane + p * C::LANES;
    if (tok < n) y[(size_t)tok * m + (size_t)r * B + i] = from_f<T>(acc[p]);
  }
}

template <typename T, int B>
void launch(const void* x, const void* values, const void* rows, const void* cols,
            void* bounds, void* y, int n, int k, int m, int s_cap, cudaStream_t stream) {
  const int mb = m / B;
  int* bd = static_cast<int*>(bounds);
  if (s_cap > 0) {
    run_bounds_kernel<<<(s_cap + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        static_cast<const int*>(rows), s_cap, mb, bd);
  }
  dim3 grid(mb, (n + Cfg<B>::BN - 1) / Cfg<B>::BN);
  dsmm_nt_kernel<T, B><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(values),
      static_cast<const int*>(cols), bd, static_cast<T*>(y), n, k, m);
}

template <typename T>
int dispatch_b(const void* x, const void* values, const void* rows, const void* cols,
               void* bounds, void* y, int n, int k, int m, int b, int s_cap,
               cudaStream_t stream) {
  switch (b) {
    case 4: launch<T, 4>(x, values, rows, cols, bounds, y, n, k, m, s_cap, stream); break;
    case 8: launch<T, 8>(x, values, rows, cols, bounds, y, n, k, m, s_cap, stream); break;
    case 16: launch<T, 16>(x, values, rows, cols, bounds, y, n, k, m, s_cap, stream); break;
    case 32: launch<T, 32>(x, values, rows, cols, bounds, y, n, k, m, s_cap, stream); break;
    case 64: launch<T, 64>(x, values, rows, cols, bounds, y, n, k, m, s_cap, stream); break;
    case 128: launch<T, 128>(x, values, rows, cols, bounds, y, n, k, m, s_cap, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dsmm_nt(const void* x, const void* values, const void* rows,
                       const void* cols, void* bounds, void* y, int n, int k, int m,
                       int b, int s_cap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_b<float>(x, values, rows, cols, bounds, y, n, k, m, b, s_cap, s);
    case 1:
      return dispatch_b<__nv_bfloat16>(x, values, rows, cols, bounds, y, n, k, m, b, s_cap, s);
    case 2:
      return dispatch_b<__half>(x, values, rows, cols, bounds, y, n, k, m, b, s_cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
