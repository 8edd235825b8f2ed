// Dense tiled GEMM for Hopper, activation-major:
//
//     y[N, D] = x[N, K] . w[K, D]
//
// Replaces the TPU kernel src/repro/kernels/dense_mm/dense_mm.py
// `dense_mm_call` (`_mm_kernel`): the TPU carried a VMEM fp32
// accumulator across the sequential K axis of its grid; here one thread
// block owns one (BM x BN) output tile and loops over K itself, staging
// a BM x BK slice of x and a BK x BN slice of w in shared memory per
// step, with the next slices loaded into registers while the current
// ones are multiplied.  Each thread keeps RM x RN fp32 sums in registers
// and writes once; ragged edges are masked on load and store.
//
// What bounds it: at the serving shapes (q/o 2048 x 2048, k/v
// 2048 x 512) decode (N = batch) is bound by reading w; prefill
// (N = a prompt bucket) by the arithmetic, which here runs in fp32 on
// the CUDA cores.  A tiled walk over K is a chain of dependent steps,
// each one load latency long, and at decode's 2048 x 2048 it has only a
// few dozen output tiles to spread over 132 SMs; so small N (<= 16)
// splits K instead: block (column tile, K slice) streams its slice of w
// with 32 lanes x 2 adjacent columns (128-byte rows in bf16) and 8 warps
// on interleaved rows, sums the warps in shared memory and writes fp32
// partials to a scratch buffer the wrapper allocates; a second kernel
// adds the slices and rounds once.  Tensor cores (wgmma) and TMA are
// later work.
//
// dtype 0 = fp32, 1 = bf16, 2 = fp16; output in the input dtype.
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

constexpr int kThreads = 256;  // 16 x 16

template <typename T, int RM, int RN, int kBK>
__global__ void __launch_bounds__(kThreads)
    dense_mm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                    int n, int k, int d) {
  constexpr int BM = 16 * RM;
  constexpr int BN = 16 * RN;
  constexpr int kA = BM * kBK / kThreads;  // x elements per thread per step
  constexpr int kB = kBK * BN / kThreads;  // w elements per thread per step
  __shared__ float as[kBK][BM + 1];        // x slice, transposed
  __shared__ float bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int d0 = blockIdx.x * BN;

  float acc[RM][RN];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < RN; ++b) acc[a][b] = 0.f;

  float ra[kA], rb[kB];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kA; ++l) {
      const int e = tid + l * kThreads;
      const int row = m0 + e / kBK, col = k0 + e % kBK;
      ra[l] = (row < n && col < k) ? to_f<T>(x[(size_t)row * k + col]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < kB; ++l) {
      const int e = tid + l * kThreads;
      const int row = k0 + e / BN, col = d0 + e % BN;
      rb[l] = (row < k && col < d) ? to_f<T>(w[(size_t)row * d + col]) : 0.f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < kA; ++l) {
      const int e = tid + l * kThreads;
      as[e % kBK][e / kBK] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < kB; ++l) {
      const int e = tid + l * kThreads;
      bs[e / BN][e % BN] = rb[l];
    }
    __syncthreads();
    if (k0 + kBK < k) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[RM], bv[RN];
#pragma unroll
      for (int a = 0; a < RM; ++a) av[a] = as[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < RN; ++b) bv[b] = bs[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int b = 0; b < RN; ++b) acc[a][b] += av[a] * bv[b];
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int row = m0 + ty + 16 * a;
    if (row >= n) continue;
#pragma unroll
    for (int b = 0; b < RN; ++b) {
      const int col = d0 + tx + 16 * b;
      if (col < d) y[(size_t)row * d + col] = from_f<T>(acc[a][b]);
    }
  }
}

constexpr int kSkCols = 64;  // columns per split-K block: 32 lanes x 2
constexpr int kSkWarps = kThreads / 32;
constexpr int kSkMaxN = 16;  // rows the split-K walk takes

// part[slice, n, d] = x[n, slice] . w[slice, d] for one K slice of kc rows
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_mm_splitk_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           float* __restrict__ part, int n, int k, int d, int kc) {
  __shared__ float red[kSkWarps][kSkMaxN][kSkCols];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = blockIdx.x * kSkCols + 2 * lane;
  const int kbeg = blockIdx.y * kc;
  const int kend = min(k, kbeg + kc);
  float acc[kSkMaxN][2];
#pragma unroll
  for (int t = 0; t < kSkMaxN; ++t) acc[t][0] = acc[t][1] = 0.f;
#pragma unroll 4
  for (int kk = kbeg + warp; kk < kend; kk += kSkWarps) {
    const T* wr = w + (size_t)kk * d;
    const float w0 = c < d ? to_f<T>(wr[c]) : 0.f;
    const float w1 = c + 1 < d ? to_f<T>(wr[c + 1]) : 0.f;
#pragma unroll
    for (int t = 0; t < kSkMaxN; ++t) {
      if (t < n) {
        const float xv = to_f<T>(x[(size_t)t * k + kk]);
        acc[t][0] += xv * w0;
        acc[t][1] += xv * w1;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kSkMaxN; ++t) {
    red[warp][t][2 * lane] = acc[t][0];
    red[warp][t][2 * lane + 1] = acc[t][1];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * kSkCols; e += kThreads) {
    const int t = e / kSkCols, cc = e % kSkCols;
    const int col = blockIdx.x * kSkCols + cc;
    if (col >= d) continue;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < kSkWarps; ++wp) v += red[wp][t][cc];
    part[((size_t)blockIdx.y * n + t) * d + col] = v;
  }
}

// y[n, d] = sum over slices of part[slice, n, d], rounded once
template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ part, T* __restrict__ y,
                                     int nd, int slices) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nd) return;
  float v = 0.f;
  for (int sl = 0; sl < slices; ++sl) v += part[(size_t)sl * nd + e];
  y[e] = from_f<T>(v);
}

template <typename T>
int dispatch(const void* x, const void* w, void* y, float* scratch, int n, int k, int d,
             int slices, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (slices > 0) {
    if (n > kSkMaxN || scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int kc = (k + slices - 1) / slices;
    dim3 grid((d + kSkCols - 1) / kSkCols, slices);
    dense_mm_splitk_kernel<T><<<grid, kThreads, 0, s>>>(xt, wt, scratch, n, k, d, kc);
    const int nd = n * d;
    splitk_reduce_kernel<T><<<(nd + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        scratch, yt, nd, slices);
  } else {
    dim3 grid((d + 63) / 64, (n + 63) / 64);
    dense_mm_kernel<T, 4, 4, 16><<<grid, kThreads, 0, s>>>(xt, wt, yt, n, k, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// slices > 0 takes the split-K walk (n <= 16) with scratch holding
// slices * n * d floats; slices == 0 the tiled walk
extern "C" int dense_mm(const void* x, const void* w, void* y, void* scratch, int n,
                        int k, int d, int slices, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  switch (dtype) {
    case 0: return dispatch<float>(x, w, y, sc, n, k, d, slices, s);
    case 1: return dispatch<__nv_bfloat16>(x, w, y, sc, n, k, d, slices, s);
    case 2: return dispatch<__half>(x, w, y, sc, n, k, d, slices, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
