// Expert-grouped GEMM for Hopper (MoE expert compute):
//
//     out[t, :] = x[t, :] . w[ids[t / tm], :, :]      x [T, D], w [E, D, F]
//
// Replaces the TPU kernel src/repro/kernels/gmm/gmm.py `gmm_call`
// (`_gmm_kernel`): there the expert ids were scalar-prefetched into the
// W block map and a VMEM fp32 accumulator was carried across the
// sequential D axis of the grid.  Here one thread block owns one output
// tile (one row tile of tm rows x 64 columns of F): it reads its own
// expert id from device memory (no host sync, so the routing can change
// every call), then loops over D in chunks of 32, staging the x rows and
// the w[e] chunk in shared memory as fp32 while the next chunk is loaded
// into registers.  w is [E, D, F] row-major, so a chunk's rows are
// contiguous along F: each thread loads 16 bytes (8 bf16/fp16 values or
// 4 fp32 values) per access, 8 threads covering a 128-byte row segment
// in half precision.  The 256 threads form 8 row groups x 32 column
// lanes; each keeps RM x 2 fp32 sums in registers (rows ty + 8 a,
// columns tx + 32 b) and writes them once, rounded to the output dtype.
// RM = ceil(tm / 8) is a template argument, so a tile of tm <= 64 rows
// does no work for rows it does not hold.
//
// What bounds it: at decode (tm = C = 8, every expert's rows one tile)
// reading w, 2 * E * D * F bytes in bf16 (0.12 ms for qwen3's 128 x 2048
// x 768 at 3.35 TB/s); at prefill (tm up to 64) the arithmetic, which
// runs in fp32 on the CUDA cores here.  Tensor cores (wgmma) and TMA
// staging are later work.
//
// An id outside [0, E) reads nothing of w: the tile's rows are written
// as zeros.  Ragged F and D edges are masked; the 16-byte loads need F a
// multiple of the vector width and w 16-byte aligned (the wrapper passes
// vec = 0 otherwise and the loads go element by element).
//
// dtype 0 = fp32, 1 = bf16, 2 = fp16; output in the input dtype.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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
constexpr int kTY = 8;          // row groups
constexpr int kTX = 32;         // column lanes
constexpr int kRN = 2;          // columns per lane
constexpr int kBN = kTX * kRN;  // 64 columns of F per block
constexpr int kBK = 32;         // rows of D per chunk
constexpr int kMaxTm = 64;

template <typename T, int RM>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ ids, T* __restrict__ out, int tm, int d, int f,
               int e_count, int vec) {
  constexpr int BM = kTY * RM;
  constexpr int kVec = 16 / (int)sizeof(T);         // elements per 16-byte load
  constexpr int kVpr = kBN / kVec;                  // vectors per chunk row
  constexpr int kWv = kBK * kVpr / kThreads;        // w vectors per thread
  constexpr int kXe = BM * kBK / kThreads;          // x elements per thread
  static_assert(kWv >= 1 && kBK * kVpr % kThreads == 0, "w chunk split");
  static_assert(kXe >= 1 && BM * kBK % kThreads == 0, "x chunk split");
  __shared__ float xs[kBK][BM + 1];  // x rows, transposed
  __shared__ float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int f0 = blockIdx.y * kBN;
  const size_t row0 = (size_t)blockIdx.x * tm;
  const int e = ids[blockIdx.x];

  if (e < 0 || e >= e_count) {
    // no expert: zero rows, nothing of w is read
    for (int i = tid; i < tm * kBN; i += kThreads) {
      const int r = i / kBN, c = f0 + i % kBN;
      if (c < f) out[(row0 + r) * f + c] = from_f<T>(0.f);
    }
    return;
  }
  const T* we = w + (size_t)e * d * f;

  float acc[RM][kRN];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < kRN; ++b) acc[a][b] = 0.f;

  float rx[kXe];
  float rw[kWv][kVec];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kXe; ++l) {
      const int i = tid + l * kThreads;
      const int r = i / kBK, c = k0 + i % kBK;
      rx[l] = (r < tm && c < d) ? to_f<T>(x[(row0 + r) * d + c]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < kWv; ++l) {
      const int v = tid + l * kThreads;
      const int r = k0 + v / kVpr;
      const int c = f0 + (v % kVpr) * kVec;
      const T* src = we + (size_t)r * f + c;
      if (vec && r < d && c < f) {
        // f is a multiple of kVec here, so the whole vector is in range
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < kVec; ++j) rw[l][j] = to_f<T>(el[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          rw[l][j] = (r < d && c + j < f) ? to_f<T>(src[j]) : 0.f;
      }
    }
  };

  load(0);
  for (int k0 = 0; k0 < d; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < kXe; ++l) {
      const int i = tid + l * kThreads;
      xs[i % kBK][i / kBK] = rx[l];
    }
#pragma unroll
    for (int l = 0; l < kWv; ++l) {
      const int v = tid + l * kThreads;
#pragma unroll
      for (int j = 0; j < kVec; ++j) ws[v / kVpr][(v % kVpr) * kVec + j] = rw[l][j];
    }
    __syncthreads();
    if (k0 + kBK < d) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float xv[RM], wv[kRN];
#pragma unroll
      for (int a = 0; a < RM; ++a) xv[a] = xs[kk][ty + kTY * a];
#pragma unroll
      for (int b = 0; b < kRN; ++b) wv[b] = ws[kk][tx + kTX * b];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int b = 0; b < kRN; ++b) acc[a][b] += xv[a] * wv[b];
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int r = ty + kTY * a;
    if (r >= tm) continue;
#pragma unroll
    for (int b = 0; b < kRN; ++b) {
      const int c = f0 + tx + kTX * b;
      if (c < f) out[(row0 + r) * f + c] = from_f<T>(acc[a][b]);
    }
  }
}

template <typename T, int RM>
void launch(const void* x, const void* w, const int* ids, void* out, int tiles, int tm,
            int d, int f, int e_count, int vec, cudaStream_t s) {
  // row tiles on x (no 65535 cap), so neighbouring blocks of one
  // expert's rows share its w chunks in L2
  dim3 grid(tiles, (f + kBN - 1) / kBN);
  gmm_kernel<T, RM><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), ids, static_cast<T*>(out), tm, d,
      f, e_count, vec);
}

template <typename T>
int dispatch(const void* x, const void* w, const int* ids, void* out, int tiles, int tm,
             int d, int f, int e_count, int vec, cudaStream_t s) {
  if (tm < 1 || tm > kMaxTm) return (int)cudaErrorInvalidValue;
  switch ((tm + kTY - 1) / kTY) {
    case 1: launch<T, 1>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s); break;
    case 2: launch<T, 2>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s); break;
    case 3: launch<T, 3>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s); break;
    case 4: launch<T, 4>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s); break;
    case 5: launch<T, 5>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s); break;
    case 6: launch<T, 6>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s); break;
    case 7: launch<T, 7>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s); break;
    default: launch<T, 8>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [tiles * tm, d], w [e_count, d, f], ids [tiles] int32 -> out
// [tiles * tm, f]; tm in 1..64; vec != 0 takes 16-byte loads of w (f a
// multiple of 16 / element size, w 16-byte aligned)
extern "C" int gmm(const void* x, const void* w, const void* ids, void* out, int tiles,
                   int tm, int d, int f, int e_count, int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  switch (dtype) {
    case 0: return dispatch<float>(x, w, id, out, tiles, tm, d, f, e_count, vec, s);
    case 1: return dispatch<__nv_bfloat16>(x, w, id, out, tiles, tm, d, f, e_count, vec, s);
    case 2: return dispatch<__half>(x, w, id, out, tiles, tm, d, f, e_count, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
