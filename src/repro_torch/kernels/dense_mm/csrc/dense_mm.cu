// Dense GEMM for Hopper, activation-major:
//
//     y[N, D] = x[N, K] . w[K, D]      (fp32 sums, y in the input dtype)
//
// Replaces the TPU kernel src/repro/kernels/dense_mm/dense_mm.py
// `dense_mm_call` (`_mm_kernel`), which carried a VMEM fp32 accumulator
// across the sequential K axis of its grid.  Blocks run in parallel here,
// so each walk below loops over K inside a block, and where K is split
// across blocks the slices are added in a fixed order (deterministic).
// The wrapper (ops.py `walk`) picks one of three walks per shape:
//
// 1. "wgmma" (bf16/fp16, K and D multiples of 8; N > 16, and N <= 16
//    where the wrapper's time model prices it below walk 2): bound by the
//    tensor cores' rate at prefill and training shapes.  One block owns a
//    BM x BN output tile (BM = BN = 64 or 128); a producer warp keeps a
//    4-stage ring of x tiles [BM, 64] and w tiles [64, BN] in shared
//    memory full through TMA (cp.async.bulk.tensor, 128-byte swizzle,
//    out-of-bounds rows and columns filled with zeros), signalled on
//    mbarriers; BM / 64 consumer warpgroups run wgmma.mma_async
//    m64nBNk16 on each stage into fp32 registers, one wgmma group in
//    flight, and release the stage to the producer when it has been read.
//    x is K-major (the A operand as wgmma wants it); w is [K, D] row-major,
//    so B is MN-major and wgmma reads it with its transpose bit.  Where the
//    output has too few tiles to fill 132 SMs the wrapper takes 64 x 64
//    tiles and, if that is still short, splits K: each slice writes fp32
//    partials and a second launch adds them in slice order.
// 2. "decode" (N <= 16, any dtype): bound by reading w once.  Block
//    (column slab, K slice) stages its slice of x's N rows in shared
//    memory once, then streams its slab of w with 16-byte loads, 16 rows
//    in flight a thread at N <= 4, else 8 (the first batch issued before
//    x is staged); the
//    K-lanes of a warp add by shuffles, the warps
//    of a block in shared memory, and the K slices of a column slab, which
//    form one thread-block cluster, through distributed shared memory in
//    rank order.  One launch, no scratch.  A shape whose fp32 slice of x
//    would pass a block's 227 KB (K past about 24k at N 9..16) takes
//    walk 1 or 3 instead.
// 3. "ffma" (fp32 at N > 16, and 16-bit shapes TMA cannot take: K or D
//    not a multiple of 8): the CUDA cores' fp32 FMA (TF32 would miss the
//    fp32 budget).  64 x 64 output tiles of 256 threads, K staged 16 deep
//    in shared memory; split K with the same partials and second launch
//    where the tiles do not fill the card.
//
// dtype 0 = fp32, 1 = bf16, 2 = fp16.
#include <cooperative_groups.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// walk 1: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kBK = 64;       // K per stage: 64 16-bit values = one 128-byte row
constexpr int kStages = 4;

template <int BM, int BN> struct TcShape {
  static constexpr int kWarpgroups = BM / 64;              // consumers
  static constexpr int kThreads = 128 * (1 + kWarpgroups);  // + one producer warpgroup
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment slack
};

// Block (column tile, row tile, K slice).  part == nullptr: write y;
// else write fp32 partials part[slice, n, d].
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(TcShape<BM, BN>::kThreads, 1)
    dense_mm_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmw, T* __restrict__ y,
                       float* __restrict__ part, int n, int k, int d, int kb_per_slice) {
  using S = TcShape<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  // 128-byte swizzle atoms are 1024 bytes: align the ring to them
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int d0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kb_total = (k + kBK - 1) / kBK;
  const int kb0 = blockIdx.z * kb_per_slice;
  const int nkb = min(kb_total, kb0 + kb_per_slice) - kb0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::kWarpgroups * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every copy
    if (threadIdx.x == 0) {
      for (int i = 0; i < nkb; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* a = ring + s * S::kStageBytes;
        uint8_t* b = a + S::kABytes;
        mbar_expect_tx(&full[s], S::kStageBytes);
        const int kc = (kb0 + i) * kBK;
        tma_load_2d(a, &tmx, &full[s], kc, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(b + j * kBK * 128, &tmw, &full[s], d0 + 64 * j, kc);
      }
    }
    return;
  }

  // consumer warpgroup g: rows m0 + 64 g .. + 63 of the tile
  const int g = wg - 1;
  constexpr int R = BN / 2;  // fp32 registers of an m64nBN accumulator
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  for (int i = 0; i < nkb; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint8_t* a = ring + s * S::kStageBytes + g * 64 * 128;
    const uint8_t* b = ring + s * S::kStageBytes + S::kABytes;
    pin<R>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A: 64 rows of 128 bytes, 8-row atoms 1024 bytes apart; a k16
      // step is 32 bytes into the row.  B: 64-column chunks 64 rows x 128
      // bytes (8192 bytes) apart, 8-row atoms 1024 apart; a k16 step is
      // 16 rows = 2048 bytes.
      WgmmaSS<BN, T>::template run<1>(acc, smem_desc(a + kk * 32, 16, 1024),
                                      smem_desc(b + kk * 2048, kBK * 128, 1024), 1);
    }
    wgmma_commit();
    pin<R>(acc);
    wgmma_wait<1>();
    if (i > 0) mbar_arrive(&empty[(i - 1) % kStages]);
  }
  wgmma_wait<0>();
  pin<R>(acc);

  // accumulator fragment: row 16 w + l / 4 (+ 8), columns 8 c + 2 (l % 4) (+ 1)
  const int t = threadIdx.x % 128;
  const int row0 = m0 + g * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int colq = d0 + 2 * (t % 4);
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int col = colq + 8 * c;
    if (col >= d) continue;  // d is even: col + 1 < d too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= n) continue;
      const float v0 = acc[4 * c + 2 * h], v1 = acc[4 * c + 2 * h + 1];
      if (part != nullptr) {
        *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * n + row) * d + col) =
            make_float2(v0, v1);
      } else if constexpr (sizeof(T) == 2) {
        T pair[2] = {from_f<T>(v0), from_f<T>(v1)};
        *reinterpret_cast<uint32_t*>(y + (size_t)row * d + col) =
            *reinterpret_cast<uint32_t*>(pair);
      }
    }
  }
}

template <typename T, int BM, int BN>
int launch_tc(const T* x, const T* w, T* y, float* part, int n, int k, int d, int* slices,
              CUtensorMapDataType ty, cudaStream_t s) {
  using S = TcShape<BM, BN>;
  CUtensorMap tmx, tmw;
  if (!make_map(&tmx, x, n, k, BM, ty) || !make_map(&tmw, w, k, d, kBK, ty))
    return (int)cudaErrorInvalidValue;
  // set at every launch: the attribute is per device, and a flag kept
  // beside it would be shared by every device and thread
  cudaFuncSetAttribute(dense_mm_tc_kernel<T, BM, BN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  const int kb_total = (k + kBK - 1) / kBK;
  const int per = (kb_total + *slices - 1) / *slices;
  *slices = (kb_total + per - 1) / per;
  dim3 grid((d + BN - 1) / BN, (n + BM - 1) / BM, *slices);
  dense_mm_tc_kernel<T, BM, BN><<<grid, S::kThreads, S::kSmem, s>>>(
      tmx, tmw, y, *slices > 1 ? part : nullptr, n, k, d, per);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// walk 2: decode (N <= 16), K slices joined through a cluster
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 256;
// rows of w in flight a thread: 16 while the sums are few, else 8
template <int NT> struct DecUnroll { static constexpr int value = NT <= 4 ? 16 : 8; };

// 16 bytes of row `wr` from col0: one load where it fits, else element by
// element with the ragged edge zero
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* __restrict__ wr, int col0, int d, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec && col0 + VEC <= d) return __ldg(reinterpret_cast<const uint4*>(wr + col0));
  uint4 raw = make_uint4(0, 0, 0, 0);
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (col0 + j < d) v[j] = wr[col0 + j];
  return raw;
}

// Block (column slab of CL * VEC columns, K slice of kc rows); the
// gridDim.y K slices of a slab are one cluster.  Shared memory: x's slice
// [NT][kc], the warps' sums [8][NT][SC], the block's sum [NT][SC].
template <typename T, int NT, int CL>
__global__ void __launch_bounds__(kDecThreads)
    dense_mm_decode_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                           int n, int k, int d, int kc, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int SC = CL * VEC;
  constexpr int KT = kDecThreads / CL;  // K-lanes of a block
  constexpr int kWarps = kDecThreads / 32;
  constexpr int kDecUnroll = DecUnroll<NT>::value;
  constexpr int kStep = kDecUnroll * KT;
  extern __shared__ float dsm[];
  float* xs = dsm;
  float* red = xs + NT * kc;
  float* fin = red + kWarps * NT * SC;
  cg::cluster_group cluster = cg::this_cluster();

  const int kbeg = blockIdx.y * kc;
  const int kend = min(k, kbeg + kc);
  const int c = threadIdx.x % CL;
  const int kl = threadIdx.x / CL;
  const int col0 = blockIdx.x * SC + c * VEC;
  // kDecUnroll rows of w in flight a thread; the first batch is issued
  // before x is staged, so the two latencies overlap
  uint4 raw[kDecUnroll];
  auto load = [&](int kk) {
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const int r = kk + u * KT;
      raw[u] = r < kend ? load_raw<T>(w + (size_t)r * d, col0, d, vec != 0)
                        : make_uint4(0, 0, 0, 0);
    }
  };
  int kk = kbeg + kl;
  load(kk);
  for (int e = threadIdx.x; e < NT * kc; e += kDecThreads) {
    const int t = e / kc, kx = kbeg + e % kc;
    xs[e] = (t < n && kx < kend) ? to_f<T>(x[(size_t)t * k + kx]) : 0.f;
  }
  __syncthreads();

  float acc[NT][VEC];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[t][j] = 0.f;
  for (; kk < kend; kk += kStep) {
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const T* v = reinterpret_cast<const T*>(&raw[u]);
      float wv[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) wv[j] = to_f<T>(v[j]);
      const float* xr = xs + min(kk + u * KT, kend - 1) - kbeg;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float xv = xr[t * kc];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[t][j] += xv * wv[j];
      }
    }
    if (kk + kStep < kend) load(kk + kStep);
  }
  // the K-lanes of a warp (lanes c, c + CL, ...), then the warps
#pragma unroll
  for (int off = CL; off < 32; off <<= 1)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[t][j] += __shfl_xor_sync(0xffffffffu, acc[t][j], off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < CL) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[(warp * NT + t) * SC + c * VEC + j] = acc[t][j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < NT * SC; e += kDecThreads) {
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) v += red[wp * NT * SC + e];
    fin[e] = v;
  }
  // the K slices of this slab: block `rank` adds its share of the outputs
  // over every rank's `fin`, in rank order
  cluster.sync();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  for (int e = rank * kDecThreads + threadIdx.x; e < NT * SC; e += ranks * kDecThreads) {
    const int t = e / SC, col = blockIdx.x * SC + e % SC;
    if (t >= n || col >= d) continue;
    float v = 0.f;
    for (int q = 0; q < ranks; ++q) v += cluster.map_shared_rank(fin, q)[e];
    y[(size_t)t * d + col] = from_f<T>(v);
  }
  cluster.sync();  // keep this block's `fin` alive until every rank has read it
}

template <typename T, int NT, int CL>
int launch_decode(const T* x, const T* w, T* y, int n, int k, int d, int slices,
                  cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int SC = CL * VEC;
  const int kc = (k + slices - 1) / slices;
  const size_t smem = sizeof(float) * ((size_t)NT * kc + (size_t)(kDecThreads / 32 + 1) * NT * SC);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  // set at every launch that needs it (per device, as in launch_tc)
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(dense_mm_decode_kernel<T, NT, CL>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int vec = ((reinterpret_cast<uintptr_t>(w) % 16) == 0 && d % VEC == 0) ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d + SC - 1) / SC, slices, 1);
  cfg.blockDim = dim3(kDecThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = slices;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, dense_mm_decode_kernel<T, NT, CL>, x, w, y, n, k, d, kc, vec);
  return (int)cudaGetLastError();
}

template <typename T, int NT>
int decode_cl(const T* x, const T* w, T* y, int n, int k, int d, int cl, int slices,
              cudaStream_t s) {
  switch (cl) {
    case 8: return launch_decode<T, NT, 8>(x, w, y, n, k, d, slices, s);
    case 16: return launch_decode<T, NT, 16>(x, w, y, n, k, d, slices, s);
    case 32: return launch_decode<T, NT, 32>(x, w, y, n, k, d, slices, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_decode_nt(const T* x, const T* w, T* y, int n, int k, int d, int cl, int slices,
                     cudaStream_t s) {
  if (n <= 1) return decode_cl<T, 1>(x, w, y, n, k, d, cl, slices, s);
  if (n <= 2) return decode_cl<T, 2>(x, w, y, n, k, d, cl, slices, s);
  if (n <= 4) return decode_cl<T, 4>(x, w, y, n, k, d, cl, slices, s);
  if (n <= 8) return decode_cl<T, 8>(x, w, y, n, k, d, cl, slices, s);
  if (n <= 16) return decode_cl<T, 16>(x, w, y, n, k, d, cl, slices, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// walk 3: fp32 FMA tiles, K split where the tiles do not fill the card
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16

template <typename T, int RM, int RN, int kK>
__global__ void __launch_bounds__(kThreads)
    dense_mm_ffma_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                         float* __restrict__ part, int n, int k, int d, int kc) {
  constexpr int BM = 16 * RM;
  constexpr int BN = 16 * RN;
  constexpr int kA = BM * kK / kThreads;  // x elements per thread per step
  constexpr int kB = kK * BN / kThreads;  // w elements per thread per step
  __shared__ float as[kK][BM + 1];        // x slice, transposed
  __shared__ float bs[kK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int d0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kc;
  const int kend = min(k, kbeg + kc);

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
      const int row = m0 + e / kK, col = k0 + e % kK;
      ra[l] = (row < n && col < kend) ? to_f<T>(x[(size_t)row * k + col]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < kB; ++l) {
      const int e = tid + l * kThreads;
      const int row = k0 + e / BN, col = d0 + e % BN;
      rb[l] = (row < kend && col < d) ? to_f<T>(w[(size_t)row * d + col]) : 0.f;
    }
  };

  load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += kK) {
#pragma unroll
    for (int l = 0; l < kA; ++l) {
      const int e = tid + l * kThreads;
      as[e % kK][e / kK] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < kB; ++l) {
      const int e = tid + l * kThreads;
      bs[e / BN][e % BN] = rb[l];
    }
    __syncthreads();
    if (k0 + kK < kend) load(k0 + kK);
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
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
      if (col >= d) continue;
      if (part != nullptr)
        part[((size_t)blockIdx.z * n + row) * d + col] = acc[a][b];
      else
        y[(size_t)row * d + col] = from_f<T>(acc[a][b]);
    }
  }
}

// y[n, d] = sum over slices of part[slice, n, d] in slice order, rounded once
template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ part, T* __restrict__ y,
                                     size_t nd, int slices) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nd) return;
  float v = 0.f;
  for (int sl = 0; sl < slices; ++sl) v += part[(size_t)sl * nd + e];
  y[e] = from_f<T>(v);
}

template <typename T>
int reduce(const float* part, T* y, int n, int d, int slices, cudaStream_t s) {
  const size_t nd = (size_t)n * d;
  splitk_reduce_kernel<T><<<(unsigned)((nd + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, y, nd, slices);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ffma(const T* x, const T* w, T* y, float* part, int n, int k, int d, int* slices,
                cudaStream_t s) {
  const int kc = max(16, ((k + *slices - 1) / *slices + 15) / 16 * 16);
  *slices = max(1, (k + kc - 1) / kc);
  dim3 grid((d + 63) / 64, (n + 63) / 64, *slices);
  dense_mm_ffma_kernel<T, 4, 4, 16><<<grid, kThreads, 0, s>>>(
      x, w, y, *slices > 1 ? part : nullptr, n, k, d, kc);
  return (int)cudaGetLastError();
}

enum Walk { kDecode = 0, kWgmma = 1, kFfma = 2 };

template <typename T>
int dispatch(const void* xv, const void* wv, void* yv, float* part, int n, int k, int d,
             int walk, int bm, int bn, int cl, int slices, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* y = static_cast<T*>(yv);
  if (slices < 1 || (slices > 1 && walk != kDecode && part == nullptr))
    return (int)cudaErrorInvalidValue;
  int code = (int)cudaErrorInvalidValue;
  if (walk == kDecode) {
    if (slices > 8) return code;
    return launch_decode_nt<T>(x, w, y, n, k, d, cl, slices, s);
  }
  if (walk == kWgmma) {
    if constexpr (sizeof(T) == 2) {
      const CUtensorMapDataType ty = std::is_same<T, __half>::value
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
      if (bm == 128 && bn == 128)
        code = launch_tc<T, 128, 128>(x, w, y, part, n, k, d, &slices, ty, s);
      else if (bm == 64 && bn == 64)
        code = launch_tc<T, 64, 64>(x, w, y, part, n, k, d, &slices, ty, s);
    }
  } else if (walk == kFfma) {
    code = launch_ffma<T>(x, w, y, part, n, k, d, &slices, s);
  }
  if (code != 0 || slices == 1) return code;
  return reduce<T>(part, y, n, d, slices, s);
}

}  // namespace

// walk 0 = decode (cl = column lanes, slices = cluster size <= 8),
// 1 = wgmma (bm x bn tiles), 2 = ffma; slices > 1 on walks 1 and 2 needs
// scratch of slices * n * d floats
extern "C" int dense_mm(const void* x, const void* w, void* y, void* scratch, int n, int k,
                        int d, int walk, int bm, int bn, int cl, int slices, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      if (walk == kWgmma) return (int)cudaErrorInvalidValue;
      return dispatch<float>(x, w, y, part, n, k, d, walk, bm, bn, cl, slices, s);
    case 1: return dispatch<__nv_bfloat16>(x, w, y, part, n, k, d, walk, bm, bn, cl, slices, s);
    case 2: return dispatch<__half>(x, w, y, part, n, k, d, walk, bm, bn, cl, slices, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
