// Expert-grouped GEMM for Hopper (MoE expert compute):
//
//     out[t, :] = x[t, :] . w[ids[t / tm], :, :]      x [T, D], w [E, D, F]
//
// Replaces the TPU kernel src/repro/kernels/gmm/gmm.py `gmm_call`
// (`_gmm_kernel`): there the expert ids were scalar-prefetched into the
// W block map and a VMEM fp32 accumulator was carried across the
// sequential D axis of the grid.  Here one thread block owns one output
// tile (one row tile of tm <= 128 rows x one column tile of F), reads its
// own expert id from device memory (no host sync, so the routing can
// change every call) and loops over D inside the block.  An id outside
// [0, E) reads nothing of w: the tile's rows are written as zeros.  The
// wrapper (ops.py `walk`) picks one of two walks:
//
// 1. "wgmma" (bf16/fp16, D and F multiples of 8): dense_mm's tensor-core
//    walk with an expert per row tile.  A producer warpgroup keeps a
//    4-stage ring full through TMA (128-byte swizzle, out-of-bounds rows
//    and columns filled with zeros): x's [BM, 64] box at the tile's first
//    row (K-major, the A operand) and w[e]'s [64, BN] boxes from a 3-D map
//    over [E, D, F] (MN-major, read with the transpose bit), so a box
//    never crosses into the next expert whatever D is.  BM / 64 consumer
//    warpgroups run wgmma m64nBNk16 into fp32 registers; rows of the box
//    past tm belong to other tiles and are computed but not written.  A
//    row tile of up to 128 rows (MoE's capacity C, `batched_row_tile`) is
//    one block, so each expert's w is read from device memory once per
//    column tile.  What bounds it: reading w, 2 E D F bytes (qwen3's
//    128 x 2048 x 768 experts: 403 MB, 0.12 ms at 3.35 TB/s), at decode
//    (tm = C = 8: the wgmma does 64 rows for 8, 8x the arithmetic needed
//    and still under the bytes) and at prefill (C 80: 2 x 80 x 2048 x 768
//    x 128 = 32 GFLOP, 0.03 ms at the tensor cores' 989 TFLOP/s, against
//    0.12 ms of bytes).  The design's answer is the TMA stream of w: 4
//    stages of 16 KB of w in flight per block, two blocks an SM.
// 2. "ffma" (fp32, and 16-bit shapes TMA cannot take): the CUDA cores'
//    fp32 FMA (TF32 would miss the fp32 budget).  The block loops over D
//    in chunks of 32, staging the x rows and the w[e] chunk in shared
//    memory as fp32 while the next chunk is loaded into registers, 16-byte
//    loads of w where F is a multiple of the vector width and w is
//    aligned (vec = 1).  The 256 threads form 8 row groups x 32 column
//    lanes, each keeping RM x 2 sums (RM = ceil(tm / 8), a template
//    argument, up to 16).
//
// dtype 0 = fp32, 1 = bf16, 2 = fp16; output in the input dtype.
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxTm = 128;

// ---------------------------------------------------------------------------
// walk 1: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kBK = 64;  // D per stage: 64 16-bit values = one 128-byte row
constexpr int kStages = 4;

template <int BM, int BN> struct TcShape {
  static constexpr int kWarpgroups = BM / 64;              // consumers
  static constexpr int kThreads = 128 * (1 + kWarpgroups);  // + one producer warpgroup
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment slack
};

// Block (column tile of F, row tile).
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(TcShape<BM, BN>::kThreads, 1)
    gmm_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmw, const int* __restrict__ ids,
                  T* __restrict__ out, int tm, int d, int f, int e_count) {
  using S = TcShape<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  // 128-byte swizzle atoms are 1024 bytes: align the ring to them
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int f0 = blockIdx.x * BN;
  const size_t row0 = (size_t)blockIdx.y * tm;
  const int e = ids[blockIdx.y];
  if (e < 0 || e >= e_count) {
    // no expert: zero rows, nothing of w is read
    for (int i = threadIdx.x; i < tm * BN; i += S::kThreads) {
      const int r = i / BN, c = f0 + i % BN;
      if (c < f) out[(row0 + r) * f + c] = from_f<T>(0.f);
    }
    return;
  }
  const int nkb = (d + kBK - 1) / kBK;
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
        const int kc = i * kBK;
        tma_load_2d(a, &tmx, &full[s], kc, (int)row0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(b + j * kBK * 128, &tmw, &full[s], f0 + 64 * j, kc, e);
      }
    }
    return;
  }

  // consumer warpgroup g: rows 64 g .. + 63 of the box
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
      // A: 64 rows of 128 bytes, 8-row atoms 1024 bytes apart, a k16 step
      // 32 bytes into the row.  B: 64-column chunks 8192 bytes apart,
      // 8-row atoms 1024 apart, a k16 step 16 rows = 2048 bytes.
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
  const int r0 = g * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int colq = f0 + 2 * (t % 4);
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int col = colq + 8 * c;
    if (col >= f) continue;  // f is even: col + 1 < f too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= tm) continue;
      *reinterpret_cast<uint32_t*>(out + (row0 + r) * f + col) =
          pack2<T>(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
    }
  }
}

template <typename T, int BM, int BN>
int launch_tc(const T* x, const T* w, const int* ids, T* out, int tiles, int tm, int d, int f,
              int e_count, cudaStream_t s) {
  using S = TcShape<BM, BN>;
  const CUtensorMapDataType ty = tma_type<T>();
  CUtensorMap tmx, tmw;
  // x [T, D], box [BM rows, 64]; w [E, D, F], box [1, 64, 64]
  const cuuint64_t wdims[3] = {(cuuint64_t)f, (cuuint64_t)d, (cuuint64_t)e_count};
  const cuuint64_t wstrides[2] = {(cuuint64_t)f * 2, (cuuint64_t)d * f * 2};
  const cuuint32_t wbox[3] = {64, kBK, 1};
  if (!make_map(&tmx, x, tiles * tm, d, BM, ty) ||
      !encode_map(&tmw, ty, 3, w, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  // set at every launch: the attribute is per device
  cudaFuncSetAttribute(gmm_tc_kernel<T, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       S::kSmem);
  dim3 grid((f + BN - 1) / BN, tiles);
  gmm_tc_kernel<T, BM, BN><<<grid, S::kThreads, S::kSmem, s>>>(tmx, tmw, ids, out, tm, d, f,
                                                               e_count);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// walk 2: fp32 FMA tiles
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTY = 8;          // row groups
constexpr int kTX = 32;         // column lanes
constexpr int kRN = 2;          // columns per lane
constexpr int kBN = kTX * kRN;  // 64 columns of F per block
constexpr int kFK = 32;         // rows of D per chunk

template <typename T, int RM>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ ids, T* __restrict__ out, int tm, int d, int f,
               int e_count, int vec) {
  constexpr int BM = kTY * RM;
  constexpr int kVec = 16 / (int)sizeof(T);         // elements per 16-byte load
  constexpr int kVpr = kBN / kVec;                  // vectors per chunk row
  constexpr int kWv = kFK * kVpr / kThreads;        // w vectors per thread
  constexpr int kXe = BM * kFK / kThreads;          // x elements per thread
  static_assert(kWv >= 1 && kFK * kVpr % kThreads == 0, "w chunk split");
  static_assert(kXe >= 1 && BM * kFK % kThreads == 0, "x chunk split");
  __shared__ float xs[kFK][BM + 1];  // x rows, transposed
  __shared__ float ws[kFK][kBN];

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
      const int r = i / kFK, c = k0 + i % kFK;
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
  for (int k0 = 0; k0 < d; k0 += kFK) {
#pragma unroll
    for (int l = 0; l < kXe; ++l) {
      const int i = tid + l * kThreads;
      xs[i % kFK][i / kFK] = rx[l];
    }
#pragma unroll
    for (int l = 0; l < kWv; ++l) {
      const int v = tid + l * kThreads;
#pragma unroll
      for (int j = 0; j < kVec; ++j) ws[v / kVpr][(v % kVpr) * kVec + j] = rw[l][j];
    }
    __syncthreads();
    if (k0 + kFK < d) load(k0 + kFK);
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
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
int launch_ffma(const void* x, const void* w, const int* ids, void* out, int tiles, int tm,
                int d, int f, int e_count, int vec, cudaStream_t s) {
  // row tiles on x (no 65535 cap), so neighbouring blocks of one
  // expert's rows share its w chunks in L2
  dim3 grid(tiles, (f + kBN - 1) / kBN);
  gmm_kernel<T, RM><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), ids, static_cast<T*>(out), tm, d,
      f, e_count, vec);
  return (int)cudaGetLastError();
}

// RM = ceil(tm / 8): 1..8 one by one, then 12 and 16
template <typename T>
int ffma_rm(const void* x, const void* w, const int* ids, void* out, int tiles, int tm, int d,
            int f, int e_count, int vec, cudaStream_t s) {
  switch ((tm + kTY - 1) / kTY) {
    case 1: return launch_ffma<T, 1>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s);
    case 2: return launch_ffma<T, 2>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s);
    case 3: return launch_ffma<T, 3>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s);
    case 4: return launch_ffma<T, 4>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s);
    case 5: return launch_ffma<T, 5>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s);
    case 6: return launch_ffma<T, 6>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s);
    case 7: return launch_ffma<T, 7>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s);
    case 8: return launch_ffma<T, 8>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s);
    case 9: case 10: case 11: case 12:
      return launch_ffma<T, 12>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s);
    default: return launch_ffma<T, 16>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s);
  }
}

enum Walk { kWgmma = 0, kFfma = 1 };

template <typename T>
int dispatch(const void* x, const void* w, const int* ids, void* out, int tiles, int tm, int d,
             int f, int e_count, int walk, int bn, int vec, cudaStream_t s) {
  if (tm < 1 || tm > kMaxTm) return (int)cudaErrorInvalidValue;
  if (walk == kFfma) return ffma_rm<T>(x, w, ids, out, tiles, tm, d, f, e_count, vec, s);
  if (walk != kWgmma || d % 8 || f % 8) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    const T* xt = static_cast<const T*>(x);
    const T* wt = static_cast<const T*>(w);
    T* o = static_cast<T*>(out);
    const bool two = tm > 64;  // two m64 halves
    if (bn == 128)
      return two ? launch_tc<T, 128, 128>(xt, wt, ids, o, tiles, tm, d, f, e_count, s)
                 : launch_tc<T, 64, 128>(xt, wt, ids, o, tiles, tm, d, f, e_count, s);
    if (bn == 64)
      return two ? launch_tc<T, 128, 64>(xt, wt, ids, o, tiles, tm, d, f, e_count, s)
                 : launch_tc<T, 64, 64>(xt, wt, ids, o, tiles, tm, d, f, e_count, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [tiles * tm, d], w [e_count, d, f], ids [tiles] int32 -> out
// [tiles * tm, f]; tm in 1..128.  walk 0 = wgmma (16-bit, d and f
// multiples of 8, bn = 64 or 128 columns a block, x and w 16-byte
// aligned), 1 = ffma (vec != 0 takes 16-byte loads of w: f a multiple of
// 16 / element size, w 16-byte aligned)
extern "C" int gmm(const void* x, const void* w, const void* ids, void* out, int tiles, int tm,
                   int d, int f, int e_count, int walk, int bn, int vec, int dtype,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  switch (dtype) {
    case 0:
      if (walk != kFfma) return (int)cudaErrorInvalidValue;
      return dispatch<float>(x, w, id, out, tiles, tm, d, f, e_count, walk, bn, vec, s);
    case 1:
      return dispatch<__nv_bfloat16>(x, w, id, out, tiles, tm, d, f, e_count, walk, bn, vec,
                                     s);
    case 2: return dispatch<__half>(x, w, id, out, tiles, tm, d, f, e_count, walk, bn, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
