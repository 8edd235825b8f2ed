// Block-sampled dense-dense matmul (SDDMM) for Hopper, activation-major:
//
//     out[z] = dy[:, r_z*b:(r_z+1)*b]^T . x[:, c_z*b:(c_z+1)*b]
//
// for every block z of a static b x b pattern, in lexsort (row, col)
// order: the value gradient of y = x . W^T (dL/dvalues of the static
// plan).  Replaces the TPU kernel src/repro/kernels/sddmm/sddmm.py
// `sddmm_tiles_call` (`_sddmm_kernel`) and the block extraction of
// `grouped_sddmm` (src/repro/kernels/sddmm/ops.py).  The TPU computed
// whole t x t tiles (t = 128 at d = 1/8, b = 16) over the non-empty tile
// list and gathered the b x b blocks out of them; at that density a
// 128 x 128 tile is non-empty with probability ~0.9998, so the stack is
// dense and does 8x the work.  Here the kernel samples the pattern's
// b x b blocks directly and writes them in order: no extraction gather.
//
// The wrapper (ops.py `walk`) picks one of two walks; both split the
// work one thread block per (block-row r, slice of N), walk the row's
// run of blocks (CSR row pointer over the lexsort order) in groups that
// share the row's dy slice, and walk N in chunks.  The contraction is
// long (N = batch * seq) and the output per block small, so when the
// rows alone cannot fill the card the wrapper splits N: each slice
// writes fp32 partials to a scratch buffer and a second launch adds them
// in a fixed order and rounds once (deterministic, no atomics).
//
// What bounds it: bytes at the training shapes (each dy and x element
// is needed once; the output is nnz * b^2).  Both walks read each dy
// column slice once per group and each x column slice once per block, so
// x is re-read from L2 by every block of its column (nnz N b 2 bytes:
// 537 MB at the FFN's up/gate, 8192 x 2048, d = 1/8, N 2048).
//
// 1. "mma" (bf16/fp16, b in {16, 32, 64}): tensor cores through the
//    warp-level mma.sync m16n8k16 (fp32 sums), reading x transposed: a
//    first kernel writes x^T [k, N'] (N' = N rounded up to 8, the pad
//    zero) to scratch, so a block's x slice over 64 tokens is b rows of
//    128 bytes, whole L2 lines, where x itself gives b * 2-byte pieces of
//    64 rows (one 32-byte sector each at b = 16).  A producer warp
//    streams, per chunk of 64 tokens, the row's dy box [64, b] (rows
//    swizzled to their width, 32 / 64 / 128 bytes) and one x^T box [b,
//    64] (128-byte swizzle) for each block of the group by TMA (rows past
//    N zero) into a ring of three stages, one lane a box (one thread
//    issuing a stage's 17 boxes in turn held the walk well below the rate
//    of the lanes issuing them together).  16 consumer warps own the
//    group's blocks, b / 16 warps a block, each an m16 slab of its rows:
//    per k16 step of tokens one ldmatrix.trans gives the A fragment (dy^T,
//    the slab's 16 features) and one ldmatrix per 16 columns the B
//    fragments (x^T rows), then b / 8 mma.sync.  Why not wgmma: its 64-row
//    minimum stacks 4 block-rows at b = 16 in one product, and at d = 1/8
//    fewer than one block in three of such a stack is in the pattern, so
//    about 70 % of the work would be wasted (the TPU's t = 128 tiles
//    wasted 8x); the walk is bound by bytes either way.
// 2. "ffma" (fp32, b in {4, 8}, and 16-bit where the caller asks): chunks
//    of CN = 32 tokens staged through shared memory as fp32 (16-byte
//    loads where a row slice is that long) and multiplied into fp32 sums
//    on the CUDA cores, an MT x MT micro-tile per thread; warps whose
//    blocks lie past the end of the row's run skip the arithmetic.
//
// Inputs (device pointers):
//   dy       [n, m]          upstream gradient, row-major, 16-byte aligned
//   x        [n, k]          forward input, row-major, 16-byte aligned
//   xt       [k, ldx]        scratch for x^T (mma; ldx = n rounded up to 8)
//   row_ptr  [m / b + 1]     CSR pointer over the blocks, int32
//   col_idx  [nnz]           block column of each block, int32
//   out      [nnz, b, b]     result in the input dtype (fully written)
//   partial  [splits, nnz, b, b] fp32 scratch (splits > 1 only)
// b in {4, 8, 16, 32, 64}; dtype 0 = fp32, 1 = bf16, 2 = fp16.
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;

template <int TB>
struct Cfg {
  static constexpr int MT = TB == 4 ? 1 : TB == 8 ? 2 : TB == 16 ? 4 : 8;  // micro-tile side
  static constexpr int SIDE = TB / MT;               // micro-tiles per block side
  static constexpr int TPB = SIDE * SIDE;            // threads per output block
  static constexpr int G = kThreads / TPB;           // output blocks per group
  static constexpr int CN = TB >= 32 ? 16 : 32;      // rows of N per staged chunk
  static constexpr int XS = CN * TB + TB;            // x slice stride (+TB: banks)
};

// one vector load of a row slice: 16 bytes, or the whole slice if shorter
template <int BYTES> struct VecT;
template <> struct VecT<4> { using type = unsigned int; };
template <> struct VecT<8> { using type = uint2; };
template <> struct VecT<16> { using type = uint4; };

template <typename T, int TB>
struct Vec {
  static constexpr int BYTES = TB * (int)sizeof(T) < 16 ? TB * (int)sizeof(T) : 16;
  static constexpr int ELEMS = BYTES / (int)sizeof(T);  // elements per vector
  static constexpr int PER_ROW = TB / ELEMS;             // vectors per row slice
  using type = typename VecT<BYTES>::type;

  // load the vector at src (or zeros) and store it as floats at dst
  __device__ __forceinline__ static void copy(const T* src, bool ok, float* dst) {
    type v = type();  // zero bits: 0.0 in every dtype
    if (ok) v = *reinterpret_cast<const type*>(src);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < ELEMS; ++i) dst[i] = to_f<T>(e[i]);
  }
};

template <typename T, int TB>
__global__ void __launch_bounds__(kThreads)
    sddmm_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                 const int* __restrict__ row_ptr, const int* __restrict__ col_idx,
                 T* __restrict__ out, float* __restrict__ partial, int n, int m, int k,
                 int nnz, int splits) {
  using C = Cfg<TB>;
  using V = Vec<T, TB>;
  __shared__ float dys[C::CN * TB];
  __shared__ float xs[C::G * C::XS];
  __shared__ int cols[C::G];

  const int r = blockIdx.x;
  const int split = blockIdx.y;
  const int chunks = (n + C::CN - 1) / C::CN;
  const int c_begin = (int)((long long)chunks * split / splits);
  const int c_end = (int)((long long)chunks * (split + 1) / splits);
  const int tid = threadIdx.x;
  const int g = tid / C::TPB;
  const int q = tid % C::TPB;
  const int i0 = (q / C::SIDE) * C::MT;
  const int j0 = (q % C::SIDE) * C::MT;
  const int z_end = row_ptr[r + 1];

  for (int z0 = row_ptr[r]; z0 < z_end; z0 += C::G) {
    const int nz = min(C::G, z_end - z0);
    if (tid < C::G) cols[tid] = tid < nz ? col_idx[z0 + tid] : 0;
    __syncthreads();
    float acc[C::MT][C::MT];
#pragma unroll
    for (int p = 0; p < C::MT; ++p)
#pragma unroll
      for (int qq = 0; qq < C::MT; ++qq) acc[p][qq] = 0.f;

    for (int ch = c_begin; ch < c_end; ++ch) {
      const int t0 = ch * C::CN;
      // stage dy[t0 : t0 + CN, r*TB : (r+1)*TB] and, for each block of
      // the group, x[t0 : t0 + CN, c*TB : (c+1)*TB] with vector loads
      // (16 bytes where the slice allows); rows past n and blocks past
      // the run are 0
      for (int e = tid; e < C::CN * V::PER_ROW; e += kThreads) {
        const int row = e / V::PER_ROW, v = e % V::PER_ROW;
        const int tok = t0 + row;
        V::copy(dy + (size_t)tok * m + (size_t)r * TB + v * V::ELEMS, tok < n,
                dys + row * TB + v * V::ELEMS);
      }
      for (int e = tid; e < C::G * C::CN * V::PER_ROW; e += kThreads) {
        const int gg = e / (C::CN * V::PER_ROW);
        const int rem = e % (C::CN * V::PER_ROW);
        const int row = rem / V::PER_ROW, v = rem % V::PER_ROW;
        const int tok = t0 + row;
        V::copy(x + (size_t)tok * k + (size_t)cols[gg] * TB + v * V::ELEMS,
                gg < nz && tok < n, xs + gg * C::XS + row * TB + v * V::ELEMS);
      }
      __syncthreads();
      const float* xg = xs + g * C::XS;
      // a block past the run's end does no arithmetic (whole warps idle)
      if (g < nz) {
#pragma unroll 4
        for (int t = 0; t < C::CN; ++t) {
          float a[C::MT], bv[C::MT];
#pragma unroll
          for (int p = 0; p < C::MT; ++p) a[p] = dys[t * TB + i0 + p];
#pragma unroll
          for (int qq = 0; qq < C::MT; ++qq) bv[qq] = xg[t * TB + j0 + qq];
#pragma unroll
          for (int p = 0; p < C::MT; ++p)
#pragma unroll
            for (int qq = 0; qq < C::MT; ++qq) acc[p][qq] += a[p] * bv[qq];
        }
      }
      __syncthreads();
    }
    if (g < nz) {
      const size_t base = (size_t)(z0 + g) * TB * TB;
#pragma unroll
      for (int p = 0; p < C::MT; ++p)
#pragma unroll
        for (int qq = 0; qq < C::MT; ++qq) {
          const size_t idx = base + (size_t)(i0 + p) * TB + j0 + qq;
          if (splits == 1)
            out[idx] = from_f<T>(acc[p][qq]);
          else
            partial[(size_t)split * nnz * TB * TB + idx] = acc[p][qq];
        }
    }
  }
}

// out[e] = sum over the splits of partial[s][e], rounded once
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sddmm_reduce_kernel(const float* __restrict__ partial, T* __restrict__ out,
                        size_t total, int splits) {
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[(size_t)p * total + e];
    out[e] = from_f<T>(s);
  }
}

// ---------------------------------------------------------------------------
// walk 1: TMA + mma.sync
// ---------------------------------------------------------------------------

constexpr int kCWarps = 16;                     // consumer warps
constexpr int kMmaThreads = 32 * kCWarps + 32;  // + one producer warp
constexpr int kMN = 64;                         // tokens a stage

template <int TB> struct Mc {
  static constexpr int WPB = TB / 16;            // warps a block (m16 slabs)
  static constexpr int G = kCWarps / WPB;        // blocks a group: 16, 8, 4
  static constexpr int SW = TB * 2;              // dy's row bytes = swizzle bytes
  static constexpr int BOX = kMN * SW;           // dy [64, TB] or x^T [TB, 64]
  static constexpr int STAGE = (G + 1) * BOX;    // dy box + G x boxes
  static constexpr int STAGES = 3;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
  static_assert(STAGE % 1024 == 0, "stages stay aligned to the swizzle atoms");
};

// byte offset of 16-byte chunk `c` of row `row` in a box written by TMA
// with rows of SW bytes and an SW-byte swizzle
template <int SW> __device__ __forceinline__ int swz(int row, int c) {
  return row * SW + 16 * (c ^ ((row * SW >> 7) & (SW / 16 - 1)));
}

template <typename T, int TB>
__global__ void __launch_bounds__(kMmaThreads, TB <= 32 ? 2 : 1)
    sddmm_mma_kernel(const __grid_constant__ CUtensorMap tmdy,
                     const __grid_constant__ CUtensorMap tmx, const int* __restrict__ row_ptr,
                     const int* __restrict__ col_idx, T* __restrict__ out,
                     float* __restrict__ partial, int n, int nnz, int splits) {
  using C = Mc<TB>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[C::STAGES], empty[C::STAGES];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int r = blockIdx.x;
  const int split = blockIdx.y;
  const int chunks = (n + kMN - 1) / kMN;
  const int c_begin = (int)((long long)chunks * split / splits);
  const int c_end = (int)((long long)chunks * (split + 1) / splits);
  const int z_begin = row_ptr[r], z_end = row_ptr[r + 1];

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCWarps * 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kCWarps * 32) {  // producer warp: lane 0 the dy box, lane g + 1 block g's
    const int lane = threadIdx.x & 31;
    int it = 0;
    for (int z0 = z_begin; z0 < z_end; z0 += C::G) {
      const int ng = min(C::G, z_end - z0);
      const int col = lane >= 1 && lane <= ng ? __ldg(col_idx + z0 + lane - 1) : 0;
      for (int ch = c_begin; ch < c_end; ++ch, ++it) {
        const int s = it % C::STAGES;
        uint8_t* st = ring + s * C::STAGE;
        if (lane == 0) {
          mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], (1 + ng) * C::BOX);
          tma_load_2d(st, &tmdy, &full[s], r * TB, ch * kMN);
        }
        __syncwarp();
        if (lane >= 1 && lane <= ng)
          tma_load_2d(st + lane * C::BOX, &tmx, &full[s], ch * kMN, col * TB);
      }
    }
    return;
  }

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = w / C::WPB;     // block of the group
  const int slab = w % C::WPB;   // its rows 16 slab .. + 15
  // ldmatrix rows: matrix j = lane / 8, row lane % 8; A's matrices
  // (dy, transposed) are (tokens +0, features +0), (+0, +8), (+8, +0),
  // (+8, +8), B's (x^T) (columns +0, tokens +0), (+0, +8), (+8, +0),
  // (+8, +8)
  const int j = lane / 8, i = lane % 8;
  const int a_tok = i + 8 * (j / 2), a_chunk = 2 * slab + (j % 2);
  const int b_col = i + 8 * (j / 2), b_chunk = j % 2;
  const int gq = lane / 4, tq = lane % 4;
  int it = 0;
  for (int z0 = z_begin; z0 < z_end; z0 += C::G) {
    const int ng = min(C::G, z_end - z0);
    float acc[TB / 8][4];
#pragma unroll
    for (int t = 0; t < TB / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
    for (int ch = c_begin; ch < c_end; ++ch, ++it) {
      const int s = it % C::STAGES;
      mbar_wait(&full[s], (it / C::STAGES) & 1);
      if (gi < ng) {  // a block past the run's end does no arithmetic
        const uint8_t* dys = ring + s * C::STAGE;
        const uint8_t* xs = dys + (1 + gi) * C::BOX;
#pragma unroll
        for (int ks = 0; ks < kMN / 16; ++ks) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, dys + swz<C::SW>(16 * ks + a_tok, a_chunk));
#pragma unroll
          for (int p = 0; p < TB / 16; ++p) {
            uint32_t bq[4];
            ldmatrix_x4(bq, xs + swz<128>(16 * p + b_col, 2 * ks + b_chunk));
            Mma16816<T>::run(acc[2 * p], a, bq[0], bq[1]);
            Mma16816<T>::run(acc[2 * p + 1], a, bq[2], bq[3]);
          }
        }
      }
      mbar_arrive(&empty[s]);
    }
    if (gi < ng) {
      // D fragment: rows gq, gq + 8 of the slab, columns 8 t + 2 tq, + 1
      const size_t base = (size_t)(z0 + gi) * TB * TB;
#pragma unroll
      for (int t = 0; t < TB / 8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t idx = base + (size_t)(16 * slab + gq + 8 * h) * TB + 8 * t + 2 * tq;
          if (splits == 1) {
            *reinterpret_cast<uint32_t*>(out + idx) = pack2<T>(acc[t][2 * h], acc[t][2 * h + 1]);
          } else {
            *reinterpret_cast<float2*>(partial + (size_t)split * nnz * TB * TB + idx) =
                make_float2(acc[t][2 * h], acc[t][2 * h + 1]);
          }
        }
    }
  }
}

// xt[f, t] = x[t, f] for t < ldx (zero past n): 64 x 64 tiles through
// shared memory, 16-byte loads and stores (k and ldx multiples of 8)
template <typename T>
__global__ void __launch_bounds__(256)
    transpose_kernel(const T* __restrict__ x, T* __restrict__ xt, int n, int k, int ldx) {
  __shared__ T tile[64][66];  // [feature][token]
  const int f0 = blockIdx.x * 64, t0 = blockIdx.y * 64;
  for (int v = threadIdx.x; v < 512; v += 256) {
    const int r = v / 8, c = (v % 8) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t0 + r < n && f0 + c < k)
      val = *reinterpret_cast<const uint4*>(x + (size_t)(t0 + r) * k + f0 + c);
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) tile[c + i][r] = e[i];
  }
  __syncthreads();
  for (int v = threadIdx.x; v < 512; v += 256) {
    const int r = v / 8, c = (v % 8) * 8;
    if (f0 + r >= k || t0 + c >= ldx) continue;
    uint4 val;
    T* e = reinterpret_cast<T*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = tile[r][c + i];
    *reinterpret_cast<uint4*>(xt + (size_t)(f0 + r) * ldx + t0 + c) = val;
  }
}

template <typename T>
int reduce_splits(void* partial, void* out, int nnz, int tb, int splits, cudaStream_t stream) {
  if (splits > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t total = (size_t)nnz * tb * tb;
    size_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 132 * 8) blocks = 132 * 8;
    sddmm_reduce_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<T*>(out), total, splits);
  }
  return (int)cudaGetLastError();
}

template <typename T, int TB>
int launch_mma(const void* dy, const void* x, const void* row_ptr, const void* col_idx,
               void* out, void* partial, void* xt, int n, int m, int k, int ldx, int nnz,
               int splits, cudaStream_t stream) {
  using C = Mc<TB>;
  if (ldx < n || ldx % 8 || xt == nullptr) return (int)cudaErrorInvalidValue;
  transpose_kernel<T><<<dim3((k + 63) / 64, (ldx + 63) / 64), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(xt), n, k, ldx);
  const CUtensorMapDataType ty = tma_type<T>();
  CUtensorMap tmdy, tmx;
  // dy [n, m], box [64 rows, TB columns] swizzled to TB * 2 bytes; x^T
  // [k, ldx], box [TB rows, 64 columns], 128-byte swizzle
  const cuuint64_t ddims[2] = {(cuuint64_t)m, (cuuint64_t)n};
  const cuuint64_t dstr[1] = {(cuuint64_t)m * 2};
  const cuuint32_t dbox[2] = {(cuuint32_t)TB, (cuuint32_t)kMN};
  const cuuint64_t xdims[2] = {(cuuint64_t)ldx, (cuuint64_t)k};
  const cuuint64_t xstr[1] = {(cuuint64_t)ldx * 2};
  const cuuint32_t xbox[2] = {(cuuint32_t)kMN, (cuuint32_t)TB};
  if (!encode_map(&tmdy, ty, 2, dy, ddims, dstr, dbox, C::SW) ||
      !encode_map(&tmx, ty, 2, xt, xdims, xstr, xbox, 128))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(sddmm_mma_kernel<T, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  dim3 grid(m / TB, splits);
  sddmm_mma_kernel<T, TB><<<grid, kMmaThreads, C::SMEM, stream>>>(
      tmdy, tmx, static_cast<const int*>(row_ptr), static_cast<const int*>(col_idx),
      static_cast<T*>(out), static_cast<float*>(partial), n, nnz, splits);
  return reduce_splits<T>(partial, out, nnz, TB, splits, stream);
}

template <typename T, int TB>
int launch(const void* dy, const void* x, const void* row_ptr, const void* col_idx,
           void* out, void* partial, int n, int m, int k, int nnz, int splits,
           cudaStream_t stream) {
  dim3 grid(m / TB, splits);
  sddmm_kernel<T, TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const int*>(row_ptr),
      static_cast<const int*>(col_idx), static_cast<T*>(out), static_cast<float*>(partial),
      n, m, k, nnz, splits);
  return reduce_splits<T>(partial, out, nnz, TB, splits, stream);
}

enum Walk { kMma = 0, kFfma = 1 };

template <typename T>
int dispatch_tb(const void* dy, const void* x, const void* row_ptr, const void* col_idx,
                void* out, void* partial, void* xt, int n, int m, int k, int ldx, int nnz,
                int splits, int tb, int walk, cudaStream_t s) {
  if (splits < 1 || (splits > 1 && partial == nullptr)) return (int)cudaErrorInvalidValue;
  if (walk == kFfma) {
    switch (tb) {
      case 4: return launch<T, 4>(dy, x, row_ptr, col_idx, out, partial, n, m, k, nnz, splits, s);
      case 8: return launch<T, 8>(dy, x, row_ptr, col_idx, out, partial, n, m, k, nnz, splits, s);
      case 16: return launch<T, 16>(dy, x, row_ptr, col_idx, out, partial, n, m, k, nnz, splits, s);
      case 32: return launch<T, 32>(dy, x, row_ptr, col_idx, out, partial, n, m, k, nnz, splits, s);
      case 64: return launch<T, 64>(dy, x, row_ptr, col_idx, out, partial, n, m, k, nnz, splits, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (walk != kMma) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    switch (tb) {
      case 16:
        return launch_mma<T, 16>(dy, x, row_ptr, col_idx, out, partial, xt, n, m, k, ldx, nnz,
                                 splits, s);
      case 32:
        return launch_mma<T, 32>(dy, x, row_ptr, col_idx, out, partial, xt, n, m, k, ldx, nnz,
                                 splits, s);
      case 64:
        return launch_mma<T, 64>(dy, x, row_ptr, col_idx, out, partial, xt, n, m, k, ldx, nnz,
                                 splits, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// walk 0 = mma (16-bit, tb in {16, 32, 64}, dy, x and xt 16-byte
// aligned, xt [k, ldx] scratch with ldx = n rounded up to 8), 1 = ffma
// (every dtype and block; xt and ldx unused)
extern "C" int sddmm(const void* dy, const void* x, const void* row_ptr, const void* col_idx,
                     void* out, void* partial, void* xt, int n, int m, int k, int ldx,
                     int nnz, int splits, int tb, int dtype, int walk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_tb<float>(dy, x, row_ptr, col_idx, out, partial, xt, n, m, k, ldx, nnz,
                                splits, tb, walk, s);
    case 1:
      return dispatch_tb<__nv_bfloat16>(dy, x, row_ptr, col_idx, out, partial, xt, n, m, k,
                                        ldx, nnz, splits, tb, walk, s);
    case 2:
      return dispatch_tb<__half>(dy, x, row_ptr, col_idx, out, partial, xt, n, m, k, ldx, nnz,
                                 splits, tb, walk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
