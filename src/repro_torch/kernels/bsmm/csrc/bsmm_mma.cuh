// The tensor-core walk "mma" of the static kernels bsmm and bsmm_balanced:
//
//     y[N, M] = x[N, K] . W^T,   W = [M, K] block-sparse, b x b blocks
//
// for bf16/fp16 at b in {16, 32, 64}, through the warp-level mma.sync
// m16n8k16 (fp32 sums).  The two kernels differ only in how block-rows
// are dealt into groups (bsmm: consecutive rows; bsmm_balanced: the bins
// of the row swizzle), so both launch this one kernel on a schedule the
// plan records once on the host (``bsmm.ops.mma_schedule``):
//
//   group_rows  [G, R]     int32, the block-row of each of a group's R
//                          row slots (-1: none)
//   stage_ptr   [G + 1]    int32, group g walks stages stage_ptr[g] ..
//                          stage_ptr[g + 1] - 1
//   stage_chunk [S]        int32, the 64-column chunk of x a stage reads
//                          (ascending within a group)
//   stage_runs  [S, R, 2]  int32, per stage and row slot: the first tile
//                          of the row's run in the stage, and the run's
//                          block columns within the chunk (a bit each,
//                          bits 0..7) | the run's first place among the
//                          stage's blocks << 8
//
// A row's tiles in one chunk are consecutive in the tile stack (the CSR
// order, columns ascending), so the e-th set bit is tile first + e.  A
// stage holds at most WCAP blocks (the host splits a fuller chunk into
// several stages of the same chunk), packed in shared memory in the
// stage's (row, column) order.  Pad tiles of empty rows are not in the
// schedule; every row slot's output is written, zeros where it has no
// run.
//
// The block: a group of R block-rows and TOK tokens (16 rows x 128
// tokens at b = 16, 16 x 64 at 32, 8 x 64 at 64), 16 warps; where the
// groups and token tiles are too few to fill the card, a slice of the
// group's stages (K slices: each block writes fp32 partial sums, a second
// launch adds them in slice order and rounds once).  Warp w owns
// FS = min(b, 32) output features of row slot w / SPR.  Stages run
// through a ring of S slots, each x's [TOK, 64] chunk (TMA, 128-byte
// swizzle, rows past N zero) and the stage's blocks.  Thread 0 loads x
// D = S - kLag stages ahead; each warp copies its row's blocks of the
// stage D ahead (cp.async, its FS rows of each) into their places.  A
// slot is refilled once every warp has arrived on its `empty` barrier
// kLag stages back, so warps run up to kLag - 1 stages apart.  The
// control of a stage is two reads of the schedule, prefetched a stage
// ahead; a warp with no block in a stage neither waits for its x nor
// multiplies.  The products: ldmatrix gives A from the chunk (tokens x 16
// columns) and B from the block rows (k-contiguous, as mma's col layout
// wants).
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace bsmm_mma {

using namespace hopper;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
// stages between a slot's last reader and its refill: of the ring's 8
// slots, 4 are loaded ahead and 4 are slack between warps (on the card a
// lag of 4 ran faster than 1, 2, 3, 5 or 6, and than 6 or 9 slots)
constexpr int kLag = 4;

template <int B> struct Cfg {
  static constexpr int MT = B == 16 ? 8 : 4;             // m16 tiles of tokens
  static constexpr int TOK = 16 * MT;                    // tokens a block owns
  static constexpr int KC = 64;                          // x columns a chunk
  static constexpr int E = KC / B;                       // block columns a chunk
  static constexpr int FS = B < 32 ? B : 32;             // output features a warp
  static constexpr int SPR = B / FS;                     // warps a row
  static constexpr int R = kWarps / SPR;                 // row slots a group
  static constexpr int XBYTES = TOK * KC * 2;            // x's chunk of a stage
  static constexpr int SW = B * 2 < 128 ? B * 2 : 128;   // a block row's swizzle
  static constexpr int SLAB = FS * B * 2;                // a warp's rows of a block
  static constexpr int WCAP = B == 16 ? 16 : (B == 32 ? 8 : 2);  // blocks a stage
  static constexpr int STAGE = XBYTES + WCAP * SPR * SLAB;
  static constexpr int S = 8;                            // slots of the ring
  static constexpr int D = S - kLag;                     // stages loaded ahead
  static constexpr int SMEM = S * STAGE + 1024;          // + alignment slack
  static constexpr int NT = FS / 8;                      // n8 tiles a warp
  static_assert(STAGE % 1024 == 0, "stages stay aligned to the swizzle atoms");
  static_assert(SMEM <= 227 * 1024, "the ring fits in shared memory");
  static_assert(E <= 8, "a run's block columns fit in 8 bits");
};

template <typename T, int B>
__global__ void __launch_bounds__(kThreads, 1)
    bsmm_mma_kernel(const __grid_constant__ CUtensorMap tmx, const T* __restrict__ tiles,
                    const int* __restrict__ group_rows, const int* __restrict__ stage_ptr,
                    const int* __restrict__ stage_chunk, const int2* __restrict__ stage_runs,
                    T* __restrict__ y, float* __restrict__ part, int n, int m, int slices) {
  using C = Cfg<B>;
  constexpr int S = C::S, D = C::D;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[S], empty[S];
  // 128-byte swizzle atoms are 1024 bytes: align the ring to them; a
  // slot is x's chunk, then the stage's blocks
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32;
  const int g = blockIdx.x, sl = blockIdx.z;
  const int tok0 = blockIdx.y * C::TOK;
  // this block's slice of the group's stages
  const int g0 = stage_ptr[g], gn = stage_ptr[g + 1] - g0;
  const int s0 = g0 + (int)((long long)gn * sl / slices);
  const int ns = g0 + (int)((long long)gn * (sl + 1) / slices) - s0;
  const int lr = w / C::SPR, wp = w % C::SPR, f0 = wp * C::FS;
  const int row = group_rows[g * C::R + lr];
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // thread 0: x's chunk of stage xt into its slot, the chunk of the
  // stage after it read ahead
  int xt = 0, xq = ns > 0 ? stage_chunk[s0] : 0;
  auto load_x = [&]() {
    const int s = xt % S;
    if (xt >= S) mbar_wait(&empty[s], ((xt / S) - 1) & 1);
    mbar_expect_tx(&full[s], C::XBYTES);
    tma_load_2d(ring + s * C::STAGE, &tmx, &full[s], xq * C::KC, tok0);
    ++xt;
    xq = xt < ns ? stage_chunk[s0 + xt] : 0;
  };
  if (tid == 0)
    while (xt < D && xt < ns) load_x();

  // every warp: its row's run at stage t (read a stage ahead), copied
  // into the stage's slot; ent[] keeps each stage in flight's bits and
  // place, ent[0] the stage computed next
  int2 nx = ns > 0 ? stage_runs[(size_t)s0 * C::R + lr] : make_int2(0, 0);
  int ent[D + 1];
  auto take = [&](int t) {
    const int2 e = t < ns ? nx : make_int2(0, 0);
    if (t + 1 < ns) nx = stage_runs[(size_t)(s0 + t + 1) * C::R + lr];
    const int s = t % S;
    // every warp waits, blocks or not: a warp never runs a round of the
    // ring ahead of the others, where the barriers' parities would alias
    if (t < ns && t >= S) mbar_wait(&empty[s], ((t / S) - 1) & 1);
    const unsigned bits = (unsigned)e.y & 0xffu;
    if (bits) {
      uint8_t* wb = ring + s * C::STAGE + C::XBYTES;
      const int off = e.y >> 8;
      int j = 0;
#pragma unroll
      for (int c = 0; c < C::E; ++c) {
        if ((bits >> c) & 1u) {
          const uint8_t* src = reinterpret_cast<const uint8_t*>(
              tiles + ((size_t)(e.x + j) * B + f0) * B);
          uint8_t* dst = wb + ((off + j) * C::SPR + wp) * C::SLAB;
#pragma unroll
          for (int i = lane; i < C::SLAB / 16; i += 32) {
            const int r = i / (2 * B / 16), cc = i % (2 * B / 16);
            cp_async16(dst + slab_at<C::SW, C::FS>(r, cc), src + (size_t)r * B * 2 + 16 * cc);
          }
          ++j;
        }
      }
    }
    cp_async_commit();
    ent[D] = e.y;
  };
  auto shift = [&]() {
#pragma unroll
    for (int i = 0; i < D; ++i) ent[i] = ent[i + 1];
  };
#pragma unroll
  for (int t = 0; t < D; ++t) {
    take(t);
    shift();
  }

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int a = 0; a < C::MT; ++a)
#pragma unroll
    for (int t = 0; t < C::NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][t][e] = 0.f;

  // ldmatrix rows: matrix jm = lane / 8, row lane % 8; A's matrices are
  // (tokens +0, columns +0), (+8, +0), (+0, +8), (+8, +8); B's (features
  // +0, columns +0), (+0, +8), (+8, +0), (+8, +8)
  const int jm = lane / 8, im = lane % 8;
  for (int it = 0; it < ns; ++it) {
    const int s = it % S;
    if (tid == 0 && xt < ns) load_x();
    take(it + D);
    cp_async_wait<D>();
    __syncwarp();  // every lane's copies are visible to the warp
    const unsigned bits = (unsigned)ent[0] & 0xffu;
    if (bits) {
      mbar_wait(&full[s], (it / S) & 1);
      const uint8_t* xs = ring + s * C::STAGE;
      const uint8_t* wb = xs + C::XBYTES;
      const int off = ent[0] >> 8;
      int j = 0;
#pragma unroll
      for (int c = 0; c < C::E; ++c) {
        if (!((bits >> c) & 1u)) continue;
        const uint8_t* vs = wb + ((off + j) * C::SPR + wp) * C::SLAB;
        ++j;
#pragma unroll
        for (int kk = 0; kk < B / 16; ++kk) {
          // B fragments of the warp's FS features: one ldmatrix a 16
          uint32_t bq[C::NT / 2][4];
#pragma unroll
          for (int t2 = 0; t2 < C::NT / 2; ++t2)
            ldmatrix_x4(bq[t2], vs + slab_at<C::SW, C::FS>(16 * t2 + im + 8 * (jm / 2),
                                                           2 * kk + (jm % 2)));
#pragma unroll
          for (int a = 0; a < C::MT; ++a) {
            // A: tokens 16 a .. + 15, columns c b + 16 kk .. + 15 of the
            // chunk (128-byte rows, 128-byte swizzle)
            const int col = c * B + 16 * kk + 8 * (jm / 2);
            const int tr = 16 * a + im + 8 * (jm % 2);
            uint32_t af[4];
            ldmatrix_x4(af, xs + tr * 128 + 16 * ((col / 8) ^ (tr & 7)));
#pragma unroll
            for (int t2 = 0; t2 < C::NT / 2; ++t2) {
              Mma16816<T>::run(acc[a][2 * t2], af, bq[t2][0], bq[t2][1]);
              Mma16816<T>::run(acc[a][2 * t2 + 1], af, bq[t2][2], bq[t2][3]);
            }
          }
        }
      }
    }
    __syncwarp();  // the warp's reads of the slot are done
    if (lane == 0) mbar_arrive(&empty[s]);
    shift();
  }

  // fragment: tokens 16 a + l / 4 (+ 8), features 8 t + 2 (l % 4) (+ 1)
  if (row < 0) return;
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int a = 0; a < C::MT; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = tok0 + 16 * a + gq + 8 * h;
      if (tok >= n) continue;
      const size_t at = (size_t)tok * m + (size_t)row * B + f0 + 2 * tq;
      if (slices > 1) {
        float* out = part + (size_t)sl * n * m + at;
#pragma unroll
        for (int t = 0; t < C::NT; ++t)
          *reinterpret_cast<float2*>(out + 8 * t) =
              make_float2(acc[a][t][2 * h], acc[a][t][2 * h + 1]);
      } else {
        T* out = y + at;
#pragma unroll
        for (int t = 0; t < C::NT; ++t)
          *reinterpret_cast<uint32_t*>(out + 8 * t) =
              pack2<T>(acc[a][t][2 * h], acc[a][t][2 * h + 1]);
      }
    }
}

// y[e] = the slices' partial sums of element e added in slice order,
// rounded once
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ part, T* __restrict__ y, size_t nm,
                              int slices) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nm) return;
  float v = 0.f;
  for (int sl = 0; sl < slices; ++sl) v += part[(size_t)sl * nm + e];
  y[e] = from_f<T>(v);
}

template <typename T, int B>
int launch(const T* x, const T* tiles, const int* group_rows, const int* stage_ptr,
           const int* stage_chunk, const int* stage_runs, T* y, float* part, int n, int k,
           int m, int groups, int slices, cudaStream_t s) {
  using C = Cfg<B>;
  if (slices < 1 || (slices > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  CUtensorMap tmx;
  if (!make_map(&tmx, x, n, k, C::TOK, tma_type<T>())) return (int)cudaErrorInvalidValue;
  // set at every launch: the attribute is per device
  cudaFuncSetAttribute(bsmm_mma_kernel<T, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  dim3 grid(groups, (n + C::TOK - 1) / C::TOK, slices);
  bsmm_mma_kernel<T, B><<<grid, kThreads, C::SMEM, s>>>(
      tmx, tiles, group_rows, stage_ptr, stage_chunk,
      reinterpret_cast<const int2*>(stage_runs), y, part, n, m, slices);
  if (slices > 1) {
    const size_t nm = (size_t)n * m;
    reduce_kernel<T><<<(unsigned)((nm + 255) / 256), 256, 0, s>>>(part, y, nm, slices);
  }
  return (int)cudaGetLastError();
}

// the walk at block b; `rows` and `wcap` are the schedule's R and WCAP,
// checked against this build's (16-byte-aligned x and tiles); `slices` K
// slices, their partial sums in `part` ([slices, n, m] fp32) where > 1
template <typename T>
int run(const void* x, const void* tiles, const void* group_rows, const void* stage_ptr,
        const void* stage_chunk, const void* stage_runs, void* y, float* part, int n, int k,
        int m, int b, int groups, int rows, int wcap, int slices, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* tt = static_cast<const T*>(tiles);
  const int* gr = static_cast<const int*>(group_rows);
  const int* sp = static_cast<const int*>(stage_ptr);
  const int* sc = static_cast<const int*>(stage_chunk);
  const int* sr = static_cast<const int*>(stage_runs);
  T* yt = static_cast<T*>(y);
  switch (b) {
#define BSMM_MMA_CASE(BB)                                                           \
  case BB:                                                                          \
    if (rows != Cfg<BB>::R || wcap != Cfg<BB>::WCAP) return (int)cudaErrorInvalidValue; \
    return launch<T, BB>(xt, tt, gr, sp, sc, sr, yt, part, n, k, m, groups, slices, s);
    BSMM_MMA_CASE(16)
    BSMM_MMA_CASE(32)
    BSMM_MMA_CASE(64)
#undef BSMM_MMA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace bsmm_mma
