// Dynamic block-sparse matmul for Hopper, activation-major:
//
//     y[N, M] = x[N, K] . W^T,   W = [M, K] held as runtime slots
//
// Replaces the TPU kernel src/repro/kernels/dsmm/dsmm.py `dsmm_call`
// (`_dsmm_kernel`), in the transposed form the sparse layers need.  The
// pattern is device data: slot s holds the b x b block values[s] at
// block-row rows[s], block-col cols[s]; padded slots hold zeros at
// (0, 0) and add exactly zero (the runtime encoder `encode_slots` moves
// them off the grid, where every walk skips them).  The only
// precondition on the slot order is that each block-row's slots are
// contiguous (the runtime encoders `encode_slots` and
// `_encode_slots_balanced` give that; rows need not ascend); the
// tensor-core walk is fastest where each row's columns ascend, as
// `encode_slots` sorts them.
//
// The TPU walked one sequential grid over the slots and flushed a VMEM
// accumulator when the row changed.  Hopper's blocks run in parallel and
// in no order, so no host CSR exists to drive them: the launch is sized
// from host-known numbers only (M / b row-tiles, N token tiles, capacity
// S), and a first small kernel finds each block-row's run [start, end)
// on the device by comparing neighbouring slots.  Every output tile is
// written once -- zeros for an empty run, so every output element is
// written whatever the pattern.  No value is read on the host: a new
// pattern every call never waits for the device.  The wrapper (ops.py
// `walk`) picks one of two walks:
//
// 1. "mma" (bf16/fp16, b in {16, 32, 64, 128}): tensor cores through the
//    warp-level mma.sync m16n8k16 (fp32 sums).  What bounds the product is
//    reading x again for every block of its column: one gather per slot
//    reads x from L2 nnz N b 2 bytes (64 times x itself at d = 1/8 and the
//    FFN's shapes).  Here a thread block owns a group of block-rows and a
//    token tile (16 rows x 128 tokens at b = 16; 512 / b rows x 64 tokens
//    above), and reads each chunk of x (64 columns, b at b = 128) once
//    for the whole group: its 16 warps share every chunk, so x's L2
//    traffic falls to (m / 16 b) reads of x at b = 16 (268 MB at up/gate
//    N 2048, with 67 MB of slots, against ~540 MB of per-slot gathers).
//    The walk: a setup pass records each row's runs (consecutive slots of
//    one chunk in ascending columns) in shared memory and marks the
//    touched chunks; the stages then visit the touched chunks in
//    ascending order, once per sweep (a row whose columns do not ascend
//    takes more sweeps, never a wrong sum).  Thread 0 keeps x's chunks in
//    flight by TMA ([tokens, 64] boxes, 128-byte swizzle, rows past N
//    zero) in a ring of up to three stages; warp w owns a block-row's
//    FS = min(b, 32) output features and, stages ahead, copies its row's
//    blocks in the stage's chunk (its FS rows of each) into its own part
//    of the stage with cp.async.  The
//    products: ldmatrix gives A from the chunk (tokens x 16 columns) and B
//    from the block rows (k-contiguous, as mma's col layout wants).  A
//    first design on wgmma (one m64 x b accumulator per block-row, a
//    producer warp staging every slot) was slower: under the
//    data-dependent selection of slots ptxas serialised the narrow
//    (n = 16) wgmmas, and one producer warp's per-stage schedule held
//    the walk.  What bounds this one is the instruction rate of each
//    warp's per-stage control (its run, its copies, its predicated
//    products), not the bytes.
// 2. "ffma" (fp32, b in {4, 8}, and 16-bit where the caller asks): one
//    256-thread block per (row-tile, token tile) walks its run; each
//    slot step stages its b x b block (in chunks of 32 columns for
//    b > 32) and the matching x slice in shared memory as fp32, and every
//    thread accumulates a strip of its row for several tokens on the CUDA
//    cores.
//
// Inputs (all device pointers):
//   x       [n, k]       activations, row-major (16-byte aligned, mma)
//   values  [S, b, b]    slot values (16-byte aligned, mma)
//   rows    [S]          block-row of each slot, int32
//   cols    [S]          block-col of each slot, int32
//   bounds  [2 * mb]     scratch, int32, zeroed by the caller
//   y       [n, m]       output, fully written
// b in {4, 8, 16, 32, 64, 128}; dtype 0 = fp32, 1 = bf16, 2 = fp16;
// output in the input dtype, fp32 accumulation.  Slots whose row or col
// lies outside the grid are skipped.
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

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

// run bounds of every block-row (both walks)
int find_bounds(const void* rows, void* bounds, int mb, int s_cap, cudaStream_t stream) {
  if (s_cap > 0) {
    run_bounds_kernel<<<(s_cap + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        static_cast<const int*>(rows), s_cap, mb, static_cast<int*>(bounds));
  }
  return (int)cudaGetLastError();
}

template <typename T, int B>
void launch_ffma(const void* x, const void* values, const void* cols, const void* bounds,
                 void* y, int n, int k, int m, cudaStream_t stream) {
  dim3 grid(m / B, (n + Cfg<B>::BN - 1) / Cfg<B>::BN);
  dsmm_nt_kernel<T, B><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(values),
      static_cast<const int*>(cols), static_cast<const int*>(bounds), static_cast<T*>(y), n,
      k, m);
}

template <typename T>
int ffma_b(const void* x, const void* values, const void* cols, const void* bounds, void* y,
           int n, int k, int m, int b, cudaStream_t s) {
  switch (b) {
    case 4: launch_ffma<T, 4>(x, values, cols, bounds, y, n, k, m, s); break;
    case 8: launch_ffma<T, 8>(x, values, cols, bounds, y, n, k, m, s); break;
    case 16: launch_ffma<T, 16>(x, values, cols, bounds, y, n, k, m, s); break;
    case 32: launch_ffma<T, 32>(x, values, cols, bounds, y, n, k, m, s); break;
    case 64: launch_ffma<T, 64>(x, values, cols, bounds, y, n, k, m, s); break;
    case 128: launch_ffma<T, 128>(x, values, cols, bounds, y, n, k, m, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// walk 1: TMA + mma.sync over a group of block-rows
// ---------------------------------------------------------------------------

constexpr int kWarps = 16;                   // warps a block
constexpr int kTcThreads = 32 * kWarps;
constexpr int kColCap = 3072;                // group's slots whose runs are recorded
constexpr int kMaskWords = 128;              // touched chunks, a bit each (K <= 262144)
constexpr int kQList = 1024;                 // touched chunks listed in ascending order
constexpr int kCopyPer = (kColCap + kTcThreads - 1) / kTcThreads;  // staged columns a thread

template <int B> struct Mm {
  static constexpr int MT = B == 16 ? 8 : 4;            // m16 tiles of tokens a block
  static constexpr int TOK = 16 * MT;                   // tokens a block owns
  static constexpr int XBOX = TOK * 128;                // one [TOK, 64 columns] box
  static constexpr int FS = B < 32 ? B : 32;            // output features a warp
  static constexpr int SPR = B / FS;                    // warps a row (b >= 64: several)
  static constexpr int R = kWarps / SPR;                // block-rows of the group
  static constexpr int KC = B < 64 ? 64 : B;            // x columns a chunk
  static constexpr int E = KC / B;                      // block columns a chunk
  static constexpr int XBYTES = TOK * KC * 2;
  static constexpr int SW = B * 2 < 128 ? B * 2 : 128;  // a block row's swizzle
  static constexpr int SLAB = FS * B * 2;               // a warp's rows of one block
  static constexpr int WBUF = E * SLAB;                 // a warp's blocks of one stage
  // stages in flight (x and blocks): three where they fit beside the
  // ~28 KB of static shared memory, else two (one at b = 128)
  static constexpr int STAGES =
      B == 128 ? 1 : 3 * (XBYTES + kWarps * WBUF) + 30 * 1024 <= 227 * 1024 ? 3 : 2;
  static constexpr int STAGE = XBYTES + kWarps * WBUF;
  static constexpr int SMEM = STAGES * STAGE + 1024;     // + alignment slack
  static constexpr int NT = FS / 8;                     // n8 tiles a warp
  static_assert(R <= 32 && E <= 32, "rows and block columns a group holds");
  static_assert(STAGE % 1024 == 0, "stages stay aligned to the swizzle atoms");
};

// The run of a row's slots `src[0, len)` that starts at `cur`: slots whose
// column lies outside the grid are passed over first, then consecutive
// slots of one chunk in ascending columns.  Returns the chunk (INT_MAX when
// the row is walked), the run's first slot and its block columns within
// the chunk (a bit each), and advances `cur` past it.  `seg` counts the
// runs whose chunk does not exceed the previous run's: the sweep a run
// belongs to (0 for every run of a row whose columns ascend).
template <int B, int KC, int E>
__device__ __forceinline__ int next_run(const int* src, int len, int kb, int& cur, int& prevq,
                                        int& seg, int& start, unsigned& bits) {
  int c = cur < len ? src[cur] : 0;
  while (cur < len && (c < 0 || c >= kb)) {
    ++cur;
    c = cur < len ? src[cur] : 0;
  }
  if (cur >= len) return INT_MAX;
  const int q = c * B / KC;
  start = cur;
  bits = 0;
  int last = -1, cnt = 0;
  do {
    last = c - q * E;
    bits |= 1u << last;
    ++cnt;
    if (cur + cnt >= len) break;
    c = src[cur + cnt];
  } while (c >= 0 && c < kb && c * B / KC == q && c - q * E > last);
  cur += cnt;
  if (q <= prevq) ++seg;
  prevq = q;
  return q;
}

// Block (group of R block-rows, TOK tokens).  Stages walk the touched
// chunks of K in ascending order, once per sweep.  Thread 0 loads x's
// chunks STAGES - 1 stages ahead through TMA; warp w owns a block-row's
// FS output features and, as far ahead, takes the row's run at each
// stage's chunk, copying its blocks' rows into its own part of that
// stage (cp.async).
template <typename T, int B>
__global__ void __launch_bounds__(kTcThreads, 1)
    dsmm_mma_kernel(const __grid_constant__ CUtensorMap tmx,
                    const T* __restrict__ values, const int* __restrict__ cols,
                    const int* __restrict__ bounds, T* __restrict__ y, int n, int k, int m) {
  using C = Mm<B>;
  constexpr int S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[S], empty[S];
  __shared__ int rfirst[32], rlen[32], rend[32], roff[32];
  __shared__ unsigned qmask[kMaskWords];
  __shared__ int nsweep, nlist, rnrun[32];
  __shared__ uint16_t qlist[kQList];
  // each recorded row's runs in order: (chunk | sweep << 16, first slot |
  // block columns << 20)
  __shared__ int2 rrec[kColCap];
  // 128-byte swizzle atoms are 1024 bytes: align the ring to them; a
  // stage is x's chunk, then each warp's blocks
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32;
  const int mb = m / B, kb = k / B;
  const int nq = (k + C::KC - 1) / C::KC;
  const bool masked = nq <= 32 * kMaskWords;  // else every chunk is walked
  const int r0 = blockIdx.x * C::R;
  const int tok0 = blockIdx.y * C::TOK;

  // setup 1: each row's slots and their place among the columns staged
  // in shared memory (roff -1: read from device memory)
  if (w == 0) {
    int first = 0, len = 0;
    if (lane < C::R && r0 + lane < mb) {
      first = bounds[r0 + lane];
      len = bounds[mb + r0 + lane] - first;
    }
    int end = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, end, o);
      if (lane >= o) end += v;
    }
    rfirst[lane] = first;
    rlen[lane] = len;
    rend[lane] = min(end, kColCap);
    roff[lane] = end <= kColCap ? end - len : -1;
    if (lane == 0) {
      nsweep = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kTcThreads);
      }
      mbar_fence_init();
    }
  }
  for (int i = tid; i < kMaskWords; i += kTcThreads) qmask[i] = 0;
  __syncthreads();
  // setup 2: the recorded rows' columns, staged in the (still idle) ring,
  // up to 6 a thread, the loads first
  int* tcols = reinterpret_cast<int*>(ring);
  {
    int v[kCopyPer], at[kCopyPer];
#pragma unroll
    for (int u = 0; u < kCopyPer; ++u) {
      const int i = tid + u * kTcThreads;
      at[u] = -1;
      if (i < rend[31]) {
        int lo = 0;  // the row whose staged range holds i
#pragma unroll
        for (int h = 16; h > 0; h >>= 1)
          if (rend[lo + h - 1] <= i) lo += h;
        if (roff[lo] >= 0) {
          at[u] = i;
          v[u] = __ldg(cols + rfirst[lo] + (i - roff[lo]));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kCopyPer; ++u)
      if (at[u] >= 0) tcols[at[u]] = v[u];
  }
  __syncthreads();
  // setup 3: a thread a row walks its runs once: their chunks into the
  // mask, the sweeps they need, and (for a recorded row) the runs
  if (tid < C::R) {
    const bool rec = roff[tid] >= 0;
    const int* src = rec ? tcols + roff[tid] : cols + rfirst[tid];
    const int len = rlen[tid];
    int cur = 0, prevq = INT_MAX, seg = -1, st, nr = 0, word = -1;
    unsigned bits, acc = 0;
    for (;;) {
      const int q = next_run<B, C::KC, C::E>(src, len, kb, cur, prevq, seg, st, bits);
      if (q == INT_MAX) break;
      if (rec) rrec[roff[tid] + nr++] = make_int2(q | (seg << 16), st | (int)(bits << 20));
      if (masked) {
        if (q >> 5 != word) {
          if (word >= 0) atomicOr(&qmask[word], acc);
          word = q >> 5;
          acc = 0;
        }
        acc |= 1u << (q & 31);
      }
    }
    if (word >= 0) atomicOr(&qmask[word], acc);
    rnrun[tid] = nr;
    if (seg >= 0) atomicMax(&nsweep, seg + 1);
  }
  __syncthreads();
  // setup 4: the touched chunks in ascending order (warp 0); where more
  // than kQList are touched every chunk is walked
  if (w == 0) {
    int base = 0;
    for (int w0 = 0; w0 < kMaskWords && w0 * 32 < nq; w0 += 32) {
      const unsigned bits = masked && w0 + lane < kMaskWords ? qmask[w0 + lane] : 0u;
      int incl = __popc(bits);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      int at = base + incl - __popc(bits);
      for (unsigned b2 = bits; b2; b2 &= b2 - 1, ++at)
        if (at < kQList) qlist[at] = (uint16_t)((w0 + lane) * 32 + __ffs(b2) - 1);
      base += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) nlist = masked && base <= kQList ? base : -1;
  }
  __syncthreads();
  const int sweeps = nsweep;
  const int nl = nlist < 0 ? nq : nlist;  // stages a sweep

  // stage t of the walk: sweep t / nl, the (t % nl)-th touched chunk; a
  // cursor (p, i) steps through them
  auto chunk_of = [&](int i) { return nlist < 0 ? i : (int)qlist[i]; };
  auto advance = [&](int& p, int& i) {
    if (++i == nl) {
      i = 0;
      ++p;
    }
  };
  // thread 0: x's chunk q into stage slot s
  auto load_x = [&](int s, int q) {
    mbar_expect_tx(&full[s], C::XBYTES);
#pragma unroll
    for (int h = 0; h < C::KC / 64; ++h)
      tma_load_2d(ring + s * C::STAGE + h * C::XBOX, &tmx, &full[s], q * C::KC + 64 * h, tok0);
  };
  int px = 0, ix = 0;  // thread 0: the next stage whose x it loads
  if (tid == 0)
    for (int s = 0; s + 1 < S && px < sweeps; ++s, advance(px, ix)) load_x(s, chunk_of(ix));

  // warp w: block-row lr = w / SPR, output features f0 .. f0 + FS - 1 of
  // it.  Every lane walks the same runs.  The pending run: chunk rq,
  // sweep seg, first slot rs, block columns rb; a recorded row reads its
  // runs in order (cur: the next record), another walks its columns in
  // device memory
  const int lr = w / C::SPR, f0 = (w % C::SPR) * C::FS;
  int cur = 0, prevq = INT_MAX, seg = -1, rq = INT_MAX, rs = 0;
  unsigned rb = 0;
  unsigned tk[S];  // the block columns taken at each stage in flight
  auto next_of = [&]() {
    if (roff[lr] >= 0) {
      if (cur >= rnrun[lr]) {
        rq = INT_MAX;
        return;
      }
      const int2 rr = rrec[roff[lr] + cur++];
      rq = rr.x & 0xffff;
      seg = rr.x >> 16;
      rs = rr.y & 0xfffff;
      rb = (unsigned)rr.y >> 20;
    } else {
      rq = next_run<B, C::KC, C::E>(cols + rfirst[lr], rlen[lr], kb, cur, prevq, seg, rs, rb);
    }
  };
#pragma unroll
  for (int i = 0; i < S; ++i) tk[i] = 0;
  next_of();
  // take the row's run at stage (p, q) into the warp's part of stage slot
  // s (tk[S - 1]): copy its blocks' rows f0 .. f0 + FS - 1, 16 bytes a
  // lane at a time, in the swizzled layout
  auto take = [&](int p, int q, int s) {
    uint8_t* wb = ring + s * C::STAGE + C::XBYTES + w * C::WBUF;
    const bool took = rq == q && seg == p;
    tk[S - 1] = took ? rb : 0u;
    if (took) {
      const uint8_t* sv = reinterpret_cast<const uint8_t*>(
          values + ((size_t)(rfirst[lr] + rs) * B + f0) * B);
      int e = 0;
#pragma unroll
      for (int c = 0; c < C::E; ++c) {
        if ((rb >> c) & 1u) {
          const uint8_t* se = sv + (size_t)e * B * B * 2;
#pragma unroll
          for (int i = lane; i < C::SLAB / 16; i += 32) {
            const int r = i / (2 * B / 16), cc = i % (2 * B / 16);
            cp_async16(wb + c * C::SLAB + slab_at<C::SW, C::FS>(r, cc),
                       se + (size_t)r * B * 2 + 16 * cc);
          }
          ++e;
        }
      }
    }
    cp_async_commit();
    if (took) next_of();
  };
  // the bits of the stage taken last move one place down the queue
  auto shift = [&]() {
#pragma unroll
    for (int i = 0; i + 1 < S; ++i) tk[i] = tk[i + 1];
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int a = 0; a < C::MT; ++a)
#pragma unroll
    for (int t = 0; t < C::NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][t][e] = 0.f;

  // the blocks of the first S - 1 stages
  int pt = 0, itk = 0;  // the next stage to take
  for (int i = 0; i + 1 < S; ++i) {
    if (pt < sweeps) {
      take(pt, chunk_of(itk), i);
      advance(pt, itk);
    } else {
      tk[S - 1] = 0;
      cp_async_commit();
    }
    shift();
  }

  // ldmatrix rows: matrix jm = lane / 8, row lane % 8; A's matrices are
  // (tokens +0, columns +0), (+8, +0), (+0, +8), (+8, +8); B's (features
  // +0, columns +0), (+0, +8), (+8, +0), (+8, +8)
  const int jm = lane / 8, im = lane % 8;
  int pc = 0, ic = 0;  // the stage computed
  for (int it = 0; pc < sweeps; ++it) {
    const int s = it % S;
    // x's chunk S - 1 stages on, into the slot the stage before this one
    // left (thread 0)
    if (tid == 0 && px < sweeps) {
      if (it > 0) mbar_wait(&empty[(it - 1) % S], ((it - 1) / S) & 1);
      load_x((it + S - 1) % S, chunk_of(ix));
      advance(px, ix);
    }
    // the blocks S - 1 stages on
    if (pt < sweeps) {
      take(pt, chunk_of(itk), (it + S - 1) % S);
      advance(pt, itk);
    } else {
      tk[S - 1] = 0;
      cp_async_commit();
    }
    cp_async_wait<S - 1>();
    __syncwarp();  // every lane's copies are visible to the warp
    mbar_wait(&full[s], (it / S) & 1);
    const uint8_t* xs = ring + s * C::STAGE;
    const uint8_t* vb = xs + C::XBYTES + w * C::WBUF;
#pragma unroll
    for (int c = 0; c < C::E; ++c) {
      if (!((tk[0] >> c) & 1u)) continue;
      const uint8_t* vs = vb + c * C::SLAB;
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
          // chunk (128-byte rows, 128-byte swizzle, 64-column boxes)
          const int col = c * B + 16 * kk + 8 * (jm / 2);
          const int tr = 16 * a + im + 8 * (jm % 2);
          uint32_t af[4];
          ldmatrix_x4(af, xs + (col / 64) * C::XBOX + tr * 128 +
                              16 * (((col % 64) / 8) ^ (tr & 7)));
#pragma unroll
          for (int t2 = 0; t2 < C::NT / 2; ++t2) {
            Mma16816<T>::run(acc[a][2 * t2], af, bq[t2][0], bq[t2][1]);
            Mma16816<T>::run(acc[a][2 * t2 + 1], af, bq[t2][2], bq[t2][3]);
          }
        }
      }
    }
    shift();
    mbar_arrive(&empty[s]);
    advance(pc, ic);
  }

  // fragment: tokens 16 a + l / 4 (+ 8), features 8 t + 2 (l % 4) (+ 1)
  const int gq = lane / 4, tq = lane % 4;
  const int r = r0 + lr;
  if (r >= mb) return;
#pragma unroll
  for (int a = 0; a < C::MT; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = tok0 + 16 * a + gq + 8 * h;
      if (tok >= n) continue;
      T* out = y + (size_t)tok * m + (size_t)r * B + f0 + 2 * tq;
#pragma unroll
      for (int t = 0; t < C::NT; ++t)
        *reinterpret_cast<uint32_t*>(out + 8 * t) =
            pack2<T>(acc[a][t][2 * h], acc[a][t][2 * h + 1]);
    }
}

template <typename T, int B>
int launch_mma(const T* x, const T* values, const int* cols, const int* bounds, T* y, int n,
               int k, int m, cudaStream_t s) {
  using C = Mm<B>;
  CUtensorMap tmx;
  if (!make_map(&tmx, x, n, k, C::TOK, tma_type<T>())) return (int)cudaErrorInvalidValue;
  // set at every launch: the attribute is per device
  cudaFuncSetAttribute(dsmm_mma_kernel<T, B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  dim3 grid((m / B + C::R - 1) / C::R, (n + C::TOK - 1) / C::TOK);
  dsmm_mma_kernel<T, B><<<grid, kTcThreads, C::SMEM, s>>>(tmx, values, cols, bounds, y, n, k,
                                                          m);
  return (int)cudaGetLastError();
}

template <typename T>
int mma_b(const void* x, const void* values, const void* cols, const void* bounds, void* y,
          int n, int k, int m, int b, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* vt = static_cast<const T*>(values);
  const int* ct = static_cast<const int*>(cols);
  const int* bd = static_cast<const int*>(bounds);
  T* yt = static_cast<T*>(y);
  switch (b) {
    case 16: return launch_mma<T, 16>(xt, vt, ct, bd, yt, n, k, m, s);
    case 32: return launch_mma<T, 32>(xt, vt, ct, bd, yt, n, k, m, s);
    case 64: return launch_mma<T, 64>(xt, vt, ct, bd, yt, n, k, m, s);
    case 128: return launch_mma<T, 128>(xt, vt, ct, bd, yt, n, k, m, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

enum Walk { kMma = 0, kFfma = 1 };

template <typename T>
int dispatch(const void* x, const void* values, const void* rows, const void* cols,
             void* bounds, void* y, int n, int k, int m, int b, int s_cap, int walk,
             cudaStream_t s) {
  if (walk != kMma && walk != kFfma) return (int)cudaErrorInvalidValue;
  const int err = find_bounds(rows, bounds, m / b, s_cap, s);
  if (err != 0) return err;
  if (walk == kFfma) return ffma_b<T>(x, values, cols, bounds, y, n, k, m, b, s);
  if constexpr (sizeof(T) == 2) {
    return mma_b<T>(x, values, cols, bounds, y, n, k, m, b, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// walk 0 = mma (16-bit, b in {16, 32, 64, 128}, x and values 16-byte
// aligned), 1 = ffma (every dtype and block)
extern "C" int dsmm_nt(const void* x, const void* values, const void* rows,
                       const void* cols, void* bounds, void* y, int n, int k, int m,
                       int b, int s_cap, int dtype, int walk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(x, values, rows, cols, bounds, y, n, k, m, b, s_cap, walk, s);
    case 1:
      return dispatch<__nv_bfloat16>(x, values, rows, cols, bounds, y, n, k, m, b, s_cap,
                                     walk, s);
    case 2:
      return dispatch<__half>(x, values, rows, cols, bounds, y, n, k, m, b, s_cap, walk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
