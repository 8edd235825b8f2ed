// Block-sparse flash attention for Hopper (forward):
//
//     o[b, r, h, :] = softmax_c(mask(r, c) ? cap(q[b, r, h] . k[b, c, h/rep] * scale)
//                                          : -1e30) . v[b, c, h/rep]
//
// Replaces the TPU kernel src/repro/kernels/bs_attn/bs_attn.py
// `bs_attn_call` (`_bs_attn_kernel`).  The visible (q_tile, kv_tile) pairs
// come from the host block mask (`mask_to_pairs`, row-sorted) as a CSR:
// row_ptr[w] .. row_ptr[w + 1] index the kv tiles of walk row w.  On top of
// the tile mask the kernel applies the element mask of the JAX package's
// tile walk (`models/attention.py` `_attend_scheduled`): causal `r >= c`,
// and with window > 0 also `(r - c < window) | (c < global_prefix)`.
// cap(x) = softcap * tanh(x / softcap) when softcap > 0 (Gemma 2).
//
// The TPU walked the pairs as one serial grid and flushed a VMEM
// accumulator when the q tile changed.  Hopper's blocks run in parallel,
// so here one thread block owns QT = 64 query rows of one (batch, head)
// and loops over its row's pairs itself:
//   * bq >= 64 (or a single q tile): a q tile is split into ceil(bq / 64)
//     blocks of at most 64 rows, each walking the tile's pairs;
//   * bq < 64 with several q tiles (the tile halving of `attend_train`
//     gives bq down to 1): a block takes group = 64 / bq whole q tiles and
//     walks the union of their pairs (the host passes that union's CSR);
//     the dense tile mask [nq, nkv] then decides per element whether the
//     element's own (q tile, kv tile) pair is visible.
// Runs of consecutive kv tiles are merged and walked in chunks of
// KT = 64 keys whatever bkv is, so the inner tile is the kernel's own.
// A chunk that is fully masked for the block's rows is skipped: under the
// causal mask the walk stops at the first chunk past the block's last
// row (pairs ascend), and chunks wholly before the window are skipped.
//
// Numerics follow the reference walk: logits, m and l in fp32; masked
// logits are the finite -1e30 (a row whose first chunk is fully masked
// holds p = 1 there until its first visible key, whose alpha =
// exp(-1e30 - m) = 0 wipes it -- no NaN); padding keys of a short chunk
// are -inf (p = 0 exactly); p is rounded to v's dtype before the PV
// product, l sums the unrounded p; out = acc / max(l, 1e-30).  Every row
// must see at least one key (the causal diagonal), as in the reference.
//
// The card's bound at the serving shapes is the FLOPs, 4 per element pair
// and head dim (QK^T and PV).  The wrapper (ops.py `kernel_walk`) picks
// one of two walks by dtype:
//
// 1. "wgmma" (bf16/fp16): a flash-attention forward on the tensor cores.
//    A block is one consumer warpgroup (the 64 query rows) and one
//    producer warp.  The producer loads the q tile once and each 64-key
//    chunk of k and v through a 2-stage TMA ring on mbarriers (4-D tensor
//    maps over the strided [B, S, heads, dh] views, ordered (dh, S, heads,
//    B) so a box is a 2-D tile; kv head h / (H / KV), so the fused
//    projection's q/k/v and GQA are read in place; the head dim in
//    64-column sub-tiles with the 128-byte swizzle, 32 columns with the
//    64-byte swizzle at dh 32; keys past Skv filled with zeros).  The
//    consumers run S = Q.K^T as wgmma m64n64k16 with both operands from
//    shared memory (K-major: dh contiguous in q and k), then the online
//    softmax on the fp32 accumulator fragments in registers (each thread
//    holds 2 rows x 16 keys; row max and sum over the 4 lanes that share
//    a row; base-2 exponent on the SFU with log2(e) folded into the
//    scale), then O += P.V as wgmma m64n{dh}k16 with P rounded to v's
//    dtype and fed from registers as the A operand (the S fragment's
//    pairs are already in the A fragment's order) and V from shared
//    memory as an MN-major operand read with the transpose bit.  The
//    output stays in registers (dh / 2 fp32 a thread) and is written once.
//    Element masks cost only where a chunk needs them: a chunk that every
//    row of the block sees whole (below the diagonal, inside the window,
//    no padding, all its tile pairs in the mask) skips them, and the
//    wrapper drops the tile mask where the element mask implies it.
//    What bounds it at the served shapes: not the tensor cores (QK^T and
//    PV are ~15 % of a chunk's cycles) but the softmax between them, a
//    latency-bound chain of ~300 instructions a thread with one consumer
//    warp per scheduler (three blocks an SM at dh <= 64, two at 128, one
//    at 192 and 256).  Overlapping the softmax with the next chunk's products
//    (issuing PV of chunk i - 1 behind QK^T of chunk i) measured slower,
//    with 2 or 3 ring stages, and is not used.
// 2. "cuda_core" (fp32, where TF32 would miss the fp32 budget; 16-bit
//    when the caller names it): the arithmetic in fp32 on the CUDA
//    cores, staged through shared memory as fp32 (q tile, one k or v
//    chunk, the p chunk), each thread owning 4 rows x 4 keys of the score
//    chunk and the same 4 rows x dh/16 columns of the output accumulator;
//    row max and sum reduce over the 16 lanes that share a row.
//
// Both walks keep the rules above: the CSR of pairs, group walks with the
// per-element tile-mask lookup, 64-key chunks, the causal stop, the
// window skip, the soft-cap before the mask, and heaviest blocks (the last
// q rows under a causal mask) launched first.
//
// Layouts: q [B, Sq, H, dh], k/v [B, Skv, KV, dh], o [B, Sq, H, dh], each
// with its own (batch, sequence, head) strides in elements and a
// contiguous head dim; kv head = h / (H / KV) (GQA, read in place).
// dh in {32, 64, 128, 192, 256}; dtype 0 = fp32, 1 = bf16, 2 = fp16.
// dh 192 is MLA's q.k head (DeepSeek-V2: 128 nope + 64 rope), with v
// zero-padded from 128 by the caller: three 64-column sub-tiles, a
// 24 KiB [64, 192] tile (~121 KiB of shared memory at 2 stages) and an
// m64n192 output accumulator of 96 fp32 registers a thread.
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;  // 16 x 16: ty owns rows ty + 16 i, tx keys tx + 16 j
constexpr int QT = 64;         // query rows per thread block
constexpr int KT = 64;         // keys per chunk
constexpr int PLD = KT + 1;    // row stride of the p chunk (distinct banks)
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* row_ptr;
  const int* cols;
  const unsigned char* tile_mask;  // [nq, nkv] when group > 1, else null
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int heads, kv_heads, sq, skv, nkv, bq, bkv, group, n_blocks;
  float scale, softcap;
  int causal, window, global_prefix;
};

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)QT * (DH + 1) + (size_t)KT * (DH + 1) + (size_t)QT * PLD);
}

// rows [first, first + n) of a strided [rows, DH] operand into dst[cap][DH + 1]
// as fp32, 16-byte loads; rows n..cap-1 are zero
template <typename T, int DH>
__device__ __forceinline__ void stage(float* __restrict__ dst, const T* __restrict__ src,
                                      long long stride, int first, int n, int cap) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = DH / VEC;
  for (int e = threadIdx.x; e < cap * PER_ROW; e += kThreads) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
    float* d = dst + r * (DH + 1) + c;
    if (r < n) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + (first + r) * stride + c));
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = to_f<T>(vals[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = 0.f;
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) bs_attn_kernel(Params p) {
  constexpr int LD = DH + 1;       // row stride of the q and kv tiles (distinct banks)
  constexpr int DJ = DH / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                // [QT][LD]
  float* kvs = qs + QT * LD;       // [KT][LD], k then v of the current chunk
  float* ps = kvs + KT * LD;       // [QT][PLD]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int kvh = h / (p.heads / p.kv_heads);
  const int blk = p.n_blocks - 1 - (int)blockIdx.x;  // heaviest first
  int w, ra, rb;                   // walk row and query rows [ra, rb)
  if (p.group > 1) {
    w = blk;
    ra = blk * p.group * p.bq;
    rb = min(ra + p.group * p.bq, p.sq);
  } else {
    const int subs = (p.bq + QT - 1) / QT;
    w = blk / subs;
    ra = w * p.bq + (blk % subs) * QT;
    rb = min(ra + QT, (w + 1) * p.bq);
  }
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  stage<T, DH>(qs, qg, p.q_ss, ra, rb - ra, QT);

  float m_i[4], l_i[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }

  const int pend = p.row_ptr[w + 1];
  bool done = false;
  for (int pi = p.row_ptr[w]; pi < pend && !done;) {
    // one run of consecutive kv tiles [j0, j1] -> keys [c_lo, c_hi)
    const int j0 = p.cols[pi];
    int j1 = j0;
    while (++pi < pend && p.cols[pi] == j1 + 1) ++j1;
    const int c_lo = j0 * p.bkv, c_hi = min((j1 + 1) * p.bkv, p.skv);
    for (int c0 = c_lo; c0 < c_hi; c0 += KT) {
      const int c1 = min(c0 + KT, c_hi);
      if (p.causal && c0 >= rb) {  // every later key is past every row
        done = true;
        break;
      }
      if (p.window > 0 && ra - (c1 - 1) >= p.window && c0 >= p.global_prefix) continue;

      __syncthreads();  // the previous chunk's reads of kvs and ps are done
      stage<T, DH>(kvs, kg, p.k_ss, c0, c1 - c0, KT);
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = kvs[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ra + ty + 16 * i;
        float rmax = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 16 * j;
          float x;
          if (r >= rb || c >= c1) {
            x = -INFINITY;  // padding: exactly no weight
          } else {
            x = s[i][j] * p.scale;
            if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
            bool vis = true;
            if (p.causal) vis = r >= c;
            if (p.window > 0) vis = vis && (r - c < p.window || c < p.global_prefix);
            if (p.tile_mask != nullptr)
              vis = vis && p.tile_mask[(long long)(r / p.bq) * p.nkv + c / p.bkv];
            if (!vis) x = kNegInf;
          }
          s[i][j] = x;
          rmax = fmaxf(rmax, x);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
        const float m_new = fmaxf(m_i[i], rmax);
        const float alpha = expf(m_i[i] - m_new);
        float rsum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pv = expf(s[i][j] - m_new);
          rsum += pv;
          ps[(ty + 16 * i) * PLD + tx + 16 * j] = to_f<T>(from_f<T>(pv));
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
        l_i[i] = l_i[i] * alpha + rsum;
        m_i[i] = m_new;
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd) acc[i][jd] *= alpha;
      }

      __syncthreads();  // every thread is done with k
      stage<T, DH>(kvs, vg, p.v_ss, c0, c1 - c0, KT);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < KT; ++c) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PLD + c];
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd) {
          const float vv = kvs[c * LD + tx + 16 * jd];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
        }
      }
    }
  }

  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ra + ty + 16 * i;
    if (r >= rb) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd)
      og[r * p.o_ss + tx + 16 * jd] = from_f<T>(acc[i][jd] / denom);
  }
}

template <typename T, int DH>
int launch_cc(const Params& p, int batch, cudaStream_t stream) {
  const size_t bytes = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(bs_attn_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.n_blocks, batch * p.heads);
  bs_attn_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// walk 1: TMA + wgmma (16-bit)
// ---------------------------------------------------------------------------

constexpr int kTcStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH> struct TcAttn {
  static constexpr int SW = DH >= 64 ? 128 : 64;  // swizzle = bytes of a sub-tile row
  static constexpr int CW = SW / 2;               // head-dim columns of a sub-tile
  static constexpr int NSUB = DH / CW;            // sub-tiles across the head dim
  static constexpr int kSub = 64 * SW;            // bytes of a [64 rows, CW] sub-tile
  static constexpr int kTile = NSUB * kSub;       // bytes of a [64 rows, DH] tile
  static constexpr int kThreads = 128 + 32;       // consumer warpgroup + producer warp
  static constexpr int kSmem = kTile * (1 + 2 * kTcStages) + 1024;  // + alignment slack
  // blocks an SM holds: small head dims leave room for three (registers
  // capped to fit), which hides the softmax's latency behind other warps
  static constexpr int kMinBlocks = DH <= 64 ? 3 : 1;
};

// 2^x on the special-function unit (p and alpha: results below 2^-126
// flush to zero, which the fp32 sums cannot see)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) = 1 - 2 / (1 + e^(2y)): exact at the limits (e^(2y) = inf
// gives 1), a few instructions where tanhf takes a long dependent chain
__device__ __forceinline__ float tanh_fast(float y) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * y));
}

// The chunk's logits in the base-2 domain (log2(e) folded into the scale,
// so p = 2^(z - m)): scaled, soft-capped, and, where kMask, padding keys
// and rows at -inf and invisible elements at the finite -1e30.  Thread
// fragment element j = 4 c + 2 h + e is row r0 + 8 h, key k0 + 8 c + e.
struct Logit {
  float mul, cap, cap_div;  // z = mul * s, or cap * tanh(cap_div * s)
  int causal, window, global_prefix, bq, bkv, nkv, rb, c1;
  const unsigned char* tile_mask;
};

template <bool kMask, bool kCap>
__device__ __forceinline__ void logits(float* sc, const Logit& L, int r0, int k0) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int r = r0 + 8 * ((j / 2) % 2), key = k0 + 8 * (j / 4) + j % 2;
    float z = kCap ? L.cap * tanh_fast(L.cap_div * sc[j]) : L.mul * sc[j];
    if (kMask) {
      bool vis = (!L.causal || r >= key) &&
                 (L.window <= 0 || r - key < L.window || key < L.global_prefix);
      if (L.tile_mask != nullptr && r < L.rb && key < L.c1)
        vis = vis && L.tile_mask[(long long)(r / L.bq) * L.nkv + key / L.bkv];
      z = (r >= L.rb || key >= L.c1) ? -INFINITY : (vis ? z : kNegInf);
    }
    sc[j] = z;
  }
}

// The walk row's 64-key chunks [c0, c1), in order, with the causal stop
// and the window skip; the producer and the consumers walk the same list.
template <typename F>
__device__ __forceinline__ void for_each_chunk(const Params& p, int w, int ra, int rb, F&& f) {
  const int pend = p.row_ptr[w + 1];
  for (int pi = p.row_ptr[w]; pi < pend;) {
    const int j0 = p.cols[pi];
    int j1 = j0;
    while (++pi < pend && p.cols[pi] == j1 + 1) ++j1;
    const int c_lo = j0 * p.bkv, c_hi = min((j1 + 1) * p.bkv, p.skv);
    for (int c0 = c_lo; c0 < c_hi; c0 += KT) {
      const int c1 = min(c0 + KT, c_hi);
      if (p.causal && c0 >= rb) return;  // every later key is past every row
      if (p.window > 0 && ra - (c1 - 1) >= p.window && c0 >= p.global_prefix) continue;
      f(c0, c1);
    }
  }
}

// 64 rows from `row` of one head of a (dh, S, heads, B) map, as NSUB
// sub-tiles
template <int DH>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int head, int row, int b) {
  using A = TcAttn<DH>;
#pragma unroll
  for (int j = 0; j < A::NSUB; ++j) tma_load_4d(dst + j * A::kSub, map, bar, j * A::CW, row, head, b);
}

template <typename T, int DH>
__global__ void __launch_bounds__(TcAttn<DH>::kThreads, TcAttn<DH>::kMinBlocks)
    bs_attn_tc_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, const Params p) {
  using A = TcAttn<DH>;
  constexpr int SW = A::SW;
  constexpr int R = DH / 2;  // fp32 registers of the m64n{DH} output accumulator
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t qbar, kfull[kTcStages], vfull[kTcStages], empty[kTcStages];
  // swizzle atoms are up to 1024 bytes: align the tiles to them
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + A::kTile;               // [stage] k chunks
  uint8_t* vs = ks + kTcStages * A::kTile;   // [stage] v chunks

  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int kvh = h / (p.heads / p.kv_heads);
  const int blk = p.n_blocks - 1 - (int)blockIdx.x;  // heaviest first
  int w, ra, rb;                   // walk row and query rows [ra, rb)
  if (p.group > 1) {
    w = blk;
    ra = blk * p.group * p.bq;
    rb = min(ra + p.group * p.bq, p.sq);
  } else {
    const int subs = (p.bq + QT - 1) / QT;
    w = blk / subs;
    ra = w * p.bq + (blk % subs) * QT;
    rb = min(ra + QT, (w + 1) * p.bq);
  }

  if (threadIdx.x == 0) {
    mbar_init(&qbar, 1);
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp: one thread issues every copy
    if (threadIdx.x == 128) {
      mbar_expect_tx(&qbar, A::kTile);
      load_rows<DH>(qs, &tmq, &qbar, h, ra, b);
      int i = 0;
      for_each_chunk(p, w, ra, rb, [&](int c0, int) {
        const int s = i % kTcStages;
        mbar_wait(&empty[s], ((i / kTcStages) & 1) ^ 1);
        mbar_expect_tx(&kfull[s], A::kTile);
        load_rows<DH>(ks + s * A::kTile, &tmk, &kfull[s], kvh, c0, b);
        mbar_expect_tx(&vfull[s], A::kTile);
        load_rows<DH>(vs + s * A::kTile, &tmv, &vfull[s], kvh, c0, b);
        ++i;
      });
    }
    return;
  }

  // consumer warpgroup.  Accumulator fragment of thread t: rows
  // 16 (t / 32) + (t % 32) / 4 (+ 8 for h = 1), columns 8 c + 2 (t % 4)
  // (+ 1): register 4 c + 2 h (+ 1).
  const int t = threadIdx.x;
  const int rloc = (t / 32) * 16 + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  float o[R];
#pragma unroll
  for (int j = 0; j < R; ++j) o[j] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};  // l: this thread's keys
  Logit L;
  L.cap = p.softcap > 0.f ? p.softcap * kLog2e : 0.f;
  L.cap_div = p.softcap > 0.f ? p.scale / p.softcap : 0.f;
  L.mul = p.scale * kLog2e;
  L.causal = p.causal, L.window = p.window, L.global_prefix = p.global_prefix;
  L.bq = p.bq, L.bkv = p.bkv, L.nkv = p.nkv, L.rb = rb, L.tile_mask = p.tile_mask;
  const int lane = t % 32;

  mbar_wait(&qbar, 0);
  int i = 0;
  for_each_chunk(p, w, ra, rb, [&](int c0, int c1) {
    const int s = i % kTcStages;
    const uint32_t ph = (i / kTcStages) & 1;
    const uint8_t* kt = ks + s * A::kTile;
    const uint8_t* vt = vs + s * A::kTile;
    ++i;

    // S = Q . K^T: both K-major; a k16 step is 32 bytes along a row,
    // stepping to the next sub-tile every CW columns
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    mbar_wait(&kfull[s], ph);
    pin<32>(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int off = (kk * 16 / A::CW) * A::kSub + (kk * 16 % A::CW) * 2;
      WgmmaSS<64, T>::template run<0>(sc, smem_desc(qs + off, 16, 8 * SW, SW),
                                      smem_desc(kt + off, 16, 8 * SW, SW), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin<32>(sc);

    // Chunk-level visibility: a chunk every element of which this block's
    // rows see (no padding, under the diagonal, inside the window, every
    // (q tile, kv tile) pair of it in the mask) takes the unmasked path;
    // the diagonal, window-edge and padded chunks take the masked one.
    bool full = c1 - c0 == KT && rb - ra == QT && (!p.causal || c1 - 1 <= ra) &&
                (p.window <= 0 || rb - 1 - c0 < p.window);
    if (full && p.tile_mask != nullptr) {
      const int q0 = ra / p.bq, nqt = (rb - 1) / p.bq - q0 + 1;
      const int j0 = c0 / p.bkv, njt = (c1 - 1) / p.bkv - j0 + 1;
      bool ok = nqt * njt <= 32;
      if (ok && lane < nqt * njt)
        ok = p.tile_mask[(long long)(q0 + lane / njt) * p.nkv + j0 + lane % njt] != 0;
      full = __all_sync(0xffffffffu, ok);
    }
    L.c1 = c1;
    const int r0 = ra + rloc, k0 = c0 + cq;
    if (L.cap > 0.f) {
      if (full) logits<false, true>(sc, L, r0, k0);
      else logits<true, true>(sc, L, r0, k0);
    } else {
      if (full) logits<false, false>(sc, L, r0, k0);
      else logits<true, false>(sc, L, r0, k0);
    }

    // online softmax on the fragments, row by row (the 4 lanes of a quad
    // share a row)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        mx[0] = fmaxf(mx[0], sc[4 * c + 2 * hh]);
        mx[1] = fmaxf(mx[1], sc[4 * c + 2 * hh + 1]);
      }
      float rmax = fmaxf(mx[0], mx[1]);
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m_i[hh], rmax);
      const float alpha = ex2(m_i[hh] - m_new);
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = ex2(sc[4 * c + 2 * hh + e] - m_new);
          sum[e] += pv;
          sc[4 * c + 2 * hh + e] = pv;
        }
      }
      l_i[hh] = l_i[hh] * alpha + (sum[0] + sum[1]);
      m_i[hh] = m_new;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        o[4 * c + 2 * hh] *= alpha;
        o[4 * c + 2 * hh + 1] *= alpha;
      }
    }

    // P in v's dtype as the A operand: k16 step kk takes keys 16 kk ..
    // + 15, i.e. accumulator column groups 2 kk and 2 kk + 1 (the S
    // fragment's pairs are already in the A fragment's order)
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack2<T>(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
    }

    // O += P . V: V MN-major (dh contiguous), transpose bit set; a k16
    // step is 16 rows, dh sub-tiles kSub apart
    mbar_wait(&vfull[s], ph);
    pin<R>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<DH, T>::template run<1>(o, pa[kk], smem_desc(vt + kk * 16 * SW, A::kSub, 8 * SW, SW),
                                      1);
    wgmma_commit();
    wgmma_wait<0>();
    pin<R>(o);
    mbar_arrive(&empty[s]);
  });

  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_i[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = ra + rloc + 8 * hh;
    if (r >= rb) continue;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      *reinterpret_cast<uint32_t*>(og + r * p.o_ss + 8 * c + cq) =
          pack2<T>(o[4 * c + 2 * hh] / denom, o[4 * c + 2 * hh + 1] / denom);
  }
}

// 4-D map over a [batch, seq, heads, dh] view with element strides sb, ss,
// sh (dh contiguous), ordered (dh, seq, heads, batch) whatever the strides,
// so a box of 64 rows x CW columns of one head is a 2-D tile
template <int DH>
bool attn_map(CUtensorMap* map, CUtensorMapDataType ty, const void* base, int batch, int seq,
              int heads, long long sb, long long ss, long long sh) {
  using A = TcAttn<DH>;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  // a batch of one: any stride past the others does
  const cuuint64_t last = (cuuint64_t)(ss * seq > sh * heads ? ss * seq : sh * heads) * 2;
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 batch > 1 ? (cuuint64_t)sb * 2 : last};
  const cuuint32_t box[4] = {(cuuint32_t)A::CW, 64, 1, 1};
  return encode_map(map, ty, 4, base, dims, strides, box, A::SW);
}

template <typename T, int DH>
int launch_tc(const Params& p, int batch, cudaStream_t stream) {
  using A = TcAttn<DH>;
  const CUtensorMapDataType ty = tma_type<T>();
  CUtensorMap tq, tk, tv;
  if (!attn_map<DH>(&tq, ty, p.q, batch, p.sq, p.heads, p.q_sb, p.q_ss, p.q_sh) ||
      !attn_map<DH>(&tk, ty, p.k, batch, p.skv, p.kv_heads, p.k_sb, p.k_ss, p.k_sh) ||
      !attn_map<DH>(&tv, ty, p.v, batch, p.skv, p.kv_heads, p.v_sb, p.v_ss, p.v_sh))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bs_attn_tc_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, A::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.n_blocks, batch * p.heads);
  bs_attn_tc_kernel<T, DH><<<grid, A::kThreads, A::kSmem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

enum Walk { kCudaCore = 0, kWgmma = 1 };

template <typename T>
int dispatch_dh(const Params& p, int batch, int dh, int walk, cudaStream_t stream) {
  if (walk == kWgmma) {
    if constexpr (sizeof(T) == 2) {
      switch (dh) {
        case 32: return launch_tc<T, 32>(p, batch, stream);
        case 64: return launch_tc<T, 64>(p, batch, stream);
        case 128: return launch_tc<T, 128>(p, batch, stream);
        case 192: return launch_tc<T, 192>(p, batch, stream);
        case 256: return launch_tc<T, 256>(p, batch, stream);
        default: return (int)cudaErrorInvalidValue;
      }
    }
    return (int)cudaErrorInvalidValue;
  }
  if (walk != kCudaCore) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return launch_cc<T, 32>(p, batch, stream);
    case 64: return launch_cc<T, 64>(p, batch, stream);
    case 128: return launch_cc<T, 128>(p, batch, stream);
    case 192: return launch_cc<T, 192>(p, batch, stream);
    case 256: return launch_cc<T, 256>(p, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int bs_attn_fwd(const void* q, const void* k, const void* v, void* o,
                           const void* row_ptr, const void* cols, const void* tile_mask,
                           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                           long long v_sh, long long o_sb, long long o_ss, long long o_sh,
                           int batch, int heads, int kv_heads, int sq, int skv, int dh,
                           int nkv, int bq, int bkv, int group, int n_blocks, float scale,
                           float softcap, int causal, int window, int global_prefix,
                           int walk, int dtype, void* stream) {
  if (n_blocks <= 0 || batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.row_ptr = static_cast<const int*>(row_ptr);
  p.cols = static_cast<const int*>(cols);
  p.tile_mask = static_cast<const unsigned char*>(tile_mask);
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.sq = sq;
  p.skv = skv;
  p.nkv = nkv;
  p.bq = bq;
  p.bkv = bkv;
  p.group = group;
  p.n_blocks = n_blocks;
  p.scale = scale;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  p.global_prefix = global_prefix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dh<float>(p, batch, dh, walk, s);
    case 1: return dispatch_dh<__nv_bfloat16>(p, batch, dh, walk, s);
    case 2: return dispatch_dh<__half>(p, batch, dh, walk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
