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
// What bounds it: at the serving shapes the FLOPs, 4 per element pair and
// head dim (QK^T and PV).  This first version runs them in fp32 on the
// CUDA cores, staged through shared memory as fp32 (q tile, one k or v
// chunk, the p chunk), each thread owning 4 rows x 4 keys of the score
// chunk and the same 4 rows x dh/16 columns of the output accumulator;
// row max and sum reduce over the 16 lanes that share a row.  Tensor
// cores (wgmma) and TMA staging are later work.  Heaviest blocks (the last
// q rows under a causal mask) are launched first.
//
// Layouts: q [B, Sq, H, dh], k/v [B, Skv, KV, dh], o [B, Sq, H, dh], each
// with its own (batch, sequence, head) strides in elements and a
// contiguous head dim; kv head = h / (H / KV) (GQA, read in place).
// dh in {32, 64, 128, 256}; dtype 0 = fp32, 1 = bf16, 2 = fp16.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
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
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t bytes = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(bs_attn_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.n_blocks, batch * p.heads);
  bs_attn_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(const Params& p, int batch, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    case 256: return launch<T, 256>(p, batch, stream);
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
                           int dtype, void* stream) {
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
    case 0: return dispatch_dh<float>(p, batch, dh, s);
    case 1: return dispatch_dh<__nv_bfloat16>(p, batch, dh, s);
    case 2: return dispatch_dh<__half>(p, batch, dh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
