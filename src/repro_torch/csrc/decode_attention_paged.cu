// Paged decode / verify attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `decode_attention_paged` in
// src/repro/kernels/decode_attention.py (the `_kernel` body reached through
// `_paged_kernel`): a small query window (the K+1 verify window, the 2K PARD
// draft window, or a prompt chunk) attends to a block-paged KV pool through
// per-row block tables.
//
//   q       [B, Tq, Hq, D]     float32 or bfloat16
//   k, v    [NB, bs, Hkv, D]   float32 or bfloat16 pools
//   tables  [B, MBS] int32     pool block of each row's logical block
//   kv_len  [B] int32          valid cache entries of each row
//   q_pos   [B, Tq] int32      absolute position of each query
//   out     [B, Tq, Hq, D]     q's dtype
//
// Key position p is visible to query (b, i) iff p < kv_len[b],
// p <= q_pos[b, i] and, with a window, p > q_pos[b, i] - window. The scores
// take `scale`, then the optional softcap tanh(s / cap) * cap, then an f32
// online softmax. A query that sees no key returns 0.
//
// What bounds it on an H100: the bytes of K/V it streams. Per row the
// useful work is 2 * (Tq * G) * D multiply-adds per key against 2 * D
// values read, so at Tq * G <= 64 rows the kernel is far below the card's
// operations-per-byte balance point. The design therefore reads every K/V
// byte once: one thread block per (kv head, batch row, tile of 64 query
// rows) holds all Tq * G query rows that share the kv head (the GQA group)
// in shared memory while the row's keys stream through in chunks of 64,
// each staged into shared memory with 16-byte loads and converted to f32
// once. The sweep stops at the last key any query of the tile can see, so
// bytes follow each row's real fill, not the pool size, and blocks past
// kv_len (or before the window) are never read. Arithmetic is f32 FMA on
// the CUDA cores; tensor cores, split-KV for small B * Hkv, TMA and wgmma
// are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;   // query rows (i, g) per thread block
constexpr int kKeys = 64;   // keys staged per chunk (two per lane)
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr float kNegInf = -1e30f;

// 16-byte vector loads converted to f32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* o) {
    float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
  __device__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(h[e]);
      o[2 * e] = f.x;
      o[2 * e + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // q tile, K chunk (rows padded by one float against bank conflicts),
  // V chunk, probabilities, per-row query positions
  return sizeof(float) * (kRows * D + kKeys * (D + 1) + kKeys * D + kRows * kKeys)
         + sizeof(int) * kRows;
}

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                    const KT* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ kv_len, const int* __restrict__ q_pos,
                    QT* __restrict__ out, int tq, int hq, int hkv, int nb, int bs,
                    int mbs, float scale, int window, float softcap) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int DC = D / 32;  // output columns per lane
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int g = hq / hkv;
  const int rows = tq * g;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;                      // [kRows][D]
  float* ks = qs + kRows * D;            // [kKeys][D + 1]
  float* vs = ks + kKeys * (D + 1);      // [kKeys][D]
  float* ps = vs + kKeys * D;            // [kRows][kKeys]
  int* qp_s = reinterpret_cast<int*>(ps + kRows * kKeys);  // [kRows]

  // stage the tile's query rows; row r = (i, gg) reads q[b, i, h*g + gg]
  constexpr int QV = Vec<QT>::N;
  for (int idx = tid; idx < kRows * (D / QV); idx += kThreads) {
    const int r = idx / (D / QV);
    const int c = (idx % (D / QV)) * QV;
    const int row = r0 + r;
    float t[QV];
    if (row < rows) {
      const int i = row / g, gg = row % g;
      Vec<QT>::load(q + ((static_cast<size_t>(b) * tq + i) * hq + h * g + gg) * D + c, t);
    } else {
#pragma unroll
      for (int e = 0; e < QV; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < QV; ++e) qs[r * D + c + e] = t[e];
  }
  // rows past the tile's end see nothing (q_pos -1 masks every key)
  for (int r = tid; r < kRows; r += kThreads) {
    const int row = r0 + r;
    qp_s[r] = row < rows ? q_pos[b * tq + row / g] : -1;
  }
  __syncthreads();

  // the tile's key range: from the earliest key any of its queries can see
  // to the last one, capped by kv_len and the table's reach
  int qmin = 0x7fffffff, qmax = -1;
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r < rows) {
      qmin = min(qmin, qp_s[r]);
      qmax = max(qmax, qp_s[r]);
    }
  }
  const int hi = min(min(kv_len[b], mbs * bs), qmax + 1);
  const int start = window > 0 ? max(0, qmin - window + 1) : 0;

  float acc[kRowsPerWarp][DC];
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  constexpr int KV = Vec<KT>::N;
  for (int c0 = start; c0 < hi; c0 += kKeys) {
    // stage keys c0 .. c0 + kKeys - 1 through the block table
    for (int idx = tid; idx < kKeys * (D / KV); idx += kThreads) {
      const int j = idx / (D / KV);
      const int c = (idx % (D / KV)) * KV;
      const int p = c0 + j;
      float kt[KV], vt[KV];
      if (p < hi) {
        int blk = tables[b * mbs + p / bs];
        blk = min(max(blk, 0), nb - 1);
        const size_t off = ((static_cast<size_t>(blk) * bs + p % bs) * hkv + h) * D + c;
        Vec<KT>::load(kp + off, kt);
        Vec<KT>::load(vp + off, vt);
      } else {
#pragma unroll
        for (int e = 0; e < KV; ++e) kt[e] = vt[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < KV; ++e) {
        ks[j * (D + 1) + c + e] = kt[e];
        vs[j * D + c + e] = vt[e];
      }
    }
    __syncthreads();

    // scores: warp w owns rows w, w + 8, ...; lane owns keys lane, lane + 32
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0 = ks[lane * (D + 1) + d];
      const float k1 = ks[(lane + 32) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float qv = qs[(warp + kWarps * i) * D + d];
        s[i][0] = fmaf(qv, k0, s[i][0]);
        s[i][1] = fmaf(qv, k1, s[i][1]);
      }
    }

    // mask + online softmax; the same warp then owns these rows' P @ V
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      const int qp = qp_s[r];
      float x[2];
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = c0 + lane + 32 * e;
        float v = s[i][e] * scale;
        if (softcap > 0.f) v = tanhf(v / softcap) * softcap;
        ok[e] = p < hi && p <= qp && (window <= 0 || p > qp - window);
        x[e] = ok[e] ? v : kNegInf;
      }
      const float m_new = fmaxf(m_run[i], warp_max(fmaxf(x[0], x[1])));
      const float p0 = ok[0] ? expf(x[0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(x[1] - m_new) : 0.f;
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + warp_sum(p0 + p1);
      m_run[i] = m_new;
      ps[r * kKeys + lane] = p0;
      ps[r * kKeys + lane + 32] = p1;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();

    // acc[row][d] += sum_j P[row][j] * V[j][d]; lane owns d = lane + 32 c
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[j * D + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pp = ps[(warp + kWarps * i) * kKeys + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pp, vv[c], acc[i][c]);
      }
    }
    __syncthreads();  // the next chunk overwrites ks / vs / ps
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = r0 + warp + kWarps * i;
    if (row >= rows) continue;
    const int qi = row / g, gg = row % g;
    const float inv = 1.f / (l_run[i] == 0.f ? 1.f : l_run[i]);
    QT* dst = out + ((static_cast<size_t>(b) * tq + qi) * hq + h * g + gg) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) Vec<QT>::store(dst + lane + 32 * c, acc[i][c] * inv);
  }
}

template <typename QT, typename KT, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* kv_len, const int* q_pos, void* out, int b, int tq,
                   int hq, int hkv, int nb, int bs, int mbs, float scale, int window,
                   float softcap, cudaStream_t stream) {
  auto kern = paged_decode_kernel<QT, KT, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = tq * (hq / hkv);
  dim3 grid(hkv, b, (rows + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      tables, kv_len, q_pos, static_cast<QT*>(out), tq, hq, hkv, nb, bs, mbs, scale,
      window, softcap);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     const int* tables, const int* kv_len, const int* q_pos, void* out,
                     int b, int tq, int hq, int hkv, int nb, int bs, int mbs,
                     float scale, int window, float softcap, cudaStream_t stream) {
  if (d == 32)
    return launch<QT, KT, 32>(q, k, v, tables, kv_len, q_pos, out, b, tq, hq, hkv, nb,
                              bs, mbs, scale, window, softcap, stream);
  if (d == 64)
    return launch<QT, KT, 64>(q, k, v, tables, kv_len, q_pos, out, b, tq, hq, hkv, nb,
                              bs, mbs, scale, window, softcap, stream);
  if (d == 128)
    return launch<QT, KT, 128>(q, k, v, tables, kv_len, q_pos, out, b, tq, hq, hkv, nb,
                               bs, mbs, scale, window, softcap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = ok).
extern "C" int decode_attention_paged(const void* q, const void* k, const void* v,
                                      const void* tables, const void* kv_len,
                                      const void* q_pos, void* out, int b, int tq,
                                      int hq, int hkv, int d, int nb, int bs, int mbs,
                                      int q_dtype, int kv_dtype, float scale,
                                      int window, float softcap, void* stream) {
  if (b <= 0 || tq <= 0 || hkv <= 0 || hq % hkv != 0 || nb <= 0 || bs <= 0 || mbs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* t = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_len);
  const int* qp = static_cast<const int*>(q_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch_d<float, float>(d, q, k, v, t, kl, qp, out, b, tq, hq, hkv, nb, bs, mbs,
                                 scale, window, softcap, s);
  else if (q_dtype == 0 && kv_dtype == 1)
    err = launch_d<float, __nv_bfloat16>(d, q, k, v, t, kl, qp, out, b, tq, hq, hkv, nb,
                                         bs, mbs, scale, window, softcap, s);
  else if (q_dtype == 1 && kv_dtype == 0)
    err = launch_d<__nv_bfloat16, float>(d, q, k, v, t, kl, qp, out, b, tq, hq, hkv, nb,
                                         bs, mbs, scale, window, softcap, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = launch_d<__nv_bfloat16, __nv_bfloat16>(d, q, k, v, t, kl, qp, out, b, tq, hq,
                                                 hkv, nb, bs, mbs, scale, window, softcap,
                                                 s);
  return static_cast<int>(err);
}
