// Shared online-softmax tile loop of the port's decode / verify attention
// kernels for Hopper (sm_90a). Four kernels are instances of it:
//
//   decode_attention_paged.cu  causal mask, block-paged pool
//   decode_attention.cu        causal mask, contiguous [B, S, Hkv, D] cache
//   tree_attention_paged.cu    tree mask,   block-paged pool
//   tree_attention.cu          tree mask,   contiguous cache
//
// A small query window q [B, Tq, Hq, D] attends to a row's keys; the K/V
// addressing (`PagedKV`: per-row block table, `ContigKV`: row stride) and
// the mask (causal or tree) are template parameters, the rest is one body.
// This loop runs the float32 and mixed instances; q and K/V in bfloat16
// take the tensor-core split-KV loop of serve_attention_mma.cuh, which
// shares the masks, the operands and the addressing defined here.
//
// Causal mask: key position p is visible to query (b, i) iff p < kv_len[b],
// p <= q_pos[b, i] and, with a window, p > q_pos[b, i] - window.
//
// Tree mask (speculative tree verification): the window's KV sits at cache
// slots win_start .. win_start + Tq - 1 while q_pos holds each node's
// LOGICAL position (root + depth), so the window is not causal by
// position. Key p is visible iff p < eff_len = min(kv_len, win_start +
// win_len) and either p < win_start (committed context; with a window also
// p > q_pos - window) or j = p - win_start satisfies j < win_len, j < Tq and
// bit j of the query's uint32 ancestor mask anc[b, i] is set.
//
// Scores take `scale`, then the optional softcap tanh(s / cap) * cap, then
// an f32 online softmax. A query that sees no key returns 0.
//
// Quantized K/V (DESIGN.md §10): int8 or fp8 (e4m3) codes with float32
// dequant scales k_scale / v_scale, one per (position, kv head), laid out
// as the K/V without their last axis ([NB, bs, Hkv] paged, [B, S, Hkv]
// contiguous): the value is code * scale. This loop dequantizes to f32 as
// it stages a chunk, the TPU kernel's arithmetic; bf16 q with 8-bit K/V
// takes the tensor-core loop of serve_attention_mma.cuh instead.
//
// What bounds these kernels on an H100: the bytes of K/V they stream. Per
// key the useful work is 2 * (Tq * G) * D multiply-adds against 2 * D
// values read, far below the card's operations-per-byte balance point at
// Tq * G <= 128 rows. So every K/V byte is read once per tile: one thread
// block per (kv head, batch row, tile of 64 query rows) holds the tile's
// query rows (the GQA group) in shared memory while the row's keys stream
// through in chunks of 64, staged into shared memory with 16-byte loads and
// converted to f32 once. The sweep covers only the keys some query of the
// tile can see: [window start, min(kv_len, last q_pos + 1)) for the causal
// mask, [window start, eff_len) for the tree mask, whose bound must not use
// q_pos (a node at depth 8 in slot 30 has q_pos = root + 8 but its KV at
// win_start + 30). Arithmetic is f32 FMA on the CUDA cores.
//
// Head dims: 32, 48, 64 and 128. A head dim that is not a multiple of the
// warp's 32 lanes (48) is padded inside the tile to the next multiple (64):
// q, K and V are staged with zero columns D .. DP - 1 in shared memory,
// scores sum over the D real columns only, the online softmax is unchanged,
// and only columns 0 .. D - 1 of the output are stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;   // query rows (i, g) per thread block
constexpr int kKeys = 64;   // keys staged per chunk (two per lane)
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr float kNegInf = -1e30f;

// two e4m3 codes (the low byte first) as f32; exact
__device__ __forceinline__ float2 fp8x2_to_float2(uint16_t x) {
  const __half2 h = __half2(__nv_cvt_fp8x2_to_halfraw2(x, __NV_E4M3));
  return __half22float2(h);
}

// 16-byte vector loads converted to f32; kQuant: codes, scaled by the caller
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static constexpr bool kQuant = false;
  __device__ static void load(const float* p, float* o) {
    float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
  __device__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr bool kQuant = false;
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

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  static constexpr bool kQuant = true;
  __device__ static void load(const int8_t* p, float* o) {
    uint4 x = *reinterpret_cast<const uint4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
    for (int e = 0; e < 16; ++e) o[e] = static_cast<float>(c[e]);
  }
};

template <>
struct Vec<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  static constexpr bool kQuant = true;
  __device__ static void load(const __nv_fp8_e4m3* p, float* o) {
    uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint16_t* c = reinterpret_cast<const uint16_t*>(&x);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float2 f = fp8x2_to_float2(c[e]);
      o[2 * e] = f.x;
      o[2 * e + 1] = f.y;
    }
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

// K/V addressing: the positions a row can hold (reach), the element
// offset of (row b, position p, kv head h) (with d = 1: the index of its
// dequant scale), and whether `keys` positions from a multiple of `keys`
// lie in one run of stride hkv * d (runs)
struct PagedKV {          // pools [NB, bs, Hkv, D], tables [B, MBS]
  const int* tables;
  int nb, bs, mbs;
  __device__ __forceinline__ int reach() const { return mbs * bs; }
  __device__ __forceinline__ bool runs(int keys) const { return bs % keys == 0; }
  __device__ __forceinline__ size_t offset(int b, int p, int h, int hkv, int d) const {
    int blk = tables[b * mbs + p / bs];
    blk = min(max(blk, 0), nb - 1);
    return ((static_cast<size_t>(blk) * bs + p % bs) * hkv + h) * d;
  }
};

struct ContigKV {         // cache [B, S, Hkv, D]
  int s;
  __device__ __forceinline__ int reach() const { return s; }
  __device__ __forceinline__ bool runs(int) const { return true; }
  __device__ __forceinline__ size_t offset(int b, int p, int h, int hkv, int d) const {
    return ((static_cast<size_t>(b) * s + p) * hkv + h) * d;
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;       // int8 / fp8 K/V: [.., .., Hkv]; else null
  const float* v_scale;
  const int* kv_len;          // [B]
  const int* q_pos;           // [B, Tq]
  const int* win_start;       // [B]      tree mask only
  const int* win_len;         // [B]      tree mask only
  const uint32_t* anc;        // [B, Tq]  tree mask only
  void* out;                  // [B, Tq, Hq, D]
  int tq, hq, hkv;
  float scale;
  int window;
  float softcap;
};

// the head dim padded to whole warps: lane l owns columns l, l + 32, ...
template <int D>
__host__ __device__ constexpr int padded_dim() { return (D + 31) / 32 * 32; }

template <int D>
constexpr size_t smem_bytes() {
  constexpr int DP = padded_dim<D>();
  // q tile, K chunk (rows padded by one float against bank conflicts),
  // V chunk, probabilities, per-row query positions and ancestor masks
  return sizeof(float) * (kRows * DP + kKeys * (DP + 1) + kKeys * DP + kRows * kKeys)
         + sizeof(int) * 2 * kRows;
}

template <typename QT, typename KT, int D, class KV, bool kTree>
__global__ void __launch_bounds__(kThreads) tile_kernel(Args a, KV kv) {
  constexpr int DP = padded_dim<D>();
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DC = DP / 32;  // output columns per lane
  const QT* __restrict__ q = static_cast<const QT*>(a.q);
  const KT* __restrict__ kp = static_cast<const KT*>(a.k);
  const KT* __restrict__ vp = static_cast<const KT*>(a.v);
  QT* __restrict__ out = static_cast<QT*>(a.out);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int tq = a.tq, hq = a.hq, hkv = a.hkv;
  const int g = hq / hkv;
  const int rows = tq * g;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;                      // [kRows][DP]
  float* ks = qs + kRows * DP;           // [kKeys][DP + 1]
  float* vs = ks + kKeys * (DP + 1);     // [kKeys][DP]
  float* ps = vs + kKeys * DP;           // [kRows][kKeys]
  int* qp_s = reinterpret_cast<int*>(ps + kRows * kKeys);          // [kRows]
  uint32_t* anc_s = reinterpret_cast<uint32_t*>(qp_s + kRows);     // [kRows]

  // stage the tile's query rows; row r = (i, gg) reads q[b, i, h*g + gg];
  // padding columns D .. DP - 1 are zero
  constexpr int QV = Vec<QT>::N;
  for (int idx = tid; idx < kRows * (DP / QV); idx += kThreads) {
    const int r = idx / (DP / QV);
    const int c = (idx % (DP / QV)) * QV;
    const int row = r0 + r;
    float t[QV];
    if (row < rows && c < D) {
      const int i = row / g, gg = row % g;
      Vec<QT>::load(q + ((static_cast<size_t>(b) * tq + i) * hq + h * g + gg) * D + c, t);
    } else {
#pragma unroll
      for (int e = 0; e < QV; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < QV; ++e) qs[r * DP + c + e] = t[e];
  }
  // rows past the tile's end are never stored; the causal mask hides every
  // key from them (q_pos -1), the tree mask leaves them only context
  for (int r = tid; r < kRows; r += kThreads) {
    const int row = r0 + r;
    const bool real = row < rows;
    qp_s[r] = real ? a.q_pos[b * tq + row / g] : -1;
    anc_s[r] = (kTree && real) ? a.anc[b * tq + row / g] : 0u;
  }
  __syncthreads();

  // the tile's key range [lo, hi): what some query of the tile can see
  int qmin = 0x7fffffff, qmax = -1;
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r < rows) {
      qmin = min(qmin, qp_s[r]);
      qmax = max(qmax, qp_s[r]);
    }
  }
  const int window = a.window;
  const int kl = min(a.kv_len[b], kv.reach());
  int lo = 0, hi, ws = 0, wl = 0;
  if constexpr (kTree) {
    ws = a.win_start[b];
    wl = a.win_len[b];
    hi = min(kl, ws + wl);                      // eff_len: never q_pos
    if (window > 0) lo = min(ws, max(0, qmin - window + 1));
  } else {
    hi = min(kl, qmax + 1);
    if (window > 0) lo = max(0, qmin - window + 1);
  }

  float acc[kRowsPerWarp][DC];
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  constexpr int KVN = Vec<KT>::N;
  for (int c0 = lo; c0 < hi; c0 += kKeys) {
    // stage keys c0 .. c0 + kKeys - 1
    for (int idx = tid; idx < kKeys * (DP / KVN); idx += kThreads) {
      const int j = idx / (DP / KVN);
      const int c = (idx % (DP / KVN)) * KVN;
      const int p = c0 + j;
      float kt[KVN], vt[KVN];
      if (p < hi && c < D) {
        const size_t off = kv.offset(b, p, h, hkv, D) + c;
        Vec<KT>::load(kp + off, kt);
        Vec<KT>::load(vp + off, vt);
        if constexpr (Vec<KT>::kQuant) {      // dequantize: code * scale
          const size_t so = kv.offset(b, p, h, hkv, 1);
          const float sk = a.k_scale[so], sv = a.v_scale[so];
#pragma unroll
          for (int e = 0; e < KVN; ++e) {
            kt[e] *= sk;
            vt[e] *= sv;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < KVN; ++e) kt[e] = vt[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < KVN; ++e) {
        ks[j * (DP + 1) + c + e] = kt[e];
        vs[j * DP + c + e] = vt[e];
      }
    }
    __syncthreads();

    // scores over the D real columns: warp w owns rows w, w + 8, ...; lane
    // owns keys lane, lane + 32
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0 = ks[lane * (DP + 1) + d];
      const float k1 = ks[(lane + 32) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float qv = qs[(warp + kWarps * i) * DP + d];
        s[i][0] = fmaf(qv, k0, s[i][0]);
        s[i][1] = fmaf(qv, k1, s[i][1]);
      }
    }

    // mask + online softmax; the same warp then owns these rows' P @ V
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      const int qp = qp_s[r];
      const uint32_t anc = anc_s[r];
      float x[2];
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = c0 + lane + 32 * e;
        float val = s[i][e] * a.scale;
        if (a.softcap > 0.f) val = tanhf(val / a.softcap) * a.softcap;
        if constexpr (kTree) {
          const int j = p - ws;
          const bool ctx = p < ws && (window <= 0 || p > qp - window);
          // j < tq <= 32 keeps the shift in range
          const bool win = j >= 0 && j < wl && j < tq && ((anc >> j) & 1u);
          ok[e] = p < hi && (ctx || win);
        } else {
          ok[e] = p < hi && p <= qp && (window <= 0 || p > qp - window);
        }
        x[e] = ok[e] ? val : kNegInf;
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
      for (int c = 0; c < DC; ++c) vv[c] = vs[j * DP + lane + 32 * c];
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
    for (int c = 0; c < DC; ++c)
      if (lane + 32 * c < D) Vec<QT>::store(dst + lane + 32 * c, acc[i][c] * inv);
  }
}

template <typename QT, typename KT, int D, class KV, bool kTree>
cudaError_t launch(const Args& a, const KV& kv, int b, cudaStream_t stream) {
  auto kern = tile_kernel<QT, KT, D, KV, kTree>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = a.tq * (a.hq / a.hkv);
  dim3 grid(a.hkv, b, (rows + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, stream>>>(a, kv);
  return cudaGetLastError();
}

template <typename QT, typename KT, class KV, bool kTree>
cudaError_t launch_d(int d, const Args& a, const KV& kv, int b, cudaStream_t stream) {
  if (d == 32) return launch<QT, KT, 32, KV, kTree>(a, kv, b, stream);
  if (d == 48) return launch<QT, KT, 48, KV, kTree>(a, kv, b, stream);
  if (d == 64) return launch<QT, KT, 64, KV, kTree>(a, kv, b, stream);
  if (d == 128) return launch<QT, KT, 128, KV, kTree>(a, kv, b, stream);
  return cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8, 3 = fp8 e4m3 (K/V
// only, with scales); bfloat16 q with bfloat16 or 8-bit K/V takes
// serve_attention_mma.cuh, not this loop. Returns a cudaError_t (0 = ok).
template <class KV, bool kTree>
int dispatch(const Args& a, const KV& kv, int b, int d, int q_dtype, int kv_dtype,
             void* stream) {
  if (b <= 0 || a.tq <= 0 || a.hkv <= 0 || a.hq % a.hkv != 0 ||
      (kv_dtype >= 2 && (!a.k_scale || !a.v_scale)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch_d<float, float, KV, kTree>(d, a, kv, b, s);
  else if (q_dtype == 0 && kv_dtype == 1)
    err = launch_d<float, __nv_bfloat16, KV, kTree>(d, a, kv, b, s);
  else if (q_dtype == 1 && kv_dtype == 0)
    err = launch_d<__nv_bfloat16, float, KV, kTree>(d, a, kv, b, s);
  else if (q_dtype == 0 && kv_dtype == 2)
    err = launch_d<float, int8_t, KV, kTree>(d, a, kv, b, s);
  else if (q_dtype == 0 && kv_dtype == 3)
    err = launch_d<float, __nv_fp8_e4m3, KV, kTree>(d, a, kv, b, s);
  return static_cast<int>(err);
}

}  // namespace attn
