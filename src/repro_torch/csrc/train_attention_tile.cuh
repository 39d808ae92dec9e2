// Training attention for Hopper (sm_90a): the float32 forward
// online-softmax loop and its backward, and the arguments, masks, tile
// classes and Δ pass that the bfloat16 kernels of train_attention_mma.cuh
// share, for the port's full-sequence kernels.
//
//   flash_attention.cu      forward, causal mask (+ window, key count)
//   flash_attention_bwd.cu  backward, causal mask
//   pard_attention.cu       forward, COD mask from per-token (segment, base)
//   pard_attention_bwd.cu   backward, COD mask
//
// Layouts: q, o, dO, dq [B, T, Hq, D]; k, v, dk, dv [B, S, Hkv, D]; the
// per-row log-sum-exp and Δ [B, Hq, T] float32. GQA: query head h reads
// kv head h / (Hq / Hkv) directly (no repeated KV).
//
// Scores take `scale`, then the optional softcap c * tanh(s / c), then the
// mask. A query that sees no key returns 0 (its log-sum-exp is stored as 0
// and never read: no pair of that row is allowed).
//
// Masks (template parameter `M`), evaluated on per-token int2 metadata
// staged beside each tile; index -1 marks a row or key past the sequence:
//   CausalMask: metadata = (index, -); key j visible to query i iff
//     j <= i (when causal) and j > i - window (when window > 0). Keys and
//     queries count from 0 on both sides, as the TPU kernel's iotas do.
//   CodMask: metadata = (segment, base); key (s_k, b_k) visible to query
//     (s_q, b_q) iff both segments > 0 and
//       s_k == 1 and b_k < b_q             (real context)
//       1 < s_k < s_q and b_k == b_q       (earlier masks of the chain)
//       s_k == s_q and b_k == b_q          (self)
//
// What bounds these kernels on an H100: the arithmetic. At D = 64 a
// (query, key) pair costs 2 * D multiply-adds forward and 5 * D backward
// against bytes that are read once per tile, far above the card's
// balance point, so the tensor cores' 989 TFLOP/s (bf16) are the bound.
// This file now serves float32 only: the bfloat16 instances run on the
// tensor cores in train_attention_mma.cuh. The float32 loop is the
// kernels' exactness check on the card (tolerance 1e-4, which TF32 tensor
// cores would break) and is off the training path (bf16 activations):
// f32 FMA on the CUDA cores, tiles of 64 rows x 64 columns staged in
// shared memory (converted to f32 once), a per-tile test of the mask
// (`any_allowed`) to skip the tiles that the mask empties, and the causal
// range bounding the sweep.
//
// Backward (no float atomics, so gradients are deterministic):
//   1. delta_kernel: Δ = rowsum(dO ∘ O) per (b, i, h).
//   2. dkdv_kernel: one block per (batch, kv head, 64 keys) holds its K/V
//      tile and accumulates dK, dV in registers while it loops over the G
//      query heads of the kv head and over the query tiles;
//   3. dq_kernel: one block per (batch, q head, 64 queries) loops over the
//      key tiles and accumulates dQ.
//   P = exp(s - lse), dS = P * (dP - Δ) with dP = dO V^T; softcap's
//   backward multiplies dS by 1 - tanh^2(s_raw / c); dq = scale dS K,
//   dk = scale dS^T Q, dv = P^T dO.
//
// Head dims: 32, 48, 64 and 128. A head dim that is not a multiple of the
// warp's 32 lanes (48) is padded inside every tile to the next multiple
// (DP = 64, attn::padded_dim): rows are staged with zero columns D .. DP - 1
// in shared memory, dot products run over the D real columns, and only
// columns 0 .. D - 1 of o, dq, dk and dv are stored.
#pragma once

#include "attention_tile.cuh"  // attn::Vec, attn::warp_max, attn::warp_sum

namespace tattn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // rows per block, columns per chunk
constexpr int kRowsPerWarp = kTile / kWarps;
constexpr float kNegInf = -1e30f;

// Classes of a (64-query tile, 64-key tile) pair, as the plain Python
// functions flash_tile_classes / pard_tile_classes compute them: no pair
// allowed (no copy, no math), some pairs allowed (the per-element mask),
// every pair allowed (no mask). A tile holding a row past T, a key past S
// or a padding token is never full.
constexpr int kEmpty = 0;
constexpr int kPartial = 1;
constexpr int kFull = 2;

struct CausalMask {
  static constexpr bool kStaged = false;  // a key's metadata is its index
  int causal;
  int window;
  __device__ __forceinline__ int2 meta(int, int i, int) const { return make_int2(i, 0); }
  __device__ __forceinline__ bool ok(int2 q, int2 k) const {
    return q.x >= 0 && k.x >= 0 && (!causal || k.x <= q.x) &&
           (window <= 0 || k.x > q.x - window);
  }
  // keys [lo, hi) of s that some query of [q0, q1) may see
  __device__ __forceinline__ void keys(int q0, int q1, int s, int& lo, int& hi) const {
    lo = window > 0 ? max(0, q0 - window + 1) : 0;
    hi = causal ? min(s, q1) : s;
  }
  // queries [lo, hi) of t that may see some key of [k0, k1)
  __device__ __forceinline__ void queries(int k0, int k1, int t, int& lo, int& hi) const {
    lo = causal ? k0 : 0;
    hi = window > 0 ? min(t, k1 - 1 + window) : t;
  }
  // the class of query tile qt against key tile kt, from the indices
  __device__ __forceinline__ int tile_class(int, int qt, int kt, int t, int s) const {
    const int q0 = qt * kTile, k0 = kt * kTile;
    const int q1 = min(q0 + kTile, t), k1 = min(k0 + kTile, s);
    if (q0 >= t || k0 >= s || (causal && k0 > q1 - 1) ||
        (window > 0 && k1 - 1 <= q0 - window))
      return kEmpty;
    const bool whole = q0 + kTile <= t && k0 + kTile <= s;
    if (whole && (!causal || k0 + kTile - 1 <= q0) &&
        (window <= 0 || k0 > q0 + kTile - 1 - window))
      return kFull;
    return kPartial;
  }
};

struct CodMask {
  static constexpr bool kStaged = true;   // a key's (segment, base) is staged
  const int* seg;   // [B, T]
  const int* base;  // [B, T]
  // [B, nt, nt] uint8 classes of (query tile, key tile), nt = ceil(T / 64),
  // from pard_tile_classes (read by the bfloat16 kernels only)
  const unsigned char* tiles;
  __device__ __forceinline__ int2 meta(int b, int i, int n) const {
    const size_t at = static_cast<size_t>(b) * n + i;
    return make_int2(seg[at], base[at]);
  }
  // the three rules above, regrouped by the key's segment
  __device__ __forceinline__ bool ok(int2 q, int2 k) const {
    if (k.x == 1) return q.x > 0 && (k.y < q.y || (q.x == 1 && k.y == q.y));
    return k.x > 1 && k.x <= q.x && k.y == q.y;
  }
  __device__ __forceinline__ void keys(int, int, int s, int& lo, int& hi) const {
    lo = 0;
    hi = s;
  }
  __device__ __forceinline__ void queries(int, int, int t, int& lo, int& hi) const {
    lo = 0;
    hi = t;
  }
  __device__ __forceinline__ int tile_class(int b, int qt, int kt, int t, int) const {
    const int nt = (t + kTile - 1) / kTile;
    return tiles[(static_cast<size_t>(b) * nt + qt) * nt + kt];
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;      // forward output (backward only)
  const void* dout;   // backward only
  float* lse;         // [B, Hq, T]: written forward, read backward
  float* delta;       // [B, Hq, T] scratch (backward)
  void* out;          // forward: o
  void* dq;
  void* dk;
  void* dv;
  int b, t, s, hq, hkv;
  float scale;
  float softcap;
};

// rows r0 .. r0 + kTile - 1 of one head of a [B, n, heads, D] tensor into
// shared f32 [kTile][LD], columns padded to DP; rows past n and padding
// columns D .. DP - 1 are zero
template <typename T, int D, int LD>
__device__ __forceinline__ void stage(float* dst, const T* src, int b, int r0, int n,
                                      int h, int heads) {
  constexpr int V = attn::Vec<T>::N;
  constexpr int DP = attn::padded_dim<D>();
  for (int idx = threadIdx.x; idx < kTile * (DP / V); idx += kThreads) {
    const int r = idx / (DP / V);
    const int c = (idx % (DP / V)) * V;
    const int row = r0 + r;
    float x[V];
    if (row < n && c < D) {
      attn::Vec<T>::load(src + ((static_cast<size_t>(b) * n + row) * heads + h) * D + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * LD + c + e] = x[e];
  }
}

template <class M>
__device__ __forceinline__ void stage_meta(int2* dst, const M& m, int b, int r0, int n) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = r0 + r < n ? m.meta(b, r0 + r, n) : make_int2(-1, 0);
}

// per-row float32 [B, Hq, n] values of rows r0 .. r0 + kTile - 1
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int b, int h,
                                           int hq, int r0, int n) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = r0 + r < n ? src[(static_cast<size_t>(b) * hq + h) * n + r0 + r] : 0.f;
}

// true iff the mask allows some (query, key) pair of the staged tile; a
// barrier for the whole block
template <class M>
__device__ __forceinline__ bool any_allowed(const M& m, const int2* qm, const int2* km) {
  bool any = false;
  for (int idx = threadIdx.x; idx < kTile * kTile && !any; idx += kThreads)
    any = m.ok(qm[idx / kTile], km[idx % kTile]);
  return __syncthreads_or(any);
}

// scaled, soft-capped score of a raw dot product; `th` gets tanh(s / cap)
__device__ __forceinline__ float score(float dot, float scale, float cap, float& th) {
  float x = dot * scale;
  th = 0.f;
  if (cap > 0.f) {
    th = tanhf(x / cap);
    x = th * cap;
  }
  return x;
}

// ---------------------------------------------------------------------------
// forward: one block per (64 queries, q head, batch row)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  constexpr int DP = attn::padded_dim<D>();
  return sizeof(float) * (kTile * DP + kTile * (DP + 1) + kTile * DP + kTile * kTile) +
         sizeof(int2) * 2 * kTile;
}

template <typename T, int D, class M>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a, M mask) {
  constexpr int DP = attn::padded_dim<D>();
  constexpr int DC = DP / 32;  // output columns per lane
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int hk = h / (a.hq / a.hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  extern __shared__ float smem[];
  float* qs = smem;                       // [kTile][DP]
  float* ks = qs + kTile * DP;            // [kTile][DP + 1]
  float* vs = ks + kTile * (DP + 1);      // [kTile][DP]
  float* ps = vs + kTile * DP;            // [kTile][kTile]
  int2* qm = reinterpret_cast<int2*>(ps + kTile * kTile);
  int2* km = qm + kTile;

  stage<T, D, DP>(qs, static_cast<const T*>(a.q), b, q0, a.t, h, a.hq);
  stage_meta(qm, mask, b, q0, a.t);

  float acc[kRowsPerWarp][DC];
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  mask.keys(q0, min(q0 + kTile, a.t), a.s, lo, hi);
  for (int c0 = lo; c0 < hi; c0 += kTile) {
    __syncthreads();  // the previous chunk's reads are done
    stage<T, D, DP + 1>(ks, static_cast<const T*>(a.k), b, c0, a.s, hk, a.hkv);
    stage<T, D, DP>(vs, static_cast<const T*>(a.v), b, c0, a.s, hk, a.hkv);
    stage_meta(km, mask, b, c0, a.s);
    __syncthreads();
    if (!any_allowed(mask, qm, km)) continue;

    // scores: warp w owns rows w, w + 8, ...; lane owns keys lane, lane + 32
    float sc[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0 = ks[lane * (DP + 1) + d];
      const float k1 = ks[(lane + 32) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float qv = qs[(warp + kWarps * i) * DP + d];
        sc[i][0] = fmaf(qv, k0, sc[i][0]);
        sc[i][1] = fmaf(qv, k1, sc[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      float x[2];
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float th;
        ok[e] = mask.ok(qm[r], km[lane + 32 * e]);
        x[e] = ok[e] ? score(sc[i][e], a.scale, a.softcap, th) : kNegInf;
      }
      const float m_new = fmaxf(m_run[i], attn::warp_max(fmaxf(x[0], x[1])));
      const float p0 = ok[0] ? expf(x[0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(x[1] - m_new) : 0.f;
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + attn::warp_sum(p0 + p1);
      m_run[i] = m_new;
      ps[r * kTile + lane] = p0;
      ps[r * kTile + lane + 32] = p1;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();

    // acc[row][d] += sum_j P[row][j] * V[j][d]; lane owns d = lane + 32 c
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[j * DP + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pp = ps[(warp + kWarps * i) * kTile + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pp, vv[c], acc[i][c]);
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + warp + kWarps * i;
    if (row >= a.t) continue;
    const bool seen = l_run[i] > 0.f;
    const float inv = seen ? 1.f / l_run[i] : 1.f;
    T* dst = out + ((static_cast<size_t>(b) * a.t + row) * a.hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (lane + 32 * c < D) attn::Vec<T>::store(dst + lane + 32 * c, acc[i][c] * inv);
    if (lane == 0)
      a.lse[(static_cast<size_t>(b) * a.hq + h) * a.t + row] =
          seen ? m_run[i] + logf(l_run[i]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Δ[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]; one thread per row,
// 16-byte loads (both dtypes; the bfloat16 kernels use it too)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) delta_kernel(Args a) {
  constexpr int V = attn::Vec<T>::N;
  const size_t row = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= static_cast<size_t>(a.b) * a.t * a.hq) return;
  const T* o = static_cast<const T*>(a.o) + row * D;
  const T* g = static_cast<const T*>(a.dout) + row * D;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += V) {
    float x[V], y[V];
    attn::Vec<T>::load(o + c, x);
    attn::Vec<T>::load(g + c, y);
#pragma unroll
    for (int e = 0; e < V; ++e) sum = fmaf(x[e], y[e], sum);
  }
  const int h = static_cast<int>(row % a.hq);
  const size_t bi = row / a.hq;  // b * t + i
  const int i = static_cast<int>(bi % a.t);
  const int b = static_cast<int>(bi / a.t);
  a.delta[(static_cast<size_t>(b) * a.hq + h) * a.t + i] = sum;
}

// launches delta_kernel on the stream
template <typename T, int D>
cudaError_t delta_launch(const Args& a, cudaStream_t st) {
  const size_t rows = static_cast<size_t>(a.b) * a.t * a.hq;
  delta_kernel<T, D><<<static_cast<unsigned>((rows + kThreads - 1) / kThreads), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <int D>
constexpr size_t dkdv_smem() {
  constexpr int DP = attn::padded_dim<D>();
  return sizeof(float) * (2 * kTile * DP + 2 * kTile * (DP + 1) + 2 * kTile * kTile +
                          2 * kTile) +
         sizeof(int2) * 2 * kTile;
}

// one block per (64 keys, kv head, batch row); rows are keys, columns queries
template <typename T, int D, class M>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args a, M mask) {
  constexpr int DP = attn::padded_dim<D>();
  constexpr int DC = DP / 32;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const int g = a.hq / a.hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  extern __shared__ float smem[];
  float* ks = smem;                       // [kTile][DP]      keys (rows)
  float* vs = ks + kTile * DP;            // [kTile][DP]
  float* qs = vs + kTile * DP;            // [kTile][DP + 1]  queries (columns)
  float* dos = qs + kTile * (DP + 1);     // [kTile][DP + 1]
  float* ps = dos + kTile * (DP + 1);     // [kTile keys][kTile queries]
  float* dss = ps + kTile * kTile;        // [kTile keys][kTile queries]
  float* lse_s = dss + kTile * kTile;     // [kTile]
  float* dl_s = lse_s + kTile;            // [kTile]
  int2* km = reinterpret_cast<int2*>(dl_s + kTile);
  int2* qm = km + kTile;

  stage<T, D, DP>(ks, static_cast<const T*>(a.k), b, k0, a.s, hk, a.hkv);
  stage<T, D, DP>(vs, static_cast<const T*>(a.v), b, k0, a.s, hk, a.hkv);
  stage_meta(km, mask, b, k0, a.s);

  float dk[kRowsPerWarp][DC], dv[kRowsPerWarp][DC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  int lo, hi;
  mask.queries(k0, min(k0 + kTile, a.s), a.t, lo, hi);
  for (int gg = 0; gg < g; ++gg) {
    const int h = hk * g + gg;
    for (int c0 = lo; c0 < hi; c0 += kTile) {
      __syncthreads();  // the previous tile's reads are done
      stage<T, D, DP + 1>(qs, static_cast<const T*>(a.q), b, c0, a.t, h, a.hq);
      stage<T, D, DP + 1>(dos, static_cast<const T*>(a.dout), b, c0, a.t, h, a.hq);
      stage_meta(qm, mask, b, c0, a.t);
      stage_rows(lse_s, a.lse, b, h, a.hq, c0, a.t);
      stage_rows(dl_s, a.delta, b, h, a.hq, c0, a.t);
      __syncthreads();
      if (!any_allowed(mask, qm, km)) continue;

      // warp w owns keys w, w + 8, ...; lane owns queries lane, lane + 32
      float sc[kRowsPerWarp][2], dp[kRowsPerWarp][2];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) sc[i][0] = sc[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float q0v = qs[lane * (DP + 1) + d];
        const float q1v = qs[(lane + 32) * (DP + 1) + d];
        const float o0v = dos[lane * (DP + 1) + d];
        const float o1v = dos[(lane + 32) * (DP + 1) + d];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float kv = ks[(warp + kWarps * i) * DP + d];
          const float vv = vs[(warp + kWarps * i) * DP + d];
          sc[i][0] = fmaf(kv, q0v, sc[i][0]);
          sc[i][1] = fmaf(kv, q1v, sc[i][1]);
          dp[i][0] = fmaf(vv, o0v, dp[i][0]);
          dp[i][1] = fmaf(vv, o1v, dp[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = lane + 32 * e;
          float p = 0.f, ds = 0.f;
          if (mask.ok(qm[c], km[r])) {
            float th;
            const float x = score(sc[i][e], a.scale, a.softcap, th);
            p = expf(x - lse_s[c]);
            ds = p * (dp[i][e] - dl_s[c]);
            if (a.softcap > 0.f) ds *= 1.f - th * th;
          }
          ps[r * kTile + c] = p;
          dss[r * kTile + c] = ds * a.scale;
        }
      }
      __syncwarp();

      // dv[key][d] += sum_c P[key][c] dO[c][d]; dk[key][d] += sum_c dS[key][c] Q[c][d]
#pragma unroll 2
      for (int c = 0; c < kTile; ++c) {
        float ov[DC], qv[DC];
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          ov[cc] = dos[c * (DP + 1) + lane + 32 * cc];
          qv[cc] = qs[c * (DP + 1) + lane + 32 * cc];
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float pp = ps[(warp + kWarps * i) * kTile + c];
          const float dd = dss[(warp + kWarps * i) * kTile + c];
#pragma unroll
          for (int cc = 0; cc < DC; ++cc) {
            dv[i][cc] = fmaf(pp, ov[cc], dv[i][cc]);
            dk[i][cc] = fmaf(dd, qv[cc], dk[i][cc]);
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = k0 + warp + kWarps * i;
    if (row >= a.s) continue;
    const size_t off = ((static_cast<size_t>(b) * a.s + row) * a.hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      if (lane + 32 * c >= D) continue;
      attn::Vec<T>::store(dkp + off + lane + 32 * c, dk[i][c]);
      attn::Vec<T>::store(dvp + off + lane + 32 * c, dv[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  constexpr int DP = attn::padded_dim<D>();
  return sizeof(float) * (2 * kTile * DP + 2 * kTile * (DP + 1) + kTile * kTile + 2 * kTile) +
         sizeof(int2) * 2 * kTile;
}

// one block per (64 queries, q head, batch row); rows are queries, columns keys
template <typename T, int D, class M>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a, M mask) {
  constexpr int DP = attn::padded_dim<D>();
  constexpr int DC = DP / 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int hk = h / (a.hq / a.hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  extern __shared__ float smem[];
  float* qs = smem;                       // [kTile][DP]      queries (rows)
  float* dos = qs + kTile * DP;           // [kTile][DP]
  float* ks = dos + kTile * DP;           // [kTile][DP + 1]  keys (columns)
  float* vs = ks + kTile * (DP + 1);      // [kTile][DP + 1]
  float* dss = vs + kTile * (DP + 1);     // [kTile queries][kTile keys]
  float* lse_s = dss + kTile * kTile;     // [kTile]
  float* dl_s = lse_s + kTile;            // [kTile]
  int2* qm = reinterpret_cast<int2*>(dl_s + kTile);
  int2* km = qm + kTile;

  stage<T, D, DP>(qs, static_cast<const T*>(a.q), b, q0, a.t, h, a.hq);
  stage<T, D, DP>(dos, static_cast<const T*>(a.dout), b, q0, a.t, h, a.hq);
  stage_meta(qm, mask, b, q0, a.t);
  stage_rows(lse_s, a.lse, b, h, a.hq, q0, a.t);
  stage_rows(dl_s, a.delta, b, h, a.hq, q0, a.t);

  float dq[kRowsPerWarp][DC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;

  int lo, hi;
  mask.keys(q0, min(q0 + kTile, a.t), a.s, lo, hi);
  for (int c0 = lo; c0 < hi; c0 += kTile) {
    __syncthreads();  // the previous chunk's reads are done
    stage<T, D, DP + 1>(ks, static_cast<const T*>(a.k), b, c0, a.s, hk, a.hkv);
    stage<T, D, DP + 1>(vs, static_cast<const T*>(a.v), b, c0, a.s, hk, a.hkv);
    stage_meta(km, mask, b, c0, a.s);
    __syncthreads();
    if (!any_allowed(mask, qm, km)) continue;

    // warp w owns queries w, w + 8, ...; lane owns keys lane, lane + 32
    float sc[kRowsPerWarp][2], dp[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i][0] = sc[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0v = ks[lane * (DP + 1) + d];
      const float k1v = ks[(lane + 32) * (DP + 1) + d];
      const float v0v = vs[lane * (DP + 1) + d];
      const float v1v = vs[(lane + 32) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float qv = qs[(warp + kWarps * i) * DP + d];
        const float ov = dos[(warp + kWarps * i) * DP + d];
        sc[i][0] = fmaf(qv, k0v, sc[i][0]);
        sc[i][1] = fmaf(qv, k1v, sc[i][1]);
        dp[i][0] = fmaf(ov, v0v, dp[i][0]);
        dp[i][1] = fmaf(ov, v1v, dp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        float ds = 0.f;
        if (mask.ok(qm[r], km[c])) {
          float th;
          const float x = score(sc[i][e], a.scale, a.softcap, th);
          ds = expf(x - lse_s[r]) * (dp[i][e] - dl_s[r]);
          if (a.softcap > 0.f) ds *= 1.f - th * th;
        }
        dss[r * kTile + c] = ds * a.scale;
      }
    }
    __syncwarp();

    // dq[row][d] += sum_j dS[row][j] K[j][d]
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = ks[j * (DP + 1) + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float dd = dss[(warp + kWarps * i) * kTile + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[i][c] = fmaf(dd, kv[c], dq[i][c]);
      }
    }
  }

  T* dqp = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + warp + kWarps * i;
    if (row >= a.t) continue;
    T* dst = dqp + ((static_cast<size_t>(b) * a.t + row) * a.hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (lane + 32 * c < D) attn::Vec<T>::store(dst + lane + 32 * c, dq[i][c]);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, class M>
cudaError_t fwd_launch(const Args& a, const M& m, cudaStream_t st) {
  auto kern = fwd_kernel<T, D, M>;
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.t + kTile - 1) / kTile, a.hq, a.b);
  kern<<<grid, kThreads, smem, st>>>(a, m);
  return cudaGetLastError();
}

template <typename T, int D, class M>
cudaError_t bwd_launch(const Args& a, const M& m, cudaStream_t st) {
  cudaError_t err = delta_launch<T, D>(a, st);
  if (err != cudaSuccess) return err;

  auto kv_kern = dkdv_kernel<T, D, M>;
  constexpr size_t kv_smem = dkdv_smem<D>();
  err = allow_smem(kv_kern, kv_smem);
  if (err != cudaSuccess) return err;
  dim3 kv_grid((a.s + kTile - 1) / kTile, a.hkv, a.b);
  kv_kern<<<kv_grid, kThreads, kv_smem, st>>>(a, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto q_kern = dq_kernel<T, D, M>;
  constexpr size_t q_smem = dq_smem<D>();
  err = allow_smem(q_kern, q_smem);
  if (err != cudaSuccess) return err;
  dim3 q_grid((a.t + kTile - 1) / kTile, a.hq, a.b);
  q_kern<<<q_grid, kThreads, q_smem, st>>>(a, m);
  return cudaGetLastError();
}

// The float32 instances (the bfloat16 ones are in train_attention_mma.cuh).
// Returns a cudaError_t (0 = ok).
template <bool kBackward, class M>
cudaError_t launch_f32(const Args& a, const M& m, int d, cudaStream_t st) {
#define TATTN_CASE(DD)                                 \
  if (d == DD) {                                       \
    if constexpr (kBackward)                           \
      return bwd_launch<float, DD, M>(a, m, st);       \
    else                                               \
      return fwd_launch<float, DD, M>(a, m, st);       \
  }
  TATTN_CASE(32)
  TATTN_CASE(48)
  TATTN_CASE(64)
  TATTN_CASE(128)
#undef TATTN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace tattn
