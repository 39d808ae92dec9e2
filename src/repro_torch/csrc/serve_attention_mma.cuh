// Serving attention on Hopper's tensor cores (sm_90a): the bfloat16-q
// instances (K/V in bf16, or quantized to int8 / fp8 e4m3 with f32 scales)
// of the four serving kernels.
//
//   decode_attention_paged.cu  causal mask, block-paged pool   (PagedKV)
//   decode_attention.cu        causal mask, contiguous cache   (ContigKV)
//   tree_attention_paged.cu    tree mask,   block-paged pool   (PagedKV)
//   tree_attention.cu          tree mask,   contiguous cache   (ContigKV)
//
// They replace the TPU kernels `decode_attention_paged` / `decode_attention`
// (src/repro/kernels/decode_attention.py) and `tree_attention_paged` /
// `tree_attention` (src/repro/kernels/tree_attention.py) for bf16 inputs.
// The float32 and mixed instances stay on attention_tile.cuh, whose header
// comment defines the masks, the operands (attn::Args) and the K/V
// addressing (attn::PagedKV: a per-row block table, attn::ContigKV: one
// [B, S, Hkv, D] row per batch row), the softcap and the 0 returned for a
// query that sees no key; this loop computes the same function, with the
// addressing as a template parameter. A row's reach (MBS * bs positions
// paged, S contiguous) bounds its sweep: min(kv_len, reach), so a
// contiguous kernel never reads past S.
//
// What bounds them on an H100: the bytes of K/V. A key costs 4 * rows * D
// FLOPs (Q K^T and P V over the window's rows) against 4 D bytes of K and
// V, so rows FLOP per byte: 36 for the verify window (G 4 x Tq 9), 64 for
// the draft window (4 x 16), 124 for the 31-slot tree (4 x 31), far below
// the card's ~295 FLOP/byte balance. Both layouts move the same bytes: a
// contiguous row is max_len long (1024 in the engine) but only the keys
// below min(kv_len, S) that some query sees are streamed, as from the
// pages. The f32 loop of attention_tile.cuh is bound instead by its own
// arithmetic: every product is an FMA on the CUDA cores from shared memory
// (~1 M FMA per 64-key chunk per block), rows are padded to 64, and B *
// Hkv = 32 blocks leave three quarters of 132 SMs idle while each block
// streams its row's keys alone. The design:
//
//   - Products on the tensor cores as mma.sync.m16n8k16 (bf16 in, f32
//     accumulators), operands by ldmatrix from shared memory: S = Q K^T
//     and O += P V. A warp owns 16 query rows (row r = i * G + g of its kv
//     head), a CTA up to 8 warps (128 rows), so the tree window's 124 rows
//     read K/V once; longer windows (G 7 x Tq 31 = 217 rows) take more row
//     tiles, balanced (2 x 112). Not wgmma: its 64-row warpgroup tiles
//     would pad the 36-row verify window to 64 rows (mma.sync: 48), and at
//     ~36 FLOP/byte the tensor cores only have to take the arithmetic off
//     the critical path, which mma.sync does.
//     Per k-step a warp loads its four K fragments first, then runs
//     eight independent mma's.
//   - Scores are scaled and soft-capped in f32; the mask is applied per
//     accumulator element from (row -> its key bounds and ancestor mask,
//     column -> key position), and skipped for a chunk that every row of
//     the warp sees whole (a vote), the common case; the online softmax is
//     f32 (log2 units, ex2.approx, m and l per row).
//     P is rounded to bf16 for the P V product, as FlashAttention does,
//     while l sums the f32 P. That adds at most 2^-8 * max|v| to an output
//     (bf16 keeps 8 significant bits, so each p_j moves by at most 2^-8
//     p_j; the output is a convex combination of V rows), under 2e-2 for
//     |v| <= 5, the bf16 tolerance. Q K^T is exact up to f32 summation
//     order: a product of two bf16 values is exact in f32.
//   - Split-KV across a thread-block cluster of cs CTAs (1..8, portable).
//     The host picks cs from shapes alone (split_kv_plan in
//     kernels/decode_attention.py: B * Hkv * row tiles against 90 % of the
//     SMs, capped by the reach in 64-key chunks), so no device value is
//     read and a call can be captured in a CUDA graph. A CTA holds an SM
//     (up to 140 KB of shared memory, 8 x 32 threads at ~210 registers),
//     and a cluster needs cs SMs of one GPC: on an H100 fewer than 32
//     clusters of 4 fit at once, so B 4 x Hkv 8 in clusters of 4 ran in
//     two waves; the 90 % keeps a call to one wave (B 4 x Hkv 8: clusters
//     of 3, 96 CTAs). On the device each CTA takes a balanced share of the
//     row tile's 64-key chunks of the visible range [lo, hi) (from kv_len,
//     the reach, q_pos, win_start / win_len and the window; lo rounded
//     down to a chunk). A CTA whose share is empty keeps m = -inf, l = 0.
//     The partial (O, m, l) of each CTA go to its shared memory; after
//     cluster.sync() every row is merged by one CTA of the cluster, which
//     reads the cs partials through distributed shared memory in split
//     order. The result is bitwise deterministic and the call is one
//     launch, with no workspace and no counters.
//   - K and V move through a ring of kStages stages filled by 16-byte
//     cp.async.cg copies: the next two chunks' copies are in flight while
//     this chunk's mma's run, with one barrier per chunk. Every CTA has 8
//     warps and all of them start copies, while only the rows' warps (3
//     for the verify window) run the products: the rate at which a warp
//     starts copies, not their latency, limited a 3-warp CTA's stream, so
//     the verify window ran faster at every context with all 8 copying.
//     A chunk whose 64 keys lie in one run of stride Hkv * D (every chunk
//     of a contiguous row; a chunk of a pool whose page size is a multiple
//     of 64) resolves its address once, with at most one block-table
//     entry; smaller pages (the tiny configs' 8 and 16) look one up per key
//     row. Rows are padded by 16 bytes in shared memory, so ldmatrix reads
//     no bank twice.
//   - Quantized K/V (int8 or fp8 e4m3 codes, a f32 scale per key and kv head;
//     DESIGN.md §10) stream at one byte a value: each 16-byte cp.async
//     carries 16 codes into a ring of 8-bit rows (D + 16 bytes), and 4-byte
//     cp.async copies stage the chunk's 64 K and 64 V scales beside it (a
//     zero-filled key gets code 0 and scale 0, so nothing but 0 reaches P V).
//     ldmatrix reads 16-bit elements only, so after the chunk lands all 8
//     warps widen its codes into one bf16 K/V tile of the bf16 layout (with
//     ALU bit operations, widen16), and a second barrier per chunk hands the
//     tile to the row warps, whose products are the bf16 route's. The
//     widening is exact: an int8 code (|c| <= 127) and every e4m3 value have
//     at most 8 significant bits and a bf16 exponent. The scales never enter
//     the tile: k_scale multiplies each f32 score column before the softmax
//     scale, the softcap and the mask (S = Q K^T is exact up to f32
//     summation, as for bf16), and v_scale multiplies P, while l sums the
//     unscaled P: O = sum_j p_j s_j v_j / sum_j p_j. The product p_j s_j
//     enters P V as a bf16 pair hi + lo (|x - hi - lo| <= 2^-16 |x|), twice
//     the P V products: rounded to one bf16, a row that sees one key would
//     get its value times a scale rounded by up to 2^-8, which with the
//     output's own bf16 rounding passes the 2e-2 tolerance once |v| > 4 (the
//     bf16 route returns that value exactly). So the 8-bit route's only
//     rounding of note is the output's. Dequantizing into the tile (bf16(code
//     * scale)) would round every K/V value too. Nothing overlaps the
//     widening pass and its barrier with the products, so at long contexts
//     the 8-bit route takes longer than the bf16 route although it moves
//     about half the bytes (PERF.md, PR 23).
//
// Head dims 32, 48, 64 and 128: all multiples of 16, so no padding.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"  // attn::Args, attn::PagedKV, attn::ContigKV

namespace smma {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;        // keys per chunk and ring stage
constexpr int kStages = 3;       // cp.async ring depth
constexpr int kMaxWarps = 8;     // 16 query rows each
constexpr int kMaxCluster = 8;   // portable cluster size
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// K/V dtype codes: 1 = bfloat16, 2 = int8, 3 = fp8 e4m3 (with scales)

// bytes of the K/V stream for R query rows, reused by the f32 partials
// [R][D + 4] after the key loop. bf16: the ring of kStages x {K, V} in bf16
// rows of D + 8 (16 bytes of padding). 8-bit: the ring of codes in rows of
// D + 16 bytes and of the K and V scales, then one bf16 {K, V} tile.
template <int D, int C>
__host__ __device__ constexpr size_t stream_bytes(int rows) {
  const size_t ring =
      C == 1 ? sizeof(bf16) * 2 * kStages * kKeys * (D + 8)
             : (D + 16 + sizeof(float)) * 2 * kStages * kKeys + sizeof(bf16) * 2 * kKeys * (D + 8);
  const size_t part = sizeof(float) * rows * (D + 4);
  return ring > part ? ring : part;
}

// bytes of dynamic shared memory for R query rows: the K/V stream, Q in
// bf16 rows of D + 8, then m and l per row
template <int D, int C>
__host__ __device__ constexpr size_t smem_bytes(int rows) {
  return stream_bytes<D, C>(rows) + sizeof(bf16) * rows * (D + 8) + sizeof(float) * 2 * rows;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lane l names row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as bf16 pairs hi = bf16(x), lo = bf16(x - hi): hi + lo within
// 2^-16 |x| of x
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(a - f.x, b - f.y);
}

// 16 int8 (C 2) or e4m3 (C 3) codes -> 16 bf16 values, exactly, with ALU
// operations (a conversion instruction runs at a quarter of their rate, and
// a 64-key chunk widens 8 K codes per thread-key):
//   int8: the float with bits 0x4B000000 | (c ^ 0x80) is 2^23 + 128 + c;
//     less 2^23 + 128 it is c, whose top 16 bits are its bf16 (|c| <= 128
//     has at most 8 significant bits);
//   e4m3: its bits s eeee mmm placed as the bf16 bits s 0000eeee mmm0000
//     give the value times 2^-120, subnormals included; widened to f32
//     (bits << 16) and multiplied by 2^120 (exact: f32 keeps subnormals
//     without -ftz) it is the value, whose top 16 bits are its bf16.
// Codes 4 i .. 4 i + 3 lie in word i, the first in its low byte; each pair
// becomes one bf16x2, the first in the low half.
template <int C>
__device__ __forceinline__ void widen16(const uint4& x, uint4 (&o)[2]) {
  const uint32_t* in = reinterpret_cast<const uint32_t*>(&x);
  uint32_t* w = reinterpret_cast<uint32_t*>(o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (C == 2) {
      const uint32_t u = in[i] ^ 0x80808080u;
      uint32_t f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)         // bytes: code k, 0, 0, 0x4B
        f[k] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | k)) -
                               8388736.f);
      w[2 * i] = __byte_perm(f[0], f[1], 0x7632);
      w[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {       // 16-bit lanes (code << 8) of a pair
        const uint32_t t = __byte_perm(in[i], 0u, h ? 0x3424 : 0x1404);
        const uint32_t b = (t & 0x80008000u) | ((t & 0x7F007F00u) >> 4);
        const float lo = __uint_as_float(b << 16) * 0x1p120f;
        const float hi = __uint_as_float(b & 0xFFFF0000u) * 0x1p120f;
        w[2 * i + h] = __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
      }
    }
  }
}

// grid (cs, Hkv * row tiles, B), cluster (cs, 1, 1), 32 * kMaxWarps
// threads: warps 0 .. cw - 1 own 16 rows each, every warp copies.
// A mma accumulator holds rows gid = lane / 4 and gid + 8 of the warp's 16,
// columns 2 (lane % 4) and + 1 of each 8-column n-tile. C: the K/V dtype
// code (1 bf16, 2 int8, 3 fp8 e4m3).
template <int D, bool kTree, class KV, int C>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    mma_kernel(attn::Args a, KV kv, int cw) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr bool kQ = C != 1;   // 8-bit codes with scales
  constexpr int RS = D + 8;     // bf16 row stride in shared memory
  constexpr int RS8 = D + 16;   // 8-bit row stride (bytes)
  constexpr int PS = D + 4;     // f32 partial row stride
  constexpr int KS = D / 16;    // k-steps of Q K^T
  constexpr int DN = D / 8;     // n-tiles of P V
  constexpr int SEG = D / 8;    // 16-byte segments per bf16 row
  constexpr int SEG8 = D / 16;  // 16-byte segments per 8-bit row

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;           // == cluster.block_rank()
  const int cs = gridDim.x;
  const int h = blockIdx.y % a.hkv;
  const int b = blockIdx.z;
  const int nthreads = blockDim.x;
  const int R = 16 * cw;                  // 16 rows per computing warp
  const int r0 = (blockIdx.y / a.hkv) * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = a.tq, hq = a.hq, hkv = a.hkv, g = hq / hkv, rows = tq * g;
  const int window = a.window;
  const bf16* __restrict__ q = static_cast<const bf16*>(a.q);
  const bf16* __restrict__ kp = static_cast<const bf16*>(a.k);
  const bf16* __restrict__ vp = static_cast<const bf16*>(a.v);
  const uint8_t* __restrict__ kp8 = static_cast<const uint8_t*>(a.k);
  const uint8_t* __restrict__ vp8 = static_cast<const uint8_t*>(a.v);
  bf16* __restrict__ out = static_cast<bf16*>(a.out);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);     // bf16: kStages x {K, V} [kKeys][RS]
  uint8_t* ring8 = smem_raw;                           // 8-bit: kStages x {K, V} [kKeys][RS8]
  float* sring = reinterpret_cast<float*>(ring8 + 2 * kStages * kKeys * RS8);
                                                       // kStages x {K, V} scales [kKeys]
  bf16* tile = reinterpret_cast<bf16*>(sring + 2 * kStages * kKeys);  // {K, V} [kKeys][RS]
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + stream_bytes<D, C>(16 * cw));  // [R][RS]
  float* m_s = reinterpret_cast<float*>(qs + R * RS);  // [R]
  float* l_s = m_s + R;                                // [R]
  float* o_s = reinterpret_cast<float*>(smem_raw);     // [R][PS] after the loop

  // the tile's key range [lo, hi): what some query of its rows can see
  const int rend = min(rows, r0 + R);
  int qmin = 0x7fffffff, qmax = -1;
  for (int i = r0 / g + lane; i <= (rend - 1) / g; i += 32) {
    const int p = a.q_pos[b * tq + i];
    qmin = min(qmin, p);
    qmax = max(qmax, p);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  }
  const int kl = min(a.kv_len[b], kv.reach());
  int lo = 0, hi, ws = 0, wl = 0;
  if constexpr (kTree) {
    ws = a.win_start[b];
    wl = a.win_len[b];
    hi = min(kl, ws + wl);                 // eff_len: never q_pos
    if (window > 0) lo = min(ws, max(0, qmin - window + 1));
  } else {
    hi = min(kl, qmax + 1);
    if (window > 0) lo = max(0, qmin - window + 1);
  }
  lo = lo / kKeys * kKeys;
  const int nchunk = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;
  const int c_begin = split * nchunk / cs;
  const int n = (split + 1) * nchunk / cs - c_begin;

  // this thread's two accumulator rows (gid and gid + 8 of its warp):
  // the key bounds of each, and the tree's ancestor mask. Causal: keys
  // [rlo, rhi). Tree: context keys [rlo, rhi) (rhi = min(hi, ws)) and
  // window keys [ws, whi) whose bit is set in anc. Padding rows (q_pos -1)
  // see no key under the causal mask and context keys under the tree
  // mask; they are never stored.
  const int ra = warp * 16 + (lane >> 2);
  int rlo[2], rhi[2];
  uint32_t anc[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = r0 + ra + 8 * e;
    const bool real = row < rows;
    const int qp = real ? a.q_pos[b * tq + row / g] : -1;
    rlo[e] = window > 0 ? qp - window + 1 : 0;
    if constexpr (kTree) {
      rhi[e] = min(hi, ws);
      anc[e] = real ? a.anc[b * tq + row / g] : 0u;
    } else {
      rhi[e] = min(hi, qp + 1);
      anc[e] = 0u;
    }
  }
  const int whi = min(hi, ws + tq);       // tree window keys: j < wl, j < tq

  auto load_chunk = [&](int c, int stage) {
    const int c0 = lo + c * kKeys;
    const bool run = kv.runs(kKeys);      // keys c0 + j at base + j * hkv * D
    if constexpr (kQ) {
      uint8_t* k8 = ring8 + stage * 2 * kKeys * RS8;
      uint8_t* v8 = k8 + kKeys * RS8;
      float* ksc = sring + stage * 2 * kKeys;
      float* vsc = ksc + kKeys;
      // key p's scale index; its codes start at D times it
      const size_t base = run ? kv.offset(b, c0, h, hkv, 1) : 0;
      auto index = [&](int j) {
        return run ? base + static_cast<size_t>(j) * hkv : kv.offset(b, c0 + j, h, hkv, 1);
      };
      for (int idx = tid; idx < kKeys * SEG8; idx += nthreads) {
        const int j = idx / SEG8, col = (idx % SEG8) * 16;
        const bool in = c0 + j < hi;
        const size_t off = in ? index(j) * D + col : 0;
        cp_async16(k8 + j * RS8 + col, kp8 + off, in);
        cp_async16(v8 + j * RS8 + col, vp8 + off, in);
      }
      for (int j = tid; j < kKeys; j += nthreads) {
        const bool in = c0 + j < hi;
        const size_t so = in ? index(j) : 0;
        cp_async4(ksc + j, a.k_scale + so, in);
        cp_async4(vsc + j, a.v_scale + so, in);
      }
    } else {
      bf16* ks = ring + stage * 2 * kKeys * RS;
      bf16* vs = ks + kKeys * RS;
      const size_t base = run ? kv.offset(b, c0, h, hkv, D) : 0;
      for (int idx = tid; idx < kKeys * SEG; idx += nthreads) {
        const int j = idx / SEG, col = (idx % SEG) * 8;
        const int p = c0 + j;
        const bool in = p < hi;
        size_t off = 0;
        if (in)
          off = (run ? base + static_cast<size_t>(j) * hkv * D : kv.offset(b, p, h, hkv, D)) + col;
        cp_async16(ks + j * RS + col, kp + off, in);
        cp_async16(vs + j * RS + col, vp + off, in);
      }
    }
  };

  // 8-bit codes of a landed stage -> the bf16 tile: K rows 0..63, V rows
  // 64..127 in both
  auto widen_chunk = [&](int stage) {
    const uint8_t* src = ring8 + stage * 2 * kKeys * RS8;
    for (int idx = tid; idx < 2 * kKeys * SEG8; idx += nthreads) {
      const int r = idx / SEG8, col = (idx % SEG8) * 16;
      uint4 w[2];
      widen16<C>(*reinterpret_cast<const uint4*>(src + r * RS8 + col), w);
      uint4* dst = reinterpret_cast<uint4*>(tile + r * RS + col);
      dst[0] = w[0];
      dst[1] = w[1];
    }
  };

  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale = a.scale * kLog2e, softcap = a.softcap;

  if (n > 0) {
    // Q joins the first commit group, with chunk 0
    for (int idx = tid; idx < R * SEG; idx += nthreads) {
      const int r = idx / SEG, col = (idx % SEG) * 8;
      const int row = r0 + r;
      const bool in = row < rows;
      const bf16* src =
          in ? q + ((static_cast<size_t>(b) * tq + row / g) * hq + h * g + row % g) * D + col
             : q;
      cp_async16(qs + r * RS + col, src, in);
    }
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n) load_chunk(c_begin + s, s);
      cp_commit();
    }
    uint32_t qf[KS][4];
    for (int it = 0; it < n; ++it) {
      cp_wait<kStages - 2>();
      __syncthreads();                    // chunk it landed; chunk it - 1 is consumed
      if (it == 0 && warp < cw) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
      }
      if constexpr (kQ) widen_chunk(it % kStages);
      if (it + kStages - 1 < n)
        load_chunk(c_begin + it + kStages - 1, (it + kStages - 1) % kStages);
      cp_commit();
      if constexpr (kQ) __syncthreads(); // the bf16 tile is whole
      if (warp >= cw) continue;           // a copying warp only

      const bf16* ks = kQ ? tile : ring + (it % kStages) * 2 * kKeys * RS;
      const bf16* vs = ks + kKeys * RS;
      // this lane's scales of n-tile j: keys 8 j + 2 (lane % 4) and + 1
      const float* ksc = sring + (it % kStages) * 2 * kKeys + 2 * (lane & 3);
      const float* vsc = ksc + kKeys;
      const int c0 = lo + (c_begin + it) * kKeys;

      // S = Q K^T: 16 rows x 64 keys per warp, n-tile j holds keys 8j..8j+7;
      // per k-step the four K fragments load first, then 8 independent mma's
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kf[4][4];
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2)
          ldsm_x4(kf[j2], ks + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS + kk * 16 +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          mma(s[2 * j2], qf[kk], kf[j2][0], kf[j2][1]);
          mma(s[2 * j2 + 1], qf[kk], kf[j2][2], kf[j2][3]);
        }
      }

      // dequant (k_scale per column), scale and softcap, in log2 units;
      // the mask only where some row of the warp does not see the whole
      // chunk
      if constexpr (kQ) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 sk = *reinterpret_cast<const float2*>(ksc + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= (e & 1) ? sk.y : sk.x;
        }
      }
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = tanhf(s[j][e] * a.scale / softcap) * softcap * kLog2e;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= scale;
      }
      const bool full = c0 >= max(rlo[0], rlo[1]) && c0 + kKeys <= min(rhi[0], rhi[1]);
      if (!__all_sync(0xffffffffu, full)) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1;
            const int p = c0 + 8 * j + 2 * (lane & 3) + (e & 1);
            bool ok = p >= rlo[hr] && p < rhi[hr];
            if constexpr (kTree) {
              const int jw = p - ws;
              // 0 <= jw < tq <= 32 keeps the shift in range
              ok = ok || (p >= ws && p < whi && ((anc[hr] >> jw) & 1u));
            }
            if (!ok) s[j][e] = kNegInf;
          }
        }
      }

      // online softmax per row; a row lives in the quad of lanes 4 gid..
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = m[hr];
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // no key seen yet: subtract 0, so masked scores give 2^-1e30 = 0
        const float base = mx == kNegInf ? 0.f : mx;
        const float alpha = ex2(m[hr] - base);
        m[hr] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j][2 * hr] = ex2(s[j][2 * hr] - base);
          s[j][2 * hr + 1] = ex2(s[j][2 * hr + 1] - base);
          sum += s[j][2 * hr] + s[j][2 * hr + 1];
        }
        l[hr] = l[hr] * alpha + sum;      // this lane's columns; quad sum at the end
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          o[dn][2 * hr] *= alpha;
          o[dn][2 * hr + 1] *= alpha;
        }
      }

      // O += P V: the S accumulator of keys 16 kk .. 16 kk + 15 is the A
      // fragment of k-step kk, rounded to bf16 (quantized: P times v_scale
      // per column, l summed the unscaled P, as a pair hi + lo); V
      // fragments two at a time
      if constexpr (kQ) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 sv = *reinterpret_cast<const float2*>(vsc + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= (e & 1) ? sv.y : sv.x;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4], pl[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {       // f & 1: row gid + 8; f >> 1: keys + 8
          const float* sf = s[2 * kk + (f >> 1)] + 2 * (f & 1);
          if constexpr (kQ)
            split_bf16(sf[0], sf[1], pa[f], pl[f]);
          else
            pa[f] = pack(sf[0], sf[1]);
        }
#pragma unroll
        for (int d2 = 0; d2 < D / 16; d2 += 2) {
          uint32_t vf[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (d2 + u < D / 16)
              ldsm_x4_t(vf[u], vs + (kk * 16 + (lane & 15)) * RS + (d2 + u) * 16 +
                                   (lane >> 4) * 8);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (d2 + u < D / 16) {
              mma(o[2 * (d2 + u)], pa, vf[u][0], vf[u][1]);
              mma(o[2 * (d2 + u) + 1], pa, vf[u][2], vf[u][3]);
              if constexpr (kQ) {
                mma(o[2 * (d2 + u)], pl, vf[u][0], vf[u][1]);
                mma(o[2 * (d2 + u) + 1], pl, vf[u][2], vf[u][3]);
              }
            }
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                        // the ring is free for the partials

  // this CTA's partial (O unnormalized, m, l) per row
#pragma unroll
  for (int hr = 0; hr < 2 && warp < cw; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int r = ra + 8 * hr;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<float2*>(o_s + r * PS + dn * 8 + 2 * (lane & 3)) =
          make_float2(o[dn][2 * hr], o[dn][2 * hr + 1]);
    if ((lane & 3) == 0) {
      m_s[r] = m[hr];
      l_s[r] = l[hr];
    }
  }
  cluster.sync();

  // merge: CTA `split` owns rows [split * per, (split + 1) * per) of the
  // tile and reads the cs partials of each in split order
  const int per = (R + cs - 1) / cs;
  const int rb = split * per, re = min(R, rb + per);
  for (int idx = tid; idx < max(re - rb, 0) * SEG; idx += nthreads) {
    const int r = rb + idx / SEG, col = (idx % SEG) * 8;
    const int row = r0 + r;
    if (row >= rows) continue;
    float mk[kMaxCluster];
    float mmax = kNegInf;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      mk[k] = k < cs ? *cluster.map_shared_rank(m_s + r, k) : kNegInf;
      mmax = fmaxf(mmax, mk[k]);
    }
    const float base = mmax == kNegInf ? 0.f : mmax;
    float lsum = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k < cs) {
        const float w = ex2(mk[k] - base);
        lsum += w * *cluster.map_shared_rank(l_s + r, k);
        const float4* src =
            reinterpret_cast<const float4*>(cluster.map_shared_rank(o_s + r * PS + col, k));
        const float4 x0 = src[0], x1 = src[1];
        acc[0] += w * x0.x; acc[1] += w * x0.y; acc[2] += w * x0.z; acc[3] += w * x0.w;
        acc[4] += w * x1.x; acc[5] += w * x1.y; acc[6] += w * x1.z; acc[7] += w * x1.w;
      }
    }
    const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);   // no key seen: 0
    uint4 packed;
    packed.x = pack(acc[0] * inv, acc[1] * inv);
    packed.y = pack(acc[2] * inv, acc[3] * inv);
    packed.z = pack(acc[4] * inv, acc[5] * inv);
    packed.w = pack(acc[6] * inv, acc[7] * inv);
    *reinterpret_cast<uint4*>(
        out + ((static_cast<size_t>(b) * tq + row / g) * hq + h * g + row % g) * D + col) = packed;
  }
  cluster.sync();                         // no CTA leaves while its partials are read
}

template <int D, bool kTree, class KV, int C>
cudaError_t launch(const attn::Args& a, const KV& kv, int b, int cs, int warps,
                   cudaStream_t stream) {
  auto kern = mma_kernel<D, kTree, KV, C>;
  const int rows = a.tq * (a.hq / a.hkv);
  const int tile = 16 * warps;
  const size_t smem = smem_bytes<D, C>(tile);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, a.hkv * ((rows + tile - 1) / tile), b);
  cfg.blockDim = dim3(32 * kMaxWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a, kv, warps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kTree, class KV, int C>
cudaError_t launch_d(int d, const attn::Args& a, const KV& kv, int b, int cs, int warps,
                     cudaStream_t s) {
  if (d == 32) return launch<32, kTree, KV, C>(a, kv, b, cs, warps, s);
  if (d == 48) return launch<48, kTree, KV, C>(a, kv, b, cs, warps, s);
  if (d == 64) return launch<64, kTree, KV, C>(a, kv, b, cs, warps, s);
  if (d == 128) return launch<128, kTree, KV, C>(a, kv, b, cs, warps, s);
  return cudaErrorInvalidValue;
}

// q in bf16, K/V of dtype code kv_dtype (1 bf16, 2 int8, 3 fp8 e4m3 with
// a.k_scale / a.v_scale); KV is attn::PagedKV or attn::ContigKV; cs and
// warps from split_kv_plan. Returns a cudaError_t (0 = ok).
template <class KV, bool kTree>
int dispatch(const attn::Args& a, const KV& kv, int b, int d, int kv_dtype, int cs, int warps,
             void* stream) {
  if (b <= 0 || a.tq <= 0 || a.hkv <= 0 || a.hq % a.hkv != 0 || cs < 1 || cs > kMaxCluster ||
      warps < 1 || warps > kMaxWarps || (kv_dtype != 1 && (!a.k_scale || !a.v_scale)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (kv_dtype == 1) err = launch_d<kTree, KV, 1>(d, a, kv, b, cs, warps, s);
  if (kv_dtype == 2) err = launch_d<kTree, KV, 2>(d, a, kv, b, cs, warps, s);
  if (kv_dtype == 3) err = launch_d<kTree, KV, 3>(d, a, kv, b, cs, warps, s);
  return static_cast<int>(err);
}

}  // namespace smma
