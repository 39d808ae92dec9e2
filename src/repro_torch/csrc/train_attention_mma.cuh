// Training attention on Hopper's tensor cores (sm_90a): the bfloat16
// instances of the port's full-sequence kernels, forward and backward.
//
//   flash_attention.cu      forward, causal mask (+ window, key count)
//   flash_attention_bwd.cu  backward, causal mask
//   pard_attention.cu       forward, COD mask from per-token (segment, base)
//   pard_attention_bwd.cu   backward, COD mask
//
// They replace the TPU kernels `flash_attention`
// (src/repro/kernels/flash_attention.py) and `pard_attention`
// (src/repro/kernels/pard_attention.py) and the gradients that the JAX
// package takes of them by autodiff. Layouts, masks, the softcap and the
// meaning of a row that sees no key are those of train_attention_tile.cuh,
// which keeps the float32 instances (the exactness check on the card).
//
// What bounds them on an H100: the operations. A (query, key) pair costs
// 4 D FLOPs forward and 10 D backward against bytes read once per tile,
// far above the card's balance point, so the bound is the FLOPs at the
// tensor cores' 989 TFLOP/s (bf16).
//
// The design, and what each part answers in the float32 loop:
//   - Every product runs on the tensor cores as wgmma (m64nNk16, bf16 in,
//     f32 accumulators): S = Q K^T and O += P V forward; S^T = K Q^T,
//     dP^T = V dO^T, dV += P^T dO, dK += dS^T Q, S = Q K^T, dP = dO V^T
//     and dQ += dS K backward. The f32 loop ran them as scalar FMAs on the
//     CUDA cores. Operands from shared memory are K-major (Q, K, V, dO
//     along the head dim) or MN-major through the descriptor's transpose
//     bit (V in P V, dO and Q in the dV and dK products, K in dS K). P and
//     dS come from registers: the S accumulator's layout is the A-operand
//     layout, so they never go through shared memory. P and dS are rounded
//     once for O and dQ; for the long sums of dV and dK they enter as bf16
//     hi + lo pairs (two products each). Every sum is f32.
//   - Tiles stay bf16 in shared memory, in 8 x 8 core matrices (the layout
//     wgmma reads without swizzle; no padding, D = 48 included). The f32
//     loop converted every tile to f32: twice the bytes, and two shared
//     loads per FMA. (A 128-byte swizzle measured no faster.)
//   - Tiles move through rings of two stages filled by 16-byte cp.async
//     (4-byte for per-row words): the next tile's copy is in flight while
//     this tile's products run, with one barrier per tile. The f32 loop
//     loaded, waited, then computed. The forward and dQ blocks give each
//     query head of one kv head its own warpgroup, so one K/V tile in
//     shared memory serves up to four heads (this cut the forward's L2
//     traffic by four and its time by a third).
//   - Tile classes (tattn::kEmpty / kPartial / kFull) in place of the
//     per-tile scan of the mask: causal tiles are classed from their
//     indices, COD tiles read a class table that the wrapper computes from
//     per-64-token summaries (pard_tile_classes). An empty tile costs no
//     copy and no math; a full tile applies no mask; only a partial tile
//     evaluates the mask, on the accumulator fragment by its row and
//     column. The f32 loop tested all 4,096 pairs of every tile, with a
//     block barrier, and then the mask again on every score.
//   - The online softmax keeps m and l per row in registers, in log2 units
//     (log2(e) folded into the scale, ex2.approx); a row is spread over the
//     quad of lanes that holds it. The stored lse is the natural-log value.
//     The softcap and the partial-tile mask are loops of their own, so the
//     element loops are straight-line code.
//
// Blocks: each warpgroup (128 threads) owns a 64-row tile, each warp 16 of
// its rows. Forward and dQ: one block per (64 queries, up to four query
// heads of one kv head, batch row) sweeping the key tiles. dK/dV: one
// block per (64 keys, kv head, batch row); its two warpgroups share K and V
// and take alternate query heads, each sweeping its heads' query tiles and
// summing dK, dV in registers; the two sums meet in shared memory in a
// fixed order. No float atomics anywhere: the gradients are deterministic.
// Grids put the tile index slowest, longest causal sweeps first.
#pragma once

#include <algorithm>
#include <cstdint>

#include "train_attention_tile.cuh"  // tattn::Args, the masks, the Δ pass, the float32 kernels

namespace tmma {

using bf16 = __nv_bfloat16;
using tattn::Args;
using tattn::kTile;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// PTX: async copies, fragments, wgmma
// ---------------------------------------------------------------------------

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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 A fragment of k-step j (columns 16 j .. 16 j + 15) of a flat
// accumulator whose registers 8 j .. 8 j + 7 hold those columns (a wgmma
// accumulator is laid out as its register-sourced A operand)
template <int N>
__device__ __forceinline__ void to_a(const float (&c)[N], int j, uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack(c[8 * j + 2 * i], c[8 * j + 2 * i + 1]);
}

// the same fragment as a bf16 pair hi + lo whose sum holds the f32 values
// to ~16 bits (hi = bf16(x), lo = bf16(x - hi))
template <int N>
__device__ __forceinline__ void split(const float (&c)[N], int j, uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = c[8 * j + 2 * i], x1 = c[8 * j + 2 * i + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack(x0 - __low2float(h), x1 - __high2float(h));
  }
}

// wgmma (sm_90a): one warpgroup computes d[64 x N] (+)= a[64 x 16] b[16 x N]
// with bf16 operands and f32 accumulators. a comes from registers in the
// mma.sync A-fragment layout of each warp's 16 rows; b from shared memory
// through a matrix descriptor; kTransB = 1 reads an MN-major b. d has the
// mma.sync accumulator layout per warp: d[4 i + e] is row 16 w + g + 8 (e / 2),
// column 8 i + 2 tq + e % 2. scale_d = 0 overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kTransB));
  }
};

template <>
struct Wgmma<48> {
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[24], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kTransB));
  }
};

template <>
struct Wgmma<64> {
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kTransB));
  }
};

template <>
struct Wgmma<128> {
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kTransB));
  }
};

// d[64 x N] (+)= a[64 x 16] b[16 x N], a and b K-major in shared memory
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<16> {
  __device__ __forceinline__ static void run(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<32> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching registers of an accumulator before the
// wgmma that writes them has been waited for
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// generic-proxy writes to shared memory (cp.async included) made visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma matrix descriptor without swizzle: start address, the byte
// stride between core matrices along K (LBO) and along M or N (SBO).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo, int sbo) {
  const uint32_t at = smem_u32(p);
  return static_cast<uint64_t>((at & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

// 32-bit words src[i0 .. i0 + kTile) of a row of n into dst[0, step, ..]
// (zero past n), by threads tid of a team of nthreads
__device__ __forceinline__ void copy_words(void* dst, const void* src, int i0, int n, int step,
                                           int tid, int nthreads) {
  for (int r = tid; r < kTile; r += nthreads) {
    const bool in = i0 + r < n;
    cp_async4(static_cast<uint32_t*>(dst) + r * step,
              static_cast<const uint32_t*>(src) + (in ? i0 + r : 0), in);
  }
}

// (segment, base) of tokens i0 .. i0 + kTile - 1 of batch row b, as int2,
// for a mask whose keys carry metadata
template <class M>
__device__ __forceinline__ void copy_meta(int2* dst, const M& m, int b, int i0, int n,
                                          int tid = threadIdx.x, int nthreads = blockDim.x) {
  if constexpr (M::kStaged) {
    copy_words(dst, m.seg + static_cast<size_t>(b) * n, i0, n, 2, tid, nthreads);
    copy_words(reinterpret_cast<int*>(dst) + 1, m.base + static_cast<size_t>(b) * n, i0, n, 2,
               tid, nthreads);
  }
}

// metadata of row i of n (i past n: a row that sees nothing)
template <class M>
__device__ __forceinline__ int2 row_meta(const M& m, int b, int i, int n) {
  return i < n ? m.meta(b, i, n) : make_int2(-1, 0);
}

// metadata of local column c (global index i of n) of a tile whose keys'
// metadata, if any, is staged at st
template <class M>
__device__ __forceinline__ int2 col_meta(const int2* st, int c, int i, int n) {
  if constexpr (M::kStaged)
    return st[c];
  else
    return make_int2(i < n ? i : -1, 0);
}

// cudaFuncSetAttribute once per kernel instance (`done`: its own flags)
// and device
template <typename K>
cudaError_t allow_smem(K kern, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

// ---------------------------------------------------------------------------
// forward: one block per (64 queries, up to four query heads of one kv head,
// batch row), one warpgroup per query head
// ---------------------------------------------------------------------------

// rows r0 .. r0 + kTile - 1 of one head of a [B, n, heads, D] tensor
// (`src`: its row 0, rows `stride` elements apart) into a shared tile of
// 8 x 8 core matrices, the layout that wgmma reads without swizzle: element
// (r, c) at ((r / 8) (D / 8) + c / 8) 64 + (r % 8) 8 + c % 8. Eight
// neighbouring threads of the team (tid of nthreads) fill one core matrix;
// rows past n are zero.
template <int D>
__device__ __forceinline__ void copy_core(bf16* dst, const bf16* src, int r0, int n,
                                          int stride, int tid = threadIdx.x,
                                          int nthreads = kThreads) {
  constexpr int C = D / 8;
  for (int idx = tid; idx < kTile * C; idx += nthreads) {
    const int r8 = idx & 7;
    const int c = (idx >> 3) % C;
    const int rb = (idx >> 3) / C;
    const int row = r0 + rb * 8 + r8;
    const bool in = row < n;
    cp_async16(dst + (rb * C + c) * 64 + r8 * 8,
               src + static_cast<size_t>(in ? row : 0) * stride + c * 8, in);
  }
}

// Stages of the K/V ring (forward, dQ) and of the Q/dO ring (dK/dV): two
// suffice, the next tile's copy overlapping this tile's products (three
// and four measured no faster), and they leave shared memory for several
// blocks per SM.
constexpr int kStages = 2;

// Query heads per forward block: the block's warpgroups take the heads of
// one kv head (up to four, two at D = 128 for the registers), so one K/V
// tile in shared memory serves them all.
template <int D>
__host__ __device__ constexpr int fwd_max_heads() {
  return D > 64 ? 2 : 4;
}

template <int D>
__host__ __device__ constexpr int fwd_smem(int heads) {
  return 2 * kTile * D * (heads + 2 * kStages) + 8 * kStages * kTile;
}

template <int D, class M>
__global__ void __launch_bounds__(kThreads * fwd_max_heads<D>(), 1) fwd_kernel(Args a, M mask) {
  constexpr int C = D / 8;        // core matrices along the head dim
  constexpr int KS = D / 16;      // k-steps over the head dim
  constexpr int NS = kTile / 2;   // score registers per thread (64 x 64 / 128)
  constexpr int NO = D / 2;       // output registers per thread (64 x D / 128)
  const int heads = blockDim.x / kThreads;      // warpgroups, one query head each
  const int wg = threadIdx.x / kThreads;
  const int per_kv = a.hq / a.hkv / heads;      // blocks per kv head
  // the tile index varies slowest and downwards: the blocks with the most
  // causal work start first, across all heads and batch rows
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int hk = blockIdx.x / per_kv;
  const int h = hk * (a.hq / a.hkv) + (blockIdx.x % per_kv) * heads + wg;
  const int b = blockIdx.y;
  const int q0 = qt * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;      // within the warpgroup
  const int g = lane >> 2;
  const int tq = lane & 3;

  extern __shared__ __align__(128) unsigned char shm[];
  bf16* qs = reinterpret_cast<bf16*>(shm) + wg * kTile * D;  // this head's [kTile x D]
  bf16* ks = reinterpret_cast<bf16*>(shm) + heads * kTile * D;  // [kStages][kTile x D]
  bf16* vs = ks + kStages * kTile * D;                         // [kStages][kTile x D]
  int2* ms = reinterpret_cast<int2*>(vs + kStages * kTile * D);  // [kStages][kTile]

  // row 0 of this (batch row, kv head) in k and v, rows a.hkv * D apart
  const size_t kv0 = (static_cast<size_t>(b) * a.s * a.hkv + hk) * D;
  const bf16* K = static_cast<const bf16*>(a.k) + kv0;
  const bf16* V = static_cast<const bf16*>(a.v) + kv0;
  int lo, hi;
  mask.keys(q0, min(q0 + kTile, a.t), a.s, lo, hi);
  const int kt_end = (hi + kTile - 1) / kTile;
  auto next = [&](int kt) {
    do ++kt;
    while (kt < kt_end && mask.tile_class(b, qt, kt, a.t, a.s) == tattn::kEmpty);
    return kt;
  };
  auto fetch = [&](int st, int kt) {
    copy_core<D>(ks + st * kTile * D, K, kt * kTile, a.s, a.hkv * D, threadIdx.x, blockDim.x);
    copy_core<D>(vs + st * kTile * D, V, kt * kTile, a.s, a.hkv * D, threadIdx.x, blockDim.x);
    copy_meta(ms + st * kTile, mask, b, kt * kTile, a.s);
  };

  // the ring: tile kt is computed while the next kStages - 1 are in flight
  int kt = next(lo / kTile - 1);
  int kf = kt;  // the last tile fetched
  if (kt < kt_end) {
    copy_core<D>(qs, static_cast<const bf16*>(a.q) + (static_cast<size_t>(b) * a.t * a.hq + h) * D,
                 q0, a.t, a.hq * D, threadIdx.x % kThreads);
    fetch(0, kt);
  }
  cp_commit();
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) {
    if (kf < kt_end) kf = next(kf);
    if (kf < kt_end) fetch(i, kf);
    cp_commit();
  }

  const int r0 = warp * 16;  // the warp's rows in the tile
  const int2 rm[2] = {row_meta(mask, b, q0 + r0 + g, a.t),
                      row_meta(mask, b, q0 + r0 + g + 8, a.t)};
  const float sl = a.scale * kLog2e;
  const bool cap = a.softcap > 0.f;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the rows, log2 units
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int it = 0; kt < kt_end; ++it) {
    cp_wait<kStages - 2>();  // this tile (and Q) have landed
    fence_async_shared();
    __syncthreads();         // for every thread, and every warp is done with tile it - 1
    if (kf < kt_end) kf = next(kf);
    if (kf < kt_end) fetch((it + kStages - 1) % kStages, kf);
    cp_commit();
    const int st = it % kStages;
    const bf16* kst = ks + st * kTile * D;
    const bf16* vst = vs + st * kTile * D;

    // S = Q K^T on the tensor cores: Q and K are K-major operands in
    // shared memory (core matrices 128 bytes apart along the head dim)
    float s[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      WgmmaSS<kTile>::run(s, gmma_desc(qs + kk * 2 * 64, 128, C * 128),
                          gmma_desc(kst + kk * 2 * 64, 128, C * 128), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // raw scores (the soft cap in units of the dot product), then the
    // per-element mask of a partial tile on the fragment's row and column
    if (cap) {
      const float c_over = a.softcap / a.scale, over_c = a.scale / a.softcap;
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = c_over * tanhf(s[i] * over_c);
    }
    if (mask.tile_class(b, qt, kt, a.t, a.s) == tattn::kPartial) {
      const int k0 = kt * kTile;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = (i >> 2) * 8 + 2 * tq + (i & 1);
        if (!mask.ok(rm[(i >> 1) & 1], col_meta<M>(ms + st * kTile, c, k0 + c, a.s)))
          s[i] = -INFINITY;
      }
    }

    // online softmax: the row max over the quad, then P = 2^(s sl - m)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float sub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl);
      sub[r] = m_new == -INFINITY ? 0.f : m_new;  // a row that has seen nothing
      const float alpha = ex2(m[r] - sub[r]);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < NO; ++i)
        if (((i >> 1) & 1) == r) o[i] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] = ex2(fmaf(s[i], sl, -sub[(i >> 1) & 1]));
      l[(i >> 1) & 1] += s[i];
    }

    // O += P V: P from registers as bf16 (the S accumulator is already the
    // A-fragment layout), V the MN-major B operand
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) to_a(s, j, pa[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j)
      Wgmma<D>::template rs<1>(o, pa[j], gmma_desc(vst + j * 2 * C * 64, C * 128, 128), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    kt = next(kt);
  }

  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + r0 + g + 8 * r;
    if (row >= a.t) continue;
    const bool seen = l[r] > 0.f;
    const float inv = seen ? 1.f / l[r] : 0.f;
    bf16* dst = out + ((static_cast<size_t>(b) * a.t + row) * a.hq + h) * D + 2 * tq;
#pragma unroll
    for (int db = 0; db < D / 8; ++db)
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(o[4 * db + 2 * r] * inv, o[4 * db + 2 * r + 1] * inv);
    if (tq == 0)
      a.lse[(static_cast<size_t>(b) * a.hq + h) * a.t + row] =
          seen ? (m[r] + log2f(l[r])) * kLn2 : 0.f;
  }
}

// ---------------------------------------------------------------------------
// backward: dK/dV, one block per (64 keys, kv head, batch row), two
// warpgroups
// ---------------------------------------------------------------------------

// Query columns per product of the dK/dV pass: few keep S^T and dP^T small
// beside dK and dV, so that two blocks fit an SM's registers (D <= 64).
constexpr int kKvSub = 16;

// Warpgroups per dK/dV block: each takes its share of the G query heads
// (heads w, w + n, ..), so the longest block's sweep is n times shorter;
// their dK, dV sums meet in shared memory at the end, in a fixed order.
constexpr int kKvGroups = 2;

// bytes of one warpgroup's ring: (Q, dO) tiles and (lse, delta, (segment,
// base)) words
template <int D>
__host__ __device__ constexpr int dkdv_ring() {
  return 2 * kTile * D * 2 * kStages + 4 * kStages * 4 * kTile;
}

// K, V once, and a ring per warpgroup
template <int D>
__host__ __device__ constexpr int dkdv_smem(int groups) {
  return 2 * kTile * D * 2 + groups * dkdv_ring<D>();
}

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kThreads) : "memory");
}

template <int D, class M>
__global__ void __launch_bounds__(kThreads * kKvGroups, D > 64 ? 1 : 2)
    dkdv_kernel(Args a, M mask) {
  constexpr int C = D / 8;
  constexpr int KS = D / 16;
  constexpr int SUB = kKvSub;
  constexpr int NS = SUB / 2;     // S^T registers per thread per product (64 x SUB / 128)
  constexpr int NO = D / 2;       // dK, dV registers per thread (64 x D / 128)
  const int groups = blockDim.x / kThreads;
  const int wg = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads;
  const int kt = blockIdx.z;  // slowest: the key tiles with the most causal work first
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = kt * kTile;
  const int grp = a.hq / a.hkv;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
  const int g = lane >> 2;
  const int tq = lane & 3;

  extern __shared__ __align__(128) unsigned char shm[];
  bf16* ks = reinterpret_cast<bf16*>(shm);  // [kTile x D] core matrices, keys
  bf16* vs = ks + kTile * D;                 // [kTile x D]
  unsigned char* ring = shm + 2 * kTile * D * 2 + wg * dkdv_ring<D>();
  bf16* qs = reinterpret_cast<bf16*>(ring);  // [kStages][kTile x D] queries
  bf16* dos = qs + kStages * kTile * D;      // [kStages][kTile x D]
  // [kStages][4][kTile]: lse, delta (f32), then (segment, base) as int2
  float* words = reinterpret_cast<float*>(dos + kStages * kTile * D);

  const bf16* Q = static_cast<const bf16*>(a.q);
  const bf16* dO = static_cast<const bf16*>(a.dout);
  int lo, hi;
  mask.queries(k0, min(k0 + kTile, a.s), a.t, lo, hi);
  const int qt_lo = lo / kTile;
  const int nq = max(0, (hi + kTile - 1) / kTile - qt_lo);
  // this warpgroup's items: item it is head hk G + (it / nq) groups + wg,
  // query tile qt_lo + it % nq
  const int items = grp / groups * nq;
  auto next = [&](int it) {
    do ++it;
    while (it < items &&
           mask.tile_class(b, qt_lo + it % nq, kt, a.t, a.s) == tattn::kEmpty);
    return it;
  };
  auto fetch = [&](int st, int it) {
    const int h = hk * grp + (it / nq) * groups + wg;
    const int c0 = (qt_lo + it % nq) * kTile;
    const size_t q0 = (static_cast<size_t>(b) * a.t * a.hq + h) * D;
    copy_core<D>(qs + st * kTile * D, Q + q0, c0, a.t, a.hq * D, tid);
    copy_core<D>(dos + st * kTile * D, dO + q0, c0, a.t, a.hq * D, tid);
    float* w = words + st * 4 * kTile;
    const size_t row = (static_cast<size_t>(b) * a.hq + h) * a.t;
    copy_words(w, a.lse + row, c0, a.t, 1, tid, kThreads);
    copy_words(w + kTile, a.delta + row, c0, a.t, 1, tid, kThreads);
    copy_meta(reinterpret_cast<int2*>(w + 2 * kTile), mask, b, c0, a.t, tid, kThreads);
  };

  // K and V for the whole block, then each warpgroup's ring: item it is
  // computed while the next kStages - 1 are in flight
  if (nq > 0) {
    const size_t kv0 = (static_cast<size_t>(b) * a.s * a.hkv + hk) * D;
    copy_core<D>(ks, static_cast<const bf16*>(a.k) + kv0, k0, a.s, a.hkv * D, threadIdx.x,
                 blockDim.x);
    copy_core<D>(vs, static_cast<const bf16*>(a.v) + kv0, k0, a.s, a.hkv * D, threadIdx.x,
                 blockDim.x);
  }
  cp_commit();
  int it = next(-1);
  int itf = it;  // the last item fetched
  if (it < items) fetch(0, it);
  cp_commit();
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) {
    if (itf < items) itf = next(itf);
    if (itf < items) fetch(i, itf);
    cp_commit();
  }
  cp_wait<kStages - 1>();  // K and V
  fence_async_shared();
  __syncthreads();

  const int r0 = warp * 16;  // the warp's keys in the tile
  const int2 km[2] = {row_meta(mask, b, k0 + r0 + g, a.s),
                      row_meta(mask, b, k0 + r0 + g + 8, a.s)};
  const float sl = a.scale * kLog2e;
  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;

  for (int n = 0; it < items; ++n) {
    cp_wait<kStages - 2>();
    fence_async_shared();
    group_sync(wg);  // for every thread of the group, which is done with item n - 1
    if (itf < items) itf = next(itf);
    if (itf < items) fetch((n + kStages - 1) % kStages, itf);
    cp_commit();
    const int st = n % kStages;
    const int qt = qt_lo + it % nq;
    const int c0 = qt * kTile;
    const bool partial = mask.tile_class(b, qt, kt, a.t, a.s) == tattn::kPartial;
    const bf16* qst = qs + st * kTile * D;
    const bf16* dost = dos + st * kTile * D;
    const float* lse_s = words + st * 4 * kTile;
    const float* dl_s = lse_s + kTile;
    const int2* meta_s = reinterpret_cast<const int2*>(lse_s + 2 * kTile);

#pragma unroll
    for (int sub = 0; sub < kTile; sub += SUB) {
      // S^T = K Q^T and dP^T = V dO^T: rows are the keys (the warp's g,
      // g + 8), columns the queries sub + 8 (i / 4) + 2 tq + i % 2
      float sT[NS], dpT[NS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        WgmmaSS<SUB>::run(sT, gmma_desc(ks + kk * 2 * 64, 128, C * 128),
                          gmma_desc(qst + sub * D + kk * 2 * 64, 128, C * 128), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        WgmmaSS<SUB>::run(dpT, gmma_desc(vs + kk * 2 * 64, 128, C * 128),
                          gmma_desc(dost + sub * D + kk * 2 * 64, 128, C * 128), kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(sT);
      fence_regs(dpT);

      // P^T = 2^(x - lse), dS^T = scale P^T (dP^T - delta) [(1 - tanh^2)];
      // the uniform branches stay outside the element loops, so that the
      // loops are straight-line code
      if (a.softcap > 0.f) {
        const float over_c = a.scale / a.softcap, cl = a.softcap * kLog2e;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int c = sub + (i >> 2) * 8 + 2 * tq + (i & 1);
          const float th = tanhf(sT[i] * over_c);
          const float p = ex2(th * cl - lse_s[c] * kLog2e);
          sT[i] = p;
          dpT[i] = p * (dpT[i] - dl_s[c]) * (1.f - th * th) * a.scale;
        }
      } else {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int c = sub + (i >> 2) * 8 + 2 * tq + (i & 1);
          const float p = ex2(sT[i] * sl - lse_s[c] * kLog2e);
          sT[i] = p;
          dpT[i] = p * (dpT[i] - dl_s[c]) * a.scale;
        }
      }
      if (partial) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int c = sub + (i >> 2) * 8 + 2 * tq + (i & 1);
          const bool ok = mask.ok(col_meta<M>(meta_s, c, c0 + c, a.t), km[(i >> 1) & 1]);
          sT[i] = ok ? sT[i] : 0.f;
          dpT[i] = ok ? dpT[i] : 0.f;
        }
      }

      // dV += P^T dO, dK += dS^T Q over these queries: dO and Q are the
      // MN-major B operands. These sums run over the G heads' queries: P^T
      // and dS^T enter as bf16 hi + lo pairs (two products each), since one
      // bf16 rounding per term moved dK and dV by up to 3 bf16 ulps from the
      // f32 sums.
      uint32_t ph[SUB / 16][4], pl[SUB / 16][4], dh[SUB / 16][4], dlo[SUB / 16][4];
#pragma unroll
      for (int j = 0; j < SUB / 16; ++j) {
        split(sT, j, ph[j], pl[j]);
        split(dpT, j, dh[j], dlo[j]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < SUB / 16; ++j) {
        const uint64_t d_do = gmma_desc(dost + (sub + 16 * j) * D, C * 128, 128);
        const uint64_t d_q = gmma_desc(qst + (sub + 16 * j) * D, C * 128, 128);
        Wgmma<D>::template rs<1>(dv, ph[j], d_do, 1);
        Wgmma<D>::template rs<1>(dv, pl[j], d_do, 1);
        Wgmma<D>::template rs<1>(dk, dh[j], d_q, 1);
        Wgmma<D>::template rs<1>(dk, dlo[j], d_q, 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(dv);
      fence_regs(dk);
    }
    it = next(it);
  }

  // the groups' sums meet in group 0, in a fixed order: deterministic
  cp_wait<0>();
  __syncthreads();  // every ring is idle
  float* part = reinterpret_cast<float*>(shm + 2 * kTile * D * 2);  // [2][NO][kThreads]
  for (int w = 1; w < groups; ++w) {
    if (wg == w) {
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        part[i * kThreads + tid] = dk[i];
        part[(NO + i) * kThreads + tid] = dv[i];
      }
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        dk[i] += part[i * kThreads + tid];
        dv[i] += part[(NO + i) * kThreads + tid];
      }
    }
    __syncthreads();
  }
  if (wg != 0) return;

  bf16* dkp = static_cast<bf16*>(a.dk);
  bf16* dvp = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + r0 + g + 8 * r;
    if (row >= a.s) continue;
    const size_t off = ((static_cast<size_t>(b) * a.s + row) * a.hkv + hk) * D + 2 * tq;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + off + db * 8) =
          __floats2bfloat162_rn(dk[4 * db + 2 * r], dk[4 * db + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + off + db * 8) =
          __floats2bfloat162_rn(dv[4 * db + 2 * r], dv[4 * db + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dQ, one block (one warpgroup) per (64 queries, q head, batch row)
// ---------------------------------------------------------------------------

// Query heads per dQ block: as in the forward, the block's warpgroups take
// query heads of one kv head and share each K/V tile.
template <int D>
__host__ __device__ constexpr int dq_max_heads() {
  return D > 64 ? 2 : 4;
}

template <int D>
__host__ __device__ constexpr int dq_smem(int heads) {
  return 2 * kTile * D * (2 * heads + 2 * kStages) + 8 * kStages * kTile;
}

template <int D, class M>
__global__ void __launch_bounds__(kThreads * dq_max_heads<D>(), 1) dq_kernel(Args a, M mask) {
  constexpr int C = D / 8;
  constexpr int KS = D / 16;
  constexpr int NS = kTile / 2;
  constexpr int NO = D / 2;
  const int heads = blockDim.x / kThreads;      // warpgroups, one query head each
  const int wg = threadIdx.x / kThreads;
  const int per_kv = a.hq / a.hkv / heads;      // blocks per kv head
  const int qt = gridDim.z - 1 - blockIdx.z;    // slowest: the longest causal rows first
  const int hk = blockIdx.x / per_kv;
  const int h = hk * (a.hq / a.hkv) + (blockIdx.x % per_kv) * heads + wg;
  const int b = blockIdx.y;
  const int q0 = qt * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;      // within the warpgroup
  const int g = lane >> 2;
  const int tq = lane & 3;

  extern __shared__ __align__(128) unsigned char shm[];
  bf16* qs = reinterpret_cast<bf16*>(shm) + wg * 2 * kTile * D;  // this head's queries
  bf16* dos = qs + kTile * D;                                     // and its dO rows
  bf16* ks = reinterpret_cast<bf16*>(shm) + heads * 2 * kTile * D;  // [kStages][kTile x D]
  bf16* vs = ks + kStages * kTile * D;                              // [kStages][kTile x D]
  int2* ms = reinterpret_cast<int2*>(vs + kStages * kTile * D);  // [kStages][kTile]

  const size_t kv0 = (static_cast<size_t>(b) * a.s * a.hkv + hk) * D;
  const bf16* K = static_cast<const bf16*>(a.k) + kv0;
  const bf16* V = static_cast<const bf16*>(a.v) + kv0;
  int lo, hi;
  mask.keys(q0, min(q0 + kTile, a.t), a.s, lo, hi);
  const int kt_end = (hi + kTile - 1) / kTile;
  auto next = [&](int kt) {
    do ++kt;
    while (kt < kt_end && mask.tile_class(b, qt, kt, a.t, a.s) == tattn::kEmpty);
    return kt;
  };
  auto fetch = [&](int st, int kt) {
    copy_core<D>(ks + st * kTile * D, K, kt * kTile, a.s, a.hkv * D, threadIdx.x, blockDim.x);
    copy_core<D>(vs + st * kTile * D, V, kt * kTile, a.s, a.hkv * D, threadIdx.x, blockDim.x);
    copy_meta(ms + st * kTile, mask, b, kt * kTile, a.s);
  };

  int kt = next(lo / kTile - 1);
  int kf = kt;  // the last tile fetched
  if (kt < kt_end) {
    const size_t qh0 = (static_cast<size_t>(b) * a.t * a.hq + h) * D;
    copy_core<D>(qs, static_cast<const bf16*>(a.q) + qh0, q0, a.t, a.hq * D,
                 threadIdx.x % kThreads);
    copy_core<D>(dos, static_cast<const bf16*>(a.dout) + qh0, q0, a.t, a.hq * D,
                 threadIdx.x % kThreads);
    fetch(0, kt);
  }
  cp_commit();
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) {
    if (kf < kt_end) kf = next(kf);
    if (kf < kt_end) fetch(i, kf);
    cp_commit();
  }

  const int r0 = warp * 16;
  const int2 rm[2] = {row_meta(mask, b, q0 + r0 + g, a.t),
                      row_meta(mask, b, q0 + r0 + g + 8, a.t)};
  const float sl = a.scale * kLog2e;
  float lse2[2], dl[2];  // the rows' lse (log2 units) and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    const size_t at = (static_cast<size_t>(b) * a.hq + h) * a.t + row;
    lse2[r] = row < a.t ? a.lse[at] * kLog2e : 0.f;
    dl[r] = row < a.t ? a.delta[at] : 0.f;
  }
  float dq[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;

  for (int it = 0; kt < kt_end; ++it) {
    cp_wait<kStages - 2>();
    fence_async_shared();
    __syncthreads();
    if (kf < kt_end) kf = next(kf);
    if (kf < kt_end) fetch((it + kStages - 1) % kStages, kf);
    cp_commit();
    const int st = it % kStages;
    const bf16* kst = ks + st * kTile * D;
    const bf16* vst = vs + st * kTile * D;

    // S = Q K^T, dP = dO V^T: all four K-major in shared memory
    float s[NS], dp[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      WgmmaSS<kTile>::run(s, gmma_desc(qs + kk * 2 * 64, 128, C * 128),
                          gmma_desc(kst + kk * 2 * 64, 128, C * 128), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      WgmmaSS<kTile>::run(dp, gmma_desc(dos + kk * 2 * 64, 128, C * 128),
                          gmma_desc(vst + kk * 2 * 64, 128, C * 128), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // dS = scale P (dP - delta) [(1 - tanh^2)], P = 2^(x - lse); the uniform
    // branches stay outside the element loops
    if (a.softcap > 0.f) {
      const float over_c = a.scale / a.softcap, cl = a.softcap * kLog2e;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1;
        const float th = tanhf(s[i] * over_c);
        s[i] = ex2(th * cl - lse2[r]) * (dp[i] - dl[r]) * (1.f - th * th) * a.scale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2(s[i] * sl - lse2[r]) * (dp[i] - dl[r]) * a.scale;
      }
    }
    if (mask.tile_class(b, qt, kt, a.t, a.s) == tattn::kPartial) {
      const int k0 = kt * kTile;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = (i >> 2) * 8 + 2 * tq + (i & 1);
        s[i] = mask.ok(rm[(i >> 1) & 1], col_meta<M>(ms + st * kTile, c, k0 + c, a.s)) ? s[i]
                                                                                       : 0.f;
      }
    }

    // dQ += dS K: dS from registers as bf16, K the MN-major B operand
    uint32_t da[kTile / 16][4];
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) to_a(s, j, da[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j)
      Wgmma<D>::template rs<1>(dq, da[j], gmma_desc(kst + j * 16 * D, C * 128, 128), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(dq);
    kt = next(kt);
  }

  bf16* dqp = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= a.t) continue;
    bf16* dst = dqp + ((static_cast<size_t>(b) * a.t + row) * a.hq + h) * D + 2 * tq;
#pragma unroll
    for (int db = 0; db < D / 8; ++db)
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(dq[4 * db + 2 * r], dq[4 * db + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// the query heads of one kv head that a block takes: the largest of
// most, most / 2, .., 1 that divides G
inline int heads_per_block(int grp, int most) {
  int n = most;
  while (grp % n) n /= 2;
  return n;
}

template <int D, class M>
cudaError_t fwd_launch(const Args& a, const M& m, cudaStream_t st) {
  static bool done[kMaxDevices];
  cudaError_t err = allow_smem(fwd_kernel<D, M>, fwd_smem<D>(fwd_max_heads<D>()), done);
  if (err != cudaSuccess) return err;
  const int heads = heads_per_block(a.hq / a.hkv, fwd_max_heads<D>());
  dim3 grid(a.hq / heads, a.b, (a.t + kTile - 1) / kTile);
  fwd_kernel<D, M><<<grid, kThreads * heads, fwd_smem<D>(heads), st>>>(a, m);
  return cudaGetLastError();
}

template <int D, class M>
cudaError_t bwd_launch(const Args& a, const M& m, cudaStream_t st) {
  cudaError_t err = tattn::delta_launch<bf16, D>(a, st);
  if (err != cudaSuccess) return err;

  static bool kv_done[kMaxDevices];
  err = allow_smem(dkdv_kernel<D, M>, dkdv_smem<D>(kKvGroups), kv_done);
  if (err != cudaSuccess) return err;
  const int groups = heads_per_block(a.hq / a.hkv, kKvGroups);
  dim3 kv_grid(a.hkv, a.b, (a.s + kTile - 1) / kTile);
  dkdv_kernel<D, M><<<kv_grid, kThreads * groups, dkdv_smem<D>(groups), st>>>(a, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static bool q_done[kMaxDevices];
  err = allow_smem(dq_kernel<D, M>, dq_smem<D>(dq_max_heads<D>()), q_done);
  if (err != cudaSuccess) return err;
  const int heads = heads_per_block(a.hq / a.hkv, dq_max_heads<D>());
  dim3 q_grid(a.hq / heads, a.b, (a.t + kTile - 1) / kTile);
  dq_kernel<D, M><<<q_grid, kThreads * heads, dq_smem<D>(heads), st>>>(a, m);
  return cudaGetLastError();
}

// dtype codes: 0 = float32 (train_attention_tile.cuh), 1 = bfloat16 (the
// tensor cores). Returns a cudaError_t (0 = ok).
template <bool kBackward, class M>
int dispatch(const Args& a, const M& m, int d, int dtype, void* stream) {
  if (a.b <= 0 || a.t <= 0 || a.s <= 0 || a.hkv <= 0 || a.hq % a.hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(tattn::launch_f32<kBackward>(a, m, d, st));
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
#define TMMA_CASE(DD)                                            \
  if (d == DD) {                                                 \
    if constexpr (kBackward)                                     \
      return static_cast<int>(bwd_launch<DD, M>(a, m, st));      \
    else                                                         \
      return static_cast<int>(fwd_launch<DD, M>(a, m, st));      \
  }
  TMMA_CASE(32)
  TMMA_CASE(48)
  TMMA_CASE(64)
  TMMA_CASE(128)
#undef TMMA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// the largest dynamic shared memory of the bfloat16 kernels at head dim d
// (forward, or the dK/dV and dQ passes), in bytes; 0 for a head dim not built
inline int smem_bytes(bool backward, int d) {
#define TMMA_SMEM(DD) \
  if (d == DD)                                                                       \
    return backward ? std::max(dkdv_smem<DD>(kKvGroups), dq_smem<DD>(dq_max_heads<DD>()))       \
                    : fwd_smem<DD>(fwd_max_heads<DD>());
  TMMA_SMEM(32)
  TMMA_SMEM(48)
  TMMA_SMEM(64)
  TMMA_SMEM(128)
#undef TMMA_SMEM
  return 0;
}

}  // namespace tmma
