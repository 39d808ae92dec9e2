// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `ssd_chunked_kernel` in src/repro/kernels/ssd.py
// (wrapper ops.ssd_chunked): every Mamba2 layer's window scan of the
// port's model, and every state gather of the speculative steps.
//
//   x           [b, t, h, P]   float32 or bfloat16
//   dt          [b, t, h]      float32 (after softplus)
//   A           [h]            float32 (negative)
//   B, C        [b, t, N]      x's dtype, shared across heads
//   init_state  [b, h, P, N]   float32, or null for zeros
//   y           [b, t, h, P]   x's dtype
//   state       [b, h, P, N]   float32 final state
//
// The state S [P, N] of each (batch row, head) is carried in f32 through
// the chunks of L tokens, starting from init_state. Per chunk:
//
//   cum = cumsum(dt A)
//   y   = ((C B^T) o exp(cum_i - cum_j) o [j <= i]) @ (dt x)  +  (C S^T) exp(cum)
//   S   = S exp(cum_L) + (x dt exp(cum_L - cum))^T B
//
// y takes the state from before the chunk's update; exp is evaluated only
// where j <= i (the masked side overflows). Tokens at or past t load as
// x = B = C = 0 and dt = 0: the TPU wrapper's padding, done in the loads.
// A token with dt = 0 multiplies S by exp(0) = 1 and adds 0, so a padded or
// dt-masked tail leaves the state bit for bit as it was.
//
// Two routes, chosen by dtype in ssd_chunked() below.
//
// float32 (x, B, C f32): ssd::ssd_kernel, one 256-thread block per (row,
// head) with S, the chunk's x, B, C and the gated [L, L] matrix in shared
// memory, every product an f32 FMA on the CUDA cores.
//
// bfloat16 (x, B, C bf16): ssd::mma_kernel. What bounds the scan on an
// H100, and what this route does about it:
//
//   - The serving windows (mamba2-130m: b 4, h 24, P 64, N 128; t = 9 or
//     16, one chunk) move 6.3 MB, mostly the f32 state in and out, and do
//     ~28 M multiply-adds: 1.95 us of bytes. The f32 loop took 32 us there,
//     bound by latency and occupancy: 96 blocks on 132 SMs, a serial prefix
//     on one thread, dependent FMA chains of N + L from shared memory,
//     4-byte state accesses. Here one CTA of 4 warps takes a (row, head,
//     16-row block of P): 384 CTAs at those shapes, several per SM. The
//     CTA's state slice S [16, 64 NK] (NK = 1 for N <= 64, 2 for N <= 128)
//     lives in mma.sync m16n8 f32 accumulators, warp w holding columns
//     16 NK w .. 16 NK (w + 1) - 1 (16 floats a thread at N = 128); it is
//     read from init_state and written to state once per call, in 16-byte
//     accesses through shared memory, and never leaves f32 in between.
//     Each warp takes the chunk's log-decay prefix itself, as a shuffle
//     scan over token pairs (in token order), into its own shared slots.
//   - At t = 2048 (32 chunks of 64) the f32 loop was bound by CUDA-core
//     FMA throughput from shared memory (3.26 ms, 177x the 18 us the bytes
//     take). Here every product runs on the tensor cores as bf16
//     mma.sync.m16n8k16 with f32 accumulators:
//       C B^T   [L x L over N]: both operands are bf16 inputs, so the
//               products are exact; warp m takes token rows 16 m .. 16 m
//               + 15 and only the key tiles j <= i;
//       G x     dt is folded into G (G_ij = exp(cum_i - cum_j) dt_j
//               (C B^T)_ij for j <= i, else 0), so x stays an exact bf16
//               operand; G, f32, goes in as a bf16 pair hi + lo straight
//               from its accumulator registers (A fragments);
//       C S^T   C exact, S as hi + lo, each warp over its own columns; the
//               four partials are summed through shared memory in warp
//               order 0, 1, 2, 3 (no atomics: two calls are bitwise equal
//               and a call replays in a CUDA graph); at 64-token chunks
//               they overwrite the chunk's C tile, so that three CTAs share
//               an SM;
//       update  (u x)^T B with u_j = dt_j exp(cum_L - cum_j): B exact, the
//               scaled x as hi + lo, accumulated straight into the state
//               fragments after they are scaled by exp(cum_L).
//     No f32 operand is rounded to a single bf16: hi = bf16(v), lo =
//     bf16(v - hi) hold v to ~2^-16 relative, as dV / dK in
//     train_attention_mma.cuh. A token with dt = 0 makes u_j = 0 and
//     G_.j = 0, so its products are exact zeros.
//   - The chunk's x slice [L, 16], B and C [L, N] and dt go to shared
//     memory through a two-stage cp.async ring: chunk c + 1 loads while
//     chunk c computes. B and C are shared by all heads; every CTA of a
//     row reads them, from L2 after the first. Shared memory: 22.9 KB a
//     CTA at 16-token chunks, 74.5 KB at 64 (N = 128).
//   - What is left: at t = 9 the state's round trip (in, then out after
//     the chunk's dependent products) and the launch; at t = 2048 the 32
//     dependent chunks of each CTA, two or three barriers and a copy wait
//     apiece.
//   - Ragged edges are zero-filled in the loads: P past a 16-row block, N
//     past 64 NK, token rows past L in the 16-row mma tiles (L 8 .. 64
//     runs in MT = 1, 2 or 4 tiles of 16 rows) and tokens past t. Shapes
//     need P and N multiples of 8 (16-byte copies), N <= 128, and 16-byte
//     aligned x, B, C and states; the wrapper raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_mma.cuh"

namespace ssd {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* s0;
  void* y;
  float* state;
  int b, t, h, p, n, chunk;
};

// ---------------------------------------------------------------------------
// float32 route
// ---------------------------------------------------------------------------

// shared floats: S [P][N+1], x [L][P], B [L][N+1], C [L][N], G [L][L],
// cum [L], w [L] (rows padded by one float against bank conflicts)
inline size_t smem_floats(int p, int n, int l) {
  return static_cast<size_t>(p) * (n + 1) + static_cast<size_t>(l) * p +
         static_cast<size_t>(l) * (n + 1) + static_cast<size_t>(l) * n +
         static_cast<size_t>(l) * l + 2 * static_cast<size_t>(l);
}

__global__ void __launch_bounds__(kThreads) ssd_kernel(Args a) {
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int P = a.p, N = a.n, L = a.chunk, H = a.h, t = a.t;
  const int tid = threadIdx.x;
  const float* __restrict__ x = static_cast<const float*>(a.x);
  const float* __restrict__ Bm = static_cast<const float*>(a.B);
  const float* __restrict__ Cm = static_cast<const float*>(a.C);
  float* __restrict__ y = static_cast<float*>(a.y);
  const float A = a.A[hh];

  extern __shared__ float smem[];
  float* S = smem;                          // [P][N + 1]
  float* xs = S + P * (N + 1);              // [L][P]
  float* Bs = xs + L * P;                   // [L][N + 1]
  float* Cs = Bs + L * (N + 1);             // [L][N]
  float* G = Cs + L * N;                    // [L][L]
  float* cum = G + L * L;                   // [L]
  float* wd = cum + L;                      // [L]: dt_j exp(cum_L - cum_j), then dt_j

  const size_t sbase = (static_cast<size_t>(bb) * H + hh) * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    S[(e / N) * (N + 1) + e % N] = a.s0 ? a.s0[sbase + e] : 0.f;

  for (int t0 = 0; t0 < t; t0 += L) {
    // stage the chunk; tokens past t are zero (dt = 0)
    for (int e = tid; e < L * P; e += kThreads) {
      const int l = e / P, pp = e % P;
      const int tok = t0 + l;
      xs[e] = tok < t ? x[((static_cast<size_t>(bb) * t + tok) * H + hh) * P + pp] : 0.f;
    }
    for (int e = tid; e < L * N; e += kThreads) {
      const int l = e / N, nn = e % N;
      const int tok = t0 + l;
      const size_t off = (static_cast<size_t>(bb) * t + tok) * N + nn;
      Bs[l * (N + 1) + nn] = tok < t ? Bm[off] : 0.f;
      Cs[l * N + nn] = tok < t ? Cm[off] : 0.f;
    }
    for (int l = tid; l < L; l += kThreads) {
      const int tok = t0 + l;
      wd[l] = tok < t ? a.dt[(static_cast<size_t>(bb) * t + tok) * H + hh] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {             // the chunk's log-decay prefix, in token order
      float c = 0.f;
      for (int l = 0; l < L; ++l) {
        c += wd[l] * A;
        cum[l] = c;
      }
    }
    __syncthreads();

    // G[i][j] = exp(cum_i - cum_j) dt_j (C_i . B_j) for j <= i, else 0
    for (int e = tid; e < L * L; e += kThreads) {
      const int i = e / L, j = e % L;
      float g = 0.f;
      if (j <= i) {
        float dot = 0.f;
        for (int nn = 0; nn < N; ++nn) dot = fmaf(Cs[i * N + nn], Bs[j * (N + 1) + nn], dot);
        g = expf(cum[i] - cum[j]) * wd[j] * dot;
      }
      G[e] = g;
    }
    __syncthreads();

    // y[i][p] = sum_{j <= i} G[i][j] x[j][p] + exp(cum_i) sum_n C[i][n] S[p][n]
    for (int e = tid; e < L * P; e += kThreads) {
      const int i = e / P, pp = e % P;
      const int tok = t0 + i;
      if (tok >= t) continue;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(G[i * L + j], xs[j * P + pp], intra);
      float st = 0.f;
      for (int nn = 0; nn < N; ++nn) st = fmaf(Cs[i * N + nn], S[pp * (N + 1) + nn], st);
      y[((static_cast<size_t>(bb) * t + tok) * H + hh) * P + pp] = intra + st * expf(cum[i]);
    }
    __syncthreads();            // every read of S and of wd as dt is done

    const float last = cum[L - 1];
    for (int l = tid; l < L; l += kThreads) wd[l] *= expf(last - cum[l]);
    __syncthreads();

    // S[p][n] = S[p][n] exp(cum_L) + sum_j w_j x[j][p] B[j][n]
    const float decay = expf(last);
    for (int e = tid; e < P * N; e += kThreads) {
      const int pp = e / N, nn = e % N;
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(wd[j] * xs[j * P + pp], Bs[j * (N + 1) + nn], acc);
      float* s = S + pp * (N + 1) + nn;
      *s = fmaf(*s, decay, acc);
    }
    __syncthreads();            // the next chunk overwrites the staged tiles
  }

  for (int e = tid; e < P * N; e += kThreads)
    a.state[sbase + e] = S[(e / N) * (N + 1) + e % N];
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.p, a.n, a.chunk) * sizeof(float);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.h, a.b);
  ssd_kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 route: the tensor cores (fragment helpers in ssd_mma.cuh)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kPBlock = 16;            // rows of P per CTA
// bf16 row stride of the staged x slice: unpadded (its ldmatrix reads
// meet 2-way bank conflicts), so that three CTAs share an SM at chunk 64
constexpr int kXS = kPBlock;
constexpr int kYS = kPBlock + 1;       // f32 row stride of the y partials

// One chunk's staged tiles, R = 16 MT token rows (rows past L or t are
// zero), in two stages; then the y partials [4][R][kYS] f32 where they do
// not fit in the stage's C tile, and each warp's cum [R] and u [R].
template <int NK, int MT>
struct Tiles {
  static constexpr int NW = 64 * NK;             // state columns of the CTA
  static constexpr int BS = NW + 8;              // bf16 row stride of B and C
  static constexpr int R = 16 * MT;
  static constexpr int kX = 0;                                   // x [R][kXS]
  static constexpr int kB = kX + 2 * R * kXS;                    // B [R][BS]
  static constexpr int kC = kB + 2 * R * BS;                     // C [R][BS]
  static constexpr int kDt = kC + 2 * R * BS;                    // dt [R] f32
  static constexpr int kStage = kDt + 4 * R;                     // bytes, 16-aligned
  // C is read by nothing after the C S^T partials, so at 64-token chunks
  // and N = 128 the partials take its place (a row of them is 272 bytes, as
  // is a row of C), for one more barrier a chunk: 74.5 KB a CTA instead of
  // 91.5 KB, three CTAs per SM instead of two (384 CTAs in one wave at b 4)
  static constexpr bool kPartInC = MT == 4 && 4 * kWarps * kYS <= 2 * BS;
  static constexpr int kPart = 2 * kStage;
  static constexpr int kScan = kPart + (kPartInC ? 0 : 4 * kWarps * R * kYS);
  static constexpr int kBytes = kScan + 4 * kWarps * 2 * R;
  static constexpr int SS = NW + 4;             // f32 row stride of the staged state
  static_assert(kStage % 16 == 0, "stage must keep 16-byte alignment");
  static_assert(4 * kPBlock * SS <= kStage, "the state slice is staged in one stage");

  unsigned char* base;
  __device__ bf16* x(int s) const { return reinterpret_cast<bf16*>(base + s * kStage + kX); }
  __device__ bf16* b(int s) const { return reinterpret_cast<bf16*>(base + s * kStage + kB); }
  __device__ bf16* c(int s) const { return reinterpret_cast<bf16*>(base + s * kStage + kC); }
  __device__ float* dt(int s) const { return reinterpret_cast<float*>(base + s * kStage + kDt); }
  __device__ float* state(int s) const { return reinterpret_cast<float*>(base + s * kStage); }
  __device__ float* part(int s, int w) const {
    return reinterpret_cast<float*>(base + (kPartInC ? s * kStage + kC : kPart)) + w * R * kYS;
  }
  __device__ float* scan(int w) const {
    return reinterpret_cast<float*>(base + kScan) + w * 2 * R;
  }
};

// Issue the copies of chunk t0 .. t0 + L - 1 (x's P block, B, C, dt) into stage s.
template <int NK, int MT>
__device__ __forceinline__ void stage_chunk(const Args& a, const Tiles<NK, MT>& tl, int s,
                                            int t0, int bb, int hh, int p0, int tid) {
  using T = Tiles<NK, MT>;
  const int P = a.p, N = a.n, L = a.chunk, H = a.h, t = a.t;
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* Bm = static_cast<const bf16*>(a.B);
  const bf16* Cm = static_cast<const bf16*>(a.C);
  bf16* xs = tl.x(s);
  bf16* bs = tl.b(s);
  bf16* cs = tl.c(s);
  float* dts = tl.dt(s);
  for (int e = tid; e < T::R * 2; e += kMmaThreads) {
    const int l = e >> 1, pp = p0 + 8 * (e & 1), tok = t0 + l;
    const bool in = l < L && tok < t && pp < P;
    cp_async16(xs + l * kXS + 8 * (e & 1),
               in ? x + ((static_cast<size_t>(bb) * t + tok) * H + hh) * P + pp : x, in);
  }
  constexpr int SEG = T::NW / 8;
  for (int e = tid; e < T::R * SEG; e += kMmaThreads) {
    const int l = e / SEG, nn = 8 * (e % SEG), tok = t0 + l;
    const bool in = l < L && tok < t && nn < N;
    const size_t off = in ? (static_cast<size_t>(bb) * t + tok) * N + nn : 0;
    cp_async16(bs + l * T::BS + nn, Bm + off, in);
    cp_async16(cs + l * T::BS + nn, Cm + off, in);
  }
  for (int l = tid; l < T::R; l += kMmaThreads) {
    const int tok = t0 + l;
    const bool in = l < L && tok < t;
    cp_async4(dts + l, in ? a.dt + (static_cast<size_t>(bb) * t + tok) * H + hh : a.dt, in);
  }
}

// grid (ceil(P / 16), h, b), 4 warps. An m16n8 accumulator holds rows gid
// = lane / 4 and gid + 8, columns 2 (lane % 4) and + 1 of each 8-column
// n-tile. The state fragment s[nt] is S rows p0 + gid (+ 8), columns
// c0 + 8 nt + 2 tq (+ 1) of the warp's c0 = 16 NK warp.
template <int NK, int MT>
__global__ void __launch_bounds__(kMmaThreads) mma_kernel(Args a) {
  using T = Tiles<NK, MT>;
  constexpr int R = T::R, BS = T::BS, NW = T::NW, SS = T::SS;
  const int pb = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int P = a.p, N = a.n, L = a.chunk, H = a.h, t = a.t;
  const int p0 = pb * kPBlock;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int c0 = 16 * NK * warp;
  const float A = a.A[hh];
  bf16* __restrict__ y = static_cast<bf16*>(a.y);

  extern __shared__ __align__(16) unsigned char mma_smem[];
  const T tl{mma_smem};
  const size_t sbase = ((static_cast<size_t>(bb) * H + hh) * P + p0) * N;

  // the initial state slice, 16-byte copies into stage 1, then to fragments
  float s[2 * NK][4];
  float* sst = tl.state(1);
  if (a.s0) {
    for (int e = tid; e < kPBlock * NW / 4; e += kMmaThreads) {
      const int r = e / (NW / 4), nn = 4 * (e % (NW / 4));
      const bool in = p0 + r < P && nn < N;
      cp_async16(sst + r * SS + nn, in ? a.s0 + sbase + static_cast<size_t>(r) * N + nn : a.s0,
                 in);
    }
  }
  stage_chunk(a, tl, 0, 0, bb, hh, p0, tid);
  cp_commit();
  cp_wait_all();
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < 2 * NK; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[nt][e] = a.s0 ? sst[(gid + 8 * (e >> 1)) * SS + c0 + 8 * nt + 2 * tq + (e & 1)] : 0.f;
  __syncthreads();                      // stage 1 takes chunk 1 next

  float* cum = tl.scan(warp);           // this warp's cum [R] and u [R]
  float* u = cum + R;
  const int nc = (t + L - 1) / L;
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * L, st = ci & 1;
    if (ci > 0) {
      cp_wait_all();
      __syncthreads();                  // chunk ci landed; chunk ci - 1 is done
    }
    if (ci + 1 < nc) {
      stage_chunk(a, tl, st ^ 1, t0 + L, bb, hh, p0, tid);
      cp_commit();
    }
    const bf16* xs = tl.x(st);
    const bf16* bs = tl.b(st);
    const bf16* cs = tl.c(st);
    const float* dts = tl.dt(st);

    // the log-decay prefix over token pairs (2 lane, 2 lane + 1), in token
    // order; u_j = dt_j exp(cum_L - cum_j); rows past L have dt = 0
    float decay;
    {
      const int j0 = 2 * lane;
      const float v0 = j0 < R ? dts[j0] * A : 0.f;
      const float v1 = j0 + 1 < R ? dts[j0 + 1] * A : 0.f;
      float incl = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float w = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += w;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float cum0 = excl + v0, cum1 = cum0 + v1;
      const float last = __shfl_sync(0xffffffffu, cum1, (R - 1) >> 1);
      if (j0 < R) {
        cum[j0] = cum0;
        cum[j0 + 1] = cum1;
        u[j0] = dts[j0] * expf(last - cum0);
        u[j0 + 1] = dts[j0 + 1] * expf(last - cum1);
      }
      decay = expf(last);
    }
    __syncwarp();

    // intra-chunk: warp m < MT owns token rows i = 16 m .. 16 m + 15.
    // C B^T over key tiles j <= i, gated into G with dt folded in, then
    // y_intra = G x with G as hi + lo A fragments from the accumulators
    float yi[2][4] = {};
    if (warp < MT) {
      const int m = warp;
      float g[2 * MT][4] = {};
      for (int ks = 0; ks < (N + 15) / 16; ++ks) {
        uint32_t af[4];
        ldsm_x4(af, cs + (16 * m + (lane & 15)) * BS + 16 * ks + (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < MT; ++jp) {
          if (jp <= m) {
            uint32_t bf[4];
            ldsm_x4(bf, bs + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * BS + 16 * ks +
                            ((lane >> 3) & 1) * 8);
            mma(g[2 * jp], af, bf[0], bf[1]);
            mma(g[2 * jp + 1], af, bf[2], bf[3]);
          }
        }
      }
      const int i0 = 16 * m + gid;
      const float ci_[2] = {cum[i0], cum[i0 + 8]};
#pragma unroll
      for (int jt = 0; jt < 2 * MT; ++jt) {
        if (jt <= 2 * m + 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + 8 * (e >> 1), j = 8 * jt + 2 * tq + (e & 1);
            g[jt][e] = j <= i ? expf(ci_[e >> 1] - cum[j]) * dts[j] * g[jt][e] : 0.f;
          }
        }
      }
#pragma unroll
      for (int kt = 0; kt < MT; ++kt) {
        if (kt <= m) {
          uint32_t ghi[4], glo[4];
          split(g[2 * kt][0], g[2 * kt][1], ghi[0], glo[0]);
          split(g[2 * kt][2], g[2 * kt][3], ghi[1], glo[1]);
          split(g[2 * kt + 1][0], g[2 * kt + 1][1], ghi[2], glo[2]);
          split(g[2 * kt + 1][2], g[2 * kt + 1][3], ghi[3], glo[3]);
          uint32_t xf[4];
          ldsm_x4_t(xf, xs + (16 * kt + (lane & 15)) * kXS + (lane >> 4) * 8);
          mma(yi[0], ghi, xf[0], xf[1]);
          mma(yi[0], glo, xf[0], xf[1]);
          mma(yi[1], ghi, xf[2], xf[3]);
          mma(yi[1], glo, xf[2], xf[3]);
        }
      }
    }

    // C S^T over this warp's columns, S as hi + lo B fragments (k = state
    // column, n = p): p rows gid of n-tiles 2k, 2k + 1 for p-tile 0, rows
    // gid + 8 for p-tile 1
    float ys[MT][2][4] = {};
    {
      uint32_t shi[NK][2][2], slo[NK][2][2];
#pragma unroll
      for (int k = 0; k < NK; ++k)
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
          split(s[2 * k][2 * pt], s[2 * k][2 * pt + 1], shi[k][pt][0], slo[k][pt][0]);
          split(s[2 * k + 1][2 * pt], s[2 * k + 1][2 * pt + 1], shi[k][pt][1], slo[k][pt][1]);
        }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          uint32_t af[4];
          ldsm_x4(af, cs + (16 * m + (lane & 15)) * BS + c0 + 16 * k + (lane >> 4) * 8);
#pragma unroll
          for (int pt = 0; pt < 2; ++pt) {
            mma(ys[m][pt], af, shi[k][pt][0], shi[k][pt][1]);
            mma(ys[m][pt], af, slo[k][pt][0], slo[k][pt][1]);
          }
        }
    }
    if (T::kPartInC) __syncthreads();   // every read of C is done
    {
      float* yp = tl.part(st, warp);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int pt = 0; pt < 2; ++pt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            yp[(16 * m + gid + 8 * (e >> 1)) * kYS + 8 * pt + 2 * tq + (e & 1)] = ys[m][pt][e];
    }
    __syncthreads();                    // the four partials are in

    // y = y_intra + exp(cum_i) (partial_0 + partial_1 + partial_2 + partial_3)
    if (warp < MT) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * warp + gid + 8 * hf, tok = t0 + i;
        const float e = expf(cum[i]);
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
          const int col = 8 * pt + 2 * tq;
          float sum0 = tl.part(st, 0)[i * kYS + col], sum1 = tl.part(st, 0)[i * kYS + col + 1];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) {
            sum0 += tl.part(st, w)[i * kYS + col];
            sum1 += tl.part(st, w)[i * kYS + col + 1];
          }
          if (i < L && tok < t && p0 + col < P) {
            const __nv_bfloat162 out = __floats2bfloat162_rn(yi[pt][2 * hf] + sum0 * e,
                                                             yi[pt][2 * hf + 1] + sum1 * e);
            *reinterpret_cast<__nv_bfloat162*>(
                y + ((static_cast<size_t>(bb) * t + tok) * H + hh) * P + p0 + col) = out;
          }
        }
      }
    }

    // S = S exp(cum_L) + (u x)^T B: A = (u x)^T as hi + lo from the
    // transposed x tile (rows p, k = token), B tiles transposed from [j][n]
#pragma unroll
    for (int nt = 0; nt < 2 * NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= decay;
#pragma unroll
    for (int kt = 0; kt < MT; ++kt) {
      uint32_t xf[4];
      ldsm_x4_t(xf, xs + (16 * kt + (lane & 15)) * kXS + (lane >> 4) * 8);
      const int j = 16 * kt + 2 * tq;
      uint32_t ahi[4], alo[4];
      scale_split(xf[0], u[j], u[j + 1], ahi[0], alo[0]);
      scale_split(xf[2], u[j], u[j + 1], ahi[1], alo[1]);
      scale_split(xf[1], u[j + 8], u[j + 9], ahi[2], alo[2]);
      scale_split(xf[3], u[j + 8], u[j + 9], ahi[3], alo[3]);
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        uint32_t bf[4];
        ldsm_x4_t(bf, bs + (16 * kt + (lane & 15)) * BS + c0 + 16 * k + (lane >> 4) * 8);
        mma(s[2 * k], ahi, bf[0], bf[1]);
        mma(s[2 * k], alo, bf[0], bf[1]);
        mma(s[2 * k + 1], ahi, bf[2], bf[3]);
        mma(s[2 * k + 1], alo, bf[2], bf[3]);
      }
    }
  }

  // the final state: fragments to stage 0, then 16-byte stores
  __syncthreads();                      // every warp is done with the last chunk
  sst = tl.state(0);
#pragma unroll
  for (int nt = 0; nt < 2 * NK; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(sst + (gid + 8 * hf) * SS + c0 + 8 * nt + 2 * tq) =
          make_float2(s[nt][2 * hf], s[nt][2 * hf + 1]);
  __syncthreads();
  for (int e = tid; e < kPBlock * NW / 4; e += kMmaThreads) {
    const int r = e / (NW / 4), nn = 4 * (e % (NW / 4));
    if (p0 + r < P && nn < N)
      *reinterpret_cast<float4*>(a.state + sbase + static_cast<size_t>(r) * N + nn) =
          *reinterpret_cast<const float4*>(sst + r * SS + nn);
  }
}

template <int NK, int MT>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int smem = Tiles<NK, MT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(mma_kernel<NK, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.p + kPBlock - 1) / kPBlock, a.h, a.b);
  mma_kernel<NK, MT><<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NK>
cudaError_t launch_mma_mt(const Args& a, int mt, cudaStream_t stream) {
  if (mt == 1) return launch_mma<NK, 1>(a, stream);
  if (mt == 2) return launch_mma<NK, 2>(a, stream);
  if (mt == 4) return launch_mma<NK, 4>(a, stream);
  return cudaErrorInvalidValue;
}

// the bf16 route's shape rules (kernels/ssd.py ssd_tile_plan makes nk, mt)
inline bool mma_takes(const Args& a, int nk, int mt) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.B) |
                          reinterpret_cast<uintptr_t>(a.C) |
                          reinterpret_cast<uintptr_t>(a.s0) |
                          reinterpret_cast<uintptr_t>(a.state);
  return (nk == 1 || nk == 2) && a.n <= 64 * nk && 16 * mt >= a.chunk && a.p % 8 == 0 &&
         a.n % 8 == 0 && align % 16 == 0 && reinterpret_cast<uintptr_t>(a.y) % 4 == 0;
}

}  // namespace ssd

// dtype codes (x, B, C, y): 0 = float32 (the f32 loop; nk, mt unused),
// 1 = bfloat16 (the tensor cores, with nk state k-steps per warp and mt
// 16-token tiles per chunk from kernels/ssd.py ssd_tile_plan). Returns a
// cudaError_t (0 = ok).
extern "C" int ssd_chunked(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, const void* init_state, void* y, void* state,
                           int b, int t, int h, int p, int n, int chunk, int dtype, int nk,
                           int mt, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || p <= 0 || n <= 0 || chunk <= 0 ||
      chunk > ssd::kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const ssd::Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B, C,
                    static_cast<const float*>(init_state), y, static_cast<float*>(state),
                    b, t, h, p, n, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(ssd::launch(a, s));
  if (dtype == 1 && ssd::mma_takes(a, nk, mt)) {
    if (nk == 1) return static_cast<int>(ssd::launch_mma_mt<1>(a, mt, s));
    return static_cast<int>(ssd::launch_mma_mt<2>(a, mt, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
