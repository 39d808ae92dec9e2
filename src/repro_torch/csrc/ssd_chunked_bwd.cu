// The gradient of the Mamba2 SSD chunked scan for Hopper (sm_90a), plain C
// interface.
//
// Ports the gradient of the TPU kernel `ssd_chunked_kernel` in
// src/repro/kernels/ssd.py, which has no backward: JAX differentiates the
// jnp scan (src/repro/models/ssm.py ssd_scan_chunked). This is the
// backward of csrc/ssd_chunked.cu under kernels/ssd.py _SSDChunked, the
// path every Mamba2 layer of a training step takes on the card.
//
//   x, dy       [b, t, h, P]   float32 or bfloat16 (one dtype with B, C)
//   dt          [b, t, h]      float32 (after softplus)
//   A           [h]            float32 (negative)
//   B, C        [b, t, N]      shared across heads
//   init_state  [b, h, P, N]   float32, or null for zeros
//   dS_final    [b, h, P, N]   float32 cotangent of the final state, or null
//   -> dx [b,t,h,P], dB, dC [b,t,N] in x's dtype; ddt [b,t,h], dA [h] and
//      dinit [b,h,P,N] float32
//
// Per chunk of L tokens, with cum = cumsum(dt A), w_ij = exp(cum_i - cum_j)
// for j <= i, e = exp(cum), f = exp(cum_L - cum), xdt = x dt, the incoming
// state S and dS the cotangent of the chunk's outgoing state
// (kernels/ssd.py ssd_chunked_bwd_ref writes the same steps in PyTorch):
//
//   D_ij   = dy_i . xdt_j                       (over P)
//   dxdt_j = sum_i w_ij (C_i . B_j) dy_i + f_j dS B_j,    dx = dxdt dt
//   dC_i   = sum_j w_ij D_ij B_j + e_i S^T dy_i
//   dB_j   = sum_i w_ij D_ij C_i + f_j dS^T xdt_j
//   M_ij   = w_ij (C_i . B_j) D_ij,   dd_j = f_j xdt_j . dS B_j
//   da_k   = sum_{i >= k, j < k} M_ij + sum_{j < k} dd_j
//            + sum_{i >= k} e_i dy_i . S C_i + exp(cum_L) sum S o dS
//   ddt    = dxdt . x + da A;   dA = sum da dt
//   dS    <- exp(cum_L) dS + sum_i e_i dy_i C_i^T
//
// da is the gradient of cum summed backward (cum is a cumsum of dt A),
// with the terms that cancel in that sum left out; cum itself is taken in
// double: w's exponent cum_i - cum_j is a difference of two sums that grow
// along the chunk, and float32 sums would lose its low digits.
//
// Two routes, chosen by dtype in ssd_chunked_bwd() below. Neither uses
// float atomics: every sum runs in a fixed order, so two calls give
// bitwise-equal gradients and a call replays in a CUDA graph.
//
// float32 (x, B, C f32): ssdb::bwd_kernel, one CTA of 256 threads per
// (block of 32 rows of P, head, batch row). It walks the chunks forward to
// recompute its rows' incoming state of each chunk into an f32 workspace
// (the autograd Function saves nothing but the inputs), then backward with
// its dS slice in shared memory, every product an f32 FMA on the CUDA
// cores; dB, dC, ddt and dA go to per-CTA partial sums that
// ssdb::reduce_kernel adds. ~190 KB of shared memory a CTA at L 64, N 128:
// one CTA per SM and a serial chunk walk.
//
// bfloat16 (x, dy, B, C bf16): four launches on the tensor cores. What
// bounds it: at mamba2-130m's training shape (b 4, t 1024, h 24, P 64,
// N 128, L 64) the gradient is ~6.4 G multiply-adds, ~26 GFLOP with the
// hi + lo pairs below (tens of us on mma.sync), and moves ~0.45 GB with
// the workspace's round trips (~0.13 ms at 3.35 TB/s): bytes and the
// stages' latency, not the tensor cores. A walk over the 16 chunks in
// order would leave most of the card idle, so the chunks run in parallel
// and the only serial part is an elementwise recurrence:
//
//   A  chunk_kernel, one CTA of 4 warps per (block of 64 rows of P, head,
//      batch row x chunk): 1536 CTAs at the training shape. The chunk's
//      cum as a shuffle scan in double; the state it adds, X_c = (u x)^T B
//      with u = dt f, and the cotangent it sends back, Y_c = (e dy)^T C,
//      into the workspace; exp(cum_L) per chunk.
//   B  recur_kernel, one thread per 4 state entries: S_{c+1} = exp(cum_L,c)
//      S_c + X_c forward from the init state and dS_c = exp(cum_L,c+1)
//      dS_{c+1} + Y_{c+1} backward from dS_final, in place: each chunk's
//      incoming state and its outgoing state's cotangent. dinit is the
//      cotangent carried past chunk 0.
//   C  grad_kernel, the same grid: C B^T and D' = dy x^T with dt folded out
//      (exact bf16 operands), gated by w and dt in f32 on the accumulator
//      fragments; dxdt = G^T dy + f (B dS^T); dB = (w D)^T C + f dt (x dS);
//      dC = (w D) B + e (dy S); the first sum of da as the product M^T U
//      with U_ik = [i >= k] (M as hi + lo, U exact), masked to the rows
//      j < k and summed over them; the prefix of dd and the reverse
//      prefix of ys by shuffle scans; ddt complete in the CTA when it
//      holds all of P, partial per P block otherwise.
//   R  sum_kernel: dB and dC over (head, P block), ddt over P blocks and
//      dA over (batch row, chunk, P block), in that fixed order.
//
// Every product runs as mma.sync.m16n8k16 in bf16 with f32 accumulators
// (ssd_mma.cuh). Each pairs one bf16 input (exact) with at most one f32
// operand, which enters as the bf16 pair hi + lo (|v - hi - lo| <=
// 2^-16 |v|): two MMAs, never three. Gated matrices (G = w o CB, w o D, M)
// span many orders of magnitude along a chunk and are never rounded to a
// single bf16. The f32 workspace: each chunk's X_c, then S_c; its Y_c,
// then dS_c (50 MB each at the training shape); the dB and dC partials of
// each (batch row, head, P block) (50 MB each); decays, ddt and dA
// partials (kernels/ssd.py ssd_bwd_plan). x, dy, B, C and dt reach shared
// memory through 16-byte cp.async with zero fill past P, N, L and t
// (tokens past t load dt = 0, so a padded tail adds nothing); the S and
// dS tiles load as f32 and are split into hi / lo bf16 tiles. Shared
// memory: 56 KB a CTA in stage A, 89 KB in stage C (two CTAs per SM).
// What is left: the workspace's round trips (~0.4 GB at the training
// shape), and C B^T and D recomputed by every head; a fused recurrence and
// head groups are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_mma.cuh"

namespace ssdb {

constexpr int kThreads = 256;
constexpr int kRows = 32;              // rows of P per CTA
constexpr int kRS = kRows + 1;         // row stride of the [L][kRows] tiles
constexpr int kMaxChunk = 64;

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* s0;
  const float* dy;
  const float* dsf;
  float* dx;
  float* ddt;
  float* dA;
  float* dB;
  float* dC;
  float* ds0;
  float* states;   // [b][h][nc][P][N]: each chunk's incoming state
  float* pdB;      // [b][h][npb][t][N]: partial dB of each CTA
  float* pdC;      // [b][h][npb][t][N]
  float* pddt;     // [b][h][npb][t]
  float* pdA;      // [b][h][npb]
  int b, t, h, p, n, chunk, npb, nc;
};

// ---------------------------------------------------------------------------
// float32 route
// ---------------------------------------------------------------------------

// shared: cum [L] in doubles first; then floats S, dS [kRows][N+1]; x, dy,
// dxdt, dS B, S C [L][kRS]; B, C [L][N+1]; w (C.B), w D, w (C.B) D
// [L][L+1]; dt, e, f and the per-token da, dd, e dy . S C and dxdt . x
// [L]; one float a thread for reductions
inline size_t smem_floats(int n, int l) {
  const size_t ns = n + 1, ls = l + 1;
  return 2 * static_cast<size_t>(l) + 2 * kRows * ns + 5 * static_cast<size_t>(l) * kRS +
         2 * l * ns + 3 * l * ls + 7 * static_cast<size_t>(l) + kThreads;
}

// cum = cumsum(dt A) over the chunk in double, by one thread in token order
__device__ __forceinline__ void chunk_cumsum(double* cum, const float* dts, float A, int L) {
  double s = 0.0;
  for (int l = 0; l < L; ++l) {
    s += static_cast<double>(dts[l] * A);
    cum[l] = s;
  }
}

// The workspace in floats (kernels/ssd.py _bwd_workspace computes the same).
inline long long workspace_floats(const Args& a) {
  const long long bh = static_cast<long long>(a.b) * a.h;
  return bh * (static_cast<long long>(a.nc) * a.p * a.n +
               static_cast<long long>(a.npb) * (2LL * a.t * a.n + a.t + 1));
}

// Stage chunk t0 .. t0 + L - 1 of the CTA's rows: x (and dy), B (and C),
// dt; tokens at or past t and rows at or past P load as zero (dt = 0).
__device__ __forceinline__ void stage(const Args& a, float* xs, float* dys, float* Bs,
                                      float* Cs, float* dts, int t0, int bb, int hh,
                                      int p0, bool bwd) {
  const int P = a.p, N = a.n, L = a.chunk, H = a.h, t = a.t, NS = N + 1;
  const int tid = threadIdx.x;
  for (int e = tid; e < L * kRows; e += kThreads) {
    const int l = e / kRows, r = e % kRows, tok = t0 + l;
    const bool in = tok < t && p0 + r < P;
    const size_t off = in ? ((static_cast<size_t>(bb) * t + tok) * H + hh) * P + p0 + r : 0;
    xs[l * kRS + r] = in ? a.x[off] : 0.f;
    if (bwd) dys[l * kRS + r] = in ? a.dy[off] : 0.f;
  }
  for (int e = tid; e < L * N; e += kThreads) {
    const int l = e / N, nn = e % N, tok = t0 + l;
    const bool in = tok < t;
    const size_t off = in ? (static_cast<size_t>(bb) * t + tok) * N + nn : 0;
    Bs[l * NS + nn] = in ? a.B[off] : 0.f;
    if (bwd) Cs[l * NS + nn] = in ? a.C[off] : 0.f;
  }
  for (int l = tid; l < L; l += kThreads) {
    const int tok = t0 + l;
    dts[l] = tok < t ? a.dt[(static_cast<size_t>(bb) * t + tok) * H + hh] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) bwd_kernel(Args a) {
  const int pb = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int P = a.p, N = a.n, L = a.chunk, H = a.h, t = a.t, nc = a.nc, npb = a.npb;
  const int NS = N + 1, LS = L + 1;
  const int p0 = pb * kRows;
  const int tid = threadIdx.x;
  const float A = a.A[hh];

  extern __shared__ float smem[];
  double* cum = reinterpret_cast<double*>(smem);  // [L]
  float* Ss = smem + 2 * L;          // [kRows][NS] incoming state of the chunk
  float* dSs = Ss + kRows * NS;      // [kRows][NS] cotangent of its outgoing state
  float* xs = dSs + kRows * NS;      // [L][kRS]
  float* dys = xs + L * kRS;         // [L][kRS]
  float* dxs = dys + L * kRS;        // [L][kRS] dxdt
  float* sbs = dxs + L * kRS;        // [L][kRS] (dS B_j)[r]
  float* scs = sbs + L * kRS;        // [L][kRS] (S C_i)[r]
  float* Bs = scs + L * kRS;         // [L][NS]
  float* Cs = Bs + L * NS;           // [L][NS]
  float* Gm = Cs + L * NS;           // [L][LS] w_ij (C_i . B_j), j <= i
  float* Dc = Gm + L * LS;           // [L][LS] w_ij D_ij
  float* Mm = Dc + L * LS;           // [L][LS] w_ij (C_i . B_j) D_ij
  float* dts = Mm + L * LS;          // [L]
  float* ev = dts + L;               // [L] exp(cum)
  float* fv = ev + L;                // [L] exp(cum_L - cum) (forward: times dt)
  float* dav = fv + L;               // [L] da, then sum_{i >= l, j < l} M_ij
  float* ddv = dav + L;              // [L] f_j xdt_j . dS B_j
  float* ysv = ddv + L;              // [L] e_i dy_i . S C_i
  float* xdv = ysv + L;              // [L] dxdt_k . x_k
  float* red = xdv + L;              // [kThreads]

  const size_t sbase = (static_cast<size_t>(bb) * H + hh) * P * N;
  const size_t cta = (static_cast<size_t>(bb) * H + hh) * npb + pb;
  float* states = a.states + (static_cast<size_t>(bb) * H + hh) * nc * P * N;
  for (int e = tid; e < kRows * N; e += kThreads) {
    const int r = e / N, nn = e % N;
    const bool in = p0 + r < P;
    const size_t off = sbase + static_cast<size_t>(p0 + r) * N + nn;
    Ss[r * NS + nn] = in && a.s0 ? a.s0[off] : 0.f;
    dSs[r * NS + nn] = in && a.dsf ? a.dsf[off] : 0.f;
  }

  // forward: the incoming state of every chunk (csrc/ssd_chunked.cu's f32
  // loop, with cum in double)
  for (int c = 0; c < nc; ++c) {
    stage(a, xs, dys, Bs, Cs, dts, c * L, bb, hh, p0, false);
    __syncthreads();
    if (tid == 0) chunk_cumsum(cum, dts, A, L);
    __syncthreads();
    for (int l = tid; l < L; l += kThreads)
      fv[l] = dts[l] * expf(static_cast<float>(cum[L - 1] - cum[l]));
    const float decay = expf(static_cast<float>(cum[L - 1]));
    __syncthreads();
    float* ws = states + static_cast<size_t>(c) * P * N;
    for (int e = tid; e < kRows * N; e += kThreads) {
      const int r = e / N, nn = e % N;
      float* s = Ss + r * NS + nn;
      if (p0 + r < P) ws[static_cast<size_t>(p0 + r) * N + nn] = *s;
      if (c + 1 < nc) {
        float acc = 0.f;
        for (int j = 0; j < L; ++j) acc = fmaf(fv[j] * xs[j * kRS + r], Bs[j * NS + nn], acc);
        *s = fmaf(*s, decay, acc);
      }
    }
    __syncthreads();
  }

  // backward: the chunks in reverse, dS carried in shared memory
  float dA_acc = 0.f;                // thread 0's sum of da dt
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L;
    stage(a, xs, dys, Bs, Cs, dts, t0, bb, hh, p0, true);
    const float* ws = states + static_cast<size_t>(c) * P * N;
    for (int e = tid; e < kRows * N; e += kThreads) {
      const int r = e / N, nn = e % N;
      Ss[r * NS + nn] = p0 + r < P ? ws[static_cast<size_t>(p0 + r) * N + nn] : 0.f;
    }
    __syncthreads();
    if (tid == 0) chunk_cumsum(cum, dts, A, L);
    __syncthreads();
    const float decay = expf(static_cast<float>(cum[L - 1]));
    for (int l = tid; l < L; l += kThreads) {
      ev[l] = expf(static_cast<float>(cum[l]));
      fv[l] = expf(static_cast<float>(cum[L - 1] - cum[l]));
    }
    // the pairs j <= i; w is taken only there (the masked side overflows)
    for (int e = tid; e < L * L; e += kThreads) {
      const int i = e / L, j = e % L;
      float g = 0.f, dc = 0.f, m = 0.f;
      if (j <= i) {
        const float w = expf(static_cast<float>(cum[i] - cum[j]));
        float cb = 0.f;
        for (int nn = 0; nn < N; ++nn) cb = fmaf(Cs[i * NS + nn], Bs[j * NS + nn], cb);
        float d = 0.f;
        for (int r = 0; r < kRows; ++r) d = fmaf(dys[i * kRS + r], xs[j * kRS + r], d);
        d *= dts[j];
        g = w * cb;
        dc = w * d;
        m = g * d;
      }
      Gm[i * LS + j] = g;
      Dc[i * LS + j] = dc;
      Mm[i * LS + j] = m;
    }
    for (int e = tid; e < L * kRows; e += kThreads) {
      const int j = e / kRows, r = e % kRows;
      float sb = 0.f, sc = 0.f;
      for (int nn = 0; nn < N; ++nn) {
        sb = fmaf(dSs[r * NS + nn], Bs[j * NS + nn], sb);
        sc = fmaf(Ss[r * NS + nn], Cs[j * NS + nn], sc);
      }
      sbs[j * kRS + r] = sb;
      scs[j * kRS + r] = sc;
    }
    __syncthreads();

    // dxdt and dx; the partial dC and dB of the CTA's rows; sum of S o dS
    for (int e = tid; e < L * kRows; e += kThreads) {
      const int j = e / kRows, r = e % kRows, tok = t0 + j;
      float acc = 0.f;
      for (int i = j; i < L; ++i) acc = fmaf(Gm[i * LS + j], dys[i * kRS + r], acc);
      const float v = fmaf(fv[j], sbs[j * kRS + r], acc);
      dxs[j * kRS + r] = v;
      if (tok < t && p0 + r < P)
        a.dx[((static_cast<size_t>(bb) * t + tok) * H + hh) * P + p0 + r] = v * dts[j];
    }
    float* pdC = a.pdC + cta * t * N;
    float* pdB = a.pdB + cta * t * N;
    for (int e = tid; e < L * N; e += kThreads) {
      const int l = e / N, nn = e % N, tok = t0 + l;
      if (tok >= t) continue;
      float ci = 0.f, bj = 0.f, cs = 0.f, bs = 0.f;
      for (int j = 0; j <= l; ++j) ci = fmaf(Dc[l * LS + j], Bs[j * NS + nn], ci);
      for (int i = l; i < L; ++i) bj = fmaf(Dc[i * LS + l], Cs[i * NS + nn], bj);
      for (int r = 0; r < kRows; ++r) {
        cs = fmaf(Ss[r * NS + nn], dys[l * kRS + r], cs);
        bs = fmaf(dSs[r * NS + nn], xs[l * kRS + r], bs);
      }
      pdC[static_cast<size_t>(tok) * N + nn] = fmaf(ev[l], cs, ci);
      pdB[static_cast<size_t>(tok) * N + nn] = fmaf(fv[l] * dts[l], bs, bj);
    }
    float sd = 0.f;
    for (int e = tid; e < kRows * N; e += kThreads) {
      const int r = e / N, nn = e % N;
      sd = fmaf(Ss[r * NS + nn], dSs[r * NS + nn], sd);
    }
    red[tid] = sd;
    __syncthreads();

    // per token k: the gradient of cum summed backward, da_k = sum_{i >= k}
    // dcum_i, is taken without the terms that cancel in that sum (the pairs
    // of w with both ends at or past k; -dd_i at i against its share of the
    // decay's sum at L - 1): da_k = sum_{i >= k, j < k} M_ij + sum_{j < k}
    // dd_j + sum_{i >= k} e_i dy_i . S C_i + exp(cum_L) sum S o dS. Here
    // the first sum, f xdt . dS B, e dy . S C and the direct ddt term.
    for (int k = tid; k < L; k += kThreads) {
      float mk = 0.f, ys = 0.f, xd = 0.f, dd = 0.f;
      for (int i = k; i < L; ++i)
        for (int j = 0; j < k; ++j) mk += Mm[i * LS + j];
      for (int r = 0; r < kRows; ++r) {
        ys = fmaf(dys[k * kRS + r], scs[k * kRS + r], ys);
        xd = fmaf(dxs[k * kRS + r], xs[k * kRS + r], xd);
        dd = fmaf(xs[k * kRS + r], sbs[k * kRS + r], dd);
      }
      dav[k] = mk;
      ysv[k] = ev[k] * ys;
      ddv[k] = dd * fv[k] * dts[k];
      xdv[k] = xd;
    }
    __syncthreads();

    // thread 0: the scans of dd and e dy . S C, the ddt and dA partials;
    // the others: dS <- exp(cum_L) dS + sum_i e_i dy_i C_i^T (every read of
    // dS is above the barrier)
    if (tid == 0) {
      float* pddt = a.pddt + cta * t;
      double sdt = 0.0, ys = 0.0, dd = 0.0;
      for (int k = 0; k < kThreads; ++k) sdt += red[k];
      for (int k = 0; k < L; ++k) {
        dav[k] += static_cast<float>(dd);
        dd += ddv[k];
      }
      const double tail = static_cast<double>(decay) * sdt;
      for (int k = L - 1; k >= 0; --k) {
        ys += ysv[k];
        const float da = static_cast<float>(dav[k] + ys + tail);
        if (t0 + k < t) pddt[t0 + k] = fmaf(da, A, xdv[k]);
        dA_acc = fmaf(da, dts[k], dA_acc);
      }
    }
    for (int e = tid; e < kRows * N; e += kThreads) {
      const int r = e / N, nn = e % N;
      float acc = 0.f;
      for (int i = 0; i < L; ++i) acc = fmaf(ev[i] * dys[i * kRS + r], Cs[i * NS + nn], acc);
      float* d = dSs + r * NS + nn;
      *d = fmaf(decay, *d, acc);
    }
    __syncthreads();
  }

  for (int e = tid; e < kRows * N; e += kThreads) {
    const int r = e / N, nn = e % N;
    if (p0 + r < P) a.ds0[sbase + static_cast<size_t>(p0 + r) * N + nn] = dSs[r * NS + nn];
  }
  if (tid == 0) a.pdA[cta] = dA_acc;
}

// The partial sums in a fixed order: dB, dC [b][t][N] over (head, P block),
// ddt [b][t][h] over P blocks, dA [h] over (batch row, P block).
__global__ void __launch_bounds__(kThreads) reduce_kernel(Args a) {
  const size_t t = a.t, N = a.n, H = a.h, npb = a.npb;
  const size_t btn = static_cast<size_t>(a.b) * t * N;
  const size_t bth = static_cast<size_t>(a.b) * t * H;
  const size_t total = btn + bth + H;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; e < total;
       e += static_cast<size_t>(gridDim.x) * kThreads) {
    if (e < btn) {
      const size_t bb = e / (t * N), rest = e % (t * N);
      float sb = 0.f, sc = 0.f;
      for (size_t k = 0; k < H * npb; ++k) {
        const size_t off = ((bb * H * npb) + k) * t * N + rest;
        sb += a.pdB[off];
        sc += a.pdC[off];
      }
      a.dB[e] = sb;
      a.dC[e] = sc;
    } else if (e < btn + bth) {
      const size_t f = e - btn, hh = f % H, bt = f / H, bb = bt / t, tok = bt % t;
      float s = 0.f;
      for (size_t pb = 0; pb < npb; ++pb) s += a.pddt[((bb * H + hh) * npb + pb) * t + tok];
      a.ddt[f] = s;
    } else {
      const size_t hh = e - btn - bth;
      float s = 0.f;
      for (size_t bb = 0; bb < static_cast<size_t>(a.b); ++bb)
        for (size_t pb = 0; pb < npb; ++pb) s += a.pdA[(bb * H + hh) * npb + pb];
      a.dA[hh] = s;
    }
  }
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.n, a.chunk) * sizeof(float);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.npb, a.h, a.b);
  bwd_kernel<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(a.b) * a.t * (a.n + a.h) + a.h;
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 route: chunk-parallel stages on the tensor cores
// ---------------------------------------------------------------------------

using ssd::bf16;
using ssd::cp_async16;
using ssd::cp_async4;
using ssd::ldsm_x4;
using ssd::ldsm_x4_t;
using ssd::mma;
using ssd::pack;
using ssd::scale_split;
using ssd::split;

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kPB = 64;                // rows of P per CTA (its P block)
constexpr int kT = 64;                 // token rows of the tiles (mt <= 4)
constexpr int kXS = kPB + 8;           // bf16 row stride of the x and dy tiles
constexpr int kBS = 128 + 8;           // bf16 row stride of B, C and the state tiles

struct MArgs {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* B;
  const bf16* C;
  const float* s0;
  const bf16* dy;
  const float* dsf;
  bf16* dx;
  float* ddt;
  float* dA;
  bf16* dB;
  bf16* dC;
  float* ds0;
  float* st;       // [b][h][nc][P][N]: each chunk's X_c, then its incoming state
  float* dst;      // [b][h][nc][P][N]: each chunk's Y_c, then dS_c
  float* pdB;      // [b][h][npb][t][N]: partial dB of each (row, head, P block)
  float* pdC;      // [b][h][npb][t][N]
  float* pddt;     // [b][h][npb][t] (npb > 1)
  float* decay;    // [b][h][nc]: exp(cum_L) of each chunk
  float* pdA;      // [b][nc][h][npb]
  int b, t, h, p, n, chunk, nc, npb, nk, mt;
};

// Shared memory (bytes): the chunk's bf16 tiles x, dy [kT][kXS] (the CTA's
// P block) and B, C [kT][kBS]; dt [kT] f32, cum [kT] double, e and f
// [kT]; the per-warp sums over rows j < k of M^T U [4][kT]; per token dd,
// dxdt . x and ys [kT]; the per-warp S o dS partials and the decay [8];
// then (stage C only) the state tile as bf16 hi and lo [kPB][kBS] each.
struct Tiles {
  static constexpr int kX = 0;
  static constexpr int kDy = kX + 2 * kT * kXS;
  static constexpr int kB = kDy + 2 * kT * kXS;
  static constexpr int kC = kB + 2 * kT * kBS;
  static constexpr int kDt = kC + 2 * kT * kBS;
  static constexpr int kCum = kDt + 4 * kT;
  static constexpr int kE = kCum + 8 * kT;
  static constexpr int kF = kE + 4 * kT;
  static constexpr int kRp = kF + 4 * kT;
  static constexpr int kDd = kRp + 4 * kWarps * kT;
  static constexpr int kXd = kDd + 4 * kT;
  static constexpr int kYs = kXd + 4 * kT;
  static constexpr int kMisc = kYs + 4 * kT;
  static constexpr int kSh = kMisc + 4 * 16;
  static constexpr int kSl = kSh + 2 * kPB * kBS;
  static constexpr int kBytesA = kSh;            // stage A: no state tiles
  static constexpr int kBytesC = kSl + 2 * kPB * kBS;
  static_assert(kSh % 16 == 0 && kCum % 8 == 0, "tile alignment");

  unsigned char* base;
  __device__ bf16* x() const { return reinterpret_cast<bf16*>(base + kX); }
  __device__ bf16* dy() const { return reinterpret_cast<bf16*>(base + kDy); }
  __device__ bf16* b() const { return reinterpret_cast<bf16*>(base + kB); }
  __device__ bf16* c() const { return reinterpret_cast<bf16*>(base + kC); }
  __device__ float* dt() const { return reinterpret_cast<float*>(base + kDt); }
  __device__ double* cum() const { return reinterpret_cast<double*>(base + kCum); }
  __device__ float* e() const { return reinterpret_cast<float*>(base + kE); }
  __device__ float* f() const { return reinterpret_cast<float*>(base + kF); }
  __device__ float* rp(int w) const { return reinterpret_cast<float*>(base + kRp) + w * kT; }
  __device__ float* dd() const { return reinterpret_cast<float*>(base + kDd); }
  __device__ float* xd() const { return reinterpret_cast<float*>(base + kXd); }
  __device__ float* ys() const { return reinterpret_cast<float*>(base + kYs); }
  __device__ float* misc() const { return reinterpret_cast<float*>(base + kMisc); }
  __device__ bf16* sh() const { return reinterpret_cast<bf16*>(base + kSh); }
  __device__ bf16* sl() const { return reinterpret_cast<bf16*>(base + kSl); }
};

// Start the copies of the chunk's rows of x and dy for P block q.
__device__ __forceinline__ void stage_xdy(const MArgs& a, const Tiles& tl, int q, int t0,
                                          int bb, int hh, int tid) {
  const int P = a.p, L = a.chunk, H = a.h, t = a.t, R = 16 * a.mt;
  for (int e = tid; e < R * (kPB / 8); e += kMmaThreads) {
    const int l = e >> 3, pp = kPB * q + 8 * (e & 7), tok = t0 + l;
    const bool in = l < L && tok < t && pp < P;
    const size_t off = in ? ((static_cast<size_t>(bb) * t + tok) * H + hh) * P + pp : 0;
    cp_async16(tl.x() + l * kXS + 8 * (e & 7), a.x + off, in);
    cp_async16(tl.dy() + l * kXS + 8 * (e & 7), a.dy + off, in);
  }
}

// Start the copies of the chunk's B, C and dt.
__device__ __forceinline__ void stage_bc(const MArgs& a, const Tiles& tl, int t0, int bb,
                                         int hh, int tid) {
  const int N = a.n, L = a.chunk, H = a.h, t = a.t, R = 16 * a.mt, SEG = 8 * a.nk;
  for (int e = tid; e < R * SEG; e += kMmaThreads) {
    const int l = e / SEG, nn = 8 * (e % SEG), tok = t0 + l;
    const bool in = l < L && tok < t && nn < N;
    const size_t off = in ? (static_cast<size_t>(bb) * t + tok) * N + nn : 0;
    cp_async16(tl.b() + l * kBS + nn, a.B + off, in);
    cp_async16(tl.c() + l * kBS + nn, a.C + off, in);
  }
  for (int l = tid; l < R; l += kMmaThreads) {
    const int tok = t0 + l;
    const bool in = l < L && tok < t;
    cp_async4(tl.dt() + l, in ? a.dt + (static_cast<size_t>(bb) * t + tok) * H + hh : a.dt, in);
  }
}

// Warp 0: the chunk's cum = cumsum(dt A) in double, as a shuffle scan over
// token pairs (2 lane, 2 lane + 1), e = exp(cum), f = exp(cum_L - cum)
// and the decay exp(cum_L) (rows past L have dt = 0: cum_L = cum_{R-1}).
__device__ __forceinline__ void chunk_prefix(const Tiles& tl, float A, int R, int lane) {
  const float* dts = tl.dt();
  const int j0 = 2 * lane;
  const double v0 = j0 < R ? static_cast<double>(dts[j0] * A) : 0.0;
  const double v1 = j0 + 1 < R ? static_cast<double>(dts[j0 + 1] * A) : 0.0;
  double incl = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double w = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += w;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  const double cum0 = excl + v0, cum1 = cum0 + v1;
  const double last = __shfl_sync(0xffffffffu, cum1, (R - 1) >> 1);
  if (j0 < R) {
    tl.cum()[j0] = cum0;
    tl.cum()[j0 + 1] = cum1;
    tl.e()[j0] = expf(static_cast<float>(cum0));
    tl.e()[j0 + 1] = expf(static_cast<float>(cum1));
    tl.f()[j0] = expf(static_cast<float>(last - cum0));
    tl.f()[j0 + 1] = expf(static_cast<float>(last - cum1));
  }
  if (lane == 0) tl.misc()[4] = expf(static_cast<float>(last));
}

// The chunk's contribution to a [P x N] state of the warp's 16 rows of P,
// (s v)^T W over the chunk's tokens: v (x or dy) exact in the tile, scaled
// by s (u or e) in f32 and split hi + lo; W (B or C) exact. Stored f32 to
// out [P][N] (this chunk's slab).
__device__ __forceinline__ void chunk_state(const MArgs& a, const bf16* vs, const float* sv,
                                            const bf16* ws, float* out, int p0, int warp,
                                            int lane) {
  const int gid = lane >> 2, tq = lane & 3, P = a.p, N = a.n;
  if (p0 + 16 * warp >= P) return;
  for (int nh = 0; nh < a.nk; ++nh) {
    float acc[8][4] = {};
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (kt >= a.mt) break;
      uint32_t vf[4], ahi[4], alo[4];
      ldsm_x4_t(vf, vs + (16 * kt + (lane & 15)) * kXS + 16 * warp + (lane >> 4) * 8);
      const int j = 16 * kt + 2 * tq;
      scale_split(vf[0], sv[j], sv[j + 1], ahi[0], alo[0]);
      scale_split(vf[2], sv[j], sv[j + 1], ahi[1], alo[1]);
      scale_split(vf[1], sv[j + 8], sv[j + 9], ahi[2], alo[2]);
      scale_split(vf[3], sv[j + 8], sv[j + 9], ahi[3], alo[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(bf, ws + (16 * kt + (lane & 15)) * kBS + 64 * nh + 16 * np + (lane >> 4) * 8);
        mma(acc[2 * np], ahi, bf[0], bf[1]);
        mma(acc[2 * np], alo, bf[0], bf[1]);
        mma(acc[2 * np + 1], ahi, bf[2], bf[3]);
        mma(acc[2 * np + 1], alo, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = p0 + 16 * warp + gid + 8 * hf, n = 64 * nh + 8 * nt + 2 * tq;
        if (p < P && n < N)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(p) * N + n) =
              make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      }
  }
}

// Stage A. grid (npb, h, b nc), 4 warps; warp w takes rows p0 + 16 w ..
// p0 + 16 w + 15 of P.
__global__ void __launch_bounds__(kMmaThreads) chunk_kernel(MArgs a) {
  const int pb = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z / a.nc, c = blockIdx.z % a.nc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * a.chunk, R = 16 * a.mt, p0 = kPB * pb;
  extern __shared__ __align__(16) unsigned char smem_a[];
  const Tiles tl{smem_a};
  stage_bc(a, tl, t0, bb, hh, tid);
  stage_xdy(a, tl, pb, t0, bb, hh, tid);
  ssd::cp_commit();
  ssd::cp_wait_all();
  __syncthreads();
  const size_t bhc = (static_cast<size_t>(bb) * a.h + hh) * a.nc + c;
  if (warp == 0) {
    chunk_prefix(tl, a.A[hh], R, lane);
    if (lane == 0) a.decay[bhc] = tl.misc()[4];
  }
  __syncthreads();
  // u = dt f into the dd slots (free in this stage)
  for (int l = tid; l < R; l += kMmaThreads) tl.dd()[l] = tl.dt()[l] * tl.f()[l];
  __syncthreads();
  const size_t slab = bhc * a.p * a.n;
  chunk_state(a, tl.x(), tl.dd(), tl.b(), a.st + slab, p0, warp, lane);
  chunk_state(a, tl.dy(), tl.e(), tl.c(), a.dst + slab, p0, warp, lane);
}

// Stage B: per 4 state entries of a (batch row, head), the recurrence over
// the chunks in place, S_{c+1} = S_c exp(cum_L,c) + X_c (the forward's
// order: decay, then update) and dS_{c-1} = exp(cum_L,c) dS_c + Y_c.
// The loads of kBatch chunks are made before any of their stores, so
// that each thread keeps kBatch 16-byte loads in flight.
constexpr int kBatch = 8;

__device__ __forceinline__ float4 fma4(float4 s, float g, float4 d) {
  return make_float4(fmaf(s.x, g, d.x), fmaf(s.y, g, d.y), fmaf(s.z, g, d.z),
                     fmaf(s.w, g, d.w));
}

__global__ void __launch_bounds__(kThreads) recur_kernel(MArgs a) {
  const size_t pn = static_cast<size_t>(a.p) * a.n, step = pn / 4;
  const int nc = a.nc;
  const size_t total = static_cast<size_t>(a.b) * a.h * step;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; e < total;
       e += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t bh = e / step, r = e % step;
    float4* st = reinterpret_cast<float4*>(a.st) + bh * nc * step + r;
    float4* dst = reinterpret_cast<float4*>(a.dst) + bh * nc * step + r;
    const float* dec = a.decay + bh * nc;
    float4 s = a.s0 ? reinterpret_cast<const float4*>(a.s0)[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < nc; c0 += kBatch) {
      float4 d[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (c0 + k < nc) d[k] = st[(c0 + k) * step];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (c0 + k < nc) {
          st[(c0 + k) * step] = s;
          s = fma4(s, dec[c0 + k], d[k]);
        }
    }
    float4 g = a.dsf ? reinterpret_cast<const float4*>(a.dsf)[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = nc - 1; c0 >= 0; c0 -= kBatch) {
      float4 d[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (c0 - k >= 0) d[k] = dst[(c0 - k) * step];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (c0 - k >= 0) {
          dst[(c0 - k) * step] = g;
          g = fma4(g, dec[c0 - k], d[k]);
        }
    }
    reinterpret_cast<float4*>(a.ds0)[e] = g;
  }
}

// The CTA's P block of the f32 state slab [P][N] as bf16 hi and lo tiles
// [kPB][kBS] (zero past P and N). With dot, first sums src o (hi + lo) of
// what the tiles held (S against dS) at the entries this thread writes.
__device__ __forceinline__ float load_split(const MArgs& a, const Tiles& tl, const float* src,
                                            int p0, bool dot, int tid) {
  const int P = a.p, N = a.n, Q = 16 * a.nk;     // float4 columns
  float sum = 0.f;
  for (int e = tid; e < kPB * Q; e += kMmaThreads) {
    const int r = e / Q, nn = 4 * (e % Q);
    const float4 v = p0 + r < P && nn < N
                         ? *reinterpret_cast<const float4*>(src + static_cast<size_t>(p0 + r) * N + nn)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    uint2* h = reinterpret_cast<uint2*>(tl.sh() + r * kBS + nn);
    uint2* l = reinterpret_cast<uint2*>(tl.sl() + r * kBS + nn);
    if (dot) {
      const uint2 ho = *h, lo = *l;
      const float2 h0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ho.x));
      const float2 h1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ho.y));
      const float2 l0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo.x));
      const float2 l1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo.y));
      sum = fmaf(v.x, h0.x + l0.x, sum);
      sum = fmaf(v.y, h0.y + l0.y, sum);
      sum = fmaf(v.z, h1.x + l1.x, sum);
      sum = fmaf(v.w, h1.y + l1.y, sum);
    }
    uint2 hi, lo;
    split(v.x, v.y, hi.x, lo.x);
    split(v.z, v.w, hi.y, lo.y);
    *h = hi;
    *l = lo;
  }
  return sum;
}

// The A fragments (16 x 16, k tile kt) of a 16 x 64 f32 accumulator set as
// hi + lo.
__device__ __forceinline__ void frag_split(const float (&g)[8][4], int kt, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split(g[2 * kt][0], g[2 * kt][1], hi[0], lo[0]);
  split(g[2 * kt][2], g[2 * kt][3], hi[1], lo[1]);
  split(g[2 * kt + 1][0], g[2 * kt + 1][1], hi[2], lo[2]);
  split(g[2 * kt + 1][2], g[2 * kt + 1][3], hi[3], lo[3]);
}

// acc (16 rows x 64 columns) += A (hi + lo, 16 x 16) times the 16 x 64
// tile at src ([k][n] rows of stride ld: transposed ldmatrix).
__device__ __forceinline__ void mma_rows_kn(float (&acc)[8][4], const uint32_t (&hi)[4],
                                            const uint32_t (&lo)[4], const bf16* src, int ld,
                                            int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t bf[4];
    ldsm_x4_t(bf, src + (lane & 15) * ld + 16 * np + (lane >> 4) * 8);
    mma(acc[2 * np], hi, bf[0], bf[1]);
    mma(acc[2 * np], lo, bf[0], bf[1]);
    mma(acc[2 * np + 1], hi, bf[2], bf[3]);
    mma(acc[2 * np + 1], lo, bf[2], bf[3]);
  }
}

// acc (16 x 64) += the exact A tile at a ([m][k], 16 x 16) times the hi +
// lo state tiles' 16 x 64 block at column c0, with k = the tiles' rows (P)
// when kn (transposed ldmatrix), else k = their columns (N) at column k0
// and n = their rows.
__device__ __forceinline__ void mma_state(float (&acc)[8][4], const uint32_t (&af)[4],
                                          const Tiles& tl, int off, bool kn, int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t bh[4], bl[4];
    if (kn) {
      const int o = off + (lane & 15) * kBS + 16 * np + (lane >> 4) * 8;
      ldsm_x4_t(bh, tl.sh() + o);
      ldsm_x4_t(bl, tl.sl() + o);
    } else {
      const int o = off + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * kBS + ((lane >> 3) & 1) * 8;
      ldsm_x4(bh, tl.sh() + o);
      ldsm_x4(bl, tl.sl() + o);
    }
    mma(acc[2 * np], af, bh[0], bh[1]);
    mma(acc[2 * np], af, bl[0], bl[1]);
    mma(acc[2 * np + 1], af, bh[2], bh[3]);
    mma(acc[2 * np + 1], af, bl[2], bl[3]);
  }
}

// Stage C. grid (npb, h, b nc), 4 warps. Warp m < mt owns the chunk's
// token rows 16 m .. 16 m + 15 in two roles: as keys j (B C^T, D'^T, dxdt,
// dB, M^T U) and as queries i (D', dC). An m16n8 accumulator holds rows
// gid = lane / 4 and gid + 8, columns 2 (lane % 4) and + 1 of each 8-column
// n-tile.
__global__ void __launch_bounds__(kMmaThreads, 2) grad_kernel(MArgs a) {
  const int pb = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z / a.nc, c = blockIdx.z % a.nc;
  const int P = a.p, N = a.n, L = a.chunk, H = a.h, t = a.t, mt = a.mt, npb = a.npb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int t0 = c * L, R = 16 * mt, p0 = kPB * pb, r0 = 16 * warp;
  const bool on = warp < mt;
  const float A = a.A[hh];
  extern __shared__ __align__(16) unsigned char smem_c[];
  const Tiles tl{smem_c};
  const bf16* xs = tl.x();
  const bf16* dys = tl.dy();
  const bf16* bs = tl.b();
  const bf16* cs = tl.c();
  const size_t bhc = (static_cast<size_t>(bb) * H + hh) * a.nc + c;
  const size_t slab = bhc * P * N;

  // B, C, dt and the first x / dy block in flight; dS as hi + lo meanwhile
  stage_bc(a, tl, t0, bb, hh, tid);
  int q = (pb + 1) % npb;
  stage_xdy(a, tl, q, t0, bb, hh, tid);
  ssd::cp_commit();
  load_split(a, tl, a.dst + slab, p0, false, tid);
  ssd::cp_wait_all();
  __syncthreads();
  if (warp == 0) chunk_prefix(tl, A, R, lane);

  // (B C^T)^T and D'^T with rows j, D' with rows i, over key / query tiles
  // that meet j <= i; D' sums over every P block (the CTA's own last)
  float cbt[8][4] = {}, dpt[8][4] = {}, dpq[8][4] = {};
  if (on) {
    for (int ks = 0; ks < 4 * a.nk; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, bs + (r0 + (lane & 15)) * kBS + 16 * ks + (lane >> 4) * 8);
#pragma unroll
      for (int ip = 0; ip < 4; ++ip) {
        if (ip < warp || ip >= mt) continue;
        uint32_t bf[4];
        ldsm_x4(bf, cs + (16 * ip + (lane & 7) + ((lane >> 4) << 3)) * kBS + 16 * ks +
                        ((lane >> 3) & 1) * 8);
        mma(cbt[2 * ip], af, bf[0], bf[1]);
        mma(cbt[2 * ip + 1], af, bf[2], bf[3]);
      }
    }
  }
  for (int s = 0; s < npb; ++s) {
    if (s > 0) {
      __syncthreads();                  // every read of block q is done
      q = (q + 1) % npb;
      stage_xdy(a, tl, q, t0, bb, hh, tid);
      ssd::cp_commit();
      ssd::cp_wait_all();
      __syncthreads();
    }
    if (!on) continue;
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      uint32_t ax[4], ady[4];
      ldsm_x4(ax, xs + (r0 + (lane & 15)) * kXS + 16 * kp + (lane >> 4) * 8);
      ldsm_x4(ady, dys + (r0 + (lane & 15)) * kXS + 16 * kp + (lane >> 4) * 8);
#pragma unroll
      for (int ip = 0; ip < 4; ++ip) {
        if (ip >= mt) continue;
        const int o = (16 * ip + (lane & 7) + ((lane >> 4) << 3)) * kXS + 16 * kp +
                      ((lane >> 3) & 1) * 8;
        uint32_t bf[4];
        if (ip >= warp) {                // D'^T: x_j . dy_i, i >= j
          ldsm_x4(bf, dys + o);
          mma(dpt[2 * ip], ax, bf[0], bf[1]);
          mma(dpt[2 * ip + 1], ax, bf[2], bf[3]);
        }
        if (ip <= warp) {                // D': dy_i . x_j, j <= i
          ldsm_x4(bf, xs + o);
          mma(dpq[2 * ip], ady, bf[0], bf[1]);
          mma(dpq[2 * ip + 1], ady, bf[2], bf[3]);
        }
      }
    }
  }
  __syncthreads();                      // cum, e, f from warp 0

  const double* cum = tl.cum();
  const float* dts = tl.dt();
  const float* ev = tl.e();
  const float* fv = tl.f();
  const float decay = tl.misc()[4];
  const bool first = pb == 0;           // the terms complete over P: once
  float tail = 0.f;

  if (on) {
    // gate: rows j (cbt -> G^T = w CB, dpt -> (w D)^T = w dt_j D'^T) and
    // rows i (dpq -> w D = w dt_j D'); w only where j <= i. The first sum
    // of da: R_k = sum_{j < k} (M^T U)_jk with M^T = CB o (w D)^T as hi +
    // lo and U_ik = [i >= k] exact, built in registers.
    const int jr[2] = {r0 + gid, r0 + gid + 8};
    const double cj[2] = {cum[jr[0]], cum[jr[1]]};
    const float dtj[2] = {dts[jr[0]], dts[jr[1]]};
    float mu[8][4] = {};
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (kt < warp || kt >= mt) continue;
      float m[2][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int nt = 2 * kt + h2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * nt + 2 * tq + (e & 1), hf = e >> 1;
          const bool keep = i >= jr[hf];
          const float w = keep ? expf(static_cast<float>(cum[i] - cj[hf])) : 0.f;
          const float wd = w * dtj[hf] * dpt[nt][e];
          m[h2][e] = cbt[nt][e] * wd;
          cbt[nt][e] *= w;
          dpt[nt][e] = wd;
        }
      }
      uint32_t mhi[4], mlo[4];
      split(m[0][0], m[0][1], mhi[0], mlo[0]);
      split(m[0][2], m[0][3], mhi[1], mlo[1]);
      split(m[1][0], m[1][1], mhi[2], mlo[2]);
      split(m[1][2], m[1][3], mhi[3], mlo[3]);
      const int i0 = 16 * kt + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= 2 * mt) continue;
        const int k = 8 * nt + gid;
        const uint32_t u0 = pack(i0 >= k ? 1.f : 0.f, i0 + 1 >= k ? 1.f : 0.f);
        const uint32_t u1 = pack(i0 + 8 >= k ? 1.f : 0.f, i0 + 9 >= k ? 1.f : 0.f);
        mma(mu[nt], mhi, u0, u1);
        mma(mu[nt], mlo, u0, u1);
      }
    }
    {
      const int ir[2] = {r0 + gid, r0 + gid + 8};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt > 2 * warp + 1) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * nt + 2 * tq + (e & 1), hf = e >> 1;
          dpq[nt][e] = j <= ir[hf]
                           ? expf(static_cast<float>(cum[ir[hf]] - cum[j])) * dts[j] * dpq[nt][e]
                           : 0.f;
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int k = 8 * nt + 2 * tq + e1;
        float v = (jr[0] < k ? mu[nt][e1] : 0.f) + (jr[1] < k ? mu[nt][2 + e1] : 0.f);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gid == 0) tl.rp(warp)[k] = v;
      }

    // dxdt (rows j, the block's 64 columns of P) = G^T dy + f (B dS^T)
    float d1[8][4] = {}, d2[8][4] = {};
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      if (it < warp || it >= mt) continue;
      uint32_t hi[4], lo[4];
      frag_split(cbt, it, hi, lo);
      mma_rows_kn(d1, hi, lo, dys + 16 * it * kXS, kXS, lane);
    }
    for (int ks = 0; ks < 4 * a.nk; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, bs + (r0 + (lane & 15)) * kBS + 16 * ks + (lane >> 4) * 8);
      mma_state(d2, af, tl, 16 * ks, false, lane);
    }
    // dx = dxdt dt; per row, dd = f dt sum_p x (B dS^T) and dxdt . x
    float dd[2] = {0.f, 0.f}, xd[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = jr[hf], tok = t0 + j;
      const float fj = fv[j];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = 8 * nt + 2 * tq;
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + j * kXS + col));
        const float v0 = fmaf(fj, d2[nt][2 * hf], d1[nt][2 * hf]);
        const float v1 = fmaf(fj, d2[nt][2 * hf + 1], d1[nt][2 * hf + 1]);
        dd[hf] = fmaf(xv.x, d2[nt][2 * hf], fmaf(xv.y, d2[nt][2 * hf + 1], dd[hf]));
        xd[hf] = fmaf(xv.x, v0, fmaf(xv.y, v1, xd[hf]));
        if (j < L && tok < t && p0 + col < P)
          *reinterpret_cast<__nv_bfloat162*>(
              a.dx + ((static_cast<size_t>(bb) * t + tok) * H + hh) * P + p0 + col) =
              __floats2bfloat162_rn(v0 * dtj[hf], v1 * dtj[hf]);
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        dd[hf] += __shfl_xor_sync(0xffffffffu, dd[hf], o);
        xd[hf] += __shfl_xor_sync(0xffffffffu, xd[hf], o);
      }
      if (tq == 0) {
        tl.dd()[j] = fj * dtj[hf] * dd[hf];
        tl.xd()[j] = xd[hf];
      }
    }

    // dB (rows j) = (w D)^T C + f dt (x dS), per 64 columns of N
    for (int nh = 0; nh < a.nk; ++nh) {
      float b1[8][4] = {}, b2[8][4] = {};
      if (first) {
#pragma unroll
        for (int it = 0; it < 4; ++it) {
          if (it < warp || it >= mt) continue;
          uint32_t hi[4], lo[4];
          frag_split(dpt, it, hi, lo);
          mma_rows_kn(b1, hi, lo, cs + 16 * it * kBS + 64 * nh, kBS, lane);
        }
      }
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {
        uint32_t af[4];
        ldsm_x4(af, xs + (r0 + (lane & 15)) * kXS + 16 * kp + (lane >> 4) * 8);
        mma_state(b2, af, tl, 16 * kp * kBS + 64 * nh, true, lane);
      }
      float* out = a.pdB + ((static_cast<size_t>(bb) * H + hh) * npb + pb) * t * N;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = jr[hf], tok = t0 + j;
        const float s = fv[j] * dtj[hf];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = 64 * nh + 8 * nt + 2 * tq;
          if (j < L && tok < t && n < N)
            *reinterpret_cast<float2*>(out + static_cast<size_t>(tok) * N + n) =
                make_float2(fmaf(s, b2[nt][2 * hf], b1[nt][2 * hf]),
                            fmaf(s, b2[nt][2 * hf + 1], b1[nt][2 * hf + 1]));
        }
      }
    }
  }

  // the state tiles: dS -> S, summing S o dS on the way
  __syncthreads();
  tail = load_split(a, tl, a.st + slab, p0, true, tid);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) tail += __shfl_xor_sync(0xffffffffu, tail, o);
  if (lane == 0) tl.misc()[warp] = tail;
  __syncthreads();

  if (on) {
    // dC (rows i) = (w D) B + e (dy S), per 64 columns of N; ys_i = e_i
    // sum_n C_i (dy S)_i
    const int ir[2] = {r0 + gid, r0 + gid + 8};
    float ys[2] = {0.f, 0.f};
    for (int nh = 0; nh < a.nk; ++nh) {
      float c1[8][4] = {}, c2[8][4] = {};
      if (first) {
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) {
          if (jt > warp) continue;
          uint32_t hi[4], lo[4];
          frag_split(dpq, jt, hi, lo);
          mma_rows_kn(c1, hi, lo, bs + 16 * jt * kBS + 64 * nh, kBS, lane);
        }
      }
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {
        uint32_t af[4];
        ldsm_x4(af, dys + (r0 + (lane & 15)) * kXS + 16 * kp + (lane >> 4) * 8);
        mma_state(c2, af, tl, 16 * kp * kBS + 64 * nh, true, lane);
      }
      float* out = a.pdC + ((static_cast<size_t>(bb) * H + hh) * npb + pb) * t * N;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = ir[hf], tok = t0 + i;
        const float ei = ev[i];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = 64 * nh + 8 * nt + 2 * tq;
          const float2 cv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cs + i * kBS + n));
          ys[hf] = fmaf(cv.x, c2[nt][2 * hf], fmaf(cv.y, c2[nt][2 * hf + 1], ys[hf]));
          if (i < L && tok < t && n < N)
            *reinterpret_cast<float2*>(out + static_cast<size_t>(tok) * N + n) =
                make_float2(fmaf(ei, c2[nt][2 * hf], c1[nt][2 * hf]),
                            fmaf(ei, c2[nt][2 * hf + 1], c1[nt][2 * hf + 1]));
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) ys[hf] += __shfl_xor_sync(0xffffffffu, ys[hf], o);
      if (tq == 0) tl.ys()[ir[hf]] = ev[ir[hf]] * ys[hf];
    }
  } else {
    for (int k = lane; k < kT; k += 32) tl.rp(warp)[k] = 0.f;
  }
  __syncthreads();

  // warp 0, tokens k = 2 lane, 2 lane + 1: da_k = R_k + sum_{j < k} dd_j +
  // sum_{i >= k} ys_i + exp(cum_L) sum S o dS (prefix and suffix by
  // shuffle scans, no subtraction); ddt = dxdt . x + da A; dA's partial
  if (warp == 0) {
    const int k0 = 2 * lane;
    float rk[2], ddv[2], ysv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = k0 + u;
      const bool in = k < R;
      rk[u] = first && in ? ((tl.rp(0)[k] + tl.rp(1)[k]) + tl.rp(2)[k]) + tl.rp(3)[k] : 0.f;
      ddv[u] = in ? tl.dd()[k] : 0.f;
      ysv[u] = in ? tl.ys()[k] : 0.f;
    }
    float pre = ddv[0] + ddv[1], suf = ysv[0] + ysv[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float w = __shfl_up_sync(0xffffffffu, pre, o);
      if (lane >= o) pre += w;
      const float v = __shfl_down_sync(0xffffffffu, suf, o);
      if (lane + o < 32) suf += v;
    }
    float pex = __shfl_up_sync(0xffffffffu, pre, 1);
    float sex = __shfl_down_sync(0xffffffffu, suf, 1);
    if (lane == 0) pex = 0.f;
    if (lane == 31) sex = 0.f;
    const float* m = tl.misc();
    const float tl_sum = decay * (((m[0] + m[1]) + m[2]) + m[3]);
    const float da1 = rk[1] + (pex + ddv[0]) + (sex + ysv[1]) + tl_sum;
    const float da0 = rk[0] + pex + (sex + ysv[1] + ysv[0]) + tl_sum;
    float dsum = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = k0 + u, tok = t0 + k;
      const float da = u ? da1 : da0;
      if (k < R) dsum = fmaf(da, dts[k], dsum);
      if (k < L && tok < t) {
        const float g = fmaf(da, A, tl.xd()[k]);
        if (npb == 1)
          a.ddt[(static_cast<size_t>(bb) * t + tok) * H + hh] = g;
        else
          a.pddt[((static_cast<size_t>(bb) * H + hh) * npb + pb) * t + tok] = g;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    if (lane == 0) a.pdA[((static_cast<size_t>(bb) * a.nc + c) * H + hh) * npb + pb] = dsum;
  }
}

// The partial sums in a fixed order: dB, dC [b][t][N] over (head, P
// block), ddt [b][t][h] over P blocks (npb > 1), dA [h] over (batch row,
// chunk, P block).
__global__ void __launch_bounds__(kThreads) sum_kernel(MArgs a) {
  const size_t t = a.t, N = a.n, H = a.h, npb = a.npb, nc = a.nc;
  const size_t btn = static_cast<size_t>(a.b) * t * N;
  const size_t bth = npb > 1 ? static_cast<size_t>(a.b) * t * H : 0;
  const size_t total = btn + bth + H;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; e < total;
       e += static_cast<size_t>(gridDim.x) * kThreads) {
    if (e < btn) {
      const size_t bb = e / (t * N), rest = e % (t * N);
      float sb = 0.f, sc = 0.f;
      for (size_t k = 0; k < H * npb; ++k) {
        const size_t off = (bb * H * npb + k) * t * N + rest;
        sb += a.pdB[off];
        sc += a.pdC[off];
      }
      a.dB[e] = __float2bfloat16(sb);
      a.dC[e] = __float2bfloat16(sc);
    } else if (e < btn + bth) {
      const size_t f = e - btn, hh = f % H, bt = f / H, bb = bt / t, tok = bt % t;
      float s = 0.f;
      for (size_t pb = 0; pb < npb; ++pb) s += a.pddt[((bb * H + hh) * npb + pb) * t + tok];
      a.ddt[f] = s;
    } else {
      const size_t hh = e - btn - bth;
      float s = 0.f;
      for (size_t bb = 0; bb < static_cast<size_t>(a.b); ++bb)
        for (size_t c = 0; c < nc; ++c)
          for (size_t pb = 0; pb < npb; ++pb) s += a.pdA[((bb * nc + c) * H + hh) * npb + pb];
      a.dA[hh] = s;
    }
  }
}

// The workspace in floats (kernels/ssd.py ssd_bwd_plan computes the same).
inline long long mma_workspace_floats(const MArgs& a) {
  const long long bh = static_cast<long long>(a.b) * a.h, nc = a.nc, npb = a.npb;
  return bh * (2 * nc * a.p * a.n + npb * (2LL * a.t * a.n + a.t) + nc + nc * npb);
}

// the bf16 route's shape rules (kernels/ssd.py ssd_bwd_plan makes nk, mt)
inline bool mma_takes(const MArgs& a) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.dy) |
                          reinterpret_cast<uintptr_t>(a.B) | reinterpret_cast<uintptr_t>(a.C) |
                          reinterpret_cast<uintptr_t>(a.s0) |
                          reinterpret_cast<uintptr_t>(a.dsf) |
                          reinterpret_cast<uintptr_t>(a.ds0) | reinterpret_cast<uintptr_t>(a.st);
  return (a.nk == 1 || a.nk == 2) && a.n <= 64 * a.nk && a.mt >= 1 && a.mt <= 4 &&
         16 * a.mt >= a.chunk && a.p % 8 == 0 && a.n % 8 == 0 && align % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.dx) % 4 == 0;
}

cudaError_t launch_mma(const MArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tiles::kBytesA);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tiles::kBytesC);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.npb, a.h, a.b * a.nc);
  chunk_kernel<<<grid, kMmaThreads, Tiles::kBytesA, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t entries = static_cast<size_t>(a.b) * a.h * a.p * a.n / 4;
  size_t blocks = (entries + kThreads - 1) / kThreads;
  if (blocks > 8192) blocks = 8192;
  recur_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grad_kernel<<<grid, kMmaThreads, Tiles::kBytesC, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(a.b) * a.t * (a.n + a.h) + a.h;
  blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ssdb

// dtype codes (x, B, C, dy, dx, dB, dC): 0 = float32 (the f32 loop; nk, mt
// unused), 1 = bfloat16 (the tensor cores, nk and mt from kernels/ssd.py
// ssd_bwd_plan). ws is an f32 workspace of ws_floats floats (at least the
// route's workspace_floats). Returns a cudaError_t (0 = ok).
extern "C" int ssd_chunked_bwd(const void* x, const void* dt, const void* A, const void* B,
                               const void* C, const void* init_state, const void* dy,
                               const void* d_state, void* dx, void* ddt, void* dA, void* dB,
                               void* dC, void* d_init, void* ws, long long ws_floats, int b,
                               int t, int h, int p, int n, int chunk, int dtype, int nk, int mt,
                               void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || p <= 0 || n <= 0 || chunk <= 0 ||
      chunk > ssdb::kMaxChunk || !d_init || !ws)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (t + chunk - 1) / chunk;
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bh = static_cast<size_t>(b) * h;
  if (dtype == 0) {
    const int npb = (p + ssdb::kRows - 1) / ssdb::kRows;
    ssdb::Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
                 static_cast<const float*>(A), static_cast<const float*>(B),
                 static_cast<const float*>(C), static_cast<const float*>(init_state),
                 static_cast<const float*>(dy), static_cast<const float*>(d_state),
                 static_cast<float*>(dx), static_cast<float*>(ddt), static_cast<float*>(dA),
                 static_cast<float*>(dB), static_cast<float*>(dC), static_cast<float*>(d_init),
                 nullptr, nullptr, nullptr, nullptr, nullptr, b, t, h, p, n, chunk, npb, nc};
    if (ws_floats < ssdb::workspace_floats(a)) return static_cast<int>(cudaErrorInvalidValue);
    a.states = w;
    a.pdB = a.states + bh * nc * p * n;
    a.pdC = a.pdB + bh * npb * t * n;
    a.pddt = a.pdC + bh * npb * t * n;
    a.pdA = a.pddt + bh * npb * t;
    return static_cast<int>(ssdb::launch(a, s));
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  using ssd::bf16;
  const int npb = (p + ssdb::kPB - 1) / ssdb::kPB;
  ssdb::MArgs a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
                static_cast<const float*>(A), static_cast<const bf16*>(B),
                static_cast<const bf16*>(C), static_cast<const float*>(init_state),
                static_cast<const bf16*>(dy), static_cast<const float*>(d_state),
                static_cast<bf16*>(dx), static_cast<float*>(ddt), static_cast<float*>(dA),
                static_cast<bf16*>(dB), static_cast<bf16*>(dC), static_cast<float*>(d_init),
                w, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                b, t, h, p, n, chunk, nc, npb, nk, mt};
  if (ws_floats < ssdb::mma_workspace_floats(a)) return static_cast<int>(cudaErrorInvalidValue);
  a.dst = a.st + bh * nc * p * n;
  a.pdB = a.dst + bh * nc * p * n;
  a.pdC = a.pdB + bh * npb * t * n;
  a.pddt = a.pdC + bh * npb * t * n;
  a.decay = a.pddt + bh * npb * t;
  a.pdA = a.decay + bh * nc;
  if (!ssdb::mma_takes(a)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ssdb::launch_mma(a, s));
}

// The bf16 route's dynamic shared memory in bytes: stage A (0) or C (1).
extern "C" int ssd_chunked_bwd_smem(int stage) {
  return stage == 0 ? ssdb::Tiles::kBytesA : ssdb::Tiles::kBytesC;
}
