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
//   D_ij   = dy_i . xdt_j                       (over the CTA's rows of P)
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
// double (chunk_cumsum).
//
// One CTA of 256 threads per (block of kRows rows of P, head, batch row):
// every term above is a sum over P of products of its own rows, so a CTA
// needs nothing from another. It first walks the chunks forward to
// recompute its rows' incoming state of each chunk into an f32 workspace
// (the autograd Function saves nothing but the inputs), then walks them
// backward with its dS slice in shared memory. dx and dinit are complete
// per CTA and go straight out; dB, dC (sums over heads and P blocks), ddt
// (over P blocks) and dA (over batch rows and P blocks) go to per-CTA
// partial sums in the workspace, which a second kernel adds in a fixed
// order. No float atomics: two calls give bitwise-equal gradients.
//
// What bounds it: at mamba2-130m's training shape (b 4, t 1024, h 24,
// P 64, N 128, L 64) the gradient needs ~10 G multiply-adds and moves
// ~0.2 GB of inputs and outputs, plus the workspace (50 MB of states,
// 200 MB of partials) written once and read once. Every product runs as
// an f32 FMA on the CUDA cores from shared memory (bf16 inputs are
// widened on load), one CTA per SM (~190 KB of shared memory at L 64, N
// 128): a simple kernel, bound by shared-memory bandwidth and the serial
// chunk walk, not by the card's peak. Tensor cores, TMA and a chunk-
// parallel state pass are later work. Rows of the [L][kRows] tiles are
// padded by one float, those of B, C and the states by one, those of the
// [L][L] tiles by one, against bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssdb {

constexpr int kThreads = 256;
constexpr int kRows = 32;              // rows of P per CTA
constexpr int kRS = kRows + 1;         // row stride of the [L][kRows] tiles
constexpr int kMaxChunk = 64;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* s0;
  const void* dy;
  const float* dsf;
  void* dx;
  float* ddt;
  float* dA;
  void* dB;
  void* dC;
  float* ds0;
  float* states;   // [b][h][nc][P][N]: each chunk's incoming state
  float* pdB;      // [b][h][npb][t][N]: partial dB of each CTA
  float* pdC;      // [b][h][npb][t][N]
  float* pddt;     // [b][h][npb][t]
  float* pdA;      // [b][h][npb]
  int b, t, h, p, n, chunk, npb, nc;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// shared: cum [L] in doubles first; then floats S, dS [kRows][N+1]; x, dy,
// dxdt, dS B, S C [L][kRS]; B, C [L][N+1]; w (C.B), w D, w (C.B) D
// [L][L+1]; dt, e, f and the per-token da, dd, e dy . S C and dxdt . x
// [L]; one float a thread for reductions
inline size_t smem_floats(int n, int l) {
  const size_t ns = n + 1, ls = l + 1;
  return 2 * static_cast<size_t>(l) + 2 * kRows * ns + 5 * static_cast<size_t>(l) * kRS +
         2 * l * ns + 3 * l * ls + 7 * static_cast<size_t>(l) + kThreads;
}

// cum = cumsum(dt A) over the chunk in double, by one thread in token
// order: w's exponent cum_i - cum_j is a difference of two sums that grow
// along the chunk, and float32 sums would lose its low digits
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
template <typename T>
__device__ __forceinline__ void stage(const Args& a, float* xs, float* dys, float* Bs,
                                      float* Cs, float* dts, int t0, int bb, int hh,
                                      int p0, bool bwd) {
  const int P = a.p, N = a.n, L = a.chunk, H = a.h, t = a.t, NS = N + 1;
  const int tid = threadIdx.x;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* Bm = static_cast<const T*>(a.B);
  const T* Cm = static_cast<const T*>(a.C);
  for (int e = tid; e < L * kRows; e += kThreads) {
    const int l = e / kRows, r = e % kRows, tok = t0 + l;
    const bool in = tok < t && p0 + r < P;
    const size_t off = in ? ((static_cast<size_t>(bb) * t + tok) * H + hh) * P + p0 + r : 0;
    xs[l * kRS + r] = in ? ld(x + off) : 0.f;
    if (bwd) dys[l * kRS + r] = in ? ld(dy + off) : 0.f;
  }
  for (int e = tid; e < L * N; e += kThreads) {
    const int l = e / N, nn = e % N, tok = t0 + l;
    const bool in = tok < t;
    const size_t off = in ? (static_cast<size_t>(bb) * t + tok) * N + nn : 0;
    Bs[l * NS + nn] = in ? ld(Bm + off) : 0.f;
    if (bwd) Cs[l * NS + nn] = in ? ld(Cm + off) : 0.f;
  }
  for (int l = tid; l < L; l += kThreads) {
    const int tok = t0 + l;
    dts[l] = tok < t ? a.dt[(static_cast<size_t>(bb) * t + tok) * H + hh] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_kernel(Args a) {
  const int pb = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int P = a.p, N = a.n, L = a.chunk, H = a.h, t = a.t, nc = a.nc, npb = a.npb;
  const int NS = N + 1, LS = L + 1;
  const int p0 = pb * kRows;
  const int tid = threadIdx.x;
  const float A = a.A[hh];
  T* dx = static_cast<T*>(a.dx);

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
    stage<T>(a, xs, dys, Bs, Cs, dts, c * L, bb, hh, p0, false);
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
    stage<T>(a, xs, dys, Bs, Cs, dts, t0, bb, hh, p0, true);
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
        st(dx + ((static_cast<size_t>(bb) * t + tok) * H + hh) * P + p0 + r, v * dts[j]);
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
template <typename T>
__global__ void __launch_bounds__(kThreads) reduce_kernel(Args a) {
  const size_t t = a.t, N = a.n, H = a.h, npb = a.npb;
  const size_t btn = static_cast<size_t>(a.b) * t * N;
  const size_t bth = static_cast<size_t>(a.b) * t * H;
  const size_t total = btn + bth + H;
  T* dB = static_cast<T*>(a.dB);
  T* dC = static_cast<T*>(a.dC);
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
      st(dB + e, sb);
      st(dC + e, sc);
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

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.n, a.chunk) * sizeof(float);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.npb, a.h, a.b);
  bwd_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(a.b) * a.t * (a.n + a.h) + a.h;
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  reduce_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ssdb

// dtype codes (x, B, C, dy, dx, dB, dC): 0 = float32, 1 = bfloat16. ws is
// an f32 workspace of ws_floats floats (at least ssdb::workspace_floats).
// Returns a cudaError_t (0 = ok).
extern "C" int ssd_chunked_bwd(const void* x, const void* dt, const void* A, const void* B,
                               const void* C, const void* init_state, const void* dy,
                               const void* d_state, void* dx, void* ddt, void* dA, void* dB,
                               void* dC, void* d_init, void* ws, long long ws_floats, int b,
                               int t, int h, int p, int n, int chunk, int dtype,
                               void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || p <= 0 || n <= 0 || chunk <= 0 ||
      chunk > ssdb::kMaxChunk || !d_init || !ws)
    return static_cast<int>(cudaErrorInvalidValue);
  const int npb = (p + ssdb::kRows - 1) / ssdb::kRows;
  const int nc = (t + chunk - 1) / chunk;
  float* w = static_cast<float*>(ws);
  ssdb::Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B, C,
               static_cast<const float*>(init_state), dy, static_cast<const float*>(d_state),
               dx, static_cast<float*>(ddt), static_cast<float*>(dA), dB, dC,
               static_cast<float*>(d_init), nullptr, nullptr, nullptr, nullptr, nullptr,
               b, t, h, p, n, chunk, npb, nc};
  if (ws_floats < ssdb::workspace_floats(a)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bh = static_cast<size_t>(b) * h;
  a.states = w;
  a.pdB = a.states + bh * nc * p * n;
  a.pdC = a.pdB + bh * npb * t * n;
  a.pddt = a.pdC + bh * npb * t * n;
  a.pdA = a.pddt + bh * npb * t;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(ssdb::launch<float>(a, s));
  if (dtype == 1) return static_cast<int>(ssdb::launch<__nv_bfloat16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
