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
// One thread block per (batch row, head) carries the state S [P, N] in f32
// through the chunks of L tokens, starting from init_state. Per chunk:
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
// What bounds it on an H100: at the serving shapes (t = 9 or 16, one chunk,
// P = 64, N = 128, 4 x 24 blocks) the bytes, mostly the f32 state in and
// out (3.1 MB each way at b = 4); at long t the arithmetic of the two
// [L, N] x [N, L] and [L, L] x [L, P] products and the two [P, N] state
// passes per chunk. This first version is simple: f32 FMA on the CUDA
// cores from shared memory (the state, the chunk's x, B, C and the gated
// [L, L] matrix), scalar loads, B and C re-read by every head's block;
// tensor cores and TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssd {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

// shared floats: S [P][N+1], x [L][P], B [L][N+1], C [L][N], G [L][L],
// cum [L], w [L] (rows padded by one float against bank conflicts)
inline size_t smem_floats(int p, int n, int l) {
  return static_cast<size_t>(p) * (n + 1) + static_cast<size_t>(l) * p +
         static_cast<size_t>(l) * (n + 1) + static_cast<size_t>(l) * n +
         static_cast<size_t>(l) * l + 2 * static_cast<size_t>(l);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args a) {
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int P = a.p, N = a.n, L = a.chunk, H = a.h, t = a.t;
  const int tid = threadIdx.x;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ Bm = static_cast<const T*>(a.B);
  const T* __restrict__ Cm = static_cast<const T*>(a.C);
  T* __restrict__ y = static_cast<T*>(a.y);
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
      xs[e] = tok < t ? to_f(x[((static_cast<size_t>(bb) * t + tok) * H + hh) * P + pp]) : 0.f;
    }
    for (int e = tid; e < L * N; e += kThreads) {
      const int l = e / N, nn = e % N;
      const int tok = t0 + l;
      const size_t off = (static_cast<size_t>(bb) * t + tok) * N + nn;
      Bs[l * (N + 1) + nn] = tok < t ? to_f(Bm[off]) : 0.f;
      Cs[l * N + nn] = tok < t ? to_f(Cm[off]) : 0.f;
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
      from_f(y + ((static_cast<size_t>(bb) * t + tok) * H + hh) * P + pp,
             intra + st * expf(cum[i]));
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

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.p, a.n, a.chunk) * sizeof(float);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.h, a.b);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ssd

// dtype codes (x, B, C, y): 0 = float32, 1 = bfloat16. Returns a
// cudaError_t (0 = ok).
extern "C" int ssd_chunked(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, const void* init_state, void* y, void* state,
                           int b, int t, int h, int p, int n, int chunk, int dtype,
                           void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || p <= 0 || n <= 0 || chunk <= 0 ||
      chunk > ssd::kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const ssd::Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B, C,
                    static_cast<const float*>(init_state), y, static_cast<float*>(state),
                    b, t, h, p, n, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(ssd::launch<float>(a, s));
  if (dtype == 1) return static_cast<int>(ssd::launch<__nv_bfloat16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
