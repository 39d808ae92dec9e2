// Full-sequence causal GQA attention, forward, for Hopper (sm_90a); plain C
// interface.
//
// Replaces the TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (reached through ops.flash_attention
// from the cache-free forward): every attention of the AR training loss.
//
//   q        [B, T, Hq, D]   float32 or bfloat16
//   k, v     [B, S, Hkv, D]  q's dtype
//   out      [B, T, Hq, D]   q's dtype
//   lse      [B, Hq, T]      float32 log-sum-exp of each row (for backward)
//
// Query i and key j count from 0; key j is visible iff j < S, j <= i (when
// causal) and j > i - window (when window > 0). Unlike the TPU wrapper, T
// and S are not padded: the tiles mask their ragged edge. bfloat16 runs on
// the tensor cores (train_attention_mma.cuh: the design and what bounds
// it), float32 on the f32 loop of train_attention_tile.cuh.

#include "train_attention_mma.cuh"

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = ok).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               void* lse, int b, int t, int s, int hq, int hkv, int d,
                               int dtype, float scale, int causal, int window,
                               float softcap, void* stream) {
  tattn::Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.b = b;
  a.t = t;
  a.s = s;
  a.hq = hq;
  a.hkv = hkv;
  a.scale = scale;
  a.softcap = softcap;
  const tattn::CausalMask m{causal, window};
  return tmma::dispatch<false>(a, m, d, dtype, stream);
}

// The largest dynamic shared memory, in bytes, of this file's bfloat16
// kernels at head dim d (0 for a head dim not built).
extern "C" int flash_attention_smem(int d) { return tmma::smem_bytes(false, d); }
