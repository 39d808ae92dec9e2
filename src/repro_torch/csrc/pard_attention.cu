// PARD-COD training attention, forward, for Hopper (sm_90a); plain C
// interface.
//
// Replaces the TPU kernel `pard_attention` in
// src/repro/kernels/pard_attention.py: every attention of the PARD
// adaptation loss over a packed COD batch. The mask is built in the kernel
// from per-token (segment, base); no [T, T] mask exists in memory.
//
//   q           [B, T, Hq, D]   float32 or bfloat16
//   k, v        [B, T, Hkv, D]  q's dtype (GQA: head h reads kv head
//                               h / (Hq / Hkv); the TPU wrapper repeats KV)
//   seg, base   [B, T] int32    segment 0 = padding (sees nothing, output 0)
//   out         [B, T, Hq, D]   q's dtype
//   lse         [B, Hq, T]      float32 log-sum-exp of each row
//
// The tile loop, the COD mask and what bounds it are in
// train_attention_tile.cuh.

#include "train_attention_tile.cuh"

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = ok).
extern "C" int pard_attention(const void* q, const void* k, const void* v, const void* seg,
                              const void* base, void* out, void* lse, int b, int t, int hq,
                              int hkv, int d, int dtype, float scale, float softcap,
                              void* stream) {
  tattn::Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.b = b;
  a.t = t;
  a.s = t;
  a.hq = hq;
  a.hkv = hkv;
  a.scale = scale;
  a.softcap = softcap;
  const tattn::CodMask m{static_cast<const int*>(seg), static_cast<const int*>(base)};
  return tattn::dispatch<false>(a, m, d, dtype, stream);
}
