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
//   tiles       [B, nt, nt]     uint8 class of each (query tile, key tile)
//                               of 64 tokens, nt = ceil(T / 64), from
//                               pard_tile_classes (read by bfloat16 only;
//                               float32 takes a null pointer)
//   out         [B, T, Hq, D]   q's dtype
//   lse         [B, Hq, T]      float32 log-sum-exp of each row
//
// The tile loops, the COD mask and what bounds them are in
// train_attention_mma.cuh (bfloat16, tensor cores) and
// train_attention_tile.cuh (float32).

#include "train_attention_mma.cuh"

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = ok).
extern "C" int pard_attention(const void* q, const void* k, const void* v, const void* seg,
                              const void* base, const void* tiles, void* out, void* lse,
                              int b, int t, int hq, int hkv, int d, int dtype, float scale,
                              float softcap, void* stream) {
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
  const tattn::CodMask m{static_cast<const int*>(seg), static_cast<const int*>(base),
                         static_cast<const unsigned char*>(tiles)};
  return tmma::dispatch<false>(a, m, d, dtype, stream);
}

// The largest dynamic shared memory, in bytes, of this file's bfloat16
// kernels at head dim d (0 for a head dim not built).
extern "C" int pard_attention_smem(int d) { return tmma::smem_bytes(false, d); }
