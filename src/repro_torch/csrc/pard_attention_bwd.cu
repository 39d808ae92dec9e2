// PARD-COD training attention, backward, for Hopper (sm_90a); plain C
// interface.
//
// The TPU kernel `pard_attention` (src/repro/kernels/pard_attention.py) has
// no backward: the JAX package takes gradients by XLA autodiff of its jnp
// path. This is the gradient of pard_attention.cu for the PARD adaptation
// loss. dK/dV of a kv head sum over its G query heads inside one block.
//
//   q, o, dout        [B, T, Hq, D]   float32 or bfloat16
//   k, v              [B, T, Hkv, D]  q's dtype
//   seg, base         [B, T] int32
//   tiles             [B, nt, nt] uint8 tile classes (pard_attention.cu)
//   lse               [B, Hq, T]      float32, from the forward
//   delta             [B, Hq, T]      float32 scratch
//   dq / dk, dv       like q / like k, q's dtype
//
// Three passes, no atomics (deterministic); see train_attention_mma.cuh
// (bfloat16) and train_attention_tile.cuh (float32).

#include "train_attention_mma.cuh"

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = ok).
extern "C" int pard_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* seg, const void* base, const void* tiles,
                                  const void* o, const void* dout, const void* lse,
                                  void* delta, void* dq, void* dk, void* dv, int b, int t,
                                  int hq, int hkv, int d, int dtype, float scale,
                                  float softcap, void* stream) {
  tattn::Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.b = b;
  a.t = t;
  a.s = t;
  a.hq = hq;
  a.hkv = hkv;
  a.scale = scale;
  a.softcap = softcap;
  const tattn::CodMask m{static_cast<const int*>(seg), static_cast<const int*>(base),
                         static_cast<const unsigned char*>(tiles)};
  return tmma::dispatch<true>(a, m, d, dtype, stream);
}

// The largest dynamic shared memory, in bytes, of this file's bfloat16
// kernels at head dim d (0 for a head dim not built).
extern "C" int pard_attention_bwd_smem(int d) { return tmma::smem_bytes(true, d); }
