// Full-sequence causal GQA attention, backward, for Hopper (sm_90a); plain
// C interface.
//
// The TPU kernel `flash_attention` (src/repro/kernels/flash_attention.py)
// has no backward: the JAX package takes gradients by XLA autodiff of its
// jnp path. This is the gradient of the port's forward kernel
// (flash_attention.cu) for the AR training loss.
//
//   q, o, dout        [B, T, Hq, D]   float32 or bfloat16
//   k, v              [B, S, Hkv, D]  q's dtype
//   lse               [B, Hq, T]      float32, from the forward
//   delta             [B, Hq, T]      float32 scratch (rowsum(dO * O))
//   dq / dk, dv       like q / like k, q's dtype
//
// Three passes on the stream: delta, then dK/dV (one block per 64 keys of a
// kv head, over its G query heads), then dQ. No atomics: deterministic.
// The passes and what bounds them are in train_attention_mma.cuh
// (bfloat16, tensor cores) and train_attention_tile.cuh (float32).

#include "train_attention_mma.cuh"

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = ok).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, int b, int t,
                                   int s, int hq, int hkv, int d, int dtype, float scale,
                                   int causal, int window, float softcap, void* stream) {
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
  a.s = s;
  a.hq = hq;
  a.hkv = hkv;
  a.scale = scale;
  a.softcap = softcap;
  const tattn::CausalMask m{causal, window};
  return tmma::dispatch<true>(a, m, d, dtype, stream);
}

// The largest dynamic shared memory, in bytes, of this file's bfloat16
// kernels at head dim d (0 for a head dim not built).
extern "C" int flash_attention_bwd_smem(int d) { return tmma::smem_bytes(true, d); }
