// Contiguous decode / verify attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention.py (the `_kernel` body under its
// contiguous BlockSpecs): the engine's `kv_layout="contiguous"` routes every
// draft window, flat verify window and prompt chunk here, under the causal
// mask, against one full-length cache row per batch row.
//
//   q       [B, Tq, Hq, D]     float32 or bfloat16
//   k, v    [B, S, Hkv, D]     float32, bfloat16, int8 or fp8 e4m3 caches
//   k_scale / v_scale  [B, S, Hkv] float32 dequant scales of 8-bit caches
//   kv_len  [B] int32          valid cache entries of each row
//   q_pos   [B, Tq] int32      absolute position of each query
//   out     [B, Tq, Hq, D]     q's dtype
//
// The TPU wrapper pads S to its 256-key block; this kernel needs no padding:
// its sweep stops at min(kv_len, S) and never reads past S. bfloat16 q with
// bfloat16, int8 or fp8 K/V runs the tensor-core split-KV loop of
// serve_attention_mma.cuh over a cluster of `cluster` CTAs of `warps` warps
// (kernels/decode_attention.py: split_kv_plan, with the reach S); float32 q,
// and bfloat16 q with float32 K/V, run the f32 tile loop of
// attention_tile.cuh, which also defines the mask. What bounds each is in its
// header.

#include "attention_tile.cuh"
#include "serve_attention_mma.cuh"

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8, 3 = fp8 e4m3 (K/V only,
// with k_scale / v_scale). Returns a cudaError_t (0 = ok).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* kv_len, const void* q_pos, void* out,
                                int b, int tq, int hq, int hkv, int d, int s,
                                int q_dtype, int kv_dtype, float scale, int window,
                                float softcap, int cluster, int warps, void* stream) {
  if (s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const attn::Args a{q, k, v, static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale), static_cast<const int*>(kv_len),
                     static_cast<const int*>(q_pos), nullptr, nullptr, nullptr,
                     out, tq, hq, hkv, scale, window, softcap};
  const attn::ContigKV kv{s};
  if (q_dtype == 1 && kv_dtype != 0)
    return smma::dispatch<attn::ContigKV, false>(a, kv, b, d, kv_dtype, cluster, warps,
                                            stream);
  return attn::dispatch<attn::ContigKV, false>(a, kv, b, d, q_dtype, kv_dtype, stream);
}
