// Paged decode / verify attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `decode_attention_paged` in
// src/repro/kernels/decode_attention.py (the `_kernel` body reached through
// `_paged_kernel`): a small query window (the K+1 verify window, the 2K PARD
// draft window, or a prompt chunk) attends to a block-paged KV pool through
// per-row block tables, under the causal mask.
//
//   q       [B, Tq, Hq, D]     float32 or bfloat16
//   k, v    [NB, bs, Hkv, D]   float32, bfloat16, int8 or fp8 e4m3 pools
//   k_scale / v_scale  [NB, bs, Hkv] float32 dequant scales of 8-bit pools
//   tables  [B, MBS] int32     pool block of each row's logical block
//   kv_len  [B] int32          valid cache entries of each row
//   q_pos   [B, Tq] int32      absolute position of each query
//   out     [B, Tq, Hq, D]     q's dtype
//
// bfloat16 q with bfloat16, int8 or fp8 K/V runs the tensor-core split-KV
// loop of serve_attention_mma.cuh over a cluster of `cluster` CTAs of `warps`
// warps (kernels/decode_attention.py: split_kv_plan); float32 q, and bfloat16
// q with float32 K/V, run the f32 tile loop of attention_tile.cuh, which also
// defines the mask. What bounds each is in its header.

#include "attention_tile.cuh"
#include "serve_attention_mma.cuh"

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8, 3 = fp8 e4m3 (K/V only,
// with k_scale / v_scale). Returns a cudaError_t (0 = ok).
extern "C" int decode_attention_paged(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* tables, const void* kv_len,
                                      const void* q_pos, void* out, int b, int tq,
                                      int hq, int hkv, int d, int nb, int bs, int mbs,
                                      int q_dtype, int kv_dtype, float scale,
                                      int window, float softcap, int cluster, int warps,
                                      void* stream) {
  if (nb <= 0 || bs <= 0 || mbs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const attn::Args a{q, k, v, static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale), static_cast<const int*>(kv_len),
                     static_cast<const int*>(q_pos), nullptr, nullptr, nullptr,
                     out, tq, hq, hkv, scale, window, softcap};
  const attn::PagedKV kv{static_cast<const int*>(tables), nb, bs, mbs};
  if (q_dtype == 1 && kv_dtype != 0)
    return smma::dispatch<attn::PagedKV, false>(a, kv, b, d, kv_dtype, cluster, warps,
                                            stream);
  return attn::dispatch<attn::PagedKV, false>(a, kv, b, d, q_dtype, kv_dtype, stream);
}
