// Paged tree-verification attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel `tree_attention_paged` in
// src/repro/kernels/tree_attention.py (the `_kernel` body reached through
// `_paged_kernel`): the packed candidate-tree verify window (and, in tree
// mode, prefilling rows' prompt chunks as causal "trees") attends to a
// block-paged KV pool under the ancestor-bitmask tree mask.
//
//   q          [B, Tq, Hq, D]     float32 or bfloat16, Tq <= 32
//   k, v       [NB, bs, Hkv, D]   float32, bfloat16, int8 or fp8 e4m3 pools
//   k_scale / v_scale  [NB, bs, Hkv] float32 dequant scales of 8-bit pools
//   tables     [B, MBS] int32     pool block of each row's logical block
//   kv_len     [B] int32          valid cache entries of each row
//   q_pos      [B, Tq] int32      LOGICAL position of each query (root+depth)
//   win_start  [B] int32          cache slot of window slot 0
//   win_len    [B] int32          meaningful window slots of each row
//   anc        [B, Tq] uint32     ancestor-or-self bitmask of each query
//   out        [B, Tq, Hq, D]     q's dtype
//
// Each row's sweep stops at min(kv_len, win_start + win_len), so a narrow
// template's row streams only its own window. bfloat16 q with bfloat16, int8
// or fp8 K/V runs the tensor-core split-KV loop of serve_attention_mma.cuh
// over a cluster of `cluster` CTAs of `warps` warps
// (kernels/decode_attention.py: split_kv_plan); float32 q, and bfloat16 q
// with float32 K/V, run the f32 tile loop of attention_tile.cuh, which also
// defines the mask. What bounds each is in its header.

#include "attention_tile.cuh"
#include "serve_attention_mma.cuh"

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8, 3 = fp8 e4m3 (K/V only,
// with k_scale / v_scale). Returns a cudaError_t (0 = ok).
extern "C" int tree_attention_paged(const void* q, const void* k, const void* v,
                                    const void* k_scale, const void* v_scale,
                                    const void* tables, const void* kv_len,
                                    const void* q_pos, const void* win_start,
                                    const void* win_len, const void* anc, void* out,
                                    int b, int tq, int hq, int hkv, int d, int nb,
                                    int bs, int mbs, int q_dtype, int kv_dtype,
                                    float scale, int window, float softcap,
                                    int cluster, int warps, void* stream) {
  if (nb <= 0 || bs <= 0 || mbs <= 0 || tq > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::Args a{q, k, v, static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale), static_cast<const int*>(kv_len),
                     static_cast<const int*>(q_pos), static_cast<const int*>(win_start),
                     static_cast<const int*>(win_len), static_cast<const uint32_t*>(anc),
                     out, tq, hq, hkv, scale, window, softcap};
  const attn::PagedKV kv{static_cast<const int*>(tables), nb, bs, mbs};
  if (q_dtype == 1 && kv_dtype != 0)
    return smma::dispatch<attn::PagedKV, true>(a, kv, b, d, kv_dtype, cluster, warps,
                                            stream);
  return attn::dispatch<attn::PagedKV, true>(a, kv, b, d, q_dtype, kv_dtype, stream);
}
