// Read-only single-token attention for NB query rows of distinct sequences
// over the shared cell arena of continuous batching (one layer).
//
// Replaces: ggml_imax_tpu/ops/decode_attention.py::_kernel_cellsb (reached
// through decode_attention_cells / _decode_attn(cells=True)).
//
// The arena has batch 1 and holds every sequence's cells; row n's mask
// (NB, T) says which cells it sees (models.common.cells_attention_mask).
// The rows' fresh K/V are already in the arena (update_kv_cells). A pad row
// (every cell masked) gets the mean of V, as in the reference.
//
// Bound on the H100: bytes. Every K/V element of the layer is used by all
// NB * Hq/Hkv query rows of its kv head, so the floor is the arena read
// once: 2 * T * Hkv * D elements at 2 bytes (bf16) or 1 + 4/32 (q8_0),
// over 3.35 TB/s (5.6 us for q8_0 at T 2048, Hkv*D 4096).
//
// Design (decode_split.cuh): the TPU kernel made one arena pass per layer
// for all rows; here one block per (64-key slice, kv head) holds all the
// rows that share the arena, so each K/V element is read once (for
// NB * g_rep <= 16 rows; more rows take more passes over the slice, from
// L2), and 16 kv heads x 32 slices at T 2048 fill the card with 512 blocks.
// A second small pass merges the slices' partial softmaxes.
#include "decode_split.cuh"

// q (NB, Hq, D) f32; k/v the layer's (1, T, Hkv*D) arena slice, bf16
// (ks = vs = null) or int8 with ks/vs (1, T, Hkv*D/32) f32; mask (NB, T)
// f32; ws_acc (NB, Hq, ceil(T/split), D) and ws_ml (.., 2) f32 scratch;
// out (NB, Hq, D) f32. D % 32 == 0, D <= 256, split <= 64, Hq % Hkv == 0.
extern "C" int ggml_decode_attention_cells(const void* q, void* k, void* v, void* ks,
                                           void* vs, const void* mask, void* ws_acc,
                                           void* ws_ml, void* out, int NB, int Hq,
                                           int Hkv, int D, int T, int split, float scale,
                                           void* stream) {
  split_decode::Args a{static_cast<const float*>(q), k, v, static_cast<float*>(ks),
                       static_cast<float*>(vs), static_cast<const float*>(mask),
                       static_cast<float*>(ws_acc), static_cast<float*>(ws_ml), NB, 1, Hq,
                       Hkv, D, T, split, (T + split - 1) / split, scale};
  return split_decode::launch(a, static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}
