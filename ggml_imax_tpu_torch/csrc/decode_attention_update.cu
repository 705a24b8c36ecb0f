// Fused single-token KV write + attention over one layer of the arena, in a
// flat mode (each query row has its own arena batch row; the destination is
// the shared n_past) and a cells mode (all rows share the cell arena; the
// destination is each row's cell).
//
// Replaces: ggml_imax_tpu/ops/decode_attention.py::_kernel_upd (reached
// through _decode_attn_upd, decode_attention_update_stacked and
// decode_attention_update_cells).
//
// Computes the attention of decode_attention_cells.cu with the destination
// row left out of the arena pass (its stored contents are stale) and the
// fresh K/V row folded into the softmax as always visible, its p not
// rounded; then stores the fresh row (and its q8_0 scales) in the arena.
// The fresh rows arrive in the arena's type (bf16, or int8 + scales from
// models.common._q8_rows) and are read through the same rounding as the
// arena, so their term equals reading them back from it.
//
// Bound on the H100: bytes, the arena read once (as decode_attention_cells)
// plus the fresh rows read and written: 8.4 MB, 2.5 us, for the bf16 arena
// at T 512, Hkv*D 4096.
//
// Design (decode_split.cuh): the split pass reads the arena, skipping the
// destination rows; the fresh rows are folded in and written by the combine
// pass, which starts after every block of the split pass has finished on
// the stream. So no block ever reads a row while it is written, in either
// mode. (Rows of one cells-mode ubatch belong to distinct sequences, so a
// row's cell is masked for every other row anyway; pad rows all write the
// trash cell, which no row sees.) On the TPU this kernel lost to the
// two-step route because XLA copied the aliased arena every layer; here the
// arena is a tensor written in place and nothing is copied.
#include "decode_split.cuh"

// q (NB, Hq, D) f32; k/v the layer's (Bk, T, Hkv*D) arena slice with Bk = NB
// (flat) or 1 (cells), bf16 or int8 with ks/vs (Bk, T, Hkv*D/32) f32; kn/vn
// (NB, Hkv*D) fresh rows in the arena's type, kns/vns (NB, Hkv*D/32) f32 or
// null; rows (NB) int32 destination rows; mask (NB, T) f32; ws_acc/ws_ml as
// decode_attention_cells.cu; out (NB, Hq, D) f32.
extern "C" int ggml_decode_attention_update(const void* q, void* k, void* v, void* ks,
                                            void* vs, const void* kn, const void* vn,
                                            const void* kns, const void* vns,
                                            const void* rows, const void* mask,
                                            void* ws_acc, void* ws_ml, void* out, int NB,
                                            int Bk, int Hq, int Hkv, int D, int T,
                                            int split, float scale, void* stream) {
  split_decode::Args a{static_cast<const float*>(q), k, v, static_cast<float*>(ks),
                       static_cast<float*>(vs), static_cast<const float*>(mask),
                       static_cast<const int*>(rows), static_cast<float*>(ws_acc),
                       static_cast<float*>(ws_ml), NB, Bk, Hq, Hkv, D, T, split,
                       (T + split - 1) / split, scale};
  split_decode::Fresh f{kn, vn, static_cast<const float*>(kns),
                        static_cast<const float*>(vns)};
  return split_decode::launch<true>(a, f, static_cast<float*>(out),
                                    static_cast<cudaStream_t>(stream));
}
