#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one NVIDIA GPU: GPT-J-6B Q4_0
(one stream, with the q4 residencies, and continuous-batching serving),
GPT-2 1558M (XL) Q8_0 and Q5_K, GPT-2 117M training steps, GPT-2 117M in
Q3_K and Q2_K (with the row-pair and u-order int8 layouts) and in Q4_0,
Q4_1, Q5_0, Q5_1, Q5_K and Q6_K and in the nine IQ formats, LLaMA-2 7B in
Q4_K, in the Q4_K_M mix (one stream and serving) and in the IQ4_XS mix
(with its bf16 residency), and Whisper small and medium in Q5_0 (each
through the transcription pipeline, eager and as CUDA-graph replay, with
DTW token timestamps); then GPT-J-6B, LLaMA-2 7B Q4_K_M, Whisper small and
GPT-2 117M from model files through the port's loaders and tokenizers; then
the quantization tools: LLaMA-2 7B F16 -> Q4_0 and its perplexity, GPT-2
117M's imatrix, IQ encoders and W4A8 quality rows; then Magika,
YOLOv3-tiny and SAM ViT-B from model files; then MNIST's FC net and CNN
trained (Adam and L-BFGS) and exported, and GPT-J-6B's decode step
exported and replayed from the saved graph; then the parallel paths:
GPT-J-6B and LLaMA-2 7B tensor-parallel decode, the ring prefill, a
pipeline and a sharded GGUF load, as two gloo processes sharing the card;
and the entry points: every example CLI on those files, the serving
benchmark CLI, and the quantization quality gate trained on the card.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):

1. setup: device facts, `nvidia-smi` name and power limit, the kernel build
   from ggml_imax_tpu_torch/csrc (nvcc -Xptxas -v summary);
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the main paths' shapes (GPT-J: natpair W4A8 at m 1 (with
   the K split w4a8_plan took, and its time at other K splits), W4A16 (M
   512, the serving ubatches M 8 and 128, each with the route and K split
   it took, and its time at other K splits), decode attention (with the
   cluster split decode_plan took, and its time at splits 1, 2, 4, 8), flash
   (and a row that sees no key at a ragged Tk of 200, 300 and 600);
   serving:
   cells decode attention at 8 rows over a 2048-cell arena and the fused
   KV-update kernel in cells mode at 8 rows x 2048 (each with its time at
   cluster splits 1, 2, 4, 8), the fused kernel in flat mode at T 512,
   these timed led, flash at a mixed ubatch's 128 rows over that q8_0
   arena; GPT-2 XL: nat8 W8A8 on fc_w (timed led, its unled time and its
   time at each K split nat8_gemv_plan may take logged beside, with the
   clusters of 2-8 blocks the card runs at once), W8A16 on fc_w at M 512,
   5, 8 and 128 (per-32
   f32 scales, and per-16 bf16 scales with a bias), each with the route
   and K split it took and its time at other K splits, flash at D = 64;
   GPT-2 117M training:
   flash with lse and the backward's tile map, dQ and dK/dV kernels at B 8,
   T 512, 12 heads of 64 (causal, and a sliding window of 128), with the
   share of tiles computed, the backward kernels also at D 256 and on a
   ragged GQA + softcap + ALiBi case with a fully masked row; dx through the
   W4A16 and W8A16 routes against the plain routes; GPT-2 117M K-quants: the
   plane-split W4A16 kernel on Q3_K and Q2_K weights, the row-pair W4A16
   on Q4_0 and the u-order W8A16 on Q8_0, at attn_w 768x2304 and out_w
   3072x768, M 1 and 8 (the GEMV route) and 512 (the tile route), each
   with the route and K split it took, and a 4096x16384 sizing shape that
   is on no path); LLaMA-2 7B Q4_K: natpair W4A8 with bf16 scales and a
   bias at the fused graph's five products, W4A16 with the bias at M 512
   on qkv_w, gu_w, down_w and the head, decode attention at 32 kv heads of 128 (S 4,
   bf16 and q8_0, and its time at splits 1, 2, 4, 8) and the fused
   KV-update kernel in flat mode there, flash at 512 x 512 over 32 heads
   of 128); LLaMA-2 7B Q4_K_M serving (phase 9b): the cells attention and
   the fused KV-update kernel in cells mode at 8 rows over 2048 cells, 32
   kv heads of 128 (decode_plan(1, 32, 2048)), q8_0 and bf16, and W4A16
   with bf16 scales and a bias at M 8 and 128 on qkv_w, gu_w and down_w;
   the instances the new formats put on a path: nat8 W8A8 and
   W8A16 at g 16, bf16 scales, no bias on LLaMA-2 7B Q4_K_M's Q6_K v_w,
   down_w and head (M 1, 8, 512; v_w and down_w also at M 128), at g 32 with f32 scales and a bias on
   GPT-2 XL Q5_K's fc_w (M 1, 5, 8, 128, 512), and W4A8 / W4A16 with f32
   scales and a bias on GPT-2 117M Q4_1's attn_w (M 1, 8, 512)); Whisper's
   (phase 10): flash with no mask at Tq = Tk = 1500 (padded keys 1536) over
   12 and 16 heads of 64 and at B 5, Tq 4, Tk 1500, nat8 W8A16 on Q5_0
   weights at mlp0_w M 1500 and qkv_w M 20 and 5, W8A8 on the head padded
   to 768 x 51968, and conv_1d against f64 (f32, not TF32)); phase 15's
   local shapes (check_parallel_kernels: GPT-J-6B and LLaMA-2 7B tp 2's
   W4A8 and W4A16 at M 448, decode attention and flash at the local
   heads, the pipeline's MLP products at M 128), with its
   time (CUDA
   events, L2 flushed before each launch), the plain version's time, one
   PyTorch library call computing the same function (a yardstick only: the
   port never calls it) and the least time the card could take (bound);
3. small models: a 2-layer GPT-J with head_dim 256, and a 2-layer GPT-2
   with head_dim 64 in Q8_0 and in Q4_0, and at n_embd 256 in Q3_K, Q2_K,
   row-pair Q4_0 and u-order Q8_0, and a 2-layer LLaMA in Q4_K (head_dim
   128, GQA 2:1, n_ff 768 padded to 1024; default and fused KV-update
   routes, bf16 and q8_0 KV), on the card (kernels) against the same
   model on the CPU (plain versions), prefill + decode, and the small
   LLaMA's decode-only celled ubatch of 2 rows through both cells routes;
   a 2 + 2-layer Whisper (head_dim 64, 150 audio positions, Q5_0, the
   head padded) on the card against the CPU: encode, cross K/V, the
   prompt and 4 fed steps with exact launch counts (SMALL_WHISPER_TOL);
   and the small
   GPT-J's BatchedEngine (two requests and a fork, q8_0 KV, both cells
   routes) on the card against the CPU, ubatch by ubatch; then
   generate(chunk=4) of the small GPT-J and LLaMA (both KV types, default
   and fused routes) and GPT-2 Q8_0 on the card (captured decode spans, then their
   replays), whose greedy tokens must equal generate(chunk=1) on the card
   and on the CPU, and the small GPT-J BatchedEngine's run_pipelined(4)
   against its step() loop on the card (equal tokens, every cell freed);
4. GPT-J engine: synthetic GPT-J-6B Q4_0 drawn on the card, prepare_fused +
   natpair repack, Engine(n_ctx=512) serving N_REQUESTS requests of a
   448-token prompt + N_PREDICT greedy tokens, with the launch counts of
   that run; then the
   device busy share of a prefill and of decode steps (torch.profiler
   kernel time against the unprofiled TTFT and step time), and W4A16's
   and the flash forward's (with its tile map) share of the device time;
   then the same requests through generate(chunk=8) (decode spans
   captured as CUDA graphs in a warm-up request, then replayed): tokens
   equal to the chunk-1 run's request by request, the same exact launch
   counts, TTFT, tok/s, ms a token, the capture seconds, the graph pool's
   bytes and a replayed span's device busy share; and a control, the
   spans captured without their n_past advance, which must fail the token
   check; then Engine(residency="q4-fused") and Engine(residency=
   "q4-stacked") built from unprepared draws of the same weights (each
   draw freed once prepared), one request each with exact launch counts
   (q4-stacked: 28 decode_attention_update a step for 28 decode_attention):
   q4-fused's tokens and KV arena equal the prepared engine's bit for bit,
   q4-stacked's equal an Engine(fused_kv_update=True) on the prepared
   weights;
5. GPT-2 XL engine: synthetic GPT-2 1558M Q8_0 drawn on the card,
   prepare_fused + nat8 repack, Engine(n_ctx=1024), the same requests,
   launch counts and profile (with nat8 W8A16's and the flash forward's
   share of the prefill's device time, nat8 W8A8's time a launch in a
   decode step), and the device time of the
   products the reference's N % 128 gate leaves to dequantize + matmul
   (attn_w, proj_w, out_w, the tied LM head) against the step's device
   time; then one request through generate(chunk=8) (the W8A8 GEMV inside
   a graph): tokens equal to chunk 1's, 48 W8A8 launches a decode token;
5b. GPT-2 XL Q5_K: the reference benchmark's structural Q5_K draw on the
   card (raw levels [0, 31], per-32 f32 scale and bias -min),
   params_repack, Engine(n_ctx=1024), one request of phase 4's shape with
   exact launch counts (48 nat8 W8A8 a decode step, 48 W8A16 a prefill:
   fc_w only), profiled as phase 5, then through generate(chunk=8): tokens
   and KV arena bit-equal to chunk 1's;
6. GPT-J serving: synthetic GPT-J-6B Q4_0, BatchedEngine(n_ctx=2048, q8_0
   KV arena, on-device sampling) under the workload of the reference's
   `examples/serve.py --bench` (8 requests arriving every 4 engine steps,
   64-127-token prompts, 32 tokens each at temp 0.8 / top_k 40 / top_p
   0.95, step_chunk(8), each chunk a captured CUDA graph), once to warm
   up and once timed; then timed in the `--steady` form (the decode tail,
   once every request is past its prompt, through run_pipelined(8)):
   aggregate tok/s, p50 TTFT, ubatch counts, exact launch counts, peak
   memory of each, the tail's ms a ubatch, the device busy share of a
   decode-only ubatch and W4A16's and the cells kernel's share of it;
   run_pipelined(8) against the step() loop on a greedy pass (equal
   tokens, every cell freed); then a
   short greedy serving pass (two mixed ubatches, a fork, decode-only
   ubatches) held to the same pass
   with every kernel's plain version on the card, and the fused KV-update
   routes on that pass and on Engine decode steps held to the default
   routes (equal tokens, logits within ROUTE_TOL; the fused Engine also
   through a replayed generate(chunk=8), equal tokens and launch counts);
   two planted faults of the fused kernel must fail that check;
7. GPT-2 117M training: synthetic F32 weights (124.4 M params), batch
   8 x 512 tokens, a fresh f32 KV cache per loss call, the mean NLL of
   log_softmax, AdamW (alpha 1e-4) through optimize.opt: 2 warm-up steps,
   then 10 timed ones through opt_resume (ms/step, train tok/s, the loss
   must fall, exact launch counts: 12 flash forwards, 12 tile maps (one a
   forward, kept for its backward) and 12 of each backward kernel (dQ,
   dK/dV) a step, nothing else), the device
   busy share of one profiled step with the flash kernels' and the KV
   arena's CopySlices share and each backward kernel's time a launch;
   then one step's loss and gradients with the kernels held to the same
   step with every plain version on the card (TRAIN_TOL), and a planted
   fault (dK without its scale) that must fail that check;
8. GPT-2 117M K-quants at a sixth of its depth (GPT2_117M_HOST: 2 layers of
   768, the script's time limit): synthetic weights drawn on the host
   in Q3_K (the reference's numpy stream and codecs, the quantization
   spread over HOST_WORKERS processes, bit-identical to
   gpt2.synthetic_params; 8b too), params_repack (every
   layer weight to the plane-split layout), Engine(n_ctx=1024) serving the
   requests of phases 4-5 with exact launch counts, the device busy
   share of a prefill and of a decode step and the device time of the
   gated LM head (dequantize + matmul, N 50257); Q2_K, and the legacy
   layouts (Q4_0 through repack_rowpair, Q8_0 through repack_int8_rows),
   one request each; then a short greedy pass of each with the kernels
   held to the same with every plain version on the card (KQ_ROUTE_TOL),
   and a planted fault (the plane-split kernel with its low and high
   scale rows swapped) that must fail that check;
8b. GPT-2 117M formats at a sixth of its depth: synthetic weights drawn on the host
   and quantized by the port's codecs in Q4_0 (the default natpair route),
   Q4_1 (natpair with a bias), Q5_0, Q5_1, Q5_K and Q6_K (nat8), each
   params_repack-ed and served by Engine(n_ctx=1024), one request each
   with exact launch counts and the seconds of the host quantization; then
   a short greedy pass of each with the kernels held to every plain
   version on the card (KQ_ROUTE_TOL), and a planted fault (the nat8 W8A8
   GEMV without its bias term, on Q5_K) that must fail that check;
8c. GPT-2 117M IQ formats at a sixth of its depth: IQ4_NL and IQ4_XS quantized on
   the host by the
   port's codecs (HOST_WORKERS processes), params_repack (nat8 g 32, f32
   scales, no bias), one request each with exact launch counts, a short
   greedy pass held to every plain version on the card (KQ_ROUTE_TOL) and
   a planted fault (the W8A8 fed the scales shifted by a group) that must
   fail it; IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S and IQ1_M from
   random blocks (codecs.random_blocks) laid out on the card by
   to_device_format (nib2, nib4 with a lut, dense; wte too, so get_rows
   expands them on the card), one request each (flash and its map the only
   kernels: these layouts take dequantize + matmul), a teacher-forced pass
   held to the same on the CPU (CODEBOOK_TOL), and a planted fault (a
   lut's entries 0 and 1 swapped; IQ1: IQ1_DELTA's sign flipped) that must
   fail it;
9. LLaMA-2 7B Q4_K: synthetic weights drawn on the card (the reference
   benchmark's llama2-7b-q4_k: uniform nibbles, per-32 scales and mins),
   prepare_fused (q/k/v fused, gate/up fused with n_ff 11008 padded to
   11264) + natpair repack with bf16 scales and bias, Engine(n_ctx=512)
   serving the requests of phase 4 with exact launch counts (per decode
   step 129 W4A8 and 32 decode attention, per prefill 129 W4A16 and 32
   flash with their maps), profiled as phase 4; the same requests through
   generate(chunk=8), tokens and KV arena bit-equal to chunk 1's; then a
   teacher-forced pass (64-token prompt + 8 steps) with the kernels held
   to the same pass with every plain version on the card
   (LLAMA_ROUTE_TOL), and a planted fault (W4A8 without its bias term)
   that must fail that check;
9b. LLaMA-2 7B Q4_K_M: the structural draw with llama.cpp's Q4_K_M mix
   (`output` Q6_K, attn_v and ffn_down Q6_K in the 16 layers use_more_bits
   picks, the rest Q4_K), prepare_fused refused (a mixed layer's q/k/v
   differ in type), fuse_gate_up alone, params_repack with bf16 scales
   (Q4_K natpair, Q6_K nat8 g 16), Engine(n_ctx=512) serving phase 9's 3
   requests with exact launch counts (a decode step 160 W4A8, 33 nat8 W8A8
   and 32 decode attention; a prefill 160 W4A16, 33 nat8 W8A16, 32 flash
   with their maps), profiled; then through generate(chunk=8), tokens and
   KV arena bit-equal; a teacher-forced pass held to every plain version
   on the card (Q4KM_ROUTE_TOL; the plain pass read beside itself with
   the A16 products summed in f64), and a planted fault (the Q6_K W8A8 fed
   g 32 in place of g 16) that must fail that check; then the
   same weights served: BatchedEngine under phase 6's workload (n_ctx 2048,
   q8_0 cells, 8 requests every 4 steps, step_chunk(8), then --steady
   through run_pipelined(8)): tok/s, p50 TTFT, exact launches (160 W4A16
   and 33 nat8 W8A16 a ubatch, 32 cells attention a decode-only one, 32
   flash and maps a mixed one), a decode-only ubatch's busy share; the
   short serving pass with every plain version on the card and the fused
   KV-update route (cells mode), each fed the default pass's tokens, held
   to it (Q4KM_ROUTE_TOL), and the fused route with the fresh row one cell
   off, which must fail;
9c. LLaMA-2 7B IQ4_XS: the structural draw in llama.cpp's IQ4_XS mix
   (`output` Q6_K, every other 2-D weight IQ4_XS: int8 table values,
   per-32 f32 scales), prepare_fused (q/k/v fused, gate/up with n_ff
   padded to 11264), params_repack (nat8 g 32 f32, the head nat8 g 16),
   Engine(n_ctx=512) serving phase 9's requests with exact launch counts
   (a decode step 129 nat8 W8A8 and 32 decode attention, a prefill 129
   nat8 W8A16 and 32 flash with their maps, no W4A8 / W4A16), profiled;
   then through generate(chunk=8), tokens and KV arena bit-equal; a
   teacher-forced pass held to every plain version on the card
   (IQ4XS_ROUTE_TOL) and a planted fault (the W8A8 fed the scales shifted
   by a group) that must fail it; then Engine(residency="bf16") on the
   same weights: one request (TTFT, tok/s, resident GiB), the teacher-
   forced pass held to the plain-version pass (BF16_RESIDENCY_TOL), and
   its weights freed once the engine is dropped;
10. Whisper Q5_0 (tools/bench_models.py's whisper-small-q5_0,
   whisper-small-rtf and whisper-medium-q5_0): 10a Whisper small (12 + 12
   layers of 768) drawn on the card (synthetic_params_device), the head
   padded 51865 -> 51968, prepare_fused + params_repack: the encoder and
   the cross K/V of one 30 s mel (ms a chunk, 96 nat8 W8A16 and 12 flash an
   encode), 3 x WHISPER_TOKENS greedy tokens from sot at one row, eager
   (ms a token, tok/s, 73 W8A8 a step), each with its device busy share; the route
   check: the same pass (encode, prompt, 8 steps) with every plain version
   on the card, its logits within ROUTE_TOL and, forced op by op on the
   kernels' pass, every op within WHISPER_ROUTE_TOL, and a planted fault
   (the encoder's 36 padded keys counted as visible) that must fail it;
   10b WhisperPipeline on the same weights with the head unpadded
   (dequantize + matmul), beam 5, one temperature, WHISPER_TOKENS a
   window: a 30 s warm-up, then WHISPER_AUDIO_S of default_rng(3) noise x
   0.1 through the eager route and through the captured steps (CUDA-graph
   replay): RTF,
   segments, tokens, exact launch counts (per window an encode, the prompt
   of 5 rows x 4 tokens and 72 W8A16 a beam step; the captured route's
   equal to the eager one's), the captured route's tokens, avg_logprob and
   KV cache after every window equal to the eager route's bit for bit, and
   a control (the captured steps with n_past frozen) that must fail that
   check; a beam step eager and captured, wall against device busy, and
   the gated head's device time; then the same audio with token_timestamps:
   the timestamp pass's device and host (median filter, DTW) seconds, its
   launches, token_times monotone; 10c Whisper medium (24 + 24 layers of
   1024) as 10a without the route check, and 10d its pipeline as 10b.
11. model files through the loaders and tokenizers (the path of the
   reference's CLIs: file -> loader -> tokenizer -> Engine or
   WhisperPipeline -> text): each file written by the port's own writers
   under build/loaders (the free space checked first), its raw blocks drawn
   on the host from a seed with finite f16 scales, loaded, checked and
   deleted before the next: 11a GPT-J-6B Q4_0 .bin (gptj.load_legacy,
   Engine(residency="q4-fused")), 11b LLaMA-2 7B Q4_K_M GGUF (llama.cpp's
   keys and names, a byte-level vocab of 32000 with 300 merges;
   llama.load_gguf, "q4-fused" refused, fuse_gate_up + params_repack with
   bf16 scales), 11c Whisper small Q5_0 .bin in whisper.cpp's layout
   (whisper.load_legacy, WhisperPipeline on 30 s of phase 10's audio, beam
   5, the captured steps) and 11d GPT-2 117M Q4_0 .bin (gpt2.load_legacy,
   "q4-fused"): every loaded tensor bit-equal on the card to the direct
   build of the bytes written, dequantize_qtensor of the first and last
   layer's largest weight bit-equal to codecs.dequantize of its bytes, the
   tokenizer's round trip on LOADER_TEXT, one request of its first 448 ids
   + N_PREDICT greedy tokens (the transcript for Whisper) with exact launch
   counts; the file's bytes and write seconds, the load seconds
   (eng.perf.load_us, eng.perf.report()), the prepare seconds, TTFT and
   tok/s or RTF, peak memory. Phase 3 adds a small GPT-J .bin and LLaMA
   Q4_K_M GGUF loaded on the card and the CPU: bit-equal tensors, then
   held card vs CPU as the other small models.
12. the quantization tools (the reference's examples/quantize.py, then
   examples/perplexity.py), files under build/quant_tools (the free space
   checked first), each deleted once its step is done; the host C++
   libraries (native/codecs.cpp, native/iq_encoders.cpp) are built by g++
   in phase 1. 12a LLaMA-2 7B (8 of its 32 layers): F16 weights drawn on
   the card from a torch.Generator, a GGUF written by GGUFWriter (phase
   11b's keys and tokenizer), requantized to Q4_0 by examples/quantize.py
   (16e; requantize_gguf on the C++ codecs) (file type and
   every other key's wire type kept, 1-D tensors byte for byte, the first
   and last layers' seven weights, token_embd and output equal to the
   numpy quantize_q4_0 of the dequantized source); tools.perplexity over
   4 windows of 512 tokens of LOADER_TEXT's file (the loaded tokenizer's ids) on
   the F16 model (dense on the card) and on the Q4_0 model (fuse_gate_up +
   params_repack: 6 L + 1 natpair W4A16, L flash and L tile maps a window),
   its mean NLL within PPL_ROUTE_TOL of the same windows on every plain
   version, two planted W4A16 faults past it; then examples/perplexity.py
   (16e) on the Q4_0 file and the text file, the loaded layout as the JAX
   CLI runs it, its perplexity within PPL_ROUTE_TOL of the kernels'. 12b GPT-2 117M: an F16
   legacy .bin (wte at WTE_SCALE: peaked logits), the imatrix
   (ImatrixCollector over tools.perplexity, 4 windows of 512) held to a
   recorder of the first and last layers' activations and refused inside
   a CUDA graph capture; requantize_legacy_bin to Q4_0 of those two
   layers with their imatrix rows (equal to quantize_rows, and a lower
   importance-weighted error than plain Q4_0); the IQ encoders on the
   golden fixture and layer 0's fc_w in IQ2_XS through qmatmul; the W4A8
   quality rows (tools/quality_tpu_row.py's method): Q4_0, Q4_K and Q5_0,
   a teacher-forced T=1 window of QUALITY_CTX through the W4A8 / W8A8
   kernels (48 launches a step) against the plain route with the "w4a8" sim, mean
   KL under tools/quality_kernel_row.py's KL_GATE (5e-3, the reference's
   kernel-path gate), the Q4_K row with the W4A8 bias dropped over it.
13. Magika, YOLOv3-tiny and SAM ViT-B at their published widths, from
   model files the phase writes under build/vision and deletes once
   loaded (no TPU kernel lies on this path: the launch counts stay 0).
   13a Magika: a GGUF of the seeded weights, identify on five of the
   repo's own files, the card's probabilities within MAGIKA_PROB_TOL of
   the CPU pass's, the labels equal. 13b YOLOv3-tiny (16..1024, 80
   classes, 416 x 416): a GGUF with batch-norm tensors folded at load,
   detect on a seeded 3 x 480 x 640 image (detections, wall ms), both
   head maps against the CPU pass at VISION_CONV_NMSE; a planted fault
   (upscale by tiling) must fail that check. 13c SAM ViT-B (1024 x 1024):
   a legacy .bin loaded by load_legacy, predict on a seeded 720 x 1280
   image with one point (encode and decode ms by CUDA events, the three
   IoUs), the embedding and the mask logits at full width and
   SAM_CPU_LAYERS encoder layers against the CPU pass at
   VISION_BLOCK_NMSE; a planted fault (rel_h and rel_w swapped in
   add_rel_pos) must fail it.
14. MNIST, L-BFGS and graph export. 14a: the FC net (784-500-10) and the
   CNN (8 and 16 channels, 10 classes) trained full-batch with the
   reference's Adam (FC 150 iterations at 5e-3, CNN 60 at 1e-2, stopping
   where its convergence tests stop) on MNIST_N images of the JAX tests'
   synthetic_digits recipe drawn on the card (ms an iteration, accuracy
   over the JAX tests' bars), the first 5 losses on MNIST_SUBSET of them
   held to the port on the CPU (MNIST_CPU_RTOL). 14b: L-BFGS
   (default_params("lbfgs")) on test_optimize.py's least squares (x within
   1e-3 of lstsq's), then on the FC net for up to LBFGS_ITERS iterations
   (the loss must fall; evaluations an iteration), the subset's losses and
   evaluation counts held to the CPU's. 14c: both trained nets through
   export_model / load_model under build/export (deleted after), the
   reloaded logits within EXPORT_TOL of the eager forward's. 14d, run
   inside phase 4 on its prepared GPT-J-6B weights: the decode step
   exported by export_graph (the weights and the KV arena as arguments,
   the kernels as ops/library's custom ops), saved, loaded, and replayed
   EXPORT_STEPS greedy steps after the eager prefill of phase 4's first
   prompt: its tokens equal to phase 4's eager run and the eager steps',
   its logits and KV arena bit-equal to theirs, 2 L + 1 W4A8 and L
   decode attention launches a step, no tensor stored in the file (trace,
   save and load seconds, the file's bytes); a planted fault (W4A8 with
   each byte's nibbles swapped, as the w4a8_gemv op's CUDA implementation)
   must fail that check.

15. the parallel paths (parallel/tp.py, ring_attention.py, pipeline.py,
   io/sharded.py): PARALLEL_RANKS processes spawned by
   parallel.distributed.spawn over gloo (NCCL refuses two ranks on one
   device), every rank on cuda:0, a file:// rendezvous under
   build/parallel; the rank bodies are this script's functions. 15a
   GPT-J-6B tp 2 at full width and depth: phase 4's draw, prepare_fused;
   rank 0 runs the single-device reference (phase 4's first prompt, then
   TP_STEPS greedy steps, bf16 and q8_0 arenas), every rank shards
   (shard_params_tp), frees the whole, repacks its shard and runs
   forward_tp fed the reference's tokens: check_forced at TP_TOL, every
   rank's logits equal, exact launches; a planted fault (rank 1's partial
   left out of one all_reduce) must fail. 15b LLaMA-2 7B Q4_K tp 2
   (TP_LLAMA_LAYERS layers, fuse_gate_up(pad_multiple=1), bf16 scales)
   the same way at TP_LLAMA_TOL; the fault: gu_w cut without its
   component order. 15c the ring prefill, tp 1 x sp 2, of a RING_CTX-token
   prompt: each rank's logits rows and arena chunk against the
   single-device prefill (RING_TOL); the fault: kpos not rotated. 15d
   GPipe, 2 stages of PIPE_BLOCKS GPT-J-6B MLP blocks (W4A16 at M
   PIPE_ROWS) over PIPE_MICRO micro-batches, bit-equal to the stages run
   in sequence in one process; the fault: the stage order swapped. 15e
   load_qtensor_sharded of a Q4_K 4096 x 32000 head from a GGUF written
   under build/parallel (deleted after): each rank's half bit-equal to the
   whole load's columns. The backend, world size and the point-to-point
   route are printed; times are two processes time-sharing one H100, not
   a scaling measurement. The kernels line counts each path's launches
   summed over the ranks (tp_gptj, tp_llama, ring_prefill, pipeline).
16. the entry points: each CLI of ggml_imax_tpu_torch/examples/ through
   its main(argv) in this process (stdout captured; its launch counts on
   the kernels line as cli_*), where its phase has its file. 16a
   examples/gptj.py on 11a's .bin (greedy, CLI_TOKENS tokens: the prompt +
   tok.decode of 11a's tokens); 16b examples/llama.py on 11b's Q4_K_M GGUF
   (the default residency must refuse the mix in one line; --resident
   as-is held to its own graph with every plain version on the card, fed
   its picks, ROUTE_TOL); 16c
   examples/whisper.py on 11c's .bin and its audio as a WAV (the segments
   equal 11c's); 16d examples/gpt2.py and examples/serve.py on 11d's .bin
   (gpt2 as 16a; serve -np 4 the same run to run, -np 1 greedy held to
   11d's engine fed its picks, ROUTE_TOL, and equal to 11d's tokens) and one
   subprocess `python -m
   ggml_imax_tpu_torch.examples.gpt2`; 16e examples/quantize.py as 12a's
   requantize step and examples/perplexity.py on its Q4_0 file (within
   PPL_ROUTE_TOL of the kernels'); 16f examples/magika.py, yolo.py and
   sam.py on 13a-13c's files (their lines those of the phase); 16g
   examples/mnist.py (FC and CNN; the reloaded prediction the eager one)
   and examples/simple.py. After phase 15: 16h examples/serve.py --bench
   --steady -np 8 --n_predict 64 at GPT-J-6B geometry (its JSON line beside
   phase 6's numbers) and 16i tools/quality_gate.py trained on the card
   (1500 steps; it must learn structure and every format must pass) and
   tools/quality_kernel_row.py (Q4_0, Q4_K, Q5_0 under KL 5e-3), files
   under build/qgate. Rows 1, 3, 5, 6, 7, 9, 14, 16 and 17 must each launch
   on an entry point's path (CLI_KERNELS).

    python3 chip_smoke.py --serving-kernels [ROOT]
    python3 chip_smoke.py --gpt2-kernels [ROOT]

run phase 1 and phase 2's serving kernels alone (rows 14-15 of PERF.md's
kernel table, timed led), or its nat8 W8A8 checks alone (row 7, led and
unled, with its time at each K split the plan may take), on the port of
the checkout at ROOT (default: this one): the same script times another
commit's kernels.

Each engine phase (5b, 8b, 8c, 9b, 9c, 10, 12, 13, 14 and 15's ranks too), and the timed
training steps, sets the launch counters to 0 just before its run and
reads them just after; a replayed graph adds the launches its capture recorded
(_build.CapturedLaunches). Each phase prints its seconds. Every flash forward
launches the tile map of its mask (flash_backward_tiles) before its kernel,
so each phase counts one map for each flash call. The line before the
last is the kernels JSON, the last line is {"ok": true, "device": {...}}.
Needs no arguments, no network and one card.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_S = 3.35e12          # H100 SXM data sheet
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
GPTJ_6B = dict(n_vocab=50400, n_ctx=512, n_embd=4096, n_head=16, n_layer=28,
               n_rot=64)
GPT2_XL = dict(n_vocab=50257, n_ctx=1024, n_embd=1600, n_head=25, n_layer=48)
# a request: a PROMPT-token prompt + N_PREDICT greedy tokens (64 before PR
# 26; 32 and N_REQUESTS 2, not 3, so the whole script stays inside its time
# limit on a slower host: the eager chunk-1 steps are host-bound; one
# request since phase 16 joined); phase 2 times its attention kernels at the
# Engine's n_ctx, ENGINE_CTX
PROMPT, N_PREDICT, N_REQUESTS = 448, 32, 1
ENGINE_CTX = 512
# decode steps in a span of Engine.generate(chunk) (a captured CUDA graph)
CHUNK = 8
# examples/serve.py --bench: n_ctx, requests, arrival every k engine steps,
# prompt lengths [lo, hi), tokens per request, decode steps per chunk
SERVE = dict(n_ctx=2048, n_req=8, arrive=4, plen=(64, 128), n_predict=32,
             chunk=8)
# Two sound greedy runs of GPT-J-6B (the fused KV-update routes against the
# default ones; kernels against plain versions) agree to this share of the
# largest |logit| (phase 6). A run rounds a few terms differently (the fresh
# row's p is not rounded to bf16; sums in another order), which flips bf16
# and int8 activation roundings downstream. Readings of this script on an
# H100 (PERF.md): sound runs at most 1.66% (the Engine's fused route);
# the planted fault the limit alone must catch (the fresh row written one
# row off, Engine, tokens still equal) at least 8.1%. 3.5% lies between.
ROUTE_TOL = 3.5e-2
# GPT-2 117M training (tools/bench_train.py's batch shape, quality_gate.py's
# loss): 2 warm-up AdamW steps through optimize.opt, then `steps` timed ones
# through opt_resume
GPT2_117M = dict(n_vocab=50257, n_ctx=1024, n_embd=768, n_head=12, n_layer=12)
# Phases 8, 8b and 8c quantize their weights on the host (8 and 8b through
# the C++ codecs since they landed, 8c's IQ4 kinds in numpy): they run
# GPT-2 117M's widths at a sixth of its depth (2 of 12 layers: half, then a
# quarter, before the entry points of phase 16 joined), so the whole script
# stays inside its time limit
GPT2_117M_HOST = dict(GPT2_117M, n_layer=2)
TRAIN = dict(batch=8, seq=512, warmup=2, steps=10, alpha=1e-4)
# A training step's loss and gradients with the kernels against the same
# step with every plain version on the card (phase 7): max |dg| per leaf
# within this share of that leaf's largest |g|. The two round P and dS to
# bf16 at the same points but sum in another order, so a rounding flips
# here and there. Readings of this script on an H100 (PERF.md): sound at
# most 6.0e-4 (the tied wte); the planted fault (dK without its scale)
# 0.53. 1e-2 is 17x the one, a fiftieth of the other.
TRAIN_TOL = 1e-2
# GPT-2 117M K-quants (phase 8): a short greedy pass (the PROMPT-token
# prompt + 8 tokens) with the kernels, and the same pass fed its tokens
# with every plain version on the card, agree to this share of the largest
# |logit|. The two sum each product in another order, which flips bf16
# roundings of the activations downstream. Readings of this script on an
# H100 (PERF.md): sound runs at most 0.49% (Q2_K; Q3_K 0.47%, row-pair
# 0.46%, u-order 0.42%), the planted fault (the low and high scale rows
# swapped) 120%. 2% is 4x the one and a sixtieth of the other. Fed the
# same tokens, the two passes' picks may part only at a near-tie: the
# random weights give top-2 margins under 1e-2 (the first run, fed its own
# picks, parted the u-order Q8_0 pass that way at the second forward).
KQ_ROUTE_TOL = 2e-2
# LLaMA-2 7B Q4_K (phase 9): the reference benchmark's llama2-7b-q4_k
# (tools/bench_models.py): every 2-D weight Q4_K, bf16 scales and mins,
# a 512-position KV cache
LLAMA2_7B = dict(n_vocab=32000, n_ctx=512, n_embd=4096, n_head=32,
                 n_head_kv=32, n_layer=32, n_ff=11008)
# Phase 9's route check: a teacher-forced pass (a 64-token prompt + 8
# steps) with the kernels, and the same pass with every plain version on
# the card, agree to this share of the largest |logit|. The structural
# draw gives every position nearly the same logits (largest |logit| ~51,
# one token picked throughout), so rounding differences barely move them.
# Readings of this script on an H100 (PERF.md): sound 4.8e-6 (0.00024
# at the prefill's last row, 1.5e-5 a decode step), the planted fault (W4A8
# without its bias term) 1.08. 1e-4 is 21x the one, 1/10,000 of the other.
LLAMA_ROUTE_TOL = 1e-4
# Phase 9b's route check (the Q4_K_M mix), as phase 9's. Its Q6_K head has
# no bias, so the largest |logit| is ~7 where phase 9's is ~51, and the
# prefill's A16 products, summed in another order than the plain versions
# sum them, part the prefill's logits by more than LLAMA_ROUTE_TOL (decode
# steps, exact integer dots, by 1.3e-7). Readings of this script on an
# H100 (PERF.md): sound 2.86e-4 (the prefill; the plain versions against
# themselves with the A16 products summed in f64 are logged beside), the
# planted fault (the Q6_K W8A8 at g 32) 0.487. 2e-3 is 7x the one, 1/240
# of the other.
Q4KM_ROUTE_TOL = 2e-3
# phases 8 and 8b quantize their host-drawn weights in this many worker
# processes (the card's machine has 8 cores)
HOST_WORKERS = 8
# kernel -> (source under ggml_imax_tpu_torch/csrc, the TPU kernel it replaces)
KERNELS = {
    "w4a8_gemv": ("w4a8_gemv.cu", "ggml_imax_tpu/ops/pallas_qmm.py:960"),
    "w4a16_gemm": ("w4a16_gemm.cu", "ggml_imax_tpu/ops/pallas_qmm.py:1077"),
    "decode_attention": ("decode_attention.cu",
                         "ggml_imax_tpu/ops/decode_attention.py:74"),
    "flash_attention": ("flash_attention.cu",
                        "ggml_imax_tpu/ops/flash_attention.py:44"),
    "nat8_w8a8": ("nat8_gemv.cu", "ggml_imax_tpu/ops/pallas_qmm.py:1181"),
    "nat8_w8a16": ("nat8_gemm.cu", "ggml_imax_tpu/ops/pallas_qmm.py:1212"),
    "decode_attention_cells": ("decode_attention_cells.cu",
                               "ggml_imax_tpu/ops/decode_attention.py:129"),
    "decode_attention_update": ("decode_attention_update.cu",
                                "ggml_imax_tpu/ops/decode_attention.py:376"),
    "flash_backward_dq": ("flash_backward.cu",
                          "ggml_imax_tpu/ops/flash_backward.py:67"),
    "flash_backward_dkv": ("flash_backward.cu",
                           "ggml_imax_tpu/ops/flash_backward.py:97"),
    # the tile map the two backward kernels share: no TPU kernel of its own
    "flash_backward_tiles": ("flash_backward.cu",
                             "none (a helper of ggml_imax_tpu/ops/"
                             "flash_backward.py:67 and :97)"),
    "planes_w4a16": ("permuted_gemm.cu", "ggml_imax_tpu/ops/pallas_qmm.py:249"),
    "rowpair_w4a16": ("permuted_gemm.cu",
                      "ggml_imax_tpu/ops/pallas_qmm.py:287"),
    "int8_rows_w8a16": ("permuted_gemm.cu",
                        "ggml_imax_tpu/ops/pallas_qmm.py:1388"),
}


def log(*a):
    print(*a, flush=True)


def bound(nbytes: float, ops: float, peak: float):
    t_mem, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


class Timer:
    """Mean ms per call from CUDA events; a 256 MB buffer is rewritten
    before each call so the weights come from device memory, not L2. With
    lead, a spin of ~2 ms on the card follows the rewrite, so the host has
    queued every launch of the call before its start event: the reading is
    the device's time, not the host's (an autograd backward's host work can
    outlast its kernels)."""

    LEAD_CYCLES = 4_000_000

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=20, warmup=3, lead=False):
        for _ in range(warmup):
            fn()
        evs = []
        for _ in range(iters):
            self.flush.zero_()
            if lead:
                torch.cuda._sleep(self.LEAD_CYCLES)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in evs) / iters


def rel_err(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def abs_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


class Checks:
    """Kernel-vs-plain checks: errors, failures, and per kernel the JSON
    entry of its first timed call (its main-path shape)."""

    def __init__(self):
        self.results: dict = {}
        self.errs: dict = {}
        self.failures: list[str] = []

    def record(self, name, label, got, ref, tol, ms=None, plain_ms=None,
               lib_ms=None, nbytes=0, ops=0, peak=PEAK_BF16):
        err = rel_err(got, ref)
        self.errs.setdefault(name, []).append(abs_err(got, ref))
        ok = err <= tol
        line = (f"  {name:16s} {label:30s} rel_err {err:.2e} (tol {tol:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(f"{name} {label}: rel_err {err:.3e} > {tol:.0e}")
        if ms is not None:
            b_ms, b_by = bound(nbytes, ops, peak)
            lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
            line += (f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
                     f"{lib}  bound {b_ms:.4f} ms ({b_by})")
            src, replaces = KERNELS[name]
            self.results.setdefault(name, {
                "name": name, "route": "cuda",
                "source": f"ggml_imax_tpu_torch/csrc/{src}",
                "replaces": replaces, "shape": label, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms})
        log(line)


def random_natpair(K, N, gen):
    from ggml_imax_tpu_torch.quant.device import QTensor
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    q = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, generator=gen,
                      device="cuda")
    s = torch.randn((K // 32, N), generator=gen, device="cuda").abs_() \
        .mul_(0.02 / 4.6)
    return QTensor("nib4", q, s, None, K, N, GGMLType.Q4_0, zero=8,
                   interleaved_bk=512, q4_layout=3)


def random_nat8(K, N, gen, g=32, scale_dtype=torch.float32, bias=False):
    from ggml_imax_tpu_torch.quant.device import QTensor
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    q = torch.randint(-127, 128, (K, N), dtype=torch.int8, generator=gen,
                      device="cuda")
    s = torch.randn((K // g, N), generator=gen, device="cuda").abs_() \
        .mul_(0.02 / 73.6)
    b = None
    if bias:
        b = (torch.randn((K // g, N), generator=gen, device="cuda") * 0.01) \
            .to(scale_dtype)
    return QTensor("int8", q, s.to(scale_dtype), b, K, N,
                   GGMLType.Q6_K if g == 16 else GGMLType.Q8_0,
                   interleaved_bk=K, q4_layout=4)


def flash_case(ck, timer, gen, label, B, Tq, Tk, Hq, Hkv, Dh, kw, timed,
               q_off=None, kv=None, visible=None, masked_row=None):
    """One flash-attention case; causal over positions q_off + i (the last
    Tq keys by default), keys at or past q_off + Tq masked as the engine's
    bucketed prefill masks them. kv: the keys and values (B, Tk, Hkv, Dh)
    instead of random ones; visible: a (B, Tq, Tk) bool visibility instead
    of the causal one; masked_row: a query row that sees no key. The lse is
    held on the rows with a visible key and, apart, on those with none.
    Timed: the bound counts what the kernel must move and compute: q, the
    k/v rows of the tiles it scores (and the V rows of the skipped tiles of
    a query tile holding a row with no visible key), the slopes, the tile
    map, the mask of the mixed tiles only, out and lse; 4 Dh operations for
    each (i, j) pair of the scored tiles. The bound over every (i, j) pair
    with the whole mask read is logged beside it."""
    from ggml_imax_tpu_torch.ops import flash_attention as fa
    from ggml_imax_tpu_torch.ops import flash_backward as fb
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = torch.randn(B, Tq, Hq, Dh, generator=gen, device="cuda")
    k, v = kv if kv is not None else (
        torch.randn(B, Tk, Hkv, Dh, generator=gen, device="cuda")
        for _ in range(2))
    q_off = Tk - Tq if q_off is None else q_off
    qi = torch.arange(Tq, device="cuda")[:, None] + q_off
    if visible is None:
        visible = torch.arange(Tk, device="cuda")[None, :] <= qi
    visible = visible.expand(B, Tq, Tk).clone()
    if masked_row is not None:
        visible[:, masked_row] = False
    if kw.get("max_bias"):
        dist = (torch.arange(Tk, device="cuda")[None, :] - qi).float()
        mask = torch.where(visible, dist, float("-inf"))[:, None]
    else:
        mask = torch.where(visible, 0.0, float("-inf"))[:, None]
    prep = fa._prep(q, k, v, mask, kw.get("max_bias", 0.0))
    args = prep + (1.0 / math.sqrt(Dh), kw.get("logit_softcap", 0.0),
                   kw.get("want_lse", False))
    m3, slopes = prep[3], prep[4]
    tmap = fb.backward_tile_map(m3)
    got, got_lse = fa.flash_attention_kernel(*args, tiles=tmap)
    ref, ref_lse = fa.flash_attention_plain(*args)
    if got_lse is not None:
        seen = ref_lse.abs() < 1e30
        ck.record("flash_attention", label + " (lse)", got_lse[seen],
                  ref_lse[seen], 1e-4)
        if not bool(seen.all()):
            ck.record("flash_attention", label + " (lse, rows with no key)",
                      got_lse[~seen], ref_lse[~seen], 1e-6)
    timing = {}
    if timed:
        qb, kb, vb = (t.to(torch.bfloat16).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        tiles = fb.backward_tile_map_plain(m3)
        nq, nk, T = tiles.shape[1], tiles.shape[2], fb.TILE
        rows = (Tq - T * torch.arange(nq, device="cuda")).clamp(max=T)
        keys = (Tk - T * torch.arange(nk, device="cuda")).clamp(max=T)
        scored = ~fa.skipped_tiles_plain(tiles, slopes, Hq)   # (B, Hq, nq, nk)
        lone = ~F.pad(visible.any(-1), (0, nq * T - Tq), value=True) \
            .reshape(B, nq, T).all(-1)                        # a row with no key
        group = (B, Hkv, Hq // Hkv, nq, nk)
        k_tiles = scored.reshape(group).any(2).any(2)
        v_tiles = k_tiles | (~scored & lone[:, None, :, None]) \
            .reshape(group).any(2).any(2)
        pairs = int((scored * rows[:, None] * keys[None, :]).sum())
        mixed = (tiles == fb.TILE_MIXED) * rows[:, None] * keys[None, :]
        kv_rows = int(((k_tiles + v_tiles.float()) * keys).sum())
        f4 = 4
        nbytes = (B * Tq * Hq * Dh * 2 + kv_rows * Dh * 2
                  + (0 if slopes is None else Hq * f4) + tiles.numel()
                  + int(mixed.sum()) * f4 + B * Tq * Hq * Dh * f4
                  + (B * Hq * Tq * f4 if got_lse is not None else 0))
        every = B * Hq * Tq * Tk
        old_bytes = ((B * Tq * Hq + 2 * B * Tk * Hkv) * Dh * 2
                     + B * Tq * Tk * f4 + B * Tq * Hq * Dh * f4)
        # the kernel timed on a map built once (the map's own kernel is
        # flash_backward_tiles, one launch a forward on the paths)
        map_ms = timer(lambda: fb.backward_tile_map(m3), iters=20, lead=True)
        log(f"  {'':16s} {label}: the scored tiles hold "
            f"{100 * pairs / every:.1f}% of the (i, j) pairs, the mixed ones "
            f"{100 * int(mixed.sum()) / (B * Tq * Tk):.1f}% of the mask; bound "
            f"over every pair, the whole mask read: "
            f"{bound(old_bytes, 4 * every * Dh, PEAK_BF16)[0]:.4f} ms; the "
            f"tile map {map_ms:.4f} ms")
        timing = dict(
            ms=timer(lambda: fa.flash_attention_kernel(*args, tiles=tmap),
                     iters=50, lead=True),
            plain_ms=timer(lambda: fa.flash_attention_plain(*args), iters=5),
            lib_ms=timer(lambda: sdpa(qb, kb, vb, attn_mask=visible[:, None]),
                         iters=50, lead=True),
            nbytes=nbytes, ops=4 * Dh * pairs)
    ck.record("flash_attention", label, got, ref, 1e-2, **timing)


def split_times(timer, qmm, x, qt, plan="natpair_plan", fn="w4a16_gemm"):
    """The kernel's time (wrapper `fn`, its plan `plan`) at K splits 1, 2,
    4, 5 and 8 in place of its plan's (the readings the plan's rule rests
    on)."""
    planner = getattr(qmm, plan)
    route = planner(x.shape[0], qt.k, qt.n)[0]
    units = qt.k // 32 if route == "small" else -(-qt.k // 64)
    try:
        for s in (1, 2, 4, 5, 8):
            if units % s == 0:
                setattr(qmm, plan, lambda *a, s=s: (route, s))
                yield s, timer(lambda: getattr(qmm, fn)(x, qt))
    finally:
        setattr(qmm, plan, planner)


def forced_split_times(ck, timer, mod, plan, splits, call, ref, tol, name):
    """A kernel's time (led) at each split of `splits` in place of its
    plan's (`mod.plan` forced to return it), each result of `call` held to
    the plain version `ref` as the planned split is."""
    planner = getattr(mod, plan)
    try:
        for s in splits:
            setattr(mod, plan, lambda *a, s=s: s)
            err = rel_err(call(), ref)
            if err > tol:
                ck.failures.append(f"{name} split {s}: rel_err {err:.3e} > "
                                   f"{tol:.0e}")
            yield s, timer(call, iters=50, lead=True)
    finally:
        setattr(mod, plan, planner)


def log_timer_floor(timer):
    """The led timer's floor: one tiny kernel. The W8A8 and W4A8 GEMVs and
    the decode attention kernels take ~0.01-0.06 ms, so they are timed led,
    beside it."""
    tiny = torch.zeros(16, device="cuda")
    log(f"  timer floor: one tiny kernel, led, "
        f"{timer(lambda: tiny.add_(1), iters=50, lead=True):.4f} ms")


def check_gptj_kernels(ck, timer, gen):
    from ggml_imax_tpu_torch.models.common import init_kv_cache, update_kv
    from ggml_imax_tpu_torch.ops import decode_attention as da
    from ggml_imax_tpu_torch.ops import qmm

    E = GPTJ_6B["n_embd"]
    shapes = {"qkvf_w": (E, 7 * E), "of_w": (5 * E, E), "lm_head": (E, 51200)}
    log_timer_floor(timer)
    for label, (K, N) in shapes.items():
        qt = random_natpair(K, N, gen)
        wd = qmm.dequant_bf16(qt)                     # library yardstick only
        sbytes = qt.scale.numel() * qt.scale.element_size()
        # A: W4A8 GEMV at m = 1, K cut as w4a8_plan says (and its time at
        # other K splits); also timed unled, as it was before the timer led
        x = torch.randn(1, K, generator=gen, device="cuda")
        x8, dx = qmm.quantize_activations_q8(x)
        x8, dx = x8[:, 0].contiguous(), dx[:, 0].contiguous()
        got = qmm.w4a8_gemv(x8, dx, qt)
        ref = qmm.w4a8_gemv_plain(x8, dx, qt)
        xb = x.to(torch.bfloat16)
        row = f"{label} m=1 K={K} N={N} split {qmm.w4a8_plan(K, N)}"
        ck.record("w4a8_gemv", row, got, ref, 1e-4,
                  timer(lambda: qmm.w4a8_gemv(x8, dx, qt), iters=50,
                        lead=True),
                  timer(lambda: qmm.w4a8_gemv_plain(x8, dx, qt), iters=3),
                  timer(lambda: torch.matmul(xb, wd), iters=50, lead=True),
                  K * N // 2 + sbytes + K + K // 32 * 4 + N * 4, 2 * K * N,
                  PEAK_INT8)
        # a yardstick of the stream alone: torch's amax over the weight's
        # bytes (no scales), led
        qi = qt.q.view(torch.int32)
        log(f"  {'':16s} {label} m=1 unled: kernel "
            f"{timer(lambda: qmm.w4a8_gemv(x8, dx, qt)):.4f} ms, library "
            f"{timer(lambda: torch.matmul(xb, wd)):.4f} ms; led amax over "
            f"the weight's {K * N // 2 / 1e6:.1f} MB "
            f"{timer(lambda: qi.amax(), iters=50, lead=True):.4f} ms")
        log(f"  {'':16s} {label} m=1 by K split: " + ", ".join(
            f"{s} {ms:.4f} ms" for s, ms in forced_split_times(
                ck, timer, qmm, "w4a8_plan",
                [s for s in (1, 2, 4, 5, 8) if (K // 32) % s == 0],
                lambda: qmm.w4a8_gemv(x8, dx, qt), ref, 1e-4,
                f"w4a8_gemv {label}")))
        # B: W4A16 GEMM at the prefill bucket M = 512, the serving
        # decode-only ubatch M = 8 and a mixed serving ubatch's bucket 128,
        # each with the route and K split it takes
        for M in (512, 8, 128):
            xm = torch.randn(M, K, generator=gen, device="cuda")
            got = qmm.w4a16_gemm(xm, qt)
            ref = qmm.w4a16_gemm_plain(xm, qt)
            xmb = xm.to(torch.bfloat16)
            route, split = qmm.natpair_plan(M, K, N)
            ck.record("w4a16_gemm", f"{label} M={M} K={K} N={N} {route}/"
                      f"{split}", got, ref,
                      1e-3, timer(lambda: qmm.w4a16_gemm(xm, qt)),
                      timer(lambda: qmm.w4a16_gemm_plain(xm, qt), iters=3),
                      timer(lambda: torch.matmul(xmb, wd)),
                      M * K * 2 + K * N // 2 + sbytes + M * N * 4,
                      2 * M * K * N, PEAK_BF16)
            log(f"  {'':16s} {label} M={M} by K split: " + ", ".join(
                f"{s} {ms:.4f} ms" for s, ms in split_times(timer, qmm, xm, qt)))
        del qt, wd

    # C: decode attention over one layer of a 512-row arena, bf16 and q8_0,
    # the keys split over a cluster of decode_plan's blocks (and the time at
    # other splits), each call led
    H, D, T, L = 16, 256, 512, 2
    scale = 1.0 / math.sqrt(D)
    for kv in (torch.bfloat16, "q8_0"):
        cache = init_kv_cache(L, 1, T, H, D, kv, device="cuda")
        kk = torch.randn(1, T, H, D, generator=gen, device="cuda")
        vv = torch.randn(1, T, H, D, generator=gen, device="cuda")
        update_kv(cache, 1, kk, vv, 0)
        q = torch.randn(1, H, D, generator=gen, device="cuda")
        mask = torch.zeros(1, T, device="cuda")
        mask[:, 500:] = da.NEG                       # n_past = 499
        args = (q, cache.k[1], cache.v[1],
                None if cache.ks is None else cache.ks[1],
                None if cache.vs is None else cache.vs[1], mask, H, scale)
        got = da.decode_attention_kernel(*args)
        ref = da.decode_attention_plain(*args)
        kvb = lambda t: t.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous()
        kb, vb = kvb(kk), kvb(vv)
        qb = q.to(torch.bfloat16)[:, :, None]
        mb = mask.to(torch.bfloat16)[:, None, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        elt = 2 if cache.ks is None else 1 + 4 / 32
        name = "bf16" if cache.ks is None else "q8_0"
        ck.record("decode_attention",
                  f"{name} B=1 H={H} D={D} T={T} S={da.decode_plan(1, H, T)}",
                  got, ref, 1e-2,
                  timer(lambda: da.decode_attention_kernel(*args), iters=50,
                        lead=True),
                  timer(lambda: da.decode_attention_plain(*args), iters=5,
                        lead=True),
                  timer(lambda: sdpa(qb, kb, vb, attn_mask=mb), iters=50,
                        lead=True),
                  H * D * 4 + 2 * T * H * D * elt + T * 4 + H * D * 4,
                  4 * H * T * D, PEAK_BF16)
        log(f"  {'':16s} {name} by split: " + ", ".join(
            f"{s} {ms:.4f} ms" for s, ms in forced_split_times(
                ck, timer, da, "decode_plan", (1, 2, 4, 8),
                lambda: da.decode_attention_kernel(*args), ref, 1e-2,
                f"decode_attention {name}")))

    # D: flash forward at the prefill shape, plus the small GQA / ALiBi /
    # softcap / LSE cases the GPT-J path does not use
    cases = [("gptj B=1 T=512 H=16 D=256", 1, 512, 512, 16, 16, 256, {}),
             ("gqa 8:2 D=128", 2, 96, 160, 8, 2, 128, {}),
             ("alibi D=64", 1, 64, 64, 8, 8, 64, {"max_bias": 8.0}),
             ("softcap D=128", 1, 80, 80, 4, 4, 128, {"logit_softcap": 30.0}),
             ("lse D=256", 1, 64, 128, 2, 2, 256, {"want_lse": True}),
             # a row that sees no key at a ragged Tk: the reference's
             # average over padded_keys(Tk) keys (256, 384, 1024)
             ("masked row Tk=200 D=64", 1, 72, 200, 4, 2, 64,
              {"want_lse": True, "max_bias": 8.0}),
             ("masked row Tk=300 D=128", 1, 72, 300, 4, 2, 128,
              {"want_lse": True}),
             ("masked row Tk=600 D=256", 1, 72, 600, 4, 2, 256,
              {"want_lse": True})]
    for label, B, Tq, Tk, Hq, Hkv, Dh, kw in cases:
        flash_case(ck, timer, gen, label, B, Tq, Tk, Hq, Hkv, Dh, kw,
                   timed=label.startswith("gptj"),
                   masked_row=5 if label.startswith("masked") else None)


def check_serving_kernels(ck, timer, gen, llama=False):
    """The serving path's attention kernels at GPT-J-6B width (16 heads of
    256): read-only cells attention for 8 query rows (one a pad row) over a
    2048-cell arena, bf16 and q8_0; the fused KV-update kernel in flat mode
    at the Engine's B 1 / T 512 (bf16) and in cells mode at 8 rows x 2048
    (q8_0, the serving arena). Each fused launch also writes its rows: the
    kernel's arena must equal the plain version's after the call. Then
    flash at a mixed ubatch's shape: 128 query rows over the 2048-cell q8_0
    arena under a cell mask. With llama, LLaMA-2 7B's serving shapes
    instead (32 kv heads of 128, decode_plan(1, 32, 2048)): the cells
    attention and the fused kernel in cells mode, each in q8_0 and bf16."""
    from ggml_imax_tpu_torch.models.common import _q8_rows, init_kv_cache, \
        read_kv, update_kv
    from ggml_imax_tpu_torch.ops import decode_attention as da
    sdpa = torch.nn.functional.scaled_dot_product_attention
    model = LLAMA2_7B if llama else GPTJ_6B
    H, D = model["n_head"], model["n_embd"] // model["n_head"]
    tag = "llama " if llama else ""
    scale = 1.0 / math.sqrt(D)

    def arena(kv, B, T):
        cache = init_kv_cache(2, B, T, H, D, kv, device="cuda")
        update_kv(cache, 1, torch.randn(B, T, H, D, generator=gen, device="cuda"),
                  torch.randn(B, T, H, D, generator=gen, device="cuda"), 0)
        return cache, (cache.k[1], cache.v[1],
                       None if cache.ks is None else cache.ks[1],
                       None if cache.vs is None else cache.vs[1])

    def library(q3, k, v, ks, vs, visible):
        """SDPA over the dequantized arena with a boolean mask (yardstick),
        led."""
        B = q3.shape[0]
        kd, vd = (da._dense(x, xs, B, H).to(torch.bfloat16)
                  for x, xs in ((k, ks), (v, vs)))
        qb = q3.to(torch.bfloat16)[:, :, None]
        return timer(lambda: sdpa(qb, kd, vd, attn_mask=visible[:, None, None]),
                     iters=50, lead=True)

    def elt(cache):
        return 2 if cache.ks is None else 1 + 4 / 32

    NB, T = 8, SERVE["n_ctx"]
    seq = torch.randint(0, NB - 1, (T,), generator=gen, device="cuda")
    visible = seq[None] == torch.arange(NB, device="cuda")[:, None]
    visible[NB - 1] = False                          # a pad row: sees nothing
    visible[:, T - 1] = False                        # the trash cell: nobody's
    mask = torch.where(visible, 0.0, da.NEG)
    for kv in ("q8_0", torch.bfloat16):
        cache, ar = arena(kv, 1, T)
        q = torch.randn(NB, H, D, generator=gen, device="cuda")
        args = (q, *ar, mask, H, scale)
        name = "q8_0" if cache.ks is not None else "bf16"
        ref = da.decode_attention_plain(*args)
        S = da.decode_plan(1, H, T)
        ck.record("decode_attention_cells",
                  f"{tag}{name} NB={NB} H={H} D={D} T={T} S={S}",
                  da.decode_attention_cells_kernel(*args), ref, 1e-2,
                  timer(lambda: da.decode_attention_cells_kernel(*args), iters=50,
                        lead=True),
                  timer(lambda: da.decode_attention_plain(*args), iters=5),
                  library(q, *ar, visible),
                  2 * NB * H * D * 4 + 2 * T * H * D * elt(cache) + NB * T * 4,
                  4 * NB * H * T * D, PEAK_BF16)
        # the time at other cluster splits (decode_plan forced), led
        log(f"  {'':16s} {tag}cells {name} by split (* the plan's): "
            + ", ".join(f"{s}{'*' if s == S else ''} {ms:.4f} ms"
                        for s, ms in forced_split_times(
                            ck, timer, da, "decode_plan", (1, 2, 4, 8),
                            lambda: da.decode_attention_cells_kernel(*args),
                            ref, 1e-2, f"decode_attention_cells {name}")))
        del cache, ar

    def fused_case(kv, NB, T, rows, mask, visible, label):
        cache, ar = arena(kv, NB if label == "flat" else 1, T)
        twin = [None if t is None else t.clone() for t in ar]
        q = torch.randn(NB, H, D, generator=gen, device="cuda")
        kn, vn = (torch.randn(NB, 1, H, D, generator=gen, device="cuda")
                  for _ in range(2))
        if cache.ks is not None:
            (k8, kd), (v8, vd) = _q8_rows(kn), _q8_rows(vn)
            fresh = (k8.reshape(NB, -1), v8.reshape(NB, -1),
                     kd.reshape(NB, -1), vd.reshape(NB, -1))
        else:
            fresh = (kn.reshape(NB, -1).bfloat16(), vn.reshape(NB, -1).bfloat16(),
                     None, None)
        tail = (mask, rows, H, scale)
        got = da.decode_attention_update_kernel(q, *ar, *fresh, *tail)
        ref = da.decode_attention_update_plain(q, *twin, *fresh, *tail)
        if not all(a is None or torch.equal(a, b) for a, b in zip(ar, twin)):
            ck.failures.append(f"decode_attention_update {label}: the arena "
                               "differs from the plain version's")
        fbytes = 2 * NB * H * D * elt(cache) * 2   # fresh rows read + written
        name = "q8_0" if cache.ks is not None else "bf16"
        S = da.decode_plan(ar[0].shape[0], H, T)
        ck.record("decode_attention_update",
                  f"{tag}{label} {name} NB={NB} H={H} D={D} T={T} S={S}", got,
                  ref,
                  1e-2,
                  timer(lambda: da.decode_attention_update_kernel(
                      q, *ar, *fresh, *tail), iters=50, lead=True),
                  timer(lambda: da.decode_attention_update_plain(
                      q, *twin, *fresh, *tail), iters=5),
                  library(q, *ar, visible),
                  2 * NB * H * D * 4 + 2 * T * H * D * elt(cache) + NB * T * 4
                  + fbytes, 4 * NB * H * T * D, PEAK_BF16)
        if label == "cells":   # the time at other cluster splits, led
            log(f"  {'':16s} {tag}{label} {name} by split (* the plan's): "
                + ", ".join(f"{s}{'*' if s == S else ''} {ms:.4f} ms"
                            for s, ms in forced_split_times(
                                ck, timer, da, "decode_plan", (1, 2, 4, 8),
                                lambda: da.decode_attention_update_kernel(
                                    q, *ar, *fresh, *tail), ref, 1e-2,
                                f"decode_attention_update {label}")))

    rows = torch.stack([torch.nonzero(visible[n])[-1, 0] for n in range(NB - 1)]
                       + [torch.tensor(T - 1, device="cuda")])
    if llama:
        for kv in ("q8_0", torch.bfloat16):
            fused_case(kv, NB, T, rows, mask, visible, "cells")
        return
    # flat mode at the Engine's shape: B 1, T 512, n_past 499 (as check C)
    Tf = ENGINE_CTX
    n_past = Tf - 13
    vis_f = torch.arange(Tf, device="cuda")[None] <= n_past
    fused_case(torch.bfloat16, 1, Tf, torch.tensor([n_past], device="cuda"),
               torch.where(vis_f, 0.0, da.NEG), vis_f, "flat")
    # cells mode at the serving shape: each row's own cell, the pad row's
    # the trash cell
    fused_case("q8_0", NB, T, rows, mask, visible, "cells")

    # flash as a mixed serving ubatch runs it: the bucket's 128 query rows
    # over the whole q8_0 arena, expanded to f32 as the forward reads it,
    # under the cell mask of that ubatch's registry
    cache, _ = arena("q8_0", 1, T)
    flash_case(ck, timer, gen, f"serving mixed Tq=128 Tk={T} H={H} D={D}",
               1, 128, T, H, H, D, {}, timed=True,
               kv=read_kv(cache, 1, dtype=torch.float32),
               visible=mixed_ubatch_mask(T, 128)[:, 0] == 0)
    del cache


def mixed_ubatch_mask(n_ctx, nb):
    """cells_attention_mask (1, 1, nb, n_ctx) of a mixed serving ubatch,
    registry as BatchedEngine.step leaves it: 7 sequences decoding (prompts
    of 64-127 tokens plus 0-31 generated, each a run of cells, this step's
    cell included), a new request's 100-token prompt chunk, and pad rows up
    to the bucket nb (seq MAX_SEQ - 1, the trash cell, visible to none)."""
    from ggml_imax_tpu_torch.models.common import cells_attention_mask
    from ggml_imax_tpu_torch.runtime.batched import MAX_SEQ
    rng = np.random.default_rng(3)
    cell_pos = np.full(n_ctx, -1, np.int64)
    cell_seq = np.zeros(n_ctx, np.int64)
    tok_pos, tok_seq, head = [], [], 0
    for s, n in enumerate(rng.integers(64, 128, 7) + rng.integers(0, 32, 7)):
        cell_pos[head:head + n + 1] = np.arange(n + 1)
        cell_seq[head:head + n + 1] = 1 << s
        tok_pos.append(n)
        tok_seq.append(s)
        head += n + 1
    cell_pos[head:head + 100] = np.arange(100)
    cell_seq[head:head + 100] = 1 << 7
    tok_pos += range(100)
    tok_seq += [7] * 100
    pad = nb - len(tok_pos)
    tok_pos += [0] * pad
    tok_seq += [MAX_SEQ - 1] * pad
    dev = lambda a: torch.as_tensor(np.asarray(a), device="cuda")[None]
    return cells_attention_mask(dev(tok_pos), dev(tok_seq), dev(cell_pos),
                                dev(cell_seq))


def nat8_gemv_clusters():
    """cudaOccupancyMaxActiveClusters of csrc/nat8_gemv.cu's g 32 f32 kernel
    at clusters of s = 2 .. 8 blocks: a query compiled with the kernel's
    source into the port's build directory."""
    import ctypes
    from ggml_imax_tpu_torch import _build
    src = _build.CSRC / "nat8_gemv.cu"
    d = _build.BUILD_DIR / "nat8_gemv_clusters"
    d.mkdir(parents=True, exist_ok=True)
    (d / "query.cu").write_text(f"""#include "{src}"
extern "C" int nat8_gemv_clusters(int s) {{
  cudaLaunchConfig_t cfg = {{}};
  cfg.gridDim = dim3(1, s);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = s;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = -1;
  return cudaOccupancyMaxActiveClusters(
      &n, (void*)nat8_gemv_kernel<float, 32, false>, &cfg) ? -1 : n;
}}
""")
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-Xcompiler", "-fPIC", "-shared",
                    str(d / "query.cu"), "-o", str(d / "query.so")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(d / "query.so"))
    return [lib.nat8_gemv_clusters(s) for s in range(2, 9)]


def check_gpt2_kernels(ck, timer, gen, w8a8_only=False):
    """nat8 W8A8 / W8A16 at GPT-2 XL's fc_w (1600 x 6400, per-32 f32 scales:
    Q8_0), then per-16 with bias and bf16 scales (Q6_K/Q5_K-like) and a
    ragged M; flash at the GPT-2 XL prefill (25 heads of 64, 512 queries
    over the 1024-row arena). w8a8_only: the W8A8 checks alone (row 7, with
    its time at each K split the plan may take, where the port has
    `nat8_gemv_plan`)."""
    from ggml_imax_tpu_torch.ops import qmm

    K, N = GPT2_XL["n_embd"], 4 * GPT2_XL["n_embd"]
    variants = [("fc_w g32 f32", 32, torch.float32, False),
                ("fc_w g16 bias bf16", 16, torch.bfloat16, True)]
    log_timer_floor(timer)
    if hasattr(qmm, "nat8_gemv_plan"):       # a parent port may lack it
        clusters = nat8_gemv_clusters()
        table = list(qmm._NAT8_GEMV_CLUSTERS.values())
        log(f"  nat8_w8a8 clusters of s blocks the card runs at once, s = "
            f"2..8: {clusters}; the plan's table {table}"
            + ("" if clusters == table
               else " (MISMATCH: the plan may take a split of two waves)"))
    for label, g, sdt, bias in variants:
        qt = random_nat8(K, N, gen, g, sdt, bias)
        wd = qmm.dequant_bf16(qt)                     # library yardstick only
        if bias:
            wd = wd + qt.bias.to(torch.bfloat16).repeat_interleave(g, 0)
        sbytes = qt.scale.numel() * qt.scale.element_size() * (2 if bias else 1)
        # W8A8 at m = 1
        x = torch.randn(1, K, generator=gen, device="cuda")
        x8, dx = qmm.quantize_activations_q8(x, g)
        x8, dx = x8[:, 0].contiguous(), dx[:, 0].contiguous()
        xs = (dx * x8.float().sum(-1)).contiguous() if bias else None
        got = qmm.nat8_w8a8_gemv(x8, dx, qt, xs)
        ref = qmm.nat8_w8a8_gemv_plain(x8, dx, qt, xs)
        xb = x.to(torch.bfloat16)
        kern = lambda: qmm.nat8_w8a8_gemv(x8, dx, qt, xs)
        lib = lambda: torch.matmul(xb, wd)
        ck.record("nat8_w8a8", f"{label} m=1 K={K} N={N} (led)", got, ref, 1e-4,
                  timer(kern, iters=50, lead=True),
                  timer(lambda: qmm.nat8_w8a8_gemv_plain(x8, dx, qt, xs), iters=5),
                  timer(lib, iters=50, lead=True),
                  K * N + sbytes + K + K // g * 4 * (2 if bias else 1) + N * 4,
                  2 * K * N, PEAK_INT8)
        log(f"  {'':16s} {label} m=1 unled: kernel {timer(kern, iters=50):.4f} "
            f"ms, library {timer(lib, iters=50):.4f} ms")
        if hasattr(qmm, "nat8_gemv_plan"):       # a parent port may lack it
            log(f"  {'':16s} {label} m=1 by K split (plan "
                f"{qmm.nat8_gemv_plan(K, N, g)}): " + ", ".join(
                    f"{s} {ms:.4f} ms" for s, ms in forced_split_times(
                        ck, timer, qmm, "nat8_gemv_plan",
                        range(1, min(8, K // 32) + 1), kern, ref, 1e-4,
                        f"nat8_w8a8 {label}")))
        if w8a8_only:
            continue
        # W8A16 at the prefill bucket M = 512, the Engine's smallest bucket
        # M = 8, a ragged M = 5 and the bucket M = 128, each with the route
        # and K split it takes, and its time at other K splits
        for M in (512, 5, 8, 128):
            xm = torch.randn(M, K, generator=gen, device="cuda")
            got = qmm.nat8_w8a16_gemm(xm, qt)
            ref = qmm.nat8_w8a16_gemm_plain(xm, qt)
            xmb = xm.to(torch.bfloat16)
            route, split = qmm.nat8_plan(M, K, N)
            ck.record("nat8_w8a16", f"{label} M={M} K={K} N={N} {route}/"
                      f"{split}", got, ref, 1e-3,
                      timer(lambda: qmm.nat8_w8a16_gemm(xm, qt)),
                      timer(lambda: qmm.nat8_w8a16_gemm_plain(xm, qt), iters=3),
                      timer(lambda: torch.matmul(xmb, wd)),
                      M * K * 2 + K * N + sbytes + M * N * 4, 2 * M * K * N,
                      PEAK_BF16)
            log(f"  {'':16s} {label} M={M} by K split: " + ", ".join(
                f"{s} {ms:.4f} ms" for s, ms in split_times(
                    timer, qmm, xm, qt, "nat8_plan", "nat8_w8a16_gemm")))
        del qt, wd
    if w8a8_only:
        return
    H, D = GPT2_XL["n_head"], GPT2_XL["n_embd"] // GPT2_XL["n_head"]
    flash_case(ck, timer, gen, f"gpt2 B=1 Tq=512 Tk=1024 H={H} D={D}", 1, 512,
               1024, H, H, D, {}, timed=True, q_off=0)


def backward_case(ck, timer, gen, label, B, Tq, Tk, Hq, Hkv, Dh, kw,
                  masked_row=None, mask=None, window=None):
    """The flash backward kernels (tile map; dQ; dK/dV) against their plain
    versions on one case, from the forward kernel's out and lse; each timed
    beside its plain version (the backward: one time for both gradients),
    its bound, and for dQ and dK/dV the backward of bf16
    scaled_dot_product_attention with the same additive mask (one time for
    the pair; a yardstick the port never calls). The kernels and SDPA's
    backward are timed with the timer's lead (device time); SDPA's also
    without it. A kernel's bound counts what it must move: q/k/v/dO, lse
    and D_i, the slopes, the tile map and the mask of the mixed tiles only
    (it reads no other), its outputs; and the products of the (i, j) pairs
    of the tiles it computes. Logs each kernel's computed share and its
    bound over every (i, j) pair with the whole mask read, for comparison.
    mask: an additive (B, 1, Tq, Tk) mask instead of the causal one;
    window: keep only the last `window` keys of each query."""
    from ggml_imax_tpu_torch.ops import flash_attention as fa
    from ggml_imax_tpu_torch.ops import flash_backward as fb
    q = torch.randn(B, Tq, Hq, Dh, generator=gen, device="cuda")
    k, v = (torch.randn(B, Tk, Hkv, Dh, generator=gen, device="cuda")
            for _ in range(2))
    if mask is None:
        qi = torch.arange(Tq, device="cuda")[:, None] + (Tk - Tq)
        kj = torch.arange(Tk, device="cuda")[None]
        fill = (kj - qi).float() if kw.get("max_bias") else \
            torch.zeros(Tq, Tk, device="cuda")
        vis = kj <= qi if window is None else (kj <= qi) & (kj > qi - window)
        mask = torch.where(vis, fill, float("-inf"))[None, None] \
            .expand(B, 1, Tq, Tk).clone()
    if masked_row is not None:
        mask[:, :, masked_row] = float("-inf")
    prep = fa._prep(q, k, v, mask, kw.get("max_bias", 0.0))
    scale, cap = 1.0 / math.sqrt(Dh), kw.get("logit_softcap", 0.0)
    m3, slopes = prep[3], prep[4]
    tiles = fb.backward_tile_map(m3)
    out, lse = fa.flash_attention_kernel(*prep, scale, cap, True, tiles=tiles)
    do = torch.randn(out.shape, generator=gen, device="cuda")
    di = (do * out).sum(-1).transpose(1, 2).contiguous()
    args = (*prep[:3], do.to(torch.bfloat16), m3, slopes, lse, di, scale,
            cap, tiles)
    dq = fb.flash_backward_dq(*args)
    dk, dv = fb.flash_backward_dkv(*args)
    rq, rk, rv = fb.flash_attention_bwd_plain(*args[:10])
    plain_ms = timer(lambda: fb.flash_attention_bwd_plain(*args[:10]), iters=5)
    lib_ms = lib_host_ms = None
    if not cap:      # SDPA has no softcap
        # (B, H, T, D) bf16, k/v repeated over the GQA group
        rep = Hq // Hkv
        lq, lk, lv = (t.to(torch.bfloat16).transpose(1, 2).repeat_interleave(
            r, dim=1).contiguous().requires_grad_(True)
                      for t, r in ((q, 1), (k, rep), (v, rep)))
        lmask = m3[:, None].to(torch.bfloat16)
        if slopes is not None:
            lmask = lmask * slopes.reshape(1, Hq, 1, 1).to(torch.bfloat16)
        lo = torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=lmask, scale=scale)
        ldo = do.to(torch.bfloat16).transpose(1, 2)

        def sdpa_backward():
            torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True)
        lib_ms = timer(sdpa_backward, iters=10, lead=True)
        lib_host_ms = timer(sdpa_backward, iters=10)
    bf, f4 = 2, 4
    qkv = (2 * B * Tq * Hq + 2 * B * Tk * Hkv) * Dh * bf + 2 * B * Hq * Tq * f4
    mixed = (tiles == fb.TILE_MIXED).repeat_interleave(fb.TILE, 1) \
        .repeat_interleave(fb.TILE, 2)[:, :Tq, :Tk]
    ins = qkv + (0 if slopes is None else Hq * f4) + tiles.numel() \
        + int(mixed.sum()) * f4
    outs = {"dq": B * Tq * Hq * Dh * f4, "dkv": 2 * B * Tk * Hkv * Dh * f4}
    # the (i, j) pairs of the tiles each kernel computes, and their products
    pairs = {name: int((~fb.skipped_plain(tiles, lse, slopes, Tk, rows)).sum())
             for name, rows in (("dq", fb.TILE), ("dkv", fb.dkv_rows(Dh)))}
    flops = {"dq": 3 * 2 * Dh * pairs["dq"], "dkv": 4 * 2 * Dh * pairs["dkv"]}
    every = B * Hq * Tq * Tk
    shape = f"{label} B={B} Tq={Tq} Tk={Tk} H={Hq}:{Hkv} D={Dh}"
    log(f"  {shape}: the computed tiles hold {100 * pairs['dq'] / every:.1f}%"
        f" (dQ) and {100 * pairs['dkv'] / every:.1f}% (dK/dV) of the "
        f"(i, j) pairs; the mixed tiles "
        f"{100 * float(mixed.float().mean()):.1f}% of the mask")
    ck.record("flash_backward_tiles", shape + " tile map", tiles,
              fb.backward_tile_map_plain(m3), 0.0,
              timer(lambda: fb.backward_tile_map(m3), iters=20, lead=True),
              timer(lambda: fb.backward_tile_map_plain(m3), iters=5), None,
              B * Tq * Tk * f4 + tiles.numel(), 0, PEAK_BF16)
    ck.record("flash_backward_dq", shape, dq, rq, 1e-2,
              timer(lambda: fb.flash_backward_dq(*args), iters=20, lead=True),
              plain_ms, lib_ms, ins + outs["dq"], flops["dq"], PEAK_BF16)
    ck.record("flash_backward_dkv", shape + " dK", dk, rk, 1e-2,
              timer(lambda: fb.flash_backward_dkv(*args), iters=20, lead=True),
              plain_ms, lib_ms, ins + outs["dkv"], flops["dkv"], PEAK_BF16)
    ck.record("flash_backward_dkv", shape + " dV", dv, rv, 1e-2)
    every_b = {name: bound(qkv + B * Tq * Tk * f4 + outs[name],
                           n * 2 * Dh * every, PEAK_BF16)[0]
               for name, n in (("dq", 3), ("dkv", 4))}
    host = "n/a" if lib_host_ms is None else f"{lib_host_ms:.4f} ms"
    log(f"  {'':16s} bound over every (i, j) pair, the whole mask read: dQ "
        f"{every_b['dq']:.4f} ms, dK/dV {every_b['dkv']:.4f} ms; SDPA's "
        f"backward timed without the lead {host}")


def check_train_kernels(ck, timer, gen):
    """The training path's attention kernels: flash forward with lse and the
    two backward kernels at GPT-2 117M training (B 8, T 512, 12 heads of 64,
    the causal mask of gpt2.forward, and a sliding window of 128 keys);
    the backward kernels also at D 256 (GPT-J width, the shared-memory
    route, key tiles of 32) and on a ragged GQA case with softcap,
    ALiBi and a fully masked row. Then dx through the kernel matmul routes
    (W4A16 at M 512, W8A16) against the same routes run plain on the card."""
    from ggml_imax_tpu_torch.models.common import attention_mask
    from ggml_imax_tpu_torch.ops import qmm
    from ggml_imax_tpu_torch.ops.qmatmul import qmatmul
    B, T = TRAIN["batch"], TRAIN["seq"]
    H, D = GPT2_117M["n_head"], GPT2_117M["n_embd"] // GPT2_117M["n_head"]
    flash_case(ck, timer, gen, f"train B={B} T={T} H={H} D={D} (lse)", B, T, T,
               H, H, D, {"want_lse": True}, timed=True)
    pos = torch.arange(T, device="cuda")[None].expand(B, T)
    backward_case(ck, timer, gen, "train", B, T, T, H, H, D, {},
                  mask=attention_mask(pos, T, 0))
    backward_case(ck, timer, gen, "window 128", B, T, T, H, H, D, {},
                  window=128)
    backward_case(ck, timer, gen, "gptj", 1, 512, 512, 16, 16, 256, {})
    backward_case(ck, timer, gen, "gqa+softcap+alibi", 2, 200, 300, 8, 2, 128,
                  {"logit_softcap": 20.0, "max_bias": 8.0}, masked_row=7)

    for label, qt in (("natpair W4A16", random_natpair(4096, 4096, gen)),
                      ("nat8 W8A16", random_nat8(1600, 6400, gen))):
        x = torch.randn(512, qt.k, generator=gen, device="cuda")
        dxs = []
        for patches in ((), [(qmm, "w4a16_gemm", qmm.w4a16_gemm_plain),
                             (qmm, "nat8_w8a16_gemm",
                              qmm.nat8_w8a16_gemm_plain)]):
            with patched(patches):
                xg = x.clone().requires_grad_(True)
                y = qmatmul(xg, qt, out_dtype=torch.float32)
                dxs.append(torch.autograd.grad(torch.sin(y).sum(), xg)[0])
        err = rel_err(*dxs)
        log(f"  dx through {label} M=512 K={qt.k} N={qt.n}: kernel route vs "
            f"plain route rel_err {err:.2e} (tol 1e-02)")
        if not err < 1e-2:
            ck.failures.append(f"dx through {label}: rel_err {err:.3e}")


def random_permuted(layout, K, N, gen):
    """Random bytes in a permuted layout (sizing shapes): planes per-16
    with zero 4 (Q3_K-like), row-pair and u-order int8 per-32."""
    from ggml_imax_tpu_torch.quant.device import QTensor
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    g = 16 if layout == "planes" else 32
    if layout == "int8":
        q = torch.randint(-127, 128, (K, N), dtype=torch.int8, generator=gen,
                          device="cuda")
    else:
        q = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8,
                          generator=gen, device="cuda")
    s = torch.randn((K // g, N), generator=gen, device="cuda").abs_() * 0.005
    kind, q4l, zero, t = {"planes": ("nib4", 0, 4, GGMLType.Q3_K),
                          "rowpair": ("nib4", 1, 8, GGMLType.Q4_0),
                          "int8": ("int8", 2, 0, GGMLType.Q8_0)}[layout]
    return QTensor(kind, q, s, None, K, N, t, zero=zero, interleaved_bk=512,
                   q4_layout=q4l)


PERMUTED_LAYOUT = {"planes_w4a16": "planes", "rowpair_w4a16": "rowpair",
                   "int8_rows_w8a16": "int8"}


def time_permuted(ck, timer, gen, name, label, qt, ms=(1, 8, 512)):
    """One permuted-layout kernel against its plain version at each M (the
    GEMV route at M 1 and 8, the tile route at 512), with its route and
    split, its time, the plain version's, bf16 torch.matmul on the weight
    dequantized beforehand (a yardstick the port never calls) and the
    bound."""
    from ggml_imax_tpu_torch.ops import qmm
    from ggml_imax_tpu_torch.ops.qmatmul import dequantize
    kern, plain = getattr(qmm, name), getattr(qmm, name + "_plain")
    wd = dequantize(qt, torch.bfloat16)
    wbytes = sum(t.numel() * t.element_size()
                 for t in (qt.q, qt.scale, qt.bias) if t is not None)
    for M in ms:
        x = torch.randn(M, qt.k, generator=gen, device="cuda")
        xb = x.to(torch.bfloat16)
        route, split = qmm.permuted_plan(PERMUTED_LAYOUT[name], M, qt.k, qt.n,
                                         qt.interleaved_bk,
                                         qt.k // qt.scale.shape[0])
        log(f"  {name:16s} {label} M={M}: route {route}, split {split}")
        ck.record(name, f"{label} M={M} K={qt.k} N={qt.n}", kern(x, qt),
                  plain(x, qt), 1e-3, timer(lambda: kern(x, qt)),
                  timer(lambda: plain(x, qt), iters=3),
                  timer(lambda: torch.matmul(xb, wd)),
                  M * qt.k * 2 + wbytes + M * qt.n * 4, 2 * M * qt.k * qt.n,
                  PEAK_BF16)
    del wd


def check_kquant_kernels(ck, timer, gen):
    """GPT-2 117M's layer products attn_w (768 x 2304, tag 256) and out_w
    (3072 x 768, tag 512) at M 1 (decode), 8 and 512 (the prefill bucket):
    the plane-split kernel on Q3_K and Q2_K weights (the port's codecs),
    the row-pair kernel on Q4_0 and the u-order kernel on Q8_0. Then each
    kernel at a 4096 x 16384 sizing shape of random bytes, on no path: the
    117M products move 0.2-1.8 MB, so their times are launch-latency
    sized."""
    from ggml_imax_tpu_torch.ops import qmm
    from ggml_imax_tpu_torch.quant.device import quantize_for_device
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    E = GPT2_117M["n_embd"]
    rng = np.random.default_rng(9)
    repack = {"planes": qmm.repack_interleaved, "rowpair": qmm.repack_rowpair,
              "int8": qmm.repack_int8_rows}
    cases = [("planes_w4a16", "planes", GGMLType.Q3_K),
             ("planes_w4a16", "planes", GGMLType.Q2_K),
             ("rowpair_w4a16", "rowpair", GGMLType.Q4_0),
             ("int8_rows_w8a16", "int8", GGMLType.Q8_0)]
    for name, layout, wtype in cases:
        for label, (K, N) in (("attn_w", (E, 3 * E)), ("out_w", (4 * E, E))):
            w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
            qt = repack[layout](quantize_for_device(w, wtype),
                                512 if K % 512 == 0 else 256)
            time_permuted(ck, timer, gen, name, f"{wtype.name} {label}", qt)
    for name, layout in (("planes_w4a16", "planes"),
                         ("rowpair_w4a16", "rowpair"),
                         ("int8_rows_w8a16", "int8")):
        time_permuted(ck, timer, gen, name, f"sizing (on no path) {layout}",
                      random_permuted(layout, 4096, 16384, gen))


def q4k_natpair(K, N, gen):
    """A Q4_K weight as models/llama.synthetic_params_device draws it,
    repacked to natpair with bf16 scales and bias (params_repack's
    scale_dtype, which also picks its K tag), as phase 9 runs it."""
    from ggml_imax_tpu_torch.ops import qmm
    from ggml_imax_tpu_torch.quant.device import QTensor
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    q = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, generator=gen,
                      device="cuda")
    s = torch.randn((K // 32, N), generator=gen, device="cuda").abs_() \
        .mul_(0.02 / 9)
    b = torch.randn((K // 32, N), generator=gen, device="cuda").abs_() \
        .mul_(-0.02 / 3)
    return qmm.params_repack(QTensor("nib4", q, s, b, K, N, GGMLType.Q4_K),
                             scale_dtype=torch.bfloat16)


def check_llama_kernels(ck, timer, gen):
    """LLaMA-2 7B Q4_K's shapes (phase 9): natpair W4A8 with bf16 scales and
    a bias at the five products of the fused graph (each with the K split
    w4a8_plan took), W4A16 with the bias at the prefill bucket M 512 on
    qkv_w, gu_w, down_w and the head (row 4's kernel), decode attention over 32 kv heads of 128 at T
    512 (S 4; bf16 and q8_0, with the time at splits 1, 2, 4, 8), the fused
    KV-update kernel in flat mode at that shape, and flash at 512 x 512 over
    32 heads of 128, causal. Each timed (the GEMVs and attention led)
    beside its plain version, the library call and the bound."""
    from ggml_imax_tpu_torch.models.common import _q8_rows, init_kv_cache, \
        update_kv
    from ggml_imax_tpu_torch.ops import decode_attention as da
    from ggml_imax_tpu_torch.ops import qmm
    sdpa = torch.nn.functional.scaled_dot_product_attention
    E, F = LLAMA2_7B["n_embd"], 11264                 # F after the pad
    shapes = {"qkv_w": (E, 3 * E), "o_w": (E, E), "gu_w": (E, 2 * F),
              "down_w": (F, E), "output": (E, LLAMA2_7B["n_vocab"])}
    for label, (K, N) in shapes.items():
        qt = q4k_natpair(K, N, gen)
        wd = qmm.dequant_bf16(qt) + qt.bias.repeat_interleave(32, 0)
        sbytes = 2 * qt.scale.numel() * qt.scale.element_size()
        x = torch.randn(1, K, generator=gen, device="cuda")
        x8, dx = qmm.quantize_activations_q8(x)
        x8, dx = x8[:, 0].contiguous(), dx[:, 0].contiguous()
        xs = dx * x8.float().sum(-1)
        xb = x.to(torch.bfloat16)
        ck.record("w4a8_gemv", f"llama {label} m=1 K={K} N={N} bf16+bias "
                  f"split {qmm.w4a8_plan(K, N)}",
                  qmm.w4a8_gemv(x8, dx, qt, xs),
                  qmm.w4a8_gemv_plain(x8, dx, qt, xs), 1e-4,
                  timer(lambda: qmm.w4a8_gemv(x8, dx, qt, xs), iters=50,
                        lead=True),
                  timer(lambda: qmm.w4a8_gemv_plain(x8, dx, qt, xs), iters=3),
                  timer(lambda: torch.matmul(xb, wd), iters=50, lead=True),
                  K * N // 2 + sbytes + K + 2 * (K // 32) * 4 + N * 4,
                  2 * K * N, PEAK_INT8)
        if label in ("qkv_w", "gu_w", "down_w", "output"):
            xm = torch.randn(512, K, generator=gen, device="cuda")
            xmb = xm.to(torch.bfloat16)
            route, split = qmm.natpair_plan(512, K, N)
            ck.record("w4a16_gemm", f"llama {label} M=512 K={K} N={N} "
                      f"bf16+bias {route}/{split}", qmm.w4a16_gemm(xm, qt),
                      qmm.w4a16_gemm_plain(xm, qt), 1e-3,
                      timer(lambda: qmm.w4a16_gemm(xm, qt)),
                      timer(lambda: qmm.w4a16_gemm_plain(xm, qt), iters=3),
                      timer(lambda: torch.matmul(xmb, wd)),
                      512 * K * 2 + K * N // 2 + sbytes + 512 * N * 4,
                      2 * 512 * K * N, PEAK_BF16)
        del qt, wd

    H, D = LLAMA2_7B["n_head"], E // LLAMA2_7B["n_head"]
    T, n_past = ENGINE_CTX, ENGINE_CTX - 13
    scale = 1.0 / math.sqrt(D)
    visible = torch.arange(T, device="cuda")[None] <= n_past
    mask = torch.where(visible, 0.0, da.NEG)
    for kv in (torch.bfloat16, "q8_0"):
        cache = init_kv_cache(2, 1, T, H, D, kv, device="cuda")
        kk, vv = (torch.randn(1, T, H, D, generator=gen, device="cuda")
                  for _ in range(2))
        update_kv(cache, 1, kk, vv, 0)
        ar = (cache.k[1], cache.v[1],
              None if cache.ks is None else cache.ks[1],
              None if cache.vs is None else cache.vs[1])
        q = torch.randn(1, H, D, generator=gen, device="cuda")
        args = (q, *ar, mask, H, scale)
        ref = da.decode_attention_plain(*args)
        kb, vb = (t.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous()
                  for t in (kk, vv))
        qb = q.to(torch.bfloat16)[:, :, None]
        elt = 2 if cache.ks is None else 1 + 4 / 32
        name = "bf16" if cache.ks is None else "q8_0"
        S = da.decode_plan(1, H, T)
        lib_ms = timer(lambda: sdpa(qb, kb, vb,
                                    attn_mask=visible[:, None, None]),
                       iters=50, lead=True)
        nbytes = H * D * 4 + 2 * T * H * D * elt + T * 4 + H * D * 4
        ck.record("decode_attention",
                  f"llama {name} B=1 H={H} D={D} T={T} S={S}",
                  da.decode_attention_kernel(*args), ref, 1e-2,
                  timer(lambda: da.decode_attention_kernel(*args), iters=50,
                        lead=True),
                  timer(lambda: da.decode_attention_plain(*args), iters=5,
                        lead=True), lib_ms, nbytes, 4 * H * T * D, PEAK_BF16)
        log(f"  {'':16s} llama {name} by split (* the plan's): " + ", ".join(
            f"{s}{'*' if s == S else ''} {ms:.4f} ms"
            for s, ms in forced_split_times(
                ck, timer, da, "decode_plan", (1, 2, 4, 8),
                lambda: da.decode_attention_kernel(*args), ref, 1e-2,
                f"decode_attention llama {name}")))
        # the fused KV write + attention at the same shape (flat mode)
        twin = [None if t is None else t.clone() for t in ar]
        kn, vn = (torch.randn(1, 1, H, D, generator=gen, device="cuda")
                  for _ in range(2))
        if cache.ks is not None:
            (k8, kd), (v8, vd) = _q8_rows(kn), _q8_rows(vn)
            fresh = (k8.reshape(1, -1), v8.reshape(1, -1), kd.reshape(1, -1),
                     vd.reshape(1, -1))
        else:
            fresh = (kn.reshape(1, -1).bfloat16(), vn.reshape(1, -1).bfloat16(),
                     None, None)
        tail = (mask, torch.tensor([n_past], device="cuda"), H, scale)
        got = da.decode_attention_update_kernel(q, *ar, *fresh, *tail)
        ref = da.decode_attention_update_plain(q, *twin, *fresh, *tail)
        if not all(a is None or torch.equal(a, b) for a, b in zip(ar, twin)):
            ck.failures.append(f"decode_attention_update llama {name}: the "
                               "arena differs from the plain version's")
        ck.record("decode_attention_update",
                  f"llama flat {name} NB=1 H={H} D={D} T={T} S={S}", got, ref,
                  1e-2,
                  timer(lambda: da.decode_attention_update_kernel(
                      q, *ar, *fresh, *tail), iters=50, lead=True),
                  timer(lambda: da.decode_attention_update_plain(
                      q, *twin, *fresh, *tail), iters=5), lib_ms,
                  nbytes + 4 * H * D * elt, 4 * H * T * D, PEAK_BF16)
        del cache, ar, twin
    flash_case(ck, timer, gen, f"llama B=1 T=512 H={H} D={D}", 1, 512, 512,
               H, H, D, {}, timed=True)


def check_llama_serving_kernels(ck, timer, gen):
    """LLaMA-2 7B Q4_K_M serving's shapes (phase 9b's serving pass): the
    cells attention and the fused KV update in cells mode over the 2048-cell
    arena at 32 kv heads of 128 (check_serving_kernels(llama=True)), and
    natpair W4A16 with bf16 scales and a bias at the serving ubatches' M 8
    and 128 on qkv_w, gu_w and down_w (the Q6_K W8A16 at M 8 and 128 in
    check_format_kernels)."""
    check_serving_kernels(ck, timer, gen, llama=True)
    E, F = LLAMA2_7B["n_embd"], 11264
    for label, (K, N) in (("qkv_w", (E, 3 * E)), ("gu_w", (E, 2 * F)),
                          ("down_w", (F, E))):
        qt = q4k_natpair(K, N, gen)
        time_instance(ck, timer, gen, f"llama Q4_K {label}", qt, (8, 128))
        del qt


def format_weight(fmt, K, N, gen, scale_dtype):
    """A weight in one of the formats this script's later phases run,
    drawn as they draw it and repacked: "Q6_K" per-16 int8 levels in
    [-32, 31], no bias (models/llama.synthetic_params_device); "Q5_K"
    per-32 raw levels [0, 31] with a bias -min (models/gpt2
    .synthetic_params_device); "Q4_1" per-32 nib4, zero 0, with a bias m
    (natpair); "IQ4_XS" per-32 int8 values of KVALUES_IQ4NL, f32 scales, no
    bias (models/llama.synthetic_params_device); "Q5_0" per-32 int8 levels
    in [-16, 15], f32 scales, no bias (models/whisper
    .synthetic_params_device)."""
    from ggml_imax_tpu_torch.ops import qmm
    from ggml_imax_tpu_torch.quant.device import QTensor
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    normal = lambda shape: torch.randn(shape, generator=gen, device="cuda")
    tag = 512 if K % 512 == 0 else (256 if K % 256 == 0 else K)
    if fmt == "Q4_1":
        q = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8,
                          generator=gen, device="cuda")
        qt = QTensor("nib4", q, normal((K // 32, N)).abs_().mul_(0.02 / 7.5),
                     normal((K // 32, N)).abs_().mul_(-0.02), K, N,
                     GGMLType.Q4_1, zero=0)
        return qmm.repack_natpair(qt, tag, scale_dtype=scale_dtype)
    if fmt == "IQ4_XS":
        from ggml_imax_tpu_torch.quant.codecs import KVALUES_IQ4NL
        idx = torch.randint(0, 16, (K * N,), dtype=torch.int32,
                            generator=gen, device="cuda")
        q = torch.from_numpy(KVALUES_IQ4NL).cuda().index_select(0, idx)
        qt = QTensor("int8", q.reshape(K, N),
                     normal((K // 32, N)).abs_().mul_(0.02 / 67.18), None, K,
                     N, GGMLType.IQ4_XS)
        return qmm.repack_nat8(qt, tag, scale_dtype=scale_dtype)
    lo, hi, g, div, bias = {"Q6_K": (-32, 32, 16, 18.5, False),
                            "Q5_K": (0, 32, 32, 18, True),
                            "Q5_0": (-16, 16, 32, 9.2, False)}[fmt]
    q = torch.randint(lo, hi, (K, N), dtype=torch.int8, generator=gen,
                      device="cuda")
    qt = QTensor("int8", q, normal((K // g, N)).abs_().mul_(0.02 / div),
                 normal((K // g, N)).abs_().mul_(-0.02 / 3) if bias else None,
                 K, N, GGMLType[fmt])
    return qmm.repack_nat8(qt, tag, scale_dtype=scale_dtype)


def time_instance(ck, timer, gen, label, qt, ms):
    """One natpair or nat8 weight through its wrappers at each M (W4A8 /
    W8A8 at M 1, W4A16 / W8A16 above, with the route and K split each
    took) against the plain versions, timed (the GEMVs led) beside the
    plain version, bf16 torch.matmul on the weight dequantized beforehand
    with its bias (a yardstick the port never calls) and the bound."""
    from ggml_imax_tpu_torch.ops import qmm
    nat8 = qt.q4_layout == 4
    g = qt.k // qt.scale.shape[0]
    gemv, gemv_plain, gemm, gemm_plain, name1, name2, plan1, plan2 = (
        (qmm.nat8_w8a8_gemv, qmm.nat8_w8a8_gemv_plain, qmm.nat8_w8a16_gemm,
         qmm.nat8_w8a16_gemm_plain, "nat8_w8a8", "nat8_w8a16",
         lambda: qmm.nat8_gemv_plan(qt.k, qt.n, g), qmm.nat8_plan)
        if nat8 else
        (qmm.w4a8_gemv, qmm.w4a8_gemv_plain, qmm.w4a16_gemm,
         qmm.w4a16_gemm_plain, "w4a8_gemv", "w4a16_gemm",
         lambda: qmm.w4a8_plan(qt.k, qt.n), qmm.natpair_plan))
    wd = qmm.dequant_bf16(qt)
    if qt.bias is not None:
        wd = wd + qt.bias.to(torch.bfloat16).repeat_interleave(g, 0)
    wbytes = sum(t.numel() * t.element_size()
                 for t in (qt.q, qt.scale, qt.bias) if t is not None)
    dt = str(qt.scale.dtype)[6:] + ("+bias" if qt.bias is not None else "")
    for M in ms:
        x = torch.randn(M, qt.k, generator=gen, device="cuda")
        xb = x.to(torch.bfloat16)
        lib = timer(lambda: torch.matmul(xb, wd), iters=50, lead=M == 1)
        if M == 1:
            x8, dx = qmm.quantize_activations_q8(x, g if nat8 else 32)
            x8, dx = x8[:, 0].contiguous(), dx[:, 0].contiguous()
            xs = None if qt.bias is None else \
                (dx * x8.float().sum(-1)).contiguous()
            ck.record(name1, f"{label} m=1 K={qt.k} N={qt.n} g{g} {dt} split "
                      f"{plan1()} (led)", gemv(x8, dx, qt, xs),
                      gemv_plain(x8, dx, qt, xs), 1e-4,
                      timer(lambda: gemv(x8, dx, qt, xs), iters=50, lead=True),
                      timer(lambda: gemv_plain(x8, dx, qt, xs), iters=3), lib,
                      wbytes + qt.k + dx.numel() * 4 * (1 if xs is None else 2)
                      + qt.n * 4, 2 * qt.k * qt.n, PEAK_INT8)
            continue
        route, split = plan2(M, qt.k, qt.n)
        ck.record(name2, f"{label} M={M} K={qt.k} N={qt.n} g{g} {dt} "
                  f"{route}/{split}", gemm(x, qt), gemm_plain(x, qt), 1e-3,
                  timer(lambda: gemm(x, qt)),
                  timer(lambda: gemm_plain(x, qt), iters=3), lib,
                  M * qt.k * 2 + wbytes + M * qt.n * 4, 2 * M * qt.k * qt.n,
                  PEAK_BF16)
    del wd


def check_format_kernels(ck, timer, gen):
    """The kernel instances the formats of phases 5b, 8b, 8c, 9b and 9c put
    on a path: nat8 W8A8 / W8A16 at g 16 with bf16 scales and no bias at
    LLaMA-2 7B Q4_K_M's Q6_K products (v_w 4096 x 4096, down_w 11264 x
    4096, the head 4096 x 32000; M 1, 8 and 512, and the serving ubatches'
    M 128 at v_w and down_w); at g 32 with f32 scales
    and a bias at GPT-2 XL Q5_K's fc_w (1600 x 6400; M 1, 5, 8, 128 and
    512); W4A8 / W4A16 with f32 scales and a bias at GPT-2 117M Q4_1's
    attn_w (768 x 2304; M 1, 8 and 512); nat8 at g 32 with f32 scales and
    no bias at LLaMA-2 7B IQ4_XS's fused products (qkv_w 4096 x 12288, o_w
    4096 x 4096, gu_w 4096 x 22528, down_w 11264 x 4096; M 1, 8 and
    512)."""
    E, F, V = LLAMA2_7B["n_embd"], 11264, LLAMA2_7B["n_vocab"]
    for label, (K, N), ms in (("llama Q6_K v_w", (E, E), (1, 8, 128, 512)),
                              ("llama Q6_K down_w", (F, E), (1, 8, 128, 512)),
                              ("llama Q6_K output", (E, V), (1, 8, 512))):
        qt = format_weight("Q6_K", K, N, gen, torch.bfloat16)
        time_instance(ck, timer, gen, label, qt, ms)
        del qt
    X = GPT2_XL["n_embd"]
    time_instance(ck, timer, gen, "gpt2-xl Q5_K fc_w",
                  format_weight("Q5_K", X, 4 * X, gen, None),
                  (1, 5, 8, 128, 512))
    S = GPT2_117M["n_embd"]
    time_instance(ck, timer, gen, "gpt2-117m Q4_1 attn_w",
                  format_weight("Q4_1", S, 3 * S, gen, None), (1, 8, 512))
    for label, (K, N) in (("qkv_w", (E, 3 * E)), ("o_w", (E, E)),
                          ("gu_w", (E, 2 * F)), ("down_w", (F, E))):
        qt = format_weight("IQ4_XS", K, N, gen, None)
        time_instance(ck, timer, gen, f"llama IQ4_XS {label}", qt,
                      (1, 8, 512))
        del qt


def legacy_repack(params, layout):
    """The legacy-layout pass's params: every natural nib4 leaf through
    repack_rowpair ("rowpair"), or every natural int8 leaf through
    repack_int8_rows ("int8"), each with the largest of 512 and 256 that
    divides its K, as params_repack shrinks its tag. A helper of this
    script, not a package feature: the JAX package offers both repacks,
    and its forward, get_rows and dequantize_xla take either layout."""
    from ggml_imax_tpu_torch.ops import qmm
    from ggml_imax_tpu_torch.quant.device import QTensor
    fn, kind = {"rowpair": (qmm.repack_rowpair, "nib4"),
                "int8": (qmm.repack_int8_rows, "int8")}[layout]

    def walk(d):
        if isinstance(d, dict):
            return {k: walk(v) for k, v in d.items()}
        if isinstance(d, list):
            return [walk(v) for v in d]
        if isinstance(d, QTensor) and d.kind == kind and d.interleaved_bk == 0:
            return fn(d, 512 if d.k % 512 == 0 else 256)
        return d
    return walk(params)


def check_small_model(failures, model, cfg, variants, label, n_prompt=40,
                      n_steps=4, tol=5e-2, relative=False):
    """Kernels on the card against the plain versions on the CPU, through
    the whole forward of a small model; variants: (name, make params on a
    device, cache kwargs[, forward kwargs]). The logits agree to tol, or
    with `relative` to tol times the CPU run's largest |logit|."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.n_vocab, (1, n_prompt))
    feed = rng.integers(0, cfg.n_vocab, n_steps)    # teacher-forced steps
    for name, make, cache_kw, *fwd in variants:
        kw = fwd[0] if fwd else {}
        runs = {}
        for dev in ("cuda", "cpu"):
            p = make(dev)
            cache = model.init_cache(cfg, device=dev, **cache_kw)
            lg, cache = model.forward(cfg, p, torch.as_tensor(prompt, device=dev),
                                      torch.arange(n_prompt, device=dev)[None],
                                      cache, 0, **kw)
            steps = [lg[0, -1].float().cpu()]
            for i, tok in enumerate(feed):
                n_past = n_prompt + i
                lg, cache = model.forward(
                    cfg, p, torch.tensor([[int(tok)]], device=dev),
                    torch.full((1, 1), n_past, device=dev), cache, n_past,
                    **kw)
                steps.append(lg[0, -1].float().cpu())
            runs[dev] = steps
        err = max(float((a - b).abs().max())
                  for a, b in zip(runs["cuda"], runs["cpu"]))
        finite = all(bool(torch.isfinite(a).all()) for a in runs["cuda"])
        limit = tol * logit_scale(runs["cpu"]) if relative else tol
        log(f"  small {label} {name}: max |logit diff| card vs CPU {err:.3e} "
            f"(limit {limit:.3e}), finite={finite}")
        if err > limit or not finite:
            failures.append(f"small {label} {name}: logit diff {err:.3e}")


def check_small_models(failures):
    from ggml_imax_tpu_torch.models import gpt2, gptj
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.formats import GGMLType

    cfg = gptj.GPTJConfig(n_vocab=512, n_ctx=256, n_embd=512, n_head=2,
                          n_layer=2, n_rot=64)
    make = lambda dev: params_repack(gptj.prepare_fused(
        gptj.synthetic_params(cfg, seed=5, device=dev), cfg))
    check_small_model(failures, gptj, cfg,
                      [(f"kv={kv}", make, {"dtype": kv})
                       for kv in (torch.bfloat16, "q8_0")], "GPT-J")
    # the CPU parity tests' GPT-2: only fc_w passes the kernel gate
    cfg2 = gpt2.GPT2Config(n_vocab=1000, n_ctx=64, n_embd=320, n_head=5,
                           n_layer=2)
    variants = []
    for wtype in (GGMLType.Q8_0, GGMLType.Q4_0):
        mk = lambda dev, wtype=wtype: params_repack(gpt2.prepare_fused(
            gpt2.synthetic_params(cfg2, wtype, seed=5, device=dev)))
        variants.append((wtype.name, mk, {}))
    check_small_model(failures, gpt2, cfg2, variants, "GPT-2")
    # the K-quant slice's GPT-2 (K-quants need n_embd % 256 == 0): every
    # layer product on a permuted-layout kernel
    cfg3 = gpt2.GPT2Config(n_vocab=1000, n_ctx=64, n_embd=256, n_head=4,
                           n_layer=2)
    variants = []
    for label, wtype, layout in (("Q3_K", GGMLType.Q3_K, None),
                                 ("Q2_K", GGMLType.Q2_K, None),
                                 ("row-pair Q4_0", GGMLType.Q4_0, "rowpair"),
                                 ("u-order Q8_0", GGMLType.Q8_0, "int8")):
        def mk(dev, wtype=wtype, layout=layout):
            p = gpt2.synthetic_params(cfg3, wtype, seed=5, device=dev)
            return params_repack(p) if layout is None else \
                legacy_repack(p, layout)
        variants.append((label, mk, {}))
    check_small_model(failures, gpt2, cfg3, variants, "GPT-2 n_embd 256")


# The small LLaMA of phase 3. Its card and CPU runs are held to ROUTE_TOL
# of the largest |logit| (the 6B paths' limit), not GPT-J's 5e-2: the
# kernels sum in another order than the plain versions (W4A16 ~2e-6
# apart), which flips bf16 and int8 roundings downstream, and this model
# (logits up to ~5.2) moves by up to 2.2% of its largest logit under such
# noise on the CPU; an H100 read 1.2-2.1% (PERF.md). For the same
# reason its greedy tokens may part between the devices at a near-tie, so
# check_small_chunked holds them per device.
SMALL_LLAMA = dict(n_vocab=512, n_ctx=256, n_embd=256, n_head=2, n_head_kv=1,
                   n_layer=2, n_ff=768)


def moved(params, dev):
    """A params tree with every tensor moved to `dev`."""
    from dataclasses import replace

    from ggml_imax_tpu_torch.quant.device import QTensor
    if isinstance(params, dict):
        return {k: moved(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [moved(v, dev) for v in params]
    if isinstance(params, QTensor):
        opt = lambda t: None if t is None else t.to(dev)
        return replace(params, q=params.q.to(dev), scale=opt(params.scale),
                       bias=opt(params.bias), lut=opt(params.lut),
                       signs=opt(params.signs))
    return None if params is None else params.to(dev)


def small_llama(dev):
    """The CPU tests' small LLaMA (head_dim 128, GQA 2:1, n_ff 768 padded to
    1024): normal weights of std 0.08 quantized to Q4_K on the host (the
    same weights on both devices; the benchmark's structural draw gives
    every token the same top logit at this size), fused, repacked, moved to
    `dev`."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.device import quantize_for_device
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    cfg = llama.LlamaConfig(**SMALL_LLAMA)
    rng = np.random.default_rng(5)
    E, F, kv = cfg.n_embd, cfg.n_ff, cfg.n_head_kv * cfg.head_dim

    def q(k, n):
        w = (rng.standard_normal((k, n)) * 0.08).astype(np.float32)
        return quantize_for_device(w, GGMLType.Q4_K, device="cpu")

    def norm(n):
        return torch.from_numpy((1 + 0.1 * rng.standard_normal(n))
                                .astype(np.float32))

    p = {"tok_embd": q(E, cfg.n_vocab), "out_norm": norm(E),
         "output": q(E, cfg.n_vocab), "layers": []}
    for _ in range(cfg.n_layer):
        p["layers"].append({
            "attn_norm": norm(E), "q_w": q(E, E), "k_w": q(E, kv),
            "v_w": q(E, kv), "o_w": q(E, E), "ffn_norm": norm(E),
            "gate_w": q(E, F), "up_w": q(E, F), "down_w": q(F, E)})
    p = llama.fuse_gate_up(llama.fuse_qkv(p), pad_multiple=1024)
    return cfg, moved(params_repack(p), dev)


def check_small_llama(failures):
    """The small LLaMA on the card (kernels) against the CPU (plain
    versions): prefill + decode on the default and the fused KV-update
    route, bf16 and q8_0 KV; then a decode-only celled ubatch of 2 rows
    (two sequences in one shared arena, after their prompt ubatch) through
    both cells routes (cells_kernel, without and with the fused update),
    with the launches of that ubatch."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.models import llama
    cfg = llama.LlamaConfig(**SMALL_LLAMA)
    made = {dev: small_llama(dev)[1] for dev in ("cuda", "cpu")}
    check_small_model(failures, llama, cfg,
                      [(f"kv={kv} fused={fused}", lambda dev: made[dev],
                        {"dtype": kv}, {"fused_kv_update": fused})
                       for kv in (torch.bfloat16, "q8_0")
                       for fused in (False, True)], "LLaMA",
                      tol=ROUTE_TOL, relative=True)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.n_vocab, 18)
    pos = np.array(list(range(10)) + list(range(6)) + [10, 6])
    seq = np.array([0] * 10 + [1] * 6 + [0, 1])
    ubatches = []
    for idx in (np.arange(16), np.arange(16, 18)):
        cell_pos = np.full(cfg.n_ctx, -1)
        cell_pos[:idx[-1] + 1] = pos[:idx[-1] + 1]
        cell_seq = np.zeros(cfg.n_ctx, np.int64)
        cell_seq[:idx[-1] + 1] = seq[:idx[-1] + 1]
        vis = (cell_seq[None] == seq[idx][:, None]) & (cell_pos[None] >= 0) \
            & (cell_pos[None] <= pos[idx][:, None])
        ubatches.append((toks[idx], pos[idx], idx,
                         np.where(vis, 0.0, -np.inf).astype(np.float32)))
    for fused in (False, True):
        runs = {}
        for dev in ("cuda", "cpu"):
            cache = llama.init_cache(cfg, dtype="q8_0", device=dev)
            t = lambda a: torch.as_tensor(a, device=dev)[None]
            out = []
            for i, (tk, ps, cells, m) in enumerate(ubatches):
                _build.reset_launches()
                lg, cache = llama.forward(
                    cfg, made[dev], t(tk).long(), t(ps).long(), cache, 0,
                    cells=t(cells).long(), mask=t(m)[None],
                    cells_kernel=i == 1, fused_kv_update=fused)
                out.append(lg[0].float().cpu())
            runs[dev] = (out, dict(_build.LAUNCHES))
        err = max(float((a - b).abs().max())
                  for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
        limit = ROUTE_TOL * logit_scale(runs["cpu"][0])
        attn = "decode_attention_update" if fused else \
            "decode_attention_cells"
        want = {"w4a8_gemv": 0, "w4a16_gemm": 9, attn: 2}
        got = {k: runs["cuda"][1][k] for k in want}
        log(f"  small LLaMA decode-only celled ubatch of 2 rows, cells route "
            f"{'cells (fused)' if fused else 'cells2'}: max |logit diff| "
            f"card vs CPU {err:.3e} (limit {limit:.3e}), launches {got}")
        if err > limit or got != want:
            failures.append(f"small LLaMA cells fused={fused}: err {err:.3e}, "
                            f"launches {got} (expected {want})")
    _build.reset_launches()


def recording(model, logs):
    """The model module with a forward that also appends, per call, the f32
    logits of the ubatch's real rows (not the pad rows, whose cell is the
    trash cell) to `logs`, on the host."""
    import functools
    import types

    @functools.wraps(model.forward)
    def forward(cfg, params, tokens, positions, cache, n_past, **kw):
        lg, cache = model.forward(cfg, params, tokens, positions, cache, n_past,
                                  **kw)
        logs.append(lg[0][kw["cells"][0] != cache.n_ctx - 1].float().cpu())
        return lg, cache
    return types.SimpleNamespace(forward=forward, __name__=model.__name__,
                                 init_cache=model.init_cache)


def same_greedy(ref, got, ref_toks, got_toks, tol=5e-2):
    """Two runs of one greedy workload (two devices, two routes, or kernels
    and plain versions): ref/got are their logits, one (rows, V) tensor per
    forward. Holds when the tokens are equal and every forward agrees to
    `tol`. Returns (ok, diffs, note): diffs, the max |logit diff| of each
    forward; where the tokens differ, only up to the first forward whose
    picks part (the later ones are fed other tokens; a row that samples
    nothing, a prompt row, may part at a near-tie without that)."""
    diffs = []
    for i, (a, b) in enumerate(zip(ref, got)):
        if a.shape != b.shape:
            break
        diffs.append(float((a - b).abs().max()))
        if ref_toks != got_toks and (a.argmax(-1) != b.argmax(-1)).any():
            return False, diffs, f"tokens differ, picks part at forward {i}"
    if ref_toks != got_toks or len(ref) != len(got):
        return False, diffs, "tokens differ"
    return max(diffs) <= tol, diffs, "tokens equal"


def logit_scale(logs) -> float:
    return max(float(a.abs().max()) for a in logs)


def check_small_batched(failures):
    """The small GPT-J's BatchedEngine (two requests, then a fork of the
    first, q8_0 KV, greedy with host sampling) on the card and on the CPU,
    both cells routes: the logits of every ubatch agree to 5e-2 and the
    tokens are equal (same_greedy)."""
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.runtime.batched import BatchedEngine

    cfg = gptj.GPTJConfig(n_vocab=512, n_ctx=256, n_embd=512, n_head=2,
                          n_layer=2, n_rot=64)
    rng = np.random.default_rng(6)
    prompts = [list(rng.integers(0, cfg.n_vocab, n)) for n in (21, 9)]
    for fused in (False, True):
        runs = {}
        for dev in ("cuda", "cpu"):
            logs = []
            p = params_repack(gptj.prepare_fused(
                gptj.synthetic_params(cfg, seed=5, device=dev), cfg))
            be = BatchedEngine(recording(gptj, logs), cfg, p, kv_dtype="q8_0",
                               device=dev, fused_kv_update=fused)
            rids = [be.add_request(pr, 8, temp=0.0) for pr in prompts]
            be.step()
            rids.append(be.fork(rids[0]))
            res = be.run()
            runs[dev] = ([res[r] for r in rids], logs, dict(be.n_ubatches))
        (tok_c, lg_c, nu_c), (tok_h, lg_h, _) = runs["cuda"], runs["cpu"]
        ok, diffs, note = same_greedy(lg_h, lg_c, tok_h, tok_c)
        log(f"  small GPT-J BatchedEngine fused_kv_update={fused}: {nu_c} "
            f"ubatches, max |logit diff| card vs CPU {max(diffs):.3e} (tol "
            f"5e-02), tokens equal {tok_c == tok_h}, {note}")
        if not ok:
            failures.append(f"small batched fused={fused}: err "
                            f"{max(diffs):.3e}, {note}, tokens {tok_c} vs "
                            f"{tok_h}")


def check_small_chunked(failures):
    """Captured spans and chunks at small size: the 2-layer GPT-J and LLaMA
    (both KV types, the default and the fused flat route) and GPT-2 (Q8_0,
    nat8 W8A8 on fc_w) run generate(chunk=4) greedily on the card; their tokens
    must equal generate(chunk=1) on the card and on the CPU. The small
    GPT-J's BatchedEngine (q8_0 KV, on-device sampling) runs three requests
    through run_pipelined(4); its greedy tokens must equal the step() loop's
    on the card, and every cell must be freed."""
    from ggml_imax_tpu_torch.models import gpt2, gptj
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    from ggml_imax_tpu_torch.runtime.batched import BatchedEngine
    from ggml_imax_tpu_torch.runtime.engine import Engine

    cfg = gptj.GPTJConfig(n_vocab=512, n_ctx=256, n_embd=512, n_head=2,
                          n_layer=2, n_rot=64)
    mk_j = lambda dev: params_repack(gptj.prepare_fused(
        gptj.synthetic_params(cfg, seed=5, device=dev), cfg))
    cfg2 = gpt2.GPT2Config(n_vocab=1000, n_ctx=64, n_embd=320, n_head=5,
                           n_layer=2)
    mk_2 = lambda dev: params_repack(gpt2.prepare_fused(
        gpt2.synthetic_params(cfg2, GGMLType.Q8_0, seed=5, device=dev)))
    prompt = list(np.random.default_rng(8).integers(0, 512, 40))
    cases = [(f"GPT-J kv={kv} fused={fused}", gptj, cfg, mk_j,
              dict(kv_dtype=kv, fused_kv_update=fused))
             for kv in (torch.bfloat16, "q8_0") for fused in (False, True)]
    cases.append(("GPT-2 Q8_0", gpt2, cfg2, mk_2, {}))
    from ggml_imax_tpu_torch.models import llama
    cases += [(f"LLaMA kv={kv} fused={fused}", llama,
               llama.LlamaConfig(**SMALL_LLAMA),
               lambda dev: small_llama(dev)[1],
               dict(kv_dtype=kv, fused_kv_update=fused))
              for kv in (torch.bfloat16, "q8_0") for fused in (False, True)]
    params = {}
    for label, model, c, make, kw in cases:
        toks = {}
        for dev in ("cuda", "cpu"):
            if (label[:5], dev) not in params:
                params[label[:5], dev] = make(dev)
            eng = Engine(model, c, params[label[:5], dev], device=dev, **kw)
            toks[dev, 1] = eng.generate(prompt, 12, temp=0)
            toks[dev, 4] = eng.generate(prompt, 12, temp=0, chunk=4)
            if dev == "cuda":                      # a second run: replays
                toks[dev, "replay"] = eng.generate(prompt, 12, temp=0, chunk=4)
        same = lambda dev: len({tuple(t) for (d, _), t in toks.items()
                                if d == dev}) == 1
        across = len({tuple(t) for t in toks.values()}) == 1
        # GPT-J and GPT-2: one token list on both devices; LLaMA: on each
        # device (SMALL_LLAMA), the devices' lists logged
        ok = same("cuda") and same("cpu") if model is llama else across
        card = toks["cuda", 4]
        log(f"  small {label}: generate(chunk=4) on the card (captured spans, "
            f"then replays) vs chunk 1 on the card and on the CPU: tokens "
            f"equal on the card {same('cuda')}, on the CPU {same('cpu')}, "
            f"across the devices {across} {card}")
        if not ok:
            failures.append(f"small chunked {label}: tokens {toks}")
    rng = np.random.default_rng(6)
    prompts = [list(rng.integers(0, cfg.n_vocab, n)) for n in (21, 9, 30)]
    outs = []
    for pipelined in (False, True):
        be = BatchedEngine(gptj, cfg, params["GPT-J", "cuda"], kv_dtype="q8_0",
                           on_device_sampling=True)
        rids = [be.add_request(p, n, temp=0.0)
                for p, n in zip(prompts, (11, 7, 18))]
        res = be.run_pipelined(4) if pipelined else be.run()
        outs.append([res[r] for r in rids])
        if (be.cell_pos[:-1] != -1).any():
            failures.append(f"small run_pipelined={pipelined}: cells not freed")
    log(f"  small GPT-J BatchedEngine: run_pipelined(4) ({len(be._chunks)} "
        f"captured chunks) vs the step() loop on the card: tokens equal "
        f"{outs[0] == outs[1]}")
    if outs[0] != outs[1]:
        failures.append(f"small run_pipelined: {outs[1]} vs step() {outs[0]}")


def _device_ms(fn, reps, launches=None):
    """Device time by kernel name, ms per rep (torch.profiler, CUDA); with
    a dict `launches`, also each name's launches per rep into it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
    evs = [ev for ev in prof.key_averages()
           if str(ev.device_type).endswith("CUDA")
           and ev.self_device_time_total > 0]
    if launches is not None:
        launches.update({ev.key: ev.count / reps for ev in evs})
    return {ev.key: ev.self_device_time_total / 1e3 / reps for ev in evs}


# kernel file -> the kernel names of its routes in a profile
SHARES = {"W4A8 (w4a8_gemv.cu)": ("w4a8_split_k",),
          "W4A16 (w4a16_gemm.cu)": ("w4a16_small_m", "w4a16_tile"),
          "nat8 W8A16 (nat8_gemm.cu)": ("nat8_small_m", "nat8_tile"),
          "nat8 W8A8 (nat8_gemv.cu)": ("nat8_gemv_kernel",),
          "cells decode attention (decode_attention_cells.cu)":
              ("cells_kernel",),
          "flash forward (flash_attention.cu and its tile map)":
              ("flash_fwd_kernel", "flash_bwd_tiles_kernel"),
          "decode attention (decode_attention.cu)": ("decode_cluster_kernel",)}


def kernel_share(dev, busy, label, what="W4A16 (w4a16_gemm.cu)",
                 launches=None):
    """Log the device time of one kernel file's routes (SHARES[what]) in a
    profile (kernel name -> ms) against the device busy time, and with
    `launches` (kernel name -> launches) the time a launch; None where the
    profile has none."""
    keys = [k for k in dev if any(n in k for n in SHARES[what])]
    ms = sum(dev[k] for k in keys)
    if not ms:
        return None
    each = ""
    if launches:
        n = sum(launches.get(k, 0) for k in keys)
        each = f", {n:g} launches, {ms / n:.4f} ms a launch"
    log(f"  {label}: {what} {ms:.3f} ms of {busy:.3f} ms device busy "
        f"({100 * ms / busy:.1f}%{each})")
    return ms


def profile_engine(eng, rng, reqs, steps=8):
    """Device busy share of a prefill and of decode steps: kernel time in a
    torch.profiler trace against the unprofiled TTFT and step time. Returns
    the device busy ms of each (None where the trace has no device time)."""
    prompt = rng.integers(0, eng.cfg.n_vocab, (1, PROMPT))
    box, busy_ms = {}, {}

    def pre(_):
        box["cache"] = eng.new_cache()
        eng.prefill(box["cache"], prompt)

    def dec(i):
        eng.decode_step(box["cache"], np.array([1]), PROMPT + i)

    walls = {"prefill": float(np.median([r["ttft_ms"] for r in reqs])),
             "decode step": 1e3 / float(np.median([r["decode_tok_s"]
                                                   for r in reqs]))}
    for label, fn, reps in (("prefill", pre, 1), ("decode step", dec, steps)):
        launches = {}
        dev = _device_ms(fn, reps, launches)
        busy_ms[label] = sum(dev.values()) if dev else None
        if not dev:
            log(f"  profiled {label}: no device time in the trace (not measured)")
            continue
        busy, wall = busy_ms[label], walls[label]
        log(f"  profiled {label}: device busy {busy:.3f} ms of {wall:.3f} ms "
            f"unprofiled -> busy {100 * busy / wall:.1f}%, idle "
            f"{100 * (1 - busy / wall):.1f}%")
        for key, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
            log(f"    {ms:9.4f} ms  {key[:90]}")
        for what in SHARES:
            kernel_share(dev, busy, f"profiled {label}", what, launches)
    return busy_ms, walls


def arena_of(eng):
    """A copy of the engine's KV arena (generate()'s cache)."""
    c = eng.arena
    return [t.clone() for t in (c.k, c.v, c.ks, c.vs) if t is not None]


def same_arena(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def run_requests(eng, prompts, failures, chunk=1, label="request"):
    """Each prompt + N_PREDICT greedy tokens through eng.generate(chunk=
    chunk), the launch counters set to 0 just before and read just after.
    Returns (per-request numbers, tokens, launch counts, a copy of the KV
    arena after each request)."""
    from ggml_imax_tpu_torch import _build
    _build.reset_launches()
    reqs, outs, arenas = [], [], []
    for r, prompt in enumerate(prompts):
        stamps = []
        t0 = time.perf_counter()
        out = eng.generate(prompt, N_PREDICT, temp=0, chunk=chunk,
                           callback=lambda tok: stamps.append(time.perf_counter()))
        ttft = (stamps[0] - t0) * 1e3
        tok_s = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        ok = len(out) == N_PREDICT and all(0 <= t < eng.cfg.n_vocab for t in out)
        log(f"  {label} {r}: TTFT {ttft:.2f} ms, decode {tok_s:.2f} tok/s "
            f"({1e3 / tok_s:.3f} ms a token), {len(out)} tokens, first "
            f"{out[:8]}")
        if not ok:
            failures.append(f"{label} {r}: bad tokens {out}")
        reqs.append({"ttft_ms": ttft, "decode_tok_s": tok_s})
        outs.append(out)
        arenas.append(arena_of(eng))
    counts = dict(_build.LAUNCHES)
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"  launches over {len(prompts)} {label}s: {counts}")
    return reqs, outs, counts, arenas


def serve(model, cfg, params, n_ctx, failures, n_requests=N_REQUESTS,
          residency="as-is"):
    """The engine phase: Engine(residency=residency), a warm-up, then
    n_requests requests of a PROMPT-token prompt + N_PREDICT greedy tokens,
    one token a step (run_requests). Returns (engine, rng, per-request
    numbers, launch counts, (the warm-up prompt, the prompts, their tokens,
    the KV arena after each))."""
    from ggml_imax_tpu_torch.runtime.engine import Engine

    eng = Engine(model, cfg, params, n_ctx=n_ctx, residency=residency)
    rng = np.random.default_rng(0)
    warm = rng.integers(0, cfg.n_vocab, PROMPT)
    last = eng.prefill(eng.new_cache(), warm[None])[0]   # drops its cache
    if last.shape != (1, cfg.n_vocab) or not np.isfinite(last).all():
        failures.append(f"prefill logits: shape {last.shape}, "
                        f"finite {np.isfinite(last).all()}")
    eng.generate(warm, 2, temp=0)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"  allocated before the requests "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    prompts = [rng.integers(0, cfg.n_vocab, PROMPT) for _ in range(n_requests)]
    reqs, outs, counts, arenas = run_requests(eng, prompts, failures)
    return eng, rng, reqs, counts, (warm, prompts, outs, arenas)


def pool_bytes(pool):
    """Bytes of the CUDA caching allocator's segments in a graph memory pool
    (torch.cuda.memory_snapshot's segment_pool_id); None where the snapshot
    does not say."""
    segs = torch.cuda.memory_snapshot()
    if pool is None or not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(sg["total_size"] for sg in segs
               if tuple(sg["segment_pool_id"]) == tuple(pool))


def serve_chunked(eng, runs, failures, n=N_REQUESTS):
    """The first n requests of serve() again, through generate(chunk=CHUNK):
    a warm-up request first (the spans' first use: an eager run and the
    capture, for spans of CHUNK and of the tail's N_PREDICT - 1 - CHUNK *
    k), then the requests, whose tokens, and KV arena after each, must
    equal serve()'s bit for bit (at random weights a token often follows
    from its predecessor alone, so the arena is what shows a step that
    attends to the wrong rows). Returns (per-request numbers, launch
    counts, summary)."""
    warm, prompts, want, want_arenas = runs
    t0 = time.perf_counter()
    eng.generate(warm, N_PREDICT, temp=0, chunk=CHUNK)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    pool = pool_bytes(eng.graph_pool)
    log(f"  chunk {CHUNK} warm-up request {warm_s:.2f} s, of which the spans' "
        f"eager first runs and captures {eng.capture_s:.2f} s "
        f"({len(eng._spans)} spans); graph pool "
        + ("not measured" if pool is None else f"{pool / 2**20:.1f} MiB"))
    torch.cuda.reset_peak_memory_stats()
    reqs, outs, counts, arenas = run_requests(eng, prompts[:n], failures,
                                              CHUNK, f"chunk-{CHUNK} request")
    same = [(got == ref, same_arena(a, b)) for got, ref, a, b
            in zip(outs, want, arenas, want_arenas)]
    for r, (tok_ok, arena_ok) in enumerate(same):
        if not (tok_ok and arena_ok):
            failures.append(f"chunk-{CHUNK} request {r}: tokens equal "
                            f"{tok_ok}, KV arena equal {arena_ok}")
    log(f"  chunk {CHUNK} vs chunk 1, request by request: (tokens equal, KV "
        f"arena equal bit for bit) {same}")
    del arenas
    return reqs, counts, {"capture_s": eng.capture_s, "warm_up_s": warm_s,
                          "graph_pool_bytes": pool}


def profile_span(eng, step_busy_ms, reps=4):
    """A replayed span of CHUNK decode steps at n_past PROMPT: its wall time
    (host clock to the fetch) and its device busy share, from torch.profiler
    over replays where the trace resolves the graph's kernels, else the
    eager step's profiled device time x CHUNK. Returns (span ms, busy ms,
    method)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.decode_span([1], PROMPT, CHUNK)
    wall = (time.perf_counter() - t0) / reps * 1e3
    dev = _device_ms(lambda _: eng.decode_span([1], PROMPT, CHUNK), reps)
    if dev:
        busy, how = sum(dev.values()), "torch.profiler over replays"
        for key, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:6]:
            log(f"    {ms:9.4f} ms  {key[:90]}")
    elif step_busy_ms is not None:
        busy, how = step_busy_ms * CHUNK, ("the trace shows no kernel of a "
                                           "replay: eager step's device time "
                                           f"x {CHUNK}")
    else:
        log(f"  span of {CHUNK}: {wall:.3f} ms, device busy not measured")
        return wall, None, "not measured"
    log(f"  replayed span of {CHUNK} steps: {wall:.3f} ms ({wall / CHUNK:.3f} "
        f"ms a token), device busy {busy:.3f} ms -> busy "
        f"{100 * busy / wall:.1f}% ({how})")
    return wall, busy, how


def frozen_n_past_control(eng, runs, failures):
    """Control: the spans captured anew with the n_past advance taken out of
    the captured step (each step writes and reads at its span's first
    position), one request replayed through them: its tokens and KV arena
    must fail serve_chunked's check against chunk 1's."""
    from ggml_imax_tpu_torch.runtime.engine import Engine
    warm, prompts, want, want_arenas = runs
    real, spans = Engine.__dict__["_advance"], eng._spans
    Engine._advance = staticmethod(lambda st, nxt: st.tok.copy_(nxt))
    eng._spans = {}
    try:
        got = eng.generate(prompts[0], N_PREDICT, temp=0, chunk=CHUNK)
        arena_ok = same_arena(arena_of(eng), want_arenas[0])
        replays = sum(run.graph is not None for _, run in eng._spans.values())
    finally:
        Engine._advance, eng._spans = real, spans
    fails = got != want[0] or not arena_ok
    log(f"  control: chunk {CHUNK} with n_past frozen in the captured span "
        f"({replays} spans captured): tokens equal {got == want[0]}, KV arena "
        f"equal {arena_ok} -> the check {'fails' if fails else 'holds'}")
    if not fails:
        failures.append("control: a span without its n_past advance passed "
                        "the token and arena check")


def gptj_residencies(cfg, params, runs, failures):
    """Phase 4's q4 residencies: Engine(residency="q4-fused") and
    Engine(residency="q4-stacked"), each built from an unprepared draw of
    phase 4's weights (seed 0; the raw draw dropped once the engine has
    prepared it), one request of phase 4 (its first prompt, N_PREDICT greedy
    tokens) with exact launch counts. q4-fused runs phase 4's graph: its
    tokens and KV arena must equal phase 4's prepared engine's bit for bit.
    q4-stacked adds the fused KV update (28 decode_attention_update a step
    where the others count 28 decode_attention); the fused flat kernel
    parts from the decode attention kernel by ~0.1 logit (phase 6), so its
    tokens and arena are held to an Engine(fused_kv_update=True) on phase
    4's prepared params, bit for bit, and whether they also equal phase 4's
    is logged. Returns (summary, launch counts by run)."""
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.runtime.engine import Engine
    warm, prompts, want, want_arenas = runs
    L, n_dec = cfg.n_layer, N_PREDICT - 1
    ref = Engine(gptj, cfg, params, n_ctx=512, fused_kv_update=True)
    ref.generate(warm, 2, temp=0)
    _, fused_outs, _, fused_arenas = run_requests(
        ref, prompts[:1], failures, label="prepared fused-route request")
    del ref
    summary, launches = {}, {}
    for residency in ("q4-fused", "q4-stacked"):
        t0 = time.time()
        raw = gptj.synthetic_params_device(cfg, seed=0)
        eng = Engine(gptj, cfg, raw, n_ctx=512, residency=residency)
        del raw
        torch.cuda.synchronize()
        prep_s = time.time() - t0
        log(f"  Engine(residency={residency!r}) from the unprepared draw: "
            f"drawn + prepared in {prep_s:.1f} s, fused_kv_update "
            f"{eng.fused_kv_update}, {torch.cuda.memory_allocated() / 2**30:.2f}"
            " GiB allocated")
        eng.generate(warm, 2, temp=0)
        reqs, outs, counts, arenas = run_requests(
            eng, prompts[:1], failures, label=f"{residency} request")
        stacked = residency == "q4-stacked"
        attn = "decode_attention_update" if stacked else "decode_attention"
        check_counts(counts, {"w4a8_gemv": n_dec * (2 * L + 1),
                              attn: n_dec * L, "w4a16_gemm": 2 * L + 1,
                              "flash_attention": L,
                              "flash_backward_tiles": L}, failures)
        ref_outs, ref_arenas = (fused_outs, fused_arenas) if stacked else \
            (want, want_arenas)
        tok_ok = outs[0] == ref_outs[0]
        arena_ok = same_arena(arenas[0], ref_arenas[0])
        log(f"  {residency}: tokens equal "
            f"{'the fused-route engine' if stacked else 'phase 4'}'s {tok_ok}, "
            f"KV arena equal bit for bit {arena_ok}"
            + (f"; tokens equal phase 4's default route's "
               f"{outs[0] == want[0]}" if stacked else ""))
        if not (tok_ok and arena_ok):
            failures.append(f"{residency}: tokens equal {tok_ok}, arena equal "
                            f"{arena_ok}")
        summary[residency] = dict(reqs[0], prepare_s=prep_s)
        launches[f"gptj_{residency.replace('-', '_')}"] = counts
        del eng, arenas
        torch.cuda.empty_cache()
    return summary, launches


def check_counts(counts, expect, failures):
    for k, n in counts.items():
        if n != expect.get(k, 0):
            failures.append(f"{k}: {n} launches, expected {expect.get(k, 0)}")


def gated_products_ms(ws, busy_ms, walls):
    """Device time (torch.profiler kernel sum) of the products ws that the
    N % 128 gate leaves to dequantize + torch.matmul (GPT-2 XL: every
    layer's attn_w, proj_w and out_w, and the tied LM head; 117M: the head),
    for one decode step (m = 1) and one prefill (M = 512); with their share
    of the step's device busy time and of its unprofiled wall time."""
    from ggml_imax_tpu_torch.ops.qmatmul import qmatmul
    if not all(w.n % 128 for w in ws):
        raise SystemExit("chip_smoke FAILED: a gated weight passed the gate")
    out = {}
    for label, m in (("decode step", 1), ("prefill", 512)):
        xs = {k: torch.randn(1, m, k, device="cuda") for k in {w.k for w in ws}}
        run = lambda _: [qmatmul(xs[w.k], w, out_dtype=torch.float32) for w in ws]
        run(0)                                     # warm-up
        dev = _device_ms(run, 2)
        out[label] = sum(dev.values()) if dev else None
        if out[label] is None:
            ev = out[f"{label} (CUDA events)"] = Timer()(lambda: run(0), iters=5)
            log(f"  gated products per {label}: no device time in the trace "
                f"(not measured); CUDA events over the products: {ev:.3f} ms")
            continue
        share = "" if busy_ms.get(label) is None else \
            f" = {100 * out[label] / busy_ms[label]:.1f}% of its device busy time"
        log(f"  gated dequant + matmul products per {label} ({len(ws)} "
            f"products): {out[label]:.3f} ms device{share}, "
            f"{100 * out[label] / walls[label]:.1f}% of its wall time")
    return out


def serving_workload(be, rng, steady=False):
    """examples/serve.py --bench: SERVE["n_req"] requests, one every
    SERVE["arrive"] engine steps, prompts of rng.integers(*plen) tokens,
    n_predict tokens each at temp 0.8, top_k 40, top_p 0.95; the loop body
    is step_chunk(chunk), and a decode-only iteration advances the arrival
    clock by the chunk. steady: the --steady form (examples/serve.py:70-84),
    whose decode tail, once every request has arrived and is past its
    prompt, drains through run_pipelined(chunk). Returns (tokens generated,
    wall s, sorted TTFTs s, request ids, the tail's (s, decode ubatches) or
    None)."""
    vocab = be.cfg.n_vocab
    lo, hi = SERVE["plen"]
    queue = [(SERVE["arrive"] * i, int(rng.integers(lo, hi)),
              SERVE["n_predict"]) for i in range(SERVE["n_req"])]
    t_start = time.perf_counter()
    ttft, t_add, step_no, tail = {}, {}, 0, None

    def note_ttfts():
        for rid, t_a in t_add.items():
            r = be.requests[rid]
            if rid not in ttft and (r.out or r.next_tok is not None):
                ttft[rid] = time.perf_counter() - t_a

    while queue or any(not be.requests[rid].done for rid in t_add):
        live = [r for r in be.requests.values() if not r.done]
        decode_only = live and all(r.n_prompt_done >= len(r.prompt)
                                   for r in live)
        if steady and not queue and decode_only:
            t0, n0 = time.perf_counter(), be.n_ubatches["decode"]
            be.run_pipelined(SERVE["chunk"])
            tail = (time.perf_counter() - t0, be.n_ubatches["decode"] - n0)
            break
        while queue and queue[0][0] <= step_no:
            _, plen, n_pred = queue.pop(0)
            rid = be.add_request(list(rng.integers(0, vocab - 1, plen)), n_pred,
                                 temp=0.8, top_k=40, top_p=0.95, seed=step_no)
            t_add[rid] = time.perf_counter()
        live = [r for r in be.requests.values() if not r.done]
        decode_only = live and all(r.n_prompt_done >= len(r.prompt)
                                   for r in live)
        be.step_chunk(SERVE["chunk"])
        step_no += SERVE["chunk"] if decode_only else 1
        note_ttfts()
    wall = time.perf_counter() - t_start
    gen = sum(len(be.requests[rid].out) for rid in t_add)
    return gen, wall, sorted(ttft.values()), list(t_add), tail


@contextlib.contextmanager
def patched(pairs):
    """Set the (module, name, value) attributes for the block, then restore
    them."""
    old = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, val in pairs:
        setattr(m, n, val)
    try:
        yield
    finally:
        for m, n, val in old:
            setattr(m, n, val)


def without_tiles(plain):
    """A plain version in place of its kernel entry, which the paths call
    with the tile map as `tiles`: the map dropped."""
    return lambda *args, tiles=None: plain(*args)


def plain_on_card():
    """Patches pointing every kernel entry of the GPT-J, GPT-2 117M and
    LLaMA paths (natpair, nat8, the permuted layouts, attention) at its
    plain version, so that the wrappers run the plain
    versions on CUDA tensors (a check of the whole path only; the port
    never does this)."""
    from ggml_imax_tpu_torch.ops import decode_attention as da
    from ggml_imax_tpu_torch.ops import flash_attention as fa
    from ggml_imax_tpu_torch.ops import flash_backward as fb
    from ggml_imax_tpu_torch.ops import qmm
    return [(qmm, "w4a16_gemm", qmm.w4a16_gemm_plain),
            (qmm, "w4a8_gemv", qmm.w4a8_gemv_plain),
            (qmm, "nat8_w8a16_gemm", qmm.nat8_w8a16_gemm_plain),
            (qmm, "nat8_w8a8_gemv", qmm.nat8_w8a8_gemv_plain),
            (qmm, "planes_w4a16", qmm.planes_w4a16_plain),
            (qmm, "rowpair_w4a16", qmm.rowpair_w4a16_plain),
            (qmm, "int8_rows_w8a16", qmm.int8_rows_w8a16_plain),
            (fa, "flash_attention_kernel",
             without_tiles(fa.flash_attention_plain)),
            (fb, "backward_tile_map", fb.backward_tile_map_plain),
            (da, "decode_attention_kernel", da.decode_attention_plain),
            (da, "decode_attention_cells_kernel", da.decode_attention_plain),
            (da, "decode_attention_update_kernel",
             da.decode_attention_update_plain)]


def planted_faults():
    """Two wrong fused KV-update kernels, the route check's controls: the
    fresh row written one row past its destination (so the next step sees
    a row never written), and the fresh row left out of the softmax (the
    row is written, then the read-only kernel runs with it masked)."""
    from ggml_imax_tpu_torch.ops import decode_attention as da
    real = da.decode_attention_update_kernel

    def one_row_off(q3, k, v, ks, vs, kn, vn, kns, vns, mask2, rows, hkv, sc):
        return real(q3, k, v, ks, vs, kn, vn, kns, vns, mask2,
                    (rows + 1) % k.shape[1], hkv, sc)

    def fresh_left_out(q3, k, v, ks, vs, kn, vn, kns, vns, mask2, rows, hkv,
                       sc):
        real(q3, k, v, ks, vs, kn, vn, kns, vns, mask2, rows, hkv, sc)
        own = torch.arange(k.shape[1], device=rows.device)[None] \
            == rows.long()[:, None]
        read = da.decode_attention_cells_kernel if k.shape[0] == 1 \
            else da.decode_attention_kernel
        return read(q3, k, v, ks, vs, torch.where(own, da.NEG, mask2), hkv, sc)

    entry = lambda fn: [(da, "decode_attention_update_kernel", fn)]
    return {"the fresh row one row off": entry(one_row_off),
            "the fresh row left out": entry(fresh_left_out)}


def short_serving(cfg, params, fused, patches=(), model=None, feed=None):
    """A short greedy serving pass at full width (GPT-J-6B by default, or
    `model`; q8_0 arena, n_ctx 2048, host sampling so each ubatch's logits
    are kept): two requests (40 and 23 prompt tokens) in a mixed ubatch of
    bucket 64, then a fork of the first and a third request (70 tokens),
    whose prompt joins the three decode rows in a mixed ubatch of bucket
    128; 8 tokens each. feed: each request's tokens to take in place of its
    own picks (a teacher-forced pass, fed another pass's tokens). Returns
    (tokens, logits per ubatch, launch counts, a copy of the KV arena)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.runtime.batched import BatchedEngine
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, cfg.n_vocab - 1, n)) for n in (40, 23, 70)]
    logs = []
    with patched(patches):
        eng = BatchedEngine(recording(model or gptj, logs), cfg, params,
                            n_ctx=SERVE["n_ctx"], kv_dtype="q8_0",
                            fused_kv_update=fused)
        rids = []
        if feed is not None:
            def fed(r):
                n = next(n for n, i in enumerate(rids)
                         if eng.requests[i] is r)
                return feed[n][len(r.out)]
            eng._sample = fed
        _build.reset_launches()
        rids += [eng.add_request(p, 8, temp=0.0) for p in prompts[:2]]
        eng.step()
        rids += [eng.fork(rids[0]), eng.add_request(prompts[2], 8, temp=0.0)]
        res = eng.run()
        counts = dict(_build.LAUNCHES)
    c = eng.cache
    return [res[r] for r in rids], logs, counts, [
        t.clone() for t in (c.k, c.v, c.ks, c.vs) if t is not None]


def engine_greedy(cfg, params, fused, patches=(), n=8, model=None,
                  n_prompt=8, n_ctx=512, feed=None, device=None):
    """Engine(n_ctx) of `model` (GPT-J by default) on `device` (the card by
    default): an n_prompt-token prompt and n greedy tokens (n - 1 decode
    steps); feed: the tokens to feed the decode steps instead of its own
    picks (a teacher-forced pass). Returns (tokens picked, logits per
    forward, launch counts of the decode steps and the prefill)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.runtime.engine import Engine
    prompt = list(np.random.default_rng(7).integers(0, cfg.n_vocab - 1,
                                                    n_prompt))
    with patched(patches):
        eng = Engine(model or gptj, cfg, params, n_ctx=n_ctx,
                     fused_kv_update=fused, device=device)
        _build.reset_launches()
        lg, cache = eng.prefill(eng.new_cache(), np.asarray([prompt]))
        toks, logs = [int(lg[0].argmax())], [torch.from_numpy(lg)]
        for i in range(n - 1):
            fed = toks[-1] if feed is None else feed[i]
            lg, cache = eng.decode_step(cache, np.asarray([fed]),
                                        len(prompt) + i)
            toks.append(int(lg[0].argmax()))
            logs.append(torch.from_numpy(lg))
        counts = dict(_build.LAUNCHES)
    return toks, logs, counts


def check_forced(label, ref, got, failures, tol, control=False):
    """Hold a teacher-forced pass (fed ref's tokens) to ref: every
    forward's max |logit diff| within tol of ref's largest |logit|, and
    the same pick at every forward except where ref's top-2 margin is
    within twice that forward's diff (a near-tie either pass may break; a
    random-weight model has many). A control (a planted fault) must fail."""
    limit = tol * logit_scale(ref[1])
    diffs = [float((a - b).abs().max()) for a, b in zip(ref[1], got[1])]
    parted = [i for i, (a, b) in enumerate(zip(ref[0], got[0])) if a != b]
    margins = {i: float(ref[1][i][0].topk(2).values.diff().abs()[0])
               for i in parted}
    ties = all(margins[i] <= 2 * diffs[i] for i in parted)
    ok = max(diffs) <= limit and ties
    log(f"  {label}: max |logit diff| per forward "
        f"[{', '.join(f'{d:.3e}' for d in diffs)}] (limit {limit:.3e}, largest "
        f"|logit| {logit_scale(ref[1]):.3f}), picks part at "
        f"{[(i, round(margins[i], 5)) for i in parted]} (forward, top-2 "
        f"margin) -> {'holds' if ok else 'fails'}")
    if ok == control:
        failures.append(f"{label}: the check {'holds' if ok else 'fails'} "
                        f"(max diff {max(diffs):.3e}, limit {limit:.3e}, "
                        f"parted {parted})")


def check_route(label, ref, got, failures, control=False, tol=ROUTE_TOL):
    """Hold one greedy run (tokens, logits, counts) to another at `tol`
    (ROUTE_TOL by default) of ref's largest |logit|; a control run (a
    planted fault) must fail that check."""
    tol = tol * logit_scale(ref[1])
    ok, diffs, note = same_greedy(ref[1], got[1], ref[0], got[0], tol)
    log(f"  {label}: max |logit diff| per forward "
        f"[{', '.join(f'{d:.3e}' for d in diffs)}] (limit {tol:.3e}, largest "
        f"|logit| {logit_scale(ref[1]):.3f}), {note} -> "
        f"{'holds' if ok else 'fails'}")
    if ok == control:
        failures.append(f"{label}: the check {'holds' if ok else 'fails'} "
                        f"({note}, max diff {max(diffs):.3e}, limit {tol:.3e})")


def check_forced_rows(label, ref, got, failures, tol, control=False):
    """check_forced for passes of many rows a forward (serving ubatches; got
    fed ref's tokens): every ubatch's max |logit diff| within tol of ref's
    largest |logit|, and each row's pick equal except where ref's top-2
    margin for that row is within twice that ubatch's diff. A control (a
    planted fault) must fail."""
    limit = tol * logit_scale(ref[1])
    same_shape = [a.shape for a in ref[1]] == [b.shape for b in got[1]]
    diffs = [float((a - b).abs().max()) for a, b in zip(ref[1], got[1])]
    parted = []
    for i, (a, b) in enumerate(zip(ref[1], got[1])):
        for r in (a.argmax(-1) != b.argmax(-1)).nonzero()[:, 0].tolist():
            top2 = a[r].topk(2).values
            parted.append((i, r, round(float(top2[0] - top2[1]), 5)))
    ties = all(m <= 2 * diffs[i] for i, _, m in parted)
    ok = same_shape and max(diffs) <= limit and ties
    log(f"  {label}: max |logit diff| per ubatch "
        f"[{', '.join(f'{d:.3e}' for d in diffs)}] (limit {limit:.3e}, largest "
        f"|logit| {logit_scale(ref[1]):.3f}), picks part at {parted} (ubatch, "
        f"row, top-2 margin) -> {'holds' if ok else 'fails'}")
    if ok == control:
        failures.append(f"{label}: the check {'holds' if ok else 'fails'} "
                        f"(max diff {max(diffs):.3e}, limit {limit:.3e}, "
                        f"parted {parted})")


def attention_recording(model, outs):
    """Patches recording, in call order and on the host, the output of
    every attention route the model's forward calls (flash for a mixed
    ubatch, the cells kernels for a decode-only one), the rows that see a
    key only: a pad row sees none, and the routes treat it differently (the
    fused kernel folds in its own fresh row)."""
    def rec(fn, mask_at):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            o = out[0] if isinstance(out, tuple) else out
            mask = a[mask_at]
            sees = (mask.reshape(-1, mask.shape[-1]).float() > -1e29).any(-1)
            outs.append(o.reshape(sees.shape[0], -1)[sees].float().cpu())
            return out
        return wrapped
    names = {"attention": 3, "decode_attention_cells": 3,
             "decode_attention_update_cells": 6}
    return [(model, n, rec(getattr(model, n), at)) for n, at in names.items()
            if hasattr(model, n)]


def check_attention_calls(label, ref, got, failures, tol, control=False):
    """Two passes' attention outputs, call by call (a layer of a ubatch
    each): every call's max |diff| within tol of the ref call's largest
    |value|. A control must fail."""
    errs = [rel_err(g, r) for r, g in zip(ref, got)]
    ok = len(ref) == len(got) and max(errs) <= tol
    worst = sorted(range(len(errs)), key=lambda i: -errs[i])[:3]
    log(f"  {label}: {len(errs)} calls, largest relative difference "
        f"{max(errs):.3e} (limit {tol:.0e}; worst calls "
        f"{[(i, float(f'{errs[i]:.3e}')) for i in worst]}) -> "
        f"{'holds' if ok else 'fails'}")
    if ok == control:
        failures.append(f"{label}: the check {'holds' if ok else 'fails'} "
                        f"(largest {max(errs):.3e})")


def check_fused_cells(label, ref, ref_attn, got, got_attn, failures,
                      control=False):
    """The fused cells route (got, fed ref's tokens) held to the default
    one (ref): the logits (check_forced_rows), the attention outputs call by
    call (check_attention_calls), both within Q4KM_ROUTE_TOL, and the KV
    arena but its trash cell bit for bit (both routes write the same q8_0
    rows into the same cells). At random weights a pass of LLaMA-2 7B with
    the fresh row written one cell off gave the sound pass's logits and
    attention outputs bit for bit on an H100; the arena is what shows that
    fault. A control (a planted fault) must fail the three taken
    together."""
    found = []
    check_forced_rows(f"{label} (fed)", ref, got, found, Q4KM_ROUTE_TOL)
    check_attention_calls(f"{label}, attention outputs", ref_attn, got_attn,
                          found, Q4KM_ROUTE_TOL)
    # the trash cell (the last) is left out: every pad row writes it, and
    # which write lands last is not defined
    arena_ok = all(torch.equal(a[:, :, :-1], b[:, :, :-1])
                   for a, b in zip(ref[3], got[3]))
    log(f"  {label}: KV arena (the trash cell left out) equal bit for bit "
        f"{arena_ok}")
    ok = arena_ok and not found
    if ok == control:
        failures.append(f"{label}: the check {'holds' if ok else 'fails'} "
                        f"(arena equal {arena_ok}; {found})")


def decode_ubatch_profile(be, rng, cfg, summary, label=""):
    """The device busy share of a decode-only ubatch: 8 streams past their
    64-token prompts, 4 steps timed unprofiled, 4 profiled; W4A16's, nat8
    W8A16's and the cells kernel's share of it. Into summary."""
    for _ in range(SERVE["n_req"]):
        be.add_request(list(rng.integers(0, cfg.n_vocab - 1, 64)), 64, temp=0.8)
    while any(r.n_prompt_done < len(r.prompt) for r in be.requests.values()
              if not r.done):
        be.step()
    t0 = time.perf_counter()
    for _ in range(4):
        be.step()
    step_ms = (time.perf_counter() - t0) / 4 * 1e3
    launches_ub = {}
    dev = _device_ms(lambda _: be.step(), 4, launches_ub)
    if not dev:
        log(f"  {label}profiled decode-only ubatch: no device time (not "
            "measured)")
        return
    busy = sum(dev.values())
    summary.update(decode_ubatch_ms=step_ms, decode_ubatch_busy_ms=busy)
    log(f"  {label}profiled decode-only ubatch (nb 8): device busy {busy:.3f} "
        f"ms of {step_ms:.3f} ms unprofiled -> busy {100 * busy / step_ms:.1f}%, "
        f"idle {100 * (1 - busy / step_ms):.1f}%")
    for key, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {ms:9.4f} ms  {key[:90]}")
    what = f"{label}profiled decode-only ubatch"
    summary["decode_ubatch_w4a16_ms"] = kernel_share(
        dev, busy, what, launches=launches_ub)
    summary["decode_ubatch_w8a16_ms"] = kernel_share(
        dev, busy, what, "nat8 W8A16 (nat8_gemm.cu)", launches_ub)
    summary["decode_ubatch_cells_ms"] = kernel_share(
        dev, busy, what, "cells decode attention (decode_attention_cells.cu)",
        launches_ub)
    tail = summary["steady"].get("tail_ms_per_ubatch")
    if tail:
        log(f"  {label}the run_pipelined tail: {tail:.3f} ms a decode-only "
            f"ubatch -> busy {100 * busy / tail:.1f}% (the eager ubatch's "
            "profiled device time over the tail's wall time a ubatch)")


def timed_serving(be, rng, L, launches, failures, steady=False,
                  products=None, key="serving"):
    """One timed serving_workload (the --steady form with steady) with the
    launch counters set to 0 just before and read just after, held to the
    exact counts of its ubatches (L attention launches a ubatch; products:
    each A16 kernel's launches a ubatch, GPT-J's 2 L + 1 W4A16 by default);
    into launches[key] (or [key + "_steady"]). Returns its summary."""
    from ggml_imax_tpu_torch import _build
    be.requests.clear()
    be.n_ubatches = {"mixed": 0, "decode": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    gen, wall, ttfts, rids, tail = serving_workload(be, rng, steady)
    counts = dict(_build.LAUNCHES)
    nu = dict(be.n_ubatches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    outs = [be.requests[r].out for r in rids]
    label = "steady serving" if steady else "serving"
    if sorted(map(len, outs)) != [SERVE["n_predict"]] * SERVE["n_req"] or \
            not all(0 <= t < be.cfg.n_vocab for o in outs for t in o):
        failures.append(f"{label}: request lengths {list(map(len, outs))}")
    summary = {"tok_s": gen / wall, "generated": gen, "wall_s": wall,
               "p50_ttft_ms": 1e3 * ttfts[len(ttfts) // 2],
               "ttft_ms": [1e3 * t for t in ttfts], "ubatches": nu,
               "max_memory_allocated_gib": peak}
    log(f"  {label}: {SERVE['n_req']} requests, {gen} tokens in {wall:.3f} s "
        f"= {gen / wall:.2f} tok/s aggregate, p50 TTFT "
        f"{summary['p50_ttft_ms']:.2f} ms (TTFTs "
        f"{', '.join(f'{1e3 * t:.1f}' for t in ttfts)} ms)")
    if tail is not None:
        summary.update(tail_s=tail[0], tail_decode_ubatches=tail[1],
                       tail_ms_per_ubatch=1e3 * tail[0] / max(1, tail[1]))
        log(f"  {label}: the run_pipelined({SERVE['chunk']}) tail {tail[0]:.3f}"
            f" s for {tail[1]} decode-only ubatches = "
            f"{summary['tail_ms_per_ubatch']:.3f} ms a ubatch")
    log(f"  ubatches: {nu['mixed']} mixed, {nu['decode']} decode-only; "
        f"max_memory_allocated {peak:.3f} GiB")
    log(f"  launches: {counts}")
    n_all = nu["mixed"] + nu["decode"]
    products = products or {"w4a16_gemm": 2 * L + 1}
    check_counts(counts, {"decode_attention_cells": L * nu["decode"],
                          "flash_attention": L * nu["mixed"],
                          "flash_backward_tiles": L * nu["mixed"],
                          **{k: n * n_all for k, n in products.items()}},
                 failures)
    launches[key + "_steady" if steady else key] = counts
    return summary


def pipelined_greedy(cfg, params, pipelined):
    """A greedy serving pass at GPT-J-6B width (q8_0 arena, n_ctx 2048,
    on-device sampling): three requests of 40, 23 and 70 prompt tokens, 24
    tokens each, through the step() loop or run_pipelined(SERVE["chunk"]).
    Returns (tokens, every cell freed)."""
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.runtime.batched import BatchedEngine
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, cfg.n_vocab - 1, n)) for n in (40, 23, 70)]
    be = BatchedEngine(gptj, cfg, params, n_ctx=SERVE["n_ctx"],
                       kv_dtype="q8_0", on_device_sampling=True, seed=1)
    rids = [be.add_request(p, 24, temp=0.0) for p in prompts]
    res = be.run_pipelined(SERVE["chunk"]) if pipelined else be.run()
    return [res[r] for r in rids], bool((be.cell_pos[:-1] == -1).all())


def serve_gptj(failures):
    """Phase 6. Returns (serving summary, launch counts by path)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.runtime.batched import BatchedEngine
    from ggml_imax_tpu_torch.runtime.engine import Engine

    cfg = gptj.GPTJConfig(**dict(GPTJ_6B, n_ctx=SERVE["n_ctx"]))
    L = cfg.n_layer
    t0 = time.time()
    params = params_repack(gptj.prepare_fused(
        gptj.synthetic_params_device(cfg, seed=0), cfg))
    torch.cuda.synchronize()
    log(f"  weights drawn + prepared in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    be = BatchedEngine(gptj, cfg, params, n_ctx=SERVE["n_ctx"],
                       kv_dtype="q8_0", on_device_sampling=True, seed=1)
    arena = sum(t.numel() * t.element_size()
                for t in (be.cache.k, be.cache.v, be.cache.ks, be.cache.vs))
    log(f"  q8_0 KV arena {arena / 2**30:.3f} GiB")
    rng = np.random.default_rng(0)
    t0 = time.time()
    serving_workload(be, rng)                        # warm-up
    log(f"  warm-up pass {time.time() - t0:.1f} s ({len(be._chunks)} chunks "
        f"captured in {sum(r.capture_s for _, r in be._chunks.values()):.2f} "
        "s with their eager first runs)")
    launches = {}
    summary = timed_serving(be, rng, L, launches, failures)
    summary["steady"] = timed_serving(be, rng, L, launches, failures,
                                      steady=True)
    pool = pool_bytes(be.graph_pool)
    summary["graph_pool_bytes"] = pool
    log("  serving graph pool " + ("not measured" if pool is None
                                   else f"{pool / 2**20:.1f} MiB"))

    # device busy share of a decode-only ubatch: 8 streams past their prompts
    decode_ubatch_profile(be, rng, cfg, summary)

    del be
    # the route checks at GPT-J-6B depth (see ROUTE_TOL): the default
    # serving route with kernels against the same with the plain versions on
    # the card, and the fused routes (cells and flat mode) against the
    # default ones; then each planted fault, which must fail the check
    ref_s = short_serving(cfg, params, False)
    check_route("serving, kernels vs plain versions on the card", ref_s,
                short_serving(cfg, params, False, plain_on_card()), failures)
    fused_s = short_serving(cfg, params, True)
    launches["serving_fused"] = fused_s[2]
    check_route("serving, fused route (cells mode) vs default", ref_s,
                fused_s, failures)
    if fused_s[2]["decode_attention_update"] == 0:
        failures.append("fused serving pass: no fused KV-update launch")
    ref_e = engine_greedy(cfg, params, False)
    fused_e = engine_greedy(cfg, params, True)
    launches["engine_fused"] = fused_e[2]
    check_route("Engine, fused route (flat mode) vs default", ref_e, fused_e,
                failures)
    check_counts(launches["engine_fused"],
                 {"decode_attention_update": L * 7, "w4a8_gemv": 7 * (2 * L + 1),
                  "w4a16_gemm": 2 * L + 1, "flash_attention": L,
                  "flash_backward_tiles": L}, failures)
    # run_pipelined against the step() loop, greedy; and the fused flat
    # route inside a graph: Engine.generate(chunk=CHUNK) twice (the second
    # run replays its span) against the fused decode steps' tokens
    want, _ = pipelined_greedy(cfg, params, False)
    got, freed = pipelined_greedy(cfg, params, True)
    log(f"  run_pipelined({SERVE['chunk']}) vs the step() loop, greedy: tokens "
        f"equal {got == want}, every cell freed {freed}")
    if got != want or not freed:
        failures.append(f"run_pipelined: tokens {got} vs {want}, freed {freed}")
    eng = Engine(gptj, cfg, params, n_ctx=512, fused_kv_update=True)
    prompt = list(np.random.default_rng(7).integers(0, cfg.n_vocab - 1, 8))
    eng.generate(prompt, 8, temp=0, chunk=CHUNK)   # the span's capture
    _build.reset_launches()
    toks = eng.generate(prompt, 8, temp=0, chunk=CHUNK)
    counts = dict(_build.LAUNCHES)
    log(f"  Engine fused, generate(chunk={CHUNK}) replayed: tokens equal the "
        f"fused decode steps' {toks == fused_e[0]}; launches {counts}")
    if toks != fused_e[0]:
        failures.append(f"fused chunked Engine: {toks} vs {fused_e[0]}")
    check_counts(counts, dict(launches["engine_fused"]), failures)
    launches["engine_fused_chunked"] = counts
    del eng
    for fault, patches in planted_faults().items():
        check_route(f"control: serving, fused route with {fault}", ref_s,
                    short_serving(cfg, params, True, patches), failures,
                    control=True)
        check_route(f"control: Engine, fused route with {fault}", ref_e,
                    engine_greedy(cfg, params, True, patches), failures,
                    control=True)
    return summary, launches


def train_loss(cfg, toks, tgts):
    """tools/quality_gate.py's training loss: a fresh f32 KV cache per call,
    gpt2.forward with compute_dtype f32, the mean NLL of log_softmax."""
    from ggml_imax_tpu_torch.models import gpt2
    B, T = toks.shape
    pos = torch.arange(T, device="cuda")[None].expand(B, T)

    def loss(p):
        cache = gpt2.init_cache(cfg, batch=B, n_ctx=T, dtype=torch.float32)
        logits, _ = gpt2.forward(cfg, p, toks, pos, cache, 0,
                                 compute_dtype=torch.float32)
        lp = torch.log_softmax(logits, dim=-1)
        return -lp.gather(-1, tgts[..., None]).mean()
    return loss


def loss_and_grads(loss_fn, params, patches=()):
    from ggml_imax_tpu_torch.optimize import float_leaves
    with patched(patches):
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, float_leaves(params))
    return float(loss.detach()), grads


def check_train_route(label, ref, got, failures, control=False):
    """Hold one training step's loss and gradients to another's: the loss
    within 1e-3 relative, each leaf's max |dg| within TRAIN_TOL of that
    leaf's largest |g| in ref. A control (a planted fault) must fail."""
    worst, at = 0.0, None
    for i, (a, b) in enumerate(zip(ref[1], got[1])):
        r = rel_err(b, a)
        if r > worst:
            worst, at = r, (i, tuple(a.shape))
    dl = abs(got[0] - ref[0]) / abs(ref[0])
    ok = dl <= 1e-3 and worst <= TRAIN_TOL
    log(f"  {label}: loss {got[0]:.6f} vs {ref[0]:.6f} (rel {dl:.2e}, tol "
        f"1e-03); worst leaf max|dg|/max|g| {worst:.3e} at leaf {at} (limit "
        f"{TRAIN_TOL:.0e}) -> {'holds' if ok else 'fails'}")
    if ok == control:
        failures.append(f"{label}: the check {'holds' if ok else 'fails'} "
                        f"(loss rel {dl:.2e}, worst leaf {worst:.3e})")


def train_gpt2(failures):
    """Phase 7. Returns (training summary, launch counts)."""
    from torch.profiler import ProfilerActivity, profile

    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch import optimize as opt
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.ops import flash_attention as fa
    from ggml_imax_tpu_torch.ops import flash_backward as fb
    from ggml_imax_tpu_torch.quant.formats import GGMLType

    cfg = gpt2.GPT2Config(**GPT2_117M)
    B, T, L = TRAIN["batch"], TRAIN["seq"], cfg.n_layer
    t0 = time.time()
    params = gpt2.synthetic_params(cfg, GGMLType.F32, seed=0)
    n_params = sum(t.numel() for t in opt.float_leaves(params))
    rng = np.random.default_rng(0)
    toks, tgts = (torch.as_tensor(rng.integers(0, cfg.n_vocab, (B, T)),
                                  device="cuda") for _ in range(2))
    loss_fn = train_loss(cfg, toks, tgts)
    torch.cuda.synchronize()
    log(f"  {n_params / 1e6:.1f} M f32 params drawn in "
        f"{time.time() - t0:.1f} s")
    po = opt.default_params("adam")
    po.adam = opt.AdamParams(n_iter=TRAIN["warmup"], alpha=TRAIN["alpha"],
                             eps_f=0.0, eps_g=0.0)
    t0 = time.time()
    _, params, ctx = opt.opt(loss_fn, params, po)         # warm-up steps
    log(f"  {TRAIN['warmup']} warm-up steps in {time.time() - t0:.1f} s")
    ctx.params.adam.n_iter = TRAIN["steps"]
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res, params = opt.opt_resume(ctx, loss_fn, params,
                                 callback=lambda it, f: losses.append(f))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    step_ms = wall / TRAIN["steps"] * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    summary = {"step_ms": step_ms,
               "train_tok_s": TRAIN["steps"] * B * T / wall,
               "loss_first": losses[0], "loss_last": losses[-1],
               "steps": len(losses), "max_memory_allocated_gib": peak}
    log(f"  {len(losses)} timed steps ({res.name}): {step_ms:.2f} ms/step, "
        f"{summary['train_tok_s']:.0f} train tok/s, loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}, max_memory_allocated {peak:.3f} GiB")
    log(f"  launches over {TRAIN['steps']} steps: {counts}")
    n = TRAIN["steps"] * L
    check_counts(counts, {"flash_attention": n, "flash_backward_dq": n,
                          "flash_backward_dkv": n,
                          "flash_backward_tiles": n}, failures)
    if not (len(losses) == TRAIN["steps"] and losses[-1] < losses[0]
            and all(math.isfinite(f) for f in losses)):
        failures.append(f"training losses {losses}")

    # one profiled step: device busy share, the flash kernels' share, the
    # KV arena's CopySlices backward (the in-place writes' gradient copies)
    ctx.params.adam.n_iter = 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.opt_resume(ctx, loss_fn, params)
    evs = prof.key_averages()
    dev = {ev.key: ev.self_device_time_total / 1e3 for ev in evs
           if str(ev.device_type).endswith("CUDA")
           and ev.self_device_time_total > 0}
    if dev:
        busy = sum(dev.values())
        flash = sum(ms for k, ms in dev.items() if "flash" in k)
        copies = [(ev.count, getattr(ev, "device_time_total", 0) / 1e3)
                  for ev in evs if ev.key.endswith("CopySlices")]
        n_copy, copy_ms = max(copies, key=lambda c: c[1], default=(0, 0.0))
        summary.update(step_busy_ms=busy, flash_ms=flash,
                       copyslices_ms=copy_ms)
        log(f"  profiled step: device busy {busy:.3f} ms of {step_ms:.3f} ms "
            f"unprofiled -> busy {100 * busy / step_ms:.1f}%, idle "
            f"{100 * (1 - busy / step_ms):.1f}%; flash kernels {flash:.3f} ms "
            f"({100 * flash / busy:.1f}% of busy); CopySlices backward "
            f"{copy_ms:.3f} ms over {n_copy} nodes "
            f"({100 * copy_ms / busy:.1f}%)")
        for key, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:10]:
            log(f"    {ms:9.4f} ms  {key[:90]}")
        # the backward's kernels in the step, per launch (no timer floor)
        for ev in evs:
            name = re.search(r"flash_bwd_\w+", ev.key)
            if name and ev.self_device_time_total > 0:
                each = ev.self_device_time_total / 1e3 / ev.count
                summary[name.group() + "_ms"] = each
                log(f"    {name.group()}: {ev.count} launches, {each:.4f} ms "
                    f"each")
    else:
        log("  profiled step: no device time in the trace (not measured)")

    # the gradient route check at full width (see TRAIN_TOL), then a planted
    # fault that it must catch: dK returned without its softmax scale
    plain = [(fa, "flash_attention_kernel",
              without_tiles(fa.flash_attention_plain)),
             (fb, "backward_tile_map", fb.backward_tile_map_plain),
             (fb, "flash_attention_bwd_kernel",
              without_tiles(fb.flash_attention_bwd_plain))]
    real_dkv = fb.flash_backward_dkv

    def dk_unscaled(*args):
        dk, dv = real_dkv(*args)
        return dk / args[8], dv
    ref = loss_and_grads(loss_fn, params, plain)
    check_train_route("training step, kernels vs plain versions on the card",
                      ref, loss_and_grads(loss_fn, params), failures)
    fault = [(fb, "flash_backward_dkv", dk_unscaled)]
    check_train_route("control: dK without its scale", ref,
                      loss_and_grads(loss_fn, params, fault), failures,
                      control=True)
    return summary, counts


def swapped_planes():
    """The K-quant route check's control: the plane-split kernel with the
    low and high planes' scale (and bias) rows swapped, a fault that still
    gives plausible numbers."""
    from dataclasses import replace

    from ggml_imax_tpu_torch.ops import qmm
    real = qmm.planes_w4a16

    def swap(t):
        return None if t is None else \
            t.reshape(-1, 2, t.shape[1]).flip(1).reshape(t.shape).contiguous()

    def fault(x2, qt):
        return real(x2, replace(qt, scale=swap(qt.scale), bias=swap(qt.bias)))
    return [(qmm, "planes_w4a16", fault)]


def kquant_gpt2(failures, pool):
    """Phase 8. GPT-2 117M at full width and a sixth of its depth
    (GPT2_117M_HOST) in
    Q3_K (N_REQUESTS requests), Q2_K,
    row-pair Q4_0 and u-order Q8_0 (one request each): weights drawn on the
    host (the reference's numpy stream and codecs, quantized in `pool`'s
    processes by host_params, a weight held to the serial codec's bytes),
    repacked, served by
    Engine(n_ctx=1024) with exact launch counts; the Q3_K run profiled;
    then each run's route check, kernels against plain versions on the
    card, and the planted fault on Q3_K. Returns (summary, launch counts),
    both by run."""
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    cfg = gpt2.GPT2Config(**GPT2_117M_HOST)
    L = cfg.n_layer
    products = N_PREDICT * 4 * L          # 64 forwards x 4 L layer products
    runs = [("q3_k", "Q3_K", GGMLType.Q3_K, None, N_REQUESTS),
            ("q2_k", "Q2_K", GGMLType.Q2_K, None, 1),
            ("rowpair_q4_0", "row-pair Q4_0", GGMLType.Q4_0, "rowpair", 1),
            ("int8_rows_q8_0", "u-order Q8_0", GGMLType.Q8_0, "int8", 1)]
    kernel_of = {None: "planes_w4a16", "rowpair": "rowpair_w4a16",
                 "int8": "int8_rows_w8a16"}
    summary, launches = {}, {}
    for key, label, wtype, layout, n_req in runs:
        log(f"  -- {label}")
        t0 = time.time()
        raw, quant_s, same = host_params(cfg, wtype, pool)
        if not same:
            failures.append(f"{label}: host_params' proj_w differs from "
                            "quantize_for_device's")
        params = params_repack(raw) if layout is None else \
            legacy_repack(raw, layout)
        del raw
        torch.cuda.synchronize()
        log(f"  weights drawn and quantized on the host in {quant_s:.1f} s "
            f"({HOST_WORKERS} processes; proj_w equal to quantize_for_"
            f"device's {same}), repacked, {time.time() - t0:.1f} s in all, "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
        eng, rng, reqs, counts, _ = serve(gpt2, cfg, params, cfg.n_ctx,
                                          failures, n_requests=n_req)
        check_counts(counts, {kernel_of[layout]: n_req * products,
                              "flash_attention": n_req * L,
                              "flash_backward_tiles": n_req * L}, failures)
        launches[f"gpt2_117m_{key}"] = counts
        entry = {"ttft_ms": [r["ttft_ms"] for r in reqs],
                 "decode_tok_s": [r["decode_tok_s"] for r in reqs],
                 "max_memory_allocated_gib":
                     torch.cuda.max_memory_allocated() / 2**30}
        if key == "q3_k":
            busy, walls = profile_engine(eng, rng, reqs)
            entry.update(busy_ms=busy, wall_ms=walls,
                         gated_head_ms=gated_products_ms([params["wte"]],
                                                         busy, walls))
        summary[key] = entry
        del eng
        greedy = lambda patches=(), feed=None: engine_greedy(
            cfg, params, False, patches, model=gpt2, n_prompt=PROMPT,
            n_ctx=cfg.n_ctx, feed=feed)
        ref = greedy()
        check_forced(f"GPT-2 117M {label}, kernels vs plain versions on the "
                     "card", ref, greedy(plain_on_card(), ref[0]), failures,
                     KQ_ROUTE_TOL)
        if key == "q3_k":
            check_forced("control: GPT-2 117M Q3_K, plane-split kernel with "
                         "its low/high scale rows swapped", ref,
                         greedy(swapped_planes(), ref[0]), failures,
                         KQ_ROUTE_TOL, control=True)
        del params
        torch.cuda.empty_cache()
    return summary, launches


def dropped_bias():
    """Phase 9's route-check control: the W4A8 kernel with the bias term
    (xs * bias, Q4_K's min and the natpair 8 * scale) dropped."""
    from dataclasses import replace

    from ggml_imax_tpu_torch.ops import qmm
    real = qmm.w4a8_gemv

    def fault(x8, dx, qt, xs=None):
        return real(x8, dx, replace(qt, bias=None))
    return [(qmm, "w4a8_gemv", fault)]


def llama_7b(failures):
    """Phase 9. LLaMA-2 7B Q4_K at full width and depth: weights drawn on
    the card, prepare_fused (F 11008 -> 11264), params_repack with bf16
    scales and bias, Engine(n_ctx=512) serving the requests of phase 4
    with exact launch counts, profiled; the same requests through
    generate(chunk=8), tokens and KV arena bit-equal request by request;
    then a teacher-forced pass with the kernels held to the same pass with
    every plain version on the card (LLAMA_ROUTE_TOL), and the W4A8 kernel
    without its bias term, which must fail that check. Returns (summary,
    launch counts by run)."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    cfg = llama.LlamaConfig(**LLAMA2_7B)
    log(f"  allocated before the draw "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    t0 = time.time()
    params = llama.synthetic_params_device(cfg, seed=0)
    params = params_repack(llama.prepare_fused(params, cfg),
                           scale_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  weights drawn + prepared in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated "
        f"(gu_w {params['layers'][0]['gu_w'].n} columns, down_w K "
        f"{params['layers'][0]['down_w'].k})")
    eng, rng, reqs, counts, runs = serve(llama, cfg, params, cfg.n_ctx,
                                         failures)
    L = cfg.n_layer
    n_dec, n_pre = N_REQUESTS * (N_PREDICT - 1), N_REQUESTS
    expect = {"w4a8_gemv": n_dec * (4 * L + 1), "decode_attention": n_dec * L,
              "w4a16_gemm": n_pre * (4 * L + 1), "flash_attention": n_pre * L,
              "flash_backward_tiles": n_pre * L}
    check_counts(counts, expect, failures)
    if failures:
        return None, None
    busy_ms, walls = profile_engine(eng, rng, reqs)
    creqs, ccounts, summary = serve_chunked(eng, runs, failures)
    check_counts(ccounts, expect, failures)
    med = lambda rs: float(np.median([r["decode_tok_s"] for r in rs]))
    span_ms, span_busy, how = profile_span(eng, busy_ms.get("decode step"))
    log(f"  chunk {CHUNK}: {med(creqs):.2f} tok/s = {1e3 / med(creqs):.3f} ms "
        f"a token (median), {med(creqs) / med(reqs):.2f}x chunk 1's "
        f"{med(reqs):.2f} tok/s")
    summary.update(requests=creqs, tok_s=med(creqs), chunk1_requests=reqs,
                   chunk1_tok_s=med(reqs), busy_ms=busy_ms, wall_ms=walls,
                   span_ms=span_ms, span_busy_ms=span_busy,
                   span_busy_method=how,
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated()
                   / 2**30)
    del eng
    greedy = lambda patches=(), feed=None: engine_greedy(
        cfg, params, False, patches, n=9, model=llama, n_prompt=64,
        n_ctx=cfg.n_ctx, feed=feed)
    ref = greedy()
    check_forced("LLaMA-2 7B Q4_K, kernels vs plain versions on the card",
                 ref, greedy(plain_on_card(), ref[0]), failures,
                 LLAMA_ROUTE_TOL)
    check_forced("control: LLaMA-2 7B Q4_K, W4A8 without its bias term", ref,
                 greedy(dropped_bias(), ref[0]), failures, LLAMA_ROUTE_TOL,
                 control=True)
    del params
    torch.cuda.empty_cache()
    return summary, {"llama": counts, "llama_chunked": ccounts}


def gpt2_xl_q5k(failures):
    """Phase 5b. GPT-2 1558M Q5_K at full width and depth: the reference
    benchmark's structural Q5_K draw on the card, params_repack (f32
    scales and bias), Engine(n_ctx=1024) serving one request of phase 4's
    shape with exact launch counts (48 nat8 W8A8 a decode step and 48 W8A16
    a prefill, fc_w only: the N % 128 gate leaves attn_w, proj_w, out_w and
    the head to dequantize + matmul), profiled; the same request through
    generate(chunk=8), tokens and KV arena bit-equal. Returns (summary,
    launch counts by run)."""
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    cfg = gpt2.GPT2Config(**GPT2_XL)
    t0 = time.time()
    params = params_repack(gpt2.prepare_fused(gpt2.synthetic_params_device(
        cfg, seed=0, wtype=GGMLType.Q5_K), cfg))
    torch.cuda.synchronize()
    fc = params["layers"][0]["fc_w"]
    log(f"  weights drawn + prepared in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated (fc_w "
        f"{fc.ggml_type.name} nat8 g{fc.k // fc.scale.shape[0]}, "
        f"{str(fc.scale.dtype)[6:]} scale and bias)")
    eng, rng, reqs, counts, runs = serve(gpt2, cfg, params, cfg.n_ctx,
                                         failures, n_requests=1)
    L = cfg.n_layer
    expect = {"nat8_w8a8": (N_PREDICT - 1) * L, "nat8_w8a16": L,
              "flash_attention": L, "flash_backward_tiles": L}
    check_counts(counts, expect, failures)
    if failures:
        return None, None
    busy_ms, walls = profile_engine(eng, rng, reqs)
    creqs, ccounts, summary = serve_chunked(eng, runs, failures, n=1)
    check_counts(ccounts, expect, failures)
    tok_s = creqs[0]["decode_tok_s"]
    log(f"  chunk {CHUNK}: {tok_s:.2f} tok/s = {1e3 / tok_s:.3f} ms a token, "
        f"{tok_s / reqs[0]['decode_tok_s']:.2f}x chunk 1's "
        f"{reqs[0]['decode_tok_s']:.2f} tok/s")
    summary.update(requests=creqs, chunk1_requests=reqs, busy_ms=busy_ms,
                   wall_ms=walls, max_memory_allocated_gib=
                   torch.cuda.max_memory_allocated() / 2**30)
    del eng, params, runs
    torch.cuda.empty_cache()
    return summary, {"gpt2_q5_k": counts, "gpt2_q5_k_chunked": ccounts}


def dropped_nat8_bias():
    """Phase 8b's route-check control: the nat8 W8A8 GEMV with its bias term
    (xs * bias: Q5_K's -min, Q5_1's m) dropped."""
    from dataclasses import replace

    from ggml_imax_tpu_torch.ops import qmm
    real = qmm.nat8_w8a8_gemv

    def fault(x8, dx, qt, xs=None):
        return real(x8, dx, replace(qt, bias=None))
    return [(qmm, "nat8_w8a8_gemv", fault)]


# phase 8b: GPT-2 117M in each format quantized on the host, and the
# kernels its repacked weights take (natpair: Q4_0 at zero 8, Q4_1 with a
# bias; nat8: Q5_0 g 32, Q5_1 and Q5_K g 32 with a bias, Q6_K g 16)
FORMATS_117M = (("Q4_0", "w4a8_gemv", "w4a16_gemm"),
                ("Q4_1", "w4a8_gemv", "w4a16_gemm"),
                ("Q5_0", "nat8_w8a8", "nat8_w8a16"),
                ("Q5_1", "nat8_w8a8", "nat8_w8a16"),
                ("Q5_K", "nat8_w8a8", "nat8_w8a16"),
                ("Q6_K", "nat8_w8a8", "nat8_w8a16"))


def _quantize_piece(job):
    """A worker process's share of host_params: columns of one (K, N)
    weight through the port's codec -> their ggml bytes."""
    from ggml_imax_tpu_torch.quant import codecs
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    cols, wtype = job
    return codecs.quantize(np.ascontiguousarray(cols.T), GGMLType(wtype))


def host_pool():
    """The worker processes host_params quantizes in (HOST_WORKERS, spawned
    once for phases 8 and 8b)."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        HOST_WORKERS, mp_context=multiprocessing.get_context("spawn"))


def host_params(cfg, wtype, pool, seed=0, scale=0.02, piece=1 << 20):
    """gpt2.synthetic_params(cfg, wtype, seed) on the card, its host
    quantization spread over `pool`: the weights drawn in the package's
    order (gpt2._param_tree, the same numpy stream), cut into pieces of
    about `piece` elements along N (a codec's blocks run along K, so the
    pieces' bytes, in order, are the whole weight's), each quantized by the
    port's codec in a worker, laid out by to_device_format as
    quantize_for_device lays it out. Returns (params, seconds, whether the
    first layer's proj_w equals quantize_for_device's, the serial codec's,
    on the same draw)."""
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.quant.device import (quantize_for_device,
                                                  to_device_format)
    t0 = time.time()
    rng = np.random.default_rng(seed)
    ws = []

    def q(shape_kn):
        ws.append((rng.standard_normal(shape_kn) * scale).astype(np.float32))
        return len(ws) - 1

    def vec(n):
        return torch.from_numpy((rng.standard_normal(n) * scale)
                                .astype(np.float32)).to(device="cuda")

    tree = gpt2._param_tree(cfg, q, vec)
    jobs = [(i, lo, lo + max(1, piece // w.shape[0]))
            for i, w in enumerate(ws)
            for lo in range(0, w.shape[1], max(1, piece // w.shape[0]))]
    raws = pool.map(_quantize_piece, [(ws[i][:, lo:hi], int(wtype))
                                      for i, lo, hi in jobs])
    parts = [[] for _ in ws]
    for (i, _, _), raw in zip(jobs, raws):
        parts[i].append(raw)
    qts = [to_device_format(np.concatenate(pp), wtype, w.shape)
           for pp, w in zip(parts, ws)]
    seconds = time.time() - t0
    k = tree["layers"][0]["proj_w"]
    one = quantize_for_device(ws[k], wtype)
    same = all((getattr(one, a) is None and getattr(qts[k], a) is None)
               or torch.equal(getattr(one, a), getattr(qts[k], a))
               for a in ("q", "scale", "bias"))

    def walk(d):
        if isinstance(d, dict):
            return {k: walk(v) for k, v in d.items()}
        if isinstance(d, list):
            return [walk(v) for v in d]
        return qts[d] if isinstance(d, int) else d
    return walk(tree), seconds, same


def formats_gpt2(failures, pool):
    """Phase 8b. GPT-2 117M at full width and a sixth of its depth in Q4_0 (the
    default
    natpair
    route), Q4_1, Q5_0, Q5_1, Q5_K and Q6_K: weights drawn on the host (the
    reference's numpy stream) and quantized by the port's codecs in
    HOST_WORKERS processes (host_params; a weight held to
    quantize_for_device's bytes), params_repack, Engine(n_ctx=1024) serving one request of phase 4's
    shape with exact launch counts (every layer product, 4 L a forward, on
    a kernel; the tied head gated); then a short greedy pass of each with
    the kernels held to the same pass with every plain version on the card
    (KQ_ROUTE_TOL), and the nat8 W8A8 GEMV without its bias term on Q5_K,
    which must fail that check. Returns (summary, launch counts by run)."""
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    cfg = gpt2.GPT2Config(**GPT2_117M_HOST)
    L = cfg.n_layer
    summary, launches = {}, {}
    for fmt, gemv, gemm in FORMATS_117M:
        log(f"  -- {fmt}")
        raw, quant_s, same = host_params(cfg, GGMLType[fmt], pool)
        if not same:
            failures.append(f"{fmt}: host_params' proj_w differs from "
                            "quantize_for_device's")
        params = params_repack(raw)
        del raw
        torch.cuda.synchronize()
        fc = params["layers"][0]["fc_w"]
        log(f"  weights drawn and quantized on the host in {quant_s:.1f} s "
            f"({HOST_WORKERS} processes; proj_w equal to quantize_for_device"
            f"'s {same}), "
            f"repacked ({fc.kind} q4_layout {fc.q4_layout}, g"
            f"{fc.k // fc.scale.shape[0]}, bias {fc.bias is not None}), "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
        eng, rng, reqs, counts, _ = serve(gpt2, cfg, params, cfg.n_ctx,
                                          failures, n_requests=1)
        check_counts(counts, {gemv: (N_PREDICT - 1) * 4 * L, gemm: 4 * L,
                              "flash_attention": L,
                              "flash_backward_tiles": L}, failures)
        launches[f"gpt2_117m_{fmt.lower()}"] = counts
        summary[fmt] = {"host_quantize_s": quant_s,
                        "ttft_ms": reqs[0]["ttft_ms"],
                        "decode_tok_s": reqs[0]["decode_tok_s"]}
        del eng
        greedy = lambda patches=(), feed=None: engine_greedy(
            cfg, params, False, patches, model=gpt2, n_prompt=PROMPT,
            n_ctx=cfg.n_ctx, feed=feed)
        ref = greedy()
        check_forced(f"GPT-2 117M {fmt}, kernels vs plain versions on the "
                     "card", ref, greedy(plain_on_card(), ref[0]), failures,
                     KQ_ROUTE_TOL)
        if fmt == "Q5_K":
            check_forced("control: GPT-2 117M Q5_K, nat8 W8A8 without its "
                         "bias term", ref, greedy(dropped_nat8_bias(), ref[0]),
                         failures, KQ_ROUTE_TOL, control=True)
        del params
        torch.cuda.empty_cache()
    return summary, launches


def use_more_bits(layer: int, n_layer: int) -> bool:
    """llama.cpp's use_more_bits (llama_tensor_get_type, mid-2024)."""
    return (layer < n_layer // 8 or layer >= 7 * n_layer // 8
            or (layer - n_layer // 8) % 3 == 2)


def q4_k_m(n_layer: int):
    """The Q4_K_M mix as models/llama.synthetic_params_device's `types`:
    `output` Q6_K, attn_v and ffn_down Q6_K where use_more_bits (16 of 32
    layers), every other weight Q4_K."""
    from ggml_imax_tpu_torch.quant.formats import GGMLType

    def types(name, layer):
        if name == "output" or (name in ("v_w", "down_w")
                                and use_more_bits(layer, n_layer)):
            return GGMLType.Q6_K
        return GGMLType.Q4_K
    return types


def q6k_fed_g32():
    """Phase 9b's route-check control: the Q6_K W8A8 GEMV run at g 32 in
    place of g 16 (activations quantized per 32, every other per-16 scale
    row), a fault that still gives plausible numbers."""
    from dataclasses import replace

    from ggml_imax_tpu_torch.ops import qmm
    real = qmm.nat8_w8a8_gemv

    def fault(x8, dx, qt, xs=None):
        if qmm.nat8_group(qt) != 16:
            return real(x8, dx, qt, xs)
        x8b, dxb = qmm.quantize_activations_q8(
            (x8.float() * dx[:, None]).reshape(1, -1), 32)
        return real(x8b[:, 0].contiguous(), dxb[:, 0].contiguous(),
                    replace(qt, scale=qt.scale[0::2].contiguous()), None)
    return [(qmm, "nat8_w8a8_gemv", fault)]


def a16_in_f64():
    """The W4A16 and nat8 W8A16 entries as their plain version with the
    sums taken in f64 and rounded to f32 once: the same function summed in
    another order, to show how far the order alone moves a path's
    logits."""
    from ggml_imax_tpu_torch.ops import qmm

    def f64(x2, qt):
        xb = x2.to(torch.bfloat16).double()
        out = xb @ qmm.dequant_bf16(qt).double()
        if qt.bias is not None:
            nb = qt.bias.shape[0]
            xs = xb.reshape(x2.shape[0], nb, qt.k // nb).sum(-1)
            out = out + xs @ qt.bias.double()
        return out.float()
    return [(qmm, "w4a16_gemm", f64), (qmm, "nat8_w8a16_gemm", f64)]


def llama_q4km(failures):
    """Phase 9b. LLaMA-2 7B Q4_K_M at full width and depth: the structural
    draw on the card with the Q4_K_M mix (Q6_K `output`, and v_w and down_w
    in 16 of 32 layers), prepare_fused refused (q/k/v of a mixed layer
    differ in type), fuse_gate_up alone (F 11008 -> 11264; the Q6_K
    down_w's int8 rows padded too), params_repack with bf16 scales and bias
    (Q4_K natpair, Q6_K nat8 at g 16), Engine(n_ctx=512) serving the 3
    requests of phase 4 with exact launch counts (a decode step 160 W4A8,
    33 nat8 W8A8 and 32 decode attention; a prefill 160 W4A16, 33 nat8
    W8A16 and 32 flash with their maps), profiled; the same requests
    through generate(chunk=8), tokens and KV arena bit-equal request by
    request; then a teacher-forced pass with the kernels held to the same
    pass with every plain version on the card (Q4KM_ROUTE_TOL), the plain
    pass beside itself with the A16 products summed in f64 (a reading),
    and the Q6_K W8A8 fed g 32 in place of g 16, which must fail the
    check.
    Returns (summary, launch counts by run)."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.device import QTensor
    cfg = llama.LlamaConfig(**LLAMA2_7B)
    L = cfg.n_layer
    t0 = time.time()
    raw = llama.synthetic_params_device(cfg, seed=0, types=q4_k_m(L))
    try:
        llama.prepare_fused(raw)
        failures.append("prepare_fused fused a Q4_K_M model's q/k/v")
    except ValueError as e:
        log(f"  prepare_fused refuses the mix: {e}")
    params = params_repack(llama.fuse_gate_up(raw), scale_dtype=torch.bfloat16)
    del raw
    torch.cuda.synchronize()
    ws = [params["output"]] + [w for lp in params["layers"] for w in lp.values()
                               if isinstance(w, QTensor)]
    n_q6k = sum(w.q4_layout == 4 for w in ws)
    n_q4k = sum(w.q4_layout == 3 for w in ws)
    wbytes = sum(t.numel() * t.element_size() for w in ws + [params["tok_embd"]]
                 for t in (w.q, w.scale, w.bias) if t is not None)
    read = sum(t.numel() * t.element_size() for w in ws
               for t in (w.q, w.scale, w.bias) if t is not None)
    log(f"  weights drawn + prepared in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, weights "
        f"{wbytes / 2**30:.3f} GiB with tok_embd; a decode step's products "
        f"{n_q4k} Q4_K natpair + {n_q6k} Q6_K nat8 g16 reading "
        f"{read / 1e9:.3f} GB (bound {read / HBM_BYTES_S * 1e3:.3f} ms); gu_w "
        f"{params['layers'][0]['gu_w'].n} columns, down_w K "
        f"{params['layers'][0]['down_w'].k}")
    if (n_q4k, n_q6k) != (160, 33):
        failures.append(f"Q4_K_M products: {n_q4k} Q4_K, {n_q6k} Q6_K, "
                        "expected 160 and 33")
        return None, None
    eng, rng, reqs, counts, runs = serve(llama, cfg, params, cfg.n_ctx,
                                         failures)
    n_dec, n_pre = N_REQUESTS * (N_PREDICT - 1), N_REQUESTS
    expect = {"w4a8_gemv": n_dec * 160, "nat8_w8a8": n_dec * 33,
              "decode_attention": n_dec * L, "w4a16_gemm": n_pre * 160,
              "nat8_w8a16": n_pre * 33, "flash_attention": n_pre * L,
              "flash_backward_tiles": n_pre * L}
    check_counts(counts, expect, failures)
    if failures:
        return None, None
    busy_ms, walls = profile_engine(eng, rng, reqs)
    creqs, ccounts, summary = serve_chunked(eng, runs, failures)
    check_counts(ccounts, expect, failures)
    med = lambda rs: float(np.median([r["decode_tok_s"] for r in rs]))
    span_ms, span_busy, how = profile_span(eng, busy_ms.get("decode step"))
    log(f"  chunk {CHUNK}: {med(creqs):.2f} tok/s = {1e3 / med(creqs):.3f} ms "
        f"a token (median), {med(creqs) / med(reqs):.2f}x chunk 1's "
        f"{med(reqs):.2f} tok/s")
    summary.update(requests=creqs, tok_s=med(creqs), chunk1_requests=reqs,
                   chunk1_tok_s=med(reqs), busy_ms=busy_ms, wall_ms=walls,
                   span_ms=span_ms, span_busy_ms=span_busy,
                   span_busy_method=how, weight_gib=wbytes / 2**30,
                   step_read_gb=read / 1e9,
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated()
                   / 2**30)
    del eng
    greedy = lambda patches=(), feed=None: engine_greedy(
        cfg, params, False, patches, n=9, model=llama, n_prompt=64,
        n_ctx=cfg.n_ctx, feed=feed)
    ref = greedy()
    plain = greedy(plain_on_card(), ref[0])
    check_forced("LLaMA-2 7B Q4_K_M, kernels vs plain versions on the card",
                 ref, plain, failures, Q4KM_ROUTE_TOL)
    # a reading of how far the sums' order alone moves this model's logits
    # (logged, not a check of the port)
    check_forced("reading: LLaMA-2 7B Q4_K_M, plain versions vs the same "
                 "with the A16 products summed in f64", plain,
                 greedy(plain_on_card() + a16_in_f64(), ref[0]), [],
                 Q4KM_ROUTE_TOL)
    check_forced("control: LLaMA-2 7B Q4_K_M, the Q6_K W8A8 fed g 32 in "
                 "place of g 16", ref, greedy(q6k_fed_g32(), ref[0]),
                 failures, Q4KM_ROUTE_TOL, control=True)
    if failures:
        return None, None
    summary["serving"], by_run = llama_serving(params, failures)
    del params
    torch.cuda.empty_cache()
    return summary, dict(by_run, llama_q4km=counts,
                         llama_q4km_chunked=ccounts)


def llama_serving(params, failures):
    """Phase 9b's serving pass on its weights: BatchedEngine(n_ctx 2048, q8_0
    cell arena, on-device sampling) under phase 6's workload (SERVE), once
    to warm up, then timed, then timed in the --steady form through
    run_pipelined(8): tok/s, p50 TTFT, exact launch counts (every ubatch,
    >= 8 rows, 160 W4A16 and 33 nat8 W8A16: q/k/v unfused; a decode-only
    ubatch 32 decode_attention_cells, a mixed one 32 flash with their maps)
    and a decode-only ubatch's busy share. Then phase 6's route check at
    this width, each pass fed the default pass's tokens (check_forced_rows,
    Q4KM_ROUTE_TOL): every plain version on the card; the fused KV-update
    route (cells mode: 32 decode_attention_update a decode-only ubatch),
    held to the default route (check_fused_cells: logits, attention outputs
    call by call, and the KV arena bit for bit); and the fused route with
    the fresh row written one cell off, which must fail that check.
    Returns (summary, launch counts by run)."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.runtime.batched import BatchedEngine
    cfg = llama.LlamaConfig(**dict(LLAMA2_7B, n_ctx=SERVE["n_ctx"]))
    L = cfg.n_layer
    be = BatchedEngine(llama, cfg, params, n_ctx=SERVE["n_ctx"],
                       kv_dtype="q8_0", on_device_sampling=True, seed=1)
    arena = sum(t.numel() * t.element_size()
                for t in (be.cache.k, be.cache.v, be.cache.ks, be.cache.vs))
    log(f"  serving: q8_0 KV arena {arena / 2**30:.3f} GiB")
    rng = np.random.default_rng(0)
    t0 = time.time()
    serving_workload(be, rng)                        # warm-up
    log(f"  serving warm-up pass {time.time() - t0:.1f} s ({len(be._chunks)} "
        f"chunks captured in "
        f"{sum(r.capture_s for _, r in be._chunks.values()):.2f} s with their "
        "eager first runs)")
    launches = {}
    products = {"w4a16_gemm": 160, "nat8_w8a16": 33}
    summary = timed_serving(be, rng, L, launches, failures, products=products,
                            key="llama_q4km_serving")
    summary["steady"] = timed_serving(be, rng, L, launches, failures,
                                      steady=True, products=products,
                                      key="llama_q4km_serving")
    summary["arena_gib"] = arena / 2**30
    decode_ubatch_profile(be, rng, cfg, summary, "serving: ")
    del be
    torch.cuda.empty_cache()
    ref_attn, fused_attn, fault_attn = [], [], []
    ref = short_serving(cfg, params, False,
                        attention_recording(llama, ref_attn), model=llama)
    feed = ref[0]
    check_forced_rows("LLaMA-2 7B Q4_K_M serving, kernels vs plain versions "
                      "on the card (fed)", ref,
                      short_serving(cfg, params, False, plain_on_card(),
                                    model=llama, feed=feed),
                      failures, Q4KM_ROUTE_TOL)
    fused = short_serving(cfg, params, True,
                          attention_recording(llama, fused_attn), model=llama,
                          feed=feed)
    check_fused_cells("LLaMA-2 7B Q4_K_M serving, fused route (cells mode) vs "
                      "default", ref, ref_attn, fused, fused_attn, failures)
    n_dec = len(ref[1]) - 2                        # two mixed ubatches
    check_counts(fused[2], {"decode_attention_update": L * n_dec,
                            "flash_attention": 2 * L,
                            "flash_backward_tiles": 2 * L,
                            "w4a16_gemm": 160 * (n_dec + 2),
                            "nat8_w8a16": 33 * (n_dec + 2)}, failures)
    launches["llama_q4km_serving_fused"] = fused[2]
    fault = planted_faults()["the fresh row one row off"]
    got = short_serving(cfg, params, True,
                        fault + attention_recording(llama, fault_attn),
                        model=llama, feed=feed)
    check_fused_cells("control: the same, the fresh row one cell off", ref,
                      ref_attn, got, fault_attn, failures, control=True)
    return summary, launches


# phase 8c: GPT-2 117M in the IQ formats. IQ4_NL and IQ4_XS are quantized on
# the host by the port's codecs (host_params) and run nat8 g 32 with f32
# scales and no bias; the decode-only kinds are drawn as random blocks
# (codecs.random_blocks) with the super-scale d below, which gives weights
# of std ~0.02, and run no kernel (IQ2 nib2 and IQ3 nib4 with a lut take
# dequantize + matmul, IQ1 is dense at load)
IQ4_117M = ("IQ4_NL", "IQ4_XS")
CODEBOOK_117M = {"IQ2_XXS": 3.4e-4, "IQ2_XS": 3.5e-4, "IQ2_S": 3.6e-4,
                 "IQ3_XXS": 1.6e-4, "IQ3_S": 1.35e-4, "IQ1_S": 2.7e-3,
                 "IQ1_M": 2.7e-3}
# Phase 8c's check of a decode-only kind: a teacher-forced pass on the card
# (a 32-token prompt + 4 steps; flash and the plain dequantize + matmul)
# against the same pass on the CPU, as check_forced holds it. The two sum
# the products in another order and round P to bf16 in another order.
# Readings of this script on an H100 (PERF.md): sound 0.37-0.51% of the
# largest |logit| (IQ3_XXS the most), the planted faults (a lut's entries
# swapped; IQ1's delta sign flipped) 33% and more. 1% is 2x the one, 1/33
# of the other.
CODEBOOK_TOL = 1e-2
# Phase 9c's route check (LLaMA-2 7B IQ4_XS), as phase 9b's: a teacher-
# forced pass with the kernels against the same pass with every plain
# version on the card. Readings of this script on an H100 (PERF.md): sound
# 6.0e-4 of the largest |logit| (6.97; the prefill 3.5e-4, the decode
# steps, which read the prefill's KV rows, up to 6.0e-4), the planted fault
# (the W8A8 fed the scales shifted by a group) 1.66e-2. 1.2e-3 is 2x the
# one, 1/14 of the other.
IQ4XS_ROUTE_TOL = 1.2e-3
# Phase 9c's bf16 residency: the same teacher-forced pass with every
# weight dequantized to dense bf16 (Engine(residency="bf16")) against the
# plain-version pass of the quantized model. The two differ by the W8A8
# route's q8_0 activations and the products' bf16 rounding. Readings of
# this script on an H100 (PERF.md): 3.5e-3 of the largest |logit| (the
# decode steps; the prefill, bf16 activations on both sides, 3.7e-4).
# 7e-3 is 2x that.
BF16_RESIDENCY_TOL = 7e-3


def iq4_scales_shifted():
    """Phases 8c's and 9c's route-check control: the nat8 W8A8 GEMV fed an
    IQ4 weight's scales shifted by one group (group r takes group r - 1's,
    the first the last's), a fault that still gives plausible numbers."""
    from dataclasses import replace

    from ggml_imax_tpu_torch.ops import qmm
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    real = qmm.nat8_w8a8_gemv

    def fault(x8, dx, qt, xs=None):
        if qt.ggml_type not in (GGMLType.IQ4_NL, GGMLType.IQ4_XS):
            return real(x8, dx, qt, xs)
        return real(x8, dx, replace(qt, scale=torch.roll(qt.scale, 1, 0)),
                    xs)
    return [(qmm, "nat8_w8a8_gemv", fault)]


def codebook_params(cfg, fmt, d, seed=0):
    """gpt2's params tree on the card in a decode-only kind: each 2-D weight
    random blocks (codecs.random_blocks, super-scale d) laid out by
    to_device_format, the vectors drawn as host_params draws them."""
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.quant import codecs
    from ggml_imax_tpu_torch.quant.device import to_device_format
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    rng = np.random.default_rng(seed)
    t = GGMLType[fmt]

    def q(shape_kn):
        k, n = shape_kn
        raw = codecs.random_blocks(t, n * k // 256, rng, d)
        return to_device_format(raw, t, (k, n), device="cuda")

    def vec(n):
        return torch.from_numpy((rng.standard_normal(n) * 0.02)
                                .astype(np.float32)).to(device="cuda")
    return gpt2._param_tree(cfg, q, vec)


def lut_swapped(params):
    """Phase 8c's control for a codebook layout: every lut with its entries
    0 and 1 swapped (a wrong magnitude for every code 0 or 1)."""
    from dataclasses import replace

    from ggml_imax_tpu_torch.quant.device import QTensor
    if isinstance(params, dict):
        return {k: lut_swapped(v) for k, v in params.items()}
    if isinstance(params, list):
        return [lut_swapped(v) for v in params]
    if isinstance(params, QTensor) and params.lut is not None:
        order = [1, 0] + list(range(2, params.lut.numel()))
        return replace(params, lut=params.lut[order].contiguous())
    return params


def qt_bytes(params):
    """Bytes of every QTensor tensor in a params tree."""
    from ggml_imax_tpu_torch.quant.device import QTensor
    if isinstance(params, dict):
        return sum(qt_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(qt_bytes(v) for v in params)
    if isinstance(params, QTensor):
        return sum(t.numel() * t.element_size() for t in
                   (params.q, params.scale, params.bias, params.lut,
                    params.signs) if t is not None)
    return 0


def codebooks_gpt2(failures, pool):
    """Phase 8c. GPT-2 117M at full width and a sixth of its depth in the nine IQ
    kinds.
    IQ4_NL and IQ4_XS: weights drawn on the host and quantized by the
    port's codecs in HOST_WORKERS processes (host_params), params_repack
    (nat8 g 32, f32 scales, no bias), Engine(n_ctx=1024) serving one
    request of phase 4's shape with exact launch counts (4 L W8A8 a decode
    step, 4 L W8A16 a prefill; the tied head gated), a short greedy pass
    held to every plain version on the card (KQ_ROUTE_TOL), and the W8A8
    fed the IQ4 scales shifted by a group, which must fail it. The
    decode-only kinds: random blocks laid out on the card (IQ2 nib2, IQ3
    nib4 with a lut, wte too, so get_rows expands them on the card; IQ1
    dense), one request with exact launch counts (flash and its map only),
    a teacher-forced pass on the card held to the same on the CPU
    (CODEBOOK_TOL), and the same with a lut's entries 0 and 1 swapped
    (IQ1: decoded with IQ1_DELTA's sign flipped), which must fail it.
    Returns (summary, launch counts by run)."""
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant import codecs
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    cfg = gpt2.GPT2Config(**GPT2_117M_HOST)
    L = cfg.n_layer
    summary, launches = {}, {}
    for fmt in IQ4_117M:
        log(f"  -- {fmt}")
        raw, quant_s, same = host_params(cfg, GGMLType[fmt], pool)
        if not same:
            failures.append(f"{fmt}: host_params' proj_w differs from "
                            "quantize_for_device's")
        params = params_repack(raw)
        del raw
        torch.cuda.synchronize()
        fc = params["layers"][0]["fc_w"]
        log(f"  weights drawn and quantized on the host in {quant_s:.1f} s "
            f"({HOST_WORKERS} processes; proj_w equal to quantize_for_device"
            f"'s {same}), repacked ({fc.kind} q4_layout {fc.q4_layout}, g"
            f"{fc.k // fc.scale.shape[0]}, bias {fc.bias is not None}), "
            f"{qt_bytes(params) / 2**30:.3f} GiB of weights, "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
        eng, rng, reqs, counts, _ = serve(gpt2, cfg, params, cfg.n_ctx,
                                          failures, n_requests=1)
        check_counts(counts, {"nat8_w8a8": (N_PREDICT - 1) * 4 * L,
                              "nat8_w8a16": 4 * L, "flash_attention": L,
                              "flash_backward_tiles": L}, failures)
        launches[f"gpt2_117m_{fmt.lower()}"] = counts
        summary[fmt] = {"host_quantize_s": quant_s,
                        "ttft_ms": reqs[0]["ttft_ms"],
                        "decode_tok_s": reqs[0]["decode_tok_s"]}
        del eng
        greedy = lambda patches=(), feed=None: engine_greedy(
            cfg, params, False, patches, model=gpt2, n_prompt=PROMPT,
            n_ctx=cfg.n_ctx, feed=feed)
        ref = greedy()
        check_forced(f"GPT-2 117M {fmt}, kernels vs plain versions on the "
                     "card", ref, greedy(plain_on_card(), ref[0]), failures,
                     KQ_ROUTE_TOL)
        check_forced(f"control: GPT-2 117M {fmt}, nat8 W8A8 fed the scales "
                     "shifted by a group", ref,
                     greedy(iq4_scales_shifted(), ref[0]), failures,
                     KQ_ROUTE_TOL, control=True)
        del params
        torch.cuda.empty_cache()
    for fmt, d in CODEBOOK_117M.items():
        log(f"  -- {fmt}")
        t0 = time.time()
        params = codebook_params(cfg, fmt, d)
        torch.cuda.synchronize()
        layout_s = time.time() - t0
        wte = params["wte"]
        log(f"  random blocks laid out on the card in {layout_s:.1f} s "
            f"(wte {wte.kind}, lut {wte.lut is not None}, signs "
            f"{wte.signs is not None}), {qt_bytes(params) / 2**30:.3f} GiB "
            f"of weights, {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
            "allocated")
        eng, rng, reqs, counts, _ = serve(gpt2, cfg, params, cfg.n_ctx,
                                          failures, n_requests=1)
        check_counts(counts, {"flash_attention": L,
                              "flash_backward_tiles": L}, failures)
        launches[f"gpt2_117m_{fmt.lower()}"] = counts
        summary[fmt] = {"layout_s": layout_s, "ttft_ms": reqs[0]["ttft_ms"],
                        "decode_tok_s": reqs[0]["decode_tok_s"],
                        "weight_gib": qt_bytes(params) / 2**30}
        del eng
        greedy = lambda p, dev=None, feed=None: engine_greedy(
            cfg, p, False, (), n=5, model=gpt2, n_prompt=32,
            n_ctx=cfg.n_ctx, feed=feed, device=dev)
        t0 = time.time()
        ref = greedy(moved(params, "cpu"), "cpu")
        summary[fmt]["cpu_pass_s"] = time.time() - t0
        check_forced(f"GPT-2 117M {fmt}, the card vs the CPU", ref,
                     greedy(params, feed=ref[0]), failures, CODEBOOK_TOL)
        if wte.lut is not None:
            what, bad = "a lut's entries 0 and 1 swapped", lut_swapped(params)
        else:
            what = "decoded with IQ1_DELTA's sign flipped"
            with patched([(codecs, "IQ1_DELTA", -codecs.IQ1_DELTA)]):
                bad = codebook_params(cfg, fmt, d)
        check_forced(f"control: GPT-2 117M {fmt}, {what}", ref,
                     greedy(bad, feed=ref[0]), failures, CODEBOOK_TOL,
                     control=True)
        del params, bad
        torch.cuda.empty_cache()
    return summary, launches


def iq4_xs_mix(name, layer):
    """llama.cpp's LLAMA_FTYPE_MOSTLY_IQ4_XS mix without an importance
    matrix (llama_tensor_get_type) as models/llama.synthetic_params_device's
    `types`: `output` Q6_K, every other 2-D weight, token_embd included,
    IQ4_XS. attn_v stays IQ4_XS (the rule that raises it to Q5_K needs
    n_gqa() >= 4), and no tensor falls back to IQ4_NL (every row length,
    4096 and 11008, is a multiple of 256)."""
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    return GGMLType.Q6_K if name == "output" else GGMLType.IQ4_XS


def llama_iq4xs(failures):
    """Phase 9c. LLaMA-2 7B in llama.cpp's IQ4_XS mix at full width and
    depth: the structural draw on the card (iq4_xs_mix), prepare_fused
    (q/k/v of one type fuse; gate/up fused with F 11008 -> 11264),
    params_repack (IQ4_XS nat8 g 32, f32 scales, no bias; the Q6_K head
    nat8 g 16), Engine(n_ctx=512) serving the requests of phase 4 with
    exact launch counts (a decode step 129 nat8 W8A8 and 32 decode
    attention; a prefill 129 nat8 W8A16 and 32 flash with their maps; no
    W4A8 or W4A16), profiled; the same requests through generate(chunk=8),
    tokens and KV arena bit-equal request by request; a teacher-forced pass
    (64-token prompt + 8 steps) with the kernels held to the same with
    every plain version on the card (IQ4XS_ROUTE_TOL), and the W8A8 fed the
    IQ4 scales shifted by a group, which must fail that check. Then
    Engine(residency="bf16") on the same weights: one request (TTFT, tok/s,
    resident GiB; flash and decode attention only), the teacher-forced pass
    held to the plain-version pass (BF16_RESIDENCY_TOL), and the dense
    weights freed once the engine is dropped. Returns (summary, launch
    counts by run)."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.device import QTensor
    cfg = llama.LlamaConfig(**LLAMA2_7B)
    L = cfg.n_layer
    t0 = time.time()
    params = params_repack(llama.prepare_fused(
        llama.synthetic_params_device(cfg, seed=0, types=iq4_xs_mix)))
    torch.cuda.synchronize()
    ws = [params["output"]] + [w for lp in params["layers"]
                               for w in lp.values() if isinstance(w, QTensor)]
    read = qt_bytes(ws)
    kinds = {(w.ggml_type.name, w.q4_layout, w.k // w.scale.shape[0],
              str(w.scale.dtype)[6:], w.bias is not None) for w in ws}
    log(f"  weights drawn + prepared in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, weights "
        f"{qt_bytes(params) / 2**30:.3f} GiB with tok_embd; a decode step's "
        f"{len(ws)} products {sorted(kinds)} (type, layout, g, scale, bias) "
        f"reading {read / 1e9:.3f} GB (bound {read / HBM_BYTES_S * 1e3:.3f} "
        f"ms); gu_w {params['layers'][0]['gu_w'].n} columns, down_w K "
        f"{params['layers'][0]['down_w'].k}")
    if len(ws) != 4 * L + 1 or any(w.q4_layout != 4 for w in ws):
        failures.append(f"IQ4_XS products: {len(ws)}, layouts "
                        f"{sorted(kinds)}; expected {4 * L + 1} nat8")
        return None, None
    eng, rng, reqs, counts, runs = serve(llama, cfg, params, cfg.n_ctx,
                                         failures)
    n_dec, n_pre = N_REQUESTS * (N_PREDICT - 1), N_REQUESTS
    expect = {"nat8_w8a8": n_dec * (4 * L + 1), "decode_attention": n_dec * L,
              "nat8_w8a16": n_pre * (4 * L + 1), "flash_attention": n_pre * L,
              "flash_backward_tiles": n_pre * L}
    check_counts(counts, expect, failures)
    if failures:
        return None, None
    busy_ms, walls = profile_engine(eng, rng, reqs)
    creqs, ccounts, summary = serve_chunked(eng, runs, failures)
    check_counts(ccounts, expect, failures)
    med = lambda rs: float(np.median([r["decode_tok_s"] for r in rs]))
    span_ms, span_busy, how = profile_span(eng, busy_ms.get("decode step"))
    log(f"  chunk {CHUNK}: {med(creqs):.2f} tok/s = {1e3 / med(creqs):.3f} ms "
        f"a token (median), {med(creqs) / med(reqs):.2f}x chunk 1's "
        f"{med(reqs):.2f} tok/s")
    summary.update(requests=creqs, tok_s=med(creqs), chunk1_requests=reqs,
                   chunk1_tok_s=med(reqs), busy_ms=busy_ms, wall_ms=walls,
                   span_ms=span_ms, span_busy_ms=span_busy,
                   span_busy_method=how, weight_gib=qt_bytes(params) / 2**30,
                   step_read_gb=read / 1e9,
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated()
                   / 2**30)
    del eng, runs
    greedy = lambda p, patches=(), feed=None: engine_greedy(
        cfg, p, False, patches, n=9, model=llama, n_prompt=64,
        n_ctx=cfg.n_ctx, feed=feed)
    ref = greedy(params)
    plain = greedy(params, plain_on_card(), ref[0])
    check_forced("LLaMA-2 7B IQ4_XS, kernels vs plain versions on the card",
                 ref, plain, failures, IQ4XS_ROUTE_TOL)
    check_forced("control: LLaMA-2 7B IQ4_XS, nat8 W8A8 fed the scales "
                 "shifted by a group", ref,
                 greedy(params, iq4_scales_shifted(), ref[0]), failures,
                 IQ4XS_ROUTE_TOL, control=True)
    # the dense bf16 yardstick: the same weights, dequantized at load
    log("  -- Engine(residency=\"bf16\")")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng, _, breqs, bcounts, bruns = serve(llama, cfg, params, cfg.n_ctx,
                                          failures, n_requests=1,
                                          residency="bf16")
    del bruns
    dense = eng.params
    dense_b = qt_bytes(dense)
    held = torch.cuda.memory_allocated() - base
    log(f"  bf16 residency: {dense_b / 2**30:.3f} GiB of dense weights "
        f"({dense_b / qt_bytes(params):.2f}x the quantized), "
        f"{held / 2**30:.3f} GiB more allocated than before the engine")
    check_counts(bcounts, {"decode_attention": (N_PREDICT - 1) * L,
                           "flash_attention": L, "flash_backward_tiles": L},
                 failures)
    del eng
    bf = greedy(dense, feed=ref[0])
    check_forced("LLaMA-2 7B IQ4_XS, bf16 residency vs the plain versions "
                 "(quantized)", plain, bf, failures, BF16_RESIDENCY_TOL)
    del dense, bf
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - base
    log(f"  the bf16 engine dropped: {(held - left) / 2**30:.3f} GiB of its "
        f"{held / 2**30:.3f} GiB freed at once")
    if left > 0.05 * dense_b:
        failures.append(f"bf16 residency: {left / 2**30:.3f} GiB still "
                        "allocated after the engine was dropped")
    summary["bf16_residency"] = {
        "ttft_ms": breqs[0]["ttft_ms"], "decode_tok_s": breqs[0]["decode_tok_s"],
        "weight_gib": dense_b / 2**30}
    del params
    torch.cuda.empty_cache()
    return summary, {"llama_iq4_xs": counts, "llama_iq4_xs_chunked": ccounts,
                     "llama_iq4_xs_bf16": bcounts}


# Whisper small and medium in Q5_0 (phase 10): the reference benchmark's
# whisper-small-q5_0 / whisper-medium-q5_0 (tools/bench_models.py:368-390),
# n_audio_ctx 1500 (30 s of audio), n_vocab 51865 (multilingual)
WHISPER_SMALL = dict(n_vocab=51865, n_audio_ctx=1500, n_audio_state=768,
                     n_audio_head=12, n_audio_layer=12, n_text_ctx=448,
                     n_text_state=768, n_text_head=12, n_text_layer=12,
                     n_mels=80)
WHISPER_MEDIUM = dict(WHISPER_SMALL, n_audio_state=1024, n_audio_head=16,
                      n_audio_layer=24, n_text_state=1024, n_text_head=16,
                      n_text_layer=24)
# measure_whisper: 64 greedy tokens from sot a rep; measure_whisper_rtf: a
# 30 s warm-up, then default_rng(3) noise x 0.1, beam 5, one temperature,
# 64 tokens a window. Here WHISPER_TOKENS (32 since PR 26) and 30 s of it
# (the reference's 120 s, halved in PR 24 and again in PR 26), so the whole
# script stays inside its time limit
WHISPER_TOKENS, WHISPER_AUDIO_S = 32, 30
# The small Whisper of phase 3 (the CPU tests' shape, 150 audio positions):
# its card and CPU runs agree to this share of the largest |logit|, and the
# encoder states to this share of their largest |value|. Readings of this
# script on an H100 (PERF.md): logits 1.35e-2, encoder states 2.6e-3 (bf16
# and int8 roundings flipped by another order of summation; the CPU tests
# read 1.2e-2 and 2.3e-3 between the port and the JAX package).
SMALL_WHISPER = dict(n_vocab=1000, n_audio_ctx=150, n_audio_state=128,
                     n_audio_head=2, n_audio_layer=2, n_text_ctx=32,
                     n_text_state=128, n_text_head=2, n_text_layer=2,
                     n_mels=16)
SMALL_WHISPER_TOL = 5e-2
# Phase 10's route check: a Whisper small pass (encode, the 4-token prompt,
# 8 greedy steps) with the kernels and the same pass with every plain
# version on the card, forced op by op on the kernels' pass (ForcedOps):
# every op's output within this share of its largest |value|. Readings of
# this script on an H100 (PERF.md): sound 3.36e-4 (attention: the flash
# kernel rounds P against its running max; the products 2.3e-6), the
# planted fault (the encoder's 36 padded keys visible) 4.70e-2. 4e-3 is 12x
# the one and 1/12 of the other. Unforced, the passes' logits parted by
# 1.57% of the largest |logit| and the fault's by 2.73% (bf16 and int8
# roundings flipped over 12 layers), too close to tell apart; the sound
# pass's logits are held to ROUTE_TOL, as the engines' are.
WHISPER_ROUTE_TOL = 4e-3


def flash_no_mask(ck, timer, gen, label, B, Tq, Tk, H, D=64):
    """Flash without a mask at a key count off the 64-key tile and the
    reference's 512-key block (Whisper's 1500: padded_keys 1536), timed
    led beside the plain version, SDPA and the bound (q, k, v read once in
    bf16, out written in f32; 4 D operations a (query, key) pair)."""
    from ggml_imax_tpu_torch.ops import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = torch.randn(B, Tq, H, D, generator=gen, device="cuda")
    k, v = (torch.randn(B, Tk, H, D, generator=gen, device="cuda")
            for _ in range(2))
    args = fa._prep(q, k, v, None, 0.0) + (1.0 / math.sqrt(D), 0.0, False)
    got, _ = fa.flash_attention_kernel(*args)
    ref, _ = fa.flash_attention_plain(*args)
    qb, kb, vb = (t.to(torch.bfloat16).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    ck.record("flash_attention", f"{label} B={B} Tq={Tq} Tk={Tk} H={H} D={D} "
              f"no mask (padded keys {fa.padded_keys(Tk)})", got, ref, 1e-2,
              timer(lambda: fa.flash_attention_kernel(*args), iters=50,
                    lead=True),
              timer(lambda: fa.flash_attention_plain(*args), iters=5),
              timer(lambda: sdpa(qb, kb, vb), iters=50, lead=True),
              (B * Tq * H + 2 * B * Tk * H) * D * 2 + B * Tq * H * D * 4,
              4 * D * B * H * Tq * Tk)


def check_conv_f32(failures, gen):
    """Whisper's two convolutions (ops/conv.conv_1d, cuDNN) on the card
    against f64 on the card: within 1e-5 of the largest |output| shows
    f32, not TF32, arithmetic; the same call with cuDNN's TF32 allowed is
    logged beside (the check's control)."""
    from ggml_imax_tpu_torch.ops.conv import conv_1d
    E = WHISPER_SMALL["n_audio_state"]
    for cin, s, w in ((80, 1, 3000), (E, 2, 3000)):
        x = torch.randn(1, cin, w, generator=gen, device="cuda")
        wt = torch.randn(E, cin, 3, generator=gen, device="cuda") * 0.05
        ref = F.conv1d(x.double(), wt.double(), stride=s, padding=1)
        err = rel_err(conv_1d(x, wt, s, 1), ref)
        old = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = rel_err(F.conv1d(x, wt, stride=s, padding=1), ref)
        finally:
            torch.backends.cudnn.allow_tf32 = old
        log(f"  conv_1d Cin {cin} -> {E}, stride {s}, W {w}: rel_err vs f64 "
            f"{err:.2e} (limit 1e-05); with cuDNN's TF32 allowed {tf32:.2e}")
        if err > 1e-5:
            failures.append(f"conv_1d stride {s}: rel_err {err:.3e} vs f64")


def check_whisper_kernels(ck, timer, gen):
    """Whisper's shapes (phase 10): flash with no mask at Tq = Tk = 1500
    over 12 heads of 64 (small) and 16 (medium), and the beam prompt's
    cross-attention (B 5, Tq 4, Tk 1500); nat8 W8A16 on small's mlp0_w
    (768 x 3072) at M 1500 (the encoder) and qkv_w (768 x 2304) at M 20
    (the beam prompt, 5 rows of 4 tokens) and M 5 (a beam step); nat8 W8A8
    on the head padded to 768 x 51968 at M 1 (a greedy step); and the
    convolutions in f32."""
    E, T = WHISPER_SMALL["n_audio_state"], WHISPER_SMALL["n_audio_ctx"]
    flash_no_mask(ck, timer, gen, "whisper-small encoder", 1, T, T, 12)
    flash_no_mask(ck, timer, gen, "whisper-medium encoder", 1, T, T, 16)
    flash_no_mask(ck, timer, gen, "whisper-small beam prompt cross", 5, 4, T,
                  12)
    time_instance(ck, timer, gen, "whisper-small Q5_0 mlp0_w",
                  format_weight("Q5_0", E, 4 * E, gen, None), (T,))
    time_instance(ck, timer, gen, "whisper-small Q5_0 qkv_w",
                  format_weight("Q5_0", E, 3 * E, gen, None), (20, 5))
    time_instance(ck, timer, gen, "whisper-small Q5_0 d_te padded",
                  format_weight("Q5_0", E, 51968, gen, None), (1,))
    check_conv_f32(ck.failures, gen)


def whisper_pass(cfg, params, mel, n_steps=8, feed=None, patches=(),
                 device="cuda"):
    """encode, the cross K/V, the prompt step and n_steps greedy decode
    steps (fed `feed` instead of its own picks: a teacher-forced pass), the
    launch counters set to 0 before each part and read after it. Returns
    (picks, f32 logits (1, n_vocab) per forward on the host, counts by
    part, the encoder states on the host)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.models import whisper as W
    from ggml_imax_tpu_torch.runtime.whisper_pipeline import (FullParams,
                                                              WhisperPipeline)
    counts = {}
    with patched(patches):
        _build.reset_launches()
        enc = W.encode(cfg, params, mel.to(device))
        cross = W.precompute_cross_kv(cfg, params, enc)
        counts["encode"] = dict(_build.LAUNCHES)
        # the pipeline's prompt: [sot, en, transcribe, no-timestamps]
        prompt = WhisperPipeline(cfg, None, device=device).initial_tokens(
            FullParams())
        T = len(prompt)
        cache = W.init_cache(cfg, device=device)
        _build.reset_launches()
        lg, cache = W.decode(cfg, params, torch.tensor([prompt], device=device),
                             torch.arange(T, device=device)[None], cache,
                             cross, 0)
        counts["prompt"] = dict(_build.LAUNCHES)
        logs = [lg[0, -1:].float().cpu()]
        picks = [int(logs[-1][0].argmax())]
        _build.reset_launches()
        for i in range(n_steps):
            tok = picks[-1] if feed is None else feed[i]
            lg, cache = W.decode(cfg, params,
                                 torch.tensor([[tok]], device=device),
                                 torch.full((1, 1), T + i, device=device),
                                 cache, cross, T + i)
            logs.append(lg[0, -1:].float().cpu())
            picks.append(int(logs[-1][0].argmax()))
        counts["steps"] = dict(_build.LAUNCHES)
    return picks, logs, counts, enc.float().cpu()


def whisper_expect(cfg, padded_head, n_steps, prompt_rows=1):
    """The launches of whisper_pass's parts: per encode 6 W8A16 an encoder
    layer and 2 (the cross K/V) a decoder layer, and a flash a layer (no
    mask, so no tile map); the prompt (M = rows x tokens > 1) 6 W8A16 a
    decoder layer (+1 for a padded head, which passes the N % 128 gate),
    2 flash a layer (self-attention with its map, cross-attention without);
    a greedy step (M 1) 6 W8A8 a layer (+1 for a padded head); attention
    at one query row is attention_xla."""
    Le, Ld, h = cfg.n_audio_layer, cfg.n_text_layer, int(padded_head)
    return {"encode": {"nat8_w8a16": 6 * Le + 2 * Ld, "flash_attention": Le},
            "prompt": {"nat8_w8a16": 6 * Ld + h, "flash_attention": 2 * Ld,
                       "flash_backward_tiles": Ld},
            "steps": {"nat8_w8a8": n_steps * (6 * Ld + h)}}


def whisper_params(cfg, seed=0, pad_head=True, device="cuda"):
    """synthetic_params_device (Q5_0), the head padded to a multiple of
    128 columns as measure_whisper pads it (or left at n_vocab as
    measure_whisper_rtf leaves it), prepare_fused, params_repack."""
    from ggml_imax_tpu_torch.models import whisper as W
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.device import pad_qtensor_cols
    raw = W.synthetic_params_device(cfg, seed=seed, device=device)
    if pad_head:
        raw["d_te"] = pad_qtensor_cols(raw["d_te"], 128)[0]
    return params_repack(W.prepare_fused(raw))


def check_small_whisper(failures):
    """The small Whisper (2 + 2 layers, head_dim 64, 150 audio positions,
    the head padded 1000 -> 1024) on the card (kernels) against the same
    weights on the CPU (plain versions): encode, cross K/V, the prompt and
    4 teacher-forced steps, with the card run's exact launch counts."""
    from ggml_imax_tpu_torch.models import whisper as W
    cfg = W.WhisperConfig(**SMALL_WHISPER)
    cpu = whisper_params(cfg, seed=5, device="cpu")
    made = {"cpu": cpu, "cuda": moved(cpu, "cuda")}
    mel = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32))
    feed = list(np.random.default_rng(6).integers(0, cfg.n_vocab, 4))
    runs = {dev: whisper_pass(cfg, made[dev], mel, 4, feed, device=dev)
            for dev in ("cuda", "cpu")}
    (_, lc, counts, ec), (_, lh, _, eh) = runs["cuda"], runs["cpu"]
    err = max(float((a - b).abs().max()) for a, b in zip(lc, lh))
    limit = SMALL_WHISPER_TOL * logit_scale(lh)
    enc_err = rel_err(ec, eh)
    want = whisper_expect(cfg, True, 4)
    got = {part: {k: n for k, n in c.items() if n} for part, c in counts.items()}
    log(f"  small Whisper Q5_0: encoder states rel_err card vs CPU "
        f"{enc_err:.3e}, max |logit diff| {err:.3e} (limit {limit:.3e}), "
        f"launches {got}")
    if err > limit or enc_err > SMALL_WHISPER_TOL or got != want:
        failures.append(f"small Whisper: logit diff {err:.3e}, encoder "
                        f"{enc_err:.3e}, launches {got} (expected {want})")


def padded_keys_visible():
    """The route check's planted fault: the encoder's flash (Tq = Tk, no
    mask) with the keys padded to padded_keys(Tk) by zeros and counted as
    visible, where the reference scores them NEG (at 1500 keys: 36 padded
    keys each adding exp(0 - m) to a row's sum)."""
    from ggml_imax_tpu_torch.ops import flash_attention as fa
    real = fa.flash_attention_kernel

    def kernel(qb, kb, vb, m3, slopes, scale, softcap, want_lse, tiles=None):
        Tq, Tk = qb.shape[1], kb.shape[1]
        if m3 is None and Tq == Tk and fa.padded_keys(Tk) > Tk:
            pad = (0, 0, 0, 0, 0, fa.padded_keys(Tk) - Tk)
            kb, vb = (F.pad(t, pad).contiguous() for t in (kb, vb))
        return real(qb, kb, vb, m3, slopes, scale, softcap, want_lse,
                    tiles=tiles)
    return [(fa, "flash_attention_kernel", kernel)]


def whisper_encode_greedy(label, cfg, params, failures, busy_label=None):
    """tools/bench_models.py measure_whisper on the port: the encoder + the
    cross K/V of one 30 s mel (N(0, 0.5)), ms a chunk (best of 3 x 4
    chained, host clock to a synchronize), then WHISPER_TOKENS greedy
    tokens from sot at one row, eager, the argmax on the card (best of 3 reps, each at the
    positions after the last), ms a token and tok/s; exact launch counts of
    an encode and of the 3 reps; the device busy share of an encode and of
    a greedy step (torch.profiler kernel time against the host-clock
    time). Returns (summary, counts by part, the cross K/V)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.models import whisper as W
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    mel = torch.randn((1, cfg.n_mels, 2 * cfg.n_audio_ctx), generator=gen,
                      device="cuda") * 0.5
    enc_fn = lambda: W.precompute_cross_kv(cfg, params,
                                           W.encode(cfg, params, mel))
    t0 = time.time()
    cross = enc_fn()
    torch.cuda.synchronize()
    first = time.time() - t0
    want = whisper_expect(cfg, params["d_te"].n % 128 == 0, WHISPER_TOKENS)
    counts = {}
    _build.reset_launches()
    cross = enc_fn()
    torch.cuda.synchronize()
    counts["encode"] = dict(_build.LAUNCHES)
    check_counts(counts["encode"], want["encode"], failures)
    enc_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(4):
            cross = enc_fn()
        torch.cuda.synchronize()
        enc_ms.append((time.perf_counter() - t0) / 4 * 1e3)
    enc_dev = _device_ms(lambda _: enc_fn(), 2)
    enc_busy = sum(enc_dev.values()) if enc_dev else None
    cache = W.init_cache(cfg, batch=1, device="cuda")
    box = {"tok": torch.full((1, 1), cfg.token_sot, dtype=torch.long,
                             device="cuda")}

    def run(start, n):
        for i in range(n):
            lg, _ = W.decode(cfg, params, box["tok"],
                             torch.full((1, 1), start + i, device="cuda"),
                             cache, cross, start + i)
            box["tok"] = lg[:, -1].argmax(-1, keepdim=True)
        return int(box["tok"][0, 0])

    run(0, WHISPER_TOKENS)                              # warm-up
    _build.reset_launches()
    dec_ms = []
    for rep in range(3):
        t0 = time.perf_counter()
        run(WHISPER_TOKENS * (rep + 1), WHISPER_TOKENS)
        dec_ms.append((time.perf_counter() - t0) / WHISPER_TOKENS * 1e3)
    counts["greedy"] = dict(_build.LAUNCHES)
    check_counts(counts["greedy"], {k: 3 * n for k, n in
                                    want["steps"].items()}, failures)
    step_dev = _device_ms(lambda i: run(300 + i, 1), 4)
    step_busy = sum(step_dev.values()) if step_dev else None
    ms, tok_ms = min(enc_ms), min(dec_ms)
    busy = lambda b, wall: "not measured (no device time in the trace)" \
        if b is None else f"{b:.3f} ms device busy = {100 * b / wall:.1f}%"
    log(f"  {label}: encoder + cross K/V {ms:.3f} ms a 30 s chunk (best of "
        f"3 x 4; reps {', '.join(f'{t:.3f}' for t in enc_ms)}; first call "
        f"{first:.2f} s), {busy(enc_busy, ms)}")
    log(f"  {label}: greedy {tok_ms:.3f} ms a token = {1e3 / tok_ms:.2f} "
        f"tok/s (best of 3 x {WHISPER_TOKENS}; reps "
        f"{', '.join(f'{t:.3f}' for t in dec_ms)}), a step "
        f"{busy(step_busy, tok_ms)}")
    for what, dev in (("encode", enc_dev), ("greedy step", step_dev)):
        for key, t in sorted((dev or {}).items(), key=lambda kv: -kv[1])[:5]:
            log(f"    {what} {t:9.4f} ms  {key[:90]}")
    log(f"  {label}: launches an encode {counts['encode']}, over 3 x "
        f"{WHISPER_TOKENS} greedy steps {counts['greedy']}")
    return ({"encode_ms_per_30s_chunk": ms, "encode_reps_ms": enc_ms,
             "encode_busy_ms": enc_busy, "decode_ms_per_token": tok_ms,
             "decode_tok_s": 1e3 / tok_ms, "decode_reps_ms": dec_ms,
             "step_busy_ms": step_busy}, counts, cross)


class ForcedOps:
    """Op-by-op teacher forcing of models/whisper on the card: a recording
    pass keeps the output of every op the model calls (conv_1d, get_rows,
    layer_norm, the products, attention, gelu) in program order; a forced
    pass, run next on the same inputs, holds each of its ops' output to
    the recorded output of the same op (max |diff| over that output's
    largest |value|) and goes on with the recorded value, so each op's
    difference stands alone instead of piling up over the layers."""

    NAMES = ("conv_1d", "get_rows", "layer_norm", "qmatmul", "attention",
             "gelu")

    def __init__(self):
        self.recs = {n: [] for n in self.NAMES}

    def recording(self):
        from ggml_imax_tpu_torch.models import whisper as W

        def rec(name, fn):
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                self.recs[name].append(out.detach().clone())
                return out
            return wrapped
        return [(W, n, rec(n, getattr(W, n))) for n in self.NAMES]

    def forcing(self, errs):
        """Patches forcing a pass on the records; errs (name -> the largest
        relative difference) fills as it runs."""
        from ggml_imax_tpu_torch.models import whisper as W
        queues = {n: list(r) for n, r in self.recs.items()}

        def force(name, fn):
            def wrapped(*a, **kw):
                got, ref = fn(*a, **kw), queues[name].pop(0)
                errs[name] = max(errs.get(name, 0.0), rel_err(got, ref))
                return ref
            return wrapped
        return [(W, n, force(n, getattr(W, n))) for n in self.NAMES]


def check_ops(label, errs, failures, control=False):
    """Every op of a forced pass within WHISPER_ROUTE_TOL of its recorded
    output; a control (a planted fault) must fail."""
    ok = max(errs.values()) <= WHISPER_ROUTE_TOL
    log(f"  {label}: largest relative difference per op "
        f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } (limit "
        f"{WHISPER_ROUTE_TOL:.0e}) -> {'holds' if ok else 'fails'}")
    if ok == control:
        failures.append(f"{label}: the check {'holds' if ok else 'fails'} "
                        f"({errs})")


def whisper_route_check(cfg, params, failures):
    """A Whisper small pass (encode, the prompt, 8 greedy steps) with the
    kernels, recorded op by op, and the same pass fed its tokens with every
    plain version on the card: the logits within ROUTE_TOL of the largest
    |logit| (check_forced), and, forced op by op on the kernels' pass
    (ForcedOps), every op within WHISPER_ROUTE_TOL; the planted fault
    (padded_keys_visible), forced on the same record, must fail that
    check."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    mel = torch.randn((1, cfg.n_mels, 2 * cfg.n_audio_ctx), generator=gen,
                      device="cuda") * 0.5
    ops = ForcedOps()
    ref = whisper_pass(cfg, params, mel, patches=ops.recording())
    feed = ref[0][:-1]
    plain = whisper_pass(cfg, params, mel, feed=feed, patches=plain_on_card())
    log(f"  encoder states, kernels vs plain versions: rel_err "
        f"{rel_err(ref[3], plain[3]):.3e}")
    check_forced("Whisper small Q5_0, kernels vs plain versions on the card",
                 ref, plain, failures, ROUTE_TOL)
    for label, patches, control in (
            ("Whisper small, forced op by op, plain versions vs kernels",
             plain_on_card(), False),
            ("control: Whisper small forced op by op, the encoder's 36 padded "
             "keys counted as visible", padded_keys_visible(), True)):
        errs = {}
        whisper_pass(cfg, params, mel, feed=feed,
                     patches=list(patches) + ops.forcing(errs))
        check_ops(label, errs, failures, control)
    del ops


def pipeline_run(pipe, samples, fp, calls=None):
    """One timed transcribe (host clock to the last fetch), the launch
    counters set to 0 just before and read just after, and a copy of the KV
    cache after every attempt. Returns (segments, wall s, launch counts,
    the caches)."""
    from ggml_imax_tpu_torch import _build
    caches, real = [], pipe._run_beam

    def run_beam(*a, **kw):
        out = real(*a, **kw)
        c = pipe.last_cache
        caches.append([t.clone() for t in (c.k, c.v, c.ks, c.vs)
                       if t is not None])
        return out
    pipe._run_beam = run_beam
    try:
        if calls is not None:
            calls.clear()
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        segs = pipe.transcribe(samples, fp)
        wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
    finally:
        del pipe._run_beam
    return segs, wall, counts, caches


def same_transcript(a, b) -> bool:
    """Two pipeline_run results with equal tokens, temperatures,
    avg_logprob and KV cache after every attempt, bit for bit."""
    key = lambda r: [(s.tokens, s.temperature, s.avg_logprob) for s in r[0]]
    return key(a) == key(b) and len(a[3]) == len(b[3]) and all(
        torch.equal(x, y) for ca, cb in zip(a[3], b[3]) for x, y in zip(ca, cb))


def frozen_whisper_fill(pipe_cls):
    """The captured Whisper steps' planted fault: each static set's n_past
    and positions left at the first value they were given (every replay
    writes and reads one cache row), as frozen_n_past_control freezes the
    engine's spans."""
    real = pipe_cls._fill

    def frozen(self, st, nxt, n_past):
        first = getattr(st, "frozen_at", None)
        if first is None:
            st.frozen_at = first = n_past
        real(self, st, nxt, first)
    return [(pipe_cls, "_fill", frozen)]


def timed_timestamps(pipe, samples, fp):
    """transcribe with token_timestamps, the timestamp pass's parts timed:
    the device part (alignment_weights: the teacher-forced decode with the
    cross-attention and the heads' fetch, host clock to the fetch) and the
    host parts (_median_filter with the normalization and averaging it
    feeds, and _dtw_path), all told. Returns (segments, wall s, launch
    counts, {part: seconds}, passes)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.runtime import whisper_pipeline as wp
    secs = {"device": 0.0, "median": 0.0, "dtw": 0.0}
    n = [0]

    def timed(key, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            secs[key] += time.perf_counter() - t0
            n[0] += key == "device"
            return out
        return wrapped
    pairs = [(wp, "alignment_weights", timed("device", wp.alignment_weights)),
             (wp, "_median_filter", timed("median", wp._median_filter)),
             (wp, "_dtw_path", timed("dtw", wp._dtw_path))]
    with patched(pairs):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        segs = pipe.transcribe(samples, fp)
        wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
    return segs, wall, counts, secs, n[0]


def captured_beam_step(pipe, reps=8):
    """The captured beam step (B 5, top-10) replayed from its static
    tensors: ms a replay with the fetch of its values (host clock), and its
    device busy time by torch.profiler over replays (None where the trace
    resolves no kernel of a replay)."""
    st = pipe._static[(5, 10)]
    st.n_past.fill_(10)
    st.pos.fill_(10)
    st.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        st.run()
        st.vals.cpu()
    wall = (time.perf_counter() - t0) / reps * 1e3
    dev = _device_ms(lambda _: (st.run(), st.vals.cpu()), 4)
    return wall, (sum(dev.values()) if dev else None), dev


def whisper_pipeline_phase(key, cfg, params, failures):
    """tools/bench_models.py measure_whisper_rtf on the port: WhisperPipeline
    (head unpadded: N 51865 fails the N % 128 gate, so dequantize + matmul
    each step), FullParams(beam_size=5, temperatures=(0.0,), max_tokens=64),
    a 30 s warm-up, then WHISPER_AUDIO_S of default_rng(3) noise x 0.1, host clock,
    through the eager route (graphs=False) and the captured steps: RTF,
    segments, tokens, exact launch counts (per window an encode, the prompt
    step at 5 rows x 4 tokens and 6 W8A16 a decoder layer at M 5 each beam
    step; the captured route's equal to the eager one's), and the captured
    route's tokens, avg_logprob and KV cache after every window equal to
    the eager route's bit for bit; a control, the captured steps with
    n_past frozen, which must fail that check on the first window; a beam
    step eager and captured, wall against device busy, and the gated head's
    device time; then the same audio again with token_timestamps: the timestamp
    pass's device and host seconds, its launches (a decoder pass at M = the
    window's tokens: 6 W8A16 and 2 flash a layer, one map), token_times
    monotone within each window, tokens equal to the captured run's."""
    from ggml_imax_tpu_torch.models import whisper as W
    from ggml_imax_tpu_torch.ops.qmatmul import qmatmul
    from ggml_imax_tpu_torch.runtime.whisper_pipeline import (FullParams,
                                                              WhisperPipeline)
    sr = 16000
    Le, Ld = cfg.n_audio_layer, cfg.n_text_layer
    rng = np.random.default_rng(3)
    fp = FullParams(beam_size=5, temperatures=(0.0,),
                    max_tokens=WHISPER_TOKENS)
    warm = (rng.standard_normal(30 * sr) * 0.1).astype(np.float32)
    samples = (rng.standard_normal(WHISPER_AUDIO_S * sr) * 0.1) \
        .astype(np.float32)
    out, runs, launches = {}, {}, {}
    for graphs in (False, True):
        route = "captured" if graphs else "eager"
        pipe = WhisperPipeline(cfg, params, graphs=graphs)
        calls = []
        real = pipe._decode_topk

        def counted(*a, _real=real, _calls=calls, **kw):
            _calls.append(a[5])                  # n_past
            return _real(*a, **kw)
        pipe._decode_topk = counted
        t0 = time.time()
        pipe.transcribe(warm, fp)
        torch.cuda.synchronize()
        log(f"  {key} {route}: warm-up transcribe of 30 s {time.time() - t0:.2f}"
            f" s" + (f", of which the captured steps' eager first runs and "
                     f"captures {pipe.capture_s:.2f} s" if graphs else ""))
        run = pipeline_run(pipe, samples, fp, calls)
        runs[route] = run
        segs, wall, counts, _ = run
        toks = sum(len(s.tokens) for s in segs)
        windows = len(segs)
        if not graphs:
            # the eager route calls the step once a prompt and a beam step
            steps = len(calls) - windows
            expect = {"nat8_w8a16": windows * (6 * Le + 2 * Ld)
                      + len(calls) * 6 * Ld,
                      "flash_attention": windows * (Le + 2 * Ld),
                      "flash_backward_tiles": windows * Ld}
            check_counts(counts, expect, failures)
        elif counts != runs["eager"][2]:
            failures.append(f"{key} captured pipeline launches {counts} differ "
                            f"from the eager route's {runs['eager'][2]}")
        if windows != WHISPER_AUDIO_S // 30 or not all(
                0 <= t < cfg.n_vocab for s in segs for t in s.tokens):
            failures.append(f"{key} {route} pipeline: {windows} segments, "
                            f"tokens {[s.tokens[:8] for s in segs]}")
        rtf = WHISPER_AUDIO_S / wall
        log(f"  {key} {route} pipeline over {WHISPER_AUDIO_S} s: {wall:.3f} s "
            f"wall -> RTF {rtf:.2f}x real time, {windows} segments, {toks} "
            f"tokens, {steps} beam steps, avg_logprob "
            f"{[round(s.avg_logprob, 4) for s in segs]}; launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        out[f"{route}_rtf"], out[f"{route}_wall_s"] = rtf, wall
        out.update(segments=windows, tokens=toks, beam_steps=steps)
        launches[f"whisper_{key}_pipeline_{route}"] = counts
    ok = same_transcript(runs["eager"], runs["captured"])
    log(f"  {key}: captured vs eager, window by window: tokens, avg_logprob "
        f"and KV cache equal bit for bit {ok}")
    if not ok:
        failures.append(f"{key}: the captured pipeline differs from the eager")
    # the control: the captured steps with n_past frozen, on the first window
    first = samples[:30 * sr]
    want = (runs["eager"][0][:1], None, None, runs["eager"][3][:1])
    with patched(frozen_whisper_fill(WhisperPipeline)):
        got = pipeline_run(pipe, first, fp)
    for st in pipe._static.values():
        del st.frozen_at
    fails = not same_transcript(want, got)
    log(f"  control: {key} captured steps with n_past frozen, first window: "
        f"tokens equal {got[0][0].tokens == want[0][0].tokens}, the check "
        f"{'fails' if fails else 'holds'}")
    if not fails:
        failures.append(f"{key} control: frozen n_past passed the check")
    # a beam step: eager (one decode step at 5 rows) and captured
    xk, xv = W.precompute_cross_kv(cfg, params, torch.zeros(
        1, cfg.n_audio_ctx, cfg.n_audio_state, device="cuda"))
    cross = (xk.repeat_interleave(5, 1), xv.repeat_interleave(5, 1))
    cache = W.init_cache(cfg, batch=5, device="cuda")
    tok = torch.full((5, 1), 220, dtype=torch.long, device="cuda")
    step = lambda i: pipe._decode_topk(
        params, tok, torch.full((5, 1), 10 + i, device="cuda"), cache, cross,
        10 + i, k=10)[0].cpu()
    step(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(8):
        step(i)
    e_wall = (time.perf_counter() - t0) / 8 * 1e3
    e_dev = _device_ms(step, 4)
    e_busy = sum(e_dev.values()) if e_dev else None
    c_wall, c_busy, c_dev = captured_beam_step(pipe)
    del cross, cache
    x = torch.randn(5, 1, cfg.n_text_state, device="cuda")
    head_ms = Timer()(lambda: qmatmul(x, params["d_te"],
                                      out_dtype=torch.float32))
    share = lambda b, w: "not measured (no device time in the trace)" \
        if b is None else f"{b:.3f} ms = {100 * b / w:.1f}%"
    log(f"  {key} beam step (5 rows): eager {e_wall:.3f} ms wall, device busy "
        f"{share(e_busy, e_wall)}; captured {c_wall:.3f} ms wall, device busy "
        f"{share(c_busy, c_wall)}; the gated head (dequantize + matmul, N "
        f"{params['d_te'].n}) {head_ms:.3f} ms by CUDA events"
        + ("" if e_busy is None else
           f" = {100 * head_ms / e_busy:.1f}% of the eager step's device time"))
    for label, dev in (("eager", e_dev), ("captured", c_dev)):
        for k, t in sorted((dev or {}).items(), key=lambda kv: -kv[1])[:5]:
            log(f"    {label} beam step {t:9.4f} ms  {k[:90]}")
    out.update(eager_beam_step_ms=e_wall, eager_beam_step_busy_ms=e_busy,
               captured_beam_step_ms=c_wall, captured_beam_step_busy_ms=c_busy,
               gated_head_ms=head_ms, capture_s=pipe.capture_s)
    # the timestamp pass, over the same audio on the captured steps
    fpt = FullParams(beam_size=5, temperatures=(0.0,),
                     max_tokens=WHISPER_TOKENS, token_timestamps=True)
    segs, wall, counts, secs, n_pass = timed_timestamps(pipe, samples, fpt)
    lens = [len(s.tokens) + 4 for s in segs if s.tokens]
    expect = {k: n + {"nat8_w8a16": 6 * Ld, "flash_attention": 2 * Ld,
                      "flash_backward_tiles": Ld}.get(k, 0) * len(lens)
              for k, n in runs["captured"][2].items()}
    check_counts(counts, expect, failures)
    mono = all(s.token_times is not None and len(s.token_times) == len(s.tokens)
               and s.token_times == sorted(s.token_times)
               and s.t0 <= s.token_times[0] and s.token_times[-1] < s.t0 + 30
               for s in segs)
    same = [s.tokens for s in segs] == [s.tokens for s in runs["captured"][0]]
    log(f"  {key} with token timestamps: {wall:.3f} s wall (RTF "
        f"{WHISPER_AUDIO_S / wall:.2f}), {n_pass} timestamp passes at T "
        f"{lens}: device part {secs['device']:.3f} s, host median filter "
        f"{secs['median']:.3f} s, host DTW {secs['dtw']:.3f} s; token_times "
        f"monotone in their windows {mono}, tokens equal the captured run's "
        f"{same}; first window's first times "
        f"{[round(float(t), 2) for t in segs[0].token_times[:6]]}")
    if not (mono and same and n_pass == len(segs)):
        failures.append(f"{key} timestamps: monotone {mono}, tokens equal "
                        f"{same}, {n_pass} passes")
    out.update(timestamps_wall_s=wall, timestamp_device_s=secs["device"],
               timestamp_median_s=secs["median"], timestamp_dtw_s=secs["dtw"],
               timestamp_passes=n_pass)
    launches[f"whisper_{key}_timestamps"] = counts
    del pipe
    return out, launches


def whisper_phase(failures):
    """Phase 10: 10a Whisper small Q5_0 as measure_whisper, the route check
    and its planted fault; 10b the small pipeline as measure_whisper_rtf,
    eager and captured, with token timestamps; 10c Whisper medium Q5_0 as
    measure_whisper, then 10d its pipeline as 10b. Returns (summary, launch
    counts by run)."""
    from ggml_imax_tpu_torch.models import whisper as W
    summary, launches = {}, {}
    for key, cfg_kw in (("small", WHISPER_SMALL), ("medium", WHISPER_MEDIUM)):
        cfg = W.WhisperConfig(**cfg_kw)
        log(f"  -- 10{'a' if key == 'small' else 'c'}: Whisper {key} Q5_0, "
            f"{cfg.n_audio_layer} + {cfg.n_text_layer} layers of "
            f"{cfg.n_audio_state}, head padded to 51968")
        t0 = time.time()
        params = whisper_params(cfg)
        torch.cuda.synchronize()
        ws = [w for w in [params["d_te"]] + [w for lp in params["enc_layers"]
                                             + params["dec_layers"]
                                             for w in lp.values()]
              if hasattr(w, "q4_layout")]
        log(f"  weights drawn + prepared in {time.time() - t0:.1f} s, "
            f"{qt_bytes(params) / 2**30:.3f} GiB, {len(ws)} products, "
            f"layouts {sorted({(w.ggml_type.name, w.q4_layout) for w in ws})}")
        out, counts, _ = whisper_encode_greedy(f"Whisper {key}", cfg, params,
                                               failures)
        summary[key] = out
        launches.update({f"whisper_{key}_{part}": c
                         for part, c in counts.items()})
        if key == "small":
            whisper_route_check(cfg, params, failures)
        del params
        torch.cuda.empty_cache()
        if failures:
            break
        log(f"  -- 10{'b' if key == 'small' else 'd'}: the Whisper {key} "
            "pipeline (head unpadded, beam 5), eager and captured, and its "
            "token timestamps")
        params = whisper_params(cfg, pad_head=False)
        summary[f"{key}_pipeline"], by_run = whisper_pipeline_phase(
            key, cfg, params, failures)
        launches.update(by_run)
        del params
        torch.cuda.empty_cache()
        if failures:
            break
    return summary, launches


# ---- phase 11: the loaders and tokenizers
# A fixed English text: every phase-11 prompt is the first PROMPT ids of
# it through the file's own tokenizer.
LOADER_TEXT = " ".join([
    "The river town woke slowly that morning, as it did every spring, with "
    "the bakers first and the boatmen soon after. Mist hung over the water "
    "and the bridge, and the bells of the old church counted six, then "
    "seven. A girl named Mara carried bread to her grandfather, who kept the "
    "lock at the bend of the river and knew every barge by the sound of its "
    "engine. He told her that the water was higher than last year, that the "
    "north fields would flood by May, and that the mayor, who never walked "
    "farther than the square, would blame the weather again."] * 4 + [
    "In the afternoon the market filled with apples, cheese, wool and tools; "
    "traders argued about prices in three languages, and children ran "
    "between the stalls with dogs at their heels. Mara counted coins for "
    "her aunt, 12 silver and 40 copper, and wrote the sums in a small book. "
    "When the sun went down, the lamps were lit along the quay, and the "
    "boats came home one by one, heavy with sand from the quarries upstream."
    ] * 4)
# the byte-level merges learned from LOADER_TEXT for the GGUF vocab
LOADER_MERGES = 300
# the f16 fields of the block formats, drawn as the models'
# synthetic_params draw their scales (scale 0.02): field -> the divisor of
# |N| * scale. Q4_K's and Q6_K's sub-scales multiply d by the block's
# 6-bit (mean 31.5) or int8 (mean |.| 64) scales.
BLOCK_SCALES = {"Q4_0": {"d": 4.6}, "Q5_0": {"d": 9.2},
                "Q4_K": {"d": 9 * 31.5, "dmin": 3 * 31.5},
                "Q6_K": {"d": 18.5 * 64}}


def loader_dir() -> Path:
    """The phase's files go under the checkout's git-ignored build/."""
    d = Path(__file__).resolve().parent / "build" / "loaders"
    d.mkdir(parents=True, exist_ok=True)
    return d


def greedy_vocab(n_vocab, text=LOADER_TEXT) -> list:
    """A legacy file's vocab: every printable ASCII character alone (so any
    ASCII text round-trips through GreedyBPETokenizer), the text's words
    alone and after a space, then numbered fillers up to n_vocab."""
    toks = [chr(c) for c in range(0x20, 0x7F)]
    toks += [w for w in dict.fromkeys(x for word in text.split(" ")
                                      for x in (word, " " + word))
             if len(w) > 1]
    toks += [f"<unused{i}>" for i in range(n_vocab - len(toks))]
    return [t.encode() for t in toks]


def byte_level_vocab(n_vocab, text=LOADER_TEXT, n_merges=LOADER_MERGES):
    """A GGUF vocab for ByteLevelBPETokenizer: the 256 byte tokens (any text
    round-trips), n_merges merges learned from the text's words as the
    tokenizer splits them (the most frequent adjacent pair first, ties to
    the first seen), then numbered fillers up to n_vocab. Returns (tokens,
    merges)."""
    from ggml_imax_tpu_torch.tokenizer.bpe import bytes_to_unicode, split_words
    b2u = bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    words = {}
    for w in split_words(text):
        key = tuple(b2u[b] for b in w.encode())
        words[key] = words.get(key, 0) + 1
    words = [[list(k), n] for k, n in words.items()]
    merges = []
    for _ in range(n_merges):
        counts = {}
        for w, n in words:
            for pair in zip(w, w[1:]):
                counts[pair] = counts.get(pair, 0) + n
        if not counts:
            break
        a, b = max(counts, key=counts.get)
        merges.append(f"{a} {b}")
        tokens.append(a + b)
        for entry in words:
            w, out, i = entry[0], [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            entry[0] = out
    tokens += [f"<unused{i}>" for i in range(n_vocab - len(tokens))]
    return tokens, merges


def random_raw(t, ne, rng, scale=0.02):
    """A tensor's encoded bytes drawn on the host from rng: uniform bytes
    for the quants and the packed sub-scales, the f16 fields set finite
    (BLOCK_SCALES; uniform bytes there would give NaN and Inf)."""
    from ggml_imax_tpu_torch.quant import codecs
    from ggml_imax_tpu_torch.quant.formats import FORMATS
    info = FORMATS[t]
    n_blocks = math.prod(ne) // info.block_size
    nbytes = n_blocks * info.type_size
    raw = rng.bit_generator.random_raw(-(-nbytes // 8)).view(np.uint8)[:nbytes]
    blocks = raw.view(codecs.BLOCK_DTYPES[t])
    for field, div in BLOCK_SCALES[t.name].items():
        blocks[field] = (np.abs(rng.standard_normal(n_blocks, np.float32))
                         * (scale / div)).astype(np.float16)
    return raw


def file_tensors(spec, rng, scale=0.02):
    """spec: (file name, params path, type, ne) rows -> name -> (type, ne,
    encoded bytes): block formats by random_raw, float tensors N * scale
    (+ 1 for a norm's gain: a path ending in _g or norm)."""
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    out = {}
    for name, path, t, ne in spec:
        if t in (GGMLType.F32, GGMLType.F16):
            x = rng.standard_normal(math.prod(ne), np.float32) * scale
            if str(path[-1]).endswith(("_g", "norm")):
                x += 1.0
            x = x.astype(np.float16 if t == GGMLType.F16 else np.float32)
            out[name] = (t, tuple(ne), x.view(np.uint8))
        else:
            out[name] = (t, tuple(ne), random_raw(t, ne, rng, scale))
    return out


def gptj_spec(cfg):
    """GPT-J's tensors as the reference's convert script writes a Q4_0
    file: (name, params path, type, ne); 2-D weights Q4_0, the rest F32."""
    from ggml_imax_tpu_torch.quant.formats import GGMLType as T
    E, V = cfg.n_embd, cfg.n_vocab
    spec = [("transformer.wte.weight", ("wte",), T.Q4_0, (E, V)),
            ("transformer.ln_f.weight", ("ln_f_g",), T.F32, (E,)),
            ("transformer.ln_f.bias", ("ln_f_b",), T.F32, (E,)),
            ("lm_head.weight", ("lmh_w",), T.Q4_0, (E, V)),
            ("lm_head.bias", ("lmh_b",), T.F32, (V,))]
    for i in range(cfg.n_layer):
        p, lp = f"transformer.h.{i}", ("layers", i)
        spec += [(f"{p}.ln_1.weight", lp + ("ln_1_g",), T.F32, (E,)),
                 (f"{p}.ln_1.bias", lp + ("ln_1_b",), T.F32, (E,))]
        spec += [(f"{p}.attn.{n}_proj.weight", lp + (f"{n[0]}_w",), T.Q4_0,
                  (E, E)) for n in ("q", "k", "v", "out")]
        spec += [(f"{p}.mlp.fc_in.weight", lp + ("fc_in_w",), T.Q4_0,
                  (E, 4 * E)),
                 (f"{p}.mlp.fc_in.bias", lp + ("fc_in_b",), T.F32, (4 * E,)),
                 (f"{p}.mlp.fc_out.weight", lp + ("fc_out_w",), T.Q4_0,
                  (4 * E, E)),
                 (f"{p}.mlp.fc_out.bias", lp + ("fc_out_b",), T.F32, (E,))]
    return spec


def gpt2_spec(cfg):
    """GPT-2's tensors as the reference's convert script writes a Q4_0
    file (the LM head tied to wte): 2-D weights Q4_0, the rest F32."""
    from ggml_imax_tpu_torch.quant.formats import GGMLType as T
    E, V, C = cfg.n_embd, cfg.n_vocab, cfg.n_ctx
    spec = [("model/wte", ("wte",), T.Q4_0, (E, V)),
            ("model/wpe", ("wpe",), T.F32, (E, C)),
            ("model/ln_f/g", ("ln_f_g",), T.F32, (E,)),
            ("model/ln_f/b", ("ln_f_b",), T.F32, (E,))]
    for i in range(cfg.n_layer):
        p, lp = f"model/h{i}", ("layers", i)
        for n in ("ln_1", "ln_2"):
            spec += [(f"{p}/{n}/g", lp + (f"{n}_g",), T.F32, (E,)),
                     (f"{p}/{n}/b", lp + (f"{n}_b",), T.F32, (E,))]
        for f, key, n_out, k_in in (("attn/c_attn", "attn", 3 * E, E),
                                    ("attn/c_proj", "proj", E, E),
                                    ("mlp/c_fc", "fc", 4 * E, E),
                                    ("mlp/c_proj", "out", E, 4 * E)):
            spec += [(f"{p}/{f}/w", lp + (f"{key}_w",), T.Q4_0, (k_in, n_out)),
                     (f"{p}/{f}/b", lp + (f"{key}_b",), T.F32, (n_out,))]
    return spec


def llama_spec(cfg, types):
    """LLaMA's tensors under llama.cpp's GGUF names, each 2-D weight in the
    type `types(params key, layer)` gives (q4_k_m: Q4_K_M's mix), norms
    F32."""
    from ggml_imax_tpu_torch.quant.formats import GGMLType as T
    E, V, F = cfg.n_embd, cfg.n_vocab, cfg.n_ff
    kv = cfg.n_head_kv * cfg.head_dim
    spec = [("token_embd.weight", ("tok_embd",), types("tok_embd", None),
             (E, V)),
            ("output_norm.weight", ("out_norm",), T.F32, (E,)),
            ("output.weight", ("output",), types("output", None), (E, V))]
    for i in range(cfg.n_layer):
        lp = ("layers", i)
        for name, key, ne in (("attn_norm", "attn_norm", (E,)),
                              ("attn_q", "q_w", (E, E)),
                              ("attn_k", "k_w", (E, kv)),
                              ("attn_v", "v_w", (E, kv)),
                              ("attn_output", "o_w", (E, E)),
                              ("ffn_norm", "ffn_norm", (E,)),
                              ("ffn_gate", "gate_w", (E, F)),
                              ("ffn_up", "up_w", (E, F)),
                              ("ffn_down", "down_w", (F, E))):
            t = T.F32 if len(ne) == 1 else types(key, i)
            spec.append((f"blk.{i}.{name}.weight", lp + (key,), t, ne))
    return spec


# whisper.cpp's names of a block's tensors -> params keys (an encoder
# block has the first 15, a decoder block all 24)
WHISPER_BLOCK = [("attn_ln.weight", "ln0_g"), ("attn_ln.bias", "ln0_b"),
                 ("attn.query.weight", "q_w"), ("attn.query.bias", "q_b"),
                 ("attn.key.weight", "k_w"), ("attn.value.weight", "v_w"),
                 ("attn.value.bias", "v_b"), ("attn.out.weight", "o_w"),
                 ("attn.out.bias", "o_b"), ("mlp_ln.weight", "ln1_g"),
                 ("mlp_ln.bias", "ln1_b"), ("mlp.0.weight", "mlp0_w"),
                 ("mlp.0.bias", "mlp0_b"), ("mlp.2.weight", "mlp1_w"),
                 ("mlp.2.bias", "mlp1_b")]
WHISPER_BLOCK_X = WHISPER_BLOCK + [
    ("cross_" + n, "x" + k.replace("ln0", "ln")) for n, k in WHISPER_BLOCK[:9]]


def whisper_spec(cfg, wtype):
    """Whisper's tensors as whisper.cpp's quantized files hold them: linear
    weights and the token embedding in wtype, the convolutions F16, the
    positional tables and 1-D tensors F32."""
    from ggml_imax_tpu_torch.quant.formats import GGMLType as T
    E, D, V = cfg.n_audio_state, cfg.n_text_state, cfg.n_vocab
    spec = [("encoder.positional_embedding", ("e_pe",), T.F32,
             (E, cfg.n_audio_ctx)),
            ("encoder.conv1.weight", ("e_conv1_w",), T.F16,
             (3, cfg.n_mels, E)),
            ("encoder.conv1.bias", ("e_conv1_b",), T.F32, (E,)),
            ("encoder.conv2.weight", ("e_conv2_w",), T.F16, (3, E, E)),
            ("encoder.conv2.bias", ("e_conv2_b",), T.F32, (E,)),
            ("encoder.ln_post.weight", ("e_ln_g",), T.F32, (E,)),
            ("encoder.ln_post.bias", ("e_ln_b",), T.F32, (E,)),
            ("decoder.token_embedding.weight", ("d_te",), wtype, (D, V)),
            ("decoder.positional_embedding", ("d_pe",), T.F32,
             (D, cfg.n_text_ctx)),
            ("decoder.ln.weight", ("d_ln_g",), T.F32, (D,)),
            ("decoder.ln.bias", ("d_ln_b",), T.F32, (D,))]
    for side, W_, n, block in (("encoder", E, cfg.n_audio_layer,
                                WHISPER_BLOCK),
                               ("decoder", D, cfg.n_text_layer,
                                WHISPER_BLOCK_X)):
        for i in range(n):
            lp = ("enc_layers" if side == "encoder" else "dec_layers", i)
            for name, key in block:
                ne = {"mlp.0.weight": (W_, 4 * W_), "mlp.2.weight": (4 * W_, W_),
                      "mlp.0.bias": (4 * W_,)}.get(name)
                if ne is None:
                    ne = (W_,) if name.endswith(("ln.weight", ".bias")) \
                        else (W_, W_)
                t = wtype if len(ne) == 2 else T.F32
                spec.append((f"{side}.blocks.{i}.{name}", lp + (key,), t, ne))
    return spec


def write_whisper_bin(path, cfg, filters, vocab, tensors, ftype=2008):
    """A whisper.cpp ggml .bin (whisper.cpp:1320-1750, as
    tests/test_whisper.py writes one): magic, 11 i32 hparams, the mel
    filters, the vocab, then each tensor's record, written one at a
    time."""
    import struct
    with open(path, "wb") as f:
        f.write(struct.pack("<I", 0x67676D6C))
        f.write(struct.pack("<11i", cfg.n_vocab, cfg.n_audio_ctx,
                            cfg.n_audio_state, cfg.n_audio_head,
                            cfg.n_audio_layer, cfg.n_text_ctx,
                            cfg.n_text_state, cfg.n_text_head,
                            cfg.n_text_layer, cfg.n_mels, ftype))
        f.write(struct.pack("<2i", *filters.shape))
        f.write(np.ascontiguousarray(filters, np.float32).tobytes())
        f.write(struct.pack("<i", len(vocab)))
        for tok in vocab:
            f.write(struct.pack("<I", len(tok)) + tok)
        for name, (t, ne, raw) in tensors.items():
            nb = name.encode()
            f.write(struct.pack(f"<3i{len(ne)}i", len(ne), len(nb), int(t),
                                *ne))
            f.write(nb)
            f.write(raw.data)


def leaf(params, path):
    for k in path:
        params = params[k]
    return params


def is_weight(path, ne) -> bool:
    """Whether a file tensor becomes a product's weight (laid out by
    to_device_format): every 2-D tensor but the positional tables (GPT-2's
    wpe, Whisper's e_pe and d_pe)."""
    return len(ne) == 2 and path[-1] not in ("wpe", "e_pe", "d_pe")


def check_loaded(label, params, spec, tensors, failures):
    """Every loaded tensor against the direct build of the bytes that were
    written: to_device_format on the card for a 2-D weight (field by field:
    q, scale, bias, lut, signs and the layout's tags), codecs.dequantize
    for the rest, bit for bit; then, for the first and last layer's largest
    weight, dequantize_qtensor of the loaded tensor against
    codecs.dequantize of the raw bytes, bit for bit."""
    from ggml_imax_tpu_torch.quant import codecs
    from ggml_imax_tpu_torch.quant.device import (QTensor, dequantize_qtensor,
                                                  to_device_format)
    bad, n_w, n_v = [], 0, 0
    for name, path, t, ne in spec:
        got = leaf(params, path)
        _, _, raw = tensors[name]
        if is_weight(path, ne):
            want = to_device_format(raw, t, ne, device="cuda")
            n_w += 1
            same = isinstance(got, QTensor) and all(
                getattr(got, f) == getattr(want, f)
                for f in ("kind", "k", "n", "ggml_type", "zero",
                          "interleaved_bk", "q4_layout")) and all(
                (a is None and b is None) or (
                    a is not None and b is not None and a.dtype == b.dtype
                    and a.is_cuda and torch.equal(a, b))
                for a, b in ((getattr(got, f), getattr(want, f))
                             for f in ("q", "scale", "bias", "lut", "signs")))
        else:
            want = torch.from_numpy(codecs.dequantize(
                raw, t, shape=tuple(reversed(ne)))).cuda()
            n_v += 1
            same = got.is_cuda and got.dtype == want.dtype and \
                got.numel() == want.numel() and \
                torch.equal(got, want.reshape(got.shape))
        if not same:
            bad.append(name)
    layers = [s for s in spec if is_weight(s[1], s[3])
              and "layers" in str(s[1][0])]
    firsts = [s for s in layers if s[1][1] == 0]
    lasts = [s for s in layers if s[1][1] == max(x[1][1] for x in layers)]
    dec = []
    for s in (max(firsts, key=lambda s: math.prod(s[3])),
              max(lasts, key=lambda s: math.prod(s[3]))):
        name, path, t, ne = s
        got = dequantize_qtensor(leaf(params, path)).cpu().numpy()
        want = codecs.dequantize(tensors[name][2], t,
                                 shape=(ne[1], ne[0])).T
        dec.append((name, bool(np.array_equal(got, want))))
    log(f"  {label}: loaded vs direct build, bit for bit: {n_w} 2-D weights "
        f"and {n_v} other tensors, {len(bad)} differ {bad[:4]}; "
        f"dequantize_qtensor vs codecs.dequantize of the raw bytes, equal: "
        f"{dec}")
    if bad or not all(ok for _, ok in dec):
        failures.append(f"{label}: loaded tensors differ from the direct "
                        f"build {bad[:8]}, decode check {dec}")


def write_timed(label, path, write, nbytes):
    """Check the free space, write the file, log its bytes and seconds."""
    import shutil
    free = shutil.disk_usage(path.parent).free
    if free < nbytes + (1 << 30):
        raise SystemExit(f"chip_smoke FAILED: {label}: {path.parent} has "
                         f"{free / 2**30:.2f} GiB free, the file needs "
                         f"{nbytes / 2**30:.2f} GiB + 1 GiB")
    t0 = time.time()
    write()
    secs = time.time() - t0
    size = path.stat().st_size
    log(f"  {label}: wrote {path.name}, {size} bytes ({size / 2**30:.3f} "
        f"GiB), in {secs:.2f} s")
    return size, secs


# the card's host link, PCIe Gen5 x16: the bound of a load's upload
PCIE_BYTES_S = 64e9


def load_floors(label, path):
    """Two floors of a load, each timed alone on this file: its bytes read
    into host memory (np.fromfile; a file just written is read from the
    page cache, warm) and one pageable copy of them to the card, beside the
    upload's bound (bytes / PCIE_BYTES_S). Returns (read s, upload s)."""
    t0 = time.perf_counter()
    buf = np.fromfile(path, np.uint8)
    read_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = torch.from_numpy(buf).to("cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    log(f"  {label}: the file's {buf.nbytes} bytes read (warm) in "
        f"{read_s:.3f} s, copied to the card in {upload_s:.3f} s "
        f"({buf.nbytes / upload_s / 1e9:.1f} GB/s; bound "
        f"{buf.nbytes / PCIE_BYTES_S:.3f} s at 64 GB/s)")
    del buf, on_card
    torch.cuda.empty_cache()
    return read_s, upload_s


def timed_load(label, load):
    """The loader call, synchronized, its device peak: (result, seconds)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = load()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"  {label}: loaded in {secs:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated (peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB during the "
        f"load)")
    return out, secs


def check_tokenizer(label, tok, n_vocab, failures, text=LOADER_TEXT):
    """The tokenizer's round trip on the text; its first PROMPT ids."""
    ids = tok.encode(text)
    back = tok.decode(ids)
    ok = back == text and len(ids) >= PROMPT and \
        all(0 <= i < n_vocab for i in ids)
    log(f"  {label}: tokenizer: {len(text)} characters -> {len(ids)} ids, "
        f"decode(encode(text)) == text {back == text}, every id < {n_vocab} "
        f"{all(0 <= i < n_vocab for i in ids)}; prompt: the first {PROMPT}")
    if not ok:
        failures.append(f"{label}: tokenizer round trip {back == text}, "
                        f"{len(ids)} ids")
    return ids[:PROMPT]


def loaded_request(label, eng, prompt, tok, load_s, expect, failures):
    """run_generation's path on a loaded engine: a warm-up of 2 tokens,
    then the prompt + N_PREDICT greedy tokens with fresh perf counters
    (load_us the loader's seconds) and the launch counters set to 0 just
    before and read just after; logs the text and eng.perf as the
    reference CLI prints them. Returns the request's numbers."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.runtime.engine import PerfCounters
    eng.generate(prompt, 2, temp=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng.perf = PerfCounters(load_us=load_s * 1e6)
    stamps = []
    _build.reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(prompt, N_PREDICT, temp=0,
                       callback=lambda t: stamps.append(time.perf_counter()))
    counts = dict(_build.LAUNCHES)
    ttft = (stamps[0] - t0) * 1e3
    tok_s = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {label}: TTFT {ttft:.2f} ms, decode {tok_s:.2f} tok/s "
        f"({1e3 / tok_s:.3f} ms a token), peak {peak:.3f} GiB allocated; "
        f"text {tok.decode(out)!r}")
    log(f"  {label}: load: {eng.perf.load_us / 1e3:.1f} ms")
    for line in eng.perf.report().splitlines():
        log(f"  {label}: {line}")
    log(f"  {label}: launches { {k: n for k, n in counts.items() if n} }")
    check_counts(counts, expect, failures)
    if len(out) != N_PREDICT or not all(0 <= t < eng.cfg.n_vocab for t in out):
        failures.append(f"{label}: bad tokens {out}")
    return {"ttft_ms": ttft, "decode_tok_s": tok_s, "peak_gib": peak,
            "tokens": out}, counts


def loaders_gptj(failures):
    """11a. GPT-J-6B Q4_0 .bin at GPTJ_6B's widths (n_ctx 2048, as the
    model's): written by io.legacy_bin.write_legacy_bin, gptj.load_legacy,
    Engine(residency="q4-fused") at n_ctx 512, one request."""
    from ggml_imax_tpu_torch.io.legacy_bin import write_legacy_bin
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.runtime.engine import Engine
    cfg = gptj.GPTJConfig(**dict(GPTJ_6B, n_ctx=2048))
    spec = gptj_spec(cfg)
    t0 = time.time()
    tensors = file_tensors(spec, np.random.default_rng(11))
    vocab = greedy_vocab(cfg.n_vocab)
    hp = dict(n_vocab=cfg.n_vocab, n_ctx=cfg.n_ctx, n_embd=cfg.n_embd,
              n_head=cfg.n_head, n_layer=cfg.n_layer, n_rot=cfg.n_rot,
              ftype=2002)
    log(f"  11a: {len(tensors)} tensors drawn on the host in "
        f"{time.time() - t0:.2f} s")
    path = loader_dir() / "gptj-6b-q4_0.bin"
    nbytes = sum(r.nbytes for _, _, r in tensors.values())
    size, write_s = write_timed("11a", path, lambda: write_legacy_bin(
        path, hp, gptj.HPARAM_NAMES, vocab, tensors), nbytes)
    floors = load_floors("11a", path)
    (lcfg, params, tok), load_s = timed_load(
        "11a gptj.load_legacy", lambda: gptj.load_legacy(path))
    if lcfg != cfg:
        failures.append(f"11a: config {lcfg} != {cfg}")
    check_loaded("11a", params, spec, tensors, failures)
    del tensors
    prompt = check_tokenizer("11a", tok, cfg.n_vocab, failures)
    if failures:
        return None, None, {}
    t0 = time.time()
    eng = Engine(gptj, cfg, params, n_ctx=512, residency="q4-fused")
    del params
    torch.cuda.synchronize()
    prep_s = time.time() - t0
    log(f"  11a Engine(residency='q4-fused'): prepared in {prep_s:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    L, n_dec = cfg.n_layer, N_PREDICT - 1
    out, counts = loaded_request(
        "11a", eng, prompt, tok, load_s,
        {"w4a8_gemv": n_dec * (2 * L + 1), "decode_attention": n_dec * L,
         "w4a16_gemm": 2 * L + 1, "flash_attention": L,
         "flash_backward_tiles": L}, failures)
    n = CLI_TOKENS - 1
    cli, cli_counts, _, _ = cli_generation(
        "16a gptj", "gptj", path, eng, tok, prompt, out["tokens"], 512,
        {"w4a8_gemv": n * (2 * L + 1), "decode_attention": n * L,
         "w4a16_gemm": 2 * L + 1, "flash_attention": L,
         "flash_backward_tiles": L}, failures)
    del eng
    torch.cuda.empty_cache()
    return dict(out, file_bytes=size, write_s=write_s, read_s=floors[0],
                upload_s=floors[1], load_s=load_s, prepare_s=prep_s,
                cli=cli), counts, {"cli_gptj": cli_counts}


def llama_gguf_kv(w, cfg, tokens, merges, file_type):
    """A LLaMA GGUF's metadata as llama.cpp writes it: the architecture's
    keys (u32, the epsilon and rope base f32), the file type, and the
    byte-level tokenizer's tokens and merges."""
    w.add_kv("general.architecture", "llama")
    w.add_kv("general.name", "LLaMA v2 (random weights)")
    w.add_kv("general.file_type", np.uint32(file_type))
    for k, v in (("context_length", cfg.n_ctx),
                 ("embedding_length", cfg.n_embd),
                 ("block_count", cfg.n_layer),
                 ("feed_forward_length", cfg.n_ff),
                 ("rope.dimension_count", cfg.head_dim),
                 ("attention.head_count", cfg.n_head),
                 ("attention.head_count_kv", cfg.n_head_kv)):
        w.add_kv(f"llama.{k}", np.uint32(v))
    w.add_kv("llama.attention.layer_norm_rms_epsilon",
             np.float32(cfg.rms_eps))
    w.add_kv("llama.rope.freq_base", np.float32(cfg.rope_base))
    w.add_kv("tokenizer.ggml.model", "gpt2")
    w.add_kv("tokenizer.ggml.tokens", tokens)
    w.add_kv("tokenizer.ggml.merges", merges)


def write_llama_gguf(label):
    """11b's file: LLaMA-2 7B Q4_K_M GGUF at LLAMA2_7B's widths (n_ctx 4096,
    as the model's): llama.cpp's keys and names, Q4_K_M's mix (q4_k_m), the
    byte-level vocab and merges, drawn from seed 12 and written by
    io.gguf.GGUFWriter into loader_dir(). -> (cfg, spec, tensors, path,
    bytes, write seconds)."""
    from ggml_imax_tpu_torch.io.gguf import GGUFWriter
    from ggml_imax_tpu_torch.models import llama
    # the file keeps the rms epsilon as f32, as llama.cpp's do
    cfg = llama.LlamaConfig(**dict(LLAMA2_7B, n_ctx=4096,
                                   rms_eps=float(np.float32(1e-5))))
    spec = llama_spec(cfg, q4_k_m(cfg.n_layer))
    t0 = time.time()
    tensors = file_tensors(spec, np.random.default_rng(12))
    tokens, merges = byte_level_vocab(cfg.n_vocab)
    log(f"  {label}: {len(tensors)} tensors drawn on the host, {len(merges)} "
        f"merges learned, in {time.time() - t0:.2f} s")
    path = loader_dir() / "llama-2-7b-q4_k_m.gguf"

    def write():
        w = GGUFWriter(path)
        llama_gguf_kv(w, cfg, tokens, merges, 15)          # MOSTLY_Q4_K_M
        for name, (t, ne, raw) in tensors.items():
            w.add_tensor(name, raw, t, shape=ne)
        w.write()
    nbytes = sum(r.nbytes for _, _, r in tensors.values())
    size, write_s = write_timed(label, path, write, nbytes)
    return cfg, spec, tensors, path, size, write_s


def loaders_llama(failures):
    """11b. write_llama_gguf's file, llama.load_gguf, prepared as phase 9b
    (fuse_gate_up, params_repack with bf16 scales; "q4-fused" refuses the
    mix), Engine at n_ctx 512, one request."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.runtime.engine import Engine
    cfg, spec, tensors, path, size, write_s = write_llama_gguf("11b")
    floors = load_floors("11b", path)
    (lcfg, params, tok), load_s = timed_load(
        "11b llama.load_gguf", lambda: llama.load_gguf(path))
    if lcfg != cfg:
        failures.append(f"11b: config {lcfg} != {cfg}")
    check_loaded("11b", params, spec, tensors, failures)
    del tensors
    prompt = check_tokenizer("11b", tok, cfg.n_vocab, failures)
    if failures:
        return None, None, {}
    try:
        Engine(llama, cfg, params, residency="q4-fused")
        failures.append("11b: residency 'q4-fused' took a Q4_K_M mix")
    except ValueError as e:
        log(f"  11b Engine(residency='q4-fused') refuses the mix: {e}")
    t0 = time.time()
    prepared = params_repack(llama.fuse_gate_up(params),
                             scale_dtype=torch.bfloat16)
    loaded = params                  # 16b runs the loaded layout beside 11b
    del params
    eng = Engine(llama, cfg, prepared, n_ctx=512)
    del prepared
    torch.cuda.synchronize()
    prep_s = time.time() - t0
    log(f"  11b fuse_gate_up + params_repack: prepared in {prep_s:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    L, n_dec = cfg.n_layer, N_PREDICT - 1
    out, counts = loaded_request(
        "11b", eng, prompt, tok, load_s,
        {"w4a8_gemv": n_dec * 160, "nat8_w8a8": n_dec * 33,
         "decode_attention": n_dec * L, "w4a16_gemm": 160, "nat8_w8a16": 33,
         "flash_attention": L, "flash_backward_tiles": L}, failures)
    cli, cli_counts = cli_llama(path, eng, loaded, tok, prompt,
                                out["tokens"], failures)
    del loaded
    del eng
    torch.cuda.empty_cache()
    return dict(out, file_bytes=size, write_s=write_s, read_s=floors[0],
                upload_s=floors[1], load_s=load_s, prepare_s=prep_s,
                cli=cli), counts, {"cli_llama": cli_counts}


def loaders_whisper(failures):
    """11c. Whisper small Q5_0 in whisper.cpp's layout (write_whisper_bin:
    the mel filters of audio.mel.mel_filterbank, a 50257-entry vocab that
    the loader pads to n_vocab), whisper.load_legacy, prepare_fused +
    params_repack, WhisperPipeline(cfg, params, filters, vocab) on the
    captured steps: 30 s of phase 10's audio, beam 5."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.audio.mel import mel_filterbank
    from ggml_imax_tpu_torch.audio.wav import read_wav, write_wav
    from ggml_imax_tpu_torch.models import whisper as W
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    from ggml_imax_tpu_torch.runtime.whisper_pipeline import (FullParams,
                                                              WhisperPipeline)
    cfg = W.WhisperConfig(**WHISPER_SMALL)
    spec = whisper_spec(cfg, GGMLType.Q5_0)
    t0 = time.time()
    tensors = file_tensors(spec, np.random.default_rng(13))
    filters = mel_filterbank(cfg.n_mels)
    vocab = greedy_vocab(50257)
    log(f"  11c: {len(tensors)} tensors drawn on the host in "
        f"{time.time() - t0:.2f} s")
    path = loader_dir() / "whisper-small-q5_0.bin"
    nbytes = sum(r.nbytes for _, _, r in tensors.values())
    size, write_s = write_timed("11c", path, lambda: write_whisper_bin(
        path, cfg, filters, vocab, tensors), nbytes)
    floors = load_floors("11c", path)
    (lcfg, params, lfilters, lvocab), load_s = timed_load(
        "11c whisper.load_legacy", lambda: W.load_legacy(path))
    ok = lcfg == cfg and np.array_equal(lfilters, filters) and \
        lvocab[:len(vocab)] == vocab and len(lvocab) == cfg.n_vocab
    log(f"  11c: config, mel filters and vocab (padded to {len(lvocab)}) as "
        f"written {ok}")
    if not ok:
        failures.append("11c: config, filters or vocab differ")
    check_loaded("11c", params, spec, tensors, failures)
    del tensors
    if failures:
        return None, None, {}
    t0 = time.time()
    params = params_repack(W.prepare_fused(params))
    pipe = WhisperPipeline(cfg, params, lfilters, lvocab)
    torch.cuda.synchronize()
    prep_s = time.time() - t0
    # the audio as a WAV (16-bit, read back): the same samples as 16c's CLI
    rng = np.random.default_rng(3)
    wav = loader_dir() / "whisper-30s.wav"
    write_wav(wav, (rng.standard_normal(30 * 16000) * 0.1).astype(np.float32))
    samples = read_wav(wav)
    fp = FullParams(beam_size=5, temperatures=(0.0,),
                    max_tokens=WHISPER_TOKENS)
    steps, real = [], pipe._fill

    def fill(st, nxt, n_past):
        steps.append(n_past)
        real(st, nxt, n_past)
    pipe._fill = fill
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    segs = pipe.transcribe(samples, fp)
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    del pipe._fill
    Le, Ld = cfg.n_audio_layer, cfg.n_text_layer
    windows = len(segs)
    expect = {"nat8_w8a16": windows * (6 * Le + 2 * Ld)
              + (windows + len(steps)) * 6 * Ld,
              "flash_attention": windows * (Le + 2 * Ld),
              "flash_backward_tiles": windows * Ld}
    check_counts(counts, expect, failures)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  11c WhisperPipeline: prepared in {prep_s:.2f} s; 30 s of audio "
        f"in {wall:.3f} s (RTF {30 / wall:.2f}x real time, the captured "
        f"steps' first runs and captures {pipe.capture_s:.2f} s of it), "
        f"{windows} segment(s), {len(steps)} captured beam steps, peak "
        f"{peak:.3f} GiB allocated; launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    for s in segs:
        log(f"  11c [{s.t0:6.2f} -> {s.t1:6.2f}] {s.text!r}")
    if windows != 1 or not all(0 <= t < cfg.n_vocab for s in segs
                               for t in s.tokens):
        failures.append(f"11c: {windows} segments, tokens "
                        f"{[s.tokens[:8] for s in segs]}")
    cli, cli_counts = cli_whisper(path, wav, segs, failures)
    del pipe, params
    torch.cuda.empty_cache()
    return {"file_bytes": size, "write_s": write_s, "read_s": floors[0],
            "upload_s": floors[1], "load_s": load_s, "prepare_s": prep_s,
            "wall_s": wall, "rtf": 30 / wall, "beam_steps": len(steps),
            "peak_gib": peak, "text": [s.text for s in segs], "cli": cli}, \
        counts, {"cli_whisper": cli_counts}


def loaders_gpt2(failures):
    """11d. GPT-2 117M Q4_0 .bin (the reference CI's model size), written
    by write_legacy_bin, gpt2.load_legacy, Engine(residency="q4-fused") at
    n_ctx 1024, one request."""
    from ggml_imax_tpu_torch.io.legacy_bin import write_legacy_bin
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.runtime.engine import Engine
    cfg = gpt2.GPT2Config(**GPT2_117M)
    spec = gpt2_spec(cfg)
    tensors = file_tensors(spec, np.random.default_rng(14))
    hp = dict(n_vocab=cfg.n_vocab, n_ctx=cfg.n_ctx, n_embd=cfg.n_embd,
              n_head=cfg.n_head, n_layer=cfg.n_layer, ftype=2002)
    path = loader_dir() / "gpt-2-117m-q4_0.bin"
    nbytes = sum(r.nbytes for _, _, r in tensors.values())
    size, write_s = write_timed("11d", path, lambda: write_legacy_bin(
        path, hp, gpt2.HPARAM_NAMES, greedy_vocab(cfg.n_vocab), tensors),
        nbytes)
    floors = load_floors("11d", path)
    (lcfg, params, tok), load_s = timed_load(
        "11d gpt2.load_legacy", lambda: gpt2.load_legacy(path))
    if lcfg != cfg:
        failures.append(f"11d: config {lcfg} != {cfg}")
    check_loaded("11d", params, spec, tensors, failures)
    del tensors
    prompt = check_tokenizer("11d", tok, cfg.n_vocab, failures)
    if failures:
        return None, None, {}
    t0 = time.time()
    eng = Engine(gpt2, cfg, params, n_ctx=1024, residency="q4-fused")
    del params
    torch.cuda.synchronize()
    prep_s = time.time() - t0
    L, n_dec = cfg.n_layer, N_PREDICT - 1
    out, counts = loaded_request(
        "11d", eng, prompt, tok, load_s,
        {"w4a8_gemv": n_dec * 4 * L, "w4a16_gemm": 4 * L,
         "flash_attention": L, "flash_backward_tiles": L}, failures)
    n = CLI_TOKENS - 1
    cli, cli_counts, argv, stdout = cli_generation(
        "16d gpt2", "gpt2", path, eng, tok, prompt, out["tokens"], 1024,
        {"w4a8_gemv": n * 4 * L, "w4a16_gemm": 4 * L, "flash_attention": L,
         "flash_backward_tiles": L}, failures)
    cli["module_entry"] = cli_module_entry(argv, stdout, failures)
    cli["serve"], serve_counts = cli_serve(path, eng, tok, prompt,
                                           out["tokens"], failures)
    del eng
    torch.cuda.empty_cache()
    return dict(out, file_bytes=size, write_s=write_s, read_s=floors[0],
                upload_s=floors[1], load_s=load_s, prepare_s=prep_s,
                cli=cli), counts, {"cli_gpt2": cli_counts,
                                   "cli_serve": serve_counts}


def loaders_phase(failures):
    """Phase 11: 11a-11d, each file written, loaded, checked, run by its CLI
    (16a-16d) and deleted before the next. Returns (summary, launch counts
    by run)."""
    summary, launches = {}, {}
    for key, run in (("gptj_bin", loaders_gptj), ("llama_gguf", loaders_llama),
                     ("whisper_bin", loaders_whisper),
                     ("gpt2_bin", loaders_gpt2)):
        t0 = time.time()
        try:
            out, counts, cli = run(failures)
        finally:
            for f in loader_dir().iterdir():
                f.unlink()
        log(f"  -- {key}: {time.time() - t0:.1f} s")
        if failures:
            break
        summary[key], launches[f"loaders_{key}"] = out, counts
        launches.update(cli)
    return summary, launches


def check_small_loaders(failures):
    """Phase 3's loaders: a small GPT-J Q4_0 .bin and a small LLaMA Q4_K_M
    GGUF (the phase's small widths, written by the port's writers),
    loaded on the card and on the CPU: every tensor on the card, bit-equal
    to the CPU load; then prepared (GPT-J prepare_fused, LLaMA
    fuse_gate_up, both params_repack) and held card vs CPU as
    check_small_model holds the other small models."""
    from ggml_imax_tpu_torch.io.gguf import GGUFWriter
    from ggml_imax_tpu_torch.io.legacy_bin import write_legacy_bin
    from ggml_imax_tpu_torch.models import gptj, llama
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.device import QTensor
    d = loader_dir()
    gcfg = gptj.GPTJConfig(n_vocab=512, n_ctx=256, n_embd=512, n_head=2,
                           n_layer=2, n_rot=64)
    lcfg = llama.LlamaConfig(**dict(SMALL_LLAMA, n_vocab=512))
    rng = np.random.default_rng(15)
    gpath, lpath = d / "small-gptj.bin", d / "small-llama.gguf"
    write_legacy_bin(gpath, dict(n_vocab=512, n_ctx=256, n_embd=512,
                                 n_head=2, n_layer=2, n_rot=64, ftype=2002),
                     gptj.HPARAM_NAMES, greedy_vocab(512),
                     file_tensors(gptj_spec(gcfg), rng))
    tokens, merges = byte_level_vocab(512, n_merges=64)
    w = GGUFWriter(lpath)
    w.add_kv("general.architecture", "llama")
    for k in ("context_length", "embedding_length", "block_count",
              "feed_forward_length", "attention.head_count",
              "attention.head_count_kv"):
        attr = {"context_length": "n_ctx", "embedding_length": "n_embd",
                "block_count": "n_layer", "feed_forward_length": "n_ff",
                "attention.head_count": "n_head",
                "attention.head_count_kv": "n_head_kv"}[k]
        w.add_kv(f"llama.{k}", np.uint32(getattr(lcfg, attr)))
    w.add_kv("tokenizer.ggml.tokens", tokens)
    w.add_kv("tokenizer.ggml.merges", merges)
    for name, (t, ne, raw) in file_tensors(
            llama_spec(lcfg, q4_k_m(lcfg.n_layer)), rng).items():
        w.add_tensor(name, raw, t, shape=ne)
    w.write()

    def flat(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in flat(v)]
        if isinstance(tree, list):
            return [x for v in tree for x in flat(v)]
        if isinstance(tree, QTensor):
            return [t for t in (tree.q, tree.scale, tree.bias, tree.lut,
                                tree.signs) if t is not None]
        return [] if tree is None else [tree]

    loaded = {}
    try:
        for dev in ("cuda", "cpu"):
            loaded[dev] = (gptj.load_legacy(gpath, device=dev)[1],
                           llama.load_gguf(lpath, device=dev)[1])
    finally:
        gpath.unlink()
        lpath.unlink()
    for i, label in enumerate(("GPT-J .bin", "LLaMA Q4_K_M GGUF")):
        card, cpu = flat(loaded["cuda"][i]), flat(loaded["cpu"][i])
        same = len(card) == len(cpu) and all(
            a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b)
            for a, b in zip(card, cpu))
        log(f"  small {label} loaded on the card: {len(card)} tensors, all on "
            f"the card and bit-equal to the CPU load {same}")
        if not same:
            failures.append(f"small {label}: card load differs from the CPU")
    check_small_model(failures, gptj, gcfg, [(
        "loaded .bin", lambda dev: params_repack(gptj.prepare_fused(
            loaded[dev][0], gcfg)), {})], "GPT-J")
    check_small_model(failures, llama, lcfg, [(
        "loaded GGUF", lambda dev: params_repack(llama.fuse_gate_up(
            loaded[dev][1])), {})], "LLaMA Q4_K_M", tol=ROUTE_TOL,
        relative=True)


# ---- phase 12: the quantization tools at full width (tools.quantize,
# quant.imatrix, quant.iq_encode, tools.perplexity), as a user of the
# reference runs examples/quantize.py and then examples/perplexity.py
PPL_CTX, PPL_WINDOWS = 512, 4
# 12a runs LLaMA-2 7B's widths at a quarter of its depth (8 of 32 layers;
# 16 before phase 16 joined), so the whole script, phase 16 included, stays
# inside its time limit (its host requantize, file check and F16 load scale
# with the depth)
QUANT_LLAMA = dict(LLAMA2_7B, n_layer=8)
# 12a: the Q4_0 model's mean NLL over the windows with the kernels against
# the same windows with every plain version on the card, relative. The two
# sum each product in another order (bf16 roundings of the activations
# downstream flip); the planted faults must move it past the limit. Readings
# of this script on an H100: PERF.md.
PPL_ROUTE_TOL = 1e-3
# 12b's window of T=1 steps (256 before PR 26, halved for the script's time
# limit)
QUALITY_CTX = 128
# 12b's F16 GPT-2 117M: its (tied) wte drawn at this scale gives peaked
# logits (the largest |logit| about 10), so that KL sees a fault
WTE_SCALE = 0.1


def quant_dir() -> Path:
    """The phase's files go under the checkout's git-ignored build/."""
    d = Path(__file__).resolve().parent / "build" / "quant_tools"
    d.mkdir(parents=True, exist_ok=True)
    return d


def drawn_on_card(spec, gen, scale=0.02, scales=None):
    """spec rows (name, params path, type, ne) -> name -> (type, ne, the
    bytes on the host): each tensor drawn on the card from gen, N * scale
    (scales: params key -> its own scale; + 1 for a norm's gain), cast to
    its F16 or F32 type there, then copied to the host."""
    from ggml_imax_tpu_torch.quant.formats import GGMLType as T
    out = {}
    for name, path, t, ne in spec:
        x = torch.randn(tuple(reversed(ne)), generator=gen, device="cuda") \
            * (scales or {}).get(path[-1], scale)
        if str(path[-1]).endswith(("_g", "norm")):
            x += 1.0
        x = x.half() if t == T.F16 else x.float()
        out[name] = (t, tuple(ne), x.cpu().numpy().view(np.uint8).reshape(-1))
    return out


def encoded_bytes(spec, t_to):
    """The bytes of spec's tensors once its 2-D ones are in t_to."""
    from ggml_imax_tpu_torch.quant.formats import FORMATS
    n = 0
    for _, _, t, ne in spec:
        f = FORMATS[t_to if len(ne) == 2 else t]
        n += math.prod(ne) // f.block_size * f.type_size
    return n


def text_tokens(tok, n):
    """The first n ids of LOADER_TEXT through tok, the text repeated as
    needed."""
    ids = []
    while len(ids) < n:
        ids += tok.encode(LOADER_TEXT + " ")
    return np.asarray(ids[:n], np.int64)


def same_value(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def check_requantized_gguf(label, src, dst, t_to, sampled, failures):
    """dst, requantize_gguf(src) to t_to: the file type updated and every
    other key as in src with its wire type; every 1-D tensor src's bytes;
    every 2-D weight in t_to, and the sampled ones equal to the numpy codec
    (the plain version, _QUANTIZERS) of src's tensor dequantized, bit for
    bit."""
    from ggml_imax_tpu_torch.io.gguf import GGUFReader
    from ggml_imax_tpu_torch.quant import codecs
    t0 = time.time()
    with GGUFReader(src) as a, GGUFReader(dst) as b:
        kv_ok = set(a.metadata) == set(b.metadata) and \
            b.metadata["general.file_type"] == int(t_to) and \
            a.metadata_types == b.metadata_types and all(
                same_value(v, b.metadata[k]) for k, v in a.metadata.items()
                if k != "general.file_type")
        one_d = [n for n, i in a.tensors.items() if len(i.shape) == 1]
        one_d_bad = [n for n in one_d if not np.array_equal(
            a.tensor_data(n), b.tensor_data(n))]
        types_bad = [n for n, i in b.tensors.items() if len(i.shape) == 2
                     and i.ggml_type != t_to]
        sample_bad = []
        for name in sampled:
            ia = a.tensors[name]
            x = codecs.dequantize(a.tensor_data(name), ia.ggml_type,
                                  shape=(ia.n_elements // ia.shape[0],
                                         ia.shape[0]))
            if not np.array_equal(codecs._QUANTIZERS[t_to](x).reshape(-1),
                                  b.tensor_data(name)):
                sample_bad.append(name)
    log(f"  {label}: general.file_type {int(t_to)}, every other key and "
        f"wire type kept: {kv_ok}; {len(one_d)} 1-D tensors byte for byte, "
        f"{len(one_d_bad)} differ; 2-D weights not {t_to.name}: "
        f"{types_bad[:4]}; {len(sampled)} sampled weights equal to the "
        f"numpy quantize_{t_to.name.lower()} of the dequantized source, "
        f"{len(sample_bad)} differ {sample_bad[:4]} ({time.time() - t0:.1f} "
        "s)")
    if not kv_ok or one_d_bad or types_bad or sample_bad:
        failures.append(f"{label}: keys {kv_ok}, 1-D {one_d_bad[:4]}, types "
                        f"{types_bad[:4]}, sampled {sample_bad[:4]}")


def natpair_faults():
    """12a's controls: the natpair W4A16 kernel fed each byte's two nibbles
    swapped (the two rows of a pair exchanged), and fed the Q4_0 zero point
    as a bias (levels q in [0, 15] where the layout holds q - 8)."""
    from dataclasses import replace

    from ggml_imax_tpu_torch.ops import qmm
    real = qmm.w4a16_gemm

    def swapped_nibbles(x2, qt):
        q = ((qt.q & 0x0F) << 4) | (qt.q >> 4)
        return real(x2, replace(qt, q=q.contiguous()))

    def unsigned_levels(x2, qt):
        return real(x2, replace(qt, bias=(8.0 * qt.scale.float())
                                .to(qt.scale.dtype).contiguous()))
    return {"the nibbles of each byte swapped": [(qmm, "w4a16_gemm",
                                                  swapped_nibbles)],
            "the zero point dropped": [(qmm, "w4a16_gemm", unsigned_levels)]}


def ppl_text(tok, n):
    """A text file of LOADER_TEXT's words (repeated as needed), the fewest
    to which the loaded tokenizer gives n ids or more (under n + PPL_CTX):
    tools.perplexity and the perplexity CLI score the same windows. ->
    (its first n ids, path)."""
    words = LOADER_TEXT.split()
    while len(tok.encode(" ".join(words))) < n:
        words += LOADER_TEXT.split()
    lo, hi = 1, len(words)                 # the fewest words giving n ids
    while lo < hi:
        mid = (lo + hi) // 2
        if len(tok.encode(" ".join(words[:mid]))) >= n:
            hi = mid
        else:
            lo = mid + 1
    text = " ".join(words[:lo])
    ids = tok.encode(text)
    if not n <= len(ids) < n + PPL_CTX:
        raise SystemExit(f"chip_smoke FAILED: {len(ids)} ids in the "
                         f"perplexity text, {n} wanted")
    path = quant_dir() / "perplexity-text.txt"
    path.write_text(text)
    return np.asarray(ids[:n], np.int64), path


def quantize_cli(src, dst, failures):
    """16e: examples/quantize.py src dst q4_0, the requantize step of 12a."""
    got, err, _, _, code = run_cli(
        "examples.quantize", [str(src), str(dst), "q4_0"],
        "16e quantize")
    lines = got.splitlines()
    log(f"  16e quantize: {len(lines)} tensors requantized, "
        f"{err.strip().splitlines()[-1] if err.strip() else ''}")
    if code != 0 or not lines or not err.startswith("total:"):
        failures.append(f"16e quantize: exit {code!r}, stderr {err[-200:]!r}")


def perplexity_cli(q4, text_path, rk, failures):
    """16e: examples/perplexity.py on the Q4_0 file over the text file (the
    params as loaded, as the JAX CLI runs them; the launch counts say which
    route that takes): its perplexity within PPL_ROUTE_TOL of the kernels'
    (relative, as log PPL = the mean NLL) over the same tokens."""
    got, err, counts, secs, code = run_cli(
        "examples.perplexity", ["-m", str(q4), "-f", str(text_path), "-c",
                                str(PPL_CTX)], "16e perplexity")
    m = re.search(r"^perplexity: ([0-9.]+) over (\d+) tokens$", got.strip())
    if code != 0 or not m:
        failures.append(f"16e perplexity: exit {code!r}, {got!r}")
        return {"wall_s": secs}, counts
    rel = abs(math.log(float(m[1])) - rk["nll"]) / rk["nll"]
    route = "the kernels" if counts["w4a16_gemm"] else \
        "the plain dequantize + matmul products (the loaded layout)"
    ok = rel <= PPL_ROUTE_TOL and int(m[2]) == rk["n_tokens"]
    log(f"  16e perplexity: {got.strip()!r} ({len(err.splitlines())} lines "
        f"on stderr) through {route} and flash; log PPL vs 12a's kernels' "
        f"mean NLL {rk['nll']:.8f}: rel {rel:.3e} (limit "
        f"{PPL_ROUTE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"16e perplexity: {got.strip()} vs NLL {rk['nll']}, "
                        f"rel {rel:.3e}")
    return {"wall_s": secs, "ppl": float(m[1]), "route": route,
            "rel_nll": rel}, counts


def timed_ppl(label, model, cfg, params, toks, patches=(), **kw):
    """tools.perplexity over toks with the launch counts set to 0 just
    before and read just after. -> (result, counts, seconds)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.tools.perplexity import perplexity
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with patched(patches):
        r = perplexity(model, cfg, params, toks, n_ctx=PPL_CTX, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    log(f"  {label}: PPL {r['ppl']:.6f}, mean NLL {r['nll']:.8f} over "
        f"{r['n_tokens']} tokens ({len(toks) // PPL_CTX} windows of "
        f"{PPL_CTX}), {secs:.2f} s; launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    return r, counts, secs


def quant_llama(failures):
    """12a. LLaMA-2 7B at QUANT_LLAMA's widths and depth: F16 weights drawn
    on the card (a torch.Generator, seed 25), written as a GGUF by the port's
    GGUFWriter with phase 11b's tokenizer; examples/quantize.py to Q4_0
    (16e: requantize_gguf, the C++ codecs), the file checked against the
    source; perplexity over PPL_WINDOWS windows of PPL_CTX tokens of a text
    file of LOADER_TEXT (ppl_text; the loaded tokenizer's ids) on the F16
    model (dense f32 on the card, the plain products; flash attention) and
    on the Q4_0 model prepared as phase 11b prepares its model
    (fuse_gate_up, params_repack: every product natpair W4A16), against the
    same windows on the plain versions, and with the planted faults; then
    examples/perplexity.py on the Q4_0 file and the text (16e). Returns
    (summary, launch counts by run)."""
    from ggml_imax_tpu_torch.io.gguf import GGUFWriter
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.formats import GGMLType as T
    cfg = llama.LlamaConfig(**dict(QUANT_LLAMA, n_ctx=4096,
                                   rms_eps=float(np.float32(1e-5))))
    L, W = cfg.n_layer, PPL_WINDOWS
    spec = llama_spec(cfg, lambda key, layer: T.F16)
    tokens, merges = byte_level_vocab(cfg.n_vocab)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    t0 = time.time()
    tensors = drawn_on_card(spec, gen)
    draw_s = time.time() - t0
    log(f"  12a: {len(tensors)} F16/F32 tensors drawn on the card and copied "
        f"to the host in {draw_s:.2f} s")
    f16, q4 = quant_dir() / "llama-2-7b-f16.gguf", \
        quant_dir() / "llama-2-7b-q4_0.gguf"

    def write():
        w = GGUFWriter(f16)
        llama_gguf_kv(w, cfg, tokens, merges, 1)              # MOSTLY_F16
        for name, (t, ne, raw) in tensors.items():
            w.add_tensor(name, raw, t, shape=ne)
        w.write()
    out = {"draw_s": draw_s}
    try:
        out["f16_bytes"], out["write_s"] = write_timed(
            "12a F16 GGUF", f16, write, encoded_bytes(spec, T.F16))
        del tensors
        out["q4_0_bytes"], out["requantize_s"] = write_timed(
            "12a examples/quantize.py F16 -> Q4_0 (requantize_gguf, the C++ "
            "codecs)", q4, lambda: quantize_cli(f16, q4, failures),
            encoded_bytes(spec, T.Q4_0))
        sampled = ["token_embd.weight", "output.weight"] + [
            f"blk.{i}.{n}.weight" for i in (0, L - 1)
            for n in ("attn_q", "attn_k", "attn_v", "attn_output",
                      "ffn_gate", "ffn_up", "ffn_down")]
        check_requantized_gguf("12a Q4_0 file", f16, q4, T.Q4_0, sampled,
                               failures)
        (lcfg, params, tok), out["load_f16_s"] = timed_load(
            "12a llama.load_gguf F16 (dense f32)",
            lambda: llama.load_gguf(f16))
    finally:
        f16.unlink(missing_ok=True)
    if lcfg != cfg or tok is None:
        failures.append(f"12a: config {lcfg}, tokenizer {tok}")
        return None, None
    toks, text_path = ppl_text(tok, W * PPL_CTX)
    flash = {"flash_attention": W * L, "flash_backward_tiles": W * L}
    launches = {}
    r16, launches["quant_llama_f16"], out["ppl_f16_s"] = timed_ppl(
        "12a F16 (plain products, flash)", llama, lcfg, params, toks)
    check_counts(launches["quant_llama_f16"], flash, failures)
    del params
    torch.cuda.empty_cache()
    (_, qparams, _), out["load_q4_0_s"] = timed_load(
        "12a llama.load_gguf Q4_0", lambda: llama.load_gguf(q4))
    t0 = time.time()
    prepared = params_repack(llama.fuse_gate_up(qparams))
    del qparams
    torch.cuda.synchronize()
    out["prepare_s"] = time.time() - t0
    rk, launches["quant_llama_q4_0"], out["ppl_q4_0_s"] = timed_ppl(
        "12a Q4_0 (kernels)", llama, lcfg, prepared, toks)
    check_counts(launches["quant_llama_q4_0"],
                 dict(flash, w4a16_gemm=W * (6 * L + 1)), failures)
    rp, _, _ = timed_ppl("12a Q4_0 (every plain version on the card)",
                         llama, lcfg, prepared, toks, plain_on_card())
    route = abs(rk["nll"] - rp["nll"]) / rp["nll"]
    log(f"  12a Q4_0 kernels vs plain: mean NLL {rk['nll']:.8f} vs "
        f"{rp['nll']:.8f}, rel {route:.3e} (limit {PPL_ROUTE_TOL:.0e}) "
        f"{'ok' if route <= PPL_ROUTE_TOL else 'FAIL'}")
    if route > PPL_ROUTE_TOL:
        failures.append(f"12a: Q4_0 kernel NLL {rk['nll']} vs plain "
                        f"{rp['nll']}: rel {route:.3e}")
    faults = {}
    for name, patches in natpair_faults().items():
        rf, _, _ = timed_ppl(f"12a control: {name}", llama, lcfg, prepared,
                             toks, patches)
        faults[name] = abs(rf["nll"] - rp["nll"]) / rp["nll"]
        log(f"  12a control ({name}): rel {faults[name]:.3e} -> "
            + ("caught" if faults[name] > PPL_ROUTE_TOL else "MISSED"))
        if faults[name] <= PPL_ROUTE_TOL:
            failures.append(f"12a: the planted fault ({name}) moved the NLL "
                            f"by {faults[name]:.3e} only")
    del prepared
    torch.cuda.empty_cache()
    out["cli"], launches["cli_perplexity"] = perplexity_cli(q4, text_path, rk,
                                                            failures)
    log(f"  12a PPL F16 {r16['ppl']:.6f}, Q4_0 {rk['ppl']:.6f} (delta "
        f"{rk['ppl'] - r16['ppl']:+.6f}), Q4_0 plain {rp['ppl']:.6f}; "
        "seeded random weights: not a quality measure")
    return dict(out, ppl_f16=r16["ppl"], ppl_q4_0=rk["ppl"],
                ppl_q4_0_plain=rp["ppl"], nll_f16=r16["nll"],
                nll_q4_0=rk["nll"], nll_q4_0_plain=rp["nll"],
                route_rel=route, faults_rel=faults,
                n_tokens=rk["n_tokens"]), launches


GPT2_FILE_W = {"attn_w": "attn/c_attn/w", "proj_w": "attn/c_proj/w",
               "fc_w": "mlp/c_fc/w", "out_w": "mlp/c_proj/w"}


def file_name(param_name):
    """name_params' "layers[i].attn_w" -> the file's "model/h{i}/attn/c_attn/w"
    (requantize keys its importance rows by file names)."""
    i, key = param_name[len("layers["):].split("].")
    return f"model/h{i}/{GPT2_FILE_W[key]}"


def imatrix_gpt2(cfg, params, toks, failures):
    """12b's collection: ImatrixCollector over tools.perplexity on the
    named F16 params, with gpt2.qmatmul wrapped by a recorder of the first
    and last layers' activations (f64 sums) to hold the rows to; then a
    CUDA graph capture with the collector active, which must raise.
    -> (the collector's rows by name, launch counts)."""
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.ops.qmatmul import qmatmul
    from ggml_imax_tpu_torch.quant.imatrix import ImatrixCollector, name_params
    named = name_params(params)
    L = cfg.n_layer
    watch = {f"layers[{i}].{k}" for i in (0, L - 1) for k in GPT2_FILE_W}
    sums, rows = {}, {}
    real = gpt2.qmatmul

    def recorded(x, w, **kw):
        if w.name in watch:
            xs = x.detach().reshape(-1, w.k).double()
            sums[w.name] = sums.get(w.name, 0) + xs.square().sum(0)
            rows[w.name] = rows.get(w.name, 0) + xs.shape[0]
        return real(x, w, **kw)
    with ImatrixCollector() as col:
        r, counts, secs = timed_ppl("12b imatrix: perplexity (F16, plain "
                                    "products, flash)", gpt2, cfg, named,
                                    toks, [(gpt2, "qmatmul", recorded)])
    mats = col.matrices()
    worst, bad = 0.0, []
    for name in sorted(watch):
        qt = named["layers"][int(name[7:name.index("]")])][name.split(".")[1]]
        want = (sums[name] / rows[name]).cpu().numpy()
        got = col.matrix(qt)
        err = float(np.abs(got - want).max() / np.abs(want).max())
        worst = max(worst, err)
        if err > 1e-5 or col.count(qt) != len(toks) or rows[name] != len(toks):
            bad.append((name, err, col.count(qt)))
    log(f"  12b imatrix: {len(mats)} rows ({sorted(mats)[:2]} ...), each "
        f"layer-0/{L - 1} row against the recorder's mean x^2: worst rel "
        f"{worst:.2e} (limit 1e-5), counts {len(toks)} each: "
        + ("ok" if not bad else f"FAIL {bad[:3]}"))
    if bad or len(mats) < 4 * L:
        failures.append(f"12b imatrix: {len(mats)} rows, bad {bad[:4]}")
    w = named["layers"][0]["fc_w"]
    x = torch.randn(1, w.k, device="cuda")
    refused = None
    with ImatrixCollector():
        try:
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                qmatmul(x, w)
        except RuntimeError as e:
            refused = str(e)
    torch.cuda.synchronize()
    log(f"  12b imatrix: a CUDA graph capture with the collector active "
        f"raises: {refused is not None} ({(refused or '')[:90]})")
    if refused is None:
        failures.append("12b: a capture with the collector active ran")
    return mats, counts, r, secs


def imatrix_requantize(f16, cfg, mats, failures):
    """12b's imatrix-weighted Q4_0 of the first and last layers' weights
    (requantize_legacy_bin with include and imatrix keyed by file names):
    those tensors equal quantize_rows of the dequantized source with their
    row, every other tensor is the source's bytes, and each has a lower
    importance-weighted error than plain Q4_0 of the same tensor."""
    from ggml_imax_tpu_torch.io.legacy_bin import read_legacy_bin
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.quant import codecs
    from ggml_imax_tpu_torch.quant.formats import GGMLType as T
    from ggml_imax_tpu_torch.quant.imatrix import quantize_rows
    from ggml_imax_tpu_torch.tools.quantize import requantize_legacy_bin
    L = cfg.n_layer
    imx = {file_name(k): v for k, v in mats.items() if k.startswith("layers")}
    include = (f"model/h0/*/w", f"model/h{L - 1}/*/w")
    dst = quant_dir() / "gpt-2-117m-q4_0-imatrix.bin"
    _, secs = write_timed("12b requantize_legacy_bin F16 -> Q4_0, imatrix, "
                          f"layers 0 and {L - 1}", dst,
                          lambda: requantize_legacy_bin(
                              f16, dst, T.Q4_0, gpt2.HPARAM_NAMES,
                              include=include, imatrix=imx),
                          f16.stat().st_size)
    try:
        a = read_legacy_bin(f16, gpt2.HPARAM_NAMES)
        b = read_legacy_bin(dst, gpt2.HPARAM_NAMES)
    finally:
        dst.unlink()
    t0 = time.time()
    moved = sorted(n for n in b.tensors if b.tensors[n].ggml_type == T.Q4_0)
    kept_bad = [n for n in a.tensors if n not in moved and not np.array_equal(
        a.tensors[n].data, b.tensors[n].data)]
    bad, gains = [], {}
    for n in moved:
        ta = a.tensors[n]
        x = codecs.dequantize(ta.data, ta.ggml_type,
                              shape=(math.prod(ta.shape) // ta.shape[0],
                                     ta.shape[0]))
        if not np.array_equal(quantize_rows(x, T.Q4_0, imatrix=imx[n]),
                              b.tensors[n].data):
            bad.append(n)
        werr = lambda raw: float((imx[n][None] * (codecs.dequantize(
            raw, T.Q4_0, shape=x.shape) - x) ** 2).sum())
        gains[n] = werr(b.tensors[n].data) / werr(codecs.quantize(x, T.Q4_0))
    worse = [n for n, g in gains.items() if g >= 1]
    log(f"  12b: {len(moved)} tensors quantized ({moved[:2]} ...), equal to "
        f"quantize_rows(source, Q4_0, imatrix=row): {len(bad)} differ; "
        f"{len(a.tensors) - len(moved)} kept byte for byte, {len(kept_bad)} "
        f"differ; importance-weighted error / plain Q4_0's: "
        + ", ".join(f"{n.split('/', 1)[1]} {g:.3f}" for n, g in gains.items())
        + f" ({time.time() - t0:.1f} s)")
    if len(moved) != 8 or bad or kept_bad or worse:
        failures.append(f"12b imatrix Q4_0: moved {len(moved)}, bad {bad}, "
                        f"kept {kept_bad[:4]}, not better {worse}")
    return {"imatrix_requantize_s": secs, "weighted_err_ratio": gains}


def iq_on_host(f16, mats, failures):
    """12b's IQ encoders on this machine's g++ build: the eleven cases of
    tests/fixtures/golden_iq_encode.npz equal the compiled reference's
    bytes; then layer 0's fc_w at full width (3072 rows of 768) in IQ2_XS
    with its imatrix row, laid out on the card, where qmatmul (the plain
    route: codebook layouts take no kernel) equals x @ the codec's
    dequantization of the same bytes."""
    from ggml_imax_tpu_torch.io.legacy_bin import read_legacy_bin
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.ops.qmatmul import qmatmul
    from ggml_imax_tpu_torch.quant import codecs
    from ggml_imax_tpu_torch.quant.device import to_device_format
    from ggml_imax_tpu_torch.quant.formats import GGMLType as T
    from ggml_imax_tpu_torch.quant.imatrix import quantize_rows
    from ggml_imax_tpu_torch.quant.iq_encode import quantize_iq
    t0 = time.time()
    z = np.load(Path(__file__).resolve().parent / "tests" / "fixtures"
                / "golden_iq_encode.npz")
    cases = [(k, q) for k in ("IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS",
                              "IQ3_S", "IQ1_S", "IQ1_M") for q in (True,)] \
        + [(k, False) for k in ("IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_M")]
    bad = [(k, q) for k, q in cases if not np.array_equal(
        quantize_iq(z["x"], T[k], z["qw"] if q else None).reshape(-1),
        z[f"{k.lower()}_bytes" + ("" if q else "_noqw")])]
    golden_s = time.time() - t0
    log(f"  12b IQ encoders: {len(cases)} golden cases, {len(bad)} differ "
        f"{bad} ({golden_s:.1f} s, each grid set's first use included)")
    if bad:
        failures.append(f"12b IQ golden cases differ: {bad}")
    t = read_legacy_bin(f16, gpt2.HPARAM_NAMES).tensors["model/h0/mlp/c_fc/w"]
    x = codecs.dequantize(t.data, t.ggml_type, shape=(t.shape[1], t.shape[0]))
    t0 = time.time()
    raw = quantize_rows(x, T.IQ2_XS, imatrix=mats["layers[0].fc_w"])
    enc_s = time.time() - t0
    qt = to_device_format(raw, T.IQ2_XS, t.shape, device="cuda")
    xin = torch.randn(4, qt.k, device="cuda")
    got = qmatmul(xin, qt, compute_dtype=torch.float32,
                  out_dtype=torch.float32)
    w = torch.from_numpy(codecs.dequantize(raw, T.IQ2_XS,
                                           shape=x.shape)).cuda()
    err = rel_err(got, xin @ w.T)
    log(f"  12b IQ2_XS fc_w (3072 x 768, imatrix row): encoded in "
        f"{enc_s:.1f} s ({raw.nbytes} bytes); qmatmul on the card vs x @ "
        f"the codec's dequantization: rel {err:.2e} (limit 1e-5) "
        + ("ok" if err <= 1e-5 else "FAIL"))
    if err > 1e-5:
        failures.append(f"12b IQ2_XS qmatmul rel {err:.3e}")
    return {"iq_golden_s": golden_s, "iq2_xs_encode_s": enc_s,
            "iq2_xs_rel": err}


def counted_row(cfg, prepared, toks, sim, patches=()):
    """tools/quality_kernel_row.kernel_row (a teacher-forced T=1 decode
    over the window through the kernels, bf16 KV and compute) with the
    launch counters set to 0 just before and read just after. -> (row,
    launch counts)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.tools import quality_kernel_row as qkr
    torch.cuda.synchronize()
    _build.reset_launches()
    with patched(patches):
        row = qkr.kernel_row(cfg, prepared, toks, sim)
    torch.cuda.synchronize()
    return row, dict(_build.LAUNCHES)


QUALITY_ROWS = (("Q4_0", "w4a8_gemv", "natpair W4A8"),
                ("Q4_K", "w4a8_gemv", "natpair W4A8 + affine bias"),
                ("Q5_0", "nat8_w8a8", "nat8 W8A8"))


def quality_rows(f16, cfg, toks, failures):
    """12b's W4A8 quality rows (tools/quality_kernel_row.py's row
    function, kernel_row): each format requantized from the F16 file
    without an imatrix (the C++ codecs, whole model), loaded; the window as
    one T = QUALITY_CTX forward on the plain route (the loaded layout and
    every plain version, f32 compute and KV) with set_activation_sim("w4a8"),
    and as a teacher-forced T=1 decode through the kernels after
    params_repack with bf16 scales; PPL of each, the mean KL(sim ||
    kernels) against qkr.KL_GATE; the Q4_K row again with the W4A8 kernel's
    bias term dropped, which must fail it."""
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.ops import qmatmul as qmm_mod
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.formats import GGMLType as T
    from ggml_imax_tpu_torch.tools import quality_kernel_row as qkr
    from ggml_imax_tpu_torch.tools.quantize import requantize_legacy_bin
    T_ = len(toks)
    rows, launches = {}, {}
    for fmt, kernel, family in QUALITY_ROWS:
        path = quant_dir() / f"gpt-2-117m-{fmt.lower()}.bin"
        _, req_s = write_timed(f"12b requantize_legacy_bin F16 -> {fmt}",
                               path, lambda: requantize_legacy_bin(
                                   f16, path, T[fmt], gpt2.HPARAM_NAMES),
                               f16.stat().st_size)
        try:
            _, params, _ = gpt2.load_legacy(path)
        finally:
            path.unlink()
        qmm_mod.set_activation_sim("w4a8")
        try:
            with torch.no_grad(), patched(plain_on_card()):
                sim, _ = gpt2.forward(
                    cfg, params, toks[None],
                    torch.arange(T_, device="cuda")[None],
                    gpt2.init_cache(cfg, 1, T_, torch.float32), 0,
                    compute_dtype=torch.float32)
        finally:
            qmm_mod.set_activation_sim(None)
        sim = sim[0]
        prepared = params_repack(params, scale_dtype=torch.bfloat16)
        del params
        t0 = time.time()
        ker, counts = counted_row(cfg, prepared, toks, sim)
        secs = time.time() - t0
        check_counts(counts, {kernel: T_ * 4 * cfg.n_layer}, failures)
        kl = ker["kl"]
        row = {"ppl_kernels": ker["ppl"],
               "ppl_sim": qkr.window_ppl(sim, toks), "kl": kl,
               "max_abs_logit": float(sim.abs().max()),
               "requantize_s": req_s, "decode_s": secs}
        ok = ker["pass"]
        log(f"  12b {fmt} ({family}): PPL kernels {row['ppl_kernels']:.4f}, "
            f"PPL W4A8 sim {row['ppl_sim']:.4f}, mean KL(sim || kernels) "
            f"{kl:.3e} (gate {qkr.KL_GATE:.0e}) {'PASS' if ok else 'FAIL'}; "
            f"largest |logit| {row['max_abs_logit']:.2f}; {T_} decode steps "
            f"in {secs:.2f} s, launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        if not ok:
            failures.append(f"12b {fmt}: KL {kl:.3e} >= {qkr.KL_GATE}")
        if fmt == "Q4_K":
            bad, _ = counted_row(cfg, prepared, toks, sim, dropped_bias())
            row["fault_kl"] = bad["kl"]
            caught = not bad["pass"]
            log(f"  12b {fmt} control (the W4A8 bias term dropped): KL "
                f"{row['fault_kl']:.3e} -> "
                + ("fails the gate (caught)" if caught else "MISSED"))
            if not caught:
                failures.append(f"12b: the dropped bias passed the gate "
                                f"(KL {row['fault_kl']:.3e})")
        rows[fmt], launches[f"quality_{fmt.lower()}"] = row, counts
        del prepared
        torch.cuda.empty_cache()
    return rows, launches


def quant_gpt2(failures):
    """12b. GPT-2 117M at GPT2_117M's widths (the reference's quality-row
    geometry): an F16 legacy .bin drawn on the card (wte at WTE_SCALE) and
    written by write_legacy_bin, gpt2.load_legacy (dense on the card); the
    imatrix over PPL_WINDOWS windows (imatrix_gpt2), the imatrix-weighted
    Q4_0 of two layers (imatrix_requantize), the IQ encoders
    (iq_on_host) and the W4A8 quality rows (quality_rows). Returns
    (summary, launch counts by run)."""
    from ggml_imax_tpu_torch.io.legacy_bin import write_legacy_bin
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.quant.formats import GGMLType as T
    cfg = gpt2.GPT2Config(**GPT2_117M)
    spec = [(n, p, T.F16 if len(ne) == 2 else T.F32, ne)
            for n, p, _, ne in gpt2_spec(cfg)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    tensors = drawn_on_card(spec, gen, scales={"wte": WTE_SCALE})
    hp = dict(n_vocab=cfg.n_vocab, n_ctx=cfg.n_ctx, n_embd=cfg.n_embd,
              n_head=cfg.n_head, n_layer=cfg.n_layer, ftype=1)
    f16 = quant_dir() / "gpt-2-117m-f16.bin"
    out, launches = {}, {}
    try:
        out["f16_bytes"], out["write_s"] = write_timed(
            "12b F16 .bin", f16, lambda: write_legacy_bin(
                f16, hp, gpt2.HPARAM_NAMES, greedy_vocab(cfg.n_vocab),
                tensors), encoded_bytes(spec, T.F16))
        del tensors
        (lcfg, params, tok), out["load_s"] = timed_load(
            "12b gpt2.load_legacy F16", lambda: gpt2.load_legacy(f16))
        if lcfg != cfg:
            failures.append(f"12b: config {lcfg} != {cfg}")
            return None, None
        toks = text_tokens(tok, PPL_WINDOWS * PPL_CTX)
        mats, launches["quant_gpt2_imatrix"], r, out["imatrix_s"] = \
            imatrix_gpt2(cfg, params, toks, failures)
        check_counts(launches["quant_gpt2_imatrix"],
                     {"flash_attention": PPL_WINDOWS * cfg.n_layer,
                      "flash_backward_tiles": PPL_WINDOWS * cfg.n_layer},
                     failures)
        out["ppl_f16"] = r["ppl"]
        del params
        torch.cuda.empty_cache()
        if failures:
            return None, None
        out.update(imatrix_requantize(f16, cfg, mats, failures))
        out.update(iq_on_host(f16, mats, failures))
        if failures:
            return None, None
        out["quality"], by_row = quality_rows(
            f16, cfg, torch.from_numpy(toks[:QUALITY_CTX]).cuda(), failures)
        launches.update(by_row)
    finally:
        f16.unlink(missing_ok=True)
    log("  12b: the PPLs above come from seeded random weights: a check of "
        "the method, not a quality measure")
    return out, launches


def quant_tools_phase(failures):
    """Phase 12: 12a and 12b, each file written, used and deleted in turn.
    Returns (summary, launch counts by run)."""
    summary, launches = {}, {}
    for key, run in (("llama_7b_q4_0", quant_llama),
                     ("gpt2_117m", quant_gpt2)):
        t0 = time.time()
        try:
            out, counts = run(failures)
        finally:
            for f in quant_dir().iterdir():
                f.unlink()
        log(f"  -- {key}: {time.time() - t0:.1f} s")
        if failures:
            break
        summary[key] = out
        launches.update(counts)
    return summary, launches


# ---- phase 13: Magika, YOLOv3-tiny and SAM ViT-B at full width (the
# rest of the op set's path). No TPU kernel lies on it: the products are
# dense f32 matmuls and cuDNN convolutions with TF32 off, so the launch
# counts stay 0 and each model is held to the port's own CPU pass on the
# same inputs, at the NMSE limits of tests/test_backend_ops_sweep.py's TOL
VISION_CONV_NMSE = 1e-9          # TOL["conv"]: YOLO's head maps
VISION_BLOCK_NMSE = 5e-7         # TOL["block_f32"]: SAM's embedding, masks
MAGIKA_PROB_TOL = 1e-5           # max |probability difference|
# the repo's own files, bytes as read (text, Python, a binary table, CUDA)
MAGIKA_FILES = ("README.md", "chip_smoke.py", "ROADMAP.md",
                "ggml_imax_tpu_torch/quant/iq_grids.npz",
                "ggml_imax_tpu_torch/csrc/flash_attention.cu")
YOLO_IMAGE = (3, 480, 640)
SAM_IMAGE = (720, 1280, 3)
SAM_POINT = (640, 360)           # pixel (x, y)
# the CPU pass of SAM's encoder: full width, this many layers (layer 2 is
# a global one, 0 and 1 windowed), so it stays a few seconds
SAM_CPU_LAYERS = 3


def vision_dir() -> Path:
    """The phase's files go under the checkout's git-ignored build/."""
    d = Path(__file__).resolve().parent / "build" / "vision"
    d.mkdir(parents=True, exist_ok=True)
    return d


def nmse(got, ref) -> float:
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    return float(((got - ref) ** 2).mean() / (ref * ref).mean().clamp_min(
        1e-300))


def event_ms(fn, reps):
    """(best, mean) ms of fn by CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return min(times), sum(times) / reps


def same_tree(a, b) -> bool:
    """Two params trees (dicts, lists, tensors on any device) bit-equal."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(same_tree, a, b))
    return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


def check_control(label, err, limit, failures):
    """A planted fault: its check must fail (err over the limit)."""
    caught = err > limit
    log(f"  control: {label}: NMSE {err:.3e} (limit {limit:.0e}) -> the "
        f"check {'fails, as it must' if caught else 'HOLDS'}")
    if not caught:
        failures.append(f"{label}: the planted fault passed its check "
                        f"(NMSE {err:.3e} <= {limit:.0e})")


def check_nmse(label, got, ref, limit, failures) -> float:
    err = nmse(got, ref)
    ok = err <= limit and bool(torch.isfinite(got).all())
    log(f"  {label}: NMSE {err:.3e} (limit {limit:.0e}) -> "
        f"{'holds' if ok else 'FAILS'}")
    if not ok:
        failures.append(f"{label}: NMSE {err:.3e} > {limit:.0e} or not finite")
    return err


def magika_phase(failures):
    """13a: a GGUF of the full synthetic weights, loaded on the card;
    identify on the repo's own files against the CPU pass."""
    from ggml_imax_tpu_torch.io.gguf import GGUFWriter
    from ggml_imax_tpu_torch.models import magika
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    host = magika.synthetic_params(np.random.default_rng(0), device="cpu")
    path = vision_dir() / "magika.gguf"
    w = GGUFWriter(path)
    for k, n in magika.GGUF_NAMES.items():
        w.add_tensor(n, host[k].numpy(), GGMLType.F32)
    nbytes = sum(t.numel() * 4 for t in host.values())
    write_timed("13a Magika", path, w.write, nbytes)
    params, load_s = timed_load("13a Magika GGUF", lambda: magika.load_gguf(
        path))
    cpu = magika.load_gguf(path, device="cpu")
    if not (same_tree(params, host) and same_tree(cpu, host)):
        failures.append("13a: the loaded Magika weights differ from the drawn")
    repo = Path(__file__).resolve().parent
    files = {}
    for rel in MAGIKA_FILES:
        data = (repo / rel).read_bytes()
        t0 = time.perf_counter()
        top = magika.identify(params, data)
        wall = (time.perf_counter() - t0) * 1e3
        toks = magika.file_tokens(data)[None]
        got = magika.forward(params, toks)[0].cpu()
        ref = magika.forward(cpu, toks)[0]
        err = float((got - ref).abs().max())
        # the same label at each rank, but where two of the CPU pass's
        # probabilities lie within twice the largest difference (a near-tie
        # either pass may order its own way)
        near = np.sort(ref.numpy())[::-1][:len(top) + 1]
        gaps = np.minimum(np.append(np.inf, -np.diff(near))[:-1],
                          -np.diff(near))
        ref_top = magika.identify(cpu, data)
        same = all(a == b for (a, _), (b, _), g in zip(top, ref_top, gaps)
                   if g > 2 * err)
        ok = same and err <= MAGIKA_PROB_TOL
        labels = ", ".join(f"{n} {p:.6f}" for n, p in top)
        log(f"  13a {rel} ({len(data)} bytes): {labels}; "
            f"identify {wall:.2f} ms wall; max |p card - p CPU| {err:.3e} "
            f"(limit {MAGIKA_PROB_TOL:.0e}), labels equal {same} -> "
            f"{'holds' if ok else 'FAILS'}")
        if not ok:
            failures.append(f"13a {rel}: labels equal {same}, max |dp| "
                            f"{err:.3e}")
        files[rel] = {"top": top, "max_abs_err": err, "identify_ms": wall}
    cli, cli_counts = cli_magika(path, files, failures)
    path.unlink()
    toks = np.stack([magika.file_tokens((repo / r).read_bytes())
                     for r in MAGIKA_FILES])
    best, mean = event_ms(lambda: magika.forward(params, toks), 10)
    log(f"  13a forward of {len(toks)} windows: {best:.3f} ms best, "
        f"{mean:.3f} ms mean (CUDA events)")
    return {"files": files, "load_s": load_s, "forward_ms": best,
            "forward_windows": len(toks), "cli": cli}, cli_counts


def yolo_gguf(path, host, rng):
    """A YOLOv3-tiny GGUF of `host`'s conv weights (yolov3-tiny.cpp:63-100
    names) with seeded biases and, for the layers that have one, batch-norm
    scales, rolling means and variances."""
    from ggml_imax_tpu_torch.io.gguf import GGUFWriter
    from ggml_imax_tpu_torch.models import yolo
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    w = GGUFWriter(path)
    nbytes = 0
    for i, lp in enumerate(host):
        wt = lp["w"].numpy()
        cout = wt.shape[0]
        vecs = {"biases": rng.standard_normal(cout) * 0.05}
        if yolo.LAYER_CFG[i][1]:
            vecs.update(scales=rng.uniform(0.5, 2.0, cout),
                        rolling_mean=rng.standard_normal(cout) * 0.05,
                        rolling_variance=rng.uniform(0.5, 2.0, cout))
        w.add_tensor(f"l{i}_weights", wt, GGMLType.F32)
        for name, v in vecs.items():
            w.add_tensor(f"l{i}_{name}", v.astype(np.float32), GGMLType.F32)
        nbytes += wt.nbytes + 4 * cout * len(vecs)
    return w, nbytes


def tiled_upscale(x, scale: int):
    """A planted fault: the upscale by tiling the map instead of repeating
    each element."""
    return x.repeat(1, 1, scale, scale)


def yolo_phase(failures):
    """13b: YOLOv3-tiny at the published widths (16..1024, 80 classes)
    from a GGUF with batch-norm tensors, folded at load; detect on a
    seeded image, both head maps against the CPU pass."""
    from ggml_imax_tpu_torch.models import yolo
    host = yolo.synthetic_params(np.random.default_rng(0), n_classes=80,
                                 width=16, device="cpu")
    path = vision_dir() / "yolov3-tiny.gguf"
    w, nbytes = yolo_gguf(path, host, np.random.default_rng(1))
    write_timed("13b YOLOv3-tiny", path, w.write, nbytes)
    params, load_s = timed_load("13b YOLOv3-tiny GGUF (batch norm folded)",
                                lambda: yolo.load_gguf(path))
    cpu = yolo.load_gguf(path, device="cpu")
    if not same_tree(params, cpu):
        failures.append("13b: the card's and the CPU's folded weights differ")
    n_par = sum(lp["w"].numel() + lp["b"].numel() for lp in params)
    img = np.random.default_rng(2).random(YOLO_IMAGE).astype(np.float32)
    x = yolo.letterbox(img, device="cuda")[None]
    xc = yolo.letterbox(img, device="cpu")[None]
    check_nmse("13b letterbox card vs CPU", x, xc, VISION_CONV_NMSE, failures)
    got, ref = yolo.forward(params, x), yolo.forward(cpu, xc)
    errs = [check_nmse(f"13b head{k} {tuple(g.shape)} card vs CPU", g, r,
                       VISION_CONV_NMSE, failures)
            for k, g, r in zip((16, 23), got, ref)]
    fwd_best, fwd_mean = event_ms(lambda: yolo.forward(params, x), 10)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = yolo.detect(params, img)
        walls.append((time.perf_counter() - t0) * 1e3)
    n_cls = sum(bool((d.prob > 0).any()) for d in dets)
    n_cpu = len(yolo.detect(cpu, img))
    log(f"  13b {n_par} parameters; forward {fwd_best:.3f} ms best, "
        f"{fwd_mean:.3f} ms mean (CUDA events); detect {min(walls):.1f} ms "
        f"wall best of 3 ({', '.join(f'{t:.1f}' for t in walls)}): "
        f"{len(dets)} detections ({n_cls} with a class over the threshold; "
        f"the CPU pass {n_cpu})")
    img_path = vision_dir() / "yolo-image.npy"
    np.save(img_path, img)
    cli, cli_counts = cli_yolo(path, img_path, dets, failures)
    path.unlink()
    img_path.unlink()
    with patched([(yolo, "upscale", tiled_upscale)]):
        bad = yolo.forward(params, x)[1]
    check_control("13b upscale by tile instead of repeat, head23",
                  nmse(bad, ref[1]), VISION_CONV_NMSE, failures)
    return {"params": n_par, "load_s": load_s, "head_nmse": errs,
            "forward_ms": fwd_best, "detect_ms": min(walls),
            "detections": len(dets), "detections_with_class": n_cls,
            "detections_cpu": n_cpu, "cli": cli}, cli_counts


def sam_tensors(params):
    """name -> (F32, ne, array) of a SAM params tree as the reference's
    .bin names them (tests/test_sam.py's writer)."""
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    out = {}

    def put(name, a):
        a = np.ascontiguousarray(a.cpu().numpy(), np.float32)
        out[name] = (GGMLType.F32, tuple(reversed(a.shape)), a)

    put("image_encoder.pos_embed", params["pe"])
    put("image_encoder.patch_embed.proj.weight", params["proj_w"])
    put("image_encoder.patch_embed.proj.bias", params["proj_b"])
    for j, k in enumerate(("neck_conv0", "neck_n0_g", "neck_conv1",
                           "neck_n1_g")):
        put(f"image_encoder.neck.{j}.weight", params[k])
    put("image_encoder.neck.1.bias", params["neck_n0_b"])
    put("image_encoder.neck.3.bias", params["neck_n1_b"])
    for i, lp in enumerate(params["enc_layers"]):
        pre = f"image_encoder.blocks.{i}"
        for n, k in (("norm1", "n1"), ("norm2", "n2")):
            put(f"{pre}.{n}.weight", lp[f"{k}_g"])
            put(f"{pre}.{n}.bias", lp[f"{k}_b"])
        put(f"{pre}.attn.rel_pos_w", lp["rel_w"])
        put(f"{pre}.attn.rel_pos_h", lp["rel_h"])
        for n, k in (("attn.qkv", "qkv"), ("attn.proj", "proj"),
                     ("mlp.lin1", "mlp1"), ("mlp.lin2", "mlp2")):
            put(f"{pre}.{n}.weight", lp[f"{k}_w"].T)
            put(f"{pre}.{n}.bias", lp[f"{k}_b"])
    put("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
        params["pe_gauss"])
    put("prompt_encoder.not_a_point_embed.weight", params["not_a_pt"][None])
    put("prompt_encoder.no_mask_embed.weight", params["no_mask"][None])
    for i, e in enumerate(params["pt_embd"]):
        put(f"prompt_encoder.point_embeddings.{i}.weight", e[None])
    dec = params["dec"]

    def attn(prefix, a):
        for k, n in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("o", "out_proj")):
            put(f"{prefix}.{n}.weight", a[f"{k}_w"].T)
            put(f"{prefix}.{n}.bias", a[f"{k}_b"])

    def mlp3(prefix, m):
        for j in range(3):
            put(f"{prefix}.layers.{j}.weight", m[f"w{j}"].T)
            put(f"{prefix}.layers.{j}.bias", m[f"b{j}"])

    for i, lp in enumerate(dec["layers"]):
        pre = f"mask_decoder.transformer.layers.{i}"
        attn(f"{pre}.self_attn", lp["self"])
        attn(f"{pre}.cross_attn_token_to_image", lp["t2i"])
        attn(f"{pre}.cross_attn_image_to_token", lp["i2t"])
        for j in (1, 2, 3, 4):
            put(f"{pre}.norm{j}.weight", lp[f"n{j}_g"])
            put(f"{pre}.norm{j}.bias", lp[f"n{j}_b"])
        for n, k in (("mlp.lin1", "mlp1"), ("mlp.lin2", "mlp2")):
            put(f"{pre}.{n}.weight", lp[f"{k}_w"].T)
            put(f"{pre}.{n}.bias", lp[f"{k}_b"])
    attn("mask_decoder.transformer.final_attn_token_to_image",
         dec["final_t2i"])
    put("mask_decoder.transformer.norm_final_attn.weight", dec["nf_g"])
    put("mask_decoder.transformer.norm_final_attn.bias", dec["nf_b"])
    for j, k in ((0, "up0_w"), (1, "up1_g"), (3, "up3_w")):
        put(f"mask_decoder.output_upscaling.{j}.weight", dec[k])
    for j, k in ((0, "up0_b"), (1, "up1_b"), (3, "up3_b")):
        put(f"mask_decoder.output_upscaling.{j}.bias", dec[k])
    for i, m in enumerate(dec["hyper"]):
        mlp3(f"mask_decoder.output_hypernetworks_mlps.{i}", m)
    mlp3("mask_decoder.iou_prediction_head", dec["iou"])
    put("mask_decoder.iou_token.weight", dec["iou_token"])
    put("mask_decoder.mask_tokens.weight", dec["mask_tokens"])
    return out


def swapped_rel_pos(attn, rel_w, rel_h):
    """A planted fault: add_rel_pos with rel_h and rel_w swapped."""
    from ggml_imax_tpu_torch.ops.tensor_ops import add_rel_pos
    return add_rel_pos(attn, rel_h, rel_w)


def sam_phase(failures):
    """13c: SAM ViT-B (the full SamConfig) from a legacy .bin, predict on a
    seeded 720 x 1280 image with one point; the encoder at full width and
    SAM_CPU_LAYERS layers, and the decoder on its output, against the CPU
    pass."""
    from dataclasses import replace

    from ggml_imax_tpu_torch.io.legacy_bin import write_legacy_bin
    from ggml_imax_tpu_torch.models import sam
    cfg = sam.SamConfig()
    t0 = time.time()
    host = sam.synthetic_params(cfg, np.random.default_rng(0), device="cpu")
    log(f"  13c weights drawn on the host in {time.time() - t0:.2f} s")
    tensors = sam_tensors(host)
    hp = {"n_enc_state": cfg.n_enc_state, "n_enc_layer": cfg.n_enc_layer,
          "n_enc_head": cfg.n_enc_head, "n_enc_out_chans": cfg.n_enc_out_chans,
          "n_pt_embd": cfg.n_pt_embd, "ftype": 0}
    path = vision_dir() / "sam_vit_b.bin"
    nbytes = sum(a.nbytes for _, _, a in tensors.values())
    write_timed("13c SAM ViT-B", path, lambda: write_legacy_bin(
        path, hp, sam.HPARAM_NAMES, [], tensors, has_vocab=False), nbytes)
    del tensors
    (lcfg, params), load_s = timed_load("13c SAM ViT-B .bin",
                                        lambda: sam.load_legacy(path))
    if lcfg != cfg or not same_tree(params, host):
        failures.append("13c: the loaded SAM config or weights differ from "
                        "the drawn")
    img = np.random.default_rng(3).integers(0, 256, SAM_IMAGE, dtype=np.uint8)
    x, (nh, nw) = sam.preprocess(img, cfg)
    pt01 = (np.asarray(SAM_POINT, np.float32) * (nh / SAM_IMAGE[0],
                                                 nw / SAM_IMAGE[1])
            / cfg.n_img_size)
    enc_ms = event_ms(lambda: sam.encode_image(cfg, params, x), 3)
    embd = sam.encode_image(cfg, params, x)
    sparse, dense = sam.encode_prompt(cfg, params, pt01)
    pe = sam.image_pe(cfg, params)
    dec_ms = event_ms(lambda: sam.decode_mask(cfg, params, embd, sparse,
                                              dense, pe), 5)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks, iou = sam.predict(cfg, params, img, SAM_POINT)
        walls.append((time.perf_counter() - t0) * 1e3)
    ok = masks.shape == (3,) + SAM_IMAGE[:2] and bool(np.isfinite(iou).all()) \
        and bool(torch.isfinite(embd).all())
    log(f"  13c encode {enc_ms[0]:.2f} ms best, {enc_ms[1]:.2f} ms mean of 3; "
        f"decode {dec_ms[0]:.3f} ms best, {dec_ms[1]:.3f} ms mean of 5 (CUDA "
        f"events); predict {min(walls):.1f} ms wall (best of 2); IoU "
        f"{', '.join(f'{v:.5f}' for v in iou)}; mask area "
        f"{', '.join(f'{m.mean():.4f}' for m in masks)} of the image; "
        f"shapes and values {'ok' if ok else 'WRONG'}")
    if not ok:
        failures.append("13c: predict's masks or IoUs have the wrong shape "
                        "or are not finite")
    img_path = vision_dir() / "sam-image.npy"
    np.save(img_path, img)
    cli, cli_counts = cli_sam(path, img_path, masks, iou, failures)
    path.unlink()
    img_path.unlink()
    # the card against the CPU at SAM_CPU_LAYERS encoder layers
    cfg_c = replace(cfg, n_enc_layer=SAM_CPU_LAYERS)
    card_c = dict(params, enc_layers=params["enc_layers"][:SAM_CPU_LAYERS])
    host_c = dict(host, enc_layers=host["enc_layers"][:SAM_CPU_LAYERS])
    xc, _ = sam.preprocess(img, cfg, device="cpu")
    check_nmse("13c preprocess card vs CPU", x, xc, VISION_BLOCK_NMSE,
               failures)
    t0 = time.time()
    e_cpu = sam.encode_image(cfg_c, host_c, xc)
    m_cpu, i_cpu = sam.decode_mask(cfg, host, e_cpu, sparse.cpu(),
                                   dense.cpu(), pe.cpu())
    log(f"  13c CPU pass ({SAM_CPU_LAYERS} encoder layers + decode) "
        f"{time.time() - t0:.1f} s")
    e_card = sam.encode_image(cfg_c, card_c, x)
    m_card, i_card = sam.decode_mask(cfg, params, e_card, sparse, dense, pe)
    errs = {k: check_nmse(f"13c {k} card vs CPU ({SAM_CPU_LAYERS} encoder "
                          "layers)", g, r, VISION_BLOCK_NMSE, failures)
            for k, g, r in (("embedding", e_card, e_cpu),
                            ("mask logits", m_card, m_cpu),
                            ("iou", i_card, i_cpu))}
    with patched([(sam, "add_rel_pos", swapped_rel_pos)]):
        bad = sam.encode_image(cfg_c, card_c, x)
    check_control("13c add_rel_pos with rel_h and rel_w swapped, embedding",
                  nmse(bad, e_cpu), VISION_BLOCK_NMSE, failures)
    return {"load_s": load_s, "encode_ms": enc_ms[0], "decode_ms": dec_ms[0],
            "predict_ms": min(walls), "iou": [float(v) for v in iou],
            "nmse": errs, "cli": cli}, cli_counts


def vision_phase(failures):
    """Phase 13: 13a-13c, each with the launch counters at 0 just before
    and read just after (no kernel lies on this path: they stay 0), each
    with its CLI (16f), whose run counts apart. Returns (summary, launch
    counts by run)."""
    from ggml_imax_tpu_torch import _build
    summary, launches = {}, {}
    for key, run in (("magika", magika_phase), ("yolov3_tiny", yolo_phase),
                     ("sam_vit_b", sam_phase)):
        t0 = time.time()
        _build.reset_launches()
        summary[key], launches[f"cli_{key}"] = run(failures)
        launches[f"vision_{key}"] = dict(_build.LAUNCHES)
        torch.cuda.empty_cache()
        log(f"  -- {key}: {time.time() - t0:.1f} s, kernel launches "
            f"{sum(launches[f'vision_{key}'].values())}")
        if failures:
            break
    return summary, launches


# ---- phase 14: MNIST, L-BFGS, graph export

# MNIST at its published widths (FC 784-500-10, CNN 8 and 16 channels, 10
# classes) on the JAX tests' synthetic_digits recipe (a template image per
# class plus noise 0.3, the CNN's 0.2), drawn on the card at MNIST's
# training-set size; each net trains for the JAX test's iterations at its
# learning rate and must pass its accuracy bar
MNIST_N = 60000
MNIST_TRAIN = {"fc": (150, 5e-3, 0.95), "cnn": (60, 1e-2, 0.9)}
# a subset on which the card is held to the port on the CPU: the first 5
# Adam losses, then L-BFGS's losses and evaluation counts, each difference
# relative to the CPU's loss but to no less than 1% of its first loss (the
# FC net's loss falls to ~1e-7 in 3 steps, where the two differ in the last
# digits: 5.3e-2 of the loss itself in my first card run). The two sum
# their f32 products in another order (cuBLAS / cuDNN against the host's)
MNIST_SUBSET = 512
MNIST_CPU_RTOL = 1e-4
LBFGS_ITERS = 20
# an exported model's logits against the eager forward's (the JAX test's)
EXPORT_TOL = 1e-5
# 14d: greedy steps replayed from the exported GPT-J-6B decode step
EXPORT_STEPS = 8


def export_dir() -> Path:
    """Phase 14's files go under the checkout's git-ignored build/."""
    d = Path(__file__).resolve().parent / "build" / "export"
    d.mkdir(parents=True, exist_ok=True)
    return d


def mnist_data(gen, kind, n):
    """synthetic_digits on the card: (images, labels)."""
    shape, noise = ((784,), 0.3) if kind == "fc" else ((1, 28, 28), 0.2)
    templates = torch.randn((10,) + shape, generator=gen, device="cuda")
    labels = torch.randint(0, 10, (n,), generator=gen, device="cuda")
    images = templates[labels] + noise * torch.randn(
        (n,) + shape, generator=gen, device="cuda")
    return images, labels


def counted(fwd, calls):
    """fwd, appending one to calls per call (an evaluation of the loss)."""
    def run(p, x):
        calls.append(1)
        return fwd(p, x)
    return run


def mnist_run(kind, images, labels, device, **kw):
    """mnist.train from the seed-0 draw on `device`: (params, the loss and
    the evaluations so far at each iteration, seconds, result)."""
    from ggml_imax_tpu_torch.models import mnist
    params = getattr(mnist, f"init_{kind}_params")(np.random.default_rng(0),
                                                   device=device)
    calls, seen = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, params = mnist.train(
        counted(getattr(mnist, f"{kind}_forward"), calls), params,
        images.to(device), labels.to(device),
        callback=lambda it, f: seen.append((f, len(calls))), **kw)
    torch.cuda.synchronize()
    return params, seen, time.perf_counter() - t0, res


def subset_check(label, kind, images, labels, failures, counts=False, **kw):
    """The card against the port on the CPU on the first MNIST_SUBSET
    images: every loss within MNIST_CPU_RTOL (and, with counts, the same
    evaluations at every iteration)."""
    sub = images[:MNIST_SUBSET], labels[:MNIST_SUBSET]
    card = mnist_run(kind, *sub, "cuda", **kw)[1]
    cpu = mnist_run(kind, *sub, "cpu", **kw)[1]
    floor = 1e-2 * abs(cpu[0][0])
    err = max(abs(a - b) / max(abs(b), floor)
              for (a, _), (b, _) in zip(card, cpu))
    same_n = [n for _, n in card] == [n for _, n in cpu]
    ok = len(card) == len(cpu) and err <= MNIST_CPU_RTOL and (
        same_n or not counts)
    log(f"  {label}: {len(card)} iterations on {MNIST_SUBSET} images, card "
        f"vs CPU max rel loss diff {err:.3e} (tol {MNIST_CPU_RTOL:.0e}; loss "
        f"{cpu[0][0]:.4f} -> {cpu[-1][0]:.3e})"
        + (f", evaluations equal {same_n}" if counts else "")
        + f" -> {'holds' if ok else 'FAILS'}")
    if not ok:
        failures.append(f"{label}: card vs CPU {err:.3e}, {len(card)} vs "
                        f"{len(cpu)} iterations, evaluations equal {same_n}")
    return err


def mnist_train_phase(failures, gen):
    """14a: both nets trained with Adam on MNIST_N images on the card."""
    from ggml_imax_tpu_torch.models import mnist
    out, trained = {}, {}
    for kind in ("fc", "cnn"):
        n_iter, lr, bar = MNIST_TRAIN[kind]
        images, labels = mnist_data(gen, kind, MNIST_N)
        err = subset_check(f"14a MNIST {kind} Adam", kind, images, labels,
                           failures, n_iter=5, lr=lr)
        params, seen, dt, res = mnist_run(kind, images, labels, "cuda",
                                          n_iter=n_iter, lr=lr)
        acc = mnist.accuracy(getattr(mnist, f"{kind}_forward"), params,
                             images, labels)
        ms = dt * 1e3 / len(seen)
        log(f"  14a MNIST {kind}: {len(seen)} Adam iterations ({res.name}) "
            f"on {MNIST_N} images, {ms:.3f} ms an iteration, loss "
            f"{seen[0][0]:.4f} -> {seen[-1][0]:.6f}, accuracy {acc:.4f} "
            f"(bar {bar})")
        if not acc > bar:
            failures.append(f"14a MNIST {kind}: accuracy {acc:.4f} <= {bar}")
        out[kind] = {"iterations": len(seen), "ms_per_iteration": ms,
                     "loss_first": seen[0][0], "loss_last": seen[-1][0],
                     "accuracy": acc, "subset_rel_err": err}
        trained[kind] = (params, images[:1024].clone())
        del images, labels
        torch.cuda.empty_cache()
    return out, trained


def lbfgs_phase(failures, gen):
    """14b: test_optimize.py's least squares, then MNIST FC with L-BFGS."""
    from ggml_imax_tpu_torch.optimize import default_params, opt
    rng = np.random.default_rng(1234)
    a = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    x0 = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    x_star = np.linalg.lstsq(a.numpy(), b.numpy(), rcond=None)[0]
    a, b = a.cuda(), b.cuda()
    p = default_params("lbfgs")
    res, x, ctx = opt(lambda x: torch.mean((a @ x - b) ** 2), x0.cuda(), p)
    err = float(np.abs(x.detach().cpu().numpy() - x_star).max())
    evals = [i["num_linesearch_steps"] + 1 for i in ctx.opt_state["info"]]
    log(f"  14b least squares: {res.name} in {ctx.iter} iterations, "
        f"evaluations {evals}, max |x - x*| {err:.2e} (tol 1e-3)")
    if not err <= 1e-3:
        failures.append(f"14b least squares: |x - x*| {err:.3e} > 1e-3")
    po = default_params("lbfgs")
    po.lbfgs.n_iter = LBFGS_ITERS
    images, labels = mnist_data(gen, "fc", MNIST_N)
    sub_err = subset_check("14b MNIST fc L-BFGS", "fc", images, labels,
                           failures, counts=True, params_opt=po)
    _, seen, dt, res = mnist_run("fc", images, labels, "cuda", params_opt=po)
    per_iter = np.diff([0] + [n for _, n in seen]).tolist()
    log(f"  14b MNIST fc L-BFGS on {MNIST_N} images: {len(seen)} iterations "
        f"({res.name}), loss {seen[0][0]:.4f} -> {seen[-1][0]:.3e}, "
        f"evaluations per iteration {per_iter} ({sum(per_iter)} in all), "
        f"{dt * 1e3 / sum(per_iter):.3f} ms an evaluation")
    if not seen[-1][0] < seen[0][0]:
        failures.append(f"14b MNIST fc L-BFGS: the loss did not fall "
                        f"({seen[0][0]} -> {seen[-1][0]})")
    return {"lstsq_iterations": ctx.iter, "lstsq_evaluations": evals,
            "lstsq_err": err, "mnist_iterations": len(seen),
            "mnist_evaluations": per_iter, "mnist_loss_first": seen[0][0],
            "mnist_loss_last": seen[-1][0], "subset_rel_err": sub_err,
            "ms_per_evaluation": dt * 1e3 / sum(per_iter)}


def export_mnist_phase(trained, failures):
    """14c: each trained net through export_model and load_model."""
    from ggml_imax_tpu_torch.models import mnist
    out = {}
    for kind, (params, x) in trained.items():
        path = export_dir() / f"mnist-{kind}.gitg"
        info = mnist.export_model(getattr(mnist, f"{kind}_forward"), params,
                                  x, path)
        t0 = time.perf_counter()
        run = mnist.load_model(path)
        load_s = time.perf_counter() - t0
        path.unlink()
        got = run(x)
        with torch.no_grad():
            want = getattr(mnist, f"{kind}_forward")(params, x)
        err = abs_err(got, want)
        ok = got.is_cuda and err <= EXPORT_TOL
        log(f"  14c MNIST {kind} exported at batch {x.shape[0]}: "
            f"{info['bytes']} bytes, trace {info['trace_s']:.2f} s, save "
            f"{info['save_s']:.2f} s, load {load_s:.2f} s; reloaded logits "
            f"vs eager max |diff| {err:.3e} (tol {EXPORT_TOL:.0e}) -> "
            f"{'holds' if ok else 'FAILS'}")
        if not ok:
            failures.append(f"14c MNIST {kind}: reloaded logits {err:.3e} "
                            f"from the eager forward")
        out[kind] = dict(info, load_s=load_s, max_abs_err=err)
    return out


def mnist_phase(failures):
    """Phase 14a-14c, then 16g (examples/mnist.py and examples/simple.py).
    Returns (summary, launch counts by run: no kernel lies on these paths,
    so they stay 0)."""
    from ggml_imax_tpu_torch import _build
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    launches = {}
    _build.reset_launches()
    summary, trained = mnist_train_phase(failures, gen)
    launches["mnist_train"] = dict(_build.LAUNCHES)
    _build.reset_launches()
    summary["lbfgs"] = lbfgs_phase(failures, gen)
    launches["mnist_lbfgs"] = dict(_build.LAUNCHES)
    _build.reset_launches()
    summary["export"] = export_mnist_phase(trained, failures)
    launches["mnist_export"] = dict(_build.LAUNCHES)
    summary["cli"], by_run = cli_mnist(failures)
    launches.update(by_run)
    return summary, launches


def swapped_nibbles_w4a8():
    """14d's control: natpair_faults' swapped nibbles on the W4A8 GEMV,
    the kernel the exported step's w4a8_gemv op launches."""
    from dataclasses import replace

    from ggml_imax_tpu_torch.ops import qmm
    real = qmm.w4a8_gemv

    def fault(x8, dx, qt, xs=None):
        q = ((qt.q & 0x0F) << 4) | (qt.q >> 4)
        return real(x8, dx, replace(qt, q=q.contiguous()), xs)
    return [(qmm, "w4a8_gemv", fault)]


def exported_gptj_step(cfg, params, runs, failures):
    """14d, on phase 4's prepared GPT-J-6B weights: the decode step
    exported with the kernels' ops (the weights and the KV arena are
    arguments), saved, loaded, and replayed EXPORT_STEPS greedy steps after
    the eager prefill of phase 4's first prompt, against the eager steps
    (Engine.decode_step) from the same arena. Returns (summary, the
    replay's launch counts)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.io.graph_export import (export_graph,
                                                     load_graph,
                                                     stored_tensor_bytes)
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.models.common import KVCache
    from ggml_imax_tpu_torch.runtime.engine import Engine
    _, prompts, outs, _ = runs
    eng = Engine(gptj, cfg, params, n_ctx=ENGINE_CTX)
    lg, prefilled = eng.prefill(eng.new_cache(), np.asarray([prompts[0]]))
    first, n0 = int(lg[0].argmax()), len(prompts[0])
    copy = lambda c: KVCache(c.k.clone(), c.v.clone(), heads=c.heads)
    eager, replay, faulty = prefilled, copy(prefilled), copy(prefilled)
    want, toks = [], [first]
    for i in range(EXPORT_STEPS):
        lg, eager = eng.decode_step(eager, np.asarray([toks[-1]]), n0 + i)
        want.append(torch.from_numpy(lg[0]))
        toks.append(int(lg[0].argmax()))

    def step(params, tok, pos, cache, n_past):
        return gptj.forward(cfg, params, tok, pos, cache, n_past)

    dev = lambda v: torch.tensor(v, device="cuda")
    path = export_dir() / "gptj-6b-step.gitg"
    info = export_graph(step, (params, dev([[first]]), dev([[n0]]),
                               eng.new_cache(), dev(n0)), path)
    stored = stored_tensor_bytes(path)
    t0 = time.perf_counter()
    run = load_graph(path)
    load_s = time.perf_counter() - t0
    path.unlink()

    def replayed(cache):
        logits, picks = [], [first]
        for i in range(EXPORT_STEPS):
            lg, _ = run(params, dev([[picks[-1]]]), dev([[n0 + i]]), cache,
                        dev(n0 + i))
            logits.append(lg[0, 0].cpu())
            picks.append(int(logits[-1].argmax()))
        return logits, picks

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    got, picks = replayed(replay)
    replay_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    L = cfg.n_layer
    check_counts(counts, {"w4a8_gemv": EXPORT_STEPS * (2 * L + 1),
                          "decode_attention": EXPORT_STEPS * L}, failures)
    weights = sum(t.numel() * t.element_size()
                  for t in torch.utils._pytree.tree_leaves(params)
                  if isinstance(t, torch.Tensor))
    bit_equal = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max(rel_err(g, w) for g, w in zip(got, want))
    same_arena = torch.equal(replay.k, eager.k) and torch.equal(replay.v,
                                                                eager.v)
    ref = outs[0][:EXPORT_STEPS + 1]
    log(f"  14d GPT-J-6B decode step exported: trace {info['trace_s']:.2f} "
        f"s, save {info['save_s']:.2f} s, load {load_s:.2f} s; artifact "
        f"{info['bytes']} bytes, tensors stored in it {stored} bytes "
        f"(weights passed as arguments: {weights} bytes)")
    log(f"  14d replay of {EXPORT_STEPS} greedy steps from prompt 0 ({n0} "
        f"tokens): {replay_s * 1e3 / EXPORT_STEPS:.2f} ms a step; tokens "
        f"{picks}, equal to phase 4's eager run {picks == ref} and to the "
        f"eager steps {picks == toks}; logits bit-equal {bit_equal} (max "
        f"rel diff {err:.3e}), arena bit-equal {same_arena}; launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    if not (picks == ref == toks and bit_equal and same_arena):
        failures.append(f"14d: the replayed step parts from the eager one "
                        f"(tokens {picks} vs {ref}, logits bit-equal "
                        f"{bit_equal}, max rel {err:.3e}, arena {same_arena})")
    if stored or info["bytes"] > weights / 100:
        failures.append(f"14d: the artifact stores {stored} bytes of tensors "
                        f"({info['bytes']} bytes in all)")
    with patched(swapped_nibbles_w4a8()):
        bad, bad_picks = replayed(faulty)
    bad_err = max(rel_err(g, w) for g, w in zip(bad, want))
    caught = bad_err > ROUTE_TOL or bad_picks != toks
    log(f"  control: W4A8 with each byte's nibbles swapped as the w4a8_gemv "
        f"op's CUDA implementation: max rel logit diff {bad_err:.3e}, tokens "
        f"equal {bad_picks == toks} -> the replay check "
        f"{'fails, as it must' if caught else 'HOLDS'}")
    if not caught:
        failures.append("14d: the planted W4A8 fault passed the replay check")
    del run, replay, faulty, eng
    torch.cuda.empty_cache()
    return {"trace_s": info["trace_s"], "save_s": info["save_s"],
            "load_s": load_s, "artifact_bytes": info["bytes"],
            "stored_tensor_bytes": stored, "weight_bytes": weights,
            "replay_ms_per_step": replay_s * 1e3 / EXPORT_STEPS,
            "logits_bit_equal": bit_equal, "max_rel_err": err,
            "control_rel_err": bad_err}, counts


# Phase 15: the parallel paths (parallel/tp.py, ring_attention.py,
# pipeline.py, io/sharded.py) as PARALLEL_RANKS processes that share the one
# card over gloo (NCCL refuses two ranks on one device): each rank's kernels
# at its local (sharded) shapes and the collectives in their places, held
# to the single-device runs. Its times are two processes time-sharing one
# H100, not a scaling measurement.
PARALLEL_RANKS = 2
# 15a / 15b: phase 4's first prompt, then TP_STEPS greedy steps
TP_STEPS = 8
# 15b's depth: LLaMA-2 7B's 32 layers
TP_LLAMA_LAYERS = 32
# 15c: the ring prefill's context, tp 1 x sp PARALLEL_RANKS
RING_CTX = 1024
# 15d: two stages of GPipe, each PIPE_BLOCKS GPT-J-6B MLP blocks, over
# PIPE_MICRO micro-batches of PIPE_ROWS rows
PIPE_BLOCKS, PIPE_MICRO, PIPE_ROWS = 4, 4, 128
# 15e: a Q4_K LM head (ggml ne (4096, 32000)) written by GGUFWriter, each
# rank loading its half of the rows
SHARD_NE = (4096, 32000)
# the ranks' spawn, run and check, in seconds
PARALLEL_TIMEOUT = 600
# 15a: the TP pass fed the single-device run's tokens, held to it as
# check_forced holds a pass (this share of the largest |logit|, picks equal
# but at near-ties). The two sum of_w's partials in another order, which
# flips bf16 and int8 activation roundings downstream, as phase 6's sound
# routes (up to 1.66%). Readings of this script on an H100 (PERF.md):
# sound up to 1.9% (the picks equal but at a near-tie, top-2 margin
# 0.0015, where a greedy pass parts), the planted fault (rank 1's partial
# left out of one layer's all_reduce) 20%. ROUTE_TOL lies between.
TP_TOL = ROUTE_TOL
# 15b: as 15a for LLaMA-2 7B. The structural draw's logits barely move
# (largest |logit| ~51): readings on an H100 sound 2.2e-7, the planted
# fault (gu_w's columns cut without the component order) 1.3e-4 and more.
# 5e-6 is 23x the one and 1/26 of the other.
TP_LLAMA_TOL = 5e-6
# 15c: the ring prefill's logits (share of the largest |logit|) and arena
# (of its largest |value|) against the single-device prefill (f32 ring
# attention against bf16 flash). Readings on an H100: sound 5.3-6.1e-3,
# the planted fault (kpos not rotated with its keys) 0.45-0.59. ROUTE_TOL
# is 6x the one and 1/13 of the other.
RING_TOL = ROUTE_TOL


def parallel_dir() -> Path:
    """Phase 15's file and rendezvous go under the checkout's git-ignored
    build/."""
    d = Path(__file__).resolve().parent / "build" / "parallel"
    d.mkdir(parents=True, exist_ok=True)
    return d


def first_prompt(n_vocab: int) -> list:
    """Phase 4's first request prompt (serve()'s draw) for a vocab."""
    rng = np.random.default_rng(0)
    rng.integers(0, n_vocab, PROMPT)                  # the warm-up prompt
    return [int(t) for t in rng.integers(0, n_vocab, PROMPT)]


def decode_case(ck, timer, gen, label, H, D, T):
    """Decode attention over one layer of a T-row arena at H kv heads of D,
    bf16 and q8_0, against its plain version (led), as phase 2 times it."""
    from ggml_imax_tpu_torch.models.common import init_kv_cache, update_kv
    from ggml_imax_tpu_torch.ops import decode_attention as da
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale, n_past = 1.0 / math.sqrt(D), T - 13
    visible = torch.arange(T, device="cuda")[None] <= n_past
    mask = torch.where(visible, 0.0, da.NEG)
    for kv in (torch.bfloat16, "q8_0"):
        cache = init_kv_cache(2, 1, T, H, D, kv, device="cuda")
        kk, vv = (torch.randn(1, T, H, D, generator=gen, device="cuda")
                  for _ in range(2))
        update_kv(cache, 1, kk, vv, 0)
        q = torch.randn(1, H, D, generator=gen, device="cuda")
        args = (q, cache.k[1], cache.v[1],
                None if cache.ks is None else cache.ks[1],
                None if cache.vs is None else cache.vs[1], mask, H, scale)
        kb, vb = (t.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous()
                  for t in (kk, vv))
        qb = q.to(torch.bfloat16)[:, :, None]
        elt = 2 if cache.ks is None else 1 + 4 / 32
        ck.record("decode_attention",
                  f"{label} {'bf16' if cache.ks is None else 'q8_0'} B=1 "
                  f"H={H} D={D} T={T} S={da.decode_plan(1, H, T)}",
                  da.decode_attention_kernel(*args),
                  da.decode_attention_plain(*args), 1e-2,
                  timer(lambda: da.decode_attention_kernel(*args), iters=50,
                        lead=True),
                  timer(lambda: da.decode_attention_plain(*args), iters=5,
                        lead=True),
                  timer(lambda: sdpa(qb, kb, vb,
                                     attn_mask=visible[:, None, None]),
                        iters=50, lead=True),
                  H * D * 4 + 2 * T * H * D * elt + T * 4 + H * D * 4,
                  4 * H * T * D, PEAK_BF16)
        del cache


def check_parallel_kernels(ck, timer, gen):
    """Rows 1-6 at phase 15's local shapes, each against its plain version
    and timed as phase 2 times them: GPT-J-6B tp 2 (natpair W4A8 at m 1 and
    W4A16 at the prompt's M 448 on qkvf_w 4096x14336, of_w 10240x4096 and
    the head 4096x25600; decode attention at 8 kv heads of 256 over 512
    rows; flash 448 x 512 over 8 heads of 256), LLaMA-2 7B Q4_K tp 2 (bf16
    scales and bias, the same M on qkv_w 4096x6144, o_w 2048x4096, gu_w
    4096x11008, down_w 5504x4096 and the head 4096x16000; decode attention
    at 16 kv heads of 128; flash over 16 heads of 128) and the pipeline's
    MLP blocks (W4A16 at M 128 on fc_in 4096x16384 and fc_out
    16384x4096)."""
    E, tp = GPTJ_6B["n_embd"], PARALLEL_RANKS
    for label, (K, N) in {"qkvf_w": (E, 7 * E // tp),
                          "of_w": (5 * E // tp, E),
                          "lm_head": (E, 51200 // tp)}.items():
        time_instance(ck, timer, gen, f"tp{tp} gptj {label}",
                      random_natpair(K, N, gen), (1, PROMPT))
    for label, (K, N) in {"fc_in_w": (E, 4 * E),
                          "fc_out_w": (4 * E, E)}.items():
        time_instance(ck, timer, gen, f"pipeline {label}",
                      random_natpair(K, N, gen), (PIPE_ROWS,))
    F, V = LLAMA2_7B["n_ff"], LLAMA2_7B["n_vocab"]
    for label, (K, N) in {"qkv_w": (E, 3 * E // tp), "o_w": (E // tp, E),
                          "gu_w": (E, 2 * F // tp), "down_w": (F // tp, E),
                          "output": (E, V // tp)}.items():
        time_instance(ck, timer, gen, f"tp{tp} llama {label}",
                      q4k_natpair(K, N, gen), (1, PROMPT))
    decode_case(ck, timer, gen, f"tp{tp} gptj", GPTJ_6B["n_head"] // tp, 256,
                ENGINE_CTX)
    decode_case(ck, timer, gen, f"tp{tp} llama", LLAMA2_7B["n_head"] // tp,
                128, ENGINE_CTX)
    for label, H, D in (("gptj", GPTJ_6B["n_head"] // tp, 256),
                        ("llama", LLAMA2_7B["n_head"] // tp, 128)):
        flash_case(ck, timer, gen, f"tp{tp} {label} B=1 Tq={PROMPT} "
                   f"Tk={ENGINE_CTX} H={H} D={D}", 1, PROMPT, ENGINE_CTX, H,
                   H, D, {}, timed=True, q_off=0)


def greedy_run(fwd, cache, prompt, n_steps, feed=None):
    """prompt, then n_steps decode steps through fwd(tokens, positions,
    cache, n_past) on the card, each fed the previous pick (or feed[i], a
    teacher-forced pass): (each forward's pick, its last-row logits as
    (1, V) host f32 numpy, the prefill's ms, each step's ms)."""
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = fwd(torch.tensor([prompt], device=dev),
                    torch.arange(len(prompt), device=dev)[None], cache, 0)
    toks, logs = [int(lg[0, -1].argmax())], [lg[0, -1:].float().cpu().numpy()]
    pre_ms, step_ms = (time.perf_counter() - t0) * 1e3, []
    for i in range(n_steps):
        n = len(prompt) + i
        t0 = time.perf_counter()
        fed = toks[-1] if feed is None else feed[i]
        lg, cache = fwd(torch.tensor([[fed]], device=dev),
                        torch.tensor([[n]], device=dev), cache, n)
        toks.append(int(lg[0, -1].argmax()))
        logs.append(lg[0, -1:].float().cpu().numpy())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return toks, logs, pre_ms, step_ms


def reference_tokens(rank, toks):
    """Rank 0's single-device tokens on every rank (broadcast_object_list;
    the TP passes are fed them), once the ranks meet."""
    import torch.distributed as dist
    box = [toks if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def with_launches(fn):
    """fn()'s result and the launches it made (the counters set to 0 just
    before, read just after)."""
    from ggml_imax_tpu_torch import _build
    _build.reset_launches()
    out = fn()
    return out, dict(_build.LAUNCHES)


def summed(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def skipped_all_reduce(rank: int, at: int):
    """15a's planted fault: dist.all_reduce as it is, but on rank 1 its
    at-th call sends zeros and keeps the rank's own partial (that layer's
    sum misses rank 1's part on rank 0, and rank 1 keeps only its own)."""
    import torch.distributed as dist
    real, calls = dist.all_reduce, [0]

    def all_reduce(t, *args, **kw):
        calls[0] += 1
        if rank == 1 and calls[0] == at:
            return real(torch.zeros_like(t), *args, **kw)
        return real(t, *args, **kw)
    return all_reduce


def tp_gptj_rank(rank, world):
    """15a on one rank: phase 4's GPT-J-6B draw, prepare_fused; rank 0 runs
    the single-device reference (bf16 and q8_0 arenas, greedy); each rank
    shards (shard_params_tp), frees the whole, repacks its shard and runs
    forward_tp on both arenas fed the reference's tokens (counted), then
    the planted fault."""
    import torch.distributed as dist
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.parallel import tp
    cfg = gptj.GPTJConfig(**GPTJ_6B)
    prompt = first_prompt(cfg.n_vocab)
    prepared = gptj.prepare_fused(gptj.synthetic_params_device(cfg, seed=0),
                                  cfg)
    out, kvs = {}, {"bf16": torch.bfloat16, "q8_0": "q8_0"}
    if rank == 0:
        ref = params_repack(prepared)
        for kv, dt in kvs.items():
            out["ref", kv] = greedy_run(
                lambda t, p, c, n: gptj.forward(cfg, ref, t, p, c, n),
                gptj.init_cache(cfg, dtype=dt), prompt, TP_STEPS)
        del ref
    local = params_repack(tp.shard_params_tp(prepared, cfg, rank, world))
    del prepared
    torch.cuda.empty_cache()
    feed = {kv: reference_tokens(rank, out.get(("ref", kv), [None])[0])
            for kv in kvs}
    fwd = lambda t, p, c, n: tp.forward_tp(cfg, local, t, p, c, n)
    counts = []
    for kv, dt in kvs.items():
        arena = tp.init_cache_tp(cfg, world, dtype=dt)
        dist.barrier()
        out["tp", kv], c = with_launches(lambda: greedy_run(
            fwd, arena, prompt, TP_STEPS, feed[kv]))
        counts.append(c)
    out["launches"] = summed(*counts)
    at = cfg.n_layer // 2                  # the prefill's middle layer
    with patched([(dist, "all_reduce", skipped_all_reduce(rank, at))]):
        out["fault"] = greedy_run(fwd, tp.init_cache_tp(cfg, world), prompt,
                                  TP_STEPS, feed["bf16"])
    out["local_gib"] = sum(t.numel() * t.element_size() for lp in
                           local["layers"] for w in (lp["qkvf_w"], lp["of_w"])
                           for t in (w.q, w.scale)) / 2**30
    return out


def tp_llama_rank(rank, world):
    """15b on one rank: LLaMA-2 7B's structural Q4_K draw (TP_LLAMA_LAYERS
    layers), fuse_qkv + fuse_gate_up(pad_multiple=1); rank 0 runs the
    single-device reference (greedy); each rank shards
    (shard_params_tp_llama), repacks with bf16 scales and runs
    forward_tp_llama fed the reference's tokens (counted), then the
    planted fault (gu_w cut without its component-wise order)."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.parallel import tp
    from ggml_imax_tpu_torch.parallel.sharding import COL, qtensor_piece
    cfg = llama.LlamaConfig(**dict(LLAMA2_7B, n_layer=TP_LLAMA_LAYERS))
    prompt = first_prompt(cfg.n_vocab)
    prepared = llama.fuse_gate_up(llama.fuse_qkv(
        llama.synthetic_params_device(cfg, seed=0)), pad_multiple=1)
    repack = lambda p: params_repack(p, scale_dtype=torch.bfloat16)
    import torch.distributed as dist
    out = {}
    if rank == 0:
        ref = repack(prepared)
        out["ref"] = greedy_run(
            lambda t, p, c, n: llama.forward(cfg, ref, t, p, c, n),
            llama.init_cache(cfg), prompt, TP_STEPS)
        del ref
    local = repack(tp.shard_params_tp_llama(prepared, cfg, rank, world))
    feed = reference_tokens(rank, out.get("ref", [None])[0])
    fwd = lambda prm: lambda t, p, c, n: tp.forward_tp_llama(cfg, prm, t, p,
                                                             c, n)
    dist.barrier()
    out["tp"], out["launches"] = with_launches(lambda: greedy_run(
        fwd(local), tp.init_cache_tp(cfg, world), prompt, TP_STEPS, feed))
    faulty = dict(local, layers=[
        dict(lp, gu_w=repack(qtensor_piece(full["gu_w"], COL, rank, world)))
        for lp, full in zip(local["layers"], prepared["layers"])])
    del prepared
    out["fault"] = greedy_run(fwd(faulty), tp.init_cache_tp(cfg, world),
                              prompt, TP_STEPS, feed)
    return out


def unrotated_kpos(ring_shift):
    """15c's planted fault: the ring's keys and values rotate, kpos stays
    (each rank masks the keys it receives by its own positions)."""
    return lambda tensors, group=None: \
        ring_shift(tensors[:2], group) + list(tensors[2:])


def ring_prefill_rank(rank, world):
    """15c on one rank: phase 4's GPT-J-6B weights at n_ctx RING_CTX,
    prepared and repacked whole (tp 1); the single-device prefill of a
    RING_CTX-token prompt, then forward_ring_prefill over a (tp 1, sp
    world) mesh (counted): this rank's logits rows and arena chunk against
    the reference's, then the planted fault."""
    import importlib
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.parallel import distributed as D
    from ggml_imax_tpu_torch.parallel import tp
    ra = importlib.import_module("ggml_imax_tpu_torch.parallel.ring_attention")
    cfg = gptj.GPTJConfig(**dict(GPTJ_6B, n_ctx=RING_CTX))
    params = params_repack(gptj.prepare_fused(
        gptj.synthetic_params_device(cfg, seed=0), cfg))
    toks = torch.tensor([np.random.default_rng(3).integers(
        0, cfg.n_vocab, RING_CTX).tolist()], device="cuda")
    pos = torch.arange(RING_CTX, device="cuda")[None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, arena = gptj.forward(cfg, params, toks, pos, gptj.init_cache(cfg), 0)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    mesh = D.global_mesh({"tp": 1, "sp": world}, device="cuda")
    groups = (mesh.get_group("tp"), mesh.get_group("sp"))
    s, T_loc = mesh["sp"].get_local_rank(), RING_CTX // world
    rows = slice(s * T_loc, (s + 1) * T_loc)

    def run():
        cache = tp.init_cache_ringsp(cfg, 1, world)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = tp.forward_ring_prefill(cfg, params, toks, pos, cache,
                                            *groups)
        torch.cuda.synchronize()
        return {"ms": (time.perf_counter() - t0) * 1e3,
                "logits": rel_err(lg[0], ref[0, rows]),
                "k": rel_err(cache.k, arena.k[:, :, rows]),
                "v": rel_err(cache.v, arena.v[:, :, rows]),
                "finite": bool(torch.isfinite(lg).all())}
    out, launches = with_launches(run)
    with patched([(ra, "ring_shift", unrotated_kpos(ra.ring_shift))]):
        fault = run()
    return {"run": out, "launches": launches, "fault": fault,
            "ref_ms": ref_ms, "sp_rank": s,
            "route": D.p2p_route(groups[1], "cuda")}


def mlp_block(seed):
    """A GPT-J-6B MLP block (LN, fc_in, gelu, fc_out, residual) drawn as
    gptj.synthetic_params_device draws a layer's (Q4_0, here natpair), from
    its own seed."""
    E = GPTJ_6B["n_embd"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    vec = lambda n: torch.randn(n, generator=gen, device="cuda").mul_(0.02)
    return {"ln_g": vec(E) + 1.0, "ln_b": vec(E),
            "fc_in_w": random_natpair(E, 4 * E, gen), "fc_in_b": vec(4 * E),
            "fc_out_w": random_natpair(4 * E, E, gen), "fc_out_b": vec(E)}


def mlp_stage(blocks, x):
    """A pipeline stage: its blocks in turn on x (rows, E) f32, the
    products on W4A16 (rows > 1)."""
    from ggml_imax_tpu_torch.ops.activations import gelu
    from ggml_imax_tpu_torch.ops.norms import layer_norm
    from ggml_imax_tpu_torch.ops.qmatmul import qmatmul
    mm = lambda h, w: qmatmul(h, w, out_dtype=torch.float32)
    for b in blocks:
        h = gelu(mm(layer_norm(x, b["ln_g"], b["ln_b"]), b["fc_in_w"])
                 + b["fc_in_b"])
        x = x + mm(h, b["fc_out_w"]) + b["fc_out_b"]
    return x


def pipeline_rank(rank, world):
    """15d on one rank: stage r = MLP blocks [r B, (r + 1) B) (seeds 1000 +
    block); pipeline_forward over PIPE_MICRO micro-batches of PIPE_ROWS
    (counted), against the stages run in sequence on each micro-batch in
    one process (rank 0: every block), bit for bit; then the planted fault
    (the stage order swapped)."""
    from ggml_imax_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                       stack_stage_params)
    E = GPTJ_6B["n_embd"]
    stage = lambda r: [mlp_block(1000 + r * PIPE_BLOCKS + i)
                       for i in range(PIPE_BLOCKS)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    x = torch.randn(PIPE_MICRO * PIPE_ROWS, E, generator=gen, device="cuda")
    mine = [stage(rank) if r == rank else None for r in range(world)]
    run = lambda stages: pipeline_forward(mlp_stage, stack_stage_params(
        stages), x, n_microbatch=PIPE_MICRO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, launches = with_launches(lambda: run(mine))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    swapped = [stage(world - 1 - rank) if r == rank else None
               for r in range(world)]
    fault = run(swapped)
    out = {"launches": launches, "ms": ms}
    if rank == 0:
        stages = [stage(r) for r in range(world)]
        ref = []
        for m in x.split(PIPE_ROWS):
            for st in stages:
                m = mlp_stage(st, m)
            ref.append(m)
        ref = torch.cat(ref)
        out.update(equal=bool(torch.equal(y, ref)),
                   err=rel_err(y, ref), fault_equal=bool(torch.equal(
                       fault, ref)), fault_err=rel_err(fault, ref),
                   finite=bool(torch.isfinite(y).all()))
    return out


def sharded_load_rank(rank, world, path):
    """15e on one rank: its half of the Q4_K head's rows through
    load_qtensor_sharded, against the same columns of the whole load, bit
    for bit."""
    from ggml_imax_tpu_torch.io.gguf import GGUFReader
    from ggml_imax_tpu_torch.io.sharded import load_qtensor_sharded
    from ggml_imax_tpu_torch.quant.device import to_device_format
    with GGUFReader(path) as r:
        info = r.tensors["output.weight"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        piece = load_qtensor_sharded(r, "output.weight", rank, world,
                                     device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        whole = to_device_format(r.tensor_data("output.weight"),
                                 info.ggml_type, info.shape, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    w = whole.n // world
    cols = slice(rank * w, (rank + 1) * w)
    equal = all(torch.equal(getattr(piece, f), getattr(whole, f)[:, cols])
                for f in ("q", "scale", "bias")) and \
        (piece.k, piece.n) == (whole.k, w)
    return {"equal": equal, "piece_s": t1 - t0, "whole_s": t2 - t1,
            "piece_bytes": info.nbytes // world, "bytes": info.nbytes}


def parallel_rank(rank, world, gguf_path):
    """Phase 15's rank body: a process of its own on cuda:0 in a gloo group
    of `world` ranks (parallel.distributed.spawn); 15a-15e in turn, each
    freeing its weights before the next. Returns what the parent checks
    and prints (host numbers and arrays)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.parallel import distributed as D
    _build.lib()                       # built by the parent: loaded here
    out = {"route": D.p2p_route(None, "cuda"),
           "device": torch.cuda.current_device()}
    for key, body in (("tp_gptj", tp_gptj_rank), ("tp_llama", tp_llama_rank),
                      ("ring_prefill", ring_prefill_rank),
                      ("pipeline", pipeline_rank)):
        t0 = time.time()
        out[key] = body(rank, world)
        out[key]["s"] = time.time() - t0
        torch.cuda.empty_cache()
    out["sharded_load"] = sharded_load_rank(rank, world, gguf_path)
    return out


def parallel_phase(failures):
    """15. The parallel paths on PARALLEL_RANKS gloo ranks sharing cuda:0
    (the ranks' bodies above, one spawn through parallel.distributed.spawn
    with a file:// rendezvous under build/parallel): 15a GPT-J-6B tp 2,
    15b LLaMA-2 7B tp 2, 15c the ring prefill (tp 1 x sp 2), 15d the
    pipeline, 15e load_qtensor_sharded. Returns (summary, launches by
    path, summed over the ranks)."""
    from ggml_imax_tpu_torch.io.gguf import GGUFWriter
    from ggml_imax_tpu_torch.parallel import distributed as D
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    d = parallel_dir()
    path = d / "head-q4_k.gguf"
    w = GGUFWriter(path)
    w.add_tensor("output.weight", random_raw(GGMLType.Q4_K, SHARD_NE,
                                             np.random.default_rng(15)),
                 GGMLType.Q4_K, shape=SHARD_NE)
    w.write()
    torch.cuda.empty_cache()
    t0 = time.time()
    try:
        ranks = D.spawn(parallel_rank, PARALLEL_RANKS, (str(path),),
                        rendezvous_dir=d, timeout=PARALLEL_TIMEOUT,
                        backend="gloo", device="cuda:0")
    finally:
        path.unlink(missing_ok=True)
    wall = time.time() - t0
    log(f"  backend gloo, world size {PARALLEL_RANKS}, every rank on "
        f"cuda:{ranks[0]['device']} (two processes time-sharing one H100); "
        f"all_reduce / all_gather / broadcast on CUDA tensors (gloo's CUDA "
        f"path), ring and pipeline point-to-point through "
        f"{ranks[0]['route']} tensors; spawn to the last result {wall:.1f} s")
    for key in ("tp_gptj", "tp_llama", "ring_prefill", "pipeline"):
        log(f"  {key}: ranks' seconds "
            f"{[round(r[key]['s'], 1) for r in ranks]}")
    summary, launches = {"wall_s": wall}, {}
    as_run = lambda r: (r[0], [torch.from_numpy(x) for x in r[1]])

    # 15a
    a = [r["tp_gptj"] for r in ranks]
    for kv in ("bf16", "q8_0"):
        ref, got = a[0]["ref", kv], [x["tp", kv] for x in a]
        log(f"  15a GPT-J-6B tp {PARALLEL_RANKS} {kv} arena, two processes "
            f"time-sharing one H100: prefill {[round(g[2], 2) for g in got]} "
            "ms, step median "
            f"{[round(float(np.median(g[3])), 2) for g in got]}"
            f" ms; single-device on rank 0 (rank 1 drawing beside it) "
            f"{ref[2]:.2f} ms, {float(np.median(ref[3])):.2f} ms; the "
            f"reference's tokens {ref[0]}, tp's picks fed them {got[0][0]}")
        summary[f"tp_gptj_{kv}"] = {
            "prefill_ms": [g[2] for g in got],
            "step_ms_median": [float(np.median(g[3])) for g in got],
            "ref_prefill_ms": ref[2],
            "ref_step_ms_median": float(np.median(ref[3]))}
        for rk, g in enumerate(got):
            check_forced(f"15a {kv} rank {rk}", as_run(ref), as_run(g),
                         failures, TP_TOL)
        if not all(np.array_equal(x, y) for g in got[1:]
                   for x, y in zip(got[0][1], g[1])):
            failures.append(f"15a {kv}: the ranks' logits differ")
    check_forced("15a planted fault (rank 1's partial out of all_reduce "
                 f"{GPTJ_6B['n_layer'] // 2})", as_run(a[0]["ref", "bf16"]),
                 as_run(a[0]["fault"]), failures, TP_TOL, control=True)
    log(f"  15a local qkvf_w + of_w {a[0]['local_gib']:.3f} GiB a rank")
    L = GPTJ_6B["n_layer"]
    per_run = {"w4a16_gemm": 2 * L + 1, "flash_attention": L,
               "flash_backward_tiles": L,
               "w4a8_gemv": TP_STEPS * (2 * L + 1),
               "decode_attention": TP_STEPS * L}
    for x in a:
        check_counts(x["launches"], {k: 2 * n for k, n in per_run.items()},
                     failures)
    launches["tp_gptj"] = summed(*[x["launches"] for x in a])

    # 15b
    b = [r["tp_llama"] for r in ranks]
    got = [x["tp"] for x in b]
    log(f"  15b LLaMA-2 7B Q4_K tp {PARALLEL_RANKS}, {TP_LLAMA_LAYERS} "
        f"layers, two processes time-sharing one H100: prefill "
        f"{[round(g[2], 2) for g in got]} ms, step median "
        f"{[round(float(np.median(g[3])), 2) for g in got]} ms; "
        f"single-device {b[0]['ref'][2]:.2f} ms, "
        f"{float(np.median(b[0]['ref'][3])):.2f} ms; the reference's tokens "
        f"{b[0]['ref'][0]}, tp's picks fed them {got[0][0]}")
    summary["tp_llama"] = {
        "layers": TP_LLAMA_LAYERS, "prefill_ms": [g[2] for g in got],
        "step_ms_median": [float(np.median(g[3])) for g in got],
        "ref_prefill_ms": b[0]["ref"][2],
        "ref_step_ms_median": float(np.median(b[0]["ref"][3]))}
    for rk, g in enumerate(got):
        check_forced(f"15b rank {rk}", as_run(b[0]["ref"]), as_run(g),
                     failures, TP_LLAMA_TOL)
    if not all(np.array_equal(x, y) for g in got[1:]
               for x, y in zip(got[0][1], g[1])):
        failures.append("15b: the ranks' logits differ")
    check_forced("15b planted fault (gu_w cut without its component order)",
                 as_run(b[0]["ref"]), as_run(b[0]["fault"]), failures,
                 TP_LLAMA_TOL, control=True)
    L = TP_LLAMA_LAYERS
    for x in b:
        check_counts(x["launches"], {
            "w4a16_gemm": 4 * L + 1, "flash_attention": L,
            "flash_backward_tiles": L, "w4a8_gemv": TP_STEPS * (4 * L + 1),
            "decode_attention": TP_STEPS * L}, failures)
    launches["tp_llama"] = summed(*[x["launches"] for x in b])

    # 15c
    c = [r["ring_prefill"] for r in ranks]
    for x in c:
        run, fault = x["run"], x["fault"]
        ok = run["finite"] and max(run["logits"], run["k"], run["v"]) \
            <= RING_TOL
        caught = fault["logits"] > RING_TOL
        log(f"  15c ring prefill sp rank {x['sp_rank']} "
            f"({RING_CTX // PARALLEL_RANKS} of {RING_CTX} tokens, p2p "
            f"through {x['route']} tensors): "
            f"logits {run['logits']:.3e}, arena k {run['k']:.3e} v "
            f"{run['v']:.3e} of the largest |value| (limit {RING_TOL:.1e}) -> "
            f"{'holds' if ok else 'fails'}; planted fault (kpos not rotated) "
            f"logits {fault['logits']:.3e}, k {fault['k']:.3e} -> "
            f"{'caught' if caught else 'MISSED'}; ring {run['ms']:.1f} ms "
            f"(two processes time-sharing one H100), single-device prefill "
            f"{x['ref_ms']:.1f} ms")
        if not ok:
            failures.append(f"15c sp rank {x['sp_rank']}: ring prefill "
                            f"{run} past {RING_TOL}")
        if not caught:
            failures.append(f"15c sp rank {x['sp_rank']}: the planted fault "
                            f"passed ({fault['logits']:.3e})")
        check_counts(x["launches"], {"w4a16_gemm": 2 * GPTJ_6B["n_layer"]
                                     + 1}, failures)
    summary["ring_prefill"] = {"ms": [x["run"]["ms"] for x in c],
                               "ref_ms": [x["ref_ms"] for x in c],
                               "err": [x["run"] for x in c]}
    launches["ring_prefill"] = summed(*[x["launches"] for x in c])

    # 15d
    p = [r["pipeline"] for r in ranks]
    log(f"  15d pipeline, {PARALLEL_RANKS} stages x {PIPE_BLOCKS} MLP blocks, "
        f"{PIPE_MICRO} micro-batches of {PIPE_ROWS} rows: bit-equal to the "
        f"stages in sequence {p[0]['equal']} (max rel {p[0]['err']:.1e}); "
        f"planted fault (stage order swapped) equal {p[0]['fault_equal']} "
        f"(max rel {p[0]['fault_err']:.3e}); {[round(x['ms'], 1) for x in p]}"
        " ms (two processes time-sharing one H100)")
    if not (p[0]["equal"] and p[0]["finite"]):
        failures.append(f"15d: the pipeline differs from the stages in "
                        f"sequence ({p[0]['err']:.3e})")
    if p[0]["fault_equal"]:
        failures.append("15d: the swapped stages passed the check")
    for x in p:
        check_counts(x["launches"], {"w4a16_gemm": 2 * PIPE_BLOCKS
                                     * PIPE_MICRO}, failures)
    summary["pipeline"] = {"ms": [x["ms"] for x in p]}
    launches["pipeline"] = summed(*[x["launches"] for x in p])

    # 15e
    e = [r["sharded_load"] for r in ranks]
    log(f"  15e load_qtensor_sharded Q4_K {SHARD_NE}: each rank's half "
        f"bit-equal to the whole load's columns {[x['equal'] for x in e]}; "
        f"{e[0]['piece_bytes']} of {e[0]['bytes']} bytes a rank, piece "
        f"{[round(x['piece_s'], 3) for x in e]} s, whole "
        f"{[round(x['whole_s'], 3) for x in e]} s (warm file)")
    if not all(x["equal"] for x in e):
        failures.append("15e: a rank's piece differs from the whole load")
    summary["sharded_load"] = e
    return summary, launches


# ---- phase 16: the entry points. Each example CLI (ggml_imax_tpu_torch/
# examples/) runs through its main(argv) in this process, stdout captured,
# where its phase already has its file (16a-16g inside phases 11-14), held
# to that phase's own result; 16h serve --bench and 16i the quality gate run
# after phase 15. Their launch counts go on the kernels line as cli_*.
# greedy tokens of the generation CLIs (16a, 16b, 16d)
CLI_TOKENS = 8
# 16d's one subprocess run of `python -m ggml_imax_tpu_torch.examples.gpt2`
CLI_TIMEOUT = 300
# 16b and 16d's serve run the loaded layout (dequantize + matmul products),
# a graph other than their phase's prepared engine. 16d's is held to 11d's
# engine fed its picks at ROUTE_TOL. 16b's parts from 11b's engine at one
# forward by ~2x the largest |logit| on this file: there the logits' sign
# rests on a sum near zero, which the bf16 roundings of the loaded layout
# flip against both graphs' f32 passes (PERF.md, `chip_smoke.py
# --llama-graphs`). So it is held to its own graph with every plain
# version on the card, fed its picks, at ROUTE_TOL.
# the kernels an entry point's run must launch (PERF.md's rows 1, 3, 5, 6,
# 7, 9, 14, 16 and 17)
CLI_KERNELS = ("w4a8_gemv", "w4a16_gemm", "decode_attention",
               "flash_attention", "nat8_w8a8", "nat8_w8a16",
               "decode_attention_cells", "flash_backward_dq",
               "flash_backward_dkv")
# 16h: examples/serve.py --bench --steady at its default GPT-J-6B geometry
SERVE_BENCH_ARGV = ["--bench", "--steady", "-np", "8", "--n_predict", "64"]
# the keys of the JAX package's examples/serve.py --bench --steady line
SERVE_BENCH_KEYS = ("metric", "value", "unit", "n_requests", "generated",
                    "p50_ttft_ms", "chunk", "wall_s", "steady_tok_s",
                    "steady_generated", "n_predict")


def shown(a: str) -> str:
    return a if len(a) <= 60 else f"{a[:40]!r}... ({len(a)} characters)"


def run_cli(module, argv, label, patches=()):
    """ggml_imax_tpu_torch.<module>.main(argv) in this process, its stdout
    and stderr captured, the launch counters set to 0 just before and read
    just after. -> (stdout, stderr, launch counts, seconds, exit code:
    main's return value or SystemExit's code)."""
    import importlib
    import io
    from ggml_imax_tpu_torch import _build
    mod = importlib.import_module(f"ggml_imax_tpu_torch.{module}")
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            patched(patches):
        try:
            code = mod.main(list(argv))
        except SystemExit as e:
            code = e.code
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    log(f"  {label}: python -m ggml_imax_tpu_torch.{module} "
        f"{' '.join(shown(str(a)) for a in argv)}: exit {code!r}, "
        f"{secs:.2f} s; launches { {k: n for k, n in counts.items() if n} }")
    return out.getvalue(), err.getvalue(), counts, secs, code


def cli_prompt(tok, prompt):
    """The text of the phase's prompt ids and whether it encodes back to
    them."""
    text = tok.decode(prompt)
    return text, tok.encode(text) == list(prompt)


def cli_generation(label, module, path, eng, tok, prompt, out, n_ctx, expect,
                   failures):
    """16a / 16d: examples.<module> at its default residency ("q4-fused",
    the phase engine's graph) on the phase's file, greedy, CLI_TOKENS
    tokens, n_ctx as the phase's engine: stdout must be the prompt's text,
    then tok.decode of each of the phase's greedy tokens (the phase engine's
    run of the re-encoded prompt where the text does not encode back to the
    phase's ids). -> (summary, launch counts, argv, stdout)."""
    text, same_ids = cli_prompt(tok, prompt)
    ref = list(out[:CLI_TOKENS]) if same_ids else \
        eng.generate(tok.encode(text), CLI_TOKENS, temp=0)
    argv = ["-m", str(path), "-p", text, "-n", str(CLI_TOKENS), "--temp", "0",
            "-s", "0", "-c", str(n_ctx)]
    got, err, counts, secs, code = run_cli(f"examples.{module}", argv, label)
    want = text + "".join(tok.decode([t]) for t in ref) + "\n"
    ok = code == 0 and got == want
    log(f"  {label}: the prompt's text encodes back to the phase's ids "
        f"{same_ids}; stdout is the prompt + tok.decode of the phase's "
        f"{CLI_TOKENS} greedy tokens: {ok} (generated "
        f"{got[len(text):].strip()!r})")
    for line in err.splitlines():
        if line.startswith(("prefill", "decode")):
            log(f"  {label}: {line}")
    if not ok:
        failures.append(f"{label}: exit {code!r}, stdout {got[-200:]!r} vs "
                        f"{want[-200:]!r}")
    check_counts(counts, expect, failures)
    return {"wall_s": secs, "stdout_equal": ok}, counts, argv, got


def forced_engine(eng, ids, picks):
    """The phase's engine teacher-forced: prefill of ids, then a decode step
    of each pick but the last. -> (its picks, logits per forward)."""
    lg, cache = eng.prefill(eng.new_cache(), np.asarray([ids]))
    logs = [torch.from_numpy(lg)]
    for i, t in enumerate(picks[:-1]):
        lg, cache = eng.decode_step(cache, np.asarray([t]), len(ids) + i)
        logs.append(torch.from_numpy(lg))
    return [int(x[0].argmax()) for x in logs], logs


def engine_recorder(logs):
    """Patches recording the logits each Engine.prefill / decode_step
    returns (a CLI's run_generation), on the host."""
    from ggml_imax_tpu_torch.runtime.engine import Engine
    prefill, step = Engine.prefill, Engine.decode_step

    def rec_prefill(self, cache, tokens, n_past=0):
        lg, cache = prefill(self, cache, tokens, n_past)
        logs.append(torch.from_numpy(lg.copy()))
        return lg, cache

    def rec_step(self, cache, token_ids, n_past):
        lg, cache = step(self, cache, token_ids, n_past)
        logs.append(torch.from_numpy(lg.copy()))
        return lg, cache
    return [(Engine, "prefill", rec_prefill), (Engine, "decode_step",
                                                 rec_step)]


def cli_llama(path, eng, params, tok, prompt, out, failures):
    """16b on 11b's Q4_K_M GGUF: the default residency must exit nonzero
    with one line naming the type mix and "--resident as-is"; then the CLI
    at --resident as-is (the loaded layout: dequantize + matmul products,
    the attention kernels), its logits recorded, and the loaded params
    (`params`) with every plain version on the card fed its picks within
    ROUTE_TOL of the largest |logit| (check_forced). Its text against
    tok.decode of 11b's tokens is logged: 11b's engine is another route.
    -> (summary, counts)."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.runtime.engine import Engine
    text, same_ids = cli_prompt(tok, prompt)
    argv = ["-m", str(path), "-p", text, "-n", str(CLI_TOKENS), "--temp", "0",
            "-s", "0", "-c", "512"]
    _, _, _, refuse_s, code = run_cli("examples.llama", argv,
                                      "16b llama (default --resident)")
    msg = str(code)
    refused = code not in (0, None) and "\n" not in msg and \
        "--resident as-is" in msg and "Q6_K" in msg
    log(f"  16b: the default residency exits with {msg!r} -> "
        + ("refused, one line" if refused else "NOT REFUSED AS IT MUST"))
    if not refused:
        failures.append(f"16b: the default residency gave {msg!r}")
    logs = []
    got, err, counts, secs, code = run_cli(
        "examples.llama", argv + ["--resident", "as-is"],
        "16b llama --resident as-is", engine_recorder(logs))
    picks = [int(x[0].argmax()) for x in logs]
    ok = code == 0 and got == text + "".join(tok.decode([t])
                                             for t in picks) + "\n"
    if not ok:
        failures.append(f"16b: exit {code!r}, stdout {got[-200:]!r}")
    with patched(plain_on_card()):
        plain = forced_engine(Engine(llama, eng.cfg, params, n_ctx=512),
                              tok.encode(text), picks)
    check_forced("16b --resident as-is vs the loaded params with every "
                 "plain version on the card, fed its picks", (picks, logs),
                 plain, failures, ROUTE_TOL)
    same = same_ids and picks == list(out[:CLI_TOKENS])
    log(f"  16b: stdout is the prompt + its picks {ok}; its text equals "
        f"tok.decode of 11b's greedy tokens {same} (another route: fuse_"
        f"gate_up, bf16 scales, W4A8/W8A8 activations)")
    L = eng.cfg.n_layer
    check_counts(counts, {"decode_attention": (CLI_TOKENS - 1) * L,
                          "flash_attention": L, "flash_backward_tiles": L},
                 failures)
    return {"wall_s": secs, "refusal_s": refuse_s, "refusal": msg,
            "text_equal_11b": same}, counts


def dense_f32(params):
    """Every QTensor of a params tree dequantized once into a dense f32 one
    (the numbers an f32 product dequantizes to, without the expansion in
    each product)."""
    from ggml_imax_tpu_torch.ops.qmatmul import dequantize
    from ggml_imax_tpu_torch.quant.device import QTensor
    if isinstance(params, dict):
        return {k: dense_f32(v) for k, v in params.items()}
    if isinstance(params, list):
        return [dense_f32(v) for v in params]
    if isinstance(params, QTensor):
        return QTensor("dense", dequantize(params, torch.float32), None, None,
                       params.k, params.n, params.ggml_type, name=params.name)
    return params


def llama_graphs() -> dict:
    """`chip_smoke.py --llama-graphs`: which graph 16b's forwards follow.
    11b's file, its as-is CLI run (16b's argv, its picks and logits), then
    teacher-forced passes fed those picks through both graphs (the loaded
    layout, "as-is"; 11b's prepared one: fuse_gate_up, params_repack with
    bf16 scales): on the card with the kernels and with every plain version
    in bf16 and f32, and on the host in f32 (the weights dequantized once).
    Logs each pass's max |logit diff| per forward and the cosine of its
    logits against each graph's host f32 pass. -> the readings."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.runtime.engine import Engine
    t_start = time.time()
    cfg, _, tensors, path, _, _ = write_llama_gguf("graphs")
    del tensors
    try:
        _, params, tok = llama.load_gguf(path)
        prompt = check_tokenizer("graphs", tok, cfg.n_vocab, [])
        text, same_ids = cli_prompt(tok, prompt)
        ids = tok.encode(text)
        logs = []
        run_cli("examples.llama", ["-m", str(path), "-p", text, "-n",
                                   str(CLI_TOKENS), "--temp", "0", "-s", "0",
                                   "-c", "512", "--resident", "as-is"],
                "graphs llama --resident as-is", engine_recorder(logs))
        picks = [int(x[0].argmax()) for x in logs]

        def prepare(p):
            return params_repack(llama.fuse_gate_up(p),
                                 scale_dtype=torch.bfloat16)

        def forced(p, dtype, plain=False, device=None):
            eng = Engine(llama, cfg, p, compute_dtype=dtype, kv_dtype=dtype,
                         n_ctx=512, device=device)
            with patched(plain_on_card() if plain else []):
                return forced_engine(eng, ids, picks)[1]
        runs = {"as-is bf16 kernels (the CLI)": logs}
        prepared = prepare(params)
        for graph, p in (("as-is", params), ("prepared", prepared)):
            for dtype, plain in ((torch.bfloat16, False),
                                 (torch.bfloat16, True),
                                 (torch.float32, True)):
                key = (f"{graph} {str(dtype)[6:]} "
                       f"{'plain' if plain else 'kernels'}")
                if key not in runs:
                    runs[key] = forced(p, dtype, plain)
        del params, prepared, p
        torch.cuda.empty_cache()
        for graph in ("as-is", "prepared"):
            t0 = time.time()
            p = llama.load_gguf(path, device="cpu")[1]
            p = dense_f32(prepare(p) if graph == "prepared" else p)
            runs[f"{graph} f32 host"] = forced(p, torch.float32,
                                               device="cpu")
            del p
            log(f"  graphs: {graph} f32 on the host in "
                f"{time.time() - t0:.1f} s")
    finally:
        path.unlink()
    scale = logit_scale(runs["as-is f32 host"])
    log(f"  graphs: prompt {len(ids)} ids (the phase's {same_ids}), the "
        f"CLI's picks {picks}, largest |logit| of the as-is host pass "
        f"{scale:.4f}; TF32 in matmuls "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    out = {"picks": picks, "largest_logit": scale, "runs": {}}
    for key, lg in runs.items():
        row = {"picks": [int(x[0].argmax()) for x in lg]}
        for ref in ("as-is f32 host", "prepared f32 host"):
            row[f"diff vs {ref}"] = [float((a.float() - b.float()).abs().max())
                                     for a, b in zip(lg, runs[ref])]
            row[f"cos vs {ref}"] = [float(torch.nn.functional.cosine_similarity(
                a.double().flatten(), b.double().flatten(), dim=0))
                for a, b in zip(lg, runs[ref])]
        out["runs"][key] = row
        log(f"  graphs: {key:28s} picks {row['picks']}")
        for ref in ("as-is f32 host", "prepared f32 host"):
            log(f"    vs {ref:18s} max |diff| "
                f"{' '.join(f'{d:.2e}' for d in row[f'diff vs {ref}'])}")
            log(f"    {'':21s} cosine    "
                f"{' '.join(f'{c:+.5f}' for c in row[f'cos vs {ref}'])}")
    log(f"  graphs: {time.time() - t_start:.1f} s")
    return out


def cli_whisper(path, wav, segs, failures):
    """16c on 11c's .bin and its audio as a WAV: the CLI at beam 5 with
    11c's cut decode settings (one temperature, WHISPER_TOKENS a window)
    put into the FullParams it builds: its segment lines equal 11c's
    transcript's. -> (summary, launch counts)."""
    from ggml_imax_tpu_torch.runtime import whisper_pipeline as wp
    full = wp.FullParams

    def cut(**kw):
        return full(**kw, temperatures=(0.0,), max_tokens=WHISPER_TOKENS)
    got, _, counts, secs, code = run_cli(
        "examples.whisper", ["-m", str(path), "-f", str(wav), "-bs", "5"],
        "16c whisper", [(wp, "FullParams", cut)])
    want = "".join(f"[{s.t0:7.2f} -> {s.t1:7.2f}] {s.text}\n" for s in segs)
    ok = code == 0 and got == want
    log(f"  16c: segments equal 11c's transcript {ok}: {got.strip()!r}")
    if not ok:
        failures.append(f"16c: exit {code!r}, {got!r} vs {want!r}")
    if not counts["nat8_w8a16"] or not counts["flash_attention"]:
        failures.append(f"16c: launches {counts}")
    return {"wall_s": secs, "segments_equal": ok}, counts


def cli_serve(path, eng, tok, prompt, out, failures):
    """16d's serve (non-bench): -np 4 sampled twice with one seed (every
    forked sequence the same run to run); then -np 1 greedy (the loaded
    layout: dequantize + matmul products, flash), the shared prefill's and
    each step's logits recorded: 11d's engine fed its picks within
    ROUTE_TOL of the largest |logit| and picking the same tokens but at a
    near-tie (check_forced): its picks are 11d's greedy tokens up to a
    near-tie.
    -> (summary, launch counts of the greedy run)."""
    from ggml_imax_tpu_torch.runtime import batched
    text, same_ids = cli_prompt(tok, prompt)
    argv = ["-m", str(path), "-p", text, "-n", str(CLI_TOKENS), "-s", "11"]
    a, _, _, secs, _ = run_cli("examples.serve", argv + ["-np", "4"],
                               "16d serve -np 4 (sampled)")
    b, _, _, _, code = run_cli("examples.serve", argv + ["-np", "4"],
                               "16d serve -np 4 again")
    seqs = a.split("--- sequence ")[1:]
    ok = code == 0 and a == b and len(seqs) == 4
    log(f"  16d serve: 4 forked sequences, the same run to run {ok}, "
        f"{len(set(seqs))} distinct")
    if not ok:
        failures.append(f"16d serve: runs differ or {len(seqs)} sequences")
    greedy = batched.sample_greedy
    logs = []

    def rec(lg):
        logs.append(torch.from_numpy(np.array(lg, np.float32))[None])
        return greedy(lg)
    got, _, counts, g_secs, code = run_cli(
        "examples.serve", argv + ["-np", "1", "--temp", "0"],
        "16d serve -np 1 greedy", [(batched, "sample_greedy", rec)])
    picks = [int(x[0].argmax()) for x in logs]
    if code != 0 or got != "--- sequence 0 ---\n" + text + tok.decode(
            picks) + "\n":
        failures.append(f"16d serve greedy: exit {code!r}, {got[-200:]!r}")
    ids = tok.encode(text)
    check_forced("16d serve greedy vs 11d's engine fed its picks",
                 (picks, logs), forced_engine(eng, ids, picks), failures,
                 ROUTE_TOL)
    # 11d's engine fed these picks picks them all, so its greedy run is
    # this sequence, unless it parted at a near-tie check_forced accepts
    ref = list(out[:CLI_TOKENS]) if same_ids else \
        eng.generate(ids, CLI_TOKENS, temp=0)
    same = picks == ref
    log(f"  16d serve: sequence 0 (greedy) equals 11d's greedy tokens {same}"
        f"{'' if same else f': {picks} vs {ref}'}")
    return {"wall_s": secs, "greedy_wall_s": g_secs, "forks_equal": ok,
            "greedy_equal_11d": same}, counts


def cli_module_entry(argv, want, failures):
    """16d's subprocess: `python -m ggml_imax_tpu_torch.examples.gpt2 argv`
    from the checkout, its stdout equal to the in-process run's."""
    t0 = time.perf_counter()
    try:
        res = subprocess.run(
            [sys.executable, "-m", "ggml_imax_tpu_torch.examples.gpt2"]
            + argv, cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=CLI_TIMEOUT)
        ok = res.returncode == 0 and res.stdout == want
        note = f"exit {res.returncode}"
    except subprocess.TimeoutExpired:
        ok, note = False, f"killed at its {CLI_TIMEOUT} s limit"
    secs = time.perf_counter() - t0
    log(f"  16d python -m ggml_imax_tpu_torch.examples.gpt2 (a subprocess): "
        f"{note}, {secs:.1f} s, stdout equal to the in-process run's {ok}")
    if not ok:
        failures.append(f"16d subprocess: {note}")
    return {"wall_s": secs, "stdout_equal": ok}


def cli_serve_bench(failures, phase6):
    """16h: examples/serve.py --bench --steady -np 8 --n_predict 64 at its
    default GPT-J-6B geometry: the JSON line parsed, every key of the JAX
    CLI's line present, generated = 8 x 64; its tok/s, steady tok/s and p50
    TTFT beside phase 6's (no gate on speed). -> (summary, counts)."""
    got, _, counts, secs, code = run_cli("examples.serve", SERVE_BENCH_ARGV,
                                         "16h serve --bench")
    try:
        rec = json.loads(got.strip().splitlines()[-1])
    except (ValueError, IndexError):
        rec = {}
    missing = [k for k in SERVE_BENCH_KEYS if k not in rec]
    ok = code == 0 and not missing and rec.get("generated") == 8 * 64
    log(f"  16h: {json.dumps(rec)}")
    log(f"  16h: serve --bench {rec.get('value')} tok/s, steady "
        f"{rec.get('steady_tok_s')} tok/s, p50 TTFT "
        f"{rec.get('p50_ttft_ms')} ms; phase 6's step_chunk("
        f"{SERVE['chunk']}) {phase6['tok_s']:.2f} tok/s, p50 TTFT "
        f"{phase6['p50_ttft_ms']:.2f} ms, --steady "
        f"{phase6['steady']['tok_s']:.2f} tok/s (8 x 32 tokens there, 8 x 64 "
        "here; the CLI's ramp is the per-token step() loop, as the JAX "
        f"CLI's); keys missing {missing}, generated {rec.get('generated')}")
    if not ok:
        failures.append(f"16h: exit {code!r}, missing {missing}, line {rec}")
    for k in ("w4a16_gemm", "decode_attention_cells", "flash_attention"):
        if not counts[k]:
            failures.append(f"16h: no {k} launch")
    return {"line": rec, "wall_s": secs}, counts


def cli_wall_seconds(engines) -> dict:
    """Every CLI run's summary in the phases' summaries (a dict with its
    wall_s under a "cli" key), by its path there."""
    out = {}

    def walk(x, path):
        if not isinstance(x, dict):
            return
        if "wall_s" in x and any(p.startswith("cli") for p in path):
            out["/".join(path)] = x
        for k, v in x.items():
            walk(v, path + (str(k),))
    walk(engines, ())
    return out


def qgate_dir() -> Path:
    d = Path(__file__).resolve().parent / "build" / "qgate"
    d.mkdir(parents=True, exist_ok=True)
    return d


def cli_quality(failures):
    """16i: tools/quality_gate.py at its small geometry (2L x 128E x 4H,
    vocab 64, T 256, B 8, 1500 steps) trained on the card (--retrain),
    every format's row and verdict; the F32 PPL must be under 0.9 x
    min(vocab, unigram); then tools/quality_kernel_row.py's Q4_0, Q4_K and
    Q5_0 rows under its KL gate. -> (summary, counts by tool)."""
    d = qgate_dir()
    out = d / "QUALITY.md"
    got, err, counts, secs, code = run_cli(
        "tools.quality_gate", ["--retrain", "--dir", str(d), "--out",
                               str(out)], "16i quality_gate")
    for line in err.splitlines():
        if line.startswith(("# train", "# trained")):
            log(f"  16i: {line}")
    rows = [ln for ln in got.splitlines() if ln.startswith("| ")
            and not ln.startswith("| configuration")]
    verdicts = re.findall(r"^- (\S+): our PPL delta .* -> \*\*(PASS|FAIL)\*\*",
                          got, re.M)
    learned = "is below the context-free bound" in got
    trained = re.search(r"# trained (\d+) steps in ([0-9.]+) s, ([0-9.]+) ms",
                        err)
    for ln in rows:
        log(f"  16i {ln}")
    log(f"  16i: verdicts {verdicts}; learned structure {learned}")
    for ln in got.splitlines():
        if ln.startswith(("Language baselines", "The trained model")):
            log(f"  16i: {ln}")
    if code != 0 or not learned or len(verdicts) != 10 or any(
            v != "PASS" for _, v in verdicts):
        failures.append(f"16i quality_gate: exit {code!r}, learned "
                        f"{learned}, verdicts {verdicts}")
    kgot, _, kcounts, ksecs, kcode = run_cli(
        "tools.quality_kernel_row", ["--dir", str(d), "--out", str(out)],
        "16i quality_kernel_row")
    krows = re.findall(r"^\| (Q\S+) \(([^)]*)\) \| ([0-9.]+) \| ([0-9.e+-]+)"
                       r" \| \*\*(PASS|FAIL)\*\* \|", kgot, re.M)
    for r in krows:
        log(f"  16i kernel row {r[0]} ({r[1]}): PPL {r[2]}, mean KL vs sim "
            f"{r[3]} -> {r[4]}")
    if kcode != 0 or len(krows) != 3 or any(r[4] != "PASS" for r in krows):
        failures.append(f"16i quality_kernel_row: exit {kcode!r}, {krows}")
    for k, c in (("w4a8_gemv", kcounts), ("nat8_w8a8", kcounts),
                 ("flash_backward_dq", counts), ("flash_backward_dkv", counts),
                 ("w4a16_gemm", counts), ("nat8_w8a16", counts)):
        if not c[k]:
            failures.append(f"16i: no {k} launch")
    summary = {"wall_s": secs, "kernel_row_s": ksecs, "rows": rows,
               "verdicts": verdicts, "learned": learned,
               "kernel_rows": krows}
    if trained:
        summary.update(steps=int(trained[1]), train_s=float(trained[2]),
                       train_ms_per_step=float(trained[3]))
        log(f"  16i: trained {trained[1]} steps in {trained[2]} s = "
            f"{trained[3]} ms a step on the card")
    return summary, {"cli_quality_gate": counts,
                     "cli_quality_kernel_row": kcounts}


def cli_magika(path, files, failures):
    """16f on 13a's GGUF and files: each printed line's labels and
    percentages those of 13a's identify (a label may trade places with a
    neighbour whose probability lies within MAGIKA_PROB_TOL)."""
    repo = Path(__file__).resolve().parent
    args = [str(repo / rel) for rel in MAGIKA_FILES]
    got, _, counts, secs, code = run_cli("examples.magika", [str(path)] + args,
                                         "16f magika")
    lines = got.splitlines()
    ok = code == 0 and len(lines) == len(args)
    for rel, a, line in zip(MAGIKA_FILES, args, lines):
        top = files[rel]["top"]
        name, _, rest = line.partition(": ")
        items = [it.rsplit(":", 1) for it in rest.split()]
        for i, ((n, pct), (tn, tp)) in enumerate(zip(items, top[:3])):
            tie = any(abs(tp - top[j][1]) <= MAGIKA_PROB_TOL
                      for j in (i - 1, i + 1) if 0 <= j < len(top))
            ok &= name == a and abs(int(pct[:-1]) - round(100 * tp)) <= 1 \
                and (n == tn or tie)
    log(f"  16f magika: {len(lines)} lines, labels and percentages those of "
        f"13a's identify {ok}: {lines[0] if lines else ''!r}")
    if not ok:
        failures.append(f"16f magika: exit {code!r}, {lines}")
    return {"wall_s": secs, "equal": ok}, counts


def cli_yolo(path, img_path, dets, failures):
    """16f on 13b's GGUF and image: the printed detections those of 13b's
    detect (threshold 0.5): the same classes in order, the percentages
    within 1, the boxes within 1.5e-3."""
    from ggml_imax_tpu_torch.examples.yolo import detection_lines
    got, _, counts, secs, code = run_cli(
        "examples.yolo", ["-m", str(path), "-i", str(img_path)], "16f yolo")
    lines, want = got.splitlines(), detection_lines(dets)
    num = re.compile(r"[-0-9.]+")
    ok = code == 0 and len(lines) == len(want)
    for g, w in zip(lines, want):
        gv, wv = (list(map(float, num.findall(x.split(":", 1)[1])))
                  for x in (g, w))
        ok &= g.split(":")[0] == w.split(":")[0] and abs(gv[0] - wv[0]) <= 1 \
            and max(abs(a - b) for a, b in zip(gv[1:], wv[1:])) <= 1.5e-3
    log(f"  16f yolo: {len(lines)} detections printed, those of 13b's detect "
        f"{ok}" + (f": {lines[0]!r}" if lines else ""))
    if not ok:
        failures.append(f"16f yolo: exit {code!r}, {lines[:3]} vs {want[:3]}")
    return {"wall_s": secs, "equal": ok, "lines": len(lines)}, counts


def cli_sam(path, img_path, masks, iou, failures):
    """16f on 13c's .bin and image with 13c's point: each mask's IoU within
    1e-3 and area within 0.1% of the image of 13c's predict, the saved masks
    equal to its on 99.9% of the pixels or more."""
    out = vision_dir() / "cli-masks.npy"
    got, _, counts, secs, code = run_cli(
        "examples.sam", ["-m", str(path), "-i", str(img_path), "-p",
                         f"{SAM_POINT[0]},{SAM_POINT[1]}", "-o", str(out)],
        "16f sam")
    line = re.compile(r"^mask (\d): iou=([-0-9.]+) area=(\d+) px$")
    rows = [line.match(x) for x in got.splitlines()[:3]]
    n_px = SAM_IMAGE[0] * SAM_IMAGE[1]
    ok = code == 0 and all(rows) and len(rows) == 3 and out.exists()
    if ok:
        saved = np.load(out)
        ok = all(abs(float(m[2]) - float(iou[i])) <= 1e-3
                 and abs(int(m[3]) - int(masks[i].sum())) <= 1e-3 * n_px
                 for i, m in enumerate(rows)) and \
            saved.shape == masks.shape and \
            bool((saved == masks).mean() >= 0.999)
    log(f"  16f sam: {got.splitlines()[:3]}; IoUs and areas those of 13c's "
        f"predict {ok}")
    if not ok:
        failures.append(f"16f sam: exit {code!r}, {got!r}")
    out.unlink(missing_ok=True)
    return {"wall_s": secs, "equal": ok}, counts


def cli_mnist(failures):
    """16g: examples/mnist.py for the FC net and the CNN at 14a's iteration
    counts, the artifact under build/export; the re-imported prediction
    must equal the eager forward's on the trained params (recorded at
    export_model)."""
    from ggml_imax_tpu_torch.models import mnist
    out, counts = {}, {}
    real = mnist.export_model
    for kind in ("fc", "cnn"):
        path = export_dir() / f"cli-mnist-{kind}.gitg"
        seen = []

        def rec(fwd, params, x, p):
            seen.append((fwd, params, x))
            return real(fwd, params, x, p)
        got, _, c, secs, code = run_cli(
            "examples.mnist", ["--arch", kind, "--iters",
                               str(MNIST_TRAIN[kind][0]), "--out", str(path)],
            f"16g mnist {kind}", [(mnist, "export_model", rec)])
        m = re.search(r"re-imported prediction for sample 0: (\d+) "
                      r"\(label (\d+)\)", got)
        acc = re.search(r"^train: (\w+), accuracy ([0-9.]+)$", got, re.M)
        eager = None
        if seen:
            fwd, params, x = seen[0]
            with torch.no_grad():
                eager = int(fwd(params, x).argmax())
        ok = code == 0 and bool(m and acc) and int(m[1]) == eager
        log(f"  16g mnist {kind}: {got.strip().splitlines()}; the reloaded "
            f"prediction equals the eager one ({eager}) {ok}")
        if not ok:
            failures.append(f"16g mnist {kind}: exit {code!r}, {got!r}")
        path.unlink(missing_ok=True)
        out[kind] = {"wall_s": secs, "accuracy": float(acc[2]) if acc
                     else None, "prediction_equal": ok}
        counts[f"cli_mnist_{kind}"] = c
    got, _, c, secs, code = run_cli("examples.simple", [], "16g simple")
    ok = code == 0 and got.splitlines()[-1:] == ["ok"]
    log(f"  16g simple: {got.strip().splitlines()} -> "
        + ("ok" if ok else "FAIL"))
    if not ok:
        failures.append(f"16g simple: exit {code!r}, {got!r}")
    out["simple"], counts["cli_simple"] = {"wall_s": secs, "ok": ok}, c
    return out, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    # a kernel group alone, timed on the port of another checkout if named
    alone = {"--serving-kernels": ("serving_kernels", check_serving_kernels),
             "--gpt2-kernels": ("gpt2_kernels", lambda ck, timer, gen:
                                check_gpt2_kernels(ck, timer, gen,
                                                   w8a8_only=True))
             }.get(sys.argv[1] if len(sys.argv) > 1 else "")
    if alone and len(sys.argv) > 2:
        repo = Path(sys.argv[2]).resolve()
    if not (repo / "ggml_imax_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout holding ggml_imax_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from ggml_imax_tpu_torch import _build, native

    # ---- 1. setup
    t_start = time.time()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    log(f"# device {name}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi[0] if smi else "nvidia-smi: n/a")
    t0 = time.time()
    _build.lib()
    log(f"# kernels built in {time.time() - t0:.1f} s")
    t0 = time.time()
    native.lib()
    native.iq_lib()
    log(f"# host C++ libraries (native/codecs.cpp, native/iq_encoders.cpp) "
        f"built and loaded in {time.time() - t0:.1f} s: g++ "
        f"{ {k: round(v, 2) for k, v in native.BUILD_SECONDS.items()} } s")
    for line in _build.BUILD_LOG.splitlines():
        if any(w in line for w in ("==", "registers", "spill", "Compiling entry")):
            log("#   " + line.strip())

    if sys.argv[1:2] == ["--llama-graphs"]:
        log(json.dumps({"llama_graphs": llama_graphs()}))
        log(smi[0] if smi else "nvidia-smi: n/a")
        return 0

    # ---- 2. kernels against their plain versions
    log("# phase 2: kernels vs plain versions (main-path shapes)")
    t0 = time.time()
    ck, timer = Checks(), Timer()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if alone:
        key, check = alone
        check(ck, timer, gen)
        if ck.failures:
            raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(ck.failures))
        log(smi[0] if smi else "nvidia-smi: n/a")
        log(json.dumps({key: list(ck.results.values()), "port": str(repo)}))
        return 0
    check_gptj_kernels(ck, timer, gen)
    check_serving_kernels(ck, timer, gen)
    check_gpt2_kernels(ck, timer, gen)
    check_train_kernels(ck, timer, gen)
    check_kquant_kernels(ck, timer, gen)
    check_llama_kernels(ck, timer, gen)
    check_llama_serving_kernels(ck, timer, gen)
    check_format_kernels(ck, timer, gen)
    check_whisper_kernels(ck, timer, gen)
    check_parallel_kernels(ck, timer, gen)
    del timer                                      # the 256 MB flush buffer
    torch.cuda.empty_cache()
    failures = ck.failures
    log(f"# phase 2: {time.time() - t0:.1f} s")
    # ---- 3. small models, card vs CPU
    log("# phase 3: small GPT-J, GPT-2 and LLaMA, card kernels vs CPU plain "
        "versions")
    t0 = time.time()
    check_small_models(failures)
    check_small_llama(failures)
    check_small_batched(failures)
    check_small_chunked(failures)
    check_small_whisper(failures)
    check_small_loaders(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    log(f"# phase 3: {time.time() - t0:.1f} s")

    from ggml_imax_tpu_torch.models import gpt2, gptj
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    n_dec, n_pre = N_REQUESTS * (N_PREDICT - 1), N_REQUESTS
    launches, engines = {}, {}

    # ---- 4. engine at GPT-J-6B width
    log("# phase 4: GPT-J-6B Q4_0 engine (synthetic weights on device)")
    cfg = gptj.GPTJConfig(**GPTJ_6B)
    t0 = time.time()
    params = gptj.synthetic_params_device(cfg, seed=0)
    params = params_repack(gptj.prepare_fused(params, cfg))
    torch.cuda.synchronize()
    log(f"  weights drawn + prepared in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    eng, rng, reqs, counts, runs = serve(gptj, cfg, params, 512, failures)
    L = cfg.n_layer
    expect = {"w4a8_gemv": n_dec * (2 * L + 1), "decode_attention": n_dec * L,
              "w4a16_gemm": n_pre * (2 * L + 1), "flash_attention": n_pre * L,
              "flash_backward_tiles": n_pre * L}
    check_counts(counts, expect, failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    busy_ms, _ = profile_engine(eng, rng, reqs)
    launches["gptj"], engines["gptj"] = counts, reqs
    # the same requests through captured spans of CHUNK decode steps
    creqs, ccounts, summary = serve_chunked(eng, runs, failures)
    check_counts(ccounts, expect, failures)
    if ccounts != counts:
        failures.append(f"chunk-{CHUNK} launches {ccounts} differ from chunk "
                        f"1's {counts}")
    med = lambda rs: float(np.median([r["decode_tok_s"] for r in rs]))
    step_busy = busy_ms.get("decode step")
    span_ms, span_busy, how = profile_span(eng, step_busy)
    summary.update(tok_s=med(creqs), ms_per_token=1e3 / med(creqs),
                   chunk1_tok_s=med(reqs), span_ms=span_ms,
                   span_busy_ms=span_busy, span_busy_method=how)
    log(f"  chunk {CHUNK}: {med(creqs):.2f} tok/s = {1e3 / med(creqs):.3f} ms a "
        f"token (median), {med(creqs) / med(reqs):.2f}x chunk 1's "
        f"{med(reqs):.2f} tok/s; 1.25 x the eager step's profiled device "
        "time " + ("not measured" if step_busy is None else
                   f"{1.25 * step_busy:.3f} ms"))
    frozen_n_past_control(eng, runs, failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    launches["gptj_chunked"], engines["gptj_chunked"] = ccounts, dict(
        summary, requests=creqs)
    del eng
    torch.cuda.empty_cache()
    engines["gptj_residency"], by_run = gptj_residencies(cfg, params, runs,
                                                         failures)
    launches.update(by_run)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    # ---- 14d. the decode step exported and replayed, on these weights
    log("# phase 14d: GPT-J-6B Q4_0 decode step through torch.export "
        "(export_graph / load_graph, the kernels as custom ops)")
    t14 = time.time()
    engines["gptj_exported"], launches["gptj_exported"] = exported_gptj_step(
        cfg, params, runs, failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    log(f"# phase 14d: {time.time() - t14:.1f} s")
    del params, runs                       # runs holds copies of the arena
    torch.cuda.empty_cache()
    log(f"# phase 4: {time.time() - t0:.1f} s")

    # ---- 5. engine at GPT-2 XL width
    log("# phase 5: GPT-2 1558M Q8_0 engine (synthetic weights on device)")
    cfg = gpt2.GPT2Config(**GPT2_XL)
    t0 = time.time()
    params = gpt2.synthetic_params_device(cfg, seed=0)
    params = params_repack(gpt2.prepare_fused(params, cfg))
    torch.cuda.synchronize()
    log(f"  weights drawn + prepared in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    eng, rng, reqs, counts, runs = serve(gpt2, cfg, params, 1024, failures)
    L = cfg.n_layer
    check_counts(counts, {"nat8_w8a8": n_dec * L, "nat8_w8a16": n_pre * L,
                          "flash_attention": n_pre * L,
                          "flash_backward_tiles": n_pre * L}, failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    gated = gated_products_ms(
        [w for lp in params["layers"]
         for w in (lp["attn_w"], lp["proj_w"], lp["out_w"])] + [params["wte"]],
        *profile_engine(eng, rng, reqs))
    launches["gpt2"], engines["gpt2"] = counts, reqs
    # one request through captured spans: the nat8 W8A8 GEMV in a graph
    creqs, ccounts, summary = serve_chunked(eng, runs, failures, n=1)
    check_counts(ccounts, {"nat8_w8a8": (N_PREDICT - 1) * L,
                           "nat8_w8a16": L, "flash_attention": L,
                           "flash_backward_tiles": L}, failures)
    log(f"  chunk {CHUNK}: {creqs[0]['decode_tok_s']:.2f} tok/s = "
        f"{1e3 / creqs[0]['decode_tok_s']:.3f} ms a token")
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    launches["gpt2_chunked"], engines["gpt2_chunked"] = ccounts, dict(
        summary, requests=creqs)
    del eng, params, runs
    torch.cuda.empty_cache()
    log(f"# phase 5: {time.time() - t0:.1f} s")

    # ---- 5b. GPT-2 XL in Q5_K
    log("# phase 5b: GPT-2 1558M Q5_K engine (synthetic weights on device)")
    t0 = time.time()
    engines["gpt2_q5_k"], by_run = gpt2_xl_q5k(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    launches.update(by_run)
    log(f"# phase 5b: {time.time() - t0:.1f} s")

    # ---- 6. continuous-batching serving at GPT-J-6B width
    log("# phase 6: GPT-J-6B Q4_0 serving (BatchedEngine, q8_0 KV, n_ctx "
        f"{SERVE['n_ctx']})")
    t0 = time.time()
    engines["serving"], by_path = serve_gptj(failures)
    launches.update(by_path)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    torch.cuda.empty_cache()
    log(f"# phase 6: {time.time() - t0:.1f} s")

    # ---- 7. GPT-2 117M training steps
    log(f"# phase 7: GPT-2 117M training (F32, B {TRAIN['batch']}, T "
        f"{TRAIN['seq']}, AdamW)")
    t0 = time.time()
    engines["train"], launches["train"] = train_gpt2(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    torch.cuda.empty_cache()
    log(f"# phase 7: {time.time() - t0:.1f} s")

    # ---- 8. GPT-2 117M K-quants and the legacy layouts
    log("# phase 8: GPT-2 117M Q3_K / Q2_K engine, row-pair Q4_0 and u-order "
        "Q8_0 (synthetic weights quantized on the host)")
    t0 = time.time()
    pool = host_pool()
    try:
        engines["gpt2_117m"], by_run = kquant_gpt2(failures, pool)
        launches.update(by_run)
        if failures:
            raise SystemExit("chip_smoke FAILED:\n  "
                             + "\n  ".join(failures))
        log(f"# phase 8: {time.time() - t0:.1f} s")

        # ---- 8b. GPT-2 117M in the other block formats
        log("# phase 8b: GPT-2 117M Q4_0 / Q4_1 / Q5_0 / Q5_1 / Q5_K / Q6_K "
            "engine (synthetic weights quantized on the host)")
        t0 = time.time()
        engines["gpt2_117m_formats"], by_run = formats_gpt2(failures, pool)
        launches.update(by_run)
        if failures:
            raise SystemExit("chip_smoke FAILED:\n  "
                             + "\n  ".join(failures))
        log(f"# phase 8b: {time.time() - t0:.1f} s")

        # ---- 8c. GPT-2 117M in the IQ formats
        log("# phase 8c: GPT-2 117M IQ4_NL / IQ4_XS (quantized on the host) "
            "and IQ2_XXS / IQ2_XS / IQ2_S / IQ3_XXS / IQ3_S / IQ1_S / IQ1_M "
            "(random blocks) engine")
        t0 = time.time()
        engines["gpt2_117m_iq"], by_run = codebooks_gpt2(failures, pool)
    finally:
        pool.shutdown()
    launches.update(by_run)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    log(f"# phase 8c: {time.time() - t0:.1f} s")

    # ---- 9. LLaMA-2 7B Q4_K
    log("# phase 9: LLaMA-2 7B Q4_K engine (synthetic weights on device, "
        "bf16 scales and mins)")
    t0 = time.time()
    engines["llama"], by_run = llama_7b(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    launches.update(by_run)
    log(f"# phase 9: {time.time() - t0:.1f} s")

    # ---- 9b. LLaMA-2 7B Q4_K_M
    log("# phase 9b: LLaMA-2 7B Q4_K_M engine (synthetic weights on device, "
        "Q6_K output and half the attn_v / ffn_down, bf16 scales)")
    t0 = time.time()
    engines["llama_q4km"], by_run = llama_q4km(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    launches.update(by_run)
    log(f"# phase 9b: {time.time() - t0:.1f} s")

    # ---- 9c. LLaMA-2 7B IQ4_XS, and its bf16 residency
    log("# phase 9c: LLaMA-2 7B IQ4_XS engine (synthetic weights on device, "
        "Q6_K output, nat8 f32 scales) and Engine(residency=\"bf16\")")
    t0 = time.time()
    engines["llama_iq4_xs"], by_run = llama_iq4xs(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    launches.update(by_run)
    log(f"# phase 9c: {time.time() - t0:.1f} s")

    # ---- 10. Whisper small and medium Q5_0
    log("# phase 10: Whisper small and medium Q5_0 (encode, greedy, the "
        "route check, the beam-search pipeline eager and captured, token "
        "timestamps)")
    t0 = time.time()
    engines["whisper"], by_run = whisper_phase(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    launches.update(by_run)
    log(f"# phase 10: {time.time() - t0:.1f} s")

    # ---- 11. model files through the loaders and tokenizers
    log("# phase 11: GPT-J-6B Q4_0 .bin, LLaMA-2 7B Q4_K_M GGUF, Whisper "
        "small Q5_0 .bin and GPT-2 117M Q4_0 .bin, written by the port's "
        "writers, loaded, run")
    t0 = time.time()
    engines["loaders"], by_run = loaders_phase(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    launches.update(by_run)
    log(f"# phase 11: {time.time() - t0:.1f} s")

    # ---- 12. the quantization tools
    log("# phase 12: LLaMA-2 7B F16 GGUF -> Q4_0 and perplexity; GPT-2 117M "
        "imatrix, imatrix-weighted Q4_0, the IQ encoders and the W4A8 "
        "quality rows (requantize, tools.perplexity, quant.imatrix)")
    t0 = time.time()
    engines["quant_tools"], by_run = quant_tools_phase(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    launches.update(by_run)
    log(f"# phase 12: {time.time() - t0:.1f} s")

    # ---- 13. Magika, YOLOv3-tiny and SAM ViT-B
    log("# phase 13: Magika, YOLOv3-tiny (416 x 416, 80 classes) and SAM "
        "ViT-B (1024 x 1024) from model files, card vs CPU")
    t0 = time.time()
    engines["vision"], by_run = vision_phase(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    launches.update(by_run)
    log(f"# phase 13: {time.time() - t0:.1f} s")

    # ---- 14. MNIST, L-BFGS and graph export (14d ran inside phase 4)
    log(f"# phase 14: MNIST FC 784-500-10 and CNN 8/16 on {MNIST_N} images "
        "(Adam), L-BFGS, export_model / load_model")
    t0 = time.time()
    engines["mnist"], by_run = mnist_phase(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    launches.update(by_run)
    log(f"# phase 14: {time.time() - t0:.1f} s")

    # ---- 15. the parallel paths on gloo ranks sharing the card
    log(f"# phase 15: GPT-J-6B and LLaMA-2 7B tp {PARALLEL_RANKS}, ring "
        f"prefill, pipeline and sharded load ({PARALLEL_RANKS} processes "
        "time-sharing one H100 over gloo)")
    t0 = time.time()
    engines["parallel"], by_path = parallel_phase(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    launches.update(by_path)
    log(f"# phase 15: {time.time() - t0:.1f} s")

    # ---- 16. the entry points: 16a-16g ran inside phases 11-14
    log("# phase 16: examples/serve.py --bench --steady at GPT-J-6B geometry, "
        "then tools/quality_gate.py trained on the card and "
        "tools/quality_kernel_row.py")
    t0 = time.time()
    engines["cli_serve_bench"], launches["cli_serve_bench"] = \
        cli_serve_bench(failures, engines["serving"])
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    torch.cuda.empty_cache()
    log(f"  -- 16h: {time.time() - t0:.1f} s")
    t16 = time.time()
    engines["cli_quality"], by_run = cli_quality(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    launches.update(by_run)
    log(f"  -- 16i: {time.time() - t16:.1f} s")
    cli_walls = {k: round(v.get("wall_s", 0.0), 2) for k, v in
                 cli_wall_seconds(engines).items()}
    log(f"  every CLI's wall seconds: {cli_walls}")
    log(f"# phase 16: {time.time() - t0:.1f} s")
    log("# phases run: 1, 2, 3, 4, 14d, 5, 5b, 6, 7, 8, 8b, 8c, 9, 9b, 9c, "
        "10, 11 (16a-16d), 12 (16e), 13 (16f), 14 (16g), 15, 16 (16h, 16i)")
    log(f"# phases 1-16: {time.time() - t_start:.1f} s")

    kernels = []
    for k in KERNELS:
        entry = dict(ck.results[k])
        by_path = {p: c[k] for p, c in launches.items() if c[k]}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        entry["max_abs_err"] = max(ck.errs[k])
        if entry["launches"] == 0:
            raise SystemExit(f"chip_smoke FAILED: {k} never ran on a main path")
        entry["cli_launches"] = sum(n for p, n in by_path.items()
                                    if p.startswith("cli_"))
        if k in CLI_KERNELS and not entry["cli_launches"]:
            raise SystemExit(f"chip_smoke FAILED: {k} never ran on an entry "
                             "point's path (phase 16)")
        kernels.append(entry)
    log(json.dumps({"engine": engines, "gated_products_ms": gated}))
    log(smi[0] if smi else "nvidia-smi: n/a")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
