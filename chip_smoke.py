#!/usr/bin/env python3
"""Drive the PyTorch port (open_whisper_kit_tpu_torch) once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each gated; any failure exits non-zero before the result lines:
  1. torch / CUDA versions and the card's name and power limit;
  2. build kernels K1 (csrc/mha_packed.cu), K2 (mega_step.cu, 1-8 rows), K3
     (qmm.cu, and qmm_rows.cu for M <= 16), K4 (qmm4.cu), K5 (ffn_int8.cu),
     K6 and T2 (w8a8.cu), K7
     (mega_beam.cu), K8 (mega_batch.cu), K9a/K9b (cross_q8.cu) and T1
     (mm_bf16.cu) with nvcc, one process per source, all at once, timed;
  3. K1 against its plain torch version on the card: bf16 at the
     large-v3-turbo encoder shape (B=1, T=1536, S=1280, n_valid=1500,
     gate max|err| <= 1e-2 * max|ref|) and f32 at the narrow models' shape
     (S=128) and at large-v3-turbo's width (S=1280), gate 2e-5; kernel,
     plain and SDPA times (CUDA events, median of 20), the bound, the bound
     of the bf16 kernel's two-pass work (QK^T twice) and the TFLOP/s it
     reaches, and of the f32 body's 3xTF32 products;
     K3, K4 and K5 against their plain versions at the shapes large-v3-turbo
     gives them (gate 1e-3 * max|ref|), with kernel, plain and library times
     (torch.matmul on the dequantized bf16 weight), each launch with a cold
     L2 cache, the bound and the kernel's share of it; at K3's rows-route
     shapes (1 x 1280 -> 1280 and -> 3840, 5 x 1280 -> 3840, W8 logits) and
     K4's (the W4 logits at 1, 5 and 8 rows, on the rows body) also the
     kernel's and torch.matmul's device times queued behind a spin, with
     the bound's share of the queued time (K4 also the call and host_us),
     and two launches bit-equal (the splits' ordered combine); K5 at 1, 5, 8 and 16 rows (the rows body)
     likewise queued, two launches bit-equal; the tiles routes above 16
     rows (K3: two launches bit-equal and the output's digest; K5 at 24, 40,
     64 and 227 rows and K4 on the W4 logits at 17 and 64, both on the TMA +
     wgmma tiles of qmm_wgmma.cuh: queued, two launches bit-equal, the
     plan's splits and blocks); K2 (the whole decoder
     step) at large-v3-turbo
     width (4 layers, 448 cache rows, 1500 audio positions, vocabulary
     51866) in its four modes (dense, int8 logits, int8, int4): 8
     consecutive steps from a cache with 100 rows of history, each from the
     same inputs as its plain version (logits and the new cache rows
     within 2e-2 of max|ref|, K2_TOL), two launches from the same inputs
     bit-equal, the step's device time queued behind a spin (its "ms"), the
     call with its host time and the host's time to issue one step
     (host_us), beside the plain step and the port's decode_impl step on
     the same weights (the yardstick; no single library call computes a
     step), each with a cold L2 cache, the bound and its share of the
     device time (with --profile also each of the 33 launches' traced
     device time); K7 (the beam step) at the same
     width for B = 5 beams in the same four modes: 8 steps at heads 126-129
     and 254-257 (across the self-attention's 128-row time-block edges)
     with lineage reorders, from a cache whose slot 0 holds 100 prompt rows
     and whose later rows hold random K/V with a random lineage, each from
     the same inputs as its plain version (logits within K2_TOL of
     max|ref|, the same argmax per beam except on rows whose two best plain
     logits lie within 1e-2 of max|ref|, K7_ARGMAX_GAP, the new cache rows
     of layer 0 within one bf16 step), and the same steps at B = 2 and 8;
     at head 258 two launches bit-equal, x0, the head and the origin table
     written behind a spin giving the same bits, B identical beams with
     one lineage B bit-equal rows, the step queued (device time, its "ms"
     in the kernels line), the call and host_us, and at B = 5 the plain
     step, the decode_impl step over 5 beams and five K2 steps on the same
     weights (the yardsticks), and the bound and its share; K2's speculative
     verify rows (R = 5 and 8, the verify passes of gamma = 4 and 7) at the
     same width in the four modes on a cache of n_text_ctx + 11 rows: one
     R-row step bit-equal to R one-row K2 steps at heads 126, 448 - R and
     Tc - 8 on the same cache, and at the first two also on a 448-row cache
     (the greedy loop's), logits and cache rows; within K2_TOL of the plain
     R-row step; at head 258 the step queued, the call and host_us against
     R one-row K2 steps, the plain step and the decode_impl step at T = R,
     and the bound;
  4. Transcriber(preset="large-v3-turbo", bf16, cuda, seed 0) answers 30 s
     of seeded synthetic audio (its weights answer 65 s in phase 36); K1's
     launch count must be exactly 32 (encoder layers) per encoder pass;
  5. the narrow f32 config through whisper_full on cuda and on cpu:
     encoder outputs within 1e-4, token ids equal;
  6. a full-width large-v3-turbo q8_0 checkpoint (the port's writer, seed-0
     random tensors) through Transcriber(model_path=...) on cuda: 30 s and
     65 s requests (temperature_inc = 0), which run K2 by themselves (its
     int8 mode) for every token step; K3 must launch exactly 200 per
     encoder pass (32 layers x 6 linears + 4 layers x cross K/V) and 16 per
     decode_impl call (prompt ingest: 4 layers x qkv/o/cq/co), by route: the
     encoder's and the decoder calls over more than 16 rows on the tiles,
     the others on the rows (check_k3_routes), K5 4 per
     decode_impl call, K2 once per token step; then one 30 s request with
     megakernel=False, whose token steps run decode_impl (K3 and K5); then
     the main path of beam search: a 30 s request with beam_size=5, every
     beam token step one K7 launch (auto) and K2 never; then K7's witness
     on the main path: a 65 s beam-5 request with K7 and its plain version
     in lockstep on the same caches in every step (logits within K2_TOL,
     heads past 128), and the same request with the plain version alone,
     the two transcripts compared;
  7. runtime W8 logits (decoder_int8=True; K3 once per decoder call) and W4
     logits (quantize_decoder_int8(logits_bits=4); K4 once per decoder call)
     on the seed-0 turbo preset, one 30 s greedy request each (K4 by route,
     then K4 on that plane at one row: queued, the call and host_us), after
     the same request on the dense logits projection and, on the same weights,
     with megakernel=True (K2 dense) and megakernel="int4" (K2 int4); and
     beam_size=5 on the same weights with megakernel=False (decode_impl over
     5 beams) and megakernel="int4" (K7 int4);
  8. narrow q4_0 and q5_0 checkpoints (S = 128: the decoder MLP runs K5)
     through whisper_full on cuda and on cpu, 35 s over two windows: token
     ids equal, at least 100 of them;
  9. a narrow bf16 q8_0 checkpoint with megakernel="int8" (K2 on the card,
     its plain version on the CPU), 35 s: token ids equal, at least 100;
     then K2 alone from one encoder output (EncoderReplay: the card's
     token loop starts from the CPU's encoder output and cross-KV), audio
     seeds 3, 4 and 9: per stream the equal tokens and, where it parts
     before 100, the step and the CPU's top-two gap there (a parting that
     is not a near tie, within K7_ARGMAX_GAP of max|logit|, fails);
 10. beam search (beam_size=3, 40 s) on the card against the CPU: the
     narrow f32 config (decode_impl, the device beam loop's sort, dedupe and
     gathers on the card) with token ids equal, at least 100; and the
     narrow bf16 q8_0 checkpoint with megakernel="int8" (K7 on the card, its
     plain version on the CPU) on three 40 s requests, token ids equal;
     then K7 alone from one encoder output, 90 s requests on audio seeds 3
     and 4, as phase 9's (the parting step: the first whose three best
     ids differ on a beam's row, the gap the least between the CPU's four
     best there; no request of this checkpoint keeps the CPU's beam
     candidates apart for 100 tokens: tests/_torch_q8_seed_scan.py);
 11. K6 (the W8A8 matmul) against its plain version, bit for bit, at the
     four encoder linears of large-v3-turbo for one window (M = 1536) and
     a round of eight (M = 12288) and a narrow padding shape; kernel,
     plain, torch._int_mm with the same quantize and scale ops (library)
     and dense bf16 torch.matmul times, cold L2, and the int8 bound;
 12. K1 at B = 8 windows (a batched round's encoder attention);
 13. K8 (the batched-stream step) at large-v3-turbo width, B = 8 streams
     with distinct cross-KV, in the four modes: 8 steps at heads 126-129
     and 254-257 against its plain version (K2_TOL, K7's argmax rule); at
     head 258 two launches bit-equal, x0 and the head written behind a
     spin giving the same bits, eight identical streams eight bit-equal
     rows; the step queued (device time, its "ms" in the kernels line), the call
     and host_us against the plain step, the decode_impl step over 8
     streams and eight K2 steps, and the bound (each stream's cross-KV)
     and its share;
 14. batched serving at full width on the seed-0 turbo preset: the W8A8
     encoder against the dense one (cosine > 0.98, relative error < 0.1)
     and both timed on a round of 8 windows; transcribe_batch of 8 x 30 s
     with the W8A8 encoder and K8 int8 (the main path of the kernels line's
     K6 and K8 launches), with megakernel=False, and with the dense
     encoder; full_parallel of 240 s over 8 chunks; a 30 s whisper_full
     request with the W8A8 encoder; transcribe_batch on the q8_0 checkpoint
     with the W8A8 encoder and K8. Each prints audio seconds per second, ms
     per lockstep step and encoder ms per round, and holds the launch
     counts exact (K6 128 and K1 32 per encoder pass, K8 once per lockstep
     step, K7 never, K2 only in chunks the quality gates send to
     whisper_full);
 15. narrow batched serving on the card against the CPU: f32
     transcribe_batched (token ids equal, at least 100) and the bf16 q8_0
     checkpoint's transcribe_batch with megakernel="int8" (K8 on the card,
     its plain version on the CPU), token ids equal on audio seed 4 (148
     tokens), the first differing token of seed 5 printed (the two
     swapped places with K8 on K2's GEMVs, Q8_BATCH_SEEDS); then, for seeds 4
     and 5, the first-step logits of the card's prompt ingest from the
     CPU's encoder output, copied over, against the CPU's, beside the whole
     card path's (ingest_split); then K8 alone: the same batch with the
     lockstep loop on the card from the CPU's encoder output and cross-KV,
     per stream the equal tokens and where it parts, as phase 9's;
 16. speculative greedy decoding at full width: the q8_0 checkpoint
     (Transcriber(model_path=..., draft_model_path=...)) serves 30 s and
     65 s greedily with K2, then with a q4_0 draft of its own seed-0 tensors
     (gamma 4) and, on 30 s, a q8_0 draft of seed-1 tensors (gamma 7; the
     drafts written by a process of their own during phases 6-15), K2 int8 for the
     draft steps and the verify passes (temperature_inc = 0): each
     transcript equal to K2 greedy's token for token, launch counts exact
     (per round gamma + 1 one-row K2 steps and one K2 call at gamma + 1
     rows, verify passes between the live rounds and POLL - 1 more a
     window, prompt ingest through decode_impl, K1/K3/K5 per encoder pass
     and decode_impl call); acceptance, rounds and ms per sampled token
     beside greedy's; the verify launches go to the kernels line as
     mega_decode_step_verify;
 17. narrow speculative decoding on the card against the CPU: bf16 q8_0
     with a q4_0 draft, megakernel="int8", gamma 4, 35 s: token ids equal
     (148), and on the card equal to K2 greedy;
 18. K9b (cross_attention_q8) and K9a (cross_attention_q8_nat) against
     their plain versions at large-v3-turbo width (20 heads, 1500 audio
     positions, bf16, gate 1e-2 of max|ref|): K9b for one row, five rows
     over one shared plane and eight streams, K9a for eight streams on
     1504-row slabs with ta_valid = 1500; and a narrow f32 shape (gate 1e-5);
     kernel (one launch over clusters of key chunks: queued, the call and
     host_us), plain and SDPA over the float cross-KV that int8 replaces
     (CUDA events, cold L2, median of 20), the byte bound and its share;
 19. int8 cross-KV on the q8_0 checkpoint (cross_kv_int8=True,
     temperature_inc = 0): greedy 30 s and 65 s (the K-window loop), 30 s
     with device_windows=1, beam 5 on 30 s, each beside the same request
     with float cross-KV and megakernel=False (ms per sampled token);
     launch counts exact: K9b 4 per one-row decode_impl call, K2 and K7
     never, K3/K5/K1 as phase 6's megakernel=False request;
 20. (inside phase 14) transcribe_batch of 8 x 30 s with the W8A8 encoder
     and cross_kv_int8 (megakernel="int8" asked): K8 never, K9b 4 per
     one-row decode_impl call (every lockstep step), K6 128 per encoder
     pass; audio s per s and ms per lockstep step beside megakernel=False
     with float cross-KV;
 21. K9a on its path: 8 decode_impl steps at B = 8 on the q8_0 decoder
     over QuantKVNat planes against the same steps over QuantKV planes of
     the same cross-KV: logits within 5e-3 of max|ref|, 4 K9a launches per
     step;
 22. narrow f32 (3 decoder layers) with cross_kv_int8 on the card against
     the CPU: greedy 35 s, beam 3 on 40 s, transcribe_batched of 60 s in 2
     chunks: token ids equal, at least 100 each, K9b launched on the card.
 23. T1 (mm_bf16, the bf16 GEMM) and T2 (mm_s8, K6's s8 GEMM alone) of the
     tensor-core probe against their plain versions at its two products,
     (1536,1280)@(1280,5120) and (1536,5120)@(5120,1280), on the probe's
     operands: T1 within one bf16 ulp per element (plus the f32 sum-order
     bound where products cancel), T2 bit for bit; kernel, plain and
     library times (cuBLAS bf16 through torch.mm with f32 out; _int_mm with
     the scale ops), cold L2, the bound and T1's and cuBLAS's shares of the
     bf16 peak; T2 also bit for bit at the 8-window mlp0 and mlp1 products
     on seeded operands; then the port's probe
     (open_whisper_kit_tpu_torch.tools.bench_int8_mxu.main) at full shape,
     the path of T1 and T2, with exact launch counts (two per chained
     iteration per chain call).
 24. the whisper_full options at full width on phase 6's q8_0 checkpoint
     (temperature_inc = 0): a 30 s request with a GBNF grammar whose token
     automaton runs in the on-device loop with K2 (every window given the
     automaton, K2 once per token step, the host reads of a grammar-free
     window), each text token accepted by a host Grammar replay; a 30 s
     request with token-level and DTW timestamps: t_dtw monotone, each DTW
     re-decode (decode_impl over the window's T tokens) 16 K3 launches (on
     the tiles when T > 16) and 4 K5, timed, and its alignment heads'
     probabilities within 1e-2 of max of the CPU's from the same tokens and
     cross-KV; a random-weight Silero file (io/silero_writer.py): 30 s of
     VAD timed on the card, its probabilities within 1e-5 of the CPU's, and
     whisper_full(vad=True) on speech spans between silences;
 25. narrow f32 (3 decoder layers) on the card against the CPU, each option:
     a grammar in the device loop and host-stepped, ref_sampling greedy at
     t = 0.4 and beam 3 (mt19937 draws), the abort callback at step 25, the
     logits filter, token and DTW timestamps, VAD: the same token ids and
     t0 / t1 / t_dtw;
 26. SortFormer diarization at the published width (SortformerConfig():
     17 Conformer layers of 512, 18 Transformer layers of 192, 117 M
     parameters; seed-0 weights written as an f16 GGUF by the port's
     exporter) through api.Diarizer(model_path=..., device="cuda") on 90 s
     of seeded noise, presets offline and low_latency: the device AOSC loop
     (one host read a file) against the host loop on the card (equal RTTM
     segments; probabilities within 1e-5 up to the speaker cache's first
     compression, beyond it printed beside the host loop's own move when
     the input is scaled by 1 + 2^-20: the random model's near-constant
     predictions leave its top-K picks to f32 noise), each timed (ms per
     30 s of audio, host clock around a synchronize) with its host reads and
     torch.profiler's device operations per chunk; the card against the
     CPU from the same file (offline 90 s, low_latency 10 s; within 1e-4 up
     to the first compression, equal segments); the compression at full
     width on the card against the host's numpy form (scores apart) and
     the CPU's device form (exact ties); diarize_batch of 30, 45, 60 and
     90 s against the four single calls (within 1e-4 on the chunks they
     share up to the first compression); Diarizer.stream("low_latency") fed
     0.5 s pieces, the device state against the host state (1e-5 up to the
     first compression, one read a chunk), beside diarize's frames;
 27. narrow f32 (3 decoder layers) transcribe with token timestamps,
     words_from_result, the TINY diarizer and api.align on the card and on
     the CPU from the same weights: the same DiarizedTranscription.
 28. the port's HTTP server (server/http_server.py) on a thread, serving
     phase 6's q8_0 turbo checkpoint on the card (K2 auto) with a 50 ms
     batch window and phase 26's SortFormer: one 30 s /inference in json,
     srt and verbose_json, each equal to Transcriber.full on the same audio
     (texts, token ids, times); four concurrent 30 s /inference, each equal
     to a direct transcribe_chunks_with_timings of the group the batcher
     formed (its n_dispatches and max_group printed); /detect-language
     against the direct call; a /stream session of 60 s of s16le in 0.5 s
     pieces (step 3000, length 10000, keep 200) equal to an in-process
     StreamingTranscriber fed the same pieces, with ms per stream step
     (median, slowest), the stream's wall over its audio seconds and K1 /
     K2 launches per step; five stream steps at audio_ctx 768 (K1 at 768
     positions, K2's cross-attention planned for Ta 768), warmed once, ms
     per step (median, slowest), then K1 held to its plain version on the
     steps' own encoder inputs and the steps' tokens with K2 held to K2 off
     (decode_impl) from the same encoder outputs; /diarize offline
     equal to Diarizer.diarize; the HTTP and direct walls and the phase's
     seconds, beside the card's name and power limit;
 29. narrow f32 (3 decoder layers, a ggml-bin) on the card against the
     CPU: StreamingTranscriber in step mode with keep_context, in step
     mode at audio_ctx 768 and in VAD mode (the same events), and whisper-cli with -otxt -osrt -ovtt -ocsv
     -olrc -oj on the card and with -ng (the same files).
 30. the LLaMA runtime (models/llama) at Llama-2-7B's published shapes
     (meta-llama/Llama-2-7b-hf config.json: hidden 4096, 32 layers, 32
     heads, FF 11008, vocabulary 32000) at full depth in bf16, random
     weights drawn on the card and a 32000-piece SPM vocabulary built in
     the process: 612 prompt tokens ingested (512 + 100), then 128 greedy
     tokens in chunks of 16; ingest ms per token, ms per generated token,
     host reads per chunk (one), peak memory, the byte bound (every weight
     once per token at 3.35 TB/s) and its share;
 31. the same width at two layers in f32 (TF32 off) on the card against the
     CPU, the same weights: 24 host-stepped greedy steps with equal ids and
     every step's logits within 1e-4 of max|logit| (a parting named with
     the CPU's top-two gap), LlamaContext.generate's greedy text equal, a
     seeded sampled reply the same twice on the card;
 32. phase 30 at TinyLlama-1.1B's shapes (2048 hidden, 22 layers, 32 heads
     on 4 kv heads: the GQA repeat at 8, FF 5632);
 33. examples/talk's chat loop (examples.talk.chat) on phase 6's q8_0 turbo
     checkpoint (K2 auto) with TinyLlama-1.1B on the card: a seeded 3 s
     utterance, its transcript, a greedy reply (at most 32 tokens, the
     antiprompt "Georgi:"), the session snapshot saved; then the same turn
     from the restored snapshot, whose reply must be the same; K1/K2/K3/K5
     launches per turn;
 34. the language server (cli/lsp.py) on the same checkpoint:
     registerCommandset, guided (one encoder pass on K1/K3, the prompt's
     decode_impl with K5 once a layer) and unguided (whisper_full, K2),
     walls and launch counts;
 35. narrow f32 (3 decoder layers) on the card against the CPU: the
     language server's responses, and each example's main with -dev 0
     against -ng (talk with a TINY llama GGUF, voice_command with a command
     list and in VAD mode, wchess with one spoken move, diarized_transcript
     with the TINY SortFormer): the same printed output.
 36. multi-GPU serving (parallel/mesh.py, ops/decode_tp.py) on the one
     card: the tensor-parallel decode step (decode_tp) on phase 6's q8_0
     decoder planes at tp = 1 (five one-row steps from 100 rows of history
     and one five-row step) is the reference; this script started again
     as ranks (--mesh-rank) over a Gloo group, the collectives staged
     through the host: two ranks (the step at tp 2; the mesh encoder on
     phase 4's dense turbo weights at tp 2, K1 on ten heads: in f32 within
     1e-2 of max|ref| of one device; in bf16 at its first ENC_GATE_LAYERS
     layers within ENC_BF16_LIMIT, a limit that one device with its input
     scaled by 1 + 2^-20 must pass and the mesh with its f32 partials
     rounded to bf16 before the all-reduce must fail; each rank's K1 equal
     to those heads of the whole call; a 30 s greedy request on (dp 1,
     tp 2) on the q8_0 checkpoint, token ids and times equal to one
     process; full_parallel of 2 x 30 s on (dp 2, tp 1), equal to one
     process running each rank's chunk alone (DP2_SEEDS), and against one
     batch of both printed; once the card is idle, the bf16 mesh encoder
     pass and a one-row mesh decode step timed beside one device's) and
     four (the step at tp 4, padded shards): logits and cache columns
     bit-equal to tp = 1, K3 launches per rank equal to tp = 1's.
     Meanwhile a world-1 NCCL mesh (make_mesh()): Transcriber(mesh=) on
     the q8_0 checkpoint, a 30 s greedy request (one, mesh, mesh, one: the
     walls) and full_parallel of 8 x 30 s, and WhisperContext(mesh=) on
     phase 4's weights, a 65 s greedy request (three windows: the dense
     turbo's seek and prompt carry); token ids and times equal to no
     mesh, no collective. Then on the idle card: the tp = 1 step
     against K2 int8 on the same planes (queued), K3 at the tp 2 shards'
     shapes with the whole width's splits (queued, plain, torch.matmul,
     bound) and K1 on ten heads (plain, SDPA, bound).
Phases 11-13, 18 and 23 run right after phase 3, with the other kernel
checks; 19, 21 and 24 right after 6, on its checkpoint.
Every phase prints ms per sampled token beside its RTF. The last three lines are the kernels JSON, the nvidia-smi name/power line
and {"ok": true, "device": {...}}. Imports nothing of JAX.

    python3 chip_smoke.py --profile

also traces one q8_0 encoder + cross-KV pass of a 30 s window (the
encoder's kernel split), one 30 s greedy request on the q8_0 checkpoint, one beam-5
request on it (K7), one greedy request on the dense preset, one
transcribe_batch of 8 x 30 s (W8A8 encoder, K8 int8) and one call of each
of the tensor-core probe's four chains with torch.profiler
(device busy share, top kernels; tables in chiprun_out/), and in phase 3
five K2 steps per mode at one row and int8 at five and eight
(chiprun_out/k2-stages-*.json: each launch's device time and how many
start before the one in front ends). It is the source of PERF.md's
"Where the time goes".
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TURBO_LAYERS = 32
NARROW = (51864, 1500, 128, 2, 2, 448, 128, 2, 2, 80)
NARROW_Q = (51864, 1500, 128, 2, 2, 448, 128, 2, 3, 80)   # 3 decoder layers
TURBO = (51866, 1500, 1280, 20, 32, 448, 1280, 20, 4, 128)
KERNELS = ("mha_packed", "mega_step", "qmm", "qmm_rows", "qmm4", "ffn_int8", "mega_beam",
           "w8a8", "mega_batch", "cross_q8", "mm_bf16")
SRC = "open_whisper_kit_tpu_torch/csrc/"
# H100 SXM published HBM bandwidth (NVIDIA data sheet): the bound of a
# kernel is the larger of its bytes over it and its operations over the
# tensor-core rate of their type (bound())
HBM_BYTES_PER_S = 3.35e12
F32_PEAK = 67e12   # H100 SXM f32 outside the tensor cores (NVIDIA data sheet)
TF32_PEAK = 495e12   # H100 SXM dense TF32 on the tensor cores (NVIDIA data sheet)


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3, flush=None,
            queued: bool = False) -> float:
    """Median device time of fn() in ms over `reps` launches. `flush`, a
    tensor larger than the L2 cache, is overwritten before each timed
    launch (outside the timed span), so fn reads its inputs from HBM as a
    caller streaming many weights does. The span starts when the card
    reaches it: a call whose host side (the wrapper's checks, allocations
    and launches) outlasts its kernels is timed with that host time in it.
    `queued` puts a 1 ms spin on the card before the span, so the host
    has issued fn's launches before the span starts: the span then holds
    the kernels and the gaps between them only."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if queued:
            torch.cuda._sleep(2_000_000)     # about 1 ms at the H100's clock
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(torch, fn, reps: int = 50) -> float:
    """Median µs of host time one call of fn() takes to return (its checks
    and launches), each call made on an idle card (a synchronize between
    calls, outside the timed span)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


# K2's 33 launches of one large-v3-turbo step, in chain order
K2_STAGES = [f"L{il} {s}" for il in range(4) for s in (
    "qkv", "self-attend", "o", "cq", "cross-attend", "co", "mlp0", "mlp1")] + ["logits"]


def k2_stage_trace(torch, tag: str, fn, steps: int = 5) -> dict:
    """`steps` calls of fn() (one K2 step each), queued behind a spin, under
    torch.profiler: from the trace's kernel rows (chrome trace, written to
    chiprun_out/k2-stages-<tag>.json), each launch of the last step in chain
    order with its device µs, the chain's span from the first start to the
    last end, and how many launches start before the one in front of them
    has ended (the dependent launches' overlap)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = out / f"k2-stages-{tag}.json"
    prof.export_chrome_trace(str(path))
    kern = sorted((e for e in json.loads(path.read_text()).get("traceEvents", [])
                   if e.get("cat") == "kernel" and ("gemv" in e.get("name", "")
                                                    or "attend" in e.get("name", ""))),
                  key=lambda e: e["ts"])
    n = len(K2_STAGES)
    last = kern[-n:] if len(kern) >= n else []
    if not last:
        return {"stages": [], "span_us": None, "overlapping": None}
    stages = [{"stage": name, "us": e["dur"]} for name, e in zip(K2_STAGES, last)]
    overlap = sum(b["ts"] < a["ts"] + a["dur"] for a, b in zip(last, last[1:]))
    span = last[-1]["ts"] + last[-1]["dur"] - last[0]["ts"]
    return {"stages": stages, "span_us": span, "overlapping": overlap}


def bound(nbytes: float, flops: float, rate: str | float = "bf16") -> tuple[float, str]:
    """(least ms the card could take, what bounds it); `rate` the peak of
    the operations' type: "bf16" or "int8", the H100's dense tensor-core
    peaks as the tensor-core probe states them, or a number."""
    from open_whisper_kit_tpu_torch.tools import bench_int8_mxu as P
    rate = {"bf16": P.BF16_PEAK, "int8": P.INT8_PEAK}.get(rate, rate)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def audio(seconds: float, seed: int):
    import numpy as np
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
            .astype(np.float32) * 0.1)


def greedy_params(FullParams):
    p = FullParams(print_progress=False)
    p.temperature_inc = 0
    return p


def phase_k1(torch, A, dtype, S: int, tol_rel: bool, tol: float, seed: int, B: int = 1,
             tag: str = "3"):
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, 1536, S, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    n_head, scale, n_valid = S // 64, 0.125, 1500
    ref = A.mha_plain(q, k, v, n_head, scale, n_valid)
    out = A.mha_packed(q, k, v, scale, n_valid)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    limit = tol * ref_max if tol_rel else tol
    print(f"[{tag}] K1 {dtype} ({B},1536,{S}) n_valid={n_valid}: max|err| {err:.3e} "
          f"max|ref| {ref_max:.3e} limit {limit:.3e}", flush=True)
    check(bool(torch.isfinite(out).all()) and err <= limit,
          f"K1 {dtype} S={S} disagrees with its plain version")
    kern = cuda_ms(torch, lambda: A.mha_packed(q, k, v, scale, n_valid))
    plain = cuda_ms(torch, lambda: A.mha_plain(q, k, v, n_head, scale, n_valid))
    # the yardstick: SDPA on the head-major layout it takes, same mask
    qh, kh, vh = (t.view(B, 1536, n_head, 64).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    mask = (torch.arange(1536, device="cuda") < n_valid)[None, None, None, :]
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=scale))
    # QK^T and PV over the live keys; q/k/v read once, out written once; f32
    # operations at the H100's f32 (non-tensor) peak, bf16 at its tensor peak
    flops = 4 * B * 1536 * n_valid * S
    b_ms, b_by = bound(nbytes(q, k, v, out), flops,
                       F32_PEAK if dtype == torch.float32 else "bf16")
    if dtype == torch.float32:
        # the f32 body's own work: the same products in 3xTF32, three TF32
        # products each, at the tensor cores' TF32 peak
        tf32_ms, _ = bound(nbytes(q, k, v, out), 3 * flops, TF32_PEAK)
        print(f"[{tag}]   kernel {kern * 1e3:.1f} us, plain {plain * 1e3:.1f} us, SDPA "
              f"{lib * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}), {100 * b_ms / kern:.1f} "
              f"% of it; 3xTF32 bound {tf32_ms * 1e3:.1f} us (median of 20)", flush=True)
        return {"shape": f"({B},1536,{S}) f32, {n_valid} keys", "max_abs_err": err,
                "ms": kern, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib, "bound_share": b_ms / kern, "tf32x3_bound_ms": tf32_ms}
    # the bf16 kernel's own work: QK^T twice (the TPU kernel's rounding point
    # needs the row sums before P is rounded), then PV
    two_ms, _ = bound(nbytes(q, k, v, out), 1.5 * flops)
    tflops = 1.5 * flops / (kern * 1e-3) / 1e12
    print(f"[{tag}]   kernel {kern * 1e3:.1f} us, plain {plain * 1e3:.1f} us, SDPA "
          f"{lib * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}), two-pass bound "
          f"{two_ms * 1e3:.1f} us, {tflops:.0f} TFLOP/s of two-pass work (median of 20)",
          flush=True)
    return {"max_abs_err": err, "ms": kern, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib, "two_pass_bound_ms": two_ms,
            "tflops": tflops}


# (kernel, what large-v3-turbo runs it on, M, K, N)
QUANT_SHAPES = [
    ("qmm", "encoder mlp0", 1536, 1280, 5120),
    ("qmm", "encoder q/k/v/o", 1536, 1280, 1280),
    ("qmm", "encoder mlp1", 1536, 5120, 1280),
    ("qmm", "cross-KV k/v", 1500, 1280, 1280),
    ("qmm", "decoder qkv, 1 row", 1, 1280, 3840),
    ("qmm", "decoder qkv, 5 rows", 5, 1280, 3840),
    ("qmm", "decoder o/cq/co, 1 row", 1, 1280, 1280),
    ("qmm", "W8 logits, 1 row", 1, 1280, 51866),
    ("qmm4", "W4 logits, 1 row", 1, 1280, 51866),
    ("qmm4", "W4 logits, 5 rows", 5, 1280, 51866),
    ("qmm4", "W4 logits, 8 rows", 8, 1280, 51866),
    ("ffn_int8", "decoder MLP, 1 row", 1, 1280, 5120),
    ("ffn_int8", "decoder MLP, 5 rows", 5, 1280, 5120),
    ("ffn_int8", "decoder MLP, 8 rows", 8, 1280, 5120),
    ("ffn_int8", "decoder MLP, 16 rows", 16, 1280, 5120),
    # the tiles routes above 16 rows: K5 at the prompt ingests (8 lockstep
    # streams of 3-4 tokens; kernel_times.py's 40; the host-stepped and DTW
    # 64-row buckets; one window's 1 + 223 + 3), K4 on the W4 logits past the
    # rows body (speculative verify at gamma >= 16, full logits)
    ("ffn_int8", "prompt ingest, 24 rows", 24, 1280, 5120),
    ("ffn_int8", "prompt ingest, 40 rows", 40, 1280, 5120),
    ("ffn_int8", "prompt ingest, 64 rows", 64, 1280, 5120),
    ("ffn_int8", "prompt ingest, 227 rows", 227, 1280, 5120),
    ("qmm4", "W4 logits, 17 rows", 17, 1280, 51866),
    ("qmm4", "W4 logits, 64 rows", 64, 1280, 51866),
]


def phase_quant_kernels(torch, Q):
    """Each shape: kernel against plain (gate 1e-3 * max|ref|), times of
    the kernel, the plain version and the library yardstick with the L2
    cache flushed before each launch (on the decode path every weight
    plane arrives cold), and the bound. The bound counts the logical N
    columns only: the planes' padding to a multiple of 128 is zeros that
    the function does not need. K3's rows-route shapes (M <= 16, kernel
    "qmm_rows") are also timed queued behind a spin (cuda_ms's `queued`:
    the device time without the wrapper's host time) for the kernel and the
    library call, and two launches must give the same bits; so are K5's
    (on the rows body at these rows since PR 15: two launches, the second a
    dependent launch). Returns {kernel: [per-shape dicts]}; a rows-route
    dict's "ms" and "library_ms" are the queued times, "ms_unqueued" and
    "library_ms_unqueued" the others."""
    g = torch.Generator(device="cuda").manual_seed(0)
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def weight(K, N):
        return torch.randn(K, N, generator=g, device="cuda") * K ** -0.5

    out = {name: [] for name in ("qmm", "qmm_rows", "qmm4", "ffn_int8")}
    for name, label, M, K, N in QUANT_SHAPES:
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        if name == "ffn_int8":
            w0 = Q.quantize_linear(weight(K, N), pad=False)
            w1 = Q.quantize_linear(weight(N, K))
            b0 = (torch.randn(N, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
            args = (x, w0.qs, w0.scales, b0, w1.qs, w1.scales)
            kern, plain = Q.ffn_int8, Q.ffn_int8_plain
            lib_fn = None   # no single library call computes the fused pair
            flops = 2 * M * K * N + 2 * M * N * K
            moved = (nbytes(x, w0.qs, w0.scales, b0, w1.qs[:, :K], w1.scales[:, :K])
                     + M * K * 4)
        else:
            w = (Q.quantize_linear4 if name == "qmm4" else Q.quantize_linear)(weight(K, N))
            args = (x, w.qs, w.scales)
            kern, plain = (Q.qmm4, Q.qmm4_plain) if name == "qmm4" else (Q.qmm, Q.qmm_plain)
            wd = Q.dequantize_dense(w, torch.bfloat16).contiguous()
            lib_fn = lambda x=x, wd=wd: torch.matmul(x, wd)   # noqa: E731
            flops = 2 * M * K * N
            moved = nbytes(x, w.qs[:, :N], w.scales[:, :N]) + M * N * 4
        ref = plain(*args)
        got = kern(*args)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        check(bool(torch.isfinite(got).all()) and err <= 1e-3 * ref_max,
              f"{name} ({label}) disagrees with its plain version: {err:.3e} "
              f"> 1e-3 * {ref_max:.3e}")
        k_ms = cuda_ms(torch, lambda: kern(*args), flush=l2_flush)
        p_ms = cuda_ms(torch, lambda: plain(*args), flush=l2_flush)
        l_ms = cuda_ms(torch, lib_fn, flush=l2_flush) if lib_fn is not None else None
        b_ms, b_by = bound(moved, flops)
        row = {"shape": f"{label}: M={M} K={K} N={N}", "max_abs_err": err,
               "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms}
        lib_txt = f"{l_ms * 1e3:.1f} us" if l_ms is not None else "none"
        print(f"[3] {name} {label} (M={M}, K={K}, N={N}): max|err| {err:.3e} "
              f"(max|ref| {ref_max:.3e}); kernel {k_ms * 1e3:.1f} us, plain "
              f"{p_ms * 1e3:.1f} us, library {lib_txt}, bound {b_ms * 1e3:.1f} us "
              f"({b_by}), {100 * b_ms / k_ms:.1f} % of the bound", flush=True)
        if name == "qmm" and Q.qmm_route(M) == "rows":
            name = "qmm_rows"
            again = kern(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"qmm rows route ({label}): two launches differ")
            kq_ms = cuda_ms(torch, lambda: kern(*args), flush=l2_flush, queued=True)
            lq_ms = cuda_ms(torch, lib_fn, flush=l2_flush, queued=True)
            plan = Q.qmm_rows_plan(M, K, args[1].shape[1])
            row.update(ms=kq_ms, library_ms=lq_ms, ms_unqueued=k_ms, library_ms_unqueued=l_ms,
                       bound_share=b_ms / kq_ms, splits=plan.splits, blocks=plan.blocks)
            print(f"[3]   qmm rows route, queued (device time): kernel {kq_ms * 1e3:.1f} us, "
                  f"torch.matmul {lq_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us, "
                  f"{100 * b_ms / kq_ms:.1f} % of the bound; kernel / matmul "
                  f"{kq_ms / lq_ms:.2f}; {plan.splits} splits, {plan.blocks} blocks; two "
                  "launches bit-equal", flush=True)
            del again
        elif name == "qmm4" and Q.qmm_route(M) == "rows":
            again = kern(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"qmm4 rows body ({label}): two launches differ")
            kq_ms = cuda_ms(torch, lambda: kern(*args), flush=l2_flush, queued=True)
            lq_ms = cuda_ms(torch, lib_fn, flush=l2_flush, queued=True)
            h_us = host_us(torch, lambda: kern(*args))
            plan = Q.qmm4_rows_plan(M, K, args[1].shape[1])
            row.update(ms=kq_ms, call_ms=k_ms, host_us=h_us, library_ms=lq_ms,
                       library_ms_unqueued=l_ms, bound_share=b_ms / kq_ms,
                       body="rows: qmm_rows.cuh with the int4 stage", splits=plan.splits,
                       blocks=plan.blocks)
            print(f"[3]   qmm4 on the rows body, queued (device time): kernel {kq_ms * 1e3:.1f} "
                  f"us, the call {k_ms * 1e3:.1f} us, host {h_us:.1f} us, torch.matmul "
                  f"{lq_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us, {100 * b_ms / kq_ms:.1f} % of "
                  f"the bound; {plan.splits} split(s), {plan.blocks} blocks; two launches "
                  "bit-equal", flush=True)
            del again
        elif name == "ffn_int8" and Q.ffn_int8_route(M) == "rows":
            again = kern(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"ffn_int8 ({label}): two launches differ")
            kq_ms = cuda_ms(torch, lambda: kern(*args), flush=l2_flush, queued=True)
            plan = Q.ffn_int8_rows_plan(M, K, N, args[4].shape[1])
            row.update(ms=kq_ms, ms_unqueued=k_ms, bound_share=b_ms / kq_ms,
                       body="rows: qmm_rows.cuh twice, the second a dependent launch",
                       splits=[plan.up.splits, plan.down.splits],
                       blocks=[plan.up.blocks, plan.down.blocks])
            print(f"[3]   ffn_int8 on the rows body, queued (device time): kernel "
                  f"{kq_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us, "
                  f"{100 * b_ms / kq_ms:.1f} % of the bound; splits {plan.up.splits} / "
                  f"{plan.down.splits}, blocks {plan.up.blocks} / {plan.down.blocks}; two "
                  "launches bit-equal", flush=True)
            del again
        elif Q.qmm_route(M) == "tiles":   # K3, K4 and K5 on the TMA + wgmma tiles
            again = kern(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"{name} tiles ({label}): two launches differ")
            digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
            row.update(digest=digest)
            clusters = Q.tiles_clusters(0)
            if name == "ffn_int8":
                tp = Q.ffn_int8_tiles_plan(M, K, N, args[4].shape[1], clusters=clusters)
                row.update(splits=[tp.up.splits, tp.down.splits],
                           blocks=[tp.up.blocks, tp.down.blocks])
            elif name == "qmm4":
                tp = Q.tiles_plan(M, K, args[1].shape[1], bits=4, clusters=clusters)
                row.update(splits=tp.splits, blocks=tp.blocks)
            if name != "qmm":
                kq_ms = cuda_ms(torch, lambda: kern(*args), flush=l2_flush, queued=True)
                lq_ms = (cuda_ms(torch, lib_fn, flush=l2_flush, queued=True)
                         if lib_fn is not None else None)
                row.update(ms=kq_ms, ms_unqueued=k_ms, library_ms=lq_ms,
                           library_ms_unqueued=l_ms, bound_share=b_ms / kq_ms)
                lib_txt = f"{lq_ms * 1e3:.1f} us" if lq_ms is not None else "none"
                print(f"[3]   {name} tiles, queued (device time): kernel {kq_ms * 1e3:.1f} us, "
                      f"library {lib_txt}, bound {b_ms * 1e3:.2f} us, "
                      f"{100 * b_ms / kq_ms:.1f} % of the bound; splits {row['splits']}, "
                      f"blocks {row['blocks']}", flush=True)
            print(f"[3]   {name} tiles: two launches bit-equal, digest {digest}", flush=True)
            del again
        out[name].append(row)
        del args, ref, got
    del l2_flush
    torch.cuda.empty_cache()
    return out


K2_MODES = ("none", "logits", "all", "int4")
K2_HISTORY, K2_STEPS = 100, 8
# K2 against its plain version: the two sum in different f32 orders, so a
# bf16 rounding of the residual stream flips now and then, and each later
# layer carries the flips on. Layer 0's new cache rows agree within one
# bf16 step (<= 1e-3 of their max); layers 1-3 and the logits, at this
# width and depth, within 0.6-1.1 % of max|ref| (H100 80GB HBM3, 700 W).
# Stated tolerance: 2e-2 of max|ref|, the JAX package's own for this
# kernel (tests/test_decode_megakernel.py).
K2_TOL = 2e-2


def turbo_decoder(torch, TM, Q, cfg, mode):
    """Seeded random large-v3-turbo decoder weights on the card, prepared
    (fused qkv), and the decoder decode_impl runs for the same mode: dense;
    W8 logits plane; every matmul int8 (K3/K5); every matmul and the
    logits int4 (K4)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    L, S, V = cfg.n_text_layer, cfg.n_text_state, cfg.n_vocab

    def w(*shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    blocks = {n: w(L, S, scale=0.02) for n in (
        "attn_ln_b", "cross_ln_b", "mlp_ln_b", "q_b", "v_b", "o_b", "cq_b", "co_b", "mlp1_b")}
    blocks.update({n: torch.ones(L, S, dtype=torch.bfloat16, device="cuda")
                   for n in ("attn_ln_w", "cross_ln_w", "mlp_ln_w")})
    blocks.update({n: w(L, S, S) for n in ("q_w", "k_w", "v_w", "o_w", "cq_w", "co_w")})
    blocks.update(mlp0_w=w(L, S, 4 * S), mlp0_b=w(L, 4 * S, scale=0.02),
                  mlp1_w=w(L, 4 * S, S))
    dec = TM.prepare_decoder({
        "te": w(V, S, scale=0.02), "pe": w(cfg.n_text_ctx, S, scale=0.02),
        "blocks": blocks, "ln_w": torch.ones(S, dtype=torch.bfloat16, device="cuda"),
        "ln_b": w(S, scale=0.02)})
    if mode == "logits":
        return dec, TM.quantize_decoder_int8(dec)
    if mode == "all":
        return dec, TM.quantize_decoder_int8(dec, scope="all")
    if mode == "int4":
        b4 = dict(dec["blocks"])
        for n in ("qkv_w", "o_w", "cq_w", "co_w", "mlp0_w", "mlp1_w"):
            b4[n] = Q.stack([Q.quantize_linear4(dec["blocks"][n][il]) for il in range(L)])
        return dec, {**dec, "blocks": b4, "te_logits": Q.quantize_linear4(dec["te"].t())}
    return dec, dec


def k2_bytes_ops(MK, mp, cfg, n_keys: int, Ta: int, rows: int = 1,
                 cross_streams: int = 1, self_shared: bool = False) -> tuple[int, int]:
    """Bytes a step over `rows` rows must move (every plane on its logical
    columns with its scales, biases and layernorm rows, the cross-KV (one,
    or one per stream: `cross_streams`), the self-KV rows each row attends
    (`self_shared`: the rows are consecutive tokens of one stream, whose
    n_keys rows are read once for all), x0 and the logits, each once) and
    its operations (2 per weight per row, and QK^T and P.V over the self
    and cross keys per row)."""
    L, S, V = cfg.n_text_layer, cfg.n_text_state, cfg.n_vocab
    moved, weights = 0, 0
    for name in MK.WEIGHTS:
        w = getattr(mp, name)
        cols = V if name == "teT" else None
        for t in ((w.qs, w.sc) if hasattr(w, "qs") else (w,)):
            t = t[..., :cols] if cols else t
            moved += t.numel() * t.element_size()
        K, N = ({"qkv_w": (S, 3 * S), "mlp0_w": (S, 4 * S), "mlp1_w": (4 * S, S),
                 "teT": (S, V)}.get(name, (S, S)))
        weights += K * N * (1 if name == "teT" else L)
    moved += sum(getattr(mp, n).numel() * 2 for n in (
        "qkv_b", "o_b", "cq_b", "co_b", "mlp0_b", "mlp1_b", "lnw", "lnb"))
    self_rows = n_keys if self_shared else rows * n_keys
    moved += L * 2 * (cross_streams * Ta + self_rows) * S * 2 + rows * (S * 2 + V * 4)
    ops = rows * (2 * weights + L * 4 * (n_keys + Ta) * S)
    return moved, ops


def phase_k2(torch, TM, MK, Q, profiling: bool = False):
    """K2 at large-v3-turbo width in each mode: K2_STEPS consecutive steps
    from a cache holding K2_HISTORY rows, each kernel step against the
    plain step on the same inputs (logits and the new cache rows within
    K2_TOL of max|ref|), and two launches from the same inputs bit-equal;
    times with a cold L2 cache of the kernel step queued behind a spin (its
    device time, "ms"), of the call with its host time ("call_ms"), of the
    plain step and the decode_impl step (the yardstick); the host's time to
    issue one step ("host_us"); the bound. With `profiling`, each launch's
    device time in a traced step (k2_stage_trace). Returns {mode: row}.
    K2's "ms" in the kernels line is this queued device time; the kernels
    lines of older trees held the call, host time included, under that key
    (now "call_ms")."""
    cfg = TM.WhisperConfig(*TURBO)
    L, S, Tc, Ta = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_ctx, cfg.n_audio_ctx
    g = torch.Generator(device="cuda").manual_seed(1)
    xk, xv = ((torch.randn(L, 1, Ta, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
              for _ in range(2))
    hist = (torch.randn(2, L, 1, Tc, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    hist[:, :, :, K2_HISTORY:] = 0
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for mode in K2_MODES:
        dec, ydec = turbo_decoder(torch, TM, Q, cfg, mode)
        mp = MK.prepare_mega(cfg, ydec if mode in ("logits", "all") else dec, quant=mode)
        kk, kv, pk, pv = (hist[i % 2].clone() for i in range(4))
        toks = torch.randint(0, cfg.n_vocab, (K2_STEPS,), generator=g, device="cuda")
        err = ref_max = cache_err = 0.0
        layer_err = [0.0] * L
        for i in range(K2_STEPS):
            # the same inputs each step: the kernel's cache is the plain one's
            kk.copy_(pk)
            kv.copy_(pv)
            head = torch.tensor(K2_HISTORY + i, device="cuda")
            x0 = (dec["te"][toks[i]] + dec["pe"][head])[None].to(torch.bfloat16)
            ref, _, _ = MK.mega_decode_step_plain(cfg, mp, x0, pk[:, 0], pv[:, 0], head,
                                                  xk[:, 0], xv[:, 0])
            got, _, _ = MK.mega_decode_step(cfg, mp, x0, kk[:, 0], kv[:, 0], head,
                                            xk[:, 0], xv[:, 0])
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()) and got.shape == ref.shape,
                  f"K2 {mode}: non-finite or misshapen logits")
            e, m = (got - ref).abs().max().item(), ref.abs().max().item()
            check(e <= K2_TOL * m, f"K2 {mode} step {i}: logits differ from the plain "
                  f"version: {e:.3e} > {K2_TOL} * {m:.3e}")
            err, ref_max = max(err, e), max(ref_max, m)
            row = K2_HISTORY + i
            for a, b in ((kk, pk), (kv, pv)):
                ra, rb = a[:, 0, row].float(), b[:, 0, row].float()
                per_layer = ((ra - rb).abs().amax(dim=1) / rb.abs().max()).tolist()
                layer_err = [max(x, y) for x, y in zip(layer_err, per_layer)]
                cache_err = max(cache_err, max(per_layer))
                check(torch.equal(a[:, :, :row], b[:, :, :row]) and not a[:, :, row + 1:].any(),
                      f"K2 {mode}: cache rows other than the written one changed")
        check(cache_err <= K2_TOL, f"K2 {mode}: new cache rows differ from the plain "
              f"version ({cache_err:.3e} of their max)")
        head = torch.tensor(K2_HISTORY + K2_STEPS, device="cuda")
        x0 = (dec["te"][toks[0]] + dec["pe"][head])[None].to(torch.bfloat16)
        # two launches from the same inputs: the same bits (no float atomics;
        # the splits and the key chunks combine in a fixed order)
        twice = []
        for _ in range(2):
            kk.copy_(pk)
            kv.copy_(pv)
            twice.append((MK.mega_decode_step(cfg, mp, x0, kk[:, 0], kv[:, 0], head,
                                              xk[:, 0], xv[:, 0])[0], kk.clone(), kv.clone()))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(*twice)),
              f"K2 {mode}: two launches from the same inputs differ")
        del twice
        tok = toks[:1, None]

        def step():
            return MK.mega_decode_step(cfg, mp, x0, kk[:, 0], kv[:, 0], head, xk[:, 0],
                                       xv[:, 0])
        kq_ms = cuda_ms(torch, step, flush=l2_flush, queued=True)
        k_ms = cuda_ms(torch, step, flush=l2_flush)
        h_us = host_us(torch, step)
        stages = k2_stage_trace(torch, f"{mode}-1", step) if profiling else None
        p_ms = cuda_ms(torch, lambda: MK.mega_decode_step_plain(
            cfg, mp, x0, pk[:, 0], pv[:, 0], head, xk[:, 0], xv[:, 0]), flush=l2_flush)
        y_ms = cuda_ms(torch, lambda: TM.decode_impl(cfg, ydec, tok, pk, pv, head, xk, xv),
                       flush=l2_flush)
        moved, ops = k2_bytes_ops(MK, mp, cfg, K2_HISTORY + K2_STEPS + 1, Ta)
        b_ms, b_by = bound(moved, ops)
        out[mode] = {"mode": mode, "max_abs_err": err, "max_ref": ref_max,
                     "cache_rel_err": cache_err, "cache_rel_err_by_layer": layer_err,
                     "two_launches_bit_equal": True, "ms": kq_ms, "call_ms": k_ms,
                     "host_us": h_us, "plain_ms": p_ms, "decode_impl_ms": y_ms,
                     "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                     "bound_share": b_ms / kq_ms, "bytes": moved}
        if stages is not None:
            out[mode]["stage_trace"] = stages
        print(f"[3] K2 {mode}: {K2_STEPS} steps, logits max|err| {err:.3e} (max|ref| "
              f"{ref_max:.3e}), cache rows {cache_err:.3e} of max (by layer "
              f"{', '.join(f'{x:.1e}' for x in layer_err)}), two launches bit-equal; step "
              f"queued (device time) {kq_ms * 1e3:.1f} us, {100 * b_ms / kq_ms:.1f} % of the "
              f"bound; the call {k_ms * 1e3:.1f} us, host {h_us:.1f} us; plain "
              f"{p_ms * 1e3:.1f} us, decode_impl step {y_ms * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.1f} us ({b_by}, {moved / 1e6:.1f} MB)", flush=True)
        if stages is not None and stages["stages"]:
            print(f"[3]   K2 {mode} traced stages (device us): " + ", ".join(
                f"{r['stage']} {r['us']:.1f}" for r in stages["stages"])
                + f"; chain span {stages['span_us']:.1f} us, {stages['overlapping']} of "
                f"{len(stages['stages']) - 1} launches start before the one in front ends",
                flush=True)
        del dec, ydec, mp, kk, kv, pk, pv
        torch.cuda.empty_cache()
    del l2_flush, hist, xk, xv
    torch.cuda.empty_cache()
    return out


K7_BEAMS = 5
K7_MORE_BEAMS = (2, 8)   # phase 3 also checks and times K7 at these B
# K7's steps in phase 3: (head, the sources each beam continues or None),
# on both sides of the self-attention's 128-row time-block edges, after a
# prompt of K2_HISTORY rows in slot 0 and random rows with a random lineage
# up to the last head
K7_STEPS = [(126, None), (127, [1, 0, 1, 4, 3]), (128, [2, 2, 0, 1, 4]), (129, None),
            (254, [3, 3, 1, 0, 2]), (255, None), (256, [4, 0, 0, 2, 1]), (257, None)]
# a kernel's pick may differ from the plain version's best only where their
# plain logits lie within this share of max|ref| (a near tie: the two sum
# in other f32 orders); the logits themselves are held to K2_TOL
K7_ARGMAX_GAP = 1e-2
# audio seeds of the narrow q8_0 beam comparison (phase 10): 40 s requests
# whose CPU transcript stays the same when the input is scaled by 1 +- 2^-20,
# 2^-16 or 2^-13. They emit the same 10 tokens: on this random-weight model
# no request that emits 100 or more keeps its beam transcript under
# 1 + 2^-20 (near-tied candidate scores), so the 100-token check of the
# beam loop runs on f32
Q8_BEAM_SEEDS = (3, 4, 7)


def k7_bit_checks(torch, MK, cfg, mp, mode, x0, kk, kv, head, xk, xv, origin) -> None:
    """K7's fixed-order checks on the card at one head (kk, kv restored
    after): two launches from the same inputs bit-equal; x0, the head and
    the origin table written behind a 2 ms spin (other values in their
    tensors until it ends) giving those bits, so no launch of the chain
    reads the step's data, the lineage included, before its wait; B
    identical beams (beam 0's token and one lineage, beam 0's) giving B
    bit-equal logits and cache rows."""
    B = x0.shape[0]
    ht = torch.tensor(head, device="cuda")
    k0, v0 = kk.clone(), kv.clone()
    runs = []
    for spun in (False, False, True):
        kk.copy_(k0)
        kv.copy_(v0)
        x, h, o = x0, ht, origin
        if spun:
            x, h = torch.full_like(x0, float("nan")), torch.tensor(3, device="cuda")
            o = (origin + 1) % B
            torch.cuda.synchronize()
            torch.cuda._sleep(4_000_000)
            x.copy_(x0)
            h.copy_(ht)
            o.copy_(origin)
        runs.append((MK.mega_decode_step_beam(cfg, mp, x, kk, kv, h, xk, xv, origin=o)[0],
                     kk.clone(), kv.clone()))
        torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])),
          f"K7 {mode}, B={B}: two launches from the same inputs differ")
    check(all(torch.equal(a, b) for a, b in zip(runs[0], runs[2])),
          f"K7 {mode}, B={B}: x0, head and origin written behind a spin change the result")
    del runs
    one = origin[:1].expand(B, -1).contiguous()
    one[:, head] = torch.arange(B, device="cuda")
    kk.copy_(k0)
    kv.copy_(v0)
    got = MK.mega_decode_step_beam(cfg, mp, x0[:1].expand(B, -1).contiguous(), kk, kv, ht, xk,
                                   xv, origin=one)[0]
    torch.cuda.synchronize()
    rows = [t[:, head * B:(head + 1) * B] for t in (kk, kv)]
    check(all(torch.equal(got[b], got[0]) for b in range(1, B))
          and all(torch.equal(r[:, b], r[:, 0]) for r in rows for b in range(1, B)),
          f"K7 {mode}, B={B}: {B} identical beams with one lineage give rows that differ")
    kk.copy_(k0)
    kv.copy_(v0)
    del got, one


def phase_k7(torch, TM, MK, Q):
    """K7 at large-v3-turbo width, B = K7_BEAMS (and K7_MORE_BEAMS), in each
    mode: the steps of K7_STEPS from a cache whose slot 0 holds K2_HISTORY
    prompt rows and whose later rows hold random K/V with a random lineage,
    each kernel step against the plain step on the same inputs (logits
    within K2_TOL of max|ref|; the same argmax per beam, or a token whose
    plain logit lies within K7_ARGMAX_GAP * max|ref| of the best; the new
    cache rows of layer 0 within one bf16 step, every layer within K2_TOL;
    every other row untouched); at the head after the last step two
    launches bit-equal, the step's data written behind a spin giving the
    same bits and B identical beams B bit-equal rows (k7_bit_checks); times
    with a cold L2 cache of the kernel step queued behind a spin (its
    device time, "ms"), of the call with its host time ("call_ms"), the
    host's time to issue one step ("host_us"), and at B = K7_BEAMS of the
    plain step, the decode_impl step over B beams and B K2 steps (the
    yardsticks: no single library call computes a beam step); the bound
    and its share of the device time. Returns {(mode, B): row}. K7's "ms"
    in the kernels line is this queued device time; the kernels lines of
    trees whose K7 ran on mega_rows.cuh held the call, host time included,
    under that key (now "call_ms")."""
    cfg = TM.WhisperConfig(*TURBO)
    L, S, Tc, Ta = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_ctx, cfg.n_audio_ctx
    T0, T1 = K2_HISTORY, K7_STEPS[-1][0] + 1
    g = torch.Generator(device="cuda").manual_seed(2)
    xk, xv = ((torch.randn(L, Ta, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
              for _ in range(2))
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for mode in K2_MODES:
        dec, ydec = turbo_decoder(torch, TM, Q, cfg, mode)
        mp = MK.prepare_mega(cfg, ydec if mode in ("logits", "all") else dec, quant=mode)
        for B in (K7_BEAMS, *K7_MORE_BEAMS):
            # the time-major beam cache: a prompt of T0 rows ingested in slot 0,
            # then every slot's rows up to T1
            hist = torch.zeros(2, L, Tc, B, S, dtype=torch.bfloat16, device="cuda")
            hist[:, :, :T0, 0] = (torch.randn(2, L, T0, S, generator=g, device="cuda") * 0.5
                                  ).to(torch.bfloat16)
            hist[:, :, T0:T1] = (torch.randn(2, L, T1 - T0, B, S, generator=g, device="cuda")
                                 * 0.5).to(torch.bfloat16)
            hist = hist.reshape(2, L, Tc * B, S)
            origin = torch.where(torch.arange(Tc, device="cuda")[None] < T0, 0,
                                 torch.arange(B, device="cuda")[:, None])
            origin[:, T0:T1] = torch.randint(0, B, (B, T1 - T0), generator=g, device="cuda")
            kk, kv, pk, pv = (hist[i % 2].clone() for i in range(4))
            del hist
            toks = torch.randint(0, cfg.n_vocab, (len(K7_STEPS), B), generator=g, device="cuda")
            err = ref_max = cache_err = flip_gap = 0.0
            n_flip = 0
            layer_err = [0.0] * L
            for i, (head, src) in enumerate(K7_STEPS):
                if src is not None:   # K7_BEAMS' sources; other B continue the same ones
                    origin = origin[torch.tensor([(src[b % K7_BEAMS] + b // K7_BEAMS) % B
                                                  for b in range(B)], device="cuda")]
                origin[:, head] = torch.arange(B, device="cuda")
                kk.copy_(pk)
                kv.copy_(pv)
                x0 = (dec["te"][toks[i]] + dec["pe"][head]).to(torch.bfloat16)
                ht = torch.tensor(head, device="cuda")
                ref, _, _ = MK.mega_decode_step_beam_plain(cfg, mp, x0, pk, pv, ht, xk, xv,
                                                           origin)
                got, _, _ = MK.mega_decode_step_beam(cfg, mp, x0, kk, kv, ht, xk, xv,
                                                     origin=origin)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all())
                      and got.shape == ref.shape == (B, cfg.n_vocab),
                      f"K7 {mode}, B={B}: non-finite or misshapen logits")
                e, m = (got - ref).abs().max().item(), ref.abs().max().item()
                check(e <= K2_TOL * m, f"K7 {mode}, B={B}, step {i} (head {head}): logits "
                      f"differ from the plain version: {e:.3e} > {K2_TOL} * {m:.3e}")
                # the two sum in other f32 orders, so a random-weight row whose two
                # best logits are nearly tied may pick the other of them
                pick, best = got.argmax(1), ref.argmax(1)
                gap = ref.max(1).values - ref.gather(1, pick[:, None])[:, 0]
                check(bool((gap <= K7_ARGMAX_GAP * m).all()),
                      f"K7 {mode}, B={B}, step {i} (head {head}): argmax {pick.tolist()} "
                      f"against {best.tolist()}, plain-logit gaps {gap.tolist()} > "
                      f"{K7_ARGMAX_GAP} * {m:.3e}")
                n_flip += int((pick != best).sum())
                flip_gap = max(flip_gap, gap.max().item() / m)
                err, ref_max = max(err, e), max(ref_max, m)
                rows = slice(head * B, (head + 1) * B)
                for a, b in ((kk, pk), (kv, pv)):
                    ra, rb = a[:, rows].float(), b[:, rows].float()
                    per_layer = ((ra - rb).abs().amax(dim=(1, 2)) / rb.abs().max()).tolist()
                    layer_err = [max(x, y) for x, y in zip(layer_err, per_layer)]
                    cache_err = max(cache_err, max(per_layer))
                    check(torch.equal(a[:, :head * B], b[:, :head * B])
                          and torch.equal(a[:, (head + 1) * B:], b[:, (head + 1) * B:]),
                          f"K7 {mode}, B={B}: cache rows other than the written ones changed")
            # one bf16 step of the largest value: 2^-7 of it
            check(layer_err[0] <= 2 ** -7 and cache_err <= K2_TOL,
                  f"K7 {mode}, B={B}: new cache rows differ from the plain version (by "
                  f"layer {layer_err} of their max)")
            head = T1
            ht = torch.tensor(head, device="cuda")
            origin[:, head] = torch.arange(B, device="cuda")
            x0 = (dec["te"][toks[0]] + dec["pe"][head]).to(torch.bfloat16)
            k7_bit_checks(torch, MK, cfg, mp, mode, x0, kk, kv, head, xk, xv, origin)

            def step():
                return MK.mega_decode_step_beam(cfg, mp, x0, kk, kv, ht, xk, xv, origin=origin)
            kq_ms = cuda_ms(torch, step, flush=l2_flush, queued=True)
            k_ms = cuda_ms(torch, step, flush=l2_flush)
            h_us = host_us(torch, step)
            # each beam reads one row per time step, its lineage's slot, and
            # its origin entries
            moved, ops = k2_bytes_ops(MK, mp, cfg, head + 1, Ta, rows=B)
            moved += B * (head + 1) * 8
            b_ms, b_by = bound(moved, ops)
            row = {"mode": mode, "beams": B, "heads": [h for h, _ in K7_STEPS],
                   "timed_head": head, "max_abs_err": err, "max_ref": ref_max,
                   "argmax_near_tie_flips": n_flip, "argmax_flip_gap_rel": flip_gap,
                   "cache_rel_err": cache_err, "cache_rel_err_by_layer": layer_err,
                   "two_launches_bit_equal": True, "spun_inputs_bit_equal": True,
                   "identical_beams_bit_equal": True,
                   "ms": kq_ms, "call_ms": k_ms, "host_us": h_us, "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / kq_ms,
                   "bytes": moved}
            yard = ""
            if B == K7_BEAMS:
                p_ms = cuda_ms(torch, lambda: MK.mega_decode_step_beam_plain(
                    cfg, mp, x0, pk, pv, ht, xk, xv, origin), reps=5, warmup=1, flush=l2_flush)
                # decode_impl over B beams on natural (L, B, Tc, S) caches, the
                # batch-1 cross-KV serving every beam, and B single-row K2 steps
                nk, nv = (t.reshape(L, Tc, B, S).transpose(1, 2).contiguous()
                          for t in (pk, pv))
                tok = toks[0][:, None]
                y_ms = cuda_ms(torch, lambda: TM.decode_impl(cfg, ydec, tok, nk, nv, ht,
                                                             xk[:, None], xv[:, None]),
                               flush=l2_flush)
                k2c = [(nk[:, b].contiguous(), nv[:, b].contiguous()) for b in range(B)]

                def k2_steps():
                    for b in range(B):
                        MK.mega_decode_step(cfg, mp, x0[b:b + 1], k2c[b][0], k2c[b][1], ht,
                                            xk, xv)
                k2_ms = cuda_ms(torch, k2_steps, flush=l2_flush)
                row.update(plain_ms=p_ms, decode_impl_ms=y_ms, k2_x5_ms=k2_ms)
                yard = (f"; plain {p_ms * 1e3:.1f} us, decode_impl B={B} step "
                        f"{y_ms * 1e3:.1f} us, {B} K2 steps {k2_ms * 1e3:.1f} us")
                del nk, nv, k2c
            out[(mode, B)] = row
            print(f"[3] K7 {mode}, B={B}: {len(K7_STEPS)} steps at heads "
                  f"{', '.join(str(h) for h, _ in K7_STEPS)}, logits max|err| {err:.3e} "
                  f"(max|ref| {ref_max:.3e}), argmax differs on {n_flip} of "
                  f"{len(K7_STEPS) * B} rows (near-ties, plain gaps up to {flip_gap:.2e} of "
                  f"max|ref|), cache rows {cache_err:.3e} of max (by layer "
                  f"{', '.join(f'{x:.1e}' for x in layer_err)}); two launches, spun inputs "
                  f"and {B} identical beams bit-equal; at head {head}: step queued (device "
                  f"time) {kq_ms * 1e3:.1f} us, {100 * b_ms / kq_ms:.1f} % of the bound; the "
                  f"call {k_ms * 1e3:.1f} us, host {h_us:.1f} us{yard}; bound "
                  f"{b_ms * 1e3:.1f} us ({b_by}, {moved / 1e6:.1f} MB)", flush=True)
            del kk, kv, pk, pv, origin
            torch.cuda.empty_cache()
        del dec, ydec, mp
        torch.cuda.empty_cache()
    del l2_flush, xk, xv
    torch.cuda.empty_cache()
    return out


# K2's verify rows in phase 3: R = 5 and 8, the verify passes of gamma = 4
# and 7, on a cache of n_text_ctx + K2V_PAD rows (the speculative loop's
# n_text_ctx + gamma + 4 at gamma = 7)
K2V_ROWS = (5, 8)
K2V_PAD = 7 + 4
K2V_TIMED_HEAD = 258


def phase_k2_verify(torch, TM, MK, Q, profiling: bool = False):
    """K2's speculative verify rows at large-v3-turbo width in each mode, R
    in K2V_ROWS: from a cache of Tc = n_text_ctx + K2V_PAD rows (the
    speculative loop's) holding `head` rows of random history, one R-row
    step against R one-row K2 steps at head, head + 1, ... on the same
    cache (logits and every cache row bit for bit), against R one-row steps
    on an n_text_ctx-row cache (the greedy loop's; logits and rows bit for
    bit) where the rows fit there, and against the plain R-row step (logits
    and the new cache rows within K2_TOL of max|ref|), at heads 126,
    n_text_ctx - R and Tc - 8; times at head K2V_TIMED_HEAD of the R-row step, the plain
    step, R one-row K2 steps and the decode_impl step at T = R (the
    yardsticks; no single library call computes a step) with a cold L2
    cache; the bound. Returns {(mode, R): row}."""
    cfg = TM.WhisperConfig(*TURBO)
    L, S, Ta = cfg.n_text_layer, cfg.n_text_state, cfg.n_audio_ctx
    Tc = cfg.n_text_ctx + K2V_PAD
    g = torch.Generator(device="cuda").manual_seed(3)
    xk, xv = ((torch.randn(L, 1, Ta, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
              for _ in range(2))
    hist = (torch.randn(2, L, 1, Tc, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    pos_max = torch.tensor(cfg.n_text_ctx - 1, device="cuda")
    out = {}
    for mode in K2_MODES:
        dec, ydec = turbo_decoder(torch, TM, Q, cfg, mode)
        mp = MK.prepare_mega(cfg, ydec if mode in ("logits", "all") else dec, quant=mode)

        def rows_at(head, R):
            # token + position rows; positions past the table clamp, as JAX's gather
            toks = torch.randint(0, cfg.n_vocab, (R,), generator=g, device="cuda")
            pos = torch.minimum(head + torch.arange(R, device="cuda"), pos_max)
            return (dec["te"][toks] + dec["pe"].index_select(0, pos)).to(torch.bfloat16)

        def caches(head):
            c = hist.clone()
            c[:, :, :, head:] = 0
            return c[0], c[1]
        n_ctx = cfg.n_text_ctx

        def one_row_steps(x0, head, k, v):
            return torch.cat([MK.mega_decode_step(
                cfg, mp, x0[r:r + 1], k[:, 0], v[:, 0], torch.tensor(head + r, device="cuda"),
                xk[:, 0], xv[:, 0])[0] for r in range(x0.shape[0])])
        for R in K2V_ROWS:
            err = ref_max = cache_err = 0.0
            heads = (126, n_ctx - R, Tc - 8)
            for head in heads:
                ht = torch.tensor(head, device="cuda")
                x0 = rows_at(head, R)
                (vk, vv), (sk, sv), (pk, pv) = caches(head), caches(head), caches(head)
                got, _, _ = MK.mega_decode_step(cfg, mp, x0, vk[:, 0], vv[:, 0], ht,
                                                xk[:, 0], xv[:, 0])
                seq = one_row_steps(x0, head, sk, sv)
                ref, _, _ = MK.mega_decode_step_plain(cfg, mp, x0, pk[:, 0], pv[:, 0], ht,
                                                      xk[:, 0], xv[:, 0])
                if head + R <= n_ctx:   # the greedy loop's cache
                    gk, gv = (c[:, :, :n_ctx].contiguous() for c in caches(head))
                    greedy = one_row_steps(x0, head, gk, gv)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()) and got.shape == ref.shape
                      == (R, cfg.n_vocab), f"K2 verify {mode} R={R}: non-finite or "
                      "misshapen logits")
                check(torch.equal(got, seq) and torch.equal(vk, sk) and torch.equal(vv, sv),
                      f"K2 verify {mode} R={R} head {head}: not bit-equal to {R} one-row "
                      f"K2 steps (logits max|diff| {(got - seq).abs().max().item():.3e})")
                if head + R <= n_ctx:
                    check(torch.equal(got, greedy) and torch.equal(vk[:, :, :n_ctx], gk)
                          and torch.equal(vv[:, :, :n_ctx], gv),
                          f"K2 verify {mode} R={R} head {head}: not bit-equal to {R} "
                          f"one-row K2 steps on a {n_ctx}-row cache (logits max|diff| "
                          f"{(got - greedy).abs().max().item():.3e})")
                e, m = (got - ref).abs().max().item(), ref.abs().max().item()
                check(e <= K2_TOL * m, f"K2 verify {mode} R={R} head {head}: logits differ "
                      f"from the plain version: {e:.3e} > {K2_TOL} * {m:.3e}")
                err, ref_max = max(err, e), max(ref_max, m)
                rows = slice(head, min(head + R, Tc))
                for a, b in ((vk, pk), (vv, pv)):
                    ra, rb = a[:, 0, rows].float(), b[:, 0, rows].float()
                    cache_err = max(cache_err, ((ra - rb).abs().max() / rb.abs().max()).item())
                    check(torch.equal(a[:, :, :head], b[:, :, :head]),
                          f"K2 verify {mode}: history rows changed")
            check(cache_err <= K2_TOL, f"K2 verify {mode} R={R}: new cache rows differ "
                  f"from the plain version ({cache_err:.3e} of their max)")
            head = K2V_TIMED_HEAD
            ht = torch.tensor(head, device="cuda")
            x0 = rows_at(head, R)
            (vk, vv), (pk, pv) = caches(head), caches(head)
            tok = torch.randint(0, cfg.n_vocab, (1, R), generator=g, device="cuda")
            def step():
                return MK.mega_decode_step(cfg, mp, x0, vk[:, 0], vv[:, 0], ht, xk[:, 0],
                                           xv[:, 0])
            kq_ms = cuda_ms(torch, step, flush=l2_flush, queued=True)
            k_ms = cuda_ms(torch, step, flush=l2_flush)
            h_us = host_us(torch, step)
            stages = (k2_stage_trace(torch, f"{mode}-{R}", step)
                      if profiling and mode == "all" else None)

            s_ms = cuda_ms(torch, lambda: one_row_steps(x0, head, vk, vv), flush=l2_flush)
            p_ms = cuda_ms(torch, lambda: MK.mega_decode_step_plain(
                cfg, mp, x0, pk[:, 0], pv[:, 0], ht, xk[:, 0], xv[:, 0]), flush=l2_flush)
            y_ms = cuda_ms(torch, lambda: TM.decode_impl(cfg, ydec, tok, pk, pv, ht, xk, xv),
                           flush=l2_flush)
            moved, ops = k2_bytes_ops(MK, mp, cfg, head + R, Ta, rows=R, self_shared=True)
            b_ms, b_by = bound(moved, ops)
            out[(mode, R)] = {
                "mode": mode, "rows": R, "heads": list(heads), "cache_rows": Tc,
                "timed_head": head, "bit_equal_to_one_row_steps": True,
                "max_abs_err": err, "max_ref": ref_max, "cache_rel_err": cache_err,
                "ms": kq_ms, "call_ms": k_ms, "host_us": h_us, "plain_ms": p_ms,
                "one_row_steps_ms": s_ms, "decode_impl_ms": y_ms, "library_ms": None,
                "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / kq_ms,
                "bytes": moved}
            if stages is not None:
                out[(mode, R)]["stage_trace"] = stages
            print(f"[3] K2 verify {mode}, R={R}: bit-equal to {R} one-row K2 steps at heads "
                  f"{', '.join(map(str, heads))} (cache {Tc} rows; and on a {n_ctx}-row "
                  f"cache at heads {heads[0]} and {heads[1]}); logits max|err| against the plain "
                  f"version {err:.3e} (max|ref| {ref_max:.3e}), cache rows {cache_err:.3e} "
                  f"of max; at head {head}: step queued (device time) {kq_ms * 1e3:.1f} us, "
                  f"{100 * b_ms / kq_ms:.1f} % of the bound; the call {k_ms * 1e3:.1f} us, host "
                  f"{h_us:.1f} us; {R} one-row steps "
                  f"{s_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, decode_impl T={R} "
                  f"{y_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}, "
                  f"{moved / 1e6:.1f} MB)", flush=True)
        del dec, ydec, mp
        torch.cuda.empty_cache()
    del l2_flush, hist, xk, xv
    torch.cuda.empty_cache()
    return out


# (what large-v3-turbo runs K6 on, M, K, N): the four encoder linears of one
# 30 s window (M = 1536) and of a batched round of eight (M = 12288), and
# the narrow padding shape
K6_SHAPES = [(f"{label}, {rows}", m, k, n)
             for rows, m in (("1 window", 1536), ("8 windows", 12288))
             for label, k, n in (("qkv", 1280, 3840), ("o", 1280, 1280),
                                 ("mlp0", 1280, 5120), ("mlp1", 5120, 1280))] + [
    ("narrow padding", 13, 32, 72)]
K6_HEADLINE = "mlp0, 8 windows"


def phase_k6(torch, E8):
    """K6 against its plain version at K6_SHAPES, bit for bit (the bf16
    input of the turbo encoder; the wide-K mlp1 input as the encoder gives
    it, rounded to bf16); times with the L2 cache flushed before each launch
    of the kernel, the plain version, torch._int_mm with the same quantize
    and scale ops around it (the library yardstick: the same function), and
    the dense bf16 torch.matmul the W8A8 layer replaces, each queued behind
    a spin (device time; since PR 15, unqueued before); the bound (int8
    operations at 1979 TOP/s, or the bytes). Returns the per-shape rows."""
    g = torch.Generator(device="cuda").manual_seed(11)
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    for label, M, K, N in K6_SHAPES:
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        w = torch.randn(K, N, generator=g, device="cuda") * K ** -0.5
        wq, ws = E8.quantize_w_cols(w)
        wq_t = wq.t().contiguous()
        ref = E8.w8a8_mm_plain(x, wq_t, ws)
        got = E8.w8a8_mm(x, wq_t, ws)
        torch.cuda.synchronize()
        n_diff = int((got.float() != ref.float()).sum())
        err = (got.float() - ref.float()).abs().max().item()
        check(got.shape == ref.shape == (M, N) and n_diff == 0,
              f"K6 {label} (M={M}, K={K}, N={N}): {n_diff} of {got.numel()} values "
              f"differ from the plain version (max|err| {err:.3e})")
        k_ms = cuda_ms(torch, lambda: E8.w8a8_mm(x, wq_t, ws), flush=l2_flush, queued=True)
        p_ms = cuda_ms(torch, lambda: E8.w8a8_mm_plain(x, wq_t, ws), flush=l2_flush,
                       queued=True)

        def int_mm():
            xq, xs = E8.quantize_act_rows(x)
            return ((torch._int_mm(xq, wq_t.t()).float() * xs) * ws).to(torch.bfloat16)
        l_ms = None
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            check(torch.equal(int_mm(), ref), f"K6 {label}: the _int_mm yardstick differs")
            l_ms = cuda_ms(torch, int_mm, flush=l2_flush, queued=True)
        wd = w.to(torch.bfloat16)
        d_ms = cuda_ms(torch, lambda: torch.matmul(x, wd), flush=l2_flush, queued=True)
        b_ms, b_by = bound(nbytes(x, wq, ws, got), 2 * M * K * N, "int8")
        rows.append({"shape": f"{label}: M={M} K={K} N={N}", "max_abs_err": err,
                     "values_differing": n_diff, "ms": k_ms, "plain_ms": p_ms,
                     "library_ms": l_ms, "dense_bf16_ms": d_ms, "bound_ms": b_ms,
                     "bound_by": b_by})
        lib_txt = f"{l_ms * 1e3:.1f} us" if l_ms is not None else "none"
        print(f"[11] K6 {label} (M={M}, K={K}, N={N}): bit-equal to plain; kernel "
              f"{k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, _int_mm + quantize/scale "
              f"{lib_txt}, dense bf16 matmul {d_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us "
              f"({b_by}), {100 * b_ms / k_ms:.1f} % of the bound (queued, device time)",
              flush=True)
        del x, w, wq, wq_t, ws, ref, got
    del l2_flush
    torch.cuda.empty_cache()
    return rows


K8_STREAMS = 8
K8_HEADS = (126, 127, 128, 129, 254, 255, 256, 257)


def k8_bit_checks(torch, MK, cfg, mp, mode, x0, kk, kv, head, xk, xv) -> None:
    """K8's fixed-order checks on the card at one head (kk, kv restored
    after): two launches from the same inputs
    bit-equal; x0 and the head written behind a 2 ms spin (other values in
    their tensors until it ends) giving those bits, so no launch of the
    chain reads them before its wait; B identical streams (stream 0's
    token, history and cross-KV) giving B bit-equal logits and cache rows."""
    B = x0.shape[0]
    ht = torch.tensor(head, device="cuda")
    k0, v0 = kk.clone(), kv.clone()
    runs = []
    for spun in (False, False, True):
        kk.copy_(k0)
        kv.copy_(v0)
        x, h = x0, ht
        if spun:
            x, h = torch.full_like(x0, float("nan")), torch.tensor(3, device="cuda")
            torch.cuda.synchronize()
            torch.cuda._sleep(4_000_000)
            x.copy_(x0)
            h.copy_(ht)
        runs.append((MK.mega_decode_step_batch(cfg, mp, x, kk, kv, h, xk, xv)[0],
                     kk.clone(), kv.clone()))
        torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])),
          f"K8 {mode}: two launches from the same inputs differ")
    check(all(torch.equal(a, b) for a, b in zip(runs[0], runs[2])),
          f"K8 {mode}: x0 and head written behind a spin change the result")
    del runs
    L, S = k0.shape[0], k0.shape[2]
    same = [t.reshape(L, -1, B, S)[:, :, :1].expand(-1, -1, B, -1).reshape(L, -1, S)
            .contiguous() for t in (k0, v0)]
    sk, sv = (t[:, :1].expand(-1, B, -1, -1).contiguous() for t in (xk, xv))
    got = MK.mega_decode_step_batch(cfg, mp, x0[:1].expand(B, -1).contiguous(), *same, ht,
                                    sk, sv)[0]
    torch.cuda.synchronize()
    rows = [t[:, head * B:(head + 1) * B] for t in same]
    check(all(torch.equal(got[b], got[0]) for b in range(1, B))
          and all(torch.equal(r[:, b], r[:, 0]) for r in rows for b in range(1, B)),
          f"K8 {mode}: {B} identical streams give rows that differ")
    kk.copy_(k0)
    kv.copy_(v0)
    del same, sk, sv, got


def phase_k8(torch, TM, MK, Q):
    """K8 at large-v3-turbo width, B = K8_STREAMS streams with distinct
    cross-KV, in each mode: steps at K8_HEADS from a cache with random
    history below the head (every stream its own slot), each kernel step
    against the plain step on the same inputs (logits within K2_TOL of
    max|ref|, K7's argmax rule, the new cache rows of layer 0 within one
    bf16 step and every layer within K2_TOL, every other row untouched);
    at head 258 two launches from the same inputs bit-equal, x0 and the
    head written behind a 2 ms spin giving the same bits, and eight
    identical streams giving eight bit-equal rows; times with a cold L2
    cache of the kernel step queued behind a spin (its device time, "ms"),
    of the call with its host time ("call_ms"), of the plain step, the
    decode_impl step over the 8 streams and eight K2 steps (the
    yardsticks: no single library call computes the step); the host's
    time to issue one step ("host_us"); the bound, which counts each
    stream's cross-KV, and its share of the device time. Returns {mode:
    row}. K8's "ms" in the kernels line is this queued device time; the
    kernels lines of trees whose K8 ran on mega_rows.cuh held the call,
    host time included, under that key (now "call_ms")."""
    cfg = TM.WhisperConfig(*TURBO)
    L, S, Tc, Ta = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_ctx, cfg.n_audio_ctx
    B = K8_STREAMS
    g = torch.Generator(device="cuda").manual_seed(4)
    xk, xv = ((torch.randn(L, B, Ta, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
              for _ in range(2))
    hist = (torch.randn(2, L, Tc * B, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for mode in K2_MODES:
        dec, ydec = turbo_decoder(torch, TM, Q, cfg, mode)
        mp = MK.prepare_mega(cfg, ydec if mode in ("logits", "all") else dec, quant=mode)
        toks = torch.randint(0, cfg.n_vocab, (len(K8_HEADS), B), generator=g, device="cuda")
        err = ref_max = cache_err = flip_gap = 0.0
        n_flip = 0
        layer_err = [0.0] * L
        for i, head in enumerate(K8_HEADS):
            kk, kv, pk, pv = (hist[c % 2].clone() for c in range(4))
            for c in (kk, kv, pk, pv):
                c[:, head * B:] = 0
            x0 = (dec["te"][toks[i]] + dec["pe"][head]).to(torch.bfloat16)
            ht = torch.tensor(head, device="cuda")
            ref, _, _ = MK.mega_decode_step_batch_plain(cfg, mp, x0, pk, pv, ht, xk, xv)
            got, _, _ = MK.mega_decode_step_batch(cfg, mp, x0, kk, kv, ht, xk, xv)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()) and got.shape == ref.shape == (B, cfg.n_vocab),
                  f"K8 {mode}: non-finite or misshapen logits")
            e, m = (got - ref).abs().max().item(), ref.abs().max().item()
            check(e <= K2_TOL * m, f"K8 {mode} (head {head}): logits differ from the plain "
                  f"version: {e:.3e} > {K2_TOL} * {m:.3e}")
            pick, best = got.argmax(1), ref.argmax(1)
            gap = ref.max(1).values - ref.gather(1, pick[:, None])[:, 0]
            check(bool((gap <= K7_ARGMAX_GAP * m).all()),
                  f"K8 {mode} (head {head}): argmax {pick.tolist()} against {best.tolist()}, "
                  f"plain-logit gaps {gap.tolist()} > {K7_ARGMAX_GAP} * {m:.3e}")
            n_flip += int((pick != best).sum())
            flip_gap = max(flip_gap, gap.max().item() / m)
            err, ref_max = max(err, e), max(ref_max, m)
            rows = slice(head * B, (head + 1) * B)
            for a, b in ((kk, pk), (kv, pv)):
                ra, rb = a[:, rows].float(), b[:, rows].float()
                per_layer = ((ra - rb).abs().amax(dim=(1, 2)) / rb.abs().max()).tolist()
                layer_err = [max(x, y) for x, y in zip(layer_err, per_layer)]
                cache_err = max(cache_err, max(per_layer))
                check(torch.equal(a[:, :head * B], b[:, :head * B])
                      and not a[:, (head + 1) * B:].any(),
                      f"K8 {mode}: cache rows other than the written ones changed")
        check(layer_err[0] <= 2 ** -7 and cache_err <= K2_TOL,
              f"K8 {mode}: new cache rows differ from the plain version (by layer "
              f"{layer_err} of their max)")
        head = K8_HEADS[-1] + 1
        ht = torch.tensor(head, device="cuda")
        kk[:, head * B:] = 0
        x0 = (dec["te"][toks[0]] + dec["pe"][head]).to(torch.bfloat16)
        k8_bit_checks(torch, MK, cfg, mp, mode, x0, kk, kv, head, xk, xv)

        def step():
            return MK.mega_decode_step_batch(cfg, mp, x0, kk, kv, ht, xk, xv)
        kq_ms = cuda_ms(torch, step, flush=l2_flush, queued=True)
        k_ms = cuda_ms(torch, step, flush=l2_flush)
        h_us = host_us(torch, step)
        p_ms = cuda_ms(torch, lambda: MK.mega_decode_step_batch_plain(
            cfg, mp, x0, pk, pv, ht, xk, xv), reps=5, warmup=1, flush=l2_flush)
        nk, nv = (t.reshape(L, Tc, B, S).transpose(1, 2).contiguous() for t in (kk, kv))
        tok = toks[0][:, None]
        y_ms = cuda_ms(torch, lambda: TM.decode_impl(cfg, ydec, tok, nk, nv, ht, xk, xv),
                       flush=l2_flush)
        per = [(nk[:, b].contiguous(), nv[:, b].contiguous(), xk[:, b].contiguous(),
                xv[:, b].contiguous()) for b in range(B)]

        def k2_steps():
            for b, (ck, cv, sk, sv) in enumerate(per):
                MK.mega_decode_step(cfg, mp, x0[b:b + 1], ck, cv, ht, sk, sv)
        k2_ms = cuda_ms(torch, k2_steps, flush=l2_flush)
        moved, ops = k2_bytes_ops(MK, mp, cfg, head + 1, Ta, rows=B, cross_streams=B)
        b_ms, b_by = bound(moved, ops)
        out[mode] = {"mode": mode, "streams": B, "heads": list(K8_HEADS), "timed_head": head,
                     "max_abs_err": err, "max_ref": ref_max,
                     "argmax_near_tie_flips": n_flip, "argmax_flip_gap_rel": flip_gap,
                     "cache_rel_err": cache_err, "cache_rel_err_by_layer": layer_err,
                     "two_launches_bit_equal": True, "spun_inputs_bit_equal": True,
                     "identical_streams_bit_equal": True,
                     "ms": kq_ms, "call_ms": k_ms, "host_us": h_us, "plain_ms": p_ms,
                     "decode_impl_ms": y_ms, "k2_x8_ms": k2_ms, "library_ms": None,
                     "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / kq_ms,
                     "bytes": moved}
        print(f"[13] K8 {mode}, B={B}: {len(K8_HEADS)} steps at heads "
              f"{', '.join(map(str, K8_HEADS))}, logits max|err| {err:.3e} (max|ref| "
              f"{ref_max:.3e}), argmax differs on {n_flip} of {len(K8_HEADS) * B} rows "
              f"(near-ties, plain gaps up to {flip_gap:.2e} of max|ref|), cache rows "
              f"{cache_err:.3e} of max (by layer {', '.join(f'{x:.1e}' for x in layer_err)}); "
              f"two launches, spun inputs and {B} identical streams bit-equal; at head {head}: "
              f"step queued (device time) {kq_ms * 1e3:.1f} us, {100 * b_ms / kq_ms:.1f} % of "
              f"the bound; the call {k_ms * 1e3:.1f} us, host {h_us:.1f} us; plain "
              f"{p_ms * 1e3:.1f} us, decode_impl B={B} step {y_ms * 1e3:.1f} us, {B} K2 steps "
              f"{k2_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}, {moved / 1e6:.1f} MB)",
              flush=True)
        del dec, ydec, mp, kk, kv, pk, pv, nk, nv, per
        torch.cuda.empty_cache()
    del l2_flush, hist, xk, xv
    torch.cuda.empty_cache()
    return out


class BeamWitness:
    """Swaps the beam loop's view of K7 while installed. "lockstep": every
    step runs K7 and, on copies of the same caches, its plain version; the
    loop goes on with K7's result, and each step's logits error, argmax
    flips and the plain logits' closest gap among each beam's B + 1 best
    are kept. "plain": every step runs the plain version on the card.
    Both keep each step's head, input rows and lineage, so two runs show
    the first step whose inputs differ."""

    def __init__(self, torch, DB, mode):
        self.torch, self.DB, self.mode, self.mk = torch, DB, mode, DB.MK
        self.steps = []      # (head, x0, origin) on the host
        self.stats = []      # lockstep: (head, err, max|ref|, flips, flip gap, top gap)

    def __enter__(self):
        mk, w = self.mk, self

        def step(cfg, mp, x0, kv_k, kv_v, kv_head, xk, xv, origin=None):
            w.steps.append((int(kv_head), x0.cpu(), origin.cpu()))
            if w.mode == "plain":
                return mk.mega_decode_step_beam_plain(cfg, mp, x0, kv_k, kv_v, kv_head,
                                                      xk, xv, origin)
            ref, _, _ = mk.mega_decode_step_beam_plain(cfg, mp, x0, kv_k.clone(),
                                                       kv_v.clone(), kv_head, xk, xv, origin)
            got, kv_k, kv_v = mk.mega_decode_step_beam(cfg, mp, x0, kv_k, kv_v, kv_head,
                                                       xk, xv, origin=origin)
            pick = got.argmax(1)
            gap = ref.max(1).values - ref.gather(1, pick[:, None])[:, 0]
            top = ref.topk(x0.shape[0] + 1, dim=1).values
            v = w.torch.stack([(got - ref).abs().max(), ref.abs().max(),
                             (pick != ref.argmax(1)).sum().float(), gap.max(),
                             (top[:, :-1] - top[:, 1:]).min()]).tolist()
            w.stats.append((int(kv_head), *v))
            return got, kv_k, kv_v

        class View:
            def __getattr__(self, name):
                return getattr(mk, name)
            mega_decode_step_beam = staticmethod(step)
        self.DB.MK = View()
        return self

    def __exit__(self, *exc):
        self.DB.MK = self.mk


class CallCounter:
    """Counts calls of the model's encoder pass and decoder forward (`dec1`:
    those over one token row; `dec_rows`: each call's batch x tokens, the
    rows its linears take), and the
    token loops' calls of the K2, K7 and K8 steps, while it is installed (each
    is looked up on its module at call time; the loops' views of the kernel
    module are swapped for one that counts, so the wrappers' own counters
    are untouched)."""

    def __init__(self, TM, DL, DB, TB=None):
        self.TM, self.DL, self.DB, self.TB = TM, DL, DB, TB
        self.enc = self.dec = self.dec1 = self.mega = self.beam = self.batch = 0
        self.dec_rows = []
        self._orig = (TM.encode_with_cross_kv, TM.decode_impl, DL.MK)

    def __enter__(self):
        enc, dec, mk = self._orig
        counter = self

        def encode(*a, **k):
            self.enc += 1
            return enc(*a, **k)

        def decode(*a, **k):
            tokens = a[2] if len(a) > 2 else k["tokens"]
            self.dec += 1
            self.dec1 += tokens.shape[1] == 1
            self.dec_rows.append(tokens.shape[0] * tokens.shape[1])
            return dec(*a, **k)

        class CountingMK:
            def __getattr__(self, name):
                return getattr(mk, name)

            @staticmethod
            def mega_decode_step(*a, **k):
                counter.mega += 1
                return mk.mega_decode_step(*a, **k)

            @staticmethod
            def mega_decode_step_beam(*a, **k):
                counter.beam += 1
                return mk.mega_decode_step_beam(*a, **k)

            @staticmethod
            def mega_decode_step_batch(*a, **k):
                counter.batch += 1
                return mk.mega_decode_step_batch(*a, **k)
        self.TM.encode_with_cross_kv, self.TM.decode_impl = encode, decode
        self.DL.MK = self.DB.MK = CountingMK()
        if self.TB is not None:
            self.TB.MK = self.DL.MK
        return self

    def __exit__(self, *exc):
        self.TM.encode_with_cross_kv, self.TM.decode_impl, self.DL.MK = self._orig
        self.DB.MK = self._orig[2]
        if self.TB is not None:
            self.TB.MK = self._orig[2]


class RoundClock:
    """While installed, keeps each lockstep round's wall time (host clock;
    a round ends in its one result read, which waits for the device) and
    its BatchResult."""

    def __init__(self, TB):
        self.TB, self.rounds = TB, []

    def __enter__(self):
        make, clock = self.TB._make_batch_step, self

        def making(sa, reads):
            run = make(sa, reads)

            def timed(*a, **k):
                t0 = time.perf_counter()
                res = run(*a, **k)
                clock.rounds.append((time.perf_counter() - t0, res))
                return res
            return timed
        self._make = make
        self.TB._make_batch_step = making
        return self

    def __exit__(self, *exc):
        self.TB._make_batch_step = self._make


def serve_batch(torch, tr, FullParams, mods, tag, what, megakernel, enc_ms, int8_encoder,
                cross_kv_int8=False):
    """One batched request: `what` "batch" (transcribe_batch of 8 x 30 s)
    or "parallel" (full_parallel of 240 s over 8 chunks), greedy with
    temperature_inc = 0. Checks the launch counts: K6 128 and K1 32 per
    encoder pass (K6 0 with the dense encoder), K8 once per lockstep step
    the loop issues (0 with megakernel=False or `cross_kv_int8`), K9b
    n_text_layer per one-row decode_impl call with `cross_kv_int8` (else
    0), K7 never, K2 only in chunks whose quality gates sent them to
    whisper_full. Prints audio seconds per second, encoder ms per round
    (`enc_ms`, timed apart) and ms per lockstep step (the rounds' wall less
    their encoder passes, over the steps in which a stream was running).
    Returns (launches, results, (audio s per s, ms per lockstep step))."""
    A, Q, MK, E8, XQ, TB = mods.A, mods.Q, mods.MK, mods.E8, mods.XQ, mods.TB
    p = greedy_params(FullParams)
    p.megakernel = megakernel
    p.cross_kv_int8 = cross_kv_int8
    reset_counts(A, Q, MK, E8, XQ)
    files = [audio(30.0, 500 + b) for b in range(8)]
    with CallCounter(mods.TM, mods.DL, mods.DB, TB) as calls, RoundClock(TB) as clock:
        t0 = time.perf_counter()
        if what == "batch":
            results = tr.transcribe_batch(files, p)
        else:
            results = [tr.full_parallel(p, mods.np.concatenate(files), 8)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rounds = len(clock.rounds)
    steps = sum(int(r.n_tokens[0]) for _, r in clock.rounds)
    fell_back = sum(int(r.failed.sum()) for _, r in clock.rounds)
    loop_ms = sum(w for w, _ in clock.rounds) * 1e3 - rounds * enc_ms
    n_tok = sum(len(s.tokens) for r in results for s in r.segments)
    got = {"w8a8_mm": E8.w8a8_mm.launches, "mha_packed": A.mha_packed.launches,
           "mega_decode_step_batch": MK.mega_decode_step_batch.launches,
           "mega_decode_step": MK.mega_decode_step.launches,
           "mega_decode_step_beam": MK.mega_decode_step_beam.launches,
           "cross_attention_q8": XQ.cross_attention_q8.launches}
    print(f"[{tag}] {what} 240 s audio, {'W8A8' if int8_encoder else 'dense'} encoder, "
          f"megakernel={megakernel!r}, cross_kv_int8={cross_kv_int8}: wall {wall:.3f} s, "
          f"{240.0 / wall:.1f} audio s per s; "
          f"rounds {rounds}, lockstep steps {steps} ({loop_ms / max(steps, 1):.2f} ms per "
          f"step), encoder {enc_ms:.1f} ms per round; chunks sent to whisper_full "
          f"{fell_back}; encoder passes {calls.enc}, K8 steps {calls.batch}, K2 steps "
          f"{calls.mega}, one-row decode_impl calls {calls.dec1}; launches {got}; emitted "
          f"tokens {n_tok}", flush=True)
    check(rounds > 0 and n_tok > 0, f"{tag}: no lockstep round or no tokens")
    n_layer = tr.ctx.cfg.n_audio_layer
    check(got["w8a8_mm"] == (4 * n_layer * calls.enc if int8_encoder else 0)
          and got["mha_packed"] == n_layer * calls.enc,
          f"{tag}: K6/K1 launches {got} for {calls.enc} encoder passes")
    on = megakernel in (True, "int8", "int4") and not cross_kv_int8
    n_layer_dec = tr.ctx.cfg.n_text_layer
    check(got["cross_attention_q8"] == (n_layer_dec * calls.dec1 if cross_kv_int8 else 0)
          and (calls.dec1 >= steps - rounds or not cross_kv_int8),
          f"{tag}: K9b launches {got['cross_attention_q8']} for {calls.dec1} one-row "
          f"decode_impl calls over {steps} lockstep steps")
    check(got["mega_decode_step_batch"] == calls.batch
          and ((steps - rounds <= calls.batch <= steps + 15 * rounds) if on
               else calls.batch == 0),
          f"{tag}: K8 launches {got['mega_decode_step_batch']}, {calls.batch} calls for "
          f"{steps} lockstep steps over {rounds} rounds")
    check(got["mega_decode_step_beam"] == 0 and got["mega_decode_step"] == calls.mega
          and (fell_back > 0 or calls.mega == 0),
          f"{tag}: K2/K7 launched outside the whisper_full fallback: {got}")
    return got, results, (240.0 / wall, loop_ms / max(steps, 1))


def phase_batched(torch, Transcriber, FullParams, mods, q8_path, profiling=False,
                  done=None) -> dict:
    """Batched serving at full large-v3-turbo width (seed-0 preset): the
    W8A8 encoder against the dense one (per-position cosine > 0.98 and
    relative error < 0.1, the JAX package's envelope), both timed on a
    round of 8 windows; transcribe_batch of 8 x 30 s with the W8A8 encoder
    and K8 int8 (the main path: its launch counts go to the kernels line),
    with megakernel=False (staged decode_impl), with the dense encoder;
    full_parallel of 240 s over 8 chunks; one 30 s whisper_full request
    with the W8A8 encoder; and transcribe_batch on the q8_0 checkpoint with
    the W8A8 encoder and K8. Phase 20 sits among them: transcribe_batch of
    8 x 30 s with the W8A8 encoder and cross_kv_int8 (megakernel="int8"
    asked: K8 stays off, K9b runs every lockstep step), beside the same
    request with float cross-KV and megakernel=False. `done(tag)` prints a
    phase's time. Returns the main path's launches."""
    TM, E8, TB = mods.TM, mods.E8, mods.TB
    tr = Transcriber(preset="large-v3-turbo", dtype=torch.bfloat16, seed=0)
    ctx, cfg = tr.ctx, tr.ctx.cfg
    dense_enc = ctx.params["encoder"]
    enc8 = E8.prepare_encoder_int8(cfg, dense_enc)
    mel = mods.mel_mod.log_mel_spectrogram(
        mods.np.concatenate([audio(30.0, 500 + b) for b in range(8)]), ctx.filters, "cuda")
    windows = torch.stack([mel.data[b * 3000:(b + 1) * 3000] for b in range(8)])
    dec = ctx.params["decoder"]
    a = TM.encode(cfg, enc8, windows[:1]).float()
    d = TM.encode(cfg, dense_enc, windows[:1]).float()
    rel = ((a - d).norm() / d.norm()).item()
    cos = (a * d).sum(-1) / (a.norm(dim=-1) * d.norm(dim=-1))
    enc_ms = {name: cuda_ms(torch, lambda e=e: TM.encode_with_cross_kv(cfg, e, dec, windows),
                            reps=3, warmup=1) for name, e in (("w8a8", enc8), ("dense", dense_enc))}
    print(f"[14] W8A8 against the dense turbo encoder, one 30 s window: relative error "
          f"{rel:.4f}, smallest per-position cosine {cos.min().item():.5f}; encoder + cross-KV "
          f"of a round of 8 windows: W8A8 {enc_ms['w8a8']:.1f} ms, dense {enc_ms['dense']:.1f} "
          f"ms (median of 3)", flush=True)
    check(tuple(a.shape) == (1, cfg.n_audio_ctx, cfg.n_audio_state)
          and bool(torch.isfinite(a).all())
          and cos.min().item() > 0.98 and rel < 0.1,
          "the W8A8 turbo encoder is outside the envelope of the dense one")
    ctx.params["encoder"] = enc8
    launches, _, _ = serve_batch(torch, tr, FullParams, mods, "14", "batch", "int8",
                                 enc_ms["w8a8"], True)
    if profiling:
        pb = greedy_params(FullParams)
        pb.megakernel = "int8"
        profile_call(torch, "batch8-w8a8-k8", "transcribe_batch 8 x 30 s, W8A8, K8 int8",
                     lambda: tr.transcribe_batch([audio(30.0, 500 + b) for b in range(8)], pb))
    _, _, flt = serve_batch(torch, tr, FullParams, mods, "14", "batch", False, enc_ms["w8a8"],
                            True)
    if done is not None:
        done("14")
    # ---- 20. the same batch with int8 cross-KV: K9b every lockstep step ----
    _, _, q8 = serve_batch(torch, tr, FullParams, mods, "20", "batch", "int8", enc_ms["w8a8"],
                           True, cross_kv_int8=True)
    print(f"[20] 8 x 30 s, W8A8 encoder: int8 cross-KV (K9b) {q8[0]:.1f} audio s per s, "
          f"{q8[1]:.2f} ms per lockstep step; float cross-KV, megakernel=False {flt[0]:.1f} "
          f"audio s per s, {flt[1]:.2f} ms per lockstep step", flush=True)
    if done is not None:
        done("20")
    serve_batch(torch, tr, FullParams, mods, "14", "parallel", "int8", enc_ms["w8a8"], True)
    reset_counts(mods.A, mods.Q, mods.MK, E8)
    res = serve(torch, tr, FullParams, 30.0, 30, "14 single-stream W8A8")
    check(E8.w8a8_mm.launches == 4 * cfg.n_audio_layer * res.timings.n_encode,
          "single-stream W8A8 request: K6 launches off")
    ctx.params["encoder"] = dense_enc
    serve_batch(torch, tr, FullParams, mods, "14", "batch", "int8", enc_ms["dense"], False)
    del tr, ctx, dense_enc, enc8, dec, windows, mel
    torch.cuda.empty_cache()
    tq = Transcriber(model_path=q8_path, dtype=torch.bfloat16, encoder_int8=True)
    check("qkv_q" in tq.ctx.params["encoder"]["blocks"], "q8_0 + encoder_int8: no W8A8 planes")
    serve_batch(torch, tq, FullParams, mods, "14 q8_0", "batch", "int8", enc_ms["w8a8"], True)
    del tq
    torch.cuda.empty_cache()
    return launches


# audio seeds of the narrow q8_0 batch comparison (phase 15): 40 s files
# whose CPU transcript in a batch of eight with megakernel="int8" stays the
# same when the input is scaled by 1 +- 2^-20, 2^-16 or 2^-13 (148 tokens
# each; of seeds 0-7 only 4 and 5 pass all six scalings, the others part
# at token 0, 116 or 138 under at least one). Both transcripts pass near
# ties under the 1.6-2.1e-2 card-against-CPU logit difference the encoder
# leaves before any K8 step (ROADMAP section 3): seed 4 parted on the card
# at its first token in earlier trees, and with K8 on K2's GEMVs seed 5
# parts at its 135th token, where the CPU's two best lie 3.7e-3 apart. The
# seed that holds is held equal, the other decoded (first, as before) with
# its first difference printed
Q8_BATCH_SEEDS = (4,)
Q8_BATCH_SHOWN = (5,)


def phase_narrow_batched(torch, TF, TM, tok_mod, FullParams, mods, q8_path, tokens) -> None:
    """Batched serving on the card against the CPU at narrow width: the f32
    config (3 decoder layers; the decode_impl branch) through
    transcribe_batched of 60 s in 2 chunks (audio seed 0: its CPU
    transcript, 296 tokens, stays the same when the input is scaled by
    1 +- 2^-20, 2^-16 or 2^-13), token ids equal and at least 100 of them; the narrow bf16 q8_0 checkpoint with megakernel="int8"
    (K8 on the card, its plain version on the CPU) through transcribe_batch
    of the Q8_BATCH_SHOWN and Q8_BATCH_SEEDS files (40 s each), token ids
    equal on the latter, the first differing token printed for the others,
    with each stream's first step (the token each side picks from the
    prompt ingest's logits, the CPU's gap between its two best and the
    largest difference of the raw logits: a near tie when the gap is the
    smaller) and, where the transcripts part, the same at the first
    lockstep step whose best token differs."""
    MK, TB = mods.MK, mods.TB
    p = greedy_params(FullParams)
    cfg3 = TM.WhisperConfig(*NARROW_Q)
    params3 = TM.init_params(cfg3, seed=0, dtype=torch.float32, device="cpu")
    ids = {}
    for dev in ("cuda", "cpu"):
        c = TF.WhisperContext(cfg3, params3, tok_mod.build_vocab(tokens, cfg3.n_vocab),
                              TF._synthetic_mel_filters(80), n_loaded=1,
                              dtype=torch.float32, device=dev)
        r = TB.transcribe_batched(c, p, audio(60.0, 0), n_chunks=2)
        ids[dev] = [t.id for s in r.segments for t in s.tokens]
    print(f"[15] narrow f32, transcribe_batched 60 s in 2 chunks: tokens cuda "
          f"{len(ids['cuda'])} cpu {len(ids['cpu'])}, token ids equal "
          f"{ids['cuda'] == ids['cpu']}", flush=True)
    check(ids["cuda"] == ids["cpu"] and len(ids["cpu"]) >= 100,
          "narrow f32 batch: cuda and cpu differ, or too few tokens to tell")
    pq = dataclasses.replace(p, megakernel="int8")
    seeds = Q8_BATCH_SHOWN + Q8_BATCH_SEEDS
    held = slice(len(Q8_BATCH_SHOWN), None)
    files = [audio(40.0, s) for s in seeds]
    ids, first_step, top2 = {}, {}, {}
    real_rules = TB.LR.apply_rules
    for dev in ("cuda", "cpu"):
        c = TF.WhisperContext.from_file(q8_path, dtype=torch.bfloat16, device=dev)
        MK.mega_decode_step_batch.launches = 0
        steps = []

        best = []     # every step's two best filtered logits, and the largest raw one

        def rules(rc, logits, *a, steps=steps, best=best, **k):
            out = real_rules(rc, logits, *a, **k)
            if not steps:       # the round's first step: the prompt ingest's logits
                steps.append((logits.float().cpu(), out[0].float().cpu()))
            best.append((torch.topk(out[0].float(), 2), logits.float()))
            return out
        TB.LR.apply_rules = rules
        try:
            res = TB.transcribe_chunks_with_timings(c, pq, files)[0]
        finally:
            TB.LR.apply_rules = real_rules
        first_step[dev] = steps[0]
        top2[dev] = [(t.values.cpu(), t.indices.cpu(), raw.cpu()) for t, raw in best]
        ids[dev] = [[t.id for s in segs for t in s.tokens] for segs in res]
        if dev == "cuda":
            check(MK.mega_decode_step_batch.launches > 0, "narrow q8_0 batch: K8 not launched")
    (raw_g, filt_g), (raw_c, filt_c) = first_step["cuda"], first_step["cpu"]
    for b, (seed, a, c_ids) in enumerate(zip(seeds, ids["cuda"], ids["cpu"])):
        first = next((i for i, (x, y) in enumerate(zip(a, c_ids)) if x != y),
                     min(len(a), len(c_ids)))
        top = torch.topk(filt_c[b], 2)
        print(f"[15] narrow bf16 q8_0, transcribe_batch of {len(files)} x 40 s, megakernel="
              f"'int8', audio seed {seed}: tokens cuda {len(a)} cpu {len(c_ids)}, equal "
              f"{a == c_ids}, equal prefix {first}; first step (the prompt ingest's logits, "
              f"before K8): token cuda {int(filt_g[b].argmax())} cpu {int(top.indices[0])}, "
              f"cpu top-2 gap {(top.values[0] - top.values[1]).item():.3e}, max|logits cuda - "
              f"cpu| {(raw_g[b] - raw_c[b]).abs().max().item():.3e}", flush=True)
        if a != c_ids:
            step = next((i for i, (g, c) in enumerate(zip(top2["cuda"], top2["cpu"]))
                         if int(g[1][b, 0]) != int(c[1][b, 0])), None)
            if step is not None:
                (gv, gi, graw), (cv, ci, craw) = top2["cuda"][step], top2["cpu"][step]
                print(f"[15]   audio seed {seed}: the first lockstep step whose best token "
                      f"differs is {step}: cpu {ci[b].tolist()} {(cv[b, 0] - cv[b, 1]).item():.3e}"
                      f" apart, cuda {gi[b].tolist()} {(gv[b, 0] - gv[b, 1]).item():.3e} apart; "
                      f"max|logits cuda - cpu| {(graw[b] - craw[b]).abs().max().item():.3e}",
                      flush=True)
    n_tok = sum(map(len, ids["cpu"][held]))
    check(ids["cuda"][held] == ids["cpu"][held]
          and n_tok >= 100, "narrow q8_0 batch with K8: cuda and cpu differ")
    ingest_split(torch, TF, TM, TB, mods, q8_path, pq, Q8_BATCH_SHOWN + Q8_BATCH_SEEDS)
    # K8 alone: the card's lockstep loop from the CPU's encoder output
    ctxs = {dev: TF.WhisperContext.from_file(q8_path, dtype=torch.bfloat16, device=dev)
            for dev in ("cuda", "cpu")}
    MK.mega_decode_step_batch.launches = 0
    one_encoder_output(
        torch, TM, TB.LR, "15", f"narrow bf16 q8_0 transcribe_batch of {len(files)} x 40 s "
        f"(audio seeds {', '.join(map(str, seeds))}), megakernel='int8'",
        lambda c: [[t.id for s in segs for t in s.tokens]
                   for segs in TB.transcribe_chunks_with_timings(c, pq, files)[0]],
        ctxs, per_row=True)
    check(MK.mega_decode_step_batch.launches > 0, "narrow q8_0 batch from one encoder output: "
          "K8 not launched")


def ingest_split(torch, TF, TM, TB, mods, q8_path, p, seeds) -> None:
    """Where the card's first-step logits part from the CPU's on the narrow
    bf16 q8_0 checkpoint: for each audio seed, the prompt ingest (the
    lockstep prompt, cross-KV and decode_impl) on the card from the CPU's
    encoder output, copied over, against the same ingest on the CPU, beside
    the whole card path (mel, encoder, ingest) against the CPU. The first
    difference is the ingest's share of the gap, the rest the mel's and the
    encoder's. A seed whose transcripts agree is the yardstick."""
    ctxs = {dev: TF.WhisperContext.from_file(q8_path, dtype=torch.bfloat16, device=dev)
            for dev in ("cpu", "cuda")}
    cpu, card = ctxs["cpu"], ctxs["cuda"]
    prompt = torch.tensor([TB._init_prompt(cpu, p)])
    frames = 2 * cpu.cfg.n_audio_ctx

    def encode(ctx, samples):
        mel = mods.mel_mod.log_mel_spectrogram(samples, ctx.filters, device=ctx.device)
        return TM.encode(ctx.cfg, ctx.params["encoder"], mel.data[None, :frames])

    def ingest(ctx, enc_out):
        dec = ctx.params["decoder"]
        xk, xv = TM.cross_kv(ctx.cfg, dec, enc_out)
        kv_k, kv_v = TM.init_kv_cache(ctx.cfg, 1, dtype=ctx.dtype, device=ctx.device)
        logits, _, _ = TM.decode_impl(ctx.cfg, dec, prompt.to(ctx.device), kv_k, kv_v, 0,
                                      xk, xv, logits_pos=prompt.shape[1] - 1)
        return logits[0, 0].float().cpu()

    for seed in seeds:
        samples = audio(40.0, seed)
        enc_cpu, enc_card = encode(cpu, samples), encode(card, samples).cpu()
        ref = ingest(cpu, enc_cpu)
        from_cpu_enc = ingest(card, enc_cpu.to("cuda"))
        whole = ingest(card, enc_card.to("cuda"))
        top = torch.topk(ref, 2).values
        gap = lambda a: (a - ref).abs().max().item()  # noqa: E731
        print(f"[15] audio seed {seed}, first-step logits, max|ref| {ref.abs().max().item():.3e} "
              f"(a bf16 step there {ref.abs().max().item() * 2.0 ** -8:.3e}), raw top-2 gap "
              f"{(top[0] - top[1]).item():.3e}: card against cpu, the whole path "
              f"{gap(whole):.3e} (encoder output max|diff| / max|ref| "
              f"{((enc_card.float() - enc_cpu.float()).abs().max() / enc_cpu.float().abs().max()).item():.3e}); "
              f"the ingest alone, from the cpu's encoder output {gap(from_cpu_enc):.3e}",
              flush=True)
        check(bool(torch.isfinite(whole).all() and torch.isfinite(from_cpu_enc).all()),
              f"ingest split, audio seed {seed}: non-finite logits")


# the card against the CPU from one encoder output (phases 9, 10 and 15):
# the audio seeds and request lengths of the bf16 q8_0 step-kernel checks,
# and the equal tokens each stream is asked for. Greedy (phase 9): seeds
# whose CPU top-two logit gaps stay wide over the 148 steps (least 5.1e-3,
# 2.4e-3 and 5.5e-3 of max|logit|, each at the ingest's step; seed 7, the
# seed before, 1.3e-3 there, where it parted on the card), 4 and 9 also
# keeping their transcript when the input is scaled by 1 +- 2^-20, 2^-16
# and 2^-13 (a CPU scan of seeds 0-15)
ONE_ENC_GREEDY_SEEDS = (3, 4, 9)
ONE_ENC_BEAM_SEEDS = (3, 4)
ONE_ENC_GREEDY_SECS = 35.0
ONE_ENC_BEAM_SECS = 90.0
ONE_ENC_TOKENS = 100


class EncoderReplay:
    """The CPU's encoder outputs on the card. `record()` keeps every
    TM.encode_with_cross_kv result (enc_out, xk, xv) of the CPU run made
    while it is installed; `replay(device)` returns them in the same order,
    copied to the card, in place of the card's own encoder pass (the
    request's mel window shapes must match), so the card's token loop starts
    from the CPU's encoder output and cross-KV: its tokens then test the
    step kernels alone. Every decode path (whisper_full's windows, the
    K-window loop, the lockstep rounds) calls the encoder through that
    module attribute."""

    def __init__(self, TM):
        self.TM, self.real, self.outs, self.served = TM, TM.encode_with_cross_kv, [], 0

    def record(self):
        def enc(cfg, e, d, mel):
            out = self.real(cfg, e, d, mel)
            self.outs.append((tuple(mel.shape), out))
            return out
        return self._installed(enc)

    def replay(self, device):
        def enc(cfg, e, d, mel):
            check(self.served < len(self.outs), "encoder replay: the card asked for more "
                  "encoder passes than the CPU made")
            shape, out = self.outs[self.served]
            check(tuple(mel.shape) == shape, f"encoder replay: window {tuple(mel.shape)} where "
                  f"the CPU encoded {shape}")
            self.served += 1
            return tuple(t.to(device) for t in out)
        return self._installed(enc)

    def _installed(self, fn):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self.TM.encode_with_cross_kv = fn
            try:
                yield self
            finally:
                self.TM.encode_with_cross_kv = self.real
        return ctx()


class StepLogits:
    """Every call of the logit rules while installed: the raw logits and the
    filtered logits' `k` best values and ids of each row, kept on the
    device until `rows()`."""

    def __init__(self, torch, LR, k=2):
        self.torch, self.LR, self.k, self.real, self.steps = torch, LR, k, LR.apply_rules, []

    def __enter__(self):
        def rules(rc, logits, *a, **kw):
            out = self.real(rc, logits, *a, **kw)
            top = self.torch.topk(out[0].float(), self.k)
            self.steps.append((top.values, top.indices, logits.float()))
            return out
        self.LR.apply_rules = rules
        return self

    def __exit__(self, *exc):
        self.LR.apply_rules = self.real

    def rows(self):
        return [tuple(t.cpu() for t in step) for step in self.steps]


def first_parting(card, cpu, k=1, row=None):
    """The first step whose best `k` ids differ on any row (or on `row`)
    between two StepLogits records, masked candidates (-inf, whose order
    topk leaves open) left out: (step, row, the CPU's smallest gap between
    adjacent finite candidates among its best k + 1, max|logit| of the
    CPU's row, max|logits card - cpu| of the row), or None."""
    for step, ((gv, gi, graw), (cv, ci, craw)) in enumerate(zip(card, cpu)):
        if gi.shape != ci.shape:
            return step, None, None, None, None
        gi = gi[:, :k].masked_fill(~gv[:, :k].isfinite(), -1)
        ci = ci[:, :k].masked_fill(~cv[:, :k].isfinite(), -1)
        differ = (gi != ci).any(1)
        if row is not None:
            differ = differ[row:row + 1] if row < differ.numel() else differ[:0]
        differ = differ.nonzero() + (row or 0)
        if differ.numel():
            r = int(differ[0])
            gaps = cv[r, :k] - cv[r, 1:k + 1]
            gap = gaps[gaps.isfinite()].min().item() if gaps.isfinite().any() else 0.0
            return (step, r, gap, craw[r].abs().max().item(),
                    (graw[r] - craw[r]).abs().max().item())
    return None


def one_encoder_output(torch, TM, LR, tag, what, run, ctxs, k=1, per_row=False):
    """`run(ctx)` (a list of token-id lists, one a stream) on the CPU context,
    recording its encoder outputs and logits, then on the card context from
    those outputs. Per stream prints the equal tokens (the common prefix) and,
    where the streams part before ONE_ENC_TOKENS, the first step whose best
    `k` ids differ (on the stream's own row of the logits with `per_row`, a
    lockstep batch; else on any row: one stream's beams) and the CPU's gap
    there. Fails where a stream parts before
    ONE_ENC_TOKENS at a step whose CPU gap is wider than K7_ARGMAX_GAP of
    max|logit| (not a near tie), or where the parting step is not found in
    greedy decoding (k = 1). Returns [(equal tokens, total, parting)]."""
    replay = EncoderReplay(TM)
    with replay.record(), StepLogits(torch, LR, k + 1) as cpu_steps:
        cpu = run(ctxs["cpu"])
    with replay.replay(ctxs["cuda"].device), StepLogits(torch, LR, k + 1) as card_steps:
        card = run(ctxs["cuda"])
    check(replay.served == len(replay.outs) > 0,
          f"{what}: the card used {replay.served} of {len(replay.outs)} encoder outputs")
    card_rows, cpu_rows = card_steps.rows(), cpu_steps.rows()
    out = []
    for i, (a, c) in enumerate(zip(card, cpu)):
        part = first_parting(card_rows, cpu_rows, k, i if per_row else None)
        equal = next((j for j, (x, y) in enumerate(zip(a, c)) if x != y), min(len(a), len(c)))
        same = a == c
        line = (f"[{tag}] {what}, from the CPU's encoder output, stream {i}: tokens cuda "
                f"{len(a)} cpu {len(c)}, equal {same}, equal tokens {equal}")
        if not same and part is not None:
            step, row, gap, big, diff = part
            line += (f"; the first step whose best {k} differ: {step} (row {row}), the CPU's gap "
                     f"there {gap:.3e} of max|logit| {big:.3e} ({gap / big:.2e}), max|logits "
                     f"cuda - cpu| {diff:.3e}" if row is not None else
                     f"; the steps part at {step} (different rows)")
        print(line, flush=True)
        if not same and equal < ONE_ENC_TOKENS:
            if k == 1:
                check(part is not None and part[1] is not None
                      and part[2] <= K7_ARGMAX_GAP * part[3],
                      f"{what}, stream {i}: parts from the CPU at token {equal}, not at a "
                      "near tie of the CPU's logits")
            elif part is not None and part[1] is not None:
                check(part[2] <= K7_ARGMAX_GAP * part[3],
                      f"{what}, stream {i}: parts from the CPU at token {equal}, not at a "
                      "near tie of the CPU's candidates")
        out.append((equal, len(c), part))
    return out


def witness_k7(torch, tr, FullParams, DB) -> None:
    """K7 against its plain version along the main path, on the card: one
    65 s beam request in lockstep (BeamWitness), every step within K2_TOL
    of max|ref| with argmax flips only within K7_ARGMAX_GAP, its heads
    past a 128-row time-block edge; then the same request with the plain
    version in every step, the same encoder and cross-KV. Prints whether
    the two transcripts agree and, where they part, the first step whose
    inputs differ and the lockstep numbers of the step before it."""
    secs, seed = 65.0, 65
    runs = {}
    for mode in ("lockstep", "plain"):
        with BeamWitness(torch, DB, mode) as w:
            res = tr.transcribe(audio(secs, seed),
                                request_params(FullParams, beam_size=K7_BEAMS))
        torch.cuda.synchronize()
        runs[mode] = (w, [t.id for s in res.segments for t in s.tokens])
    wk, ids_k = runs["lockstep"]
    wp, ids_p = runs["plain"]
    worst = max(wk.stats, key=lambda r: r[1] / r[2])
    past = [r for r in wk.stats if r[0] >= 128]
    flips = [r for r in wk.stats if r[3] > 0]
    print(f"[6] K7 witness, {secs:.0f} s beam {K7_BEAMS}: {len(wk.stats)} lockstep steps, heads "
          f"up to {max(r[0] for r in wk.stats)} ({len(past)} steps at 128 or more); logits "
          f"max|err| up to {worst[1] / worst[2]:.2e} of max|ref| (head {worst[0]}), past 128 "
          f"up to {max((r[1] / r[2] for r in past), default=0.0):.2e}; argmax flips on "
          f"{int(sum(r[3] for r in flips))} rows, plain gaps up to "
          f"{max((r[4] / r[2] for r in flips), default=0.0):.2e} of max|ref|", flush=True)
    for head, e, m, n_flip, gap, _ in wk.stats:
        check(e <= K2_TOL * m, f"K7 witness, head {head}: logits differ from the plain "
              f"version: {e:.3e} > {K2_TOL} * {m:.3e}")
        check(n_flip == 0 or gap <= K7_ARGMAX_GAP * m,
              f"K7 witness, head {head}: argmax off the plain best by {gap:.3e}")
    check(past, "K7 witness: the request never attended past 128 rows")
    same = next((i for i, (a, b) in enumerate(zip(ids_k, ids_p)) if a != b),
                min(len(ids_k), len(ids_p)))
    line = (f"[6] K7 witness: tokens with K7 {len(ids_k)}, with the plain step {len(ids_p)}, "
            f"equal {ids_k == ids_p}, equal prefix {same}")
    if ids_k != ids_p:
        d = next((i for i, (a, b) in enumerate(zip(wk.steps, wp.steps))
                  if a[0] != b[0] or not (torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]))),
                 min(len(wk.steps), len(wp.steps)))
        head, e, m, _, _, top_gap = wk.stats[max(d - 1, 0)]
        line += (f"; the steps' inputs first differ at step {d} of {len(wk.steps)}; "
                 f"at the step before it (head {head}) the plain logits' closest pair among "
                 f"a beam's {K7_BEAMS + 1} best lies {top_gap:.3e} apart, the kernel's "
                 f"largest error {e:.3e} (max|ref| {m:.3e})")
    print(line, flush=True)


# the drafts of phase 16: (tag, checkpoint file, gamma); (a) the target's
# own seed-0 tensors as q4_0, the closest draft there is without real
# weights; (b) seed-1 tensors as q8_0, whose proposals the target rejects,
# with the most verify rows K2 takes (gamma + 1 = 8)
SPEC_DRAFTS = (("a", "draft-q4_0-seed0.bin", 4), ("b", "draft-q8_0-seed1.bin", 7))


def write_drafts_main(argv) -> int:
    """SPEC_DRAFTS into DIR (chip_smoke.py --write-drafts DIR N_TOKENS, a
    process of its own beside phases 6-15): the q8_0 checkpoint's seed-0
    tensors as q4_0 and seed-1 tensors as q8_0, with the vocabulary's
    first N_TOKENS pieces; prints its seconds last."""
    t0 = time.perf_counter()
    sys.path.insert(0, str(REPO))
    from open_whisper_kit_tpu_torch.decode import full as TF
    from open_whisper_kit_tpu_torch.io import ggml_writer as W
    tmp, n_tokens = Path(argv[0]), int(argv[1])
    tokens = [b"<%d>" % i for i in range(n_tokens)]
    hp = W.WhisperHParams(*TURBO, ftype=1, qntvr=0)
    for (_, name, _), seed, wtype in zip(SPEC_DRAFTS, (0, 1), ("q4_0", "q8_0")):
        W.write_checkpoint(tmp / name, hp, TF._synthetic_mel_filters(128), tokens,
                           W.random_reference_tensors(hp, seed=seed),
                           wtype=W.TYPE_FOR_NAME[wtype])
    print(f"{time.perf_counter() - t0:.1f}", flush=True)
    return 0


def phase_speculative(torch, Transcriber, TF, FullParams, mods, tmp) -> int:
    """Speculative greedy decoding at full large-v3-turbo width: the q8_0
    target (K2 int8 by itself) serves 30 s and 65 s greedily, then with
    each of SPEC_DRAFTS attached (Transcriber(model_path=...,
    draft_model_path=...), then set_draft), temperature_inc = 0. Each
    transcript must equal the target's K2-greedy one token for token; the
    launch counts are exact: every round gamma + 1 one-row K2 draft steps
    and one K2 verify pass at gamma + 1 rows, as many verify passes as live
    rounds plus at most POLL - 1 masked ones a window, every window's
    prompt ingest (both models) one decode_impl call, no decode_impl call
    in a round. Prints acceptance, rounds and ms per sampled token beside
    greedy's. Returns the verify passes' launches."""
    A, Q, MK, TM, DL, DB = mods.A, mods.Q, mods.MK, mods.TM, mods.DL, mods.DB
    from open_whisper_kit_tpu_torch.decode import device_speculative as DS
    target = tmp / "ggml-large-v3-turbo-q8_0.bin"
    requests = ((30.0, 30), (65.0, 65))

    def run(tr, p, secs, seed):
        reset_counts(A, Q, MK)
        with CallCounter(TM, DL, DB) as calls:
            t0 = time.perf_counter()
            res = tr.transcribe(audio(secs, seed), p)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ids = [t.id for s in res.segments for t in s.tokens]
        return res, ids, wall, calls, dict(MK.mega_decode_step.launches_by_rows)

    tr = Transcriber(model_path=target, draft_model_path=tmp / SPEC_DRAFTS[0][1],
                     dtype=torch.bfloat16)
    greedy = {}
    p = greedy_params(FullParams)
    for secs, seed in requests:
        res, ids, wall, _, _ = run(tr, p, secs, seed)
        greedy[secs] = ids, wall / max(res.timings.n_sample, 1) * 1e3
        check(len(ids) > 0, f"q8_0 greedy {secs:.0f} s: no tokens")
        print(f"[16] q8_0 greedy, {secs:.0f} s, K2 auto: sampled tokens "
              f"{res.timings.n_sample}, emitted {len(ids)}, wall {wall:.3f} s, "
              f"{greedy[secs][1]:.2f} ms per sampled token", flush=True)
    n_verify = 0
    for tag, name, gamma in SPEC_DRAFTS:
        if tag != SPEC_DRAFTS[0][0]:
            tr.ctx.set_draft(TF.WhisperContext.from_file(tmp / name, dtype=torch.bfloat16,
                                                         device="cuda"))
        ps = dataclasses.replace(p, speculative=gamma)
        check(tr.ctx.mega_mode(ps) == "all" and tr.ctx.draft.mega_mode(ps, draft=True)
              == "all", f"draft ({tag}): K2 not selected for the draft steps and the verify")
        # draft (b) accepts nothing on these weights: its 30 s request alone
        for secs, seed in (requests if tag == SPEC_DRAFTS[0][0] else requests[:1]):
            res, ids, wall, calls, rows = run(tr, ps, secs, seed)
            tm = res.timings
            n_win = tm.n_encode // 2
            rounds = tm.n_decode - n_win
            verify, one = rows.get(gamma + 1, 0), rows.get(1, 0)
            same = ids == greedy[secs][0]
            first = next((i for i, (a, b) in enumerate(zip(ids, greedy[secs][0])) if a != b),
                         None)
            ms_tok = wall / max(tm.n_sample, 1) * 1e3
            print(f"[16] draft ({tag}) {name}, gamma {gamma}, {secs:.0f} s: windows {n_win}, "
                  f"sampled tokens {tm.n_sample}, emitted {len(ids)}, rounds {rounds} "
                  f"({tm.n_sample / max(rounds, 1):.2f} tokens a round), accepted "
                  f"{tm.n_spec_accepted} of {rounds * gamma} proposals "
                  f"({tm.n_spec_accepted / max(rounds * gamma, 1):.1%}); K2 launches: "
                  f"{one} one-row, {verify} at {gamma + 1} rows, all {rows}; decode_impl "
                  f"calls {calls.dec}, encoder passes {calls.enc}; wall {wall:.3f} s, "
                  f"{ms_tok:.2f} ms per sampled token (greedy {greedy[secs][1]:.2f}); "
                  f"transcript equals K2 greedy {same}"
                  + ("" if same else f" (first differing token {first})"), flush=True)
            check(same and len(ids) > 0, f"draft ({tag}) {secs:.0f} s: the speculative "
                  "transcript differs from K2 greedy")
            check(set(rows) <= {1, gamma + 1} and one == (gamma + 1) * verify
                  and rounds <= verify <= rounds + (DS.POLL - 1) * n_win,
                  f"draft ({tag}) {secs:.0f} s: K2 launches {rows} for {rounds} rounds "
                  f"over {n_win} windows")
            check(calls.enc == 2 * n_win and calls.dec == 2 * n_win
                  and A.mha_packed.launches == TURBO_LAYERS * calls.enc
                  and Q.qmm.launches == calls.enc * (TURBO_LAYERS * 6 + 4 * 2)
                  + calls.dec * 4 * 4 and Q.ffn_int8.launches == calls.dec * 4,
                  f"draft ({tag}) {secs:.0f} s: encoder / decode_impl launches off "
                  f"prediction (encoder {calls.enc}, decode_impl {calls.dec}, K1 "
                  f"{A.mha_packed.launches}, K3 {Q.qmm.launches}, K5 {Q.ffn_int8.launches})")
            n_verify += verify
    del tr
    torch.cuda.empty_cache()
    return n_verify


# audio seed of the narrow speculative comparison (phase 17): its CPU
# transcript with megakernel="int8" stays the same when the input is scaled
# by 1 +- 2^-20, 2^-16 or 2^-13 (of seeds 0-7, only 4 and 7 hold all six)
SPEC_NARROW_SEED = 4


def phase_narrow_speculative(torch, TF, FullParams, mods, q8_path, hp, tokens) -> None:
    """Narrow bf16 q8_0 target with a q4_0 draft of the same tensors,
    megakernel="int8", gamma = 4, 35 s: draft steps K2 at one row and verify
    passes K2 at five rows on the card, their plain versions on the CPU;
    token ids equal, at least 100, and on the card equal to K2 greedy."""
    W, MK = mods.W, mods.MK
    draft_path = q8_path.with_name("narrow-q4_0-draft.bin")
    W.write_checkpoint(draft_path, hp, TF._synthetic_mel_filters(80), tokens,
                       W.random_reference_tensors(hp, seed=0), wtype=W.TYPE_FOR_NAME["q4_0"])
    p = greedy_params(FullParams)
    p.megakernel = "int8"
    ps = dataclasses.replace(p, speculative=4)
    samples = audio(35.0, SPEC_NARROW_SEED)
    ids = {}
    for dev in ("cuda", "cpu"):
        c = TF.WhisperContext.from_file(q8_path, dtype=torch.bfloat16, device=dev)
        c.set_draft(TF.WhisperContext.from_file(draft_path, dtype=torch.bfloat16, device=dev))
        MK.mega_decode_step.launches_by_rows.clear()
        r = TF.whisper_full(c, ps, samples)
        ids[dev] = [t.id for s in r.segments for t in s.tokens]
        if dev == "cuda":
            rows = dict(MK.mega_decode_step.launches_by_rows)
            check(rows.get(5, 0) > 0 and rows.get(1, 0) == 5 * rows[5],
                  f"narrow speculative on cuda: K2 launches {rows}")
            c.draft = None
            g = TF.whisper_full(c, p, samples)
            greedy = [t.id for s in g.segments for t in s.tokens]
    same = ids["cuda"] == ids["cpu"]
    print(f"[17] narrow bf16 q8_0 + q4_0 draft, gamma 4, megakernel='int8', audio seed "
          f"{SPEC_NARROW_SEED}: tokens {len(ids['cuda'])}, token ids cuda == cpu {same}, "
          f"cuda == K2 greedy {ids['cuda'] == greedy}, K2 launches on cuda {rows}", flush=True)
    check(same and len(ids["cuda"]) >= 100 and ids["cuda"] == greedy,
          "narrow speculative: cuda and cpu differ, too few tokens, or not K2 greedy's")


# K9 cases of phase 18: (kernel, dtype, heads, query rows B, plane batch Bk)
# at 1500 audio positions; the turbo shapes of the main path (greedy: one
# row; beam 5: five rows over one shared plane, batch stride 0; lockstep:
# eight streams, each its own planes; K9a's route: eight streams on
# 1504-row slabs, ta_valid = 1500) and a narrow f32 shape (S = 128)
K9_CASES = [("K9b", "bf16", 20, 1, 1), ("K9b", "bf16", 20, 5, 1), ("K9b", "bf16", 20, 8, 8),
            ("K9a", "bf16", 20, 8, 8), ("K9b", "f32", 2, 1, 1), ("K9a", "f32", 2, 8, 8)]
K9_TA = 1500
# gates against the plain version, relative to max|ref|: bf16 a tenth of a
# percent past the kernels' own bf16 rounding of p * vs (JAX's K9b test
# allows 2e-2 absolute on O(1) outputs); f32 the f32 summation order
K9_TOL = {"bf16": 1e-2, "f32": 1e-5}
F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores (NVIDIA data sheet)


def phase_k9(torch, TM, XQ) -> dict:
    """K9b (cross_attention_q8) and K9a (cross_attention_q8_nat) against
    their plain versions at K9_CASES on the same inputs (planes from
    TM.quantize_cross_kv / quantize_cross_kv_nat of a random cross-KV), gated
    at K9_TOL; times with the L2 cache flushed before each launch of the
    kernel, the plain version and SDPA over the float K/V of the same shape
    (the float cross-KV that int8 replaces: no single PyTorch call attends
    over int8 planes with per-row scales, so library_ms stays null); the
    bound (the live keys' planes and scales, q and out, at 3.35 TB/s).
    Returns {"K9b": rows, "K9a": rows}."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(19)
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    rows = {"K9b": [], "K9a": []}
    for kernel, dt, H, B, Bk in K9_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        S, nat, scale = H * 64, kernel == "K9a", 64 ** -0.25
        xk, xv = ((torch.randn(1, Bk, K9_TA, S, generator=g, device="cuda") * 0.5).to(dtype)
                  for _ in range(2))
        quant = TM.quantize_cross_kv_nat if nat else TM.quantize_cross_kv
        qk, qv = quant(xk, H), quant(xv, H)
        planes = (qk.qs[0], qk.scale[0], qv.qs[0], qv.scale[0])
        extra = (qk.ta_valid,) if nat else ()
        fn = XQ.cross_attention_q8_nat if nat else XQ.cross_attention_q8
        plain = XQ.cross_attention_q8_nat_plain if nat else XQ.cross_attention_q8_plain
        q = torch.randn(B, 1, S, generator=g, device="cuda").to(dtype)
        ref = plain(q, *planes, H, scale, *extra)
        got = fn(q, *planes, H, scale, *extra)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        shape = (f"B={B} over {'one shared plane' if Bk < B else f'{Bk} planes'}, H={H}, "
                 f"Ta={K9_TA}{', Tap=%d' % planes[0].shape[1] if nat else ''}, {dt}")
        print(f"[18] {kernel} {shape}: max|err| {err:.3e} max|ref| {ref_max:.3e} limit "
              f"{K9_TOL[dt] * ref_max:.3e}", flush=True)
        check(got.shape == q.shape and bool(torch.isfinite(got).all())
              and err <= K9_TOL[dt] * ref_max,
              f"{kernel} {shape} disagrees with its plain version")
        # device time (launches queued behind a spin), and the call as an
        # eager caller issues it (host side included)
        k_ms = cuda_ms(torch, lambda: fn(q, *planes, H, scale, *extra), flush=l2_flush,
                       queued=True)
        c_ms = cuda_ms(torch, lambda: fn(q, *planes, H, scale, *extra), flush=l2_flush)
        h_us = host_us(torch, lambda: fn(q, *planes, H, scale, *extra))
        p_ms = cuda_ms(torch, lambda: plain(q, *planes, H, scale, *extra), flush=l2_flush,
                       queued=True)
        plan = XQ.cross_q8_plan(B, H, planes[0].shape[-2] if not nat else qk.ta_valid, Bk < B)
        # the float path's attention over the same cross-KV: rows sharing a
        # plane fold into queries, as decode_impl folds them
        kh, vh = (x[0].view(Bk, K9_TA, H, 64).transpose(1, 2).contiguous() for x in (xk, xv))
        qh = q.view(Bk, B // Bk, H, 64).transpose(1, 2).contiguous()
        s_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
                       flush=l2_flush, queued=True)
        live = (Bk * H * K9_TA * 64, Bk * H * K9_TA * 4)     # plane and scale bytes a side
        b_ms, b_by = bound(2 * sum(live) + 2 * nbytes(q), 4 * B * H * K9_TA * 64,
                           "bf16" if dt == "bf16" else F32_FLOP_PER_S)
        rows[kernel].append({"shape": shape, "max_abs_err": err, "ms": k_ms, "call_ms": c_ms,
                             "host_us": h_us, "plain_ms": p_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": None, "float_kv_sdpa_ms": s_ms,
                             "chunks": plan.chunks, "chunk": plan.chunk, "rows": plan.rows,
                             "blocks": plan.blocks})
        print(f"[18]   kernel {k_ms * 1e3:.1f} us queued (the call with its host side "
              f"{c_ms * 1e3:.1f} us, host {h_us:.1f} us), plain {p_ms * 1e3:.1f} us, SDPA over "
              f"the float cross-KV that int8 replaces {s_ms * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by}), {100 * b_ms / k_ms:.1f} % of the bound (median of "
              f"20, cold L2; device times queued behind a spin); one launch: {plan.chunks} "
              f"chunks of {plan.chunk} keys a cluster, {plan.rows} row(s) a block, "
              f"{plan.blocks} blocks", flush=True)
        del xk, xv, qk, qv, planes, q, ref, got, kh, vh, qh
    del l2_flush
    torch.cuda.empty_cache()
    return rows


# the requests of phase 19 on the q8_0 checkpoint: (label, seconds, audio
# seed, FullParams fields, beams)
INT8_KV_REQUESTS = (("greedy", 30.0, 30, {}, 0), ("greedy", 65.0, 65, {}, 0),
                    ("greedy, device_windows=1", 30.0, 30, {"device_windows": 1}, 0),
                    ("beam 5", 30.0, 30, {}, K7_BEAMS))


def phase_cross_int8(torch, tr, FullParams, mods) -> int:
    """int8 cross-KV at full width on the q8_0 turbo checkpoint:
    INT8_KV_REQUESTS with cross_kv_int8=True and megakernel left to the
    policy (temperature_inc = 0), each beside the same request with float
    cross-KV and megakernel=False, which takes the same decode_impl route
    with float cross-attention. Launch counts exact: K9b n_text_layer per
    one-row decode_impl call (none for the float request), K2 and K7 never,
    K3 and K5 as phase 6's megakernel=False request, K1 per encoder pass.
    Prints ms per sampled token of both. Returns the int8 requests' K9b
    launches."""
    A, Q, MK, XQ, TM, DL, DB = mods.A, mods.Q, mods.MK, mods.XQ, mods.TM, mods.DL, mods.DB
    n_layer = tr.ctx.cfg.n_text_layer
    k9b = 0
    for label, secs, seed, kw, beams in INT8_KV_REQUESTS:
        out = {}
        for int8 in (True, False):
            p = request_params(FullParams, megakernel=None if int8 else False,
                               beam_size=beams)
            p = dataclasses.replace(p, cross_kv_int8=int8, **kw)
            check(tr.ctx.mega_mode(p) is None, f"{label}: a step kernel selected")
            reset_counts(A, Q, MK, XQ=XQ)
            with CallCounter(TM, DL, DB) as calls:
                t0 = time.perf_counter()
                res = tr.transcribe(audio(secs, seed), p)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            n_sample = res.timings.n_sample
            n_tok = sum(len(s.tokens) for s in res.segments)
            n9 = XQ.cross_attention_q8.launches
            want_k3 = calls.enc * (TURBO_LAYERS * 6 + 4 * 2) + calls.dec * 4 * 4
            out[int8] = wall * 1e3 / max(n_sample, 1)
            print(f"[19] q8_0 {label}, {secs:.0f} s, cross_kv_int8={int8}: encoder passes "
                  f"{calls.enc}, decode_impl calls {calls.dec} ({calls.dec1} one-row), sampled "
                  f"tokens {n_sample}, emitted {n_tok}; launches K9b {n9}, K3 "
                  f"{Q.qmm.launches} (predicted {want_k3}), K5 {Q.ffn_int8.launches}, K1 "
                  f"{A.mha_packed.launches}, K2 {MK.mega_decode_step.launches}, K7 "
                  f"{MK.mega_decode_step_beam.launches}; wall {wall:.3f} s, {out[int8]:.2f} "
                  "ms per sampled token", flush=True)
            check(n_tok > 0 and calls.dec1 > 0, f"{label}: no tokens or no one-row step")
            check(n9 == (n_layer * calls.dec1 if int8 else 0)
                  and XQ.cross_attention_q8_nat.launches == 0,
                  f"{label}, cross_kv_int8={int8}: K9b launches {n9} for {calls.dec1} "
                  "one-row decode_impl calls")
            check(MK.mega_decode_step.launches == MK.mega_decode_step_beam.launches == 0
                  and calls.mega == calls.beam == 0 and Q.qmm.launches == want_k3
                  and Q.ffn_int8.launches == 4 * calls.dec and Q.qmm4.launches == 0
                  and A.mha_packed.launches == TURBO_LAYERS * calls.enc,
                  f"{label}, cross_kv_int8={int8}: launch counts off prediction")
            if int8:
                k9b += n9
        print(f"[19] q8_0 {label}, {secs:.0f} s: {out[True]:.2f} ms per sampled token with "
              f"int8 cross-KV (K9b), {out[False]:.2f} with float cross-KV (megakernel=False)",
              flush=True)
    return k9b


K9A_STEPS = 8
K9A_TOL = 5e-3      # JAX's tests/test_whisper_model.py QuantKVNat tolerance


def phase_k9a_path(torch, tr, mods) -> int:
    """K9a on its path: K9A_STEPS full-width decode_impl steps at B = 8
    streams on the q8_0 checkpoint's decoder, once over QuantKVNat planes
    (K9a) and once over QuantKV planes (K9b) of the same cross-KV, from the
    same inputs (each step's token the QuantKV run's argmax): logits within
    K9A_TOL of max|ref|, n_text_layer K9a launches per step. Returns K9a's
    launches."""
    TM, XQ = mods.TM, mods.XQ
    cfg, dec = tr.ctx.cfg, tr.ctx.params["decoder"]
    B, H, L = K8_STREAMS, cfg.n_text_head, cfg.n_text_layer
    g = torch.Generator(device="cuda").manual_seed(21)
    enc = torch.randn(B, cfg.n_audio_ctx, cfg.n_audio_state, generator=g,
                      device="cuda").to(torch.bfloat16)
    xk, xv = TM.cross_kv(cfg, dec, enc)
    planes = {"QuantKVNat": (TM.quantize_cross_kv_nat(xk, H), TM.quantize_cross_kv_nat(xv, H)),
              "QuantKV": (TM.quantize_cross_kv(xk, H), TM.quantize_cross_kv(xv, H))}
    caches = {k: TM.init_kv_cache(cfg, B, dtype=torch.bfloat16, device="cuda") for k in planes}
    tok = torch.randint(0, cfg.n_vocab, (B, 1), generator=g, device="cuda")
    errs, n9a = [], 0
    for step in range(K9A_STEPS):
        logits = {}
        for kind in ("QuantKVNat", "QuantKV"):
            XQ.cross_attention_q8_nat.launches = XQ.cross_attention_q8.launches = 0
            kv_k, kv_v = caches[kind]
            out, kv_k, kv_v = TM.decode_impl(cfg, dec, tok, kv_k, kv_v, step, *planes[kind])
            caches[kind] = kv_k, kv_v
            torch.cuda.synchronize()
            logits[kind] = out[:, 0].float()
            launched = (XQ.cross_attention_q8_nat.launches, XQ.cross_attention_q8.launches)
            check(launched == ((L, 0) if kind == "QuantKVNat" else (0, L)),
                  f"K9a path step {step}, {kind}: launches (K9a, K9b) {launched}")
            n9a += launched[0]
        ref = logits["QuantKV"]
        errs.append(((logits["QuantKVNat"] - ref).abs().max() / ref.abs().max()).item())
        check(bool(torch.isfinite(logits["QuantKVNat"]).all()) and errs[-1] <= K9A_TOL,
              f"K9a path step {step}: logits {errs[-1]:.3e} of max|ref| off the QuantKV run")
        tok = ref.argmax(1)[:, None]
    print(f"[21] {K9A_STEPS} decode_impl steps at B = {B}, q8_0 turbo decoder: QuantKVNat "
          f"(K9a, {planes['QuantKVNat'][0].qs.shape[2]}-row slabs, ta_valid "
          f"{planes['QuantKVNat'][0].ta_valid}) against QuantKV (K9b): logits max|diff| / "
          f"max|ref| per step {[f'{e:.2e}' for e in errs]} (limit {K9A_TOL}); K9a launches "
          f"{n9a}", flush=True)
    del planes, caches, enc, xk, xv
    torch.cuda.empty_cache()
    return n9a


# audio seeds of phase 22 (narrow f32, cross_kv_int8, cuda against cpu):
# (greedy 35 s, beam 3 40 s, transcribe_batched 60 s in 2 chunks); each CPU
# transcript stays the same when the input is scaled by 1 +- 2^-20, 2^-16
# or 2^-13
INT8_KV_NARROW_SEEDS = (0, 1, 0)


def phase_narrow_cross_int8(torch, TF, TM, tok_mod, FullParams, mods, tokens) -> None:
    """int8 cross-KV on the card against the CPU at narrow width (the f32
    timestamp config): greedy whisper_full of 35 s, beam 3 of 40 s and
    transcribe_batched of 60 s in 2 chunks, cross_kv_int8=True: token ids
    equal, at least 100 each; on the card K9b launches, on the CPU none."""
    XQ, TB = mods.XQ, mods.TB
    cfg3 = TM.WhisperConfig(*NARROW_Q)
    params3 = TM.init_params(cfg3, seed=0, dtype=torch.float32, device="cpu")
    p = dataclasses.replace(greedy_params(FullParams), cross_kv_int8=True)
    pb = dataclasses.replace(request_params(FullParams, beam_size=3), cross_kv_int8=True)
    sg, sb, st = INT8_KV_NARROW_SEEDS
    runs = (("greedy 35 s", lambda c: TF.whisper_full(c, p, audio(35.0, sg))),
            ("beam 3, 40 s", lambda c: TF.whisper_full(c, pb, audio(40.0, sb))),
            ("transcribe_batched 60 s in 2 chunks",
             lambda c: TB.transcribe_batched(c, p, audio(60.0, st), n_chunks=2)))
    ctxs = {dev: TF.WhisperContext(cfg3, params3, tok_mod.build_vocab(tokens, cfg3.n_vocab),
                                   TF._synthetic_mel_filters(80), n_loaded=1,
                                   dtype=torch.float32, device=dev) for dev in ("cuda", "cpu")}
    for label, run in runs:
        ids, n9 = {}, {}
        for dev, c in ctxs.items():
            XQ.cross_attention_q8.launches = 0
            r = run(c)
            ids[dev] = [t.id for s in r.segments for t in s.tokens]
            n9[dev] = XQ.cross_attention_q8.launches
        first = next((i for i, (a, b) in enumerate(zip(ids["cuda"], ids["cpu"])) if a != b),
                     min(len(ids["cuda"]), len(ids["cpu"])))
        print(f"[22] narrow f32, cross_kv_int8, {label}: tokens cuda {len(ids['cuda'])} cpu "
              f"{len(ids['cpu'])}, equal {ids['cuda'] == ids['cpu']}, equal prefix {first}; "
              f"K9b launches cuda {n9['cuda']} cpu {n9['cpu']}", flush=True)
        check(ids["cuda"] == ids["cpu"] and len(ids["cpu"]) >= 100 and n9["cuda"] > 0
              and n9["cpu"] == 0, f"narrow int8 cross-KV {label}: cuda and cpu differ, too "
              "few tokens, or K9b not launched on the card")


# the whisper_full options (phases 24 and 25): a grammar whose token
# automaton fits the DFA budget (the synthetic vocabulary's "<i>" tokens)
OPT_GRAMMAR = 'root ::= "<14444>" | "<2>" | "<777>" "<8>"'
# one that lets a window run long after its first token (2 states, 50258
# transitions): the ms per sampled token of a grammar window
OPT_GRAMMAR_OPEN = 'root ::= "<2>" [<>0-9]*'
OPT_DTW_ROWS = 64         # the extra re-decode at a window's worth of tokens (K3's tiles)
OPT_REPLAYED = 8          # text tokens the host Grammar replays at most
OPT_DTW_TOL = 1e-2        # alignment-head probabilities, card against CPU, of max|cpu|
OPT_VAD_TOL = 1e-5        # Silero probabilities, card against CPU, absolute
OPT_SPANS = ((1, 9), (12, 16), (19, 29))   # noise (0.3 rms) in 30 s of silence


def speech_audio(seconds: float, spans, seed: int = 1):
    """Silence with seeded noise (0.3 rms) over `spans` of (start, end) s: the
    random Silero file calls the noise speech and the silence not."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = np.zeros(int(16000 * seconds), np.float32)
    for lo, hi in spans:
        a, b = int(lo * 16000), int(hi * 16000)
        x[a:b] = rng.standard_normal(b - a) * 0.3
    return x


def phase_options(torch, tr, TF, FullParams, mods, tmp) -> None:
    """The whisper_full options at full width on the q8_0 turbo checkpoint
    (temperature_inc = 0): a 30 s grammar request whose windows run the
    on-device loop with the grammar's token automaton and K2 (one launch per
    token step, the host read as often as without a grammar), every text
    token accepted by a host Grammar replay; a 30 s request with token-level
    and DTW timestamps, its DTW re-decode (decode_impl over the window's
    tokens, 16 K3 and 4 K5 launches) timed, t_dtw monotone, and the
    alignment heads' probabilities within OPT_DTW_TOL of the CPU's from the
    same tokens and cross-KV; a random-weight Silero file: its
    probabilities on the card within OPT_VAD_TOL of the CPU's, the time of
    30 s of VAD, and whisper_full(vad=True)."""
    import numpy as np
    from open_whisper_kit_tpu_torch.decode import grammar as G
    from open_whisper_kit_tpu_torch.io import silero_writer as SW
    from open_whisper_kit_tpu_torch.models.silero import vad as SV
    from open_whisper_kit_tpu_torch.timestamps import dtw as DTW
    A, Q, MK, TM, DL, DB = mods.A, mods.Q, mods.MK, mods.TM, mods.DL, mods.DB
    ctx = tr.ctx
    vocab = ctx.vocab

    # ---- a grammar in the on-device loop, K2 ----
    p = dataclasses.replace(greedy_params(FullParams), grammar_rules=OPT_GRAMMAR)
    t0 = time.perf_counter()
    ops = TF._grammar_device_ops(ctx, p)
    dfa_s = time.perf_counter() - t0
    check(ops is not None and ops.allowed.is_cuda and ctx.mega_mode(p) == "all",
          "grammar: no device automaton on the card, or K2 not selected")
    windows, real_seg = [], DL.decode_segment

    def seg(*a, **k):
        r = real_seg(*a, **k)
        windows.append((k.get("grammar"), r))
        return r
    reset_counts(A, Q, MK)
    reads0 = ctx.reads.n
    DL.decode_segment = seg
    try:
        with CallCounter(TM, DL, DB) as calls:
            t0 = time.perf_counter()
            res = tr.transcribe(audio(30.0, 30), p)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        DL.decode_segment = real_seg
    reads = ctx.reads.n - reads0
    n_sample, n_k2 = res.timings.n_sample, MK.mega_decode_step.launches
    steps = [(r.tokens.cpu().numpy(), int(r.n_tokens)) for _, r in windows]
    want_reads = sum(1 + -(-n // DL.POLL) for _, n in steps)
    replayed = 0
    for toks, n in steps:
        g = G.Grammar.from_gbnf(OPT_GRAMMAR)
        for t in toks[:n]:
            if t >= vocab.token_eot or not vocab.id_to_token[t] or replayed >= OPT_REPLAYED:
                continue
            check(int(t) not in set(g.rejected_tokens(vocab)),
                  f"grammar: token {int(t)} is rejected by the host Grammar")
            g.accept_token(vocab.id_to_token[t])
            replayed += 1
    print(f"[24] q8_0 30 s with a grammar: automaton {ops.allowed.shape[0]} states built in "
          f"{dfa_s:.2f} s; windows {len(windows)}, sampled tokens {n_sample}, segments "
          f"{len(res.segments)}; K2 launches {n_k2} (K2 steps {calls.mega}), host reads {reads} "
          f"(without a grammar: {want_reads}); text tokens replayed through the host Grammar "
          f"{replayed}, all accepted; wall {wall:.3f} s, {wall * 1e3 / max(n_sample, 1):.2f} ms "
          "per sampled token", flush=True)
    check(windows and all(w is ops for w, _ in windows), "grammar: a window left the device loop")
    check(n_k2 > 0 and n_k2 == calls.mega and reads == want_reads and replayed > 0,
          "grammar: K2 not on every token step, extra host reads, or no text to replay")
    # ms per sampled token: the open grammar against the same one-window
    # requests without one, in turns
    po = dataclasses.replace(greedy_params(FullParams), grammar_rules=OPT_GRAMMAR_OPEN,
                             device_windows=0)
    t0 = time.perf_counter()
    check(TF._grammar_device_ops(ctx, po) is not None, "open grammar: no device automaton")
    dfa_s = time.perf_counter() - t0
    per_tok = {True: [], False: []}
    for g in (False, True, True, False):
        q = po if g else dataclasses.replace(po, grammar_rules=None)
        reset_counts(A, Q, MK)
        t0 = time.perf_counter()
        r = tr.transcribe(audio(30.0, 30), q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = r.timings.n_sample
        per_tok[g].append((wall * 1e3 / max(n, 1), n, MK.mega_decode_step.launches))
    print(f"[24] q8_0 30 s, one window per call, ms per sampled token (sampled tokens, K2 "
          f"launches) with the open grammar {per_tok[True]} (automaton built in {dfa_s:.2f} "
          f"s), without a grammar {per_tok[False]}", flush=True)
    check(all(k2 > 0 for _, _, k2 in per_tok[True]), "open grammar: K2 not launched")

    # ---- token-level and DTW timestamps: the re-decode on the card ----
    p = dataclasses.replace(greedy_params(FullParams), token_timestamps=True,
                            dtw_token_timestamps=True)
    recs, real_dec = [], TM.decode_impl

    def dec(*a, **k):
        if not k.get("collect_cross_qk"):
            return real_dec(*a, **k)
        torch.cuda.synchronize()
        n3, n5, tiles = Q.qmm.launches, Q.ffn_int8.launches, Q.qmm.launches_by_route["tiles"]
        t0 = time.perf_counter()
        out = real_dec(*a, **k)
        torch.cuda.synchronize()
        recs.append(dict(args=a, kw=k, qk=out[3], ms=(time.perf_counter() - t0) * 1e3,
                         k3=Q.qmm.launches - n3, k5=Q.ffn_int8.launches - n5,
                         tiles=Q.qmm.launches_by_route["tiles"] - tiles))
        return out
    reset_counts(A, Q, MK)
    TM.decode_impl = dec
    real_dtw = DTW.compute_dtw_timestamps
    dtw_ms = []

    def timed_dtw(*a, **k):
        t0 = time.perf_counter()
        real_dtw(*a, **k)
        dtw_ms.append((time.perf_counter() - t0) * 1e3)
    DTW.compute_dtw_timestamps = timed_dtw
    try:
        t0 = time.perf_counter()
        res = tr.transcribe(audio(30.0, 30), p)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TM.decode_impl, DTW.compute_dtw_timestamps = real_dec, real_dtw
    t_dtw = [t.t_dtw for s in res.segments for t in s.tokens if t.t_dtw >= 0]
    n_t0 = sum(t.t0 >= 0 for s in res.segments for t in s.tokens)
    heads = DTW.heads_for_model(ctx.model_type, n_text_layer=ctx.cfg.n_text_layer,
                                n_head=ctx.cfg.n_text_head)
    rec = recs[0] if recs else None
    check(rec is not None, "DTW: no re-decode ran")
    cfg, a = ctx.cfg, rec["args"]
    T = a[2].shape[1]
    dec_cpu = TF._to_device(ctx.params["decoder"], "cpu")
    kk, kv = TM.init_kv_cache(cfg, 1, dtype=ctx.dtype, device="cpu")
    cpu_qk = real_dec(cfg, dec_cpu, a[2].cpu(), kk, kv, 0, a[6].cpu(), a[7].cpu(),
                      **rec["kw"])[3]
    li = [l for l, _ in heads]
    hi = [h for _, h in heads]
    card_h, cpu_h = rec["qk"][li, 0, hi].float().cpu(), cpu_qk[li, 0, hi].float()
    err = ((card_h - cpu_h).abs().max() / cpu_h.abs().max()).item()
    # the same re-decode at OPT_DTW_ROWS tokens (a talkative window's): K3 on
    # its tiles, K5 above 16 rows
    toks = torch.cat([a[2][:, :3], torch.randint(0, vocab.token_eot, (1, OPT_DTW_ROWS - 4),
                      generator=torch.Generator().manual_seed(5)).to(a[2].device),
                      a[2][:, -1:]], dim=1)
    TM.decode_impl = dec
    try:
        kk, kv = TM.init_kv_cache(cfg, 1, dtype=ctx.dtype, device=ctx.device)
        out64 = TM.decode_impl(cfg, ctx.params["decoder"], toks, kk, kv, 0, a[6], a[7],
                                      logits_pos=OPT_DTW_ROWS - 1, collect_cross_qk=True)
    finally:
        TM.decode_impl = real_dec
    big = recs.pop()
    kk, kv = TM.init_kv_cache(cfg, 1, dtype=ctx.dtype, device="cpu")
    cpu_big = real_dec(cfg, dec_cpu, toks.cpu(), kk, kv, 0, a[6].cpu(), a[7].cpu(),
                       logits_pos=OPT_DTW_ROWS - 1, collect_cross_qk=True)[3][li, 0, hi].float()
    err_big = ((out64[3][li, 0, hi].float().cpu() - cpu_big).abs().max()
               / cpu_big.abs().max()).item()
    ffn_tiles = Q.ffn_int8.launches_by_route["tiles"]
    print(f"[24] q8_0 30 s with token and DTW timestamps: segments {len(res.segments)}, "
          f"tokens with t0 {n_t0}, with t_dtw {len(t_dtw)}; DTW re-decodes {len(recs)} "
          f"(T = {[r['args'][2].shape[1] for r in recs]} rows): decode_impl "
          f"{[round(r['ms'], 2) for r in recs]} ms, whole DTW step "
          f"{[round(m, 2) for m in dtw_ms]} ms per window; K3 launches per re-decode "
          f"{[r['k3'] for r in recs]} (tiles {[r['tiles'] for r in recs]}), K5 "
          f"{[r['k5'] for r in recs]}; alignment heads {len(heads)}, card against CPU "
          f"max|diff| / max|cpu| {err:.2e} at T = {T}; wall {wall:.3f} s", flush=True)
    print(f"[24] DTW re-decode at T = {OPT_DTW_ROWS}: {big['ms']:.2f} ms, K3 launches "
          f"{big['k3']} (tiles {big['tiles']}), K5 {big['k5']}; card against CPU "
          f"max|diff| / max|cpu| {err_big:.2e}", flush=True)
    check(len(t_dtw) > 0 and n_t0 > 0 and t_dtw == sorted(t_dtw),
          "DTW: no t_dtw, no token t0, or t_dtw not monotone")
    check(all(r["k3"] == 16 and r["k5"] == 4
              and r["tiles"] == (16 if r["args"][2].shape[1] > Q.QMM_ROWS_MAX else 0)
              for r in recs), "DTW re-decode: K3 / K5 launch counts off")
    check(err <= OPT_DTW_TOL and err_big <= OPT_DTW_TOL,
          f"DTW: alignment heads card against CPU {err:.2e}, {err_big:.2e}")
    check(big["k3"] == big["tiles"] == 16 and big["k5"] == 4 and ffn_tiles >= 4,
          "DTW re-decode at T > 16: K3 off its tiles, or K5 off its M > 16 body")

    # ---- the Silero VAD prefilter ----
    path = tmp / "silero-random.bin"
    SW.write_silero(path, SW.random_silero_tensors(seed=0))
    x = speech_audio(30.0, OPT_SPANS)
    vad = ctx.get_vad(str(path))
    check(vad.device.type == "cuda", "VAD model not on the card")
    vad.detect_speech(x)
    vad_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pc = vad.detect_speech(x)
        vad_ms.append((time.perf_counter() - t0) * 1e3)
    pp = SV.SileroVAD.from_file(str(path), device="cpu").detect_speech(x)
    verr = float(np.abs(pc - pp).max())
    p = dataclasses.replace(greedy_params(FullParams), vad=True, vad_model_path=str(path))
    reset_counts(A, Q, MK)
    t0 = time.perf_counter()
    res = tr.transcribe(x, p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [(s.t0, s.t1) for s in res.segments if not (0 <= s.t0 < s.t1 <= 3010)]
    print(f"[24] Silero VAD (random weights) on 30 s: {len(pc)} chunks, "
          f"{statistics.median(vad_ms):.1f} ms (median of 3, host clock), probabilities "
          f"max|card - cpu| {verr:.2e}; whisper_full(vad=True): segments {len(res.segments)}, "
          f"sampled tokens {res.timings.n_sample}, encoder passes {res.timings.n_encode}, "
          f"wall {wall:.3f} s", flush=True)
    check(verr <= OPT_VAD_TOL and len(pc) == 938, f"VAD: card against CPU {verr:.2e}")
    check(res.segments and not bad and A.mha_packed.launches == TURBO_LAYERS
          * res.timings.n_encode, f"VAD request: segments {bad[:2]} outside the audio, or "
          "K1 off its count")


def phase_narrow_options(torch, TF, TM, tok_mod, FullParams, tmp, tokens) -> None:
    """Each whisper_full option on the card against the CPU at narrow width
    (the f32 timestamp config, 25 s of audio): a grammar in the device loop
    and host-stepped, ref_sampling greedy at t = 0.4 and beam 3, the abort
    callback at step 25 of 30 s, the logits filter, token and DTW
    timestamps, VAD on speech spans: the same segments and token t0 / t1 /
    t_dtw."""
    from open_whisper_kit_tpu_torch.decode.params import BeamSearchParams, SamplingStrategy
    cfg3 = TM.WhisperConfig(*NARROW_Q)
    params3 = TM.init_params(cfg3, seed=0, dtype=torch.float32, device="cpu")
    path = tmp / "silero-random.bin"
    base = greedy_params(FullParams)
    beam = dict(strategy=SamplingStrategy.BEAM_SEARCH,
                beam_search=BeamSearchParams(beam_size=3))

    def aborting(at):
        n = [0]

        def abort():
            n[0] += 1
            return n[0] >= at
        return abort
    cases = (("grammar", dict(grammar_rules=OPT_GRAMMAR), 25.0),
             ("grammar, host-stepped", dict(grammar_rules=OPT_GRAMMAR, use_device_loops=False,
                                           max_tokens=2, single_segment=True), 25.0),
             ("ref_sampling, t = 0.4, best_of 3", dict(ref_sampling=True, temperature=0.4), 25.0),
             ("ref_sampling, beam 3", dict(ref_sampling=True, **beam), 25.0),
             ("abort at step 25", dict(max_tokens=24), 30.0),
             ("logits_filter_callback", dict(logits_filter_callback=lambda *a: None), 25.0),
             ("token + DTW timestamps", dict(token_timestamps=True,
                                             dtw_token_timestamps=True), 25.0),
             ("VAD", dict(vad=True, vad_model_path=str(path)), None))
    ctxs = {dev: TF.WhisperContext(cfg3, params3, tok_mod.build_vocab(tokens, cfg3.n_vocab),
                                   TF._synthetic_mel_filters(80), n_loaded=1,
                                   dtype=torch.float32, device=dev) for dev in ("cuda", "cpu")}
    for label, kw, secs in cases:
        x = audio(secs, 2) if secs else speech_audio(30.0, OPT_SPANS)
        out = {}
        for dev, c in ctxs.items():
            p = dataclasses.replace(base, **kw)
            p.greedy.best_of = 3
            if label.startswith("abort"):
                p.abort_callback = aborting(25)
            r = TF.whisper_full(c, p, x)
            out[dev] = [(s.t0, s.t1, s.text, [(t.id, t.t0, t.t1, t.t_dtw) for t in s.tokens])
                        for s in r.segments]
        n_tok = sum(len(s[3]) for s in out["cpu"])
        print(f"[25] narrow f32, {label}: segments {len(out['cpu'])}, tokens {n_tok}, cuda == "
              f"cpu (ids, t0, t1, t_dtw) {out['cuda'] == out['cpu']}", flush=True)
        check(out["cuda"] == out["cpu"] and n_tok > 0, f"narrow {label}: cuda and cpu differ")


# SortFormer diarization (phases 26-27): the published model's shapes
# (SortformerConfig(): 17 Conformer layers of 512, 18 Transformer layers of
# 192, 117 M parameters) from seed-0 random weights written as an f16 GGUF,
# on DIAR_SECS of seeded noise; the TINY config of the JAX package's tests
# for the narrow card-against-CPU phase
DIAR_SECS = 90.0
DIAR_CPU_SECS = {"offline": 90.0, "low_latency": 10.0}
DIAR_BATCH_SECS = (30.0, 45.0, 60.0, 90.0)
DIAR_TINY = dict(n_mels=32, d_model=32, n_layers=2, n_heads=4, conv_kernel=5,
                 ff_expansion=2, subsampling_channels=8, tf_layers=2, tf_d_model=16,
                 tf_heads=4, tf_ff=32)


def device_ops(torch, run) -> int:
    """The device operations (kernels and copies) one call of run() issues,
    counted from a torch.profiler trace; 0 if the trace holds none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def first_compress(scfg, useds) -> int:
    """The index of the first chunk whose state update compresses the
    speaker cache (len(useds) if none): the AOSC lengths follow the chunk
    schedule alone (streaming._state_update)."""
    sc = fifo = 0
    for i, used in enumerate(useds):
        total = fifo + used
        if total > scfg.fifo_len:
            pop = min(max(scfg.spkcache_update_period, used - scfg.fifo_len + fifo), total)
            sc, fifo = sc + pop, total - pop
            if sc > scfg.spkcache_len:
                return i
        else:
            fifo = total
    return len(useds)


def shared_frames(SD, cfg, scfg, feat: int, feat_full: int, to_compress: bool = True) -> int:
    """The frames of the chunks that a file of `feat` mel frames shares with
    the schedule of `feat_full` frames; with `to_compress`, up to the first
    compression of the speaker cache: where two correct runs must agree
    (phase_diarize)."""
    own = SD._chunk_schedule(cfg, scfg, feat)
    full = SD._chunk_schedule(cfg, scfg, feat_full)
    stop = first_compress(scfg, full[3]) + 1 if to_compress else len(own[0])
    k = 0
    while k < min(len(own[0]), stop) and all(own[j][k] == full[j][k] for j in range(4)):
        k += 1
    return sum(own[3][:k])


def phase_diarize(torch, tmp) -> None:
    """Phase 26: SortFormer diarization at the published width through
    api.Diarizer (module docstring).

    The seed-0 random model's predictions hardly depend on the audio (per
    speaker within ~2e-2 over a file), so from the first compression of the
    speaker cache on, its top-K picks among scores that lie within f32
    noise of each other: two correct runs part there (the host loop parts
    from itself, up to 6e-3, when the input is scaled by 1 + 2^-20). The
    loops are held to each other on the chunks up to that compression, and
    the compression itself is held to the host's on full-width states
    whose scores are apart."""
    import numpy as np
    from open_whisper_kit_tpu_torch import api as TAPI
    from open_whisper_kit_tpu_torch.align import rttm as RT
    from open_whisper_kit_tpu_torch.models.sortformer import device_aosc as SD
    from open_whisper_kit_tpu_torch.models.sortformer import export as SE
    from open_whisper_kit_tpu_torch.models.sortformer import model as SM
    from open_whisper_kit_tpu_torch.models.sortformer import streaming as SS
    smi = nvidia_smi_line()
    cfg = SM.SortformerConfig()
    t0 = time.perf_counter()
    path = SE.write_sortformer_gguf(tmp / "sortformer-seed0-f16.gguf", cfg,
                                    SM.init_params(cfg, seed=0, device="cpu"))
    t1 = time.perf_counter()
    card = TAPI.Diarizer(model_path=path, device="cuda")
    cpu = TAPI.Diarizer(model_path=path, device="cpu")
    torch.cuda.synchronize()
    n_par = sum(v.numel() for k, v in _tensor_leaves(card.engine.params)
                if k not in ("mel_fb", "mel_window"))
    print(f"[26] SortformerConfig() seed 0: {n_par / 1e6:.1f} M parameters, f16 GGUF "
          f"{path.stat().st_size / 2**20:.1f} MiB written in {t1 - t0:.1f} s, loaded on "
          f"cuda and cpu in {time.perf_counter() - t1:.1f} s | {smi}", flush=True)
    check(card.device.type == "cuda" and card._auto_device_state(None),
          "Diarizer on the card does not default to the device loop")
    reads = card.engine.reads
    x = audio(DIAR_SECS, 26)

    def segs(segments):
        return [dataclasses.astuple(s) for s in segments]

    def timed(fn):
        torch.cuda.synchronize()
        n0, t0 = reads.n, time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, reads.n - n0

    def schedule(scfg, secs):
        useds = SD._chunk_schedule(cfg, scfg, int(16000 * secs) // cfg.hop_length)[3]
        i = first_compress(scfg, useds)
        return useds, i, sum(useds[:i + 1])

    def dmax(a, b, n=None):
        return float(np.abs(a[:n] - b[:n]).max()) if len(a[:n]) else 0.0

    full = {}
    for preset in ("offline", "low_latency"):
        scfg = TAPI.PRESETS[preset]
        useds, i_c, n_pre = schedule(scfg, DIAR_SECS)
        n_chunks = len(useds)
        for ds in (True, False):      # first calls: allocator and cuBLAS set-up
            card.diarize(audio(2.0, 1), preset, device_state=ds)
        (pd, sd), ms_dev, r_dev = timed(lambda: card.diarize(x, preset, device_state=True))
        (ph, sh), ms_host, r_host = timed(lambda: card.diarize(x, preset, device_state=False))
        full[preset] = pd
        # the noise floor: the host loop on the input scaled by 1 + 2^-20 (on
        # 45 s for low_latency), over the frames the two schedules share
        secs_s = DIAR_SECS if preset == "offline" else 45.0
        ps, _ = card.diarize(x[:int(16000 * secs_s)] * np.float32(1 + 2.0 ** -20), preset,
                             device_state=False)
        n_s = shared_frames(SD, cfg, scfg, int(16000 * secs_s) // cfg.hop_length,
                            int(16000 * DIAR_SECS) // cfg.hop_length, to_compress=False)
        per30 = 30.0 / DIAR_SECS
        print(f"[26] {preset}, {DIAR_SECS:.0f} s, {n_chunks} chunks: device loop "
              f"{ms_dev * per30:.1f} ms per 30 s of audio ({ms_dev / n_chunks:.2f} ms a chunk, "
              f"{r_dev} host read), host loop {ms_host * per30:.1f} ms per 30 s "
              f"({ms_host / n_chunks:.2f} ms a chunk, {r_host} host reads, "
              f"{r_host / n_chunks:.0f} a chunk) | {smi}", flush=True)
        lo, hi = ph.min(0), ph.max(0)
        print(f"[26] {preset}: frames {pd.shape[0]}, probabilities per speaker "
              f"{' '.join(f'{a:.4f}..{b:.4f}' for a, b in zip(lo, hi))}, RTTM segments {len(sd)}, "
              f"equal {segs(sd) == segs(sh)}; device against host loop max|d prob| over the "
              f"{n_pre} frames up to the first compression (chunk {i_c}) {dmax(pd, ph, n_pre):.2e}, "
              f"over the file {dmax(pd, ph):.2e}; the host loop against itself on the input "
              f"x (1 + 2^-20), the {n_s} frames of {secs_s:.0f} s {dmax(ph, ps, n_s):.2e}",
              flush=True)
        check(pd.shape == ph.shape == (sum(useds), 4) and r_dev == 1 and r_host == n_chunks
              and np.isfinite(pd).all(), f"diarize {preset}: shapes or host reads wrong")
        check(dmax(pd, ph, n_pre) <= 1e-5 and segs(sd) == segs(sh) and len(sd) > 0,
              f"diarize {preset}: the device loop and the host loop differ")
        ops = {}
        secs_p = 30.0 if preset == "offline" else 5.0
        for ds in (True, False):
            ops[ds] = device_ops(torch, lambda: card.diarize(x[:int(16000 * secs_p)], preset,
                                                             device_state=ds))
        n_p = len(schedule(scfg, secs_p)[0])
        print(f"[26] {preset}: device operations per chunk (torch.profiler, {secs_p:.0f} s, "
              f"{n_p} chunks): device loop {ops[True] / n_p:.0f}, host loop {ops[False] / n_p:.0f}"
              if ops[True] else f"[26] {preset}: device operations per chunk: not measured "
              "(the trace holds no device events)", flush=True)
        # the card against the CPU, from the same file
        secs = DIAR_CPU_SECS[preset]
        xc = x[:int(16000 * secs)]
        _, i_cc, n_cpu = schedule(TAPI.PRESETS[preset], secs)
        t0 = time.perf_counter()
        pc, sc = cpu.diarize(xc, preset)
        ms_cpu = (time.perf_counter() - t0) * 1e3
        pg, sg = (pd, sd) if secs == DIAR_SECS else card.diarize(xc, preset)
        print(f"[26] {preset}, {secs:.0f} s: card (device loop) against cpu (host loop, "
              f"{ms_cpu * 30.0 / secs:.0f} ms per 30 s) max|d prob| over the {n_cpu} frames up "
              f"to the first compression {dmax(pg, pc, n_cpu):.2e} (expected within 1e-4), "
              f"over the file {dmax(pg, pc):.2e}; segments equal {segs(sg) == segs(sc)} "
              f"({len(sc)} on the cpu) | {smi}", flush=True)
        check(pg.shape == pc.shape and dmax(pg, pc, n_cpu) <= 1e-4 and segs(sg) == segs(sc),
              f"diarize {preset}: card and cpu differ")

    # the compression at full width: the card's device form against the
    # host's numpy form on states whose scores are apart, and against the
    # CPU's device form on states of exact ties (lax.top_k's order)
    rng = np.random.default_rng(26)
    for name in ("offline", "low_latency"):
        scfg = TAPI.PRESETS[name]
        n = scfg.spkcache_len + scfg.spkcache_update_period
        SC_MAX = scfg.spkcache_len + scfg.fifo_len + 190
        for ties in (False, True):
            st = SS.StreamState(cfg.d_model)
            st.spkcache = rng.standard_normal((n, cfg.d_model)).astype(np.float32)
            p = rng.random((n, 4)).astype(np.float32)
            if ties:
                p = np.where(p > 0.6, 1.0, np.where(p < 0.3, 0.0, 0.7)).astype(np.float32)
            st.spkcache_preds, st.spkcache_preds_valid = p, True
            st.mean_sil_emb = rng.standard_normal(cfg.d_model).astype(np.float32)
            bufs = [np.zeros((SC_MAX,) + a.shape[1:], np.float32) for a in (st.spkcache, p)]
            bufs[0][:n], bufs[1][:n] = st.spkcache, p
            got = {}
            for dev in ("cuda", "cpu"):
                sc, sp, ln = SD._compress_dev(
                    torch.from_numpy(bufs[0])[None].to(dev), torch.from_numpy(bufs[1])[None].to(dev),
                    torch.tensor([n], device=dev), torch.from_numpy(st.mean_sil_emb)[None].to(dev),
                    scfg)
                got[dev] = (sc[0, :scfg.spkcache_len].cpu().numpy(),
                            sp[0, :scfg.spkcache_len].cpu().numpy(), int(ln[0]))
            SS.compress_spkcache(st, scfg)
            same_host = (np.array_equal(got["cuda"][0], st.spkcache)
                         and np.array_equal(got["cuda"][1], st.spkcache_preds))
            same_cpu = all(np.array_equal(a, b) for a, b in zip(got["cuda"], got["cpu"]))
            print(f"[26] compress_spkcache, {name}, {n} x {cfg.d_model} -> "
                  f"{scfg.spkcache_len}, {'exact ties' if ties else 'scores apart'}: card "
                  f"(device form) == cpu (device form) {same_cpu}, == host (numpy) "
                  f"{same_host}", flush=True)
            check(same_cpu and got["cuda"][2] == scfg.spkcache_len and (ties or same_host),
                  f"compress_spkcache at full width ({name}, ties {ties}): the card differs")

    # lockstep batch of uneven files against the single calls
    preset = "low_latency"
    scfg = TAPI.PRESETS[preset]
    xs = [x[:int(16000 * s)] for s in DIAR_BATCH_SECS]
    batch, ms_b, r_b = timed(lambda: card.diarize_batch(xs, preset))
    # the single calls (the 90 s file's is the device-loop run above)
    singles = [full[preset] if len(a) == len(x) else card.diarize(a, preset)[0] for a in xs]
    feats = [len(a) // cfg.hop_length for a in xs]
    for (pb, _), ps, f, secs in zip(batch, singles, feats, DIAR_BATCH_SECS):
        n_same = shared_frames(SD, cfg, scfg, f, max(feats))
        print(f"[26] diarize_batch, {preset}, {secs:.0f} s of {len(xs)} files: frames "
              f"{pb.shape[0]}; the {n_same} frames of the chunks it shares with the single "
              f"call up to the first compression within {dmax(pb, ps, n_same):.2e} of it, "
              f"the file {dmax(pb, ps):.2e}", flush=True)
        check(pb.shape == ps.shape and n_same > 0 and dmax(pb, ps, n_same) <= 1e-4
              and np.isfinite(pb).all(), f"diarize_batch {secs:.0f} s differs from its single call")
    print(f"[26] diarize_batch of {len(xs)} files ({sum(DIAR_BATCH_SECS):.0f} s): "
          f"{ms_b:.1f} ms, {ms_b * 30.0 / sum(DIAR_BATCH_SECS):.1f} ms per 30 s of audio, "
          f"{r_b} host read | {smi}", flush=True)
    check(r_b == 1, "diarize_batch on the card read the device more than once")

    # true streaming in 0.5 s pieces
    xs30 = x[:16000 * 30]
    out = {}
    for ds in (True, False):
        st = card.stream(preset, device_state=None if ds else False)
        check(st.device_state is ds, "stream() did not pick the device state on the card")
        n0, t0 = reads.n, time.perf_counter()
        for i in range(0, len(xs30), 8000):
            st.feed(xs30[i:i + 8000])
        st.finish()
        out[ds] = (st.probs(), (time.perf_counter() - t0) * 1e3, reads.n - n0, st.n_chunks)
    (pd, ms_d, r_d, nc), (ph, ms_h, _, _) = out[True], out[False]
    # a stream's chunks take no left context: chunk_len frames each
    n_pre = (first_compress(scfg, [scfg.chunk_len] * nc) + 1) * scfg.chunk_len
    ref = singles[DIAR_BATCH_SECS.index(30.0)]     # diarize() of the same 30 s
    print(f"[26] stream {preset}, 30 s in 0.5 s pieces: {nc} chunks, device state "
          f"{ms_d:.1f} ms ({r_d / nc:.0f} host read a chunk), host state {ms_h:.1f} ms; device "
          f"against host state max|d prob| over the {min(n_pre, len(pd))} frames up to the "
          f"first compression {dmax(pd, ph, n_pre):.2e}, the stream {dmax(pd, ph):.2e}; "
          f"against diarize({preset}) frames {len(pd)} / {len(ref)}, max|d prob| "
          f"{dmax(pd, ref, min(len(pd), len(ref))):.2e} (no left context, the mel restarts "
          f"each round) | {smi}", flush=True)
    check(pd.shape == ph.shape and dmax(pd, ph, n_pre) <= 1e-5 and r_d == nc
          and np.isfinite(pd).all(), "stream: the device state and the host state differ")
    check(RT.to_rttm(RT.probs_to_segments(pd, 0.5, 11, "s")).startswith("SPEAKER s 1 "),
          "stream: no RTTM segment")


def _tensor_leaves(tree, key=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensor_leaves(v, k)
    else:
        yield key, tree


def phase_narrow_diarize(torch, TF, TM, tok_mod, FullParams, tokens) -> None:
    """Phase 27: the narrow f32 Whisper (3 decoder layers) with token
    timestamps, words_from_result, the TINY diarizer and api.align, on the
    card and on the CPU from the same weights: the same
    DiarizedTranscription."""
    import numpy as np
    from open_whisper_kit_tpu_torch import api as TAPI
    from open_whisper_kit_tpu_torch.models.sortformer import model as SM
    cfg3 = TM.WhisperConfig(*NARROW_Q)
    params3 = TM.init_params(cfg3, seed=0, dtype=torch.float32, device="cpu")
    tiny = SM.SortformerConfig(**DIAR_TINY)
    sparams = SM.init_params(tiny, seed=0, device="cpu")
    x = audio(25.0, 2)
    out = {}
    for dev in ("cuda", "cpu"):
        c = TF.WhisperContext(cfg3, params3, tok_mod.build_vocab(tokens, cfg3.n_vocab),
                              TF._synthetic_mel_filters(80), n_loaded=1,
                              dtype=torch.float32, device=dev)
        p = greedy_params(FullParams)
        p.token_timestamps = True
        words = TAPI.words_from_result(TF.whisper_full(c, p, x), ctx=c)
        d = TAPI.Diarizer(cfg=tiny, params=sparams, device=dev)
        _, segments = d.diarize(x, stream_config="low_latency", median_win=3)
        out[dev] = TAPI.align(words, segments)
    a, b = out["cuda"], out["cpu"]
    same = (a.text == b.text
            and [(w.word, w.start, w.end, w.speaker) for w in a.words]
            == [(w.word, w.start, w.end, w.speaker) for w in b.words]
            and [(u.speaker, u.text, u.start, u.end, len(u.words)) for u in a.segments]
            == [(u.speaker, u.text, u.start, u.end, len(u.words)) for u in b.segments])
    dp = max((abs(u.probability - v.probability) for u, v in zip(a.words, b.words)),
             default=0.0)
    print(f"[27] narrow f32 transcribe (token timestamps) + TINY diarizer + api.align, 25 s: "
          f"words {len(a.words)}, speakers {sorted({w.speaker for w in a.words if w.speaker})}, "
          f"utterances {len(a.segments)}, cuda == cpu {same}, max|d word probability| "
          f"{dp:.2e}", flush=True)
    check(same and len(a.words) > 0 and dp <= 1e-5 and np.isfinite(dp),
          "narrow diarized transcription: cuda and cpu differ")


# serving and streaming at full width (phase 28): the stream's feed pieces,
# its step / length / keep, and the seconds of each request kind
SERVE_SECS = 30.0
SERVE_SEEDS = (281, 282, 283, 284)
STREAM_SECS = 60.0
STREAM_CFG = {"step_ms": 3000, "length_ms": 10000, "keep_ms": 200}
STREAM_PIECE = 8000          # 0.5 s of s16le a /stream/feed
AUDIO_CTX = 768
AC_STEPS = 5                 # stream steps of 3 s timed at AUDIO_CTX
DIAR_SERVE_SECS = 30.0


def wav_bytes(x) -> bytes:
    """16 kHz mono s16le WAV bytes of f32 samples in [-1, 1]."""
    import io
    import wave
    import numpy as np
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def multipart(fields: dict) -> tuple[bytes, str]:
    b = "smokeboundary28"
    parts = [f'--{b}\r\nContent-Disposition: form-data; name="{k}"'.encode()
             + (b'; filename="a.wav"' if k == "file" else b"") + b"\r\n\r\n"
             + (v if isinstance(v, bytes) else str(v).encode()) + b"\r\n"
             for k, v in fields.items()]
    return b"".join(parts) + f"--{b}--\r\n".encode(), f"multipart/form-data; boundary={b}"


def http_post(url: str, body: bytes, ctype: str) -> str:
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.read().decode()
    except urllib.error.HTTPError as e:
        raise PhaseFailed(f"POST {url}: HTTP {e.code} {e.read()[:500]!r}") from None


def handler_params(FullParams, **kw):
    """The FullParams the server's /inference handler builds from a form
    that sets only temperature_inc=0 (and response_format)."""
    p = FullParams(print_progress=False, language="en", temperature_inc=0.0, max_len=60)
    p.greedy = dataclasses.replace(p.greedy, best_of=2)
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def stream_events(evs) -> list:
    return [(e.text, e.t0, e.t1, e.final, e.speaker_turn_next) for e in evs]


def audio_ctx_steps(torch, tr, state, mods, smi) -> None:
    """Phase 28's stream steps at AUDIO_CTX on the server's transcriber:
    warmed once, then timed; K1 held to its plain version on the steps' own
    encoder inputs, and the tokens with K2 to those with K2 off
    (decode_impl) from the same encoder outputs."""
    from open_whisper_kit_tpu_torch.audio import mel as MEL
    from open_whisper_kit_tpu_torch.decode import stream as TS
    A, Q, MK, TM, LR = mods.A, mods.Q, mods.MK, mods.TM, mods.TB.LR
    xa = audio(3.0 * AC_STEPS, 286)
    ac_pieces = [xa[i:i + 48000] for i in range(0, len(xa), 48000)]

    def ac_stream(k2=True, times=None):
        st = TS.StreamingTranscriber(tr.ctx, TS.StreamParams(audio_ctx=AUDIO_CTX,
                                                             no_fallback=True))
        if not k2:
            real_fp = st._full_params

            def k2_off():
                fp = real_fp()
                fp.megakernel = False
                return fp
            st._full_params = k2_off
        ev = []
        with state.lock:
            for piece in ac_pieces:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev += st.feed(piece)
                torch.cuda.synchronize()
                if times is not None:
                    times.append((time.perf_counter() - t0) * 1e3)
        check(st.n_iter == len(ac_pieces), f"audio_ctx {AUDIO_CTX}: {st.n_iter} steps "
              f"for {len(ac_pieces)} pieces of 3 s")
        return stream_events(ev)
    ac_stream()             # warm: K2's step pack for Ta 768, K1's 768 shape
    reset_counts(A, Q, MK)
    ac_ms = []
    ev_t = ac_stream(times=ac_ms)
    n_k1, n_k2 = A.mha_packed.launches, MK.mega_decode_step.launches
    print(f"[28] stream steps at audio_ctx {AUDIO_CTX} ({AC_STEPS} steps of 3 s, warmed "
          f"once): ms per step median {statistics.median(ac_ms):.1f}, slowest "
          f"{max(ac_ms):.1f} (min {min(ac_ms):.1f}); per step K1 launches "
          f"{n_k1 / AC_STEPS:.1f}, K2 launches {n_k2 / AC_STEPS:.1f}; {len(ev_t)} events "
          f"| {smi}", flush=True)
    check(n_k1 == TURBO_LAYERS * AC_STEPS and n_k2 > 0
          and all(0 <= e[1] <= e[2] for e in ev_t),
          f"audio_ctx {AUDIO_CTX} steps: K1 {n_k1}, K2 {n_k2} launches")
    # the encoder + cross-KV pass alone at AUDIO_CTX and at the full window
    mel = MEL.log_mel_spectrogram(xa, tr.ctx.filters, device=tr.ctx.device)

    def enc_ms(ac):
        ts = []
        with state.lock:
            for _ in range(AC_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.ctx.encode_window(mel.data, 0, ac)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)
    e_ac, e_full = enc_ms(AUDIO_CTX), enc_ms(0)
    print(f"[28] the encoder + cross-KV pass alone (median of {AC_STEPS}): "
          f"{AUDIO_CTX} positions {e_ac:.1f} ms, {tr.ctx.cfg.n_audio_ctx} positions "
          f"{e_full:.1f} ms | {smi}", flush=True)
    # the same steps again, keeping the encoder's attention inputs and
    # outputs, then with K2 off (decode_impl) from those encoder outputs
    k1_in, real_mha = [], TM.mha_full

    def keeping_mha(q, k, v, n_head, scale, kv_valid=None):
        if len(k1_in) < TURBO_LAYERS:
            k1_in.append((q.clone(), k.clone(), v.clone(), n_head, scale, kv_valid))
        return real_mha(q, k, v, n_head, scale, kv_valid)
    replay = EncoderReplay(TM)
    TM.mha_full = keeping_mha
    try:
        with replay.record(), StepLogits(torch, LR, 2) as on_steps:
            ev_on = ac_stream()
    finally:
        TM.mha_full = real_mha
    reset_counts(A, Q, MK)
    with replay.replay(tr.ctx.device), StepLogits(torch, LR, 2) as off_steps:
        ev_off = ac_stream(k2=False)
    n_k1_off, n_k2_off = A.mha_packed.launches, MK.mega_decode_step.launches
    check(ev_on == ev_t, f"audio_ctx {AUDIO_CTX}: a second run gave other events")
    check(replay.served == len(replay.outs) == AC_STEPS and n_k1_off == n_k2_off == 0,
          f"audio_ctx {AUDIO_CTX} with K2 off: {replay.served} of {len(replay.outs)} "
          f"encoder outputs replayed, K1 {n_k1_off} / K2 {n_k2_off} launches")
    # K1 at the steps' own encoder shape, on the first step's inputs
    errs = []
    for q, k, v, n_head, scale, kv_valid in k1_in:
        n_valid = q.shape[1] if kv_valid is None else kv_valid
        ref = A.mha_plain(q, k, v, n_head, scale, n_valid)
        out = A.mha_packed(q, k, v, scale, n_valid)
        errs.append(((out.float() - ref.float()).abs().max().item(),
                     ref.float().abs().max().item(), bool(torch.isfinite(out).all())))
    worst = max(e / r for e, r, _ in errs)
    print(f"[28] K1 on the audio_ctx {AUDIO_CTX} step's own inputs: {len(k1_in)} layers at "
          f"{tuple(k1_in[0][0].shape)} {k1_in[0][0].dtype}, n_valid "
          f"{k1_in[0][5] or k1_in[0][0].shape[1]}; max|err| / max|ref| against "
          f"mha_plain {worst:.3e} (limit 1e-2)", flush=True)
    check(len(k1_in) == TURBO_LAYERS and tuple(k1_in[0][0].shape[1:]) == (AUDIO_CTX, 1280)
          and all(f for _, _, f in errs) and worst <= 1e-2,
          f"K1 at audio_ctx {AUDIO_CTX} disagrees with its plain version")
    # the tokens with K2 against K2 off (decode_impl), one encoder output
    on_rows, off_rows = on_steps.rows(), off_steps.rows()
    ids_on = [int(r[1][0, 0]) for r in on_rows]
    ids_off = [int(r[1][0, 0]) for r in off_rows]
    equal = next((j for j, (x, y) in enumerate(zip(ids_on, ids_off)) if x != y),
                 min(len(ids_on), len(ids_off)))
    part = first_parting(on_rows, off_rows)
    line = (f"[28] audio_ctx {AUDIO_CTX}, {AC_STEPS} steps from one encoder output: tokens "
            f"K2 {len(ids_on)}, K2 off {len(ids_off)}, equal {ids_on == ids_off}, equal "
            f"tokens {equal}, events equal {ev_on == ev_off}")
    if ids_on != ids_off and part is not None and part[1] is not None:
        step, _, gap, big, diff = part
        line += (f"; the first step whose best token differs: {step}, the K2-off gap there "
                 f"{gap:.3e} of max|logit| {big:.3e}, max|logits K2 - K2 off| {diff:.3e}")
    print(line, flush=True)
    if ids_on == ids_off:
        check(ev_on == ev_off and len(ids_on) > 0,
              f"audio_ctx {AUDIO_CTX}: equal tokens with and without K2, other events")
    else:
        check(part is not None and part[1] is not None
              and part[2] <= K7_ARGMAX_GAP * part[3],
              f"audio_ctx {AUDIO_CTX}: K2 parts from K2 off at token {equal}, not at a "
              "near tie of K2 off's logits")


def phase_serving(torch, TF, FullParams, mods, q8_path, gguf_path) -> None:
    """Phase 28: the port's server (server/http_server.py) on a thread,
    serving the q8_0 turbo checkpoint on the card (K2 auto), each response
    held to the direct call on the same model (module docstring)."""
    import threading
    import numpy as np
    from open_whisper_kit_tpu_torch.audio.wav import load_wav
    from open_whisper_kit_tpu_torch.cli import outputs as O
    from open_whisper_kit_tpu_torch.compat import whisper_lang_str_full
    from open_whisper_kit_tpu_torch.decode import stream as TS
    from open_whisper_kit_tpu_torch.decode.batch import transcribe_chunks_with_timings
    from open_whisper_kit_tpu_torch.server import http_server as H
    A, Q, MK = mods.A, mods.Q, mods.MK
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    srv = H.serve(str(q8_path), port=0, device="cuda", batch_window_ms=50,
                  diarize_model=str(gguf_path))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    state = srv.state
    groups = []
    run_group = state.batcher._run_group

    def recording(reqs):
        groups.append([r.audio for r in reqs])
        return run_group(reqs)
    state.batcher._run_group = recording
    try:
        check(state.device == torch.device("cuda", torch.cuda.current_device()),
              f"server device {state.device} is not the indexed card")
        tr = state.transcriber
        check(tr.ctx.mega_mode(greedy_params(FullParams)) == "all",
              "served q8_0 checkpoint: K2 is not switched on")
        wavs = [wav_bytes(audio(SERVE_SECS, s)) for s in SERVE_SEEDS]
        tmpwav = Path(q8_path).parent

        def decoded(data):
            (tmpwav / "a.wav").write_bytes(data)
            return load_wav(tmpwav / "a.wav")
        x0 = decoded(wavs[0])

        def direct(p, x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with state.lock:
                r = tr.full(p, x)
            torch.cuda.synchronize()
            return r, (time.perf_counter() - t0) * 1e3

        def via_http(fields):
            t0 = time.perf_counter()
            out = http_post(url + "/inference", *multipart({"temperature_inc": b"0", **fields}))
            return out, (time.perf_counter() - t0) * 1e3

        def written(res, writer, **kw):
            buf = __import__("io").StringIO()
            writer(res, buf, None, **kw)
            return buf.getvalue()

        # ---- one 30 s request in json, srt and verbose_json ----
        direct(handler_params(FullParams), x0)     # warm: K2's argument pack, first uses
        res, d_ms = direct(handler_params(FullParams), x0)
        walls = {}
        got, walls["json"] = via_http({"file": wavs[0], "response_format": b"json"})
        ok_json = json.loads(got) == {"text": written(res, O.write_txt)}
        got, walls["srt"] = via_http({"file": wavs[0], "response_format": b"srt"})
        ok_srt = got == written(res, O.write_srt)
        vres, v_ms = direct(handler_params(FullParams, token_timestamps=True), x0)
        got, walls["verbose_json"] = via_http({"file": wavs[0], "response_format": b"verbose_json"})
        vj = json.loads(got)
        eot = tr.ctx.vocab.token_eot
        ok_v = ([(s["text"], s["tokens"], s["start"], s["end"],
                  [(w["start"], w["end"]) for w in s["words"]]) for s in vj["segments"]]
                == [(s.text, [t.id for t in s.tokens if t.id < eot], s.t0 / 100.0, s.t1 / 100.0,
                     [(t.t0 / 100.0, t.t1 / 100.0) for t in s.tokens if t.id < eot])
                    for s in vres.segments])
        n_tok = sum(len(s.tokens) for s in res.segments)
        print(f"[28] /inference 30 s on q8_0 turbo: {len(res.segments)} segments, {n_tok} "
              f"tokens; json {walls['json']:.1f} ms, srt {walls['srt']:.1f} ms, verbose_json "
              f"{walls['verbose_json']:.1f} ms through HTTP against the direct Transcriber.full "
              f"{d_ms:.1f} ms (token timestamps {v_ms:.1f} ms); equal to the direct call: json "
              f"{ok_json}, srt {ok_srt}, verbose_json {ok_v} | {smi}", flush=True)
        check(ok_json and ok_srt and ok_v and n_tok > 0, "/inference differs from Transcriber.full")

        # ---- four concurrent 30 s requests through the batcher ----
        xs = [decoded(w) for w in wavs]
        groups.clear()          # the single requests above went through it too
        outs, errs = [None] * len(wavs), []
        barrier = threading.Barrier(len(wavs))

        def hit(i):
            try:
                barrier.wait()
                outs[i] = via_http({"file": wavs[i], "response_format": b"srt"})
            except Exception as e:  # noqa: BLE001
                errs.append(e)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(wavs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        conc_ms = (time.perf_counter() - t0) * 1e3
        check(not errs, f"concurrent /inference failed: {errs[:1]}")
        b = state.batcher
        want = {}
        d0 = time.perf_counter()
        for grp in groups:
            p = handler_params(FullParams)
            with state.lock:
                if len(grp) == 1:
                    rs = [tr.full(p, grp[0])]
                else:
                    segs, tms = transcribe_chunks_with_timings(tr.ctx, p, grp)
                    rs = [TF.TranscribeResult(segments=s, timings=t) for s, t in zip(segs, tms)]
            for x, r in zip(grp, rs):
                want[next(i for i, y in enumerate(xs) if np.array_equal(x, y))] = r
        torch.cuda.synchronize()
        dd_ms = (time.perf_counter() - d0) * 1e3
        same = [outs[i][0] == written(want[i], O.write_srt) for i in range(len(wavs))]
        print(f"[28] 4 concurrent 30 s /inference (srt, batch window 50 ms): batcher "
              f"n_dispatches {b.n_dispatches}, max_group {b.max_group}, groups "
              f"{[len(g) for g in groups]}; wall {conc_ms:.1f} ms through HTTP (each "
              f"{', '.join(f'{o[1]:.1f}' for o in outs)} ms) against {dd_ms:.1f} ms for the "
              f"direct transcribe_chunks_with_timings of the same groups; each equal to the "
              f"direct call {same} | {smi}", flush=True)
        check(all(same) and sorted(want) == list(range(len(wavs))),
              "batched /inference differs from the direct lockstep call")

        # ---- /detect-language ----
        t0 = time.perf_counter()
        dl = json.loads(http_post(url + "/detect-language", *multipart({"file": wavs[1]})))
        dl_ms = (time.perf_counter() - t0) * 1e3
        with state.lock:
            lid, probs = tr.detect_language(xs[1])
        print(f"[28] /detect-language: {dl['detected_language']} p {dl['probability']:.4f} in "
              f"{dl_ms:.1f} ms; direct {whisper_lang_str_full(lid)} p {float(probs[lid]):.4f}",
              flush=True)
        check(dl["detected_language"] == whisper_lang_str_full(lid)
              and abs(dl["probability"] - float(probs[lid])) <= 1e-6,
              "/detect-language differs from the direct call")

        # ---- a 60 s /stream session against an in-process StreamingTranscriber ----
        xs60 = audio(STREAM_SECS, 285)
        pcm = (np.clip(xs60, -1, 1) * 32767).astype("<i2")
        pieces = [pcm[i:i + STREAM_PIECE] for i in range(0, len(pcm), STREAM_PIECE)]
        sid = json.loads(http_post(url + "/stream/start", json.dumps(STREAM_CFG).encode(),
                                   "application/json"))["session"]
        got_ev = []
        t0 = time.perf_counter()
        for i, piece in enumerate(pieces):
            route = "finish" if i == len(pieces) - 1 else "feed"
            got_ev += json.loads(http_post(f"{url}/stream/{route}?session={sid}",
                                           piece.tobytes(), "application/octet-stream"))["events"]
        http_stream_ms = (time.perf_counter() - t0) * 1e3
        st = TS.StreamingTranscriber(tr.ctx, TS.StreamParams(
            step_ms=STREAM_CFG["step_ms"], length_ms=STREAM_CFG["length_ms"],
            keep_ms=STREAM_CFG["keep_ms"], no_fallback=True))
        reset_counts(A, Q, MK)
        want_ev, step_ms = [], []
        t_all = time.perf_counter()
        with state.lock:
            for i, piece in enumerate(pieces):
                n0 = st.n_iter
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want_ev += st.feed(piece.astype(np.float32) / 32768.0)
                torch.cuda.synchronize()
                if st.n_iter > n0:
                    step_ms.append((time.perf_counter() - t0) * 1e3)
            want_ev += st.flush()
        torch.cuda.synchronize()
        ip_stream_ms = (time.perf_counter() - t_all) * 1e3
        n_k1, n_k2 = A.mha_packed.launches, MK.mega_decode_step.launches
        same = got_ev == [{"text": e.text, "t0": e.t0, "t1": e.t1, "final": e.final,
                           "speaker_turn_next": e.speaker_turn_next} for e in want_ev]
        n_steps = st.n_iter
        print(f"[28] /stream 60 s in 0.5 s s16le pieces (step 3000, length 10000, keep 200): "
              f"{len(got_ev)} events, equal to the in-process StreamingTranscriber {same}; "
              f"{n_steps} steps (the flush included); ms per stream step median "
              f"{statistics.median(step_ms):.1f}, slowest {max(step_ms):.1f} (min "
              f"{min(step_ms):.1f}); stream wall over audio seconds: HTTP "
              f"{http_stream_ms / 1e3 / STREAM_SECS:.4f}, in process "
              f"{ip_stream_ms / 1e3 / STREAM_SECS:.4f}; per step K1 launches "
              f"{n_k1 / n_steps:.1f}, K2 launches {n_k2 / n_steps:.1f} | {smi}", flush=True)
        check(same and len(got_ev) > 0 and sid not in state.sessions,
              "/stream events differ from the in-process StreamingTranscriber")
        check(n_k1 == TURBO_LAYERS * n_steps and n_k2 > 0,
              f"stream steps: K1 {n_k1} / K2 {n_k2} launches for {n_steps} steps")

        # ---- stream steps at audio_ctx 768 (K1 at 768 positions, K2 at Ta 768) ----
        audio_ctx_steps(torch, tr, state, mods, smi)

        # ---- /diarize (offline) with phase 26's full-width SortFormer ----
        xd = audio(DIAR_SERVE_SECS, 287)
        wd = wav_bytes(xd)
        dz_ms = []
        for _ in range(2):      # the first request loads the SortFormer (lazily)
            t0 = time.perf_counter()
            got = json.loads(http_post(url + "/diarize", *multipart(
                {"file": wd, "preset": b"offline"})))
            dz_ms.append((time.perf_counter() - t0) * 1e3)
        with state.lock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, segs = state.diarizer.diarize(decoded(wd), stream_config="offline",
                                             file_id="audio")
            torch.cuda.synchronize()
        dd_ms = (time.perf_counter() - t0) * 1e3
        same = got == {"segments": [{"speaker": s.speaker, "start": s.start,
                                     "duration": s.duration} for s in segs]}
        print(f"[28] /diarize offline 30 s: {len(segs)} segments; through HTTP {dz_ms[0]:.1f} "
              f"ms (the model's load included), then {dz_ms[1]:.1f} ms, against the direct "
              f"Diarizer.diarize {dd_ms:.1f} ms; equal to it {same} | {smi}", flush=True)
        check(same, "/diarize differs from Diarizer.diarize")
    finally:
        srv.shutdown()
        srv.server_close()
        state.batcher._run_group = run_group
    print(f"[28] phase seconds {time.perf_counter() - t_phase:.1f} | {smi}", flush=True)


def phase_narrow_serving(torch, TF, FullParams, tmp, tokens) -> None:
    """Phase 29: narrow f32 streaming and whisper-cli on the card against
    the CPU (module docstring)."""
    import io
    import contextlib
    import numpy as np
    from open_whisper_kit_tpu_torch.cli import main as CLI
    from open_whisper_kit_tpu_torch.decode import stream as TS
    from open_whisper_kit_tpu_torch.io import ggml_writer as W
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    hp = W.WhisperHParams(*NARROW_Q, ftype=0, qntvr=0)
    path = tmp / "narrow-f32.bin"
    W.write_checkpoint(path, hp, TF._synthetic_mel_filters(80), tokens,
                       W.random_reference_tensors(hp, seed=0), wtype=W.TYPE_FOR_NAME["f32"])
    speech = np.zeros(16000 * 14, np.float32)
    rng = np.random.default_rng(29)
    for a, b in ((0.5, 3.0), (5.0, 7.5), (10.5, 13.5)):
        speech[int(a * 16000):int(b * 16000)] = rng.standard_normal(
            int(b * 16000) - int(a * 16000)) * 0.3
    cases = (("step mode, keep_context", audio(20.0, 3),
              dict(step_ms=3000, length_ms=10000, keep_ms=200, no_context=False)),
             (f"step mode, audio_ctx {AUDIO_CTX}", audio(20.0, 3),
              dict(step_ms=3000, length_ms=10000, keep_ms=200, audio_ctx=AUDIO_CTX)),
             ("VAD mode", speech, dict(step_ms=0, length_ms=5000)))
    for what, x, kw in cases:
        ev = {}
        for dev in ("cuda", "cpu"):
            c = TF.WhisperContext.from_file(path, dtype=torch.float32, device=dev)
            st = TS.StreamingTranscriber(c, TS.StreamParams(no_fallback=True, **kw))
            out = []
            for i in range(0, len(x), 8000):
                out += st.feed(x[i:i + 8000])
            out += st.flush()
            ev[dev] = [(e.text, e.t0, e.t1, e.final, e.n_iter) for e in out]
        print(f"[29] narrow f32 StreamingTranscriber, {what}: {len(ev['cuda'])} events, "
              f"cuda == cpu {ev['cuda'] == ev['cpu']}", flush=True)
        check(ev["cuda"] == ev["cpu"] and ev["cpu"], f"narrow stream ({what}): cuda and cpu differ")
    wav = tmp / "narrow-cli.wav"
    wav.write_bytes(wav_bytes(audio(16.0, 1)))
    flags = ["-m", str(path), "-f", str(wav), "-nf", "--dtype", "f32", "-np",
             "-otxt", "-osrt", "-ovtt", "-ocsv", "-olrc", "-oj"]
    for tag, extra in (("cpu", ["-ng"]), ("cuda", [])):
        with contextlib.redirect_stdout(io.StringIO()):
            check(CLI.main(flags + ["-of", str(tmp / f"cli-{tag}")] + extra) == 0,
                  f"whisper-cli on {tag} failed")
    same = {}
    for ext in ("txt", "srt", "vtt", "csv", "lrc", "json"):
        a, b = ((tmp / f"cli-{tag}.{ext}").read_text() for tag in ("cuda", "cpu"))
        if ext == "json":
            ja, jb = json.loads(a), json.loads(b)
            ta, tb = ja["transcription"], jb["transcription"]
            same[ext] = (len(ta) == len(tb) and all(
                (u["timestamps"], u["offsets"], u["text"]) == (v["timestamps"], v["offsets"], v["text"])
                for u, v in zip(ta, tb)) and {k: v for k, v in ja.items() if k != "transcription"}
                == {k: v for k, v in jb.items() if k != "transcription"})
        else:
            same[ext] = a == b
    n_seg = (tmp / "cli-cpu.srt").read_text().count("-->")
    print(f"[29] whisper-cli (16 s, {n_seg} segments), card against -ng: files equal {same} "
          f"| phase seconds {time.perf_counter() - t_phase:.1f} | {smi}", flush=True)
    check(all(same.values()) and n_seg > 0, "whisper-cli: card and -ng files differ")


# ---- phases 30-35: the LLaMA runtime, talk, the language server, the examples ----

# published shapes: meta-llama/Llama-2-7b-hf and TinyLlama/TinyLlama-1.1B-Chat-v1.0
# config.json (hidden, layers, heads, kv heads, FF, vocabulary, context, rms eps,
# rope base)
LLAMA_CONFIGS = {
    "Llama-2-7B": dict(n_vocab=32000, n_ctx=4096, n_embd=4096, n_layer=32, n_head=32,
                       n_head_kv=32, n_ff=11008, rope_freq_base=10000.0, rms_eps=1e-5),
    "TinyLlama-1.1B": dict(n_vocab=32000, n_ctx=2048, n_embd=2048, n_layer=22, n_head=32,
                           n_head_kv=4, n_ff=5632, rope_freq_base=10000.0, rms_eps=1e-5),
}
LLAMA_CTX = 2048        # the LlamaContext window of the full-depth runs
LLAMA_PROMPT = 612      # ingested tokens: two chunks, 512 + 100
LLAMA_GEN = 128         # greedy tokens, in chunks of LLAMA_CHUNK
LLAMA_CHUNK = 16
LLAMA_TRACED = 4        # tokens of the traced chunk (the trace's tables take seconds)
LLAMA_F32_TOL = 1e-4    # card against CPU, f32, of max|logit|
LSP_WORDS = [b" up", b" down", b" left", b" right", b" stop", b" select", b" one",
             b" from", b" the", b" available", b" words", b":", b",", b".", b" Selected",
             b" word", b"up", b"down", b"left", b"right", b"stop"]
CHESS_WORDS = ([b" to", b"to", b" ", b" pawn", b" knight", b" bishop", b" rook", b" queen",
                b" king"] + [c.encode() for c in "abcdefgh12345678"])
LSP_COMMANDS = ["up", "down", "left", "right", "stop"]


def spm_vocab(n: int = 32000):
    """A SentencePiece vocabulary of `n` pieces built in the process: the
    three specials, the 256 byte pieces, then "▁" and every 1-3 letter
    string with and without "▁", scored so that longer merges win."""
    import itertools
    import string
    import numpy as np
    from open_whisper_kit_tpu_torch.models.llama import tokenizer as LT
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    ttype = [LT.ATTR_UNKNOWN, LT.ATTR_CONTROL, LT.ATTR_CONTROL] + [LT.ATTR_BYTE] * 256
    pieces = ["▁"]
    for length in (1, 2, 3):
        for s in itertools.product(string.ascii_lowercase, repeat=length):
            pieces += ["▁" + "".join(s), "".join(s)]
    pieces = pieces[:n - len(tokens)]
    scores = [0.0] * len(tokens) + [float(len(p)) for p in pieces]
    tokens += pieces
    ttype += [LT.ATTR_NORMAL] * len(pieces)
    return LT.LlamaVocab(model="llama", tokens=tokens, scores=np.asarray(scores, np.float32),
                         token_type=np.asarray(ttype, np.int32))


def llama_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from llama_leaves(v)
    else:
        yield tree


def phase_llama_full(torch, tag: str, name: str, vocab, smi: str) -> dict:
    """Phases 30 and 32: one configuration at full depth in bf16, random
    weights drawn on the card: 612 prompt tokens ingested (two chunks),
    then 128 greedy tokens in chunks of 16; ingest ms per token, ms per
    generated token, host reads per chunk, peak memory, the byte bound's
    share (every weight read once per token)."""
    import numpy as np
    from open_whisper_kit_tpu_torch.models.llama import model as LM
    cfg = LM.LlamaConfig(**LLAMA_CONFIGS[name])
    t0 = time.perf_counter()
    params = LM.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_par = sum(t.numel() for t in llama_leaves(params))
    wbytes = sum(t.numel() * t.element_size() for t in llama_leaves(params))
    torch.cuda.reset_peak_memory_stats()
    ctx = LM.LlamaContext(cfg=cfg, params=params, vocab=vocab, n_ctx=LLAMA_CTX, device="cuda")
    kv_bytes = 2 * ctx.kv_k.numel() * ctx.kv_k.element_size()
    prompt = np.random.default_rng(30).integers(259, cfg.n_vocab, LLAMA_PROMPT).tolist()
    greedy = LM.SampleParams(temp=0.0)
    # warm-up: both ingest shapes and one chunk (allocator, cuBLAS handles)
    ctx.eval_tokens(prompt)
    ctx.generate([prompt[0]], greedy, max_tokens=LLAMA_CHUNK, chunk=LLAMA_CHUNK)
    ctx.reset()
    torch.cuda.synchronize()
    reads0 = ctx.reads.n
    t0 = time.perf_counter()
    logits = ctx.eval_tokens(prompt)        # its host read waits for the card
    t_ing = time.perf_counter() - t0
    check(logits.shape == (cfg.n_vocab,) and bool(np.isfinite(logits).all()),
          f"{name}: ingest logits malformed")
    t0 = time.perf_counter()
    text = ctx.generate([int(np.argmax(logits))], greedy, max_tokens=LLAMA_GEN,
                        chunk=LLAMA_CHUNK)
    t_gen = time.perf_counter() - t0
    n_gen = ctx.n_past - LLAMA_PROMPT
    chunks = -(-n_gen // LLAMA_CHUNK)
    reads = ctx.reads.n - reads0
    peak = torch.cuda.max_memory_allocated()
    ms_tok = t_gen / n_gen * 1e3
    bound_ms = wbytes / HBM_BYTES_PER_S * 1e3
    print(f"[{tag}] {name} ({n_par / 1e9:.3f} G parameters, bf16 {wbytes / 1e9:.2f} GB, KV at "
          f"n_ctx {LLAMA_CTX} {kv_bytes / 1e9:.2f} GB; drawn on the card in {t_init:.2f} s): "
          f"ingest {LLAMA_PROMPT} tokens {t_ing * 1e3:.1f} ms ({t_ing * 1e3 / LLAMA_PROMPT:.3f} "
          f"ms per token); {n_gen} greedy tokens in {chunks} chunks of {LLAMA_CHUNK}: "
          f"{t_gen * 1e3:.1f} ms, {ms_tok:.3f} ms per token; host reads {reads} (1 ingest + "
          f"{(reads - 1) / max(chunks, 1):.2f} per chunk); peak memory {peak / 1e9:.2f} GB; "
          f"byte bound {bound_ms:.3f} ms per token, {100 * bound_ms / ms_tok:.1f} % of it "
          f"reached; {len(text)} characters | {smi}", flush=True)
    check(n_gen == LLAMA_GEN and reads == 1 + chunks,
          f"{name}: {n_gen} tokens, {reads} host reads (want {LLAMA_GEN}, 1 + {chunks})")
    # a chunk of LLAMA_TRACED tokens under torch.profiler: the device's busy
    # share and its launches per token (chiprun_out/profile-llama-<tag>.txt)
    profile_call(torch, f"llama-{tag}", f"{name}, one chunk of {LLAMA_TRACED} greedy tokens",
                 lambda: ctx.generate([0], greedy, max_tokens=LLAMA_TRACED,
                                      chunk=LLAMA_TRACED) and [])
    del ctx, params
    torch.cuda.empty_cache()
    return {"ingest_ms_per_token": t_ing * 1e3 / LLAMA_PROMPT, "ms_per_token": ms_tok,
            "bound_ms": bound_ms, "peak_gb": peak / 1e9}


def llama_greedy_steps(torch, LM, cfg, params, prompt, steps: int, device: str):
    """Host-stepped greedy decoding through forward: (ids, logits rows)."""
    kk, kv = LM.init_kv_cache(cfg, 1, len(prompt) + steps + 1, torch.float32, device=device)
    logits, kk, kv = LM.forward(cfg, params, torch.tensor([prompt], device=device), kk, kv, 0)
    ids, rows = [], [logits[0].cpu()]
    for i in range(steps):
        ids.append(int(rows[-1].argmax()))
        logits, kk, kv = LM.forward(cfg, params, torch.tensor([[ids[-1]]], device=device),
                                    kk, kv, len(prompt) + i)
        rows.append(logits[0].cpu())
    return ids, rows


def phase_llama_card_vs_cpu(torch, vocab, smi: str) -> None:
    """Phase 31: Llama-2-7B's width at two layers in f32 (TF32 off), the
    same CPU-drawn weights on the card and the CPU: greedy ids equal and
    every step's logits within LLAMA_F32_TOL of max|logit| (first_parting
    names a parting; it passes only as a near tie, where the CPU's top-two
    gap is within twice the row's card-CPU difference); LlamaContext.
    generate's greedy text equal; a seeded sampled reply the same twice on
    the card."""
    import numpy as np
    from open_whisper_kit_tpu_torch.decode.full import _to_device
    from open_whisper_kit_tpu_torch.models.llama import model as LM
    t_phase = time.perf_counter()
    cfg = LM.LlamaConfig(**dict(LLAMA_CONFIGS["Llama-2-7B"], n_layer=2))
    cpu = LM.init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    card = _to_device(cpu, torch.device("cuda"))
    prompt = np.random.default_rng(31).integers(259, cfg.n_vocab, 48).tolist()
    out = {dev: llama_greedy_steps(torch, LM, cfg, p, prompt, 24, dev)
           for dev, p in (("cuda", card), ("cpu", cpu))}
    (gi, gr), (ci, cr) = out["cuda"], out["cpu"]
    # first_parting's records: each step's two best logits, their ids, the row
    records = {dev: [(*r[None].topk(2), r[None]) for r in rows] for dev, (_, rows) in out.items()}
    part = first_parting(records["cuda"], records["cpu"])
    n_cmp = len(gr) if part is None else part[0] + 1
    errs = [((g - c).abs().max() / c.abs().max()).item() for g, c in zip(gr[:n_cmp], cr[:n_cmp])]
    print(f"[31] Llama-2-7B width, 2 layers, f32 (TF32 off), 48-token prompt + 24 greedy "
          f"steps: ids equal {gi == ci}, first parting (step, row, CPU top-two gap, "
          f"max|logit|, max|card - cpu|) {part}, max|logits card - cpu| / max|cpu| "
          f"{max(errs):.3e} over {n_cmp} rows (gate {LLAMA_F32_TOL})", flush=True)
    check(max(errs) <= LLAMA_F32_TOL, "llama f32: card and cpu logits differ")
    check(part is None or part[2] <= 2 * part[4],
          f"llama f32: ids part at step {part[0] if part else None}, not a near tie")
    texts = {}
    for dev, p in (("cuda", card), ("cpu", cpu)):
        ctx = LM.LlamaContext(cfg=cfg, params=p, vocab=vocab, n_ctx=128, dtype=torch.float32,
                              device=dev)
        texts[dev] = (ctx.generate(prompt, LM.SampleParams(temp=0.0), max_tokens=32,
                                   chunk=LLAMA_CHUNK), ctx.n_past, ctx.reads.n)
    sampled = []
    ctx = LM.LlamaContext(cfg=cfg, params=card, vocab=vocab, n_ctx=128, dtype=torch.float32,
                          device="cuda")
    for _ in range(2):
        ctx.reset()
        sampled.append(ctx.generate(prompt, LM.SampleParams(temp=0.8, top_k=40, top_p=0.95,
                                                            min_p=0.05),
                                    max_tokens=32, seed=7, chunk=LLAMA_CHUNK))
    print(f"[31] LlamaContext.generate greedy (32 tokens, chunk {LLAMA_CHUNK}): card == cpu "
          f"{texts['cuda'] == texts['cpu']} (n_past {texts['cuda'][1]}, host reads "
          f"{texts['cuda'][2]}); seeded sampled reply the same twice on the card "
          f"{sampled[0] == sampled[1]} | phase seconds {time.perf_counter() - t_phase:.1f} "
          f"| {smi}", flush=True)
    check(texts["cuda"] == texts["cpu"] or part is not None, "llama generate: card and cpu differ")
    check(sampled[0] == sampled[1] and sampled[0], "llama sampled reply not reproducible")
    del card, cpu, ctx
    torch.cuda.empty_cache()


class NoFallback:
    """whisper_full with temperature_inc 0: the sampled fallback draws from
    torch's generator, whose streams differ between the card and the CPU."""

    def __init__(self, TF):
        self.TF = TF

    def __enter__(self):
        self.f = f = self.TF.whisper_full

        def run(ctx, p, *a, **kw):
            p.temperature_inc = 0.0
            return f(ctx, p, *a, **kw)
        self.TF.whisper_full = run
        return self

    def __exit__(self, *exc):
        self.TF.whisper_full = self.f


def speech_wav(path, seconds: float, seed: int, spans) -> Path:
    """A WAV of speech-like noise over `spans` and silence elsewhere."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = np.zeros(int(16000 * seconds), np.float32)
    for a, b in spans:
        x[int(a * 16000):int(b * 16000)] = rng.standard_normal(
            int(b * 16000) - int(a * 16000)) * 0.3
    path.write_bytes(wav_bytes(x))
    return path


def kernel_counts(A, Q, MK) -> dict:
    return {"K1": A.mha_packed.launches, "K2": MK.mega_decode_step.launches,
            "K3": dict(Q.qmm.launches_by_route), "K5": Q.ffn_int8.launches}


def phase_talk(torch, TF, mods, q8_path, tmp, vocab, smi: str):
    """Phase 33: examples/talk's chat loop on the q8_0 turbo checkpoint
    (K2 auto) with TinyLlama-1.1B (random bf16 weights drawn on the card):
    a seeded 3 s utterance -> transcript -> a greedy reply of at most 32
    tokens with the antiprompt "Georgi:"; the session snapshot saved, then
    restored for the same turn, whose reply must be the same. Returns the
    whisper context for phase 34."""
    import contextlib
    import io
    import numpy as np
    from open_whisper_kit_tpu_torch.examples import talk as TALK
    from open_whisper_kit_tpu_torch.models.llama import model as LM
    t_phase = time.perf_counter()
    ctx_w = TF.WhisperContext.from_file(q8_path, dtype=torch.bfloat16, device="cuda")
    cfg = LM.LlamaConfig(**LLAMA_CONFIGS["TinyLlama-1.1B"])
    lctx = LM.LlamaContext(cfg=cfg, params=LM.init_params(cfg, seed=0, device="cuda"),
                           vocab=vocab, n_ctx=LLAMA_CTX, device="cuda")
    wav = speech_wav(tmp / "talk.wav", 3.0, 33, [(0.3, 2.7)])
    session = tmp / "talk-session.npz"
    args = TALK.build_parser().parse_args(
        ["-mw", str(q8_path), "-ml", "in-process", "--input-wav", str(wav), "--temp", "0",
         "--reply-tokens", "32", "--max-turns", "1", "--session", str(session)])
    outs, walls = [], []
    for turn in range(2):
        reset_counts(mods.A, mods.Q, mods.MK)
        reads0 = lctx.reads.n
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as o:
            check(TALK.chat(args, ctx_w, lctx) == 0, "talk: chat failed")
        walls.append(time.perf_counter() - t0)
        outs.append(o.getvalue())
        counts = kernel_counts(mods.A, mods.Q, mods.MK)
        heard, _, reply = outs[-1].partition("\nLLaMA:")
        print(f"[33] talk turn {turn} ({'restored' if turn else 'saved'} the session): "
              f"{walls[-1] * 1e3:.1f} ms, heard {heard.split(':', 1)[-1].strip()[:60]!r}, reply "
              f"{len(reply.strip())} characters, llama n_past {lctx.n_past}, host reads "
              f"{lctx.reads.n - reads0}; launches {counts}", flush=True)
        check(counts["K1"] == TURBO_LAYERS * (counts["K1"] // TURBO_LAYERS) and counts["K1"] > 0
              and counts["K2"] > 0 and counts["K3"]["tiles"] > 0,
              "talk: the transcription did not run K1, K2 and K3")
    check(session.exists() and outs[0] == outs[1] and "\nLLaMA:" in outs[0],
          "talk: the restored session's reply differs, or no reply")
    snap = np.load(session)
    print(f"[33] talk session {session.stat().st_size / 1e6:.1f} MB (kv f32 "
          f"{tuple(snap['kv_k'].shape)}), replies equal | phase seconds "
          f"{time.perf_counter() - t_phase:.1f} | {smi}", flush=True)
    del lctx
    torch.cuda.empty_cache()
    return ctx_w


def lsp_round(srv, seconds_seed_guided, seconds_seed_unguided):
    """registerCommandset, then guided and unguided requests: the responses."""
    import base64
    from open_whisper_kit_tpu_torch.cli import lsp as LSP

    def b64(x):
        return base64.b64encode(x.tobytes()).decode()
    out = [srv.handle({"jsonrpc": "2.0", "method": "registerCommandset",
                       "params": LSP_COMMANDS, "id": 1})]
    for i, (secs, seed) in enumerate(seconds_seed_guided):
        out.append(srv.handle({"jsonrpc": "2.0", "method": "guided", "id": 10 + i,
                               "params": {"audio_b64": b64(audio(secs, seed)),
                                          "commandset_index": 0}}))
    for i, (secs, seed) in enumerate(seconds_seed_unguided):
        out.append(srv.handle({"jsonrpc": "2.0", "method": "unguided", "id": 20 + i,
                               "params": {"audio_b64": b64(audio(secs, seed))}}))
    return out


def phase_lsp(torch, TF, tok_mod, mods, ctx, tokens, smi: str) -> None:
    """Phase 34: the language server on the q8_0 turbo checkpoint (K2 auto),
    its vocabulary's strings from id 1000 on the commands' words:
    registerCommandset, then guided (one encoder pass, one decode_impl over
    the prompt) and unguided (whisper_full), each with its K1/K2/K3/K5
    launches and wall."""
    from open_whisper_kit_tpu_torch.cli import lsp as LSP
    words = list(tokens)
    words[1000:1000 + len(LSP_WORDS)] = LSP_WORDS
    ctx.vocab = tok_mod.build_vocab(words, ctx.cfg.n_vocab)
    ctx._mask_cache = {}
    srv = LSP.LspServer(ctx)
    lsp_round(srv, ((2.0, 34),), ())          # warm-up
    for method, guided, unguided in (("guided", ((2.0, 35),), ()),
                                     ("unguided", (), ((3.0, 36),))):
        reset_counts(mods.A, mods.Q, mods.MK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with NoFallback(TF):
            res = lsp_round(srv, guided, unguided)[1]
        wall = time.perf_counter() - t0
        counts = kernel_counts(mods.A, mods.Q, mods.MK)
        print(f"[34] lsp {method} on q8_0 turbo: {wall * 1e3:.1f} ms, result "
              f"{json.dumps(res.get('result'))[:80]}, launches {counts}", flush=True)
        check("result" in res, f"lsp {method}: {res}")
        check(counts["K1"] == TURBO_LAYERS and counts["K3"]["tiles"] > 0,
              f"lsp {method}: not one encoder pass on K1/K3")
        if method == "guided":
            check(counts["K5"] == 4 and counts["K2"] == 0,
                  "lsp guided: the prompt's decode_impl did not run K5 once a layer")
        else:
            check(counts["K2"] > 0, "lsp unguided: K2 did not run the token steps")
    print(f"[34] | {smi}", flush=True)


def write_tiny_llama_gguf(path, seed: int = 0):
    """A random-weight GGUF of tests/test_llama.py's TINY shapes (2 layers,
    width 64, 4 / 2 heads, 320 pieces) in llama.cpp's layout."""
    import numpy as np
    from open_whisper_kit_tpu_torch.io.gguf import GGUFWriter
    V, S, F, L, H, HKV = 320, 64, 128, 2, 4, 2
    rng = np.random.default_rng(seed)
    base = spm_vocab(V)
    w = GGUFWriter(path)
    w.add_string("general.architecture", "llama")
    for key, v in (("embedding_length", S), ("block_count", L), ("attention.head_count", H),
                   ("attention.head_count_kv", HKV), ("feed_forward_length", F),
                   ("context_length", 128), ("vocab_size", V)):
        w.add_uint32(f"llama.{key}", v)
    w.add_float32("llama.rope.freq_base", 10000.0)
    w.add_float32("llama.attention.layer_norm_rms_epsilon", 1e-5)
    w.add_string("tokenizer.ggml.model", "llama")
    w.add_array("tokenizer.ggml.tokens", base.tokens)
    w.add_array("tokenizer.ggml.scores", base.scores)
    w.add_array("tokenizer.ggml.token_type", base.token_type)
    w.add_uint32("tokenizer.ggml.bos_token_id", 1)
    w.add_uint32("tokenizer.ggml.eos_token_id", 2)
    w.add_bool("tokenizer.ggml.add_bos_token", True)

    def r(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32)
    kvd = HKV * (S // H)
    w.add_tensor("token_embd.weight", r(V, S))
    w.add_tensor("output_norm.weight", np.abs(r(S)) + 0.5)
    w.add_tensor("output.weight", r(V, S))
    for i in range(L):
        p = f"blk.{i}."
        for name, shape in (("attn_norm", None), ("attn_q", (S, S)), ("attn_k", (kvd, S)),
                            ("attn_v", (kvd, S)), ("attn_output", (S, S)),
                            ("ffn_norm", None), ("ffn_gate", (F, S)), ("ffn_up", (F, S)),
                            ("ffn_down", (S, F))):
            w.add_tensor(p + name + ".weight",
                         np.abs(r(S)) + 0.5 if shape is None else r(*shape))
    w.write()
    return path


def phase_narrow_examples(torch, TF, tmp, tokens, smi: str) -> None:
    """Phase 35: narrow f32 checkpoints (3 decoder layers) on the card
    against the CPU: the language server's responses (f32 contexts), and
    each example's `main` with -dev 0 against -ng (whisper in bf16 as the
    examples load it; a TINY llama GGUF; the TINY SortFormer): the same
    printed output. whisper_full runs with temperature_inc 0."""
    import contextlib
    import io
    from open_whisper_kit_tpu_torch.cli import lsp as LSP
    from open_whisper_kit_tpu_torch.examples import diarized_transcript as EX_D
    from open_whisper_kit_tpu_torch.examples import talk as EX_T
    from open_whisper_kit_tpu_torch.examples import voice_command as EX_V
    from open_whisper_kit_tpu_torch.examples import wchess as EX_W
    from open_whisper_kit_tpu_torch.io import ggml_writer as W
    from open_whisper_kit_tpu_torch.models.sortformer import export as SE
    from open_whisper_kit_tpu_torch.models.sortformer import model as SM
    t_phase = time.perf_counter()
    hp = W.WhisperHParams(*NARROW_Q, ftype=0, qntvr=0)
    tensors = W.random_reference_tensors(hp, seed=0)
    words = list(tokens)
    words[1000:1000 + len(LSP_WORDS + CHESS_WORDS)] = LSP_WORDS + CHESS_WORDS
    path = tmp / "narrow-words.bin"
    W.write_checkpoint(path, hp, TF._synthetic_mel_filters(80), words, tensors,
                       wtype=W.TYPE_FOR_NAME["f32"])
    # the grammar requests' copy: the other strings empty (never a grammar
    # automaton's candidates, which keeps its build short) and their
    # embedding rows zero (a logit of 0, below the best named token's)
    named = 1000 + len(LSP_WORDS + CHESS_WORDS)
    te = tensors["decoder.token_embedding.weight"].copy()
    te[named:50256] = 0.0
    grammar = tmp / "narrow-grammar.bin"
    W.write_checkpoint(grammar, hp, TF._synthetic_mel_filters(80),
                       words[:named] + [b""] * (len(words) - named),
                       dict(tensors, **{"decoder.token_embedding.weight": te}),
                       wtype=W.TYPE_FOR_NAME["f32"])
    resp = {}
    with NoFallback(TF):
        for dev in ("cuda", "cpu"):
            ctx = TF.WhisperContext.from_file(path, dtype=torch.float32, device=dev)
            resp[dev] = lsp_round(LSP.LspServer(ctx), ((2.0, 0), (2.0, 1), (2.0, 2)),
                                  ((3.0, 0), (6.0, 4)))
    print(f"[35] narrow f32 language server (registerCommandset, 3 guided, 2 unguided): "
          f"card == cpu {resp['cuda'] == resp['cpu']}", flush=True)
    check(resp["cuda"] == resp["cpu"] and all("result" in r for r in resp["cpu"]),
          "narrow lsp: card and cpu responses differ")
    llama = write_tiny_llama_gguf(tmp / "tiny-llama.gguf")
    sf_cfg = SM.SortformerConfig(n_mels=32, d_model=32, n_layers=2, n_heads=4, conv_kernel=5,
                                 ff_expansion=2, subsampling_channels=8, tf_layers=2,
                                 tf_d_model=16, tf_heads=4, tf_ff=32)
    sortformer = SE.write_sortformer_gguf(tmp / "tiny-sortformer.gguf", sf_cfg,
                                          SM.init_params(sf_cfg, seed=0, device="cpu"))
    prompt = tmp / "talk-prompt.txt"
    prompt.write_text("{0} talks to {1}.\n{0}{4} hello\n{1}{4} hello\n{0}{4}")
    meeting = tmp / "meeting.wav"
    meeting.write_bytes(wav_bytes(audio(12.0, 2)))
    runs = {
        "talk": (EX_T.main, ["-mw", str(path), "-ml", str(llama), "--input-wav",
                             str(speech_wav(tmp / "q.wav", 3.0, 0, [(0.0, 3.0)])),
                             "--temp", "0", "--reply-tokens", "6", "--max-turns", "1",
                             "--prompt-file", str(prompt)]),
        "voice_command (commands)": (EX_V.main, [
            "-m", str(grammar), "--commands", "up,down,left,right", "--input-wav",
            str(speech_wav(tmp / "cmd.wav", 2.0, 1, [(0.0, 2.0)]))]),
        "voice_command (stream)": (EX_V.main, [
            "-m", str(path), "--input-wav",
            str(speech_wav(tmp / "vad.wav", 4.0, 3, [(0.5, 2.5)]))]),
        "wchess": (EX_W.main, ["-m", str(grammar), "--audio",
                               str(speech_wav(tmp / "m1.wav", 2.0, 5, [(0.0, 2.0)]))]),
        "diarized_transcript": (EX_D.main, [str(meeting), "-m", str(path), "-dm",
                                            str(sortformer), "--preset", "low_latency"]),
    }
    with NoFallback(TF):
        for name, (main, args) in runs.items():
            out = {}
            t0 = time.perf_counter()
            for dev, flag in (("cuda", ["-dev", "0"]), ("cpu", ["-ng"])):
                with contextlib.redirect_stdout(io.StringIO()) as o:
                    check(main(args + flag) == 0, f"{name} on {dev} failed")
                out[dev] = o.getvalue()
            print(f"[35] {name}: card == -ng {out['cuda'] == out['cpu']} "
                  f"({len(out['cpu'])} characters, {time.perf_counter() - t0:.1f} s)",
                  flush=True)
            check(out["cuda"] == out["cpu"] and out["cpu"], f"{name}: card and -ng differ")
    print(f"[35] phase seconds {time.perf_counter() - t_phase:.1f} | {smi}", flush=True)


# the tensor-core probe's two products (tools/bench_int8_mxu.py): x @ W1 and
# h @ W2 of large-v3-turbo's encoder MLP, M = 1536 rows (one window, padded)
MXU_SHAPES = (("x @ W1", 1536, 1280, 5120), ("h @ W2", 1536, 5120, 1280))
# T2 also at the encoder's 8-window MLP products (the 128 x 256 tile)
MXU_S8_WIDE = (("mlp0, 8 windows", 12288, 1280, 5120), ("mlp1, 8 windows", 12288, 5120, 1280))


def phase_mxu(torch, G, P, profiling: bool = False) -> dict:
    """T1 (mm_bf16) and T2 (mm_s8) against their plain versions at the
    probe's two products, on the probe's own operands (X0 and W1; the gelu
    of their product, rounded to bf16, and W2; T2 on their quant_rows /
    quant_cols planes): T1 within one bf16 ulp of every element, plus what
    two f32 sums of the same K products can differ by in another order,
    with at most 1 % of the values differing and 0.1 % by more than one
    ulp (G.mm_bf16_within); T2 bit for bit. Times with the L2 cache flushed before each
    launch, queued behind a spin (device time): the kernel, the plain
    version, the library call (T1: cuBLAS bf16 through torch.mm with f32
    out; T2: torch._int_mm with the same scale ops, first checked equal to
    the plain version) and the bound. Then the port's probe, main(), at
    full shape: every chain call of T1 and T2 launches its kernel exactly
    twice per iteration (two warm calls and the timed repeats), and each
    chain's row is finite. With `profiling`, one call of each of the four
    chains under torch.profiler (profile_call). Returns {"mm_bf16": rows,
    "mm_s8": rows, "launches": {...}, "probe": rows}."""
    import torch.nn.functional as F
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    x0, w1, w2 = P.operands(P.M, P.K, P.F_, "cuda")
    h = F.gelu(G.mm_bf16_plain(x0, w1).float(), approximate="tanh").to(torch.bfloat16)
    rows = {"mm_bf16": [], "mm_s8": []}
    for (label, M, K, N), a, b in zip(MXU_SHAPES, (x0, h), (w1, w2)):
        check(tuple(a.shape) == (M, K) and tuple(b.shape) == (K, N), f"{label}: operands")
        shape = f"{label}: ({M},{K})@({K},{N})"
        # ---- T1 ----
        ref = G.mm_bf16_plain(a, b)
        got = G.mm_bf16(a, b)
        torch.cuda.synchronize()
        r = G.mm_bf16_within(got, ref, a, b)
        err = r["max_abs_err"]
        print(f"[23] T1 {shape}: max|err| {err:.3e} (max|ref| "
              f"{ref.float().abs().max().item():.3e}); {r['differing']} of {r['n']} values "
              f"differ (limit {G.MM_BF16_MAX_DIFFERING:.0%}), {r['past_ulp']} by more than "
              f"one bf16 ulp (limit {G.MM_BF16_MAX_PAST_ULP:.1%}), {r['past_bound']} past "
              f"the ulp plus the f32 order bound (limit 0)", flush=True)
        check(got.shape == ref.shape and r["ok"],
              f"T1 {shape}: beyond its gate against the plain version: {r}")
        k_ms = cuda_ms(torch, lambda: G.mm_bf16(a, b), flush=l2_flush, queued=True)
        p_ms = cuda_ms(torch, lambda: G.mm_bf16_plain(a, b), flush=l2_flush, queued=True)
        l_ms = cuda_ms(torch, lambda: torch.mm(a, b, out_dtype=torch.float32),
                       flush=l2_flush, queued=True)
        b_ms, b_by = bound(nbytes(a, b, got), 2 * M * K * N)
        share = 2 * M * K * N / (k_ms * 1e-3) / P.BF16_PEAK
        plan = G.mm_bf16_plan(M, N, torch.cuda.get_device_properties(0).multi_processor_count)
        rows["mm_bf16"].append({"shape": shape, "max_abs_err": err, "values_differing":
                                r["differing"], "values_past_one_ulp": r["past_ulp"], "ms": k_ms,
                                "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "bf16_peak_share": share,
                                "library_bf16_peak_share": share * k_ms / l_ms})
        print(f"[23]   T1 kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, cuBLAS bf16 "
              f"(torch.mm, f32 out) {l_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}); "
              f"{2 * M * K * N / k_ms / 1e9:.1f} TFLOP/s, {100 * share:.1f} % of the bf16 peak "
              f"(cuBLAS {100 * share * k_ms / l_ms:.1f} %), kernel / cuBLAS {k_ms / l_ms:.2f}; "
              f"{plan}", flush=True)
        del ref, got
        # ---- T2 ----
        aq, a_s = P.quant_rows(a)
        bq, b_s = P.quant_cols(b)
        bq_t = bq.t().contiguous()
        ref = G.mm_s8_plain(aq, a_s, bq_t, b_s)
        got = G.mm_s8(aq, a_s, bq_t, b_s)
        torch.cuda.synchronize()
        n_diff = int((got.float() != ref.float()).sum())
        err = (got.float() - ref.float()).abs().max().item()
        print(f"[23] T2 {shape}: {n_diff} of {got.numel()} values differ from the plain "
              f"version (max|err| {err:.3e})", flush=True)
        check(got.shape == ref.shape and n_diff == 0,
              f"T2 {shape}: {n_diff} values differ from the plain version")

        def int_mm():
            return ((torch._int_mm(aq, bq_t.t()).float() * a_s) * b_s).to(torch.bfloat16)
        check(torch.equal(int_mm(), ref), f"T2 {shape}: the _int_mm yardstick differs")
        k_ms = cuda_ms(torch, lambda: G.mm_s8(aq, a_s, bq_t, b_s), flush=l2_flush,
                       queued=True)
        p_ms = cuda_ms(torch, lambda: G.mm_s8_plain(aq, a_s, bq_t, b_s), flush=l2_flush,
                       queued=True)
        l_ms = cuda_ms(torch, int_mm, flush=l2_flush, queued=True)
        b_ms, b_by = bound(nbytes(aq, a_s, bq_t, b_s, got), 2 * M * K * N, "int8")
        rows["mm_s8"].append({"shape": shape, "max_abs_err": err, "values_differing": n_diff,
                              "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                              "bound_ms": b_ms, "bound_by": b_by})
        print(f"[23]   T2 kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, _int_mm + "
              f"scale ops {l_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}); "
              f"{2 * M * K * N / k_ms / 1e9:.1f} TOP/s (median of 20, cold L2, device time)",
              flush=True)
        del aq, a_s, bq, bq_t, ref, got
    del x0, w1, w2, h
    # T2 at the 8-window encoder products, seeded operands, bit for bit
    g = torch.Generator(device="cuda").manual_seed(23)
    for label, M, K, N in MXU_S8_WIDE:
        shape = f"{label}: ({M},{K})@({K},{N})"
        aq, a_s = P.quant_rows(torch.randn(M, K, generator=g, device="cuda")
                               .to(torch.bfloat16))
        bq, b_s = P.quant_cols(torch.randn(K, N, generator=g, device="cuda") * K ** -0.5)
        bq_t = bq.t().contiguous()
        ref = G.mm_s8_plain(aq, a_s, bq_t, b_s)
        got = G.mm_s8(aq, a_s, bq_t, b_s)
        torch.cuda.synchronize()
        n_diff = int((got.float() != ref.float()).sum())
        check(got.shape == ref.shape and n_diff == 0,
              f"T2 {shape}: {n_diff} values differ from the plain version")
        k_ms = cuda_ms(torch, lambda: G.mm_s8(aq, a_s, bq_t, b_s), flush=l2_flush,
                       queued=True)
        b_ms, b_by = bound(nbytes(aq, a_s, bq_t, b_s, got), 2 * M * K * N, "int8")
        rows["mm_s8"].append({"shape": shape, "max_abs_err": 0.0, "values_differing": 0,
                              "ms": k_ms, "plain_ms": None, "library_ms": None,
                              "bound_ms": b_ms, "bound_by": b_by})
        print(f"[23] T2 {shape}: bit-equal to the plain version; kernel {k_ms * 1e3:.1f} us, "
              f"bound {b_ms * 1e3:.1f} us ({b_by}), {100 * b_ms / k_ms:.1f} % of the bound",
              flush=True)
        del aq, a_s, bq, bq_t, ref, got
    del l2_flush
    torch.cuda.empty_cache()

    # ---- the probe, the main path of T1 and T2 ----
    G.mm_bf16.launches = G.mm_s8.launches = 0
    probe = P.main([])
    torch.cuda.synchronize()
    launches = {"mm_bf16": G.mm_bf16.launches, "mm_s8": G.mm_s8.launches}
    want = 2 * P.NITER * (2 + P.REPEATS)
    print(f"[23] probe main(): {len(probe)} rows; launches T1 {launches['mm_bf16']}, T2 "
          f"{launches['mm_s8']} (predicted {want} each: 2 x {P.NITER} iterations x "
          f"{2 + P.REPEATS} chain calls)", flush=True)
    check(launches["mm_bf16"] == launches["mm_s8"] == want,
          "probe: T1/T2 launch counts off prediction")
    check(len(probe) == 4
          and all(r["us_per_iter"] > 0 and 0 < r["peak_share"] < 1 for r in probe),
          "probe: malformed rows")
    if profiling:
        x0, w1, w2 = P.operands(P.M, P.K, P.F_, "cuda")
        (w1q, w1s), (w2q, w2s) = P.quant_cols(w1), P.quant_cols(w2)
        w1q_cm, w2q_cm = (w.t().contiguous().t() for w in (w1q, w2q))
        for tag, step, ws in (
                ("bf16", P.step_bf16, (w1, w2)),
                ("w8a8", P.step_xla_s8, (w1q_cm, w1s, w2q_cm, w2s)),
                ("T1", P.make_step_pallas_bf16(w1, w2), ()),
                ("T2", P.make_step_pallas_s8(w1q, w1s, w2q, w2s), ())):
            loop = P.chain(step)
            loop(x0, *ws)
            profile_call(torch, f"probe-{tag}", f"probe chain {tag}, {P.NITER} iterations",
                         lambda: (loop(x0, *ws), [])[1])
    return {**rows, "launches": launches, "probe": probe}


def profile_request(torch, tr, FullParams, secs, seed, tag, beam_size=0) -> None:
    """One request (greedy, or beam search with `beam_size`) under
    torch.profiler (profile_call)."""
    profile_call(torch, tag, f"{secs:.0f} s {f'beam {beam_size}' if beam_size else 'greedy'}",
                 lambda: [tr.transcribe(audio(secs, seed),
                                        request_params(FullParams, beam_size=beam_size))])


def profile_call(torch, tag, label, run) -> None:
    """`run()` (a list of TranscribeResults, or none) under torch.profiler: device
    busy share (the sum of kernel self times over the wall time) and the
    kernels that take it; the full table goes to
    chiprun_out/profile-<tag>.txt."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        results = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)
    # device rows (kernels, copies) have no host time of their own; an aten
    # op's row repeats the time of the kernels it launched
    kern = sorted((e for e in rows if e.self_cpu_time_total == 0 and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kern) / 1e3
    n_tok = sum(r.timings.n_sample for r in results)
    print(f"[profile {tag}] {label}, traced: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f} %), "
          + (f"sampled tokens {n_tok}, " if results else "")
          + f"device launches {sum(e.count for e in kern)}; top: "
          + "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.1f} ms x{e.count}"
                      for e in kern[:6]), flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    sort = "self_device_time_total" if hasattr(kern[0], "self_device_time_total") \
        else "self_cuda_time_total"
    (out / f"profile-{tag}.txt").write_text(rows.table(sort_by=sort, row_limit=40))


def reset_counts(A, Q, MK, E8=None, XQ=None) -> None:
    A.mha_packed.launches = MK.mega_decode_step.launches = 0
    MK.mega_decode_step.launches_by_rows.clear()
    MK.mega_decode_step_beam.launches = MK.mega_decode_step_batch.launches = 0
    Q.qmm.launches = Q.qmm4.launches = Q.ffn_int8.launches = 0
    Q.qmm.launches_by_route.update(rows=0, tiles=0)
    Q.qmm4.launches_by_route.update(rows=0, tiles=0)
    if E8 is not None:
        E8.w8a8_mm.launches = 0
    if XQ is not None:
        XQ.cross_attention_q8.launches = XQ.cross_attention_q8_nat.launches = 0


def check_k3_routes(Q, calls, what) -> None:
    """K3's launches by route in a q8_0 request: every encoder pass (32
    layers x 6 linears + 4 cross K/V, M = 1500 or 1536) and every decoder
    call over more than QMM_ROWS_MAX rows (4 layers x qkv/o/cq/co) on the
    tiles; the decoder's calls over fewer rows on the rows route."""
    big = sum(m > Q.QMM_ROWS_MAX for m in calls.dec_rows)
    want = {"rows": 16 * (calls.dec - big), "tiles": (TURBO_LAYERS * 6 + 4 * 2) * calls.enc
            + 16 * big}
    got = dict(Q.qmm.launches_by_route)
    print(f"[6] {what}: K3 launches by route {got} (predicted {want})", flush=True)
    check(got == want, f"{what}: K3 route counts {got} != {want}")


def request_params(FullParams, greedy=True, megakernel=None, beam_size=0):
    """FullParams of a request: temperature_inc = 0 when `greedy` (the
    device loops alone), beam search when `beam_size`."""
    p = greedy_params(FullParams) if greedy else FullParams(print_progress=False)
    p.megakernel = megakernel
    if beam_size:
        from open_whisper_kit_tpu_torch.decode.params import BeamSearchParams, SamplingStrategy
        p = dataclasses.replace(p, strategy=SamplingStrategy.BEAM_SEARCH,
                                beam_search=BeamSearchParams(beam_size=beam_size))
    return p


def serve(torch, tr, FullParams, secs, seed, tag, greedy=True, megakernel=None,
          beam_size=0):
    p = request_params(FullParams, greedy, megakernel, beam_size)
    t0 = time.perf_counter()
    res = tr.transcribe(audio(secs, seed), p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tm = res.timings
    n_tok = sum(len(s.tokens) for s in res.segments)
    print(f"[{tag}] {secs:.0f} s audio, {f'beam {beam_size}' if beam_size else 'greedy'}, "
          f"megakernel={megakernel!r} (mode "
          f"{tr.ctx.mega_mode(p)}): encoder passes {tm.n_encode}, sampled tokens "
          f"{tm.n_sample}, emitted tokens {n_tok}, segments {len(res.segments)}, wall "
          f"{wall:.3f} s, RTF {wall / secs:.4f}, {wall * 1e3 / max(tm.n_sample, 1):.2f} ms "
          "per sampled token", flush=True)
    # random weights may close a window's last segment at seek + seek_delta
    # before its opening timestamp (whisper.cpp's rule), so t0 <= t1 is not
    # asked; ids, probabilities, text and non-negative times are
    n_vocab = tr.ctx.cfg.n_vocab
    bad = [(s.t0, s.t1, s.text, [(t.id, t.p) for t in s.tokens][:4])
           for s in res.segments
           if not (s.t0 >= 0 and s.t1 >= 0 and s.text and s.tokens and all(
               0 <= t.id < n_vocab and 0.0 <= t.p <= 1.0 for t in s.tokens))]
    check(n_tok > 0 and not bad, f"malformed segment: {bad[:2]}")
    return res


# ---- 36. multi-GPU serving on one card ------------------------------------------

MESH_STEP_HEAD = 100      # decode_tp steps: rows of history before the first
MESH_WORLDS = {"world2": 2, "world4": 4}
# full_parallel of 2 x 30 s on (dp 2, tp 1): the audio seeds. Each dp rank
# runs its own lockstep loop over its chunk (a batch of one) where one
# process runs both chunks in one batch of two; the card's dense products
# (the encoder's convolutions, the logits) are summed in an order cuBLAS
# picks by the row count, and on these random weights a chunk's transcript
# moves with the batch (seeds 60-63 all moved on the H100). The check holds the
# mesh to one process running each rank's share alone, merged as
# full_parallel merges, and prints whether one batch of both agrees
DP2_SEEDS = (60, 61)
# the bf16 mesh encoder's gate against one device: its first layer at full
# width (over all 32 layers these random weights carry bf16 rounding far
# enough that one device sits 4e-2 of max|ref| from its own f32 encoder),
# and the limit on mean|x - one device| / mean|one device|, set between a
# sound reading and the control (mesh_encoder). The max-based reading is
# a count of bf16 steps at the largest outputs: the sound reading moves it
# as far as the control does, so it is printed and not gated.
# tests/_torch_mesh_gate_scan.py reads all three at depths 1-16 on the card
ENC_GATE_LAYERS = 1
ENC_BF16_LIMIT = 2.4e-3


def unfused_on_host(torch, params):
    """A context's params on the host with the decoder's fused q/k/v split
    back (a concatenation, so exactly): what WhisperContext takes."""
    blocks = dict(params["decoder"]["blocks"])
    qkv, b = blocks.pop("qkv_w"), blocks.pop("qkv_b")
    S = qkv.shape[-1] // 3
    blocks.update(q_w=qkv[..., :S], k_w=qkv[..., S:2 * S], v_w=qkv[..., 2 * S:],
                  q_b=b[..., :S], v_b=b[..., 2 * S:])

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return tree.to("cpu").contiguous()
    return host({"encoder": params["encoder"], "decoder": dict(params["decoder"], blocks=blocks)})


def _tp_inputs(torch, TM, cfg, dec, xk, xv):
    """The decode_tp steps' inputs: 100 seeded history rows in the caches,
    five one-row x0s (te + pe of seeded tokens) and one five-row x0."""
    g = torch.Generator(device="cuda").manual_seed(36)
    S, L, Tc = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_ctx
    hist = [(torch.randn(L, Tc, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
            for _ in range(2)]
    for h in hist:
        h[:, MESH_STEP_HEAD:] = 0
    toks = torch.randint(0, cfg.n_vocab, (10,), generator=g, device="cuda")
    pos = MESH_STEP_HEAD + torch.arange(5, device="cuda")
    x1 = [(dec["te"][toks[i:i + 1]] + dec["pe"][pos[i:i + 1]]).to(torch.bfloat16)
          for i in range(5)]
    x5 = (dec["te"][toks[5:]] + dec["pe"][pos]).to(torch.bfloat16)
    return {"hist_k": hist[0], "hist_v": hist[1], "x1": x1, "x5": x5, "xk": xk, "xv": xv}


def _tp_run(torch, DTP, cfg, mp, inp, rank, tp, group):
    """Five one-row steps from the history, then one five-row step from
    it: the logits of each and the caches after each run (this rank's
    columns), and the K3 launches the steps made."""
    from open_whisper_kit_tpu_torch.ops import quant_matmul as Q
    cols = slice(rank * cfg.n_text_state // tp, (rank + 1) * cfg.n_text_state // tp)
    xk, xv = inp["xk"][..., cols].contiguous(), inp["xv"][..., cols].contiguous()
    out, n0 = [], Q.qmm.launches
    for xs in (inp["x1"], [inp["x5"]]):
        kv_k = inp["hist_k"][..., cols].contiguous()
        kv_v = inp["hist_v"][..., cols].contiguous()
        head, logits = MESH_STEP_HEAD, []
        for x0 in xs:
            lg, kv_k, kv_v = DTP.mega_decode_step_tp(cfg, mp, x0, kv_k, kv_v, head, xk, xv,
                                                     group=group)
            logits.append(lg.cpu())
            head += x0.shape[0]
        out.append((logits, kv_k.cpu(), kv_v.cpu()))
    torch.cuda.synchronize()
    return out, Q.qmm.launches - n0


def _tp_equal(got, ref, rank, tp, S):
    """Whether a rank's logits and its columns of the caches equal tp = 1's,
    bit for bit."""
    cols = slice(rank * S // tp, (rank + 1) * S // tp)
    return all(all(g.cpu().equal(r.cpu()) for g, r in zip(gl, rl))
               and gk.cpu().equal(rk[..., cols].cpu()) and gv.cpu().equal(rv[..., cols].cpu())
               for (gl, gk, gv), (rl, rk, rv) in zip(got, ref))


def _rel(a, b) -> float:
    """max|a - b| / max|b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def _rel_mean(a, b) -> float:
    """mean|a - b| / mean|b|."""
    return ((a - b).abs().mean() / b.abs().mean()).item()


def mesh_encoder(torch, TM, TF, A, X, tok_mod, cfg, params, mel, mesh, rank, res) -> dict:
    """Phase 36's mesh encoder at tp 2 on dense turbo weights (`params`),
    rank 0 also holding one device's: in f32 and in bf16 at full depth
    (the pass WhisperContext(mesh=).encode_window makes), and in bf16 at
    ENC_GATE_LAYERS layers beside a sound reading (one device, its input
    scaled by 1 + 2^-20) and a control (the mesh with its f32 partial
    products rounded to bf16 before the all-reduce). Writes the readings
    into `res`; returns the bf16 contexts {one device?: context}."""
    vocab = tok_mod.build_vocab([b"<%d>" % i for i in range(50257)], cfg.n_vocab)
    filters = TF._synthetic_mel_filters(cfg.n_mels)

    def cast(tree, dtype):
        if isinstance(tree, dict):
            return {k: cast(v, dtype) for k, v in tree.items()}
        return tree.to(dtype)
    encs, ctxs, res["enc_k1"] = {}, {}, []
    for dtype in (torch.float32, torch.bfloat16):
        for one in ((False, True) if rank == 0 else (False,)):
            ctx = TF.WhisperContext(cfg, cast(params, dtype), vocab, filters, n_loaded=1,
                                    dtype=dtype, device="cuda", mesh=None if one else mesh)
            n1 = A.mha_packed.launches
            encs[dtype, one] = ctx.encode_window(mel.data, 0, 0)[0].float()
            torch.cuda.synchronize()
            if not one:
                res["enc_k1"].append(A.mha_packed.launches - n1)
            if dtype == torch.bfloat16:
                ctxs[one] = ctx
            del ctx
    cut = dataclasses.replace(cfg, n_audio_layer=ENC_GATE_LAYERS)
    window = mel.data[:2 * cfg.n_audio_ctx][None]

    def enc(one, x):
        return TM.encode(cut, ctxs[one].params["encoder"], x).float()
    gate = {"mesh": enc(False, window)}
    reduce = X.all_reduce_sum
    X.all_reduce_sum = lambda part, group: reduce(part.to(torch.bfloat16).float(), group)
    try:
        gate["control"] = enc(False, window)
    finally:
        X.all_reduce_sum = reduce
    if rank == 0:
        gate["one"] = enc(True, window)
        gate["sound"] = enc(True, window * (1 + 2.0 ** -20))
        one32, one16 = encs[torch.float32, True], encs[torch.bfloat16, True]
        res.update(
            enc_rel=_rel(encs[torch.float32, False], one32),
            enc_rel_bf16=_rel(encs[torch.bfloat16, False], one16),
            enc_f32_one=_rel(one16, one32),
            enc_f32_mesh=_rel(encs[torch.bfloat16, False], one32),
            enc_gate={k: [_rel(gate[k], gate["one"]), _rel_mean(gate[k], gate["one"])]
                      for k in ("mesh", "sound", "control")},
            enc_finite=all(bool(torch.isfinite(e).all())
                           for e in list(encs.values()) + list(gate.values())))
    return ctxs


def mesh_times(torch, TM, dist, cfg, ctxs, mel, mesh, rank, work) -> dict:
    """Phase 36's times at tp 2, once the main process has left the card
    (it writes work/idle): the bf16 mesh encoder pass (encode_window) and a
    one-row mesh decode step (decode_impl), both ranks on the one card with
    the collectives staged through the host, each beside one device's
    (rank 0 alone, rank 1 waiting): wall ms around a synchronize, median of
    five after one warm-up."""
    t_end = time.time() + 600
    while not (work / "idle").exists():
        check(time.time() < t_end, "phase 36: the main process never left the card")
        time.sleep(0.05)
    group = mesh.get_group("tp")

    def wall(fn, both: bool) -> float:
        ts = []
        for _ in range(6):
            dist.barrier(group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if both or rank == 0:
                fn()
                torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        dist.barrier(group)
        return statistics.median(ts[1:]) * 1e3

    tokens = torch.tensor([[50257]], device="cuda")

    def step(one):
        _, xk, xv = ctxs[one].encode_window(mel.data, 0, 0)
        kk, kv = TM.init_kv_cache(cfg, 1, torch.bfloat16, device="cuda")
        dec = ctxs[one].params["decoder"]
        return lambda: TM.decode_impl(cfg, dec, tokens, kk, kv, 0, xk, xv)
    out = {"enc_ms_mesh": wall(lambda: ctxs[False].encode_window(mel.data, 0, 0), True),
           "step_ms_mesh": wall(step(False), True)}
    if rank == 0:
        out["enc_ms_one"] = wall(lambda: ctxs[True].encode_window(mel.data, 0, 0), False)
        out["step_ms_one"] = wall(step(True), False)
    else:
        wall(None, False)
        wall(None, False)
    return out


def mesh_rank_main(argv) -> int:
    """One rank of phase 36's Gloo worlds on the card (chip_smoke.py
    --mesh-rank SCENARIO RANK WORLD PORT DIR): writes DIR/SCENARIO-RANK.json."""
    scenario, rank, world, port, work = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    from open_whisper_kit_tpu_torch import Transcriber
    from open_whisper_kit_tpu_torch.audio import mel as mel_mod
    from open_whisper_kit_tpu_torch.decode import full as TF
    from open_whisper_kit_tpu_torch.decode import tokenizer as tok_mod
    from open_whisper_kit_tpu_torch.decode.params import FullParams
    from open_whisper_kit_tpu_torch.models.whisper import model as TM
    from open_whisper_kit_tpu_torch.ops import attention as A
    from open_whisper_kit_tpu_torch.ops import decode_tp as DTP
    from open_whisper_kit_tpu_torch.parallel import mesh as X
    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(work)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    res = {"rank": rank}
    t0 = time.perf_counter()
    try:
        mesh = X.make_mesh(tp=world, device="cuda")
        ref = torch.load(work / "tp-ref.pt", map_location="cuda")
        cfg = TM.WhisperConfig(*TURBO)
        mp = torch.load(work / f"tp{world}-rank{rank}.pt", map_location="cuda")
        got, n_k3 = _tp_run(torch, DTP, cfg, mp, ref["inputs"], rank, world,
                            mesh.get_group("tp"))
        res.update(tp_equal=_tp_equal(got, ref["out"], rank, world, cfg.n_text_state),
                   tp_k3=n_k3, tp_steps=len(ref["inputs"]["x1"]) + 1)
        del mp, ref
        if scenario == "world2":
            # the mesh encoder at tp 2 on dense turbo weights, against one device
            params = torch.load(work / "dense.pt", map_location="cuda")
            mel = mel_mod.log_mel_spectrogram(audio(30.0, 30), TF._synthetic_mel_filters(
                cfg.n_mels), "cuda")
            ctxs = mesh_encoder(torch, TM, TF, A, X, tok_mod, cfg, params, mel, mesh, rank, res)
            del params
            # K1 on this rank's 10 heads (what the mesh encoder calls) against
            # those heads of the whole call
            g = torch.Generator(device="cuda").manual_seed(7)
            q, k, v = (torch.randn(1, 1536, 1280, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(3))
            whole = A.mha_full(q, k, v, 20, 0.125, kv_valid=1500)
            cols = slice(rank * 640, (rank + 1) * 640)
            mine = A.mha_full(q[..., cols].contiguous(), k[..., cols].contiguous(),
                              v[..., cols].contiguous(), 10, 0.125, kv_valid=1500)
            res["k1_equal"] = bool(mine.equal(whole[..., cols]))
            del q, k, v, whole, mine
            torch.cuda.empty_cache()
            # one 30 s greedy request on (dp 1, tp 2), full_parallel on (dp 2, tp 1)
            q8 = work.parent / "ggml-large-v3-turbo-q8_0.bin"
            p = greedy_params(FullParams)
            tr = Transcriber(model_path=q8, dtype=torch.bfloat16, mesh=mesh)
            r = tr.transcribe(audio(30.0, 30), p)
            res["tp2_ids"] = [t.id for s in r.segments for t in s.tokens]
            res["tp2_times"] = [(s.t0, s.t1) for s in r.segments]
            del tr
            tr = Transcriber(model_path=q8, dtype=torch.bfloat16,
                             mesh=X.make_mesh(tp=1, device="cuda"))
            res["dp2"] = {}
            for seed in DP2_SEEDS:
                r = tr.full_parallel(p, audio(60.0, seed), 2)
                res["dp2"][seed] = ([t.id for s in r.segments for t in s.tokens],
                                    [(s.t0, s.t1) for s in r.segments])
            del tr
            torch.cuda.empty_cache()
            res.update(mesh_times(torch, TM, dist, cfg, ctxs, mel, mesh, rank, work))
        res["collectives"] = dict(X.COLLECTIVES)
        res["seconds"] = time.perf_counter() - t0
        (work / f"{scenario}-{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()
    return 0


def phase_mesh(torch, TF, Transcriber, FullParams, tok_mod, mods, q8_path, dense,
               smi) -> dict:
    """Phase 36 (module docstring): the tp step's planes and its tp = 1
    reference; two and four ranks on the card over Gloo, started first; a
    world-1 NCCL mesh against no mesh while they run (`dense`: phase 4's
    weights on the host, unfused); then, on an idle card, the world2
    ranks' mesh encoder and decode step beside one device's, and the
    times: the tp = 1 step against K2 int8, K3 at the tp 2 shards' shapes,
    K1 on ten heads. Returns the shard rows and the step times."""
    from open_whisper_kit_tpu_torch.ops import decode_tp as DTP
    from open_whisper_kit_tpu_torch.parallel import mesh as X
    A, Q, MK, TM = mods.A, mods.Q, mods.MK, mods.TM
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="mesh-", dir=q8_path.parent))
    cfg = TM.WhisperConfig(*TURBO)

    # the tp step's planes from the q8_0 checkpoint's decoder, its inputs and
    # the tp = 1 reference; the shards the ranks load
    tr1 = Transcriber(model_path=q8_path, dtype=torch.bfloat16)
    dec = tr1.ctx.params["decoder"]
    mel = mods.mel_mod.log_mel_spectrogram(audio(30.0, 30), tr1.ctx.filters, "cuda")
    _, xk, xv = tr1.ctx.encode_window(mel.data, 0, 0)
    inp = _tp_inputs(torch, TM, cfg, dec, xk[:, 0].contiguous(), xv[:, 0].contiguous())
    mp1 = DTP.prepare_mega_tp(cfg, dec, 1)
    out1, k3_1 = _tp_run(torch, DTP, cfg, mp1, inp, 0, 1, None)
    torch.save({"inputs": inp, "out": out1}, work / "tp-ref.pt")
    for tp in (2, 4):
        mp = DTP.prepare_mega_tp(cfg, dec, tp)
        for rank in range(tp):
            torch.save(DTP.shard_mega_tp(mp, rank), work / f"tp{tp}-rank{rank}.pt")
    del mp
    torch.save(dense, work / "dense.pt")
    procs = []
    for scenario, n in MESH_WORLDS.items():
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs += [(scenario, r, subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--mesh-rank", scenario, str(r),
             str(n), str(port), str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            for r in range(n)]
    try:
        # (a) a world-1 NCCL mesh against no mesh, while the ranks run
        mesh = X.make_mesh()
        check(tuple(mesh.mesh.shape) == (1, 1) and X.mesh_device(mesh).type == "cuda"
              and str(X.dist.get_backend()) == "nccl", "world-1 mesh: not one NCCL rank")
        trm = Transcriber(model_path=q8_path, dtype=torch.bfloat16, mesh=mesh)
        p = greedy_params(FullParams)

        def ids(r):
            return ([t.id for s in r.segments for t in s.tokens],
                    [(s.t0, s.t1) for s in r.segments])

        def same(what, one, on_mesh, order=("one", "mesh")):
            res, walls = {"one": [], "mesh": []}, {"one": [], "mesh": []}
            for name in order:
                reset_counts(A, Q, MK)
                t0 = time.perf_counter()
                res[name].append(ids((one if name == "one" else on_mesh)()))
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t0)
                check(A.mha_packed.launches > 0, f"{what}: K1 not launched")
            ref = res["one"][0]
            equal = all(r == ref for r in res["one"] + res["mesh"])
            print(f"[36] world-1 NCCL mesh, {what}: tokens {len(ref[0])}, segments "
                  f"{len(ref[1])}, token ids and segment times equal to no mesh {equal}",
                  flush=True)
            check(equal and ref[0], f"{what}: mesh and no mesh differ")
            return ref, walls
        # one, mesh, mesh, one: the first call of each context builds its
        # step kernels' planes; the last two are the warm walls
        ref30, walls = same("q8_0 30 s greedy", lambda: tr1.transcribe(audio(30.0, 30), p),
                            lambda: trm.transcribe(audio(30.0, 30), p),
                            order=("one", "mesh", "mesh", "one"))
        check(MK.mega_decode_step.launches > 0, "q8_0 on the mesh: K2 not launched")
        same("q8_0 full_parallel 8 x 30 s", lambda: tr1.full_parallel(p, audio(240.0, 240), 8),
             lambda: trm.full_parallel(p, audio(240.0, 240), 8))
        ref60, alone = {}, {}
        for seed in DP2_SEEDS:
            x = audio(60.0, seed)
            ref60[seed] = ids(tr1.full_parallel(p, x, 2))
            merged = []
            for i, c in enumerate((x[:480000], x[480000:])):
                for seg in mods.TB.transcribe_chunks_with_timings(tr1.ctx, p, [c])[0][0]:
                    seg.t0 += 3000 * i
                    seg.t1 += 3000 * i
                    if i and merged:
                        seg.t0 = max(seg.t0, merged[-1].t1)
                    merged.append(seg)
            alone[seed] = ids(TF.TranscribeResult(segments=merged))
        # dense bf16 turbo (phase 4's weights): a context without a mesh and one on it
        params = TF._to_device(dense, "cuda")
        vocab = tok_mod.build_vocab([b"<%d>" % i for i in range(50257)], cfg.n_vocab)
        ctxs = {m: TF.WhisperContext(cfg, params, vocab, TF._synthetic_mel_filters(cfg.n_mels),
                                     n_loaded=1, dtype=torch.bfloat16,
                                     model_type="large-v3-turbo", device="cuda",
                                     mesh=mesh if m else None) for m in (False, True)}
        same("dense 65 s greedy", lambda: TF.whisper_full(ctxs[False], p, audio(65.0, 65)),
             lambda: TF.whisper_full(ctxs[True], p, audio(65.0, 65)))
        check(X.COLLECTIVES == {"all_gather": 0, "all_reduce": 0, "staged": 0},
              "a world-1 mesh issued collectives")
        del ctxs, params
        torch.cuda.empty_cache()
        (work / "idle").touch()     # the world2 ranks time their mesh passes now

        # (b) the ranks: 2 (the tp step at tp 2, the mesh encoder, a request on
        # (dp 1, tp 2), full_parallel on (dp 2, tp 1)) and 4 (the tp step at tp 4)
        for scenario, r, proc in procs:
            text = proc.communicate(timeout=600)[0].decode(errors="replace")
            check(proc.returncode == 0, f"phase 36 {scenario} rank {r} failed:\n{text[-3000:]}")
        ranks = {(s, r): json.loads((work / f"{s}-{r}.json").read_text())
                 for s, n in MESH_WORLDS.items() for r in range(n)}
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"[36] the ranks ended {time.perf_counter() - t_phase:.1f} s into the phase",
          flush=True)
    for (s, r), got in sorted(ranks.items()):
        tp = MESH_WORLDS[s]
        print(f"[36] {s} rank {r} (Gloo on one card): tp step at tp {tp} bit-equal to tp 1 "
              f"{got['tp_equal']} (5 one-row steps and one 5-row step), K3 launches "
              f"{got['tp_k3']} (tp 1: {k3_1}); collectives {got['collectives']}; "
              f"{got['seconds']:.1f} s", flush=True)
        check(got["tp_equal"], f"{s} rank {r}: tp step not bit-equal to tp 1")
        check(got["tp_k3"] == k3_1, f"{s} rank {r}: K3 launches {got['tp_k3']} != {k3_1}")
        check(got["collectives"]["staged"] > 0, f"{s} rank {r}: no collective staged")
    w2 = {r: ranks[("world2", r)] for r in range(2)}
    print(f"[36] mesh encoder (tp 2, dense turbo, one window): f32 max|mesh - one device| / "
          f"max|ref| {w2[0]['enc_rel']:.2e}; bf16 {w2[0]['enc_rel_bf16']:.2e}, where bf16 "
          f"rounding alone takes one device {w2[0]['enc_f32_one']:.2e} and the mesh "
          f"{w2[0]['enc_f32_mesh']:.2e} from the f32 encoder of the same weights; K1 "
          f"launches per rank and pass "
          f"{[w2[r]['enc_k1'] for r in range(2)]}; K1 on each rank's 10 heads equal to those "
          f"heads of the whole call {[w2[r]['k1_equal'] for r in range(2)]}", flush=True)
    check(w2[0]["enc_rel"] <= 1e-2 and w2[0]["enc_finite"], "mesh encoder far from one device")
    gate = w2[0]["enc_gate"]
    print(f"[36] mesh encoder in bf16 at its first {ENC_GATE_LAYERS} layer(s) against one "
          f"device, mean|x - one| / mean|one| (max|x - one| / max|one|): the mesh "
          f"{gate['mesh'][1]:.3e} ({gate['mesh'][0]:.3e}), limit {ENC_BF16_LIMIT:.1e}; one "
          f"device with its input scaled by 1 + 2^-20 (sound, must pass) "
          f"{gate['sound'][1]:.3e} ({gate['sound'][0]:.3e}); the mesh with its f32 partials "
          f"rounded to bf16 before the all-reduce (control, must fail) "
          f"{gate['control'][1]:.3e} ({gate['control'][0]:.3e})", flush=True)
    check(gate["mesh"][1] <= ENC_BF16_LIMIT, "bf16 mesh encoder far from one device")
    check(gate["sound"][1] <= ENC_BF16_LIMIT, "bf16 mesh encoder: a sound reading fails the limit")
    check(gate["control"][1] > ENC_BF16_LIMIT, "bf16 mesh encoder: the control passes the limit")
    print(f"[36] tp 2, two ranks on the one card (Gloo, the collectives through the host), "
          f"wall ms (median of 5): the bf16 mesh encoder pass {w2[0]['enc_ms_mesh']:.1f} "
          f"against one device {w2[0]['enc_ms_one']:.1f}; a one-row decode step "
          f"(decode_impl) {w2[0]['step_ms_mesh']:.2f} against one device "
          f"{w2[0]['step_ms_one']:.2f} | {smi}", flush=True)
    check(all(w2[r]["k1_equal"] and w2[r]["enc_k1"] == [TURBO_LAYERS] * 2 for r in range(2)),
          "K1 on a rank's heads differs from the whole call, or launch count off")
    for r in range(2):
        same_tp = (w2[r]["tp2_ids"], [tuple(x) for x in w2[r]["tp2_times"]]) == ref30
        got = {int(k): (v[0], [tuple(x) for x in v[1]]) for k, v in w2[r]["dp2"].items()}
        print(f"[36] rank {r}: q8_0 30 s greedy on (dp 1, tp 2) tokens {len(w2[r]['tp2_ids'])} "
              f"equal to one process {same_tp}; full_parallel 2 x 30 s on (dp 2, tp 1), per "
              f"audio seed (tokens, equal to one process running each rank's chunk alone, "
              f"equal to one process's batch of both): " + ", ".join(
                  f"{seed} ({len(got[seed][0])}, {got[seed] == alone[seed]}, "
                  f"{got[seed] == ref60[seed]})" for seed in DP2_SEEDS), flush=True)
        check(same_tp, f"rank {r}: the (dp 1, tp 2) request differs from one process")
        check(all(got[s] == alone[s] and got[s][0] for s in DP2_SEEDS),
              f"rank {r}: full_parallel on (dp 2, tp 1) differs from one process running "
              "the ranks' shares")

    # (c) times on the idle card: the tp = 1 step against K2 int8 on the same
    # planes; K3 at the tp 2 shards' shapes (one row, the whole width's
    # splits); K1 on ten heads; a 30 s request's wall with and without the mesh
    mpk = MK.prepare_mega(cfg, dec, quant="all")
    kv = [inp["hist_k"].clone(), inp["hist_v"].clone()]
    x0 = inp["x1"][0]

    def step_tp():
        return DTP.mega_decode_step_tp(cfg, mp1, x0, kv[0], kv[1], MESH_STEP_HEAD,
                                       inp["xk"], inp["xv"])

    def step_k2():
        return MK.mega_decode_step(cfg, mpk, x0, kv[0], kv[1],
                                   torch.tensor(MESH_STEP_HEAD, device="cuda"),
                                   inp["xk"], inp["xv"])
    tp_ms = cuda_ms(torch, step_tp, reps=10, queued=True)
    k2_ms = cuda_ms(torch, step_k2, queued=True)
    lt, lk = step_tp()[0], step_k2()[0]
    rel = ((lt - lk).abs().max() / lk.abs().max()).item()
    print(f"[36] tp step (decode_tp, tp 1) on the q8_0 decoder, one row: {tp_ms * 1e3:.1f} "
          f"us queued (device time) against K2 int8 on the same planes {k2_ms * 1e3:.1f} us; "
          f"{k3_1} K3 launches for 6 steps; logits max|tp - K2| / max|K2| {rel:.2e}, argmax "
          f"equal {int(lt.argmax()) == int(lk.argmax())} | {smi}", flush=True)
    check(rel <= K2_TOL and int(lt.argmax()) == int(lk.argmax()),
          "decode_tp at tp 1 far from K2 on the same planes")
    del mpk, mp1
    rows = []
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    mp2 = DTP.shard_mega_tp(DTP.prepare_mega_tp(cfg, dec, 2), 0)
    for f, K, n_whole in (("qkv", 1280, 3840), ("o", 1280, 1280), ("mlp0", 1280, 5120),
                          ("mlp1", 5120, 1280), ("teT", 1280, cfg.n_vocab)):
        qs = mp2[f + "_qs"] if f == "teT" else mp2[f + "_qs"][0]
        sc = mp2[f + "_sc"] if f == "teT" else mp2[f + "_sc"][0]
        xr = torch.randn(1, K, device="cuda").to(torch.bfloat16)
        splits = Q.qmm_rows_plan(1, K, Q._padded(n_whole)).splits
        own = Q.qmm_rows_plan(1, K, qs.shape[1]).splits
        ref = Q.qmm_plain(xr, qs, sc)
        err = ((Q.qmm(xr, qs, sc, splits=splits) - ref).abs().max() / ref.abs().max()).item()
        wd = Q.dequantize_dense(Q.QuantLinear(qs, sc))
        k_ms = cuda_ms(torch, lambda: Q.qmm(xr, qs, sc, splits=splits), flush=flush,
                       queued=True)
        p_ms = cuda_ms(torch, lambda: Q.qmm_plain(xr, qs, sc), flush=flush)
        l_ms = cuda_ms(torch, lambda: torch.matmul(xr, wd), flush=flush, queued=True)
        b_ms, by = bound(nbytes(xr, qs, sc) + 4 * qs.shape[1], 2 * K * qs.shape[1])
        rows.append({"shape": f"tp 2 shard {f} 1x{K}->{qs.shape[1]}", "ms": k_ms,
                     "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms, "bound_by": by,
                     "max_abs_err": err, "splits": splits, "own_splits": own})
        print(f"[36] K3 rows route at the tp 2 shard of {f} (1 x {K} -> {qs.shape[1]}, the "
              f"whole width's {splits} splits, its own plan's {own}): {k_ms * 1e3:.1f} us "
              f"queued, plain {p_ms * 1e3:.1f}, torch.matmul {l_ms * 1e3:.1f} queued, bound "
              f"{b_ms * 1e3:.2f} us ({by}), {b_ms / k_ms:.1%}; max|err| / max|ref| {err:.1e}",
              flush=True)
        check(err <= 1e-3, f"K3 at the {f} shard off its plain version")
    del mp2, dec
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(1, 1536, 640, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    ref = A.mha_plain(q, k, v, 10, 0.125, 1500)
    err = ((A.mha_packed(q, k, v, 0.125, 1500) - ref).abs().max() / ref.abs().max()).item()
    qh, kh, vh = (t.view(1, 1536, 10, 64).transpose(1, 2).contiguous() for t in (q, k, v))
    mask = (torch.arange(1536, device="cuda") < 1500)[None, None, None, :]
    k1_ms = cuda_ms(torch, lambda: A.mha_packed(q, k, v, 0.125, 1500))
    p1_ms = cuda_ms(torch, lambda: A.mha_plain(q, k, v, 10, 0.125, 1500))
    s1_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, mask, scale=0.125))
    b1_ms, by1 = bound(nbytes(q, k, v) * 4 / 3, 4 * 1536 * 1500 * 640)
    rows.append({"shape": "tp 2: (1,1536,640) bf16, 10 heads, 1500 keys", "ms": k1_ms,
                 "plain_ms": p1_ms, "library_ms": s1_ms, "bound_ms": b1_ms, "bound_by": by1,
                 "max_abs_err": err})
    print(f"[36] K1 on ten heads (1, 1536, 640) bf16, 1500 keys: {k1_ms * 1e3:.1f} us, plain "
          f"{p1_ms * 1e3:.1f}, SDPA {s1_ms * 1e3:.1f}, bound {b1_ms * 1e3:.2f} us ({by1}); "
          f"max|err| / max|ref| {err:.1e}", flush=True)
    check(err <= 1e-2, "K1 on ten heads off its plain version")
    del flush, q, k, v, ref
    print(f"[36] q8_0 30 s greedy wall (one, mesh, mesh, one; the first call of each "
          f"context builds its planes) without a mesh "
          f"{', '.join(f'{w:.4f}' for w in walls['one'])} s, on the world-1 NCCL mesh "
          f"{', '.join(f'{w:.4f}' for w in walls['mesh'])} s | {smi}", flush=True)
    del tr1, trm
    torch.cuda.empty_cache()
    X.dist.destroy_process_group()
    shutil.rmtree(work, ignore_errors=True)
    print(f"[36] phase 36 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"rows": rows, "tp_ms": tp_ms, "k2_ms": k2_ms, "walls": walls,
            "times_tp2": {k: w2[0][k] for k in ("enc_ms_mesh", "enc_ms_one", "step_ms_mesh",
                                               "step_ms_one")}}


def main(profiling: bool = False) -> int:
    if not (REPO / "open_whisper_kit_tpu_torch").is_dir():
        print("chip_smoke: the open_whisper_kit_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from open_whisper_kit_tpu_torch import Transcriber
    from open_whisper_kit_tpu_torch.audio import mel as mel_mod
    from open_whisper_kit_tpu_torch.decode import device_beam as DB
    from open_whisper_kit_tpu_torch.decode import device_loop as DL
    from open_whisper_kit_tpu_torch.decode import full as TF
    from open_whisper_kit_tpu_torch.decode import tokenizer as tok_mod
    from open_whisper_kit_tpu_torch.decode.params import FullParams
    from open_whisper_kit_tpu_torch.io import ggml_writer as W
    from open_whisper_kit_tpu_torch.models.whisper import model as TM
    from open_whisper_kit_tpu_torch.ops import _build
    from open_whisper_kit_tpu_torch.ops import attention as A
    from open_whisper_kit_tpu_torch.ops import decode_megakernel as MK
    from open_whisper_kit_tpu_torch.ops import encoder_int8 as E8
    from open_whisper_kit_tpu_torch.ops import experiments as XQ
    from open_whisper_kit_tpu_torch.ops import gemm as G
    from open_whisper_kit_tpu_torch.ops import quant_matmul as Q
    from open_whisper_kit_tpu_torch.tools import bench_int8_mxu as P
    from open_whisper_kit_tpu_torch.decode import batch as TB
    import types
    import numpy as np
    mods = types.SimpleNamespace(A=A, Q=Q, MK=MK, E8=E8, XQ=XQ, TB=TB, TM=TM, DL=DL, DB=DB,
                                 mel_mod=mel_mod, np=np, W=W)

    phase_t = {}
    t_start = time.perf_counter()

    def done(tag):
        phase_t[tag] = time.perf_counter() - t_start - sum(phase_t.values())
        print(f"[{tag}] phase took {phase_t[tag]:.1f} s", flush=True)

    # ---- 1. versions and card ----
    smi = nvidia_smi_line()
    print(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} | {smi}", flush=True)
    done("1")

    # ---- 2. build the kernels, one nvcc per source, all at once ----
    t0 = time.perf_counter()
    _build.build_all(list(KERNELS))
    A._kernel_lib()
    MK._kernel_lib("mega_step")
    MK._kernel_lib("mega_beam")
    MK._kernel_lib("mega_batch")
    E8._kernel_lib()
    XQ._kernel_lib()
    G._lib_bf16()
    G._lib_s8()
    for name in ("qmm", "qmm_rows", "qmm4", "ffn_int8"):
        Q._kernel_lib(name)
    print(f"[2] {', '.join(KERNELS)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    done("2")

    # ---- 3. every kernel against its plain version ----
    k1 = phase_k1(torch, A, torch.bfloat16, 1280, True, 1e-2, 0)
    k1["f32_shapes"] = [phase_k1(torch, A, torch.float32, S, False, 2e-5, 1)
                        for S in (128, 1280)]
    quant = phase_quant_kernels(torch, Q)
    k2 = phase_k2(torch, TM, MK, Q, profiling)
    k2v = phase_k2_verify(torch, TM, MK, Q, profiling)
    k7 = phase_k7(torch, TM, MK, Q)
    done("3")

    # ---- 11-13. the kernels of batched serving against their plain versions ----
    k6 = phase_k6(torch, E8)
    done("11")
    phase_k1(torch, A, torch.bfloat16, 1280, True, 1e-2, 2, B=K8_STREAMS, tag="12")
    done("12")
    k8 = phase_k8(torch, TM, MK, Q)
    done("13")
    # ---- 18. K9b and K9a (int8 cross-KV) against their plain versions ----
    k9 = phase_k9(torch, TM, XQ)
    done("18")
    # ---- 23. T1 and T2 against their plain versions; the probe, their path ----
    mxu = phase_mxu(torch, G, P, profiling)
    done("23")

    # ---- 4. turbo bf16 requests through the public entry point ----
    t0 = time.perf_counter()
    tr = Transcriber(preset="large-v3-turbo", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    print(f"[4] large-v3-turbo weights (seed 0) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reset_counts(A, Q, MK)
    n_enc = 0
    for secs, seed in ((30.0, 30),):
        res = serve(torch, tr, FullParams, secs, seed, "4", greedy=False)
        n_enc += res.timings.n_encode
    launches = {"mha_packed": A.mha_packed.launches}
    print(f"[4] K1 launches {launches['mha_packed']} for {n_enc} encoder passes",
          flush=True)
    check(n_enc > 0 and launches["mha_packed"] == TURBO_LAYERS * n_enc,
          f"K1 launches {launches['mha_packed']} != {TURBO_LAYERS} x {n_enc}")
    ctx = tr.ctx
    mel = mel_mod.log_mel_spectrogram(audio(30.0, 30), ctx.filters, "cuda")
    enc_out, xk, xv = ctx.encode_window(mel.data, 0, 0)
    check(tuple(enc_out.shape) == (1, 1500, 1280) and bool(torch.isfinite(enc_out).all())
          and tuple(xk.shape) == (4, 1, 1500, 1280), "turbo encoder output malformed")
    enc_ms = cuda_ms(torch, lambda: ctx.encode_window(mel.data, 0, 0), reps=5, warmup=1)
    print(f"[4] turbo encoder + cross-KV per window: {enc_ms:.2f} ms (median of 5)",
          flush=True)
    dense_turbo = unfused_on_host(torch, ctx.params)    # phase 36's dense weights
    del tr, ctx, enc_out, xk, xv
    torch.cuda.empty_cache()
    done("4")

    # ---- 5. narrow f32 config: cuda against cpu ----
    cfg = TM.WhisperConfig(*NARROW)
    params = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tokens = [b"<%d>" % i for i in range(min(cfg.n_vocab, 50257))]
    results = {}
    for dev in ("cuda", "cpu"):
        vocab = tok_mod.build_vocab(tokens, cfg.n_vocab)
        c = TF.WhisperContext(cfg, params, vocab, TF._synthetic_mel_filters(80),
                              n_loaded=1, dtype=torch.float32, device=dev)
        samples = audio(65.0, 5)
        m = mel_mod.log_mel_spectrogram(samples, c.filters, dev)
        eo = c.encode_window(m.data, 0, 0)[0].cpu()
        r = TF.whisper_full(c, greedy_params(FullParams), samples)
        results[dev] = (eo, [[t.id for t in s.tokens] for s in r.segments])
    enc_err = (results["cuda"][0] - results["cpu"][0]).abs().max().item()
    same = results["cuda"][1] == results["cpu"][1]
    print(f"[5] narrow f32: encoder max|cuda-cpu| {enc_err:.3e}, segments "
          f"{len(results['cuda'][1])}, token ids equal {same}", flush=True)
    check(enc_err <= 1e-4, "narrow f32 encoder: cuda and cpu differ")
    check(same and len(results["cuda"][1]) > 0, "narrow f32 tokens: cuda and cpu differ")
    done("5")

    build_dir = REPO / "build"
    build_dir.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke-ckpt-", dir=build_dir))
    drafts = None
    try:
        # ---- 6. full-width q8_0 checkpoint through Transcriber(model_path) ----
        # phase 16's drafts, written by a process of their own meanwhile
        t_drafts = time.perf_counter()
        drafts = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"),
                                   "--write-drafts", str(tmp), str(len(tokens))],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        hp = W.WhisperHParams(*TURBO, ftype=1, qntvr=0)
        path = tmp / "ggml-large-v3-turbo-q8_0.bin"
        W.write_checkpoint(path, hp, TF._synthetic_mel_filters(128), tokens,
                           W.random_reference_tensors(hp, seed=0),
                           wtype=W.TYPE_FOR_NAME["q8_0"])
        print(f"[6] q8_0 large-v3-turbo checkpoint written in "
              f"{time.perf_counter() - t0:.1f} s ({path.stat().st_size / 1e6:.0f} MB)",
              flush=True)
        t0 = time.perf_counter()
        tr = Transcriber(model_path=path, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        blocks = tr.ctx.params["decoder"]["blocks"]
        check(tr.model_type == "large-v3-turbo"
              and isinstance(tr.ctx.params["encoder"]["blocks"]["mlp0_w"], Q.QuantLinear)
              and isinstance(blocks["qkv_w"], Q.QuantLinear)
              and blocks["mlp0_w"].qs.shape[-1] == blocks["mlp0_w"].n_out,
              "q8_0 checkpoint did not load as unpadded int8 planes")
        print(f"[6] loaded on cuda in {time.perf_counter() - t0:.1f} s", flush=True)
        check(tr.ctx.mega_mode(greedy_params(FullParams)) == "all",
              "q8_0 checkpoint: K2 is not switched on by itself")
        launches["qmm"] = launches["qmm_rows"] = launches["ffn_int8"] = 0
        # auto (K2 int8 for every token step), then megakernel=False, whose
        # token steps run decode_impl (K3 and K5 on the decoder path)
        for megakernel, runs in ((None, ((30.0, 30), (65.0, 65))), (False, ((30.0, 30),))):
            reset_counts(A, Q, MK)
            with CallCounter(TM, DL, DB) as calls:
                n_sample = sum(serve(torch, tr, FullParams, secs, seed, "6",
                                     megakernel=megakernel).timings.n_sample
                               for secs, seed in runs)
            torch.cuda.synchronize()
            want_k3 = calls.enc * (TURBO_LAYERS * 6 + 4 * 2) + calls.dec * 4 * 4
            want_k5 = calls.dec * 4
            n_k2 = MK.mega_decode_step.launches
            print(f"[6] megakernel={megakernel!r}: encoder passes {calls.enc}, decode_impl "
                  f"calls {calls.dec}, K2 steps {calls.mega}, sampled tokens {n_sample}: "
                  f"K2 launches {n_k2}, K3 launches {Q.qmm.launches} (predicted {want_k3}), "
                  f"K5 launches {Q.ffn_int8.launches} (predicted {want_k5}), K1 launches "
                  f"{A.mha_packed.launches} (predicted {TURBO_LAYERS * calls.enc})",
                  flush=True)
            check(calls.enc > 0 and Q.qmm.launches == want_k3
                  and Q.ffn_int8.launches == want_k5
                  and A.mha_packed.launches == TURBO_LAYERS * calls.enc
                  and Q.qmm4.launches == 0, "q8_0 request: launch counts off prediction")
            check_k3_routes(Q, calls, f"q8_0 megakernel={megakernel!r}")
            if megakernel is None:
                # every token step is one K2 launch; a window's loop steps once
                # per sampled token but its last, and at most POLL - 1 masked
                # steps past its end
                check(n_k2 == calls.mega and n_sample - calls.dec <= n_k2
                      <= n_sample + 16 * calls.dec,
                      f"q8_0 auto: K2 launches {n_k2} do not match the token steps")
                launches["mega_decode_step"] = n_k2
            else:
                check(n_k2 == 0 and calls.mega == 0, "megakernel=False still ran K2")
            launches["qmm"] += Q.qmm.launches_by_route["tiles"]
            launches["qmm_rows"] += Q.qmm.launches_by_route["rows"]
            launches["ffn_int8"] += Q.ffn_int8.launches
        # the main path of beam search: every beam token step is one K7
        # launch (int8, by itself), K2 never; the host reads the loop's done
        # flag every POLL steps and one control pair per window, no token
        reset_counts(A, Q, MK)
        reads0 = tr.ctx.reads.n
        with CallCounter(TM, DL, DB) as calls:
            n_sample = serve(torch, tr, FullParams, 30.0, 30, "6",
                             beam_size=K7_BEAMS).timings.n_sample
        torch.cuda.synchronize()
        reads = tr.ctx.reads.n - reads0
        want_k3 = calls.enc * (TURBO_LAYERS * 6 + 4 * 2) + calls.dec * 4 * 4
        n_k7 = MK.mega_decode_step_beam.launches
        print(f"[6] beam {K7_BEAMS}: encoder passes {calls.enc}, decode_impl calls "
              f"{calls.dec}, K7 steps {calls.beam}, sampled tokens {n_sample}: K7 launches "
              f"{n_k7}, K2 launches {MK.mega_decode_step.launches}, K3 launches "
              f"{Q.qmm.launches} (predicted {want_k3}), K5 launches {Q.ffn_int8.launches} "
              f"(predicted {calls.dec * 4}), K1 launches {A.mha_packed.launches}, host "
              f"reads {reads}", flush=True)
        check(calls.enc > 0 and Q.qmm.launches == want_k3
              and Q.ffn_int8.launches == calls.dec * 4 and Q.qmm4.launches == 0
              and A.mha_packed.launches == TURBO_LAYERS * calls.enc
              and MK.mega_decode_step.launches == 0 and calls.mega == 0,
              "q8_0 beam request: launch counts off prediction")
        check_k3_routes(Q, calls, f"q8_0 beam {K7_BEAMS}")
        check(n_k7 == calls.beam and n_sample - calls.dec <= n_k7 <= n_sample + 16 * calls.dec,
              f"q8_0 beam: K7 launches {n_k7} do not match the beam token steps")
        check(reads <= n_sample / 16 + 2 * calls.dec + 1,
              f"q8_0 beam: {reads} host reads for {n_sample} token steps")
        launches["mega_decode_step_beam"] = n_k7
        witness_k7(torch, tr, FullParams, DB)
        mel = mel_mod.log_mel_spectrogram(audio(30.0, 30), tr.ctx.filters, "cuda")
        q_ms = cuda_ms(torch, lambda: tr.ctx.encode_window(mel.data, 0, 0), reps=5,
                       warmup=1)
        print(f"[6] q8_0 encoder + cross-KV per window: {q_ms:.2f} ms (median of 5)",
              flush=True)
        if profiling:
            profile_call(torch, "q8_0-encoder", "q8_0 encoder + cross-KV, one 30 s window",
                         lambda: (tr.ctx.encode_window(mel.data, 0, 0), [])[1])
            profile_request(torch, tr, FullParams, 30.0, 30, "q8_0")
            profile_request(torch, tr, FullParams, 30.0, 30, "q8_0-beam5", beam_size=K7_BEAMS)
        done("6")

        # ---- 19. int8 cross-KV requests on the q8_0 checkpoint (K9b) ----
        launches["cross_attention_q8"] = phase_cross_int8(torch, tr, FullParams, mods)
        done("19")
        # ---- 21. K9a on its path: decode_impl over QuantKVNat planes ----
        launches["cross_attention_q8_nat"] = phase_k9a_path(torch, tr, mods)
        done("21")
        # ---- 24. the whisper_full options at full width ----
        phase_options(torch, tr, TF, FullParams, mods, tmp)
        del tr, blocks
        torch.cuda.empty_cache()
        done("24")

        # ---- 7. runtime W8 and W4 logits on the turbo preset ----
        tr = Transcriber(preset="large-v3-turbo", dtype=torch.bfloat16,
                         decoder_int8=True, seed=0)
        dec = tr.ctx.params["decoder"]
        check(isinstance(dec["te_logits"], Q.QuantLinear), "decoder_int8 made no W8 plane")
        x_ln = torch.randn(1, 1, 1280, generator=torch.Generator(device="cuda").manual_seed(3),
                           device="cuda").to(torch.bfloat16)
        dense = TM._dot_f32(x_ln, dec["te"].t())
        # the same request on the dense logits projection first: the yardstick
        # for the W8/W4 requests' RTF, in the same call on the same card
        tr.ctx.params["decoder"] = {k: v for k, v in dec.items() if k != "te_logits"}
        serve(torch, tr, FullParams, 30.0, 30, "7 dense logits")
        if profiling:
            profile_request(torch, tr, FullParams, 30.0, 30, "dense")
        # the same weights through K2: dense planes, then runtime int4 planes
        for megakernel in (True, "int4"):
            reset_counts(A, Q, MK)
            serve(torch, tr, FullParams, 30.0, 30, "7 K2", megakernel=megakernel)
            check(MK.mega_decode_step.launches > 0 and Q.qmm.launches == 0
                  and Q.qmm4.launches == 0, f"megakernel={megakernel!r} did not run K2 alone")
        # beam search on the same weights: decode_impl over the beams, then K7 int4
        for megakernel in (False, "int4"):
            reset_counts(A, Q, MK)
            serve(torch, tr, FullParams, 30.0, 30, "7", megakernel=megakernel,
                  beam_size=K7_BEAMS)
            n_k7 = MK.mega_decode_step_beam.launches
            check((n_k7 > 0) == (megakernel == "int4") and MK.mega_decode_step.launches == 0
                  and Q.qmm.launches == 0 and Q.qmm4.launches == 0,
                  f"beam, megakernel={megakernel!r}: K7 launches {n_k7}, K2 "
                  f"{MK.mega_decode_step.launches}")
        tr.ctx.params["decoder"] = dec
        for bits in (8, 4):
            if bits == 4:
                dec = dict(dec)
                dec.pop("te_logits")
                dec = TM.quantize_decoder_int8(dec, logits_bits=4)
                tr.ctx.params["decoder"] = dec
                check(isinstance(dec["te_logits"], Q.QuantLinear4), "no W4 plane")
            lg = Q.qmatmul(x_ln, dec["te_logits"])
            rel = ((lg - dense).abs().max() / dense.abs().max()).item()
            print(f"[7] W{bits} logits plane against the dense bf16 projection: "
                  f"max|diff| / max|dense| {rel:.4f}", flush=True)
            check(tuple(lg.shape) == (1, 1, 51866) and rel <= (0.05 if bits == 8 else 0.25),
                  f"W{bits} logits far from the dense projection")
            reset_counts(A, Q, MK)
            with CallCounter(TM, DL, DB) as calls:
                serve(torch, tr, FullParams, 30.0, 30, "7")
            torch.cuda.synchronize()
            kern = Q.qmm if bits == 8 else Q.qmm4
            other = Q.qmm4 if bits == 8 else Q.qmm
            print(f"[7] W{bits}: decoder calls {calls.dec}, {kern.__name__} launches "
                  f"{kern.launches}", flush=True)
            check(calls.dec > 0 and kern.launches == calls.dec and other.launches == 0
                  and Q.ffn_int8.launches == 0, f"W{bits} logits: launch counts off")
            if bits == 4:
                launches["qmm4"] = kern.launches
                by_route = dict(Q.qmm4.launches_by_route)
                # K4 on this plane as the request runs it: one row, queued
                # (device time), the call and the host's time to issue it
                te4 = dec["te_logits"]
                x1 = x_ln.reshape(1, -1)
                ref4 = Q.qmm4_plain(x1, te4.qs, te4.scales)
                err4 = ((Q.qmm4(x1, te4.qs, te4.scales) - ref4).abs().max()
                        / ref4.abs().max()).item()
                flush7 = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
                run4 = lambda: Q.qmm4(x1, te4.qs, te4.scales)   # noqa: E731
                q4_ms = cuda_ms(torch, run4, flush=flush7, queued=True)
                c4_ms = cuda_ms(torch, run4, flush=flush7)
                h4_us = host_us(torch, run4)
                print(f"[7] W4: K4 launches by route {by_route} (the rows body at every "
                      f"decoder call of at most {Q.QMM_ROWS_MAX} rows); K4 on this plane, one "
                      f"row: {q4_ms * 1e3:.1f} us queued (device time), the call "
                      f"{c4_ms * 1e3:.1f} us, host {h4_us:.1f} us (cold L2, median of 20); "
                      f"max|err| / max|ref| {err4:.2e} against its plain version", flush=True)
                check(by_route["rows"] > 0 and err4 <= 1e-3,
                      "W4 logits: K4's rows body not launched, or off its plain version")
                del flush7
        del tr, dec
        torch.cuda.empty_cache()
        done("7")

        # ---- 8. narrow q4_0 / q5_0 checkpoints: cuda against cpu ----
        hp = W.WhisperHParams(*NARROW_Q, ftype=1, qntvr=0)
        tensors = W.random_reference_tensors(hp, seed=0)
        # 35 s (two windows); audio seeds whose transcript on the CPU stays
        # the same when the input is scaled by 1 +- 2^-20, 2^-16 or 2^-13,
        # so a last-place difference in a sum does not flip a near-tied
        # random-weight token
        for qtype, seed in (("q4_0", 6), ("q5_0", 6)):
            path = tmp / f"narrow-{qtype}.bin"
            W.write_checkpoint(path, hp, TF._synthetic_mel_filters(80), tokens, tensors,
                               wtype=W.TYPE_FOR_NAME[qtype])
            ids, n_enc = {}, {}
            for dev in ("cuda", "cpu"):
                c = TF.WhisperContext.from_file(path, dtype=torch.float32, device=dev)
                reset_counts(A, Q, MK)
                r = TF.whisper_full(c, greedy_params(FullParams), audio(35.0, seed))
                ids[dev] = [[t.id for t in s.tokens] for s in r.segments]
                n_enc[dev] = r.timings.n_encode
                if dev == "cuda":
                    check(Q.qmm.launches > 0 and Q.ffn_int8.launches > 0,
                          f"narrow {qtype} on cuda did not run K3 and K5")
            flat = {dev: [t for s in v for t in s] for dev, v in ids.items()}
            same = ids["cuda"] == ids["cpu"]
            n_tok = len(flat["cuda"])
            first = next((i for i, (a, b) in enumerate(zip(flat["cuda"], flat["cpu"]))
                          if a != b), None)
            print(f"[8] narrow {qtype}: encoder passes {n_enc['cuda']}, segments "
                  f"{len(ids['cuda'])}, tokens {n_tok}, token ids cuda == cpu {same}"
                  + ("" if same else f" (first differing token {first})"), flush=True)
            check(same and n_tok >= 100 and n_enc["cuda"] == n_enc["cpu"] == 2,
                  f"narrow {qtype}: cuda and cpu differ, or too few tokens to tell")
        done("8")

        # ---- 9. narrow bf16 q8_0 checkpoint, megakernel="int8": cuda against cpu ----
        path = tmp / "narrow-q8_0.bin"
        W.write_checkpoint(path, hp, TF._synthetic_mel_filters(80), tokens, tensors,
                           wtype=W.TYPE_FOR_NAME["q8_0"])
        p9 = greedy_params(FullParams)
        p9.megakernel = "int8"
        ids = {}
        for dev in ("cuda", "cpu"):
            c = TF.WhisperContext.from_file(path, dtype=torch.bfloat16, device=dev)
            check(c.mega_mode(p9) == "all", "narrow q8_0: K2 not selected")
            reset_counts(A, Q, MK)
            # audio seed 7: its CPU transcript stays the same when the input
            # is scaled by 1 +- 2^-20, 2^-16 or 2^-13
            r = TF.whisper_full(c, p9, audio(35.0, 7))
            ids[dev] = [[t.id for t in s.tokens] for s in r.segments]
            if dev == "cuda":
                check(MK.mega_decode_step.launches > 0, "narrow q8_0 on cuda did not run K2")
        n_tok = sum(map(len, ids["cuda"]))
        print(f"[9] narrow bf16 q8_0, megakernel='int8': segments {len(ids['cuda'])}, "
              f"tokens {n_tok}, token ids cuda == cpu {ids['cuda'] == ids['cpu']}", flush=True)
        check(ids["cuda"] == ids["cpu"] and n_tok >= 100,
              "narrow bf16 q8_0 with K2: cuda and cpu differ, or too few tokens to tell")
        # K2 alone: the card's token loop from the CPU's encoder output
        ctxs = {dev: TF.WhisperContext.from_file(path, dtype=torch.bfloat16, device=dev)
                for dev in ("cuda", "cpu")}
        for seed in ONE_ENC_GREEDY_SEEDS:
            reset_counts(A, Q, MK)
            one_encoder_output(
                torch, TM, mods.TB.LR, "9", f"narrow bf16 q8_0 greedy, megakernel='int8', "
                f"{ONE_ENC_GREEDY_SECS:.0f} s, audio seed {seed}",
                lambda c, seed=seed: [[t.id for s in TF.whisper_full(
                    c, p9, audio(ONE_ENC_GREEDY_SECS, seed)).segments for t in s.tokens]], ctxs)
            check(MK.mega_decode_step.launches > 0, "narrow q8_0 from one encoder output: no K2")
        done("9")

        # ---- 10. beam search, beam_size=3: cuda against cpu ----
        pb = request_params(FullParams, beam_size=3)
        cfg3 = TM.WhisperConfig(*NARROW_Q)
        params3 = TM.init_params(cfg3, seed=0, dtype=torch.float32, device="cpu")
        ids = {}
        for dev in ("cuda", "cpu"):
            c = TF.WhisperContext(cfg3, params3, tok_mod.build_vocab(tokens, cfg3.n_vocab),
                                  TF._synthetic_mel_filters(80), n_loaded=1,
                                  dtype=torch.float32, device=dev)
            # audio seed 1: the CPU transcript stays the same when the input is
            # scaled by 1 +- 2^-20, 2^-16 or 2^-13
            r = TF.whisper_full(c, pb, audio(40.0, 1))
            ids[dev] = [[t.id for t in s.tokens] for s in r.segments]
        n_tok = sum(map(len, ids["cuda"]))
        print(f"[10] narrow f32, beam 3: segments {len(ids['cuda'])}, tokens {n_tok}, "
              f"token ids cuda == cpu {ids['cuda'] == ids['cpu']}", flush=True)
        check(ids["cuda"] == ids["cpu"] and n_tok >= 100,
              "narrow f32 beam: cuda and cpu differ, or too few tokens to tell")
        pq = dataclasses.replace(pb, megakernel="int8")
        ctxs = {dev: TF.WhisperContext.from_file(path, dtype=torch.bfloat16, device=dev)
                for dev in ("cuda", "cpu")}
        check(all(c.mega_mode(pq) == "all" for c in ctxs.values()),
              "narrow q8_0: K7 not selected")
        n_equal = 0
        for seed in Q8_BEAM_SEEDS:
            ids = {}
            for dev, c in ctxs.items():
                reset_counts(A, Q, MK)
                r = TF.whisper_full(c, pq, audio(40.0, seed))
                ids[dev] = [t.id for s in r.segments for t in s.tokens]
                if dev == "cuda":
                    check(MK.mega_decode_step_beam.launches > 0
                          and MK.mega_decode_step.launches == 0,
                          "narrow q8_0 beam on cuda did not run K7 alone")
            same = next((i for i, (a, b) in enumerate(zip(ids["cuda"], ids["cpu"])) if a != b),
                        min(len(ids["cuda"]), len(ids["cpu"])))
            print(f"[10] narrow bf16 q8_0, beam 3, megakernel='int8', audio seed {seed}: "
                  f"tokens cuda {len(ids['cuda'])} cpu {len(ids['cpu'])}, equal "
                  f"{ids['cuda'] == ids['cpu']}, equal prefix {same}", flush=True)
            check(ids["cuda"] == ids["cpu"] and ids["cpu"],
                  f"narrow q8_0 beam, audio seed {seed}: cuda (K7) and cpu differ")
            n_equal += len(ids["cpu"])
        print(f"[10] narrow bf16 q8_0 beam: {n_equal} equal tokens over "
              f"{len(Q8_BEAM_SEEDS)} requests", flush=True)
        # K7 alone: the card's beam loop from the CPU's encoder output, on
        # requests long enough for ONE_ENC_TOKENS
        for seed in ONE_ENC_BEAM_SEEDS:
            reset_counts(A, Q, MK)
            one_encoder_output(
                torch, TM, mods.TB.LR, "10", f"narrow bf16 q8_0 beam 3, megakernel='int8', "
                f"{ONE_ENC_BEAM_SECS:.0f} s, audio seed {seed}",
                lambda c, seed=seed: [[t.id for s in TF.whisper_full(
                    c, pq, audio(ONE_ENC_BEAM_SECS, seed)).segments for t in s.tokens]], ctxs,
                k=pq.beam_search.beam_size)
            check(MK.mega_decode_step_beam.launches > 0,
                  "narrow q8_0 beam from one encoder output: no K7")
        done("10")

        # ---- 14 and 20. batched serving at full width: the W8A8 encoder and
        # K8; with int8 cross-KV (K9b) ----
        got = phase_batched(torch, Transcriber, FullParams, mods,
                            tmp / "ggml-large-v3-turbo-q8_0.bin", profiling, done)
        launches.update({k: got[k] for k in ("w8a8_mm", "mega_decode_step_batch")})
        done("14, the rest")

        # ---- 15. narrow batched serving: cuda against cpu ----
        phase_narrow_batched(torch, TF, TM, tok_mod, FullParams, mods, path, tokens)
        done("15")

        # ---- 16. speculative greedy decoding at full width ----
        text = drafts.communicate(timeout=600)[0].decode(errors="replace")
        check(drafts.returncode == 0, f"writing the drafts failed:\n{text[-3000:]}")
        print(f"[6] the two draft checkpoints written by a process of their own, done "
              f"{float(text.split()[-1]):.1f} s after it started (joined "
              f"{time.perf_counter() - t_drafts:.1f} s after)", flush=True)
        launches["mega_decode_step_verify"] = phase_speculative(
            torch, Transcriber, TF, FullParams, mods, tmp)
        done("16")

        # ---- 17. narrow speculative decoding: cuda against cpu ----
        phase_narrow_speculative(torch, TF, FullParams, mods, path, hp, tokens)
        done("17")

        # ---- 22. narrow int8 cross-KV: cuda against cpu ----
        phase_narrow_cross_int8(torch, TF, TM, tok_mod, FullParams, mods, tokens)
        done("22")

        # ---- 25. narrow whisper_full options: cuda against cpu ----
        phase_narrow_options(torch, TF, TM, tok_mod, FullParams, tmp, tokens)
        done("25")

        # ---- 26. SortFormer diarization at the published width ----
        phase_diarize(torch, tmp)
        done("26")

        # ---- 27. narrow diarized transcription: cuda against cpu ----
        phase_narrow_diarize(torch, TF, TM, tok_mod, FullParams, tokens)
        done("27")

        # ---- 28. the server, streaming and the batcher at full width ----
        phase_serving(torch, TF, FullParams, mods, tmp / "ggml-large-v3-turbo-q8_0.bin",
                      tmp / "sortformer-seed0-f16.gguf")
        done("28")

        # ---- 29. narrow streaming and whisper-cli: cuda against cpu ----
        phase_narrow_serving(torch, TF, FullParams, tmp, tokens)
        done("29")

        # ---- 30-35. the LLaMA runtime, talk, the language server, the examples ----
        smi = nvidia_smi_line()
        vocab = spm_vocab()
        phase_llama_full(torch, "30", "Llama-2-7B", vocab, smi)
        done("30")
        phase_llama_card_vs_cpu(torch, vocab, smi)
        done("31")
        phase_llama_full(torch, "32", "TinyLlama-1.1B", vocab, smi)
        done("32")
        ctx_w = phase_talk(torch, TF, mods, tmp / "ggml-large-v3-turbo-q8_0.bin", tmp, vocab,
                           smi)
        done("33")
        phase_lsp(torch, TF, tok_mod, mods, ctx_w, tokens, smi)
        del ctx_w
        done("34")
        phase_narrow_examples(torch, TF, tmp, tokens, smi)
        done("35")

        # ---- 36. multi-GPU serving on one card ----
        phase_mesh(torch, TF, Transcriber, FullParams, tok_mod, mods,
                   tmp / "ggml-large-v3-turbo-q8_0.bin", dense_turbo, smi)
        del dense_turbo
        done("36")
    finally:
        if drafts is not None and drafts.poll() is None:
            drafts.kill()
            drafts.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    launches.update(mxu["launches"])
    head = {"qmm": 0, "qmm_rows": 0, "qmm4": 0, "ffn_int8": 0}   # the row each headline takes
    replaces = {"mha_packed": "open_whisper_kit_tpu/ops/attention.py:70",
                "mega_decode_step": "open_whisper_kit_tpu/ops/decode_megakernel.py:1128",
                "mega_decode_step_verify": "open_whisper_kit_tpu/ops/decode_megakernel.py:1128",
                "mega_decode_step_beam": "open_whisper_kit_tpu/ops/decode_megakernel.py:1309",
                "mega_decode_step_batch": "open_whisper_kit_tpu/ops/decode_megakernel.py:1471",
                "w8a8_mm": "open_whisper_kit_tpu/ops/encoder_int8.py:129",
                "qmm": "open_whisper_kit_tpu/ops/quant_matmul.py:129",
                "qmm_rows": "open_whisper_kit_tpu/ops/quant_matmul.py:129",
                "qmm4": "open_whisper_kit_tpu/ops/quant_matmul.py:280",
                "ffn_int8": "open_whisper_kit_tpu/ops/quant_matmul.py:385",
                "cross_attention_q8": "open_whisper_kit_tpu/ops/experiments.py:155",
                "cross_attention_q8_nat": "open_whisper_kit_tpu/ops/experiments.py:73",
                "mm_bf16": "tools/bench_int8_mxu.py:115",
                "mm_s8": "tools/bench_int8_mxu.py:125"}
    rows = [{"name": "mha_packed", **k1},
            {"name": "mega_decode_step", **k2["all"], "modes": list(k2.values())},
            {"name": "mega_decode_step_verify", **k2v[("all", 5)],
             "modes": list(k2v.values())},
            {"name": "mega_decode_step_beam", **k7[("all", K7_BEAMS)],
             "modes": list(k7.values())},
            {"name": "mega_decode_step_batch", **k8["all"], "modes": list(k8.values())},
            {"name": "w8a8_mm", **next(r for r in k6 if r["shape"].startswith(K6_HEADLINE)),
             "shapes": k6},
            {"name": "cross_attention_q8", **k9["K9b"][0], "shapes": k9["K9b"]},
            {"name": "cross_attention_q8_nat", **k9["K9a"][0], "shapes": k9["K9a"]},
            {"name": "mm_bf16", **mxu["mm_bf16"][0], "shapes": mxu["mm_bf16"]},
            {"name": "mm_s8", **mxu["mm_s8"][0], "shapes": mxu["mm_s8"]}]
    for name, i in head.items():
        rows.append({"name": name, **{k: v for k, v in quant[name][i].items()
                                      if k != "shape"},
                     "shape": quant[name][i]["shape"], "shapes": quant[name]})
    stems = {"mega_decode_step": "mega_step", "mega_decode_step_verify": "mega_step",
             "mega_decode_step_beam": "mega_beam",
             "mega_decode_step_batch": "mega_batch", "w8a8_mm": "w8a8",
             "cross_attention_q8": "cross_q8", "cross_attention_q8_nat": "cross_q8",
             "mm_s8": "w8a8"}
    for r in rows:
        stem = stems.get(r["name"], r["name"])
        r.update(route="cuda", source=SRC + stem + ".cu",
                 replaces=replaces[r["name"]], launches=launches[r["name"]])
        check(r["launches"] > 0, f"{r['name']} never launched on its path")
    print(f"[end] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--write-drafts"]:
        sys.exit(write_drafts_main(sys.argv[2:]))
    try:
        sys.exit(main(profiling="--profile" in sys.argv[1:]))
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
