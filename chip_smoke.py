#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phase NAME ...]

With no argument every phase runs, as below; `--phase NAME` (repeatable;
the names are PHASES' keys, e.g. multi-gpu, lockstep, q8) runs the chosen
phases alone (with the GGUFs and CPU references they need), and prints
the last two lines of a whole run without the kernels line. Since slice
17 the engine, quant-tier, lockstep and beam phases run the full-width
model cut to COMPARE_LAYERS (4) layers (but for two checks that stay at
24), the W8A8 path's and the full utterance's CPU runs are child
processes started with the main path (whose host-clock readings now run
beside them), and the kernel phases time both matmul designs only at
the main paths' rows.

Phases (any failure exits non-zero):
  1. device: the card's name and power limit; no CUDA -> exit 2, no result.
  2. build: the three CUDA kernels from nemotron_tpu_torch/csrc with nvcc,
     one process each, all at once.
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main paths' shapes (all four latency modes, B = 1 and 8, f32 and
     bf16, dense and int8 rings for the attention; M = 1, 14, 112 for the
     Q8 matmul; the W8A8 matmul bit for bit), with the tolerances below;
     repeated calls bit-equal (attention and Q8); times of the kernel, the
     plain version and one PyTorch library call: the attention in every
     mode at B = 1 (f32, dense rings) and at the W8A8 path's B = 8 (bf16,
     int8 rings, R = 13), the Q8 matmul per layer at M = 14 and M = 1, the
     W8A8 matmul per layer at M = 8, 16 and 112 and per call at M = 672;
     the Q8 matmul also at the full-utterance path's M = 17, 257 and 804
     (checked) and per layer at M = 804 (timed). Since slice 11 the Q8
     matmul has two designs (split-K clusters up to M* rows, 128 x 128
     tiles above): checked at M* - 1, M* and M* + 1 besides, repeatable bit
     for bit at M = 896 in both dtypes, checked at the crossover sweep's
     rows M = 16, 32, 64, 128 and 256, and both designs timed per layer
     at M = 804 and 896 through the same entry point (`q8_matmul_as`;
     since slice 17, the sweep's timings are chip_q8_sweep.py's); the
     profiles count Q8
     launches under every kernel name that starts with q8_matmul.
  4. Q8_0 main path (slice 1): a seeded full-width (0.6B) random-weight
     GGUF with Q8_0 encoder matmuls, written with the port's writer, loaded
     with load_model(device="cuda") and streamed through StreamSession
     (f32, one stream) in all four latency modes. Each kernel's launch
     count must match the chunk count, and in the profile of R=13 chunks
     each Q8 call must be one kernel launch (no reduce kernel); the R=13
     tokens must equal the
     port's CPU run of the same session, and the encoder's output over
     enough chunks to wrap the ring, and its caches after them, must agree
     with the CPU.
  5. W8A8 serving tier (slice 2): the same GGUF turned into W8A8 in memory
     (quantize_model_params), streamed in bf16 over 8 streams with int8 K/V
     rings in all four modes (4 s; 2 s at R = 0 and 1), then with the
     shared x-ring at R=13; launch
     counts per chunk; the f32 R=13 session's tokens, encoder output and
     caches against the port's CPU run; bf16 against f32 on the card. In
     the profile of R=13 chunks each W8A8 call must be one kernel launch
     (no quantize or reduce kernel).
  6. full-utterance path (slice 7): the same Q8_0 GGUF, f32, through
     transcribe_batch on 4 seeded utterances of 4, 8, 12 and 16 s (M =
     4 x 201 = 804 rows a matmul): wall, RTF, device busy share, peak
     memory; 240 Q8 launches per encode_batch (wrapper count and profile by
     name); tokens and texts equal to the port's CPU run; the encoder's
     output against the CPU within a tolerance fixed from a control (the
     CPU run against itself under a two-ulp input change); a
     transcribe_batch_with_state chain of two segments equal to the CPU's.
  7. tones cell (slice 7): the trained fixture weights/tones_tiny.gguf (f32,
     Dh = 16) on 8 seeded 15 s tone streams: streaming in all four modes at
     S = 8 and at S = 1 (R = 13), and transcribe_batch of the 8 streams,
     each with token error < 10% against the labels and the port's CPU
     tokens; then W8A8 with int8 K/V (bf16, R = 13, S = 8): its token
     error, its agreement with the f32 card run, chunk ms and RTF.
  8. serving engine (slice 8): the ragged ServingEngine at full width, 64
     slots (48 fed at the real-time rate, 16 at half rate, 8 evicted and
     re-admitted, every slot finalized), 4 s of audio a stream (2 s at
     R = 0 and 1, SHORT_SECONDS): W8A8 + int8 K/V in bf16 with the DSP
     on the device in all four modes (step
     p50/p90 against the mode's shift, aggregate RTF, tokens, peak memory;
     one attention and ten W8A8 launches a layer an encoder step; four
     tracked streams against solo bf16 sessions, >= 95% of token
     positions), a profile of 3 R = 13 ticks; Q8_0 in f32 with host DSP at
     R = 13 (the tracked streams' tokens equal to solo f32 sessions, their
     encoder outputs within the Q8_0 path's card tolerance), its profile;
     8, 64 and 256 slots at R = 13 (W8A8, bf16, device DSP). The kernel
     phase checks and times the new shapes first: attention at B = 64 and
     256, Q8 at M = 896, W8A8 at M = 896 and 3584. Then the trained
     fixtures: tones_tiny.gguf, 8 streams of 15 s at ragged rates through
     the engine in both DSP modes at R = 0 and 13 (tokens equal to solo
     card sessions, a prefix of them with device DSP; token error < 10%),
     and endpointing on tones_tiny_sil.gguf (2 events, each within
     Levenshtein 1 of its labels).
  9. network server (slice 9): an ASRServer (TCP, WebSocket and the HTTP
     sidecar) over a 64-slot ServingEngine with confidence at full width,
     R = 13, driven by 24 TCP and 4 WebSocket clients streaming 2.5 s of
     seeded PCM each at the real-time rate and 4 POST /transcribe
     requests, in two cells: Q8_0 f32 with host DSP (every client's FINAL
     or REST tokens equal to those of the same audio through a directly
     driven engine, and 8 clients' to solo sessions', log-posteriors
     within TOL_CONF_ABS, words equal to tokens_to_words) and W8A8 +
     int8 K/V bf16 with device DSP (8 clients' agreement with solo bf16
     sessions as a reading). Each prints the server tick (net of its wait for the engine
     lock) beside the engine's own step, END->FINAL, first-PARTIAL and REST
     latencies, the device busy share over the whole load (CUPTI covers
     the engine's worker threads) and launches per encoder step by kernel
     name (24 attention, 240 of the matmul). Then the trained fixtures
     through the server: 8 TCP clients of 15 s on tones_tiny.gguf at R = 0
     and 13 (token error < 10%, an SRT from the FINAL words equal to
     write_subtitles of the tokens) and endpointing on tones_tiny_sil.gguf
     (2 UTTERANCE events with words); then the entry points on the card
     against --cpu: the batch CLI with --confidence --srt and the
     streaming CLI with --timestamps --confidence --vtt (subtitle files
     byte-equal, stdout equal up to the {p=...} hundredths), and
     `python -m nemotron_tpu_torch.asr_server` replayed into by
     `python -m nemotron_tpu_torch.asr_client --srt`.
 10. the rest of the quant tiers and snapshots (slice 10). The kernel
     phase holds the attention kernel's int4 mode (packed rings) to its
     plain version at Dh = 128 and 16, B = 1, 8 and 64, every mode, f32
     and bf16 (repeated calls bit-equal), and times it beside int8 at
     B = 8 and 64; and the W8A8 kernel's static mode bit for bit at
     M = 8, 16, 112 and 896 for every (K, N) of a layer, timed per layer
     beside the dynamic mode and _int_mm. Then, on the full-width GGUF:
     SmoothQuant calibrated on the card on 4 s of seeded PCM, w8a8-sq-static
     with int4 rings (bf16, 8 streams) in the four modes (2 s of audio
     at R = 0 and 1, 4 s at 6 and 13, as the W8A8 path's; launches a step
     by name: 24 int4 attention, 240 W8A8), readings against the int8
     dynamic tier and the port's CPU run; --rc-by-layer 13,6,1,0 on Q8_0
     f32 (tokens equal to the CPU's); the 64-slot engine on the new tier
     beside the int8 engine; snapshots on the card (a Q8_0 f32 and a W8A8
     bf16 session resumed bit-equal, the Q8_0 snapshot continued on the
     CPU to the CPU's tokens, the 64-slot engine in both DSP modes resumed
     to every slot's tokens). The tones fixture with int4 (f32) and
     w8a8-sq-static + int4 (bf16): token error < 10%. The streaming CLI
     with --kv-int4, --rc-by-layer and --quantize=w8a8-sq-static --calib
     on the card against --cpu, and asr_server --kv-int4 --rc-by-layer
     replayed into by asr_client.
 11. slice 12: the W8A8 matmul has two designs (split-K clusters up to M*
     rows, 128 x 128 tiles above): the kernel phase holds both to the plain
     versions bit for bit from M = 16 on (M* and M* + 1, 804, 896, 897,
     3584 and the crossover sweep's 32, 64, 96, 128, 288 besides the main
     paths' rows), in both modes and dtypes, checks repeated calls in
     both, and times both designs per layer in both modes at M = 16, 112,
     672, 804, 896 and 3584 (since slice 17) through the same entry point
     (`w8a8_matmul_as`), with torch._int_mm on the [K, N] weight and on a
     column-major copy; the profiles count W8A8 launches under every kernel
     name that starts with w8a8_matmul, and the engine phase profiles the
     256-slot W8A8 engine (M = 3584) beside the 64-slot one.
 12. lockstep serving (slice 13), on the full-width GGUF: the
     LockstepEngine in Q8_0 f32 over 8 streams at R = 13, pipelined (the
     tokens of the real-audio chunks equal to solo f32 sessions); W8A8 +
     int8 K/V bf16 over 64 streams in the four modes beside the 64-slot
     device-DSP ServingEngine on the same audio (tick p50/p90 against the
     mode's limit, RTF, peak GiB, 24 attention and 240 W8A8 launches a
     chunk, two streams against solo bf16 sessions, a profile of 3 R = 13
     ticks) and over 256 streams; CohortScheduler and ServingCohorts (2 x
     32, Q8_0 f32: shared weights by data_ptr, each cohort equal to a solo
     engine); `python -m nemotron_tpu_torch.serve` with --lockstep and
     without.
 13. the RNN-T beam family (slice 14), on the full-width GGUF with its
     prediction side peaked so that the beams emit: K = 1 against greedy
     in the four modes (its log-prob at least the greedy path's, the JAX
     package's gate); a K = 4 Q8_0 f32 session over 8
     R = 13 chunks against the port's CPU run (every hypothesis's score
     within 1e-3, tokens equal but for near-ties, best hypothesis
     non-empty and equal; 24 / 240 launches a chunk); beam_decode with and
     without a label LM under torch.cuda.set_sync_debug_mode("error"); the
     64-slot ServingEngine (K = 4, Q8_0 f32, host and device DSP, ragged)
     and the LockstepEngine (8 streams), their beams held the same way to
     solo K = 4 sessions; readings of
     W8A8 + int8 K/V bf16 K = 4 sessions (S = 8, four modes), the 64-slot
     engine with and without the LM, a 3-tick profile and the beam's own
     device time. Then the trained fixtures against the CPU:
     tones_tiny.gguf with tones_tiny_lm.gguf (K = 4, weight 0.3, 8
     streams) in a session, the 64-slot engine and the lockstep engine,
     transcribe_batch with LM rescoring and 4-best lists,
     asr_server --refine on tones_tiny_sil.gguf and the streaming CLI with
     --boost (greedy, and with --beam --lm).
 14. TDT and CTC decoding (slice 15), on a second seeded full-width GGUF
     with the TDT fixture's durations (0-4) and a CTC head, its heads
     shaped so that the argmaxes have wide margins (shape_tdt_ctc_heads),
     written and decoded on the CPU by a child process while the lockstep
     and beam phases run: Q8_0 f32 S = 1 over 8 chunks in the four modes,
     the TDT walk with confidence and ctc=True, card against CPU (tokens
     with frames, tdt_skip and ctc_prev equal, confidences within 1e-3),
     24 / 240 launches a chunk; the walk chunked against one call over the
     same frames, K = 1 beam against the walk, the host syncs of a chunk;
     the K = 4 TDT beam card against CPU (compare_beams, t and sym equal);
     the 64-slot engine (TDT host DSP, CTC device DSP) and the lockstep
     engine (8 streams) in both families against solo sessions (since
     slice 18 on the 4-layer cut); readings
     of W8A8 + int8 K/V bf16 (S = 8 chunk ms in the four modes, the
     64-slot engine's tick p50 / p90, a profile and the decode's device
     ms for TDT greedy, TDT beam and CTC). Then the trained fixtures
     against the CPU: tones_tiny_tdt.gguf (greedy, and K = 4 with
     tones_tiny_lm.gguf) and tones_tiny_hybrid.gguf with ctc=True over the
     tones streams, asr_server --ctc (READY's decode "ctc", FINAL equal to
     --cpu) and cli_transcribe --ctc against --cpu.
 15. training (slice 16), on dense f32 parameters (no kernel of the port
     launches: the three counts stay 0): the full-width GGUF cut to 2
     layers, loss and every leaf's gradient on a fixed batch (4
     utterances of 4 s, 20 labels each, R = 13's chunked attention)
     against the port's CPU run of the same cut (a child process), and one
     train step; the 24 layers on the card alone: remat against no remat,
     5 steps whose loss falls, step ms with and without remat, peak GiB,
     utterance-seconds trained a second, one step each with the delay
     penalty, TDT (sigma 0.05) and the CTC term on the phase-14 GGUF.
     Then weights/tones_tiny.gguf fine-tuned 30 steps on fresh tones
     batches, saved with save_model and streamed at R = 13 (token error
     < 10%, tokens equal to the CPU's run of the saved file); the tiny
     config trained from scratch for 150 steps (the loss halves); the
     train entry point on the card against --cpu, --checkpoint then
     --resume against an uninterrupted run, its saved GGUF through the
     streaming CLI (card against --cpu), and train_lm (the NLL falls).
 16. multi-GPU (slice 17), at full width: (a) a one-rank NCCL mesh --
     ServingEngine(mesh=) (64 slots, W8A8 + int8 K/V bf16, device DSP,
     R = 13, in turns with the unsharded engine: its tick p50 beside
     it), LockstepEngine(mesh=) (64 streams) and the Q8_0 f32 engine, each
     bit-equal to the unsharded engine in tokens, every state leaf and
     launches; (b) two ranks sharing the card over gloo at model-parallel
     2 -- the Q8_0 f32 engine's tokens equal to (a)'s, encode_chunk within
     4x a two-ulp control, the W8A8 bf16 engine's token counts, a profiled
     tick (24 attention and 240 Q8 launches at the rank's shapes), the
     all_reduce calls and bytes of a tick; (c) data-parallel 2 --
     MultihostLockstep and MultihostServing (32 rows a rank) bit-equal to
     one-process engines of the same rows, a per-rank save / load resume;
     (d) a model-parallel-2 train step on the 2-layer cut against one
     rank; (e) serve --mesh 1 / --mesh 2 / --lockstep --coordinator (two
     processes) and train --model-parallel 2 exit 0 with their summaries.
     The kernel phase checks and times the rank's shapes: attention at
     H = 4 of 8, Q8 at (K, N) = (1024, 2048), (2048, 1024), (1024, 512),
     (512, 1024), W8A8 at the FFN's two. No number here is a multi-GPU
     speed: the machine has one card.
 17. dump tracing, the profiler reader, the native bindings and beam
     decode on a mesh (slice 18, `--phase utils-native`), at full width,
     R = 13: (a) NativeGGUF's views equal to the plain reader's bytes and
     load_model's params equal with and without it; (b) a traced session
     (8 chunks, f32) bit-equal to an untraced one in tokens, state and
     launches, its 28 dump files with their shapes, read_dump round trips;
     (c) `cli --profile=DIR` on the card: step_percentiles counts the
     chunk steps, each with device time, and the trace holds the ring and
     Q8 kernels; (d) ServingEngine(dsp="native") at 16 slots: tokens equal
     to solo native sessions, the native mel within 2e-4 of the numpy
     backend's, the native DSP's ms a tick beside the device DSP's; (e) a
     K = 4 beam engine on a one-rank NCCL mesh bit-equal to the unsharded
     one, and on two gloo ranks sharing the card with its tokens.
 18. the evaluation entry points (slice 19, `--phase eval`), through
     their main(argv): (a) `token_agreement --full` (random weights at the
     published widths, 4 streams, R = 0 and 13), every configuration's
     agreement and flips recorded and its launches counted by ring type
     (dense, int8, int4) and matmul, and the static SmoothQuant W8A8 tier
     on the GGUF's dense weights; (b) `compare_outputs` on the full-width
     Q8_0 GGUF over 9 s (the batch pass above the Q8 kernel's M*: both
     designs launched), its lines equal to the CPU's; (c)
     `token_agreement` on tones_tiny.gguf, `beam_quality`, `lm_quality`,
     `tdt_quality`, `hybrid_quality`, `refine_quality` and
     `emission_delay` on the trained fixtures, each JSON held to its
     --cpu run (a child process): f32 results equal, token_agreement's
     bf16 / int8 tiers within TOL_EVAL_AGREEMENT_PCT / TOL_EVAL_TER_PCT.
     (a) and (c) run on the card in two child processes beside the
     utils-native phase; (b) runs in this process.
 19. the numpy oracle and the parity ladder (slice 20, `--phase
     parity`), through the tools' main(argv): (a) `run_parity --quick` on
     the full-width Q8_0 GGUF (24 layers, dequantized: the oracle's
     weights): load, stages (compare_layers, each stage's max_abs logged),
     greedy (exact tokens) and streaming R=13 PASS, the ring and Q8
     kernels launched; `debug_conv_layers --layer 0` and `--layer 23` with
     no DIFF, `debug_joint_trace --frames 8` with no divergence; (b) a
     NeMo-style .nemo (the same seeded weights cut to 4 layers) through
     convert_to_gguf (f32, q8_0) and convert_weights (.nemo -> bin ->
     gguf), every tensor equal to the checkpoint's (Q8_0: its block
     rounding) and every file equal to the CPU's byte for byte, then
     `run_parity --quick` on the f32 GGUF: stages 1-4 PASS, stage 5's
     agreements (Q8 and W8A8 kernels; dense, int8 and int4 rings) within
     TOL_EVAL_AGREEMENT_PCT of the same ladder with --cpu. (a) and (b) run
     in a child process on the card beside the multi-GPU, utils-native and
     eval phases; (b)'s CPU side in one beside the phases from lockstep on.
 20. one JSON line of kernel results, the card's name and power limit, and
     last the line {"ok": true, "device": {...}}. Each phase prints its
     wall time.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
AUDIO_SECONDS = 4.0
MODES = (0, 1, 6, 13)
# the R = 0 and 1 runs of the four-mode readings (the W8A8 path, the
# engine, the quant tiers, lockstep) take the first SHORT_SECONDS of each
# stream: 25-50 chunks a stream of one kind (lockstep since PR 13, the
# others since PR 15, to keep the script near 950 s)
SHORT_SECONDS = 2.0
# the comparison phases of slices 8, 10, 13 and 14 (the engine, the quant
# tiers and snapshots, lockstep, the beam family: engines held to solo
# sessions, the card held to the CPU) run the full-width model cut to
# COMPARE_LAYERS layers (full width, reduced depth: cut_layers), since
# slice 17, to keep the script within its time with the multi-GPU phase;
# but for two checks the tier's chaos fails at 4 layers (lockstep's W8A8
# streams against solo sessions at R = 13, the beam's card-vs-CPU
# scores), which stay at 24, as do the main paths, the full
# utterance, the server (its time is the engine lock's, not the depth's),
# TDT/CTC and the serve entry points. Four layers keep --rc-by-layer's
# four groups whole.
COMPARE_LAYERS = 4
# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s per type. The
# Q8 and attention kernels run f32 and bf16 on the CUDA cores (FFMA, f32
# accumulation) and the W8A8 kernel its integer product on the tensor cores
# (mma.sync s8). Each bound is the least time the card could take: f32 work
# at the f32 peak, bf16 work at the bf16 tensor-core peak, int8 at the int8
# peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
# Tolerances, kernel vs plain version on the same inputs. f32: the two sum
# the same products in another order, so the gap grows like sqrt(K) ulps of
# the largest partial sum; 4e-6 relative to the largest output covers
# K = 4096 with margin, and 1e-5 absolute holds for attention outputs of
# order 1 (the JAX package's fused-vs-einsum test holds 2e-5). bf16: both
# round the f32 result to bf16, and the rounded value moves by one ulp when
# the f32 sums differ in the last bits; two bf16 ulps (2^-6 relative to the
# largest output) bound it.
TOL_F32_Q8_REL = 4e-6
TOL_F32_ATTN_ABS = 1e-5
TOL_BF16_REL = 2.0 ** -6
# full-width encoder output and caches over n_seg + 2 chunks, card vs CPU:
# 24 layers of f32 arithmetic in different summation orders (cuDNN/cuBLAS
# vs CPU), carried from chunk to chunk through the caches
TOL_ENCODER_ABS = 1e-3
# W8A8 + int8 K/V, card vs CPU, f32, 8 streams, R = 13. The W8A8 kernel
# equals its plain version bit for bit, but int8 rounding turns the
# last-bit differences of the other ops (cuBLAS/cuDNN vs CPU sums, the
# attention kernel) into whole steps: an activation on a rounding boundary
# takes the neighbouring int8 value (1/127 of its row's amax). Over 24
# layers such flips grow to the tier's quantization noise: the port's own
# CPU run departs from itself by 8-9% of max|out| when its input moves by
# two f32 ulps (a control this phase measures), as far as the card departs
# from it (measured on an H100 80GB HBM3 at 700 W). So the checks are:
#  - each layer replayed on the card with the CPU's inputs and caches (ring
#    wrapped): outputs, new K/V, conv cache and the attention input within
#    3e-2 of their max|.| (one layer's flips: up to 1.2e-2 measured there);
#  - the same replay in bf16 against the CPU's f32: within 0.08, the JAX
#    package's own bound for this config (tests/test_quant.py:247-276);
#  - free-running, n_seg + 2 chunks: the card departs from the CPU no more
#    than twice as far as the control does (outputs, conv cache, scales,
#    mean int8 ring step), and bf16 from f32 on the card no more than 0.08
#    of max|out| or, where the control's noise floor is higher, twice the
#    control; valid_len and phase exact;
#  - tokens: every stream agrees position by position in at least 95% of
#    its tokens (the JAX package's bf16 token bound is 5%,
#    tests/test_trained_fixture.py:80-95).
TOL_W8A8_LAYER_REL = 3e-2
TOL_BF16_VS_F32_REL = 0.08
W8A8_CONTROL_FACTOR = 2.0
W8A8_CONTROL_ULPS = 2
TOL_W8A8_TOKEN_AGREE = 0.95
W8A8_STREAMS = 8
# full-utterance path: 4 utterances, the longest 16 s = 201 encoder frames,
# so each encoder matmul takes M = 4 x 201 = 804 rows
FULL_UTT_SECONDS = (4.0, 8.0, 12.0, 16.0)
FULL_UTT_M = 804
# its encoder output, card vs CPU (f32, valid frames, relative to the CPU's
# max|out|): at most FULL_CONTROL_FACTOR times the control, the CPU run's
# departure from itself under a two-ulp input change. Set from the CPU
# before any card reading: the JAX package against the port, both on the
# CPU (another summation order in every op, as the card has), departed 1.1x
# and 1.4x as far as that control at d_model 256 / 4 layers and 512 / 6
# layers (Q8_0, random weights, 2 ragged utterances).
FULL_CONTROL_FACTOR = 4.0
# tones cell: the JAX package's trained-fixture gate
# (tests/test_trained_fixture.py:66-77) on 8 streams
TONES_STREAMS, TONES_SECONDS, TONES_SEED, TONES_N = 8, 15.0, 123, 16
TONES_TER_MAX = 0.10
# serving engine (slice 8): 64 slots, the last 16 fed at half the real-time
# rate, 8 evicted (4 of each rate) and re-admitted a third of the way in;
# 4 s of audio a stream; R = 13 steps run M = 64 x 14 = 896 rows a matmul
ENGINE_SLOTS, ENGINE_HALF, ENGINE_EVICT, ENGINE_SECONDS = 64, 16, 8, 4.0
ENGINE_M = ENGINE_SLOTS * 14
ENGINE_SLOT_COUNTS = (8, 64, 256)
SHIFT_MS = {0: 80, 1: 160, 6: 560, 13: 1120}
# tones cell through the engine: 4 streams at the real-time rate, 3 at half
# rate, 1 admitted late
ENGINE_TONES_HALF, ENGINE_TONES_LATE = (4, 5, 6), 7
# the endpointing audio's two utterances (tones_tiny_sil.gguf)
SIL_LABELS = ([3, 11, 6, 0, 14, 9], [8, 2, 15])
# the network server (slice 9): a 64-slot engine behind an ASRServer, 24 TCP
# and 4 WebSocket clients streaming 2.5 s each at the real-time rate in
# 100 ms blocks (two R = 13 chunks of real audio, then the finalize; 4 s
# up to PR 13, cut to keep the script within its time), and 4 POST
# /transcribe requests of 2.5 s (48, 8 and 8 up to slice 17: each END
# steps the whole slab under the engine lock, so the cell's wall grows
# with the streaming clients; the engine keeps its 64 slots); the
# clients' log-posteriors against solo sessions within the Q8_0 path's
# card tolerance (TOL_ENCODER_ABS)
SERVER_SLOTS, SERVER_TCP, SERVER_WS, SERVER_REST = 64, 24, 4, 4
SERVER_SECONDS = 2.5
TOL_CONF_ABS = 1e-3
# slice 10: the quant tiers and snapshots. SmoothQuant calibrates on 4 s of
# seeded PCM (its own stream, not one the sessions decode); per-layer right
# context as NeMo's lookahead groups; snapshots cut mid-stream, mid-chunk
SQ_CALIB_STREAM, SQ_CALIB_SECONDS = 900, 4.0
RC_BY_LAYER = (13, 6, 1, 0)
SNAPSHOT_CUT = 30_000         # samples into a 4 s stream (R = 13: mid-chunk)
# slice 14: the RNN-T beam family. K hypotheses, expansions a frame, token
# slots a hypothesis; the card-vs-CPU session runs BEAM_CPU_CHUNKS chunks at
# R = 13; scores card vs CPU within TOL_BEAM_SCORE (the Q8_0 path's encoder
# tolerance: a sum of log-probs of joints over encoder outputs that agree
# within it); the lockstep check runs BEAM_LOCK_STREAMS streams
BEAM_K, BEAM_EXPANSIONS, BEAM_MAX_TOKENS = 4, 10, 1024
BEAM_CPU_CHUNKS, BEAM_LOCK_STREAMS = 8, 8
BEAM_LM_WEIGHT = 0.3
TOL_BEAM_SCORE = 1e-3
TONES_NBEST_KW = dict(beam_size=BEAM_K, return_nbest=BEAM_K,
                      lm_weight=BEAM_LM_WEIGHT, lm_rescore=True)
# slice 15: TDT and CTC. A second seeded full-width GGUF with the TDT
# fixture's durations and a CTC head (Q8_0 encoder matmuls). At the seed's
# scale the heads' logits are nearly flat, and the random encoder's output
# is mostly one vector for every frame (its frame-to-frame spread is a fifth
# of its size), so the duration head prefers duration 0 on every frame (no
# jump) and the other argmaxes sit on small margins. Shaped: the rows of
# the TDT_ACTIVE labels, in the token head and the CTC head, scaled by
# TDT_HEAD_SCALE (each argmax falls among them, with wide margins; blank's
# row stays, so labels win: with it scaled too, blank won every frame at
# R = 1 and no token was emitted, PR 15 chip run 1), and duration TDT_JUMP
# biased by TDT_JUMP_BIAS (the walk jumps TDT_JUMP frames and overshoots
# the chunk's end, so the skip carry works; blank jumps are compared on
# the trained TDT fixture). Rehearsed on the CPU at d_model 128, 24
# layers. The LSTM
# stays as it is (PR 14: a scaled 640-wide LSTM is chaotic). The
# card-vs-CPU sessions run TDT_CHUNKS chunks; the W8A8 readings
# TDT_READ_SECONDS of audio a stream.
TDT_DURATIONS = (0, 1, 2, 3, 4)
TDT_ACTIVE = (5, 17, 101, 257, 500, 733, 900, 1001)
TDT_HEAD_SCALE = 8.0
TDT_JUMP, TDT_JUMP_BIAS = 3, 6.0
TDT_CHUNKS = 8
TDT_READ_SECONDS = 2.0
# slice 16: training. The full-width phase trains the seeded GGUF dense on
# a fixed batch of TRAIN_BATCH utterances of TRAIN_SECONDS with TRAIN_LABELS
# labels each, with the chunked attention of R = 13 (TRAIN_CHUNK, its
# chunk_enc_len); its card-vs-CPU check runs a TRAIN_CUT_LAYERS-layer cut
# (full width, reduced depth, to keep the CPU's share short). Loss, card vs
# CPU: f32 sums in another order through two layers and the lattice, 1e-4
# relative; gradients: 1e-3 of each leaf's max |g|. Remat against no remat
# on the card: the same kernels recomputed, the JAX package's own bounds
# (tests/test_training.py::test_remat_gradients_match).
TRAIN_BATCH, TRAIN_SECONDS, TRAIN_LABELS = 4, 4.0, 20
TRAIN_CHUNK = 14
TRAIN_CUT_LAYERS = 2
TRAIN_LR = 5e-5
TRAIN_STEPS, TRAIN_REMAT_STEPS = 5, 3
TOL_TRAIN_LOSS_REL, TOL_TRAIN_GRAD_REL = 1e-4, 1e-3
TOL_REMAT_LOSS_REL, TOL_REMAT_GRAD_REL, TOL_REMAT_GRAD_ABS = 1e-6, 1e-4, 1e-6
# the fine-tune of the tones fixture (the recipe's sampler, warm-up
# history 192), the entry points' runs and the tiny model trained from
# scratch (no warm-up history: its 64-192 extra LSTM steps a batch set the
# step's time, and these runs check the entry points, not the stream
# behaviour the history trains)
FT_STEPS, FT_BATCH, FT_LR = 30, 8, 1e-5
ENTRY_VAL = 16
SCRATCH_STEPS = 150
SCRATCH_FLAGS = ["--lr", "1e-3", "--batch", "8", "--history-max", "0",
                 "--utt-tones", "8", "--val", "8"]
# the device the training phases run on (a CPU rehearsal of the phases
# sets "cpu" and stubs torch.cuda's synchronize and memory calls)
CARD = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def time_calls(calls, iters: int, replays: int = 5) -> float:
    """Mean device ms per call over `iters` calls cycling through `calls`
    (distinct buffers, so the working set exceeds the 50 MB L2 cache as on
    the main path). The calls are captured into one CUDA graph and the
    graph is replayed between CUDA events, so the host's Python and launch
    overhead is out of the time."""
    import torch

    for c in calls:                      # warm-up: build, allocate, cache
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


# a profile window waits this long after it opens before the work it
# measures starts: CUPTI lost, in bursts of consecutive windows, the
# records of kernels that ran in the first milliseconds of a window, and
# none of a kernel started 20 ms in (chip_profile_probe.py; PERF.md
# section 7)
PROFILE_HEAD_S = 0.02


def profile_window(fn) -> dict:
    """Device time and launch count by kernel name and the device's busy
    share over one call of `fn`, from torch.profiler (CUPTI). Kernels run
    on one stream, so the sum of their durations is the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_HEAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return profile_summary(prof, wall_us)


def profile_summary(prof, wall_us: float) -> dict:
    """Device time and launches by kernel name, and the busy time, of a
    finished torch.profiler run over `wall_us` of wall time, user
    annotations on the device timeline (record_function ranges such as
    the optimizer's step) left out. Reads the raw activity records
    (`prof.events()` would build an event tree first, a minute for a few
    hundred thousand launches)."""
    from torch.autograd import DeviceType

    raw_ns: dict[str, int] = {}
    raw_n: dict[str, int] = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", bool)()):
            raw = e.name()
            raw_ns[raw] = raw_ns.get(raw, 0) + e.duration_ns()
            raw_n[raw] = raw_n.get(raw, 0) + 1
    by_name: dict[str, float] = {}
    count: dict[str, int] = {}
    for raw, ns in raw_ns.items():
        name = raw.replace("(anonymous namespace)::", "")
        if name.endswith(")"):                  # drop the parameter list
            name = name.rsplit("(", 1)[0]
        name = name.removeprefix("void ")[:100]
        by_name[name] = by_name.get(name, 0.0) + ns / 1e3
        count[name] = count.get(name, 0) + raw_n[raw]
    busy_us = sum(by_name.values())
    return dict(wall_us=wall_us, busy_us=busy_us, count=count,
                by_name=sorted(by_name.items(), key=lambda kv: -kv[1]))


def launches_of(prof: dict, prefix: str) -> int:
    """Kernel launches in a profile whose names start with `prefix`."""
    return sum(n for name, n in prof["count"].items()
               if name.startswith(prefix))


def kernel_counts() -> dict:
    """Each kernel wrapper's launch count."""
    from nemotron_tpu_torch.ops.quant_kernel import q8_matmul
    from nemotron_tpu_torch.ops.ring_attn_kernel import fused_ring_attention
    from nemotron_tpu_torch.ops.w8a8_kernel import w8a8_matmul

    return {"attn": fused_ring_attention.launches, "q8": q8_matmul.launches,
            "w8a8": w8a8_matmul.launches}


def reset_counts() -> None:
    from nemotron_tpu_torch.ops.quant_kernel import q8_matmul
    from nemotron_tpu_torch.ops.ring_attn_kernel import fused_ring_attention
    from nemotron_tpu_torch.ops.w8a8_kernel import w8a8_matmul

    for fn in (fused_ring_attention, q8_matmul, w8a8_matmul):
        fn.launches = 0


def counted(fn, launches: dict):
    """fn() with every kernel count set to 0 just before it and read just
    after it; the counts are added to `launches`. Returns (fn's result,
    the counts)."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    r = fn()
    torch.cuda.synchronize()
    n = kernel_counts()
    for k in launches:
        launches[k] += n[k]
    return r, n


def check(name: str, err: float, tol: float, failures: list) -> None:
    ok = err <= tol
    if not ok:
        failures.append(f"{name}: max_abs_err {err:.3e} > tol {tol:.3e}")
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e}) "
        f"{'ok' if ok else 'FAIL'}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_phase(failures: list) -> dict:
    import torch
    import torch.nn.functional as F

    from nemotron_tpu_torch.config import CacheConfig, ModelConfig
    from nemotron_tpu_torch.ops.ring_attn_kernel import (fused_ring_attention,
                                                         pack_int4,
                                                         ring_attention_ref)

    cfg = ModelConfig()
    L, H, Dh = cfg.n_layers, cfg.n_heads, cfg.d_head
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(B, Q, KV, dt, ring_dt, n_stacks=1, dh=Dh, H=H):
        """ring_dt: the compute dtype, torch.int8, or "int4" (packed); H:
        the heads (a model-parallel rank's share)."""
        def rn(*s):
            return torch.randn(*s, device="cuda", generator=g).to(dt)
        if ring_dt in (torch.int8, "int4"):
            # values uniform over the int range; column scales of an
            # amax/qmax size, so that the dequantized K/V are O(1) and the
            # ring carries most of the output
            qmax, col = (127, 0.02) if ring_dt == torch.int8 else (7, 0.3)

            def ring():
                r = torch.randint(-qmax, qmax + 1, (L, B, H, KV, dh),
                                  device="cuda", generator=g,
                                  dtype=torch.int8)
                return r if qmax == 127 else pack_int4(r)
            kc = torch.rand(B, H, KV, device="cuda", generator=g) * col
            vc = torch.rand(B, H, KV, device="cuda", generator=g) * col
        else:
            def ring():
                return rn(L, B, H, KV, dh)
            kc = torch.ones(B, H, KV, device="cuda")
            vc = torch.ones(B, H, KV, device="cuda")
        return dict(q_u=rn(B, H, Q, dh), k_new=rn(B, H, Q, dh),
                    v_new=rn(B, H, Q, dh),
                    rings=[(ring(), ring()) for _ in range(n_stacks)],
                    a=rn(B, H, Q, KV + Q), k_cols=kc, v_cols=vc,
                    int4=ring_dt == "int4")

    def run(fn, x, layer, stack=0):
        k_all, v_all = x["rings"][stack]
        return fn(layer, x["q_u"], x["k_new"], x["v_new"], k_all, v_all,
                  x["a"], x["k_cols"], x["v_cols"], packed_int4=x["int4"])

    def swap_nibbles(p):
        """Packed int4 bytes with their nibbles exchanged: what a kernel
        that unpacked the pairs in the wrong order would read."""
        v = p.to(torch.int32) & 0xFF
        return (((v & 0xF) << 4) | (v >> 4)).to(torch.uint8).view(torch.int8)

    log("phase kernels: fused_ring_attention vs ring_attention_ref")
    for R in MODES:
        cc = CacheConfig(att_right_context=R)
        Q, KV = cc.chunk_enc_len, cc.kv_len
        for B in (1, 8):
            for dt in (torch.float32, torch.bfloat16):
                for ring_dt in (dt, torch.int8):
                    x = inputs(B, Q, KV, dt, ring_dt)
                    got = run(fused_ring_attention, x, L - 1)
                    want = run(ring_attention_ref, x, L - 1)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    scale = want.float().abs().max().item()
                    tol = (TOL_F32_ATTN_ABS if dt == torch.float32
                           else TOL_BF16_REL * max(scale, 1.0))
                    check(f"attn R={R} Q={Q} KV={KV} B={B} {str(dt)[6:]} "
                          f"ring={str(ring_dt)[6:]}", err, tol, failures)

    # the serving engine's slot counts (slice 8): B = 64 and 256 at R = 13
    cc = CacheConfig(att_right_context=13)
    for B in ENGINE_SLOT_COUNTS[1:]:
        for dt, ring_dt in ((torch.float32, torch.float32),
                            (torch.bfloat16, torch.int8)):
            x = inputs(B, cc.chunk_enc_len, cc.kv_len, dt, ring_dt)
            got = run(fused_ring_attention, x, L - 1)
            want = run(ring_attention_ref, x, L - 1)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            tol = (TOL_F32_ATTN_ABS if dt == torch.float32
                   else TOL_BF16_REL * max(scale, 1.0))
            check(f"attn R=13 B={B} {str(dt)[6:]} ring={str(ring_dt)[6:]} "
                  f"(engine slots)", err, tol, failures)
            del x, got, want

    # slice 17: a model-parallel-2 rank's heads (H = 4 of 8) at the
    # engine's 64 slots, R = 13: f32 dense rings (the Q8_0 engine) and bf16
    # int8 rings (the W8A8 tier)
    for dt, ring_dt in ((torch.float32, torch.float32),
                        (torch.bfloat16, torch.int8)):
        x = inputs(ENGINE_SLOTS, cc.chunk_enc_len, cc.kv_len, dt, ring_dt,
                   H=H // 2)
        got = run(fused_ring_attention, x, L - 1)
        want = run(ring_attention_ref, x, L - 1)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = (TOL_F32_ATTN_ABS if dt == torch.float32
               else TOL_BF16_REL * max(scale, 1.0))
        check(f"attn R=13 B={ENGINE_SLOTS} H={H // 2} {str(dt)[6:]} "
              f"ring={str(ring_dt)[6:]} (a model-parallel-2 rank)", err, tol,
              failures)
        del x, got, want

    # determinism: the same inputs give the same bits (no atomics)
    for B, dt, ring_dt in ((1, torch.float32, torch.float32),
                           (8, torch.bfloat16, torch.int8)):
        x = inputs(B, 14, 84, dt, ring_dt)
        first = run(fused_ring_attention, x, L - 1)
        same = all(torch.equal(run(fused_ring_attention, x, L - 1), first)
                   for _ in range(3))
        log(f"  attn B={B} {str(dt)[6:]} ring={str(ring_dt)[6:]}: repeated "
            f"calls bit-equal: {same}")
        if not same:
            failures.append(f"attn B={B} {str(dt)[6:]}: not deterministic")

    # slice 10: packed int4 rings, at the full model's Dh = 128 and the
    # trained tones fixture's Dh = 16 (8-byte rows), in every mode, at the
    # session's, the W8A8 path's and the engine's stream counts
    log("phase kernels: fused_ring_attention over int4 rings vs "
        "ring_attention_ref")
    for dh in (128, 16):
        for R in MODES:
            cc = CacheConfig(att_right_context=R)
            Q, KV = cc.chunk_enc_len, cc.kv_len
            for B in (1, 8, 64):
                for dt in (torch.float32, torch.bfloat16):
                    x = inputs(B, Q, KV, dt, "int4", dh=dh)
                    got = run(fused_ring_attention, x, L - 1)
                    want = run(ring_attention_ref, x, L - 1)
                    again = run(fused_ring_attention, x, L - 1)
                    # the check must see a nibble-order fault: the plain
                    # version over nibble-swapped rings misses the kernel
                    x["rings"] = [tuple(swap_nibbles(r) for r in x["rings"][0])]
                    wrong = run(ring_attention_ref, x, L - 1)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    err_swap = (got.float() - wrong.float()).abs().max().item()
                    scale = want.float().abs().max().item()
                    tol = (TOL_F32_ATTN_ABS if dt == torch.float32
                           else TOL_BF16_REL * max(scale, 1.0))
                    name = f"attn int4 Dh={dh} R={R} B={B} {str(dt)[6:]}"
                    check(name, err, tol, failures)
                    if not torch.equal(got, again):
                        failures.append(f"{name}: not deterministic")
                    log(f"  {name}: nibble-swapped rings miss by "
                        f"{err_swap:.3e} ({err_swap / tol:.1f}x tol)")
                    if not err_swap > tol:
                        failures.append(f"{name}: nibble-swapped rings within "
                                        f"tol ({err_swap:.3e})")
                    del x, got, want, again, wrong

    def timed(R, B, dt, ring_dt, with_library, n_stacks=8, iters=2000,
              H=H):
        cc = CacheConfig(att_right_context=R)
        Q, KV = cc.chunk_enc_len, cc.kv_len
        x = inputs(B, Q, KV, dt, ring_dt, n_stacks=n_stacks, H=H)
        pairs = [(run(fused_ring_attention, x, l, s).float(),
                  run(ring_attention_ref, x, l, s).float())
                 for s in range(n_stacks) for l in (0, L - 1)]
        err = max((g - w).abs().max().item() for g, w in pairs)
        tol = (TOL_F32_ATTN_ABS if dt == torch.float32 else TOL_BF16_REL
               * max(max(w.abs().max().item() for _, w in pairs), 1.0))
        del pairs
        calls = [lambda s=s, l=l: run(fused_ring_attention, x, l, s)
                 for s in range(n_stacks) for l in range(L)]
        plain = [lambda s=s, l=l: run(ring_attention_ref, x, l, s)
                 for s in range(n_stacks) for l in range(L)]
        ms = time_calls(calls, iters)
        plain_ms = time_calls(plain, 200)
        lib_ms = None
        if with_library:
            # library yardstick: SDPA over the concatenated dense K/V with
            # the additive mask a (the same function for dense rings)
            kcat = [[torch.cat([x["rings"][s][0][l], x["k_new"]], dim=2)
                     for l in range(L)] for s in range(n_stacks)]
            vcat = [[torch.cat([x["rings"][s][1][l], x["v_new"]], dim=2)
                     for l in range(L)] for s in range(n_stacks)]
            lib = [lambda s=s, l=l: F.scaled_dot_product_attention(
                x["q_u"], kcat[s][l], vcat[s][l], attn_mask=x["a"],
                scale=1.0 / math.sqrt(Dh))
                for s in range(n_stacks) for l in range(L)]
            lib_ms = time_calls(lib, iters)
        es = x["q_u"].element_size()
        ring_row = x["rings"][0][0].element_size() * x["rings"][0][0].shape[-1]
        nbytes = (es * (4 * B * H * Q * Dh + B * H * Q * (KV + Q))
                  + ring_row * 2 * B * H * KV + 4 * 2 * B * H * KV)
        flops = 2 * 2 * B * H * Q * (KV + Q) * Dh
        peak = PEAK_FLOPS[str(dt)[6:]]
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
        r = dict(Q=Q, KV=KV, B=B, H=H, ms=ms, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=bound_ms, bytes=nbytes,
                 flops=flops, max_abs_err=err,
                 bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                           >= flops / peak else "operations"))
        lib_txt = f"sdpa {lib_ms * 1e3:.2f} us, " if with_library else ""
        ring_name = ring_dt if isinstance(ring_dt, str) else str(ring_dt)[6:]
        log(f"  R={R} Q={Q} KV={KV} B={B} H={H} {str(dt)[6:]} ring="
            f"{ring_name}: kernel {ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us, {lib_txt}bound {bound_ms * 1e3:.3f} us "
            f"({nbytes} B, {flops} FLOP), err {err:.2e}")
        if err > tol:
            failures.append(f"attn timing inputs R={R} B={B}: err {err:.3e}")
        return r

    # times at the main paths' shapes: the Q8_0 path's (one stream, f32,
    # dense rings, every mode) and the W8A8 path's (8 streams, bf16, int8
    # rings, R = 13; no library call computes it)
    log("phase kernels: fused_ring_attention times (8 ring stacks x 24 "
        "layers cycled, beyond L2)")
    per_mode = {R: timed(R, 1, torch.float32, torch.float32, True)
                for R in MODES}
    per_mode["w8a8"] = timed(13, 8, torch.bfloat16, torch.int8, False)
    # the serving engine's 64 slots (one ring stack of 24 layers is 0.26
    # GB in int8, 1.06 GB in f32: beyond L2 without more stacks)
    B = ENGINE_SLOTS
    per_mode["engine_w8a8"] = timed(13, B, torch.bfloat16, torch.int8, False,
                                    n_stacks=1, iters=480)
    per_mode["engine_f32"] = timed(13, B, torch.float32, torch.float32, True,
                                   n_stacks=1, iters=480)
    # slice 10: int4 rings beside int8 at the W8A8 path's and the engine's
    # stream counts (no library call computes either)
    per_mode["int4"] = timed(13, 8, torch.bfloat16, "int4", False)
    per_mode["engine_int4"] = timed(13, B, torch.bfloat16, "int4", False,
                                    n_stacks=1, iters=480)
    # slice 17: a model-parallel-2 rank's 4 heads at the engine's 64 slots,
    # f32 dense rings (the Q8_0 engine over two ranks; two stacks of 0.53
    # GB exceed L2)
    per_mode["mp2_f32"] = timed(13, B, torch.float32, torch.float32, True,
                                n_stacks=2, iters=480, H=H // 2)
    return per_mode


Q8_SHAPES = {(1024, 1024): 5, (1024, 4096): 2, (4096, 1024): 2,
             (1024, 2048): 1}   # (K, N): calls per layer (q/k/v/out/pw2,
#                                  ffn w1 x2, ffn w2 x2, pw1)


# slice 17: a model-parallel-2 rank's (K, N) at full width: the FFN's w1
# and w2 split along N and K, the attention's q/k/v/pos along N and
# attn_out along K (the conv module stays whole)
LOCAL_SHAPES = {(1024, 2048): "w1", (2048, 1024): "w2",
                (1024, 512): "q/k/v/pos", (512, 1024): "attn_out"}
# the W8A8 tier splits the FFNs only: attn_out's local K (512) would take
# its own activation groups, not the whole weight's 1024 (parallel/mesh.py)
W8A8_LOCAL_SHAPES = {(1024, 2048): "w1", (2048, 1024): "w2"}


# the rows where both designs of the Q8 kernel are timed: the full
# utterance and the 64-slot engine (the crossover sweep at M = 16-256,
# which fixed M* = 96, is timed by chip_q8_sweep.py, no longer here; its
# rows are still checked against the plain version: Q8_SWEEP_MS)
Q8_CROSSOVER_MS = (FULL_UTT_M, ENGINE_M)
Q8_SWEEP_MS = (16, 32, 64, 128, 256)


def q8_phase(failures: list) -> dict:
    import torch

    from nemotron_tpu_torch.ops.quant_kernel import (SPLITK_MAX_M,
                                                     q8_launch_geometry,
                                                     q8_matmul, q8_matmul_as,
                                                     q8_matmul_ref, sm_count,
                                                     splitk_geometry,
                                                     tiled_geometry)

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    sms = sm_count(torch.device("cuda"))

    def weights(K, N, n=1):
        return [(torch.randint(-127, 128, (K, N), device="cuda", generator=g,
                               dtype=torch.int8),
                 torch.rand(K // 32, N, device="cuda", generator=g) * 1e-3)
                for _ in range(n)]

    # the skinny design up to M* = SPLITK_MAX_M rows, the tiled one above:
    # both sides of M*, the streaming step's rows, the full-utterance and
    # engine batches, ragged tiles (17, 257), the crossover sweep's rows
    log(f"phase kernels: q8_matmul vs q8_matmul_ref (M* = {SPLITK_MAX_M})")
    star = SPLITK_MAX_M
    for M in (1, 14, 112, 17, 257, FULL_UTT_M, ENGINE_M, star - 1, star,
              star + 1, *Q8_SWEEP_MS):
        for (K, N) in Q8_SHAPES:
            design = q8_launch_geometry(M, K, N, sms).design
            for dt in (torch.float32, torch.bfloat16):
                (q, s), = weights(K, N)
                x = torch.randn(M, K, device="cuda", generator=g).to(dt)
                got = q8_matmul(x, q, s)
                want = q8_matmul_ref(x, q, s)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                tol = (TOL_F32_Q8_REL if dt == torch.float32
                       else TOL_BF16_REL) * scale
                check(f"q8 M={M} K={K} N={N} {str(dt)[6:]} {design}", err,
                      tol, failures)

    # slice 17: a model-parallel-2 rank's shapes at the session's, 8
    # streams' and the engine's rows
    for M in (14, 112, ENGINE_M):
        for (K, N), what in LOCAL_SHAPES.items():
            for dt in (torch.float32, torch.bfloat16):
                (q, s), = weights(K, N)
                x = torch.randn(M, K, device="cuda", generator=g).to(dt)
                err = (q8_matmul(x, q, s).float()
                       - q8_matmul_ref(x, q, s).float()).abs().max().item()
                scale = q8_matmul_ref(x, q, s).float().abs().max().item()
                tol = (TOL_F32_Q8_REL if dt == torch.float32
                       else TOL_BF16_REL) * scale
                check(f"q8 M={M} K={K} N={N} {str(dt)[6:]} (a "
                      f"model-parallel-2 rank's {what})", err, tol, failures)

    # determinism: the same inputs give the same bits (no atomics), in both
    # designs (the engine's M = 896 splits K over clusters of 4)
    for M, (K, N) in ((14, (4096, 1024)), (1, (1024, 4096)),
                      (ENGINE_M, (1024, 1024)), (ENGINE_M, (4096, 1024))):
        for dt in (torch.float32, torch.bfloat16):
            (q, s), = weights(K, N)
            x = torch.randn(M, K, device="cuda", generator=g).to(dt)
            first = q8_matmul(x, q, s)
            same = all(torch.equal(q8_matmul(x, q, s), first)
                       for _ in range(3))
            log(f"  q8 M={M} K={K} N={N} {str(dt)[6:]} "
                f"{q8_launch_geometry(M, K, N, sms)}: repeated calls "
                f"bit-equal: {same}")
            if not same:
                failures.append(f"q8 M={M} K={K} N={N}: not deterministic")

    # times at the main paths' shapes: M = 14 rows (one stream, R=13), M = 1
    # (R=0), the full-utterance batch's M = 804 and the 64-slot engine's
    # M = 896, f32; enough weight copies to exceed L2 as a chunk does. At
    # the crossover rows both designs, through the same entry point
    log("phase kernels: q8_matmul times (f32; weights cycled beyond L2)")
    out = {}
    timed_shapes = [(M, K, N) for M in sorted({1, 14, *Q8_CROSSOVER_MS})
                    for (K, N) in Q8_SHAPES]
    # slice 17: the model-parallel-2 rank's shapes at the engine's rows
    timed_shapes += [(ENGINE_M, K, N) for (K, N) in LOCAL_SHAPES
                     if (K, N) not in Q8_SHAPES]
    for M, K, N in timed_shapes:
        iters = 500 if M <= 16 else 100
        n = max(2, (192 << 20) // (K * N))
        ws = weights(K, N, n)
        x = torch.randn(M, K, device="cuda", generator=g)
        own = q8_launch_geometry(M, K, N, sms)
        geos = {"splitk": splitk_geometry(M, K, N, sms)}
        if M in Q8_CROSSOVER_MS:
            geos["tiled"] = tiled_geometry(M, K, N, sms)
        err = max((q8_matmul(x, q, s) - q8_matmul_ref(x, q, s))
                  .abs().max().item() for q, s in ws[:4])
        dense = [(q.float().reshape(K // 32, 32, N)
                  * s[:, None, :]).reshape(K, N) for q, s in ws[:8]]
        design_ms = {d: time_calls([lambda q=q, s=s, geo=geo:
                                    q8_matmul_as(x, q, s, geo)
                                    for q, s in ws], iters)
                     for d, geo in geos.items()}
        plain_ms = time_calls([lambda q=q, s=s: q8_matmul_ref(x, q, s)
                               for q, s in ws[:8]], 100)
        lib_ms = time_calls([lambda w=w: torch.matmul(x, w)
                             for w in dense], iters)
        nbytes = M * K * 4 + K * N + (K // 32) * N * 4 + M * N * 4
        flops = 2 * M * K * N
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS["float32"]
        out[(M, K, N)] = dict(ms=design_ms[own.design], design=own.design,
                              split=own.split, plain_ms=plain_ms,
                              library_ms=lib_ms,
                              bound_ms=max(t_bytes, t_ops) * 1e3,
                              bytes=nbytes, flops=flops, max_abs_err=err,
                              bound_by="bytes" if t_bytes >= t_ops
                              else "operations")
        out[(M, K, N)] |= {f"{d}_ms": v for d, v in design_ms.items()}
        log(f"  M={M} K={K} N={N}: kernel {design_ms[own.design] * 1e3:.2f}"
            f" us ({own.design}, split {own.split}"
            + "".join(f"; {d} {v * 1e3:.2f} us" for d, v in
                      design_ms.items() if len(design_ms) > 1)
            + f"), plain {plain_ms * 1e3:.2f} us, matmul "
            f"{lib_ms * 1e3:.2f} us, bound {max(t_bytes, t_ops) * 1e6:.3f}"
            f" us, err {err:.2e}")
        if err > TOL_F32_Q8_REL * 64:
            failures.append(f"q8 timing inputs M={M} K={K} N={N}")
        del ws, dense
    for M in Q8_CROSSOVER_MS:
        layer = {d: sum(out[(M, K, N)][f"{d}_ms"] * c
                        for (K, N), c in Q8_SHAPES.items())
                 for d in ("splitk", "tiled")}
        log(f"  crossover M={M}, one layer: splitk {layer['splitk'] * 1e3:.2f}"
            f" us, tiled {layer['tiled'] * 1e3:.2f} us; the geometry takes "
            f"{'splitk' if M <= SPLITK_MAX_M else 'tiled'}")
    return out


def quantize_rows(x):
    """int8 activations, one scale per row (the library yardstick's input)."""
    import torch

    xf = x.float()
    s = xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)


def static_scale(x):
    """A static activation scale as SmoothQuant's calibration gives it (the
    calibrated amax / 127), set at 80% of this input's amax so that the
    largest values saturate: one f32 value on the card."""
    return (x.float().abs().amax() * 0.8 / 127.0).reshape(1)[0].contiguous()


# the rows where both designs of the W8A8 kernel are timed per layer in
# both modes: the streaming rows of 1-8 streams, the shared x-ring (672),
# the full-utterance batch, the 64- and 256-slot engines (the crossover
# sweep at M = 32-288 and the tiled splits at M = 896, which fixed M* =
# 256 and the split, are no longer timed; the sweep's rows are still
# checked bit for bit: W8A8_SWEEP_MS)
W8A8_CROSSOVER_MS = (16, 112, 672, FULL_UTT_M, ENGINE_M,
                     ENGINE_SLOT_COUNTS[-1] * 14)
W8A8_SWEEP_MS = (32, 64, 96, 128, 288)


def w8a8_phase(failures: list) -> dict:
    import torch

    from nemotron_tpu_torch.ops.quant_kernel import sm_count
    from nemotron_tpu_torch.ops.w8a8_kernel import (SPLITK_MAX_M,
                                                    splitk_geometry,
                                                    tiled_geometry,
                                                    tiled_takes,
                                                    w8a8_launch_geometry,
                                                    w8a8_matmul,
                                                    w8a8_matmul_as,
                                                    w8a8_matmul_ref,
                                                    w8a8_matmul_static_ref)

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    sms = sm_count(torch.device("cuda"))
    star = SPLITK_MAX_M

    def weights(K, N, n=1):
        return [(torch.randint(-127, 128, (K, N), device="cuda", generator=g,
                               dtype=torch.int8),
                 torch.rand(N, device="cuda", generator=g) * 1e-2 + 1e-4)
                for _ in range(n)]

    def act(M, K, dt):
        # rows of unequal scale, as the activations of the encoder
        scale = torch.rand(M, 1, device="cuda", generator=g) * 3 + 0.1
        return (torch.randn(M, K, device="cuda", generator=g) * scale).to(dt)

    def designs(M, K, N, xsize):
        """The launch's own geometry and, from 16 rows on where the tiled
        design takes K, the other design's."""
        own = w8a8_launch_geometry(M, K, N, sms, xsize)
        geos = {own.design: own}
        if M >= 16 and tiled_takes(K):
            geos.setdefault("splitk", splitk_geometry(M, K, N, sms, xsize))
            geos.setdefault("tiled", tiled_geometry(M, K, N, sms))
        return own, geos

    def exact(got, want):
        err = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, want) and not err > 0:
            err = float("inf")          # a NaN or a signed zero differs
        return err

    # the skinny design up to M* = SPLITK_MAX_M rows, the tiled one above:
    # both designs at every M from 16 rows on, both modes (the static scale
    # saturates the largest rows), both dtypes, bit for bit
    log(f"phase kernels: w8a8_matmul vs its plain versions, bit for bit, "
        f"both designs from M = 16 (M* = {star})")
    worst = 0.0
    checks = [(M, K, N) for M in (1, 8, 16, 56, 112, star, star + 1, 672,
                                  FULL_UTT_M, ENGINE_M, ENGINE_M + 1,
                                  ENGINE_SLOT_COUNTS[-1] * 14,
                                  *W8A8_SWEEP_MS)
              for (K, N) in Q8_SHAPES] + [(3, 96, 56), (900, 96, 56),
                                          (900, 512, 56)]
    # slice 17: a model-parallel-2 rank's FFN shapes
    checks += [(M, K, N) for M in (8, 112, ENGINE_M)
               for (K, N) in W8A8_LOCAL_SHAPES if (K, N) not in Q8_SHAPES]
    for M, K, N in checks:
        for dt in (torch.float32, torch.bfloat16):
            (q, cs), = weights(K, N)
            x = act(M, K, dt)
            s_act = static_scale(x)
            want = w8a8_matmul_ref(x, q, cs)
            want_s = w8a8_matmul_static_ref(x, q, cs, s_act)
            own, geos = designs(M, K, N, x.element_size())
            errs = {}
            got = w8a8_matmul(x, q, cs)
            errs[f"{own.design} (own)"] = exact(got, want)
            errs[f"{own.design} (own) static"] = exact(
                w8a8_matmul(x, q, cs, s_act), want_s)
            for d, geo in geos.items():
                if d != own.design:
                    errs[d] = exact(w8a8_matmul_as(x, q, cs, None, geo), want)
                    errs[f"{d} static"] = exact(
                        w8a8_matmul_as(x, q, cs, s_act, geo), want_s)
            torch.cuda.synchronize()
            err = max(errs.values())
            worst = max(worst, err)
            check(f"w8a8 M={M} K={K} N={N} {str(dt)[6:]} "
                  f"[{', '.join(errs)}]", err, 0.0, failures)

    # determinism: the same inputs give the same bits (no atomics), in both
    # designs (the engine's M = 896 splits K over clusters)
    for M, (K, N) in ((8, (4096, 1024)), (ENGINE_M, (1024, 1024)),
                      (ENGINE_M, (4096, 1024))):
        (q, cs), = weights(K, N)
        x = act(M, K, torch.bfloat16)
        for d, geo in designs(M, K, N, 2)[1].items():
            first = w8a8_matmul_as(x, q, cs, None, geo)
            same = all(torch.equal(w8a8_matmul_as(x, q, cs, None, geo), first)
                       for _ in range(3))
            log(f"  w8a8 M={M} K={K} N={N} bf16 {geo}: repeated calls "
                f"bit-equal: {same}")
            if not same:
                failures.append(f"w8a8 M={M} K={K} N={N} {d}: not "
                                f"deterministic")

    # times at the main paths' shapes, bf16 activations (the serving
    # dtype), enough weight copies to exceed L2 as a chunk does: M = 8
    # (8 streams, R = 0), then the crossover rows with both designs through
    # the same entry point, in both modes. The library yardstick is
    # torch._int_mm on the pre-quantized activation (no quantize or
    # rescale; rows padded to 32 below M = 17), on the port's [K, N] weight
    # and on a column-major copy; library_ms is the faster of the two.
    log("phase kernels: w8a8_matmul times (bf16; weights cycled beyond L2; "
        "library = torch._int_mm on the pre-quantized activation, on the "
        "[K, N] weight and on a column-major copy)")
    out = {}
    plain_rows = (8, 16, 112, 672, ENGINE_M, ENGINE_SLOT_COUNTS[-1] * 14)
    timed_shapes = [(M, K, N) for M in (8, *W8A8_CROSSOVER_MS)
                    for (K, N) in Q8_SHAPES]
    # slice 17: the model-parallel-2 rank's FFN shapes at the engine's rows
    timed_shapes += [(ENGINE_M, K, N) for (K, N) in W8A8_LOCAL_SHAPES
                     if (K, N) not in Q8_SHAPES]
    for M, K, N in timed_shapes:
        iters = 500 if M <= 16 else 200 if M <= 256 else 100 if M <= 1000 \
            else 30
        n = max(2, (192 << 20) // (K * N))
        ws = weights(K, N, n)
        x = act(M, K, torch.bfloat16)
        s_act = static_scale(x)
        own, geos = designs(M, K, N, 2)
        err = max(exact(w8a8_matmul(x, q, cs), w8a8_matmul_ref(x, q, cs))
                  for q, cs in ws[:4])
        st_err = max(exact(w8a8_matmul(x, q, cs, s_act),
                           w8a8_matmul_static_ref(x, q, cs, s_act))
                     for q, cs in ws[:4])
        t = {}
        for d, geo in geos.items():
            t[f"{d}_ms"] = time_calls(
                [lambda q=q, cs=cs, geo=geo: w8a8_matmul_as(
                    x, q, cs, None, geo) for q, cs in ws], iters)
            t[f"static_{d}_ms"] = time_calls(
                [lambda q=q, cs=cs, geo=geo: w8a8_matmul_as(
                    x, q, cs, s_act, geo) for q, cs in ws], iters)
        if M in plain_rows:
            t["plain_ms"] = time_calls(
                [lambda q=q, cs=cs: w8a8_matmul_ref(x, q, cs)
                 for q, cs in ws[:8]], 30 if M > 1000 else 100)
            t["static_plain_ms"] = time_calls(
                [lambda q=q, cs=cs: w8a8_matmul_static_ref(x, q, cs, s_act)
                 for q, cs in ws[:8]], 30 if M > 1000 else 100)
        xq = quantize_rows(x)
        if M <= 16:                    # torch._int_mm needs M > 16
            xq = torch.cat([xq, xq.new_zeros(32 - M, K)])
        t["int_mm_kn_ms"] = time_calls(
            [lambda q=q: torch._int_mm(xq, q) for q, _ in ws], iters)
        cm = [q.t().contiguous().t() for q, _ in ws]
        t["int_mm_cm_ms"] = time_calls(
            [lambda q=q: torch._int_mm(xq, q) for q in cm], iters)
        del cm
        nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
        ops = 2 * M * K * N
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops / PEAK_FLOPS["int8"]
        lib_ms = min(t["int_mm_kn_ms"], t["int_mm_cm_ms"])
        row = dict(design=own.design, split=own.split,
                   ms=t[f"{own.design}_ms"], library_ms=lib_ms,
                   bound_ms=max(t_bytes, t_ops) * 1e3, bytes=nbytes,
                   ops=ops, max_abs_err=err,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   **{k: v for k, v in t.items()
                      if not k.startswith("static")})
        out[(M, K, N)] = row
        st_bytes = nbytes + 4
        st_t_bytes = st_bytes / HBM_BYTES_PER_S
        out[("static", M, K, N)] = dict(
            design=own.design, split=own.split,
            ms=t[f"static_{own.design}_ms"], library_ms=lib_ms,
            bound_ms=max(st_t_bytes, t_ops) * 1e3, bytes=st_bytes, ops=ops,
            max_abs_err=st_err, int_mm_kn_ms=t["int_mm_kn_ms"],
            int_mm_cm_ms=t["int_mm_cm_ms"],
            bound_by="bytes" if st_t_bytes >= t_ops else "operations",
            **{k.removeprefix("static_"): v for k, v in t.items()
               if k.startswith("static_")})
        log(f"  M={M} K={K} N={N}: kernel {row['ms'] * 1e3:.2f} us "
            f"({own.design}, split {own.split}"
            + "".join(f"; {d} {t[f'{d}_ms'] * 1e3:.2f} us"
                      for d in geos if len(geos) > 1)
            + f"), static {t[f'static_{own.design}_ms'] * 1e3:.2f} us"
            + "".join(f" ({d} {t[f'static_{d}_ms'] * 1e3:.2f})"
                      for d in geos if len(geos) > 1)
            + (f", plain {t['plain_ms'] * 1e3:.2f} / static "
               f"{t['static_plain_ms'] * 1e3:.2f} us" if "plain_ms" in t
               else "")
            + f", _int_mm {t['int_mm_kn_ms'] * 1e3:.2f} us ([K, N]) / "
            f"{t['int_mm_cm_ms'] * 1e3:.2f} us (column-major), bound "
            f"{max(t_bytes, t_ops) * 1e6:.3f} us ({row['bound_by']}), "
            f"err {err:.2e} / static {st_err:.2e}")
        if err != 0.0 or st_err != 0.0:
            failures.append(f"w8a8 timing inputs M={M} K={K} N={N}")
        del ws
    for M in W8A8_CROSSOVER_MS:
        for mode, pre in (("dynamic", ()), ("static", ("static",))):
            layer = {d: sum(out[(*pre, M, K, N)][f"{d}_ms"] * c
                            for (K, N), c in Q8_SHAPES.items())
                     for d in ("splitk", "tiled")}
            log(f"  crossover M={M} {mode}, one layer: splitk "
                f"{layer['splitk'] * 1e3:.2f} us, tiled "
                f"{layer['tiled'] * 1e3:.2f} us; the geometry takes "
                f"{'splitk' if M <= star else 'tiled'}")
    out["max_abs_err"] = worst
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def write_full_width_gguf(path: str):
    """Seeded full-width random-weight GGUF, encoder matmuls as Q8_0 (the
    reference converter's default selection), with the converter's conv
    weight layouts and a joint bias on token 5 so that tokens are emitted.
    Returns the number of Q8_0 tensors."""
    from nemotron_tpu_torch.config import ModelConfig
    from nemotron_tpu_torch.params import random_weight_arrays

    cfg = ModelConfig()
    arrays = random_weight_arrays(cfg, seed=SEED)
    arrays["joint.joint_net.2.bias"][5] = 2.0
    return save_q8_model(path, cfg, arrays)


def shape_tdt_ctc_heads(arrays: dict, cfg) -> dict:
    """The TDT_ACTIVE labels' rows of the joint's token head and of the
    CTC head scaled by TDT_HEAD_SCALE, and duration TDT_JUMP's bias raised
    by TDT_JUMP_BIAS (in place; returns `arrays`)."""
    k = np.float32(TDT_HEAD_SCALE)
    rows = list(TDT_ACTIVE)
    for name in ("joint.joint_net.2", "ctc_decoder.decoder_layers.0"):
        arrays[f"{name}.weight"][rows] *= k
        arrays[f"{name}.bias"][rows] *= k
    jump = cfg.vocab_size + list(cfg.tdt_durations).index(TDT_JUMP)
    arrays["joint.joint_net.2.bias"][jump] += np.float32(TDT_JUMP_BIAS)
    return arrays


def write_tdt_ctc_gguf(path: str):
    """The seeded full-width TDT GGUF with a CTC head (TDT_DURATIONS, heads
    shaped by shape_tdt_ctc_heads, Q8_0 encoder matmuls), written to a
    temporary name and renamed, so that a reader never sees it half
    written."""
    from nemotron_tpu_torch.config import ModelConfig
    from nemotron_tpu_torch.params import random_weight_arrays

    cfg = ModelConfig(tdt_durations=TDT_DURATIONS)
    arrays = shape_tdt_ctc_heads(
        random_weight_arrays(cfg, seed=SEED + 15, ctc_head=True), cfg)
    n = save_q8_model(path + ".part", cfg, arrays)
    os.replace(path + ".part", path)
    return n


def save_q8_model(path: str, cfg, arrays: dict) -> int:
    """`arrays` (random_weight_arrays' names and layouts) as parameters on
    the CPU, written by params.save_model with Q8_0 encoder matmuls and the
    vocab t0, t1, ... (the config's metadata, nemo.tdt_durations for a TDT
    config). Returns the number of Q8_0 tensors."""
    from nemotron_tpu_torch.ops.quant import should_quantize
    from nemotron_tpu_torch.params import params_from_arrays, save_model

    params = params_from_arrays(arrays, cfg, device="cpu")
    save_model(path, params, cfg,
               vocab=[f"t{i}" for i in range(cfg.vocab_size)],
               quantize_mode="q8_0")
    return sum(should_quantize(n, a) for n, a in arrays.items())


@functools.lru_cache(maxsize=None)
def full_width_model(gguf_path: str, device: str):
    """load_model of the full-width GGUF, once a device for the whole run:
    the phases share its weights (read-only; every variant is a new
    object: quantize_model_params, peaked_params). main() drops them after
    the full-width phases."""
    from nemotron_tpu_torch.params import load_model

    return load_model(gguf_path, device=device)


@functools.lru_cache(maxsize=None)
def full_width_w8a8(gguf_path: str):
    """The full-width GGUF's weights as W8A8 (quantize_model_params of
    full_width_model's, on the card), once for the W8A8 path and the
    multi-GPU phase."""
    from nemotron_tpu_torch.params import quantize_model_params

    return quantize_model_params(full_width_model(gguf_path, "cuda")[0],
                                 mode="w8a8")


def dense_of(params):
    """`params` with every Q8_0 leaf dequantized in f32 (what
    load_model(keep_quantized=False) gives for a Q8_0 GGUF)."""
    import torch

    from nemotron_tpu_torch.ops.quant import QTensor, dequantize
    from nemotron_tpu_torch.params import map_leaves

    return map_leaves(lambda x: dequantize(x, torch.float32)
                      if isinstance(x, QTensor) else x, params)


def compare_model(model, n: int = COMPARE_LAYERS):
    """(params, cfg, vocab) of a comparison phase: `model` (load_model's
    triple) cut to its first n layers."""
    params, cfg, vocab = model
    return (*cut_layers(params, cfg, n), vocab)


def mode_seconds(R: int) -> float:
    """The audio a stream of the four-mode readings takes at mode R."""
    return SHORT_SECONDS if R < 6 else AUDIO_SECONDS


def seeded_pcm(stream: int = 0, seconds: float = AUDIO_SECONDS) -> np.ndarray:
    """Tone plus noise; each stream its own pitch and noise."""
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    noise = np.random.default_rng(SEED + stream).standard_normal(n)
    pcm = (0.3 * np.sin(2 * np.pi * 440 * (1 + 0.1 * stream) * t)
           + 0.05 * noise) * 16000
    return pcm.astype("<i2")


def main_path_phase(gguf_path: str, failures: list) -> dict:
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.models import encoder as enc_mod
    from nemotron_tpu_torch.ops.quant_kernel import q8_matmul
    from nemotron_tpu_torch.ops.ring_attn_kernel import fused_ring_attention
    from nemotron_tpu_torch.streaming.session import StreamSession

    t0 = time.perf_counter()
    params, cfg, vocab = full_width_model(gguf_path, "cuda")
    torch.cuda.synchronize()
    log(f"phase main path: load_model(device='cuda') "
        f"{time.perf_counter() - t0:.1f} s, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, Q8_0 encoder matmuls: "
        f"{type(params.layers.ffn1_w1).__name__}")
    pcm = seeded_pcm()
    results = {}
    for R in MODES:
        cc = CacheConfig(att_right_context=R, n_mels=cfg.n_mels)
        warm = StreamSession(params, cfg, vocab, cc)
        warm.process(pcm[: cc.chunk_samples * 2])
        torch.cuda.synchronize()
        sess = StreamSession(params, cfg, vocab, cc)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        sess.process(pcm)
        sess.finalize()
        torch.cuda.synchronize()
        n = kernel_counts()
        attn_n, q8_n = n["attn"], n["q8"]
        chunks = sess.total_chunks
        toks = [t for t, _ in sess.get_tokens(0)]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        results[R] = dict(chunks=chunks, tokens=toks, attn_launches=attn_n,
                          q8_launches=q8_n,
                          chunk_ms=sess.chunk_seconds / max(chunks, 1) * 1e3,
                          rtf=sess.rtf, peak_gib=peak)
        log(f"  R={R}: {chunks} chunks, {len(toks)} tokens, mean chunk "
            f"{results[R]['chunk_ms']:.2f} ms, RTF {sess.rtf:.4f}, launches "
            f"attn {attn_n} q8 {q8_n}, peak {peak:.2f} GiB, "
            f"text {sess.get_transcript(0)[:40]!r}")
        want_attn, want_q8 = cfg.n_layers * chunks, 10 * cfg.n_layers * chunks
        if chunks == 0 or attn_n != want_attn or q8_n != want_q8:
            failures.append(f"R={R}: launches attn {attn_n} (want "
                            f"{want_attn}), q8 {q8_n} (want {want_q8})")
        del warm, sess

    # where a chunk's time goes: one R=13 session over the audio, profiled
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    sess = StreamSession(params, cfg, vocab, cc)
    sess.process(pcm[: cc.chunk_samples * 2])
    warm_chunks = sess.total_chunks
    q8_before, attn_before = q8_matmul.launches, fused_ring_attention.launches
    prof = profile_window(lambda: sess.process(pcm))
    q8_calls = q8_matmul.launches - q8_before
    attn_calls = fused_ring_attention.launches - attn_before
    if prof["busy_us"] > 0:
        log(f"  profile R=13 ({sess.total_chunks - warm_chunks} chunks): wall "
            f"{prof['wall_us'] / 1e3:.2f} ms, device busy "
            f"{prof['busy_us'] / 1e3:.2f} ms "
            f"({100 * prof['busy_us'] / prof['wall_us']:.1f}%)")
        for name, us in prof["by_name"][:10]:
            log(f"    {us / 1e3:8.3f} ms  {name}")
        log("  the port's kernels in that profile:")
        for name, us in prof["by_name"]:
            if name.startswith(("q8_", "ring_attn_")):
                log(f"    {us / 1e3:8.3f} ms  {prof['count'][name]:6d} "
                    f"launches  {name}")
        q8_k = launches_of(prof, "q8_matmul")
        attn_k = launches_of(prof, "ring_attn_cluster_kernel")
        reduce_k = launches_of(prof, "q8_reduce")
        log(f"  Q8 calls {q8_calls}, Q8 kernel launches {q8_k}, reduce "
            f"launches {reduce_k}; attention calls {attn_calls}, kernel "
            f"launches {attn_k}")
        if q8_k != q8_calls or reduce_k or attn_k != attn_calls \
                or q8_calls == 0:
            failures.append(f"Q8_0 profile: {q8_calls} Q8 calls but {q8_k} "
                            f"Q8 kernels and {reduce_k} reduce kernels; "
                            f"{attn_calls} attention calls, {attn_k} kernels")
    else:
        log("  profile R=13: no device time recorded (not measured)")
    del sess

    # the port's CPU run of the R=13 session: the same tokens
    cpu_params, _, _ = full_width_model(gguf_path, "cpu")
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    cpu_sess = StreamSession(cpu_params, cfg, vocab, cc)
    cpu_sess.process(pcm)
    cpu_sess.finalize()
    cpu_toks = [t for t, _ in cpu_sess.get_tokens(0)]
    same = cpu_toks == results[13]["tokens"]
    log(f"  R=13 tokens card vs CPU: {'equal' if same else 'DIFFER'} "
        f"({len(cpu_toks)} tokens)")
    if not same:
        failures.append("R=13 tokens differ between the card and the CPU")

    # the encoder on both devices over n_seg + 2 chunks of seeded mel: the
    # ring fills, wraps and is overwritten, so the kernel's ring reads and
    # the in-place segment write are held to the CPU at full width
    n_seg = cc.kv_len // cc.chunk_enc_len
    mels = np.random.default_rng(SEED).standard_normal(
        (n_seg + 2, 1, cc.chunk_mel_frames, cfg.n_mels)).astype(np.float32)
    outs, states = [], []
    for p in (params, cpu_params):
        st = enc_mod.init_encoder_state(cfg, cc, 1, torch.float32, p.device)
        ph = enc_mod.precompute_pos_heads(p, cfg, cc)
        per_chunk = []
        for mel in mels:
            o, st = enc_mod.encode_chunk(p, cfg, cc,
                                         torch.from_numpy(mel).to(p.device),
                                         st, ph)
            per_chunk.append(o.float().cpu())
        outs.append(per_chunk)
        states.append(st)
    for ci, (o_card, o_cpu) in enumerate(zip(*outs)):
        finite = bool(torch.isfinite(o_card).all())
        err = (o_card - o_cpu).abs().max().item()
        log(f"  encoder chunk {ci} (R=13) card vs CPU: shape "
            f"{tuple(o_card.shape)}, finite {finite}, max_abs_err {err:.3e} "
            f"(tol {TOL_ENCODER_ABS:.0e}, max |out| "
            f"{o_cpu.abs().max().item():.3f})")
        if (not finite or err > TOL_ENCODER_ABS
                or tuple(o_card.shape) != (1, cc.valid_out_len, cfg.d_model)):
            failures.append(f"encoder chunk {ci} card vs CPU: err {err:.3e}")
    for name in ("k_cache", "v_cache", "conv_cache", "valid_len", "phase"):
        a, b = (getattr(st, name).float().cpu() for st in states)
        err = (a - b).abs().max().item()
        log(f"  encoder state {name} after {len(mels)} chunks card vs CPU: "
            f"max_abs_err {err:.3e} (tol {TOL_ENCODER_ABS:.0e})")
        if not err <= TOL_ENCODER_ABS:
            failures.append(f"encoder state {name} card vs CPU: err {err:.3e}")
    return results


# ---------------------------------------------------------------------------
# phase 5: the W8A8 + int8 K/V serving tier at full width
# ---------------------------------------------------------------------------

def position_agreement(got: list, want: list) -> float:
    """Share of `want`'s (token, frame) pairs that `got` has at the same
    position."""
    same = sum(x == y for x, y in zip(got, want))
    return same / max(len(want), len(got), 1)


def run_session(params, cfg, vocab, cc, pcm, dtype):
    """One StreamSession over the streams' PCM to the end; returns it."""
    from nemotron_tpu_torch.streaming.session import StreamSession

    sess = StreamSession(params, cfg, vocab, cc, n_streams=pcm.shape[0],
                         compute_dtype=dtype)
    sess.process(pcm)
    sess.finalize()
    return sess


def encoder_run(params, cfg, cc, mels, dtype, record_last: bool = False):
    """The encoder over each chunk of `mels` [n, S, T, n_mels]: per-chunk
    outputs (f32, on the CPU), the state after the last chunk and, with
    record_last, each layer's call in the last chunk (inputs cloned before
    the in-place ring write, outputs)."""
    import torch

    from nemotron_tpu_torch.models import encoder as enc_mod
    from nemotron_tpu_torch.params import cast_params

    p = cast_params(params, dtype)
    st = enc_mod.init_encoder_state(cfg, cc, mels.shape[1], dtype, p.device)
    ph = enc_mod.precompute_pos_heads(p, cfg, cc, dtype)
    outs, calls = [], []
    layer_fn = enc_mod.conformer_layer

    def recorded(lp, *args, **kw):
        saved = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
        out = layer_fn(lp, *args, **kw)
        calls.append((saved, kw, out))
        return out

    try:
        for i, mel in enumerate(mels):
            if record_last and i == len(mels) - 1:
                enc_mod.conformer_layer = recorded
            o, st = enc_mod.encode_chunk(
                p, cfg, cc, torch.from_numpy(mel).to(p.device, dtype), st, ph)
            outs.append(o.float().cpu())
    finally:
        enc_mod.conformer_layer = layer_fn
    return outs, st, calls


def state_gaps(a, b) -> dict:
    """How far encoder state `a` departs from `b`: conv cache (abs), scales
    (relative), mean int8 ring step; valid_len and phase equal or not."""
    import torch

    gaps = {}
    for name in ("k_cache", "v_cache", "k_scale", "v_scale", "conv_cache"):
        x, y = getattr(a, name).cpu(), getattr(b, name).cpu()
        if x.dtype == torch.int8:
            gaps[name] = (x.int() - y.int()).abs().float().mean().item()
        elif name.endswith("scale"):
            gaps[name] = ((x - y).abs() / y.abs()).max().item()
        else:
            gaps[name] = (x.float() - y.float()).abs().max().item()
    gaps["exact"] = all(torch.equal(getattr(a, n).cpu(), getattr(b, n).cpu())
                        for n in ("valid_len", "phase"))
    return gaps


def replay_layers(calls, params, dtype) -> list:
    """Each recorded CPU layer call again on the card, in `dtype`, with the
    card's params: per layer, the largest gap of each output (y, new K, new
    V, conv cache, attention input) relative to the CPU's max|.|."""
    import torch

    from nemotron_tpu_torch.models import encoder as enc_mod
    from nemotron_tpu_torch.params import cast_params

    layers = cast_params(params, dtype).layers
    gaps = []
    for l, (args, kw, want) in enumerate(calls):
        # x, pos_heads and the conv cache are in the compute dtype; the
        # mask, ring, slot indices and scale columns keep theirs
        dev = [a.to("cuda", dtype) if i in (0, 1, 3) else
               a.to("cuda") if isinstance(a, torch.Tensor) else a
               for i, a in enumerate(args)]
        got = enc_mod.conformer_layer(layers.layer(l), *dev, **kw)
        gaps.append([(g.float().cpu() - w.float()).abs().max().item()
                     / max(w.abs().max().item(), 1e-12)
                     for g, w in zip(got, want)])
    return gaps


def w8a8_mels(cfg, cc):
    """The W8A8 path's encoder input: n_seg + 2 chunks of seeded mel (the
    int8 rings fill and wrap) for W8A8_STREAMS streams, and the same moved
    by W8A8_CONTROL_ULPS f32 ulps (the control)."""
    n_seg = cc.kv_len // cc.chunk_enc_len
    mels = np.random.default_rng(SEED + 1).standard_normal(
        (n_seg + 2, W8A8_STREAMS, cc.chunk_mel_frames, cfg.n_mels)).astype(
        np.float32)
    return mels, (mels * np.float32(1 + W8A8_CONTROL_ULPS * 2.0 ** -23)
                  ).astype(np.float32)


# the W8A8 path's R = 13 cache config, on the card and the CPU
W8A8_CPU_CC = dict(att_right_context=13, kv_cache_int8=True)


def cpu_w8a8_reference(gguf_path: str, out_path: str) -> None:
    """The W8A8 path's CPU run (f32, W8A8_CPU_CC, W8A8_STREAMS streams of
    seeded PCM; w8a8_path_phase's reference): each stream's tokens, the
    encoder over w8a8_mels with the last chunk's layer calls, and over the
    control's mel; written with torch.save."""
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import load_model, quantize_model_params

    params, cfg, vocab = load_model(gguf_path, device="cpu")
    params = quantize_model_params(params, mode="w8a8")
    cc = CacheConfig(n_mels=cfg.n_mels, **W8A8_CPU_CC)
    S, f32 = W8A8_STREAMS, torch.float32
    pcm = np.stack([seeded_pcm(s) for s in range(S)])
    sess = run_session(params, cfg, vocab, cc, pcm, f32)
    mels, nudged = w8a8_mels(cfg, cc)
    o_cpu, st_cpu, calls = encoder_run(params, cfg, cc, mels, f32,
                                       record_last=True)
    o_ctl, st_ctl, _ = encoder_run(params, cfg, cc, nudged, f32)
    torch.save(dict(tokens=[sess.get_tokens(s) for s in range(S)],
                    o_cpu=o_cpu, st_cpu=st_cpu, calls=calls, o_ctl=o_ctl,
                    st_ctl=st_ctl), out_path)


def finish_torch_job(proc: subprocess.Popen, out_path: str,
                     timeout=900):
    """Wait for a start_cpu_job child and torch.load what it wrote."""
    import torch

    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"CPU job exit {proc.returncode}: {err[-2000:]}")
    return torch.load(out_path, weights_only=False)


def w8a8_path_phase(gguf_path: str, ref_job, ref_path: str,
                    failures: list) -> dict:
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.ops.w8a8_kernel import w8a8_matmul

    t0 = time.perf_counter()
    _, cfg, vocab = full_width_model(gguf_path, "cuda")
    params = full_width_w8a8(gguf_path)
    torch.cuda.synchronize()
    log(f"phase W8A8 path: load_model(device='cuda') + quantize_model_params"
        f"(mode='w8a8') {time.perf_counter() - t0:.1f} s, encoder matmuls: "
        f"{type(params.layers.ffn1_w1).__name__}")
    S = W8A8_STREAMS
    pcm = np.stack([seeded_pcm(s) for s in range(S)])
    bf16, f32 = torch.bfloat16, torch.float32
    results = {}
    for R, shared in [(R, False) for R in MODES] + [(13, True)]:
        cc = CacheConfig(att_right_context=R, n_mels=cfg.n_mels,
                         kv_cache_int8=True, shared_cache=shared)
        run_session(params, cfg, vocab, cc, pcm[:, :cc.chunk_samples * 2],
                    bf16)                                          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        sess = run_session(params, cfg, vocab, cc,
                           pcm[:, :int(mode_seconds(R) * 16000)], bf16)
        torch.cuda.synchronize()
        n = kernel_counts()
        counts = (n["attn"], n["w8a8"], n["q8"])
        chunks = sess.total_chunks
        n_tok = [len(sess.get_tokens(s)) for s in range(S)]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        name = f"R={R}" + (" shared" if shared else "")
        results[name] = dict(chunks=chunks, tokens=sum(n_tok),
                             attn_launches=counts[0], w8a8_launches=counts[1],
                             q8_launches=counts[2],
                             chunk_ms=sess.chunk_seconds / max(chunks, 1) * 1e3,
                             rtf=sess.rtf, peak_gib=peak)
        log(f"  {name} bf16 S={S} int8 K/V: {chunks} chunks, {sum(n_tok)} "
            f"tokens, mean chunk {results[name]['chunk_ms']:.2f} ms, RTF "
            f"{sess.rtf:.4f}, launches attn {counts[0]} w8a8 {counts[1]} q8 "
            f"{counts[2]}, peak {peak:.2f} GiB, "
            f"text {sess.get_transcript(S - 1)[:32]!r}")
        per_layer = 12 if shared else 10
        want = (cfg.n_layers * chunks, per_layer * cfg.n_layers * chunks, 0)
        if chunks == 0 or counts != want or min(n_tok) == 0:
            failures.append(f"W8A8 {name}: launches (attn, w8a8, q8) {counts}"
                            f" (want {want}), tokens per stream {n_tok}")
        del sess

    # where a chunk's time goes: the R = 13 bf16 session, profiled
    cc = CacheConfig(n_mels=cfg.n_mels, **W8A8_CPU_CC)
    from nemotron_tpu_torch.streaming.session import StreamSession

    sess = StreamSession(params, cfg, vocab, cc, n_streams=S,
                         compute_dtype=bf16)
    sess.process(pcm[:, :cc.chunk_samples * 2])
    warm_chunks = sess.total_chunks
    w8_before = w8a8_matmul.launches
    prof = profile_window(lambda: sess.process(pcm))
    w8_calls = w8a8_matmul.launches - w8_before
    if prof["busy_us"] > 0:
        log(f"  profile R=13 bf16 S={S} ({sess.total_chunks - warm_chunks} "
            f"chunks): wall {prof['wall_us'] / 1e3:.2f} ms, device busy "
            f"{prof['busy_us'] / 1e3:.2f} ms "
            f"({100 * prof['busy_us'] / prof['wall_us']:.1f}%)")
        for kname, us in prof["by_name"][:10]:
            log(f"    {us / 1e3:8.3f} ms  {kname}")
        log("  the port's kernels in that profile:")
        for kname, us in prof["by_name"]:
            if kname.startswith(("w8a8_", "ring_attn_", "q8_")):
                log(f"    {us / 1e3:8.3f} ms  {prof['count'][kname]:6d} "
                    f"launches  {kname}")
        w8_k = launches_of(prof, "w8a8_matmul")
        w8_other = (launches_of(prof, "w8a8_quantize")
                    + launches_of(prof, "w8a8_reduce")
                    + launches_of(prof, "w8a8_product"))
        log(f"  W8A8 calls {w8_calls}, W8A8 kernel launches {w8_k}, "
            f"quantize/product/reduce launches {w8_other}")
        if w8_k != w8_calls or w8_other or w8_calls == 0:
            failures.append(f"W8A8 profile: {w8_calls} W8A8 calls but "
                            f"{w8_k} W8A8 kernels and {w8_other} quantize, "
                            f"product or reduce kernels")
        if launches_of(prof, "q8_"):
            failures.append("W8A8 profile: Q8 kernels launched")
    else:
        log("  profile R=13 bf16: no device time recorded (not measured)")
    del sess

    # f32, R = 13, the same config on the card and in the port's CPU run
    # (cpu_w8a8_reference, a child process started with the main path)
    card = run_session(params, cfg, vocab, cc, pcm, f32)
    mels, nudged = w8a8_mels(cfg, cc)
    o_card, st_card, _ = encoder_run(params, cfg, cc, mels, f32)
    o_bf16, st_bf16, _ = encoder_run(params, cfg, cc, mels, bf16)
    bf = run_session(params, cfg, vocab, cc, pcm, bf16)
    t0 = time.perf_counter()
    ref = finish_torch_job(ref_job, ref_path)
    log(f"  the CPU run (a child process): waited for it "
        f"{time.perf_counter() - t0:.1f} s")
    cpu_tokens = ref["tokens"]
    agree = [position_agreement(card.get_tokens(s), cpu_tokens[s])
             for s in range(S)]
    log(f"  R=13 f32 S={S} tokens card vs CPU: {sum(a == 1 for a in agree)} "
        f"of {S} streams equal, position agreement {min(agree):.4f}-"
        f"{max(agree):.4f} ({sum(len(t) for t in cpu_tokens)} "
        f"tokens; tol {TOL_W8A8_TOKEN_AGREE})")
    if min(agree) < TOL_W8A8_TOKEN_AGREE:
        failures.append(f"W8A8 R=13 f32 tokens card vs CPU: agreement "
                        f"{min(agree):.4f}")

    # the encoder over n_seg + 2 chunks: the int8 rings fill and wrap
    o_cpu, st_cpu, calls = ref["o_cpu"], ref["st_cpu"], ref["calls"]
    o_ctl, st_ctl = ref["o_ctl"], ref["st_ctl"]

    for dtype, tol in ((f32, TOL_W8A8_LAYER_REL),
                       (bf16, TOL_BF16_VS_F32_REL)):
        gaps = replay_layers(calls, params, dtype)
        worst = [max(g[i] for g in gaps) for i in range(5)]
        log(f"  W8A8 layers replayed on the card in {str(dtype)[6:]} with the "
            f"CPU's inputs (R=13 S={S}, ring wrapped): worst gap of y "
            f"{worst[0]:.3e}, new K {worst[1]:.3e}, new V {worst[2]:.3e}, "
            f"conv {worst[3]:.3e}, attention input {worst[4]:.3e} of "
            f"max|.| (tol {tol}); layers with no gap: "
            f"{sum(max(g) == 0 for g in gaps)} of {len(gaps)}")
        if not max(worst) <= tol:
            failures.append(f"W8A8 layer replay {str(dtype)[6:]}: "
                            f"{max(worst):.3e} > {tol}")

    def out_gap(outs, ref):
        return max((a - b).abs().max().item() / b.abs().max().item()
                   for a, b in zip(outs, ref))

    control = out_gap(o_ctl, o_cpu)
    ctl_state = state_gaps(st_ctl, st_cpu)
    log(f"  W8A8 control: the CPU run against itself with its input moved "
        f"by {W8A8_CONTROL_ULPS} f32 ulps: outputs {control:.3e} of "
        f"max|out|; state {json.dumps(ctl_state)}")
    for name, outs, st, ref, ref_st, bound, check_state in (
            ("card vs CPU f32", o_card, st_card, o_cpu, st_cpu,
             W8A8_CONTROL_FACTOR * control, True),
            ("bf16 vs f32 on the card", o_bf16, st_bf16, o_card, st_card,
             max(TOL_BF16_VS_F32_REL, W8A8_CONTROL_FACTOR * control), False)):
        gap = out_gap(outs, ref)
        sg = state_gaps(st, ref_st)
        finite = all(bool(torch.isfinite(o).all()) for o in outs)
        shape_ok = all(tuple(o.shape) == (S, cc.valid_out_len, cfg.d_model)
                       for o in outs)
        over = [k for k, v in sg.items() if check_state and k != "exact"
                and v > W8A8_CONTROL_FACTOR * ctl_state[k] + 1e-6]
        ok = (finite and shape_ok and sg["exact"] and not over
              and gap <= bound)
        log(f"  W8A8 encoder {name} over {len(mels)} chunks (R=13 S={S}): "
            f"outputs {gap:.3e} of max|out| (tol {bound:.3e}); state "
            f"{json.dumps(sg)}{'' if ok else ' FAIL'}")
        if not ok:
            failures.append(f"W8A8 encoder {name}: outputs {gap:.3e}, "
                            f"finite {finite}, shape {shape_ok}, "
                            f"over the control: {over}")

    # bf16 against f32 on the card: tokens
    agree = [position_agreement(bf.get_tokens(s), card.get_tokens(s))
             for s in range(S)]
    log(f"  W8A8 R=13 tokens bf16 vs f32 on the card: position agreement "
        f"{min(agree):.4f}-{max(agree):.4f}")
    return results


# ---------------------------------------------------------------------------
# phase 6: the full-utterance path at full width
# ---------------------------------------------------------------------------

def valid_gap(a, b, lengths) -> float:
    """Largest |a - b| over each utterance's valid frames, relative to the
    largest |b| there."""
    return (max((a[i, :n] - b[i, :n]).abs().max().item()
                for i, n in enumerate(lengths))
            / max(b[i, :n].abs().max().item() for i, n in enumerate(lengths)))


def full_utterance_encode(params, cfg, mel, lengths) -> tuple:
    """encode_batch over the batch mel (f32, masked past each utterance's
    length) and greedy_decode's tokens: (encoder output, tokens), on the
    CPU."""
    import torch

    from nemotron_tpu_torch.models import decoder as dec_mod
    from nemotron_tpu_torch.models import encoder as enc_mod

    lens = torch.from_numpy(lengths).to(params.device)
    e = enc_mod.encode_batch(params, cfg,
                             torch.from_numpy(mel).to(params.device),
                             enc_lengths=lens)
    st = dec_mod.init_decoder_state(cfg, mel.shape[0], torch.float32,
                                    params.device)
    toks = dec_mod.greedy_decode(params, cfg, e, st, enc_lengths=lens)[0]
    return e.float().cpu(), toks.cpu()


def full_utterance_chain(params, cfg, vocab, utt) -> list:
    """transcribe_batch_with_state over the two halves of `utt`, the
    decoder state carried: [(text, tokens, frame offset)] a half."""
    from nemotron_tpu_torch.streaming import session as sess_mod

    half = utt.size // 2
    st, off, out = None, 0, []
    for seg in (utt[:half], utt[half:]):
        text, tl, st, off = sess_mod.transcribe_batch_with_state(
            params, cfg, vocab, seg, dec_state=st, frame_offset=off)
        out.append((text, tl, off))
    return out


def cpu_full_utterance_reference(gguf_path: str, out_path: str) -> None:
    """The full-utterance phase's CPU run: the batch mel of the seeded
    utterances, encode_batch's output over it and over the mel moved by
    W8A8_CONTROL_ULPS ulps (the control), greedy tokens, and the
    two-segment transcribe_batch_with_state chain; written with
    torch.save."""
    import torch

    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.streaming import session as sess_mod

    params, cfg, vocab = load_model(gguf_path, device="cpu")
    utts = [seeded_pcm(i, s) for i, s in enumerate(FULL_UTT_SECONDS)]
    mel, lengths = sess_mod.batch_mel(params, cfg, utts)
    nudged = (mel * np.float32(1 + W8A8_CONTROL_ULPS * 2.0 ** -23)
              ).astype(np.float32)
    with torch.no_grad():
        enc, toks = full_utterance_encode(params, cfg, mel, lengths)
        ctl, _ = full_utterance_encode(params, cfg, nudged, lengths)
    torch.save(dict(mel=mel, lengths=lengths, enc=enc, toks=toks,
                    control=ctl,
                    chain=full_utterance_chain(params, cfg, vocab, utts[1])),
               out_path)


def full_utterance_phase(gguf_path: str, ref_job, ref_path: str,
                         failures: list) -> dict:
    import torch

    from nemotron_tpu_torch.models import decoder as dec_mod
    from nemotron_tpu_torch.streaming import session as sess_mod
    from nemotron_tpu_torch.utils.text import tokens_to_text

    params, cfg, vocab = full_width_model(gguf_path, "cuda")
    utts = [seeded_pcm(i, s) for i, s in enumerate(FULL_UTT_SECONDS)]
    audio_s = sum(FULL_UTT_SECONDS)
    sess_mod.transcribe_batch(params, cfg, vocab, utts)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    texts = sess_mod.transcribe_batch(params, cfg, vocab, utts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"attn": 0, "q8": 10 * cfg.n_layers, "w8a8": 0}
    log(f"phase full utterance: transcribe_batch of {len(utts)} utterances "
        f"({', '.join(f'{s:g}' for s in FULL_UTT_SECONDS)} s; f32, Q8_0): "
        f"wall {wall * 1e3:.2f} ms, RTF {wall / audio_s:.5f}, peak "
        f"{peak:.2f} GiB, launches {json.dumps(counts)}, text lengths "
        f"{[len(t) for t in texts]}")
    if counts != want:
        failures.append(f"full utterance: launches {counts} (want {want})")

    # where the time goes, and the Q8 kernel launches counted by name
    prof = profile_window(
        lambda: sess_mod.transcribe_batch(params, cfg, vocab, utts))
    busy = prof["busy_us"] / max(prof["wall_us"], 1e-9)
    q8_k = launches_of(prof, "q8_matmul")
    if prof["busy_us"] > 0:
        log(f"  profile of one transcribe_batch: wall "
            f"{prof['wall_us'] / 1e3:.2f} ms, device busy "
            f"{prof['busy_us'] / 1e3:.2f} ms ({100 * busy:.1f}%), "
            f"q8_matmul* launches {q8_k} (one encode_batch)")
        for name, us in prof["by_name"][:10]:
            log(f"    {us / 1e3:8.3f} ms  {prof['count'][name]:6d} launches  "
                f"{name}")
        if q8_k != 10 * cfg.n_layers:
            failures.append(f"full utterance profile: {q8_k} Q8 kernel "
                            f"launches (want {10 * cfg.n_layers})")
    else:
        failures.append("full utterance profile: no device time recorded")

    # card vs the port's CPU run (cpu_full_utterance_reference, a child
    # process started beside the earlier phases) on the CPU's mel: the
    # encoder output (and the control that fixes its tolerance), then
    # greedy tokens
    card_chain = full_utterance_chain(params, cfg, vocab, utts[1])
    t0 = time.perf_counter()
    ref = finish_torch_job(ref_job, ref_path)
    log(f"  the CPU run (a child process): waited for it "
        f"{time.perf_counter() - t0:.1f} s")
    lengths = ref["lengths"]
    enc = {"cpu": ref["enc"], "control": ref["control"]}
    toks = {"cpu": ref["toks"]}
    enc["card"], toks["card"] = full_utterance_encode(params, cfg,
                                                      ref["mel"], lengths)
    rows = enc["card"].shape[0] * enc["card"].shape[1]
    control = valid_gap(enc["control"], enc["cpu"], lengths)
    tol = FULL_CONTROL_FACTOR * control
    gap = valid_gap(enc["card"], enc["cpu"], lengths)
    finite = bool(torch.isfinite(enc["card"]).all())
    log(f"  encode_batch card vs CPU ({rows} rows = M, enc_lengths "
        f"{lengths.tolist()}): {gap:.3e} of max|out| (tol {tol:.3e} = "
        f"{FULL_CONTROL_FACTOR:g} x the control {control:.3e}), finite "
        f"{finite}")
    if rows != FULL_UTT_M or not finite or not gap <= tol:
        failures.append(f"full utterance encoder card vs CPU: {gap:.3e} "
                        f"(tol {tol:.3e}), rows {rows}, finite {finite}")
    same_tokens = torch.equal(toks["card"], toks["cpu"])
    cpu_texts = [tokens_to_text(t, vocab) for t in
                 dec_mod.tokens_to_list(toks["cpu"].numpy(),
                                        cfg.blank_token)]
    n_tok = int((toks["cpu"] != cfg.blank_token).sum())
    log(f"  greedy tokens card vs CPU: {'equal' if same_tokens else 'DIFFER'}"
        f" ({n_tok} tokens); transcribe_batch texts on the card vs the CPU's "
        f"tokens: {'equal' if texts == cpu_texts else 'DIFFER'}")
    if not same_tokens or texts != cpu_texts or n_tok == 0:
        failures.append("full utterance tokens differ between the card and "
                        "the CPU")

    # decoder state carried over two segments of the 8 s utterance
    chains = {"card": card_chain, "cpu": ref["chain"]}
    same = chains["card"] == chains["cpu"]
    log(f"  transcribe_batch_with_state, 2 segments: card vs CPU "
        f"{'equal' if same else 'DIFFER'} (tokens "
        f"{[len(o[1]) for o in chains['card']]}, offsets "
        f"{[o[2] for o in chains['card']]})")
    if not same or not chains["cpu"][1][1]:
        failures.append("transcribe_batch_with_state differs between the "
                        "card and the CPU")
    return dict(wall_ms=wall * 1e3, rtf=wall / audio_s, busy_share=busy,
                peak_gib=peak, launches=counts, M=rows,
                encoder_gap=gap, encoder_tol=tol)


# ---------------------------------------------------------------------------
# phase 7: the trained tones fixture
# ---------------------------------------------------------------------------

def token_error(got: list, truths: list) -> float:
    """Levenshtein distance over all streams / truth tokens."""
    from nemotron_tpu_torch.utils.text import edit_distance

    return (sum(edit_distance(g, t) for g, t in zip(got, truths))
            / sum(len(t) for t in truths))


def tones_phase(failures: list) -> dict:
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import load_model, quantize_model_params
    from nemotron_tpu_torch.streaming.session import transcribe_batch
    from nemotron_tpu_torch.utils.tones import make_eval_streams

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "weights", "tones_tiny.gguf")
    card = load_model(path, device="cuda")
    cpu = load_model(path, device="cpu")
    cfg, vocab = card[1], card[2]
    audio, truths = make_eval_streams(TONES_STREAMS, TONES_SECONDS, TONES_N,
                                      seed=TONES_SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    log(f"phase tones: {path} (d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"of {cfg.d_head}, {cfg.n_layers} layers, f32), {TONES_STREAMS} "
        f"streams of {TONES_SECONDS:g} s (seed {TONES_SEED}), "
        f"{sum(len(t) for t in truths)} labels")

    def stream(params, R, pcm, dtype=f32, int8=False):
        cc = CacheConfig(att_right_context=R, n_mels=cfg.n_mels,
                         kv_cache_int8=int8)
        sess = run_session(params, cfg, vocab, cc, pcm, dtype)
        return sess, [[t for t, _ in sess.get_tokens(s)]
                      for s in range(pcm.shape[0])]

    def card_run(fn):
        """fn on the card with the launch counts set to 0; its result, its
        wall seconds and the counts."""
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, kernel_counts()

    run_session(card[0], cfg, vocab, CacheConfig(n_mels=cfg.n_mels),
                audio[:, :16000], f32)                        # warm-up
    results = {}
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    runs = [(f"R={R} S={TONES_STREAMS}", R, audio) for R in MODES]
    runs.append(("R=13 S=1", 13, audio[:1]))
    f32_card = {}
    for name, R, pcm in runs:
        (sess, got), wall, counts = card_run(lambda: stream(card[0], R, pcm))
        _, want = stream(cpu[0], R, pcm)
        ter = token_error(got, truths[:pcm.shape[0]])
        chunks = sess.total_chunks
        f32_card[name] = sess
        results[name] = dict(ter=ter, chunk_ms=sess.chunk_seconds
                             / max(chunks, 1) * 1e3, rtf=sess.rtf,
                             wall_s=wall, chunks=chunks, launches=counts,
                             same_as_cpu=got == want)
        for k in launches:
            launches[k] += counts[k]
        log(f"  streaming {name} f32: token error {ter:.4f}, "
            f"{sum(map(len, got))} tokens, {chunks} chunks, mean chunk "
            f"{results[name]['chunk_ms']:.2f} ms, RTF {sess.rtf:.4f}, "
            f"launches {json.dumps(counts)}, tokens vs CPU "
            f"{'equal' if got == want else 'DIFFER'}")
        want_counts = {"attn": cfg.n_layers * chunks, "q8": 0, "w8a8": 0}
        if (not ter < TONES_TER_MAX or got != want or chunks == 0
                or counts != want_counts):
            failures.append(f"tones {name}: token error {ter:.4f}, tokens "
                            f"vs CPU equal {got == want}, launches {counts}")

    texts, wall, counts = card_run(
        lambda: transcribe_batch(card[0], cfg, vocab, list(audio)))
    cpu_texts = transcribe_batch(cpu[0], cfg, vocab, list(audio))
    got = [[vocab.index("▁" + w) for w in t.split()] for t in texts]
    ter = token_error(got, truths)
    results["transcribe_batch"] = dict(ter=ter, wall_ms=wall * 1e3,
                                       rtf=wall / (TONES_SECONDS
                                                   * TONES_STREAMS),
                                       launches=counts,
                                       same_as_cpu=texts == cpu_texts)
    log(f"  transcribe_batch of the {TONES_STREAMS} streams f32: token error "
        f"{ter:.4f}, wall {wall * 1e3:.2f} ms, RTF "
        f"{results['transcribe_batch']['rtf']:.5f}, launches "
        f"{json.dumps(counts)}, texts vs CPU "
        f"{'equal' if texts == cpu_texts else 'DIFFER'}")
    if not ter < TONES_TER_MAX or texts != cpu_texts or any(counts.values()):
        failures.append(f"tones transcribe_batch: token error {ter:.4f}, "
                        f"texts vs CPU equal {texts == cpu_texts}, launches "
                        f"{counts}")

    w8 = quantize_model_params(card[0], mode="w8a8")
    (sess, got), wall, counts = card_run(
        lambda: stream(w8, 13, audio, bf16, int8=True))
    ter = token_error(got, truths)
    ref = f32_card[f"R=13 S={TONES_STREAMS}"]
    agree = [position_agreement(sess.get_tokens(s), ref.get_tokens(s))
             for s in range(TONES_STREAMS)]
    chunks = sess.total_chunks
    for k in launches:
        launches[k] += counts[k]
    results["w8a8"] = dict(ter=ter, agreement_min=min(agree),
                           agreement_mean=sum(agree) / len(agree),
                           chunk_ms=sess.chunk_seconds / max(chunks, 1) * 1e3,
                           rtf=sess.rtf, launches=counts)
    log(f"  streaming R=13 S={TONES_STREAMS} W8A8 + int8 K/V bf16: token "
        f"error {ter:.4f} (f32 {results[f'R=13 S={TONES_STREAMS}']['ter']:.4f}), "
        f"position agreement with the f32 card run {min(agree):.4f}-"
        f"{max(agree):.4f}, mean chunk {results['w8a8']['chunk_ms']:.2f} ms, "
        f"RTF {sess.rtf:.4f}, launches {json.dumps(counts)}")
    want_counts = {"attn": cfg.n_layers * chunks, "q8": 0,
                   "w8a8": 10 * cfg.n_layers * chunks}
    if counts != want_counts or chunks == 0:
        failures.append(f"tones W8A8: launches {counts} (want {want_counts})")
    results["launches"] = launches
    return results


# ---------------------------------------------------------------------------
# phase 8: the serving engine (slice 8)
# ---------------------------------------------------------------------------

class EncoderTap:
    """Counts the encoder steps (encoder.encode_chunk calls, through which
    the engine's masked step and every session go) and records the output
    rows of the chosen slots at each step that advances them. `drop(slots)`
    forgets what evicted slots recorded."""

    def __init__(self, slots=()):
        self.rows = {s: [] for s in slots}
        self.calls = 0

    def __enter__(self):
        from nemotron_tpu_torch.models import encoder as enc_mod

        self.mod, self.orig = enc_mod, enc_mod.encode_chunk

        def tapped(*args, step_mask=None, **kw):
            out, st = self.orig(*args, step_mask=step_mask, **kw)
            self.calls += 1
            if self.rows:
                mask = None if step_mask is None else step_mask.cpu()
                for s, rows in self.rows.items():
                    if mask is None or mask[s]:
                        rows.append(out[s].float().cpu())
            return out, st

        enc_mod.encode_chunk = tapped
        return self

    def __exit__(self, *exc):
        self.mod.encode_chunk = self.orig

    def drop(self, slots) -> None:
        for s in slots:
            if s in self.rows:
                self.rows[s] = []


def engine_schedule(eng, pcm_of, half=(), evict=(), evict_tick=None,
                    late=(), late_tick=None, tap=None,
                    finalize: bool = True, before_end=None) -> dict:
    """Drive a fresh engine through a ragged schedule, one chunk shift of
    samples a tick: every slot but `late` admitted at once, the slots in
    `half` fed every other tick, `late` admitted at `late_tick`, and the
    `evict` slots evicted at `evict_tick` (their recordings dropped from
    `tap`) and re-admitted with new streams (stream ids from n_slots up)
    of the same rate; then every slot finalized in one finalize_streams
    call (or, finalize=False, evicted); before_end({slot: stream id}), if
    given, runs just before that. pcm_of(stream id) gives a stream's PCM.
    Returns the final tokens and PCM per stream id, the slot each
    stream ended in, the frames each had decoded before the finalize, and
    the stats and latency percentiles of the streaming ticks (before the
    finalize)."""
    n, q = eng.n_slots, eng.cc.shift_samples
    slots = eng.add_streams(n - len(late))
    stream_of = {s: s for s in slots}
    pos = {s: 0 for s in slots}
    pcm = {s: pcm_of(s) for s in slots}
    half = set(half)
    tick = 0
    while True:
        if tick == evict_tick and evict:
            for s in evict:
                eng.remove_stream(s)
            if tap:
                tap.drop(evict)
            assert sorted(eng.add_streams(len(evict))) == sorted(evict)
            for k, s in enumerate(evict):
                stream_of[s] = sid = n + k
                pcm[sid], pos[sid] = pcm_of(sid), 0
        if tick == late_tick:
            for s in late:
                assert eng.add_stream() == s
                stream_of[s], pcm[s], pos[s] = s, pcm_of(s), 0
        if tick > max(evict_tick or 0, late_tick or 0) and all(
                pos[sid] >= pcm[sid].size for sid in stream_of.values()):
            break
        feed = {}
        for s, sid in stream_of.items():
            if s in half and tick % 2:
                continue
            a = pcm[sid][pos[sid]:pos[sid] + q]
            if a.size:
                feed[s] = a
                pos[sid] += a.size
        if feed:
            eng.feed_audio(feed)
        eng.step()
        tick += 1
    stats, latency = eng.stats(), eng.latency_percentiles()
    slots = list(stream_of)
    frames = {stream_of[s]: int(eng.frame_offsets[s]) for s in slots}
    if before_end is not None:
        before_end(stream_of)
    ends = (eng.finalize_streams(slots, return_tokens=True) if finalize
            else [eng.remove_stream(s, return_tokens=True) for s in slots])
    finals = {stream_of[s]: toks for s, (_text, toks) in zip(slots, ends)}
    return dict(finals=finals, slot_of={sid: s for s, sid in
                                        stream_of.items()},
                pcm=pcm, stats=stats, latency=latency, ticks=tick,
                frames=frames)


def ragged_plan(n: int, seconds: float, q: int) -> dict:
    """The engine cells' schedule: the last ENGINE_HALF slots at half rate,
    ENGINE_EVICT slots (half from each rate class) evicted and re-admitted
    a third of the way in (n >= 32), or all at the real-time rate."""
    if n < 32:
        return {}
    half = list(range(n - ENGINE_HALF, n))
    k = ENGINE_EVICT // 2
    return dict(half=half, evict=list(range(n - ENGINE_HALF - k,
                                            n - ENGINE_HALF))
                + list(range(n - k, n)),
                evict_tick=int(seconds * 16000 / q) // 3)


def tracked_streams(n: int) -> list:
    """One stream of each rate class and the re-admitted ones: slot 0 (full
    rate), the first half-rate slot, the first re-admitted full-rate and
    half-rate streams."""
    return [0, n - ENGINE_HALF, n, n + ENGINE_EVICT // 2]


def solo_session(params, cfg, vocab, cc, pcm, dtype, **kw) -> dict:
    """One StreamSession (options `kw`) over one stream's PCM: the tokens
    of the chunks of real audio ("streamed", before the finalize) and the
    frames they cover, and the tokens after the finalize ("final"), whose
    last chunk is padded with zero mel."""
    from nemotron_tpu_torch.streaming.session import StreamSession

    sess = StreamSession(params, cfg, vocab, cc, compute_dtype=dtype, **kw)
    sess.process(pcm)
    out = dict(streamed=list(sess.get_tokens(0)), frames=sess.frame_offset)
    sess.finalize()
    out["final"] = sess.get_tokens(0)
    return out


def streamed_part(tokens: list, solo: dict) -> list:
    """The tokens of the frames the solo session decoded from chunks of
    real audio. With the DSP on the device the engine pads a stream's tail
    with silence PCM where the session pads zero mel, so only these chunks
    see the same input; the JAX package compares a transcript prefix."""
    return [t for t in tokens if t[1] < solo["frames"]]


def engine_step_profile(eng, steps: int = 3) -> dict:
    """Every slot admitted and given two chunk shifts (after which each
    shift completes a chunk), then `steps` ticks profiled, one shift a
    slot each: the busy share and each kernel's launches and device ms."""
    q = eng.cc.shift_samples
    slots = eng.add_streams(eng.n_slots)
    pcm = {s: seeded_pcm(s, (2 + steps) * q / 16000) for s in slots}
    for t in range(2):
        eng.feed_audio({s: pcm[s][t * q:(t + 1) * q] for s in slots})
        eng.step()

    def run():
        for t in range(2, 2 + steps):
            eng.feed_audio({s: pcm[s][t * q:(t + 1) * q] for s in slots})
            eng.step()

    with EncoderTap() as tap:
        prof = profile_window(run)
    prof["encoder_steps"] = tap.calls
    return prof


def check_engine_launches(name, counts, steps, cfg, per_layer, kernel,
                          failures) -> None:
    """Each encoder step of the engine: one attention launch a layer and
    `per_layer` launches a layer of `kernel`, none of the other matmul."""
    other = "q8" if kernel == "w8a8" else "w8a8"
    want = {"attn": cfg.n_layers * steps, kernel: per_layer * cfg.n_layers
            * steps, other: 0}
    if not steps or counts != want:
        failures.append(f"engine {name}: launches {counts} in {steps} "
                        f"encoder steps (want {want})")


def log_profile(name, prof, steps, failures, kernel_prefix, per_step):
    """Print a profile of `steps` engine ticks; check the launches a tick
    by kernel name against `per_step` {name prefix: launches}."""
    if prof["busy_us"] <= 0:
        failures.append(f"engine profile {name}: no device time recorded")
        return {}
    busy = prof["busy_us"] / prof["wall_us"]
    log(f"  profile {name}, {steps} ticks ({prof['encoder_steps']} encoder "
        f"steps): wall {prof['wall_us'] / 1e3:.2f} ms, device busy "
        f"{prof['busy_us'] / 1e3:.2f} ms ({100 * busy:.1f}%)")
    for kname, us in prof["by_name"][:8]:
        log(f"    {us / 1e3:8.3f} ms  {prof['count'][kname]:6d} launches  "
            f"{kname}")
    out = dict(wall_ms=prof["wall_us"] / 1e3, busy_ms=prof["busy_us"] / 1e3,
               busy_share=busy, per_step={})
    for prefix, want in per_step.items():
        n = launches_of(prof, prefix)
        ms = sum(us for k, us in prof["by_name"] if k.startswith(prefix)) / 1e3
        out["per_step"][prefix] = dict(launches=n / steps, ms=ms / steps)
        log(f"    per tick: {prefix} {n / steps:g} launches, "
            f"{ms / steps:.3f} ms")
        if n != want * steps or prof["encoder_steps"] != steps:
            failures.append(f"engine profile {name}: {n} {prefix} launches "
                            f"in {prof['encoder_steps']} encoder steps "
                            f"(want {want} a tick x {steps})")
    if launches_of(prof, kernel_prefix):
        failures.append(f"engine profile {name}: {kernel_prefix} launched")
    return out


def w8a8_solo_readings(run, params, cfg, vocab, cc, R, failures,
                       streams) -> dict:
    """The `streams` of a 64-slot W8A8 bf16 run against solo bf16
    sessions, beside two controls that involve no engine: the solo
    session against the same stream in a 2-stream session (another batch
    size) and against itself with its mel moved by two f32 ulps. On the
    random weights at full width the tier is chaotic under int8 rounding
    (see the W8A8 path phase): a last-bit change anywhere, batch size
    included, can move a token, and the controls printed beside the
    engine's agreement show how far. So this comparison is a reading. The
    engine's W8A8 agreement is held to the tier's 95% bound on the trained
    fixture (engine_tones_phase), and its slot isolation at full width by
    the Q8_0 f32 run (exact). Checked here: each tracked stream decodes as
    many tokens as its solo session over the chunks of real audio."""
    import torch

    from nemotron_tpu_torch.streaming.session import StreamSession

    bf16 = torch.bfloat16
    rows = {}
    for sid in streams:
        pcm = run["pcm"][sid]
        solo = solo_session(params, cfg, vocab, cc, pcm, bf16)
        ref = solo["streamed"]
        got = streamed_part(run["finals"][sid], solo)
        pair = StreamSession(params, cfg, vocab, cc, n_streams=2,
                             compute_dtype=bf16)
        pair.process(np.stack([pcm, seeded_pcm(500 + sid, ENGINE_SECONDS)
                               [:pcm.size]]))
        nudged = StreamSession(params, cfg, vocab, cc, compute_dtype=bf16)
        mel = nudged.preproc.process(pcm[None])
        nudged.process_mel((mel * np.float32(1 + W8A8_CONTROL_ULPS * 2.0 ** -23)
                            ).astype(np.float32))
        rows[sid] = dict(engine=position_agreement(got, ref),
                         pair_control=position_agreement(
                             pair.get_tokens(0), ref),
                         nudge_control=position_agreement(
                             nudged.get_tokens(0), ref), tokens=len(ref))
        if len(got) != len(ref) or not ref:
            failures.append(f"engine W8A8 stream {sid}: {len(got)} tokens "
                            f"over the real-audio chunks, solo {len(ref)}")
    log(f"  W8A8 bf16 R={R} tracked streams vs solo bf16 sessions (position "
        "agreement; controls without the engine: the stream in a 2-stream "
        "session, its mel moved by 2 ulps): " + "; ".join(
            f"stream {sid}: engine {r['engine']:.4f}, 2-stream "
            f"{r['pair_control']:.4f}, nudged {r['nudge_control']:.4f}"
            for sid, r in rows.items()))
    return rows


def engine_phase(gguf_path: str, failures: list) -> dict:
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import quantize_model_params
    from nemotron_tpu_torch.streaming.serving import ServingEngine

    bf16, f32 = torch.bfloat16, torch.float32
    q8_params, cfg, vocab = compare_model(full_width_model(gguf_path,
                                                           "cuda"))
    w8_params = quantize_model_params(q8_params, mode="w8a8")
    n = ENGINE_SLOTS

    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    out = {"modes": {}, "slot_counts": {}}
    log(f"phase engine: ServingEngine at full width, {cfg.n_layers} "
        f"layers, {n} slots, "
        f"{n - ENGINE_HALF} at the real-time rate, {ENGINE_HALF} at half "
        f"rate, {ENGINE_EVICT} evicted and re-admitted, "
        f"{ENGINE_SECONDS:g} s a stream")

    def timed_run(params, cc, dtype, dsp, slots, plan, tap_slots=(),
                  seconds=ENGINE_SECONDS):
        eng = ServingEngine(params, cfg, vocab, cc, n_slots=slots,
                            compute_dtype=dtype, dsp=dsp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with EncoderTap(tap_slots) as tap:
            run = engine_schedule(eng, lambda sid: seeded_pcm(sid, seconds),
                                  tap=tap, **plan)
            torch.cuda.synchronize()
            run["encoder_steps"] = tap.calls
        run["counts"] = kernel_counts()
        run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        run["rows"] = tap.rows
        for k in launches:
            launches[k] += run["counts"][k]
        return run, eng

    def summary(run, R):
        lat, st = run["latency"], run["stats"]
        return dict(p50_ms=lat["p50"] * 1e3, p90_ms=lat["p90"] * 1e3,
                    shift_ms=SHIFT_MS[R], rtf=st["aggregate_rtf"],
                    ticks=st["engine_steps"], audio_s=st["audio_seconds_decoded"],
                    tokens=sum(map(len, run["finals"].values())),
                    peak_gib=run["peak_gib"],
                    encoder_steps=run["encoder_steps"])

    # W8A8 + int8 K/V, bf16, device DSP, 64 slots, the four modes
    for R in MODES:
        t0 = time.perf_counter()
        cc = CacheConfig(att_right_context=R, n_mels=cfg.n_mels,
                         kv_cache_int8=True)
        plan = ragged_plan(n, mode_seconds(R), cc.shift_samples)
        run, _ = timed_run(w8_params, cc, bf16, "device", n, plan,
                           seconds=mode_seconds(R))
        res = summary(run, R)
        check_engine_launches(f"W8A8 R={R}", run["counts"],
                              run["encoder_steps"], cfg, 10, "w8a8", failures)
        out["modes"][f"R={R}"] = res
        log(f"  W8A8 bf16 device DSP R={R}: step p50 {res['p50_ms']:.2f} / "
            f"p90 {res['p90_ms']:.2f} ms (shift {SHIFT_MS[R]} ms), aggregate "
            f"RTF {res['rtf']:.4f}, {res['ticks']} ticks, "
            f"{res['encoder_steps']} encoder steps, {res['tokens']} tokens, "
            f"peak {res['peak_gib']:.2f} GiB, launches "
            f"{json.dumps(run['counts'])} (wall "
            f"{time.perf_counter() - t0:.1f} s)")
        if R in (6, 13):
            # R = 6 on the first two tracked streams only (the run's time
            # limit; PERF.md §4)
            track = tracked_streams(n)
            out["modes"][f"R={R}"]["solo"] = w8a8_solo_readings(
                run, w8_params, cfg, vocab, cc, R, failures,
                track if R == 13 else track[:2])
        del run

    cc13 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels,
                       kv_cache_int8=True)
    reset_counts()
    prof = engine_step_profile(ServingEngine(
        w8_params, cfg, vocab, cc13, n_slots=n, compute_dtype=bf16,
        dsp="device"))
    for k, v in kernel_counts().items():
        launches[k] += v
    out["profile_w8a8"] = log_profile(
        "W8A8 bf16 R=13", prof, 3, failures, "q8_",
        {"ring_attn_cluster_kernel": cfg.n_layers,
         "w8a8_matmul": 10 * cfg.n_layers})

    # Q8_0, f32, host DSP, 64 slots, R = 13: tokens and encoder outputs of
    # the tracked streams against solo f32 sessions
    t0 = time.perf_counter()
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    plan = ragged_plan(n, ENGINE_SECONDS, cc.shift_samples)
    track = tracked_streams(n)
    run, eng = timed_run(q8_params, cc, f32, "numpy", n, plan,
                         tap_slots=[0, n - ENGINE_HALF, plan["evict"][0],
                                    plan["evict"][ENGINE_EVICT // 2]])
    res = summary(run, 13)
    check_engine_launches("Q8_0 R=13", run["counts"], run["encoder_steps"],
                          cfg, 10, "q8", failures)
    same, gaps = [], []
    for sid in track:
        with EncoderTap([0]) as tap:
            solo = solo_session(q8_params, cfg, vocab, cc, run["pcm"][sid],
                                f32)["final"]
        same.append(run["finals"][sid] == solo and len(solo) > 0)
        mine = run["rows"][run["slot_of"][sid]]
        if len(mine) != len(tap.rows[0]):
            gaps.append(float("inf"))
        else:
            gaps.append(max((a - b).abs().max().item()
                            for a, b in zip(mine, tap.rows[0])))
    res.update(solo_tokens_equal=same, solo_encoder_gap=gaps)
    out["q8_f32"] = res
    log(f"  Q8_0 f32 host DSP R=13: step p50 {res['p50_ms']:.2f} / p90 "
        f"{res['p90_ms']:.2f} ms, aggregate RTF {res['rtf']:.4f}, "
        f"{res['ticks']} ticks, {res['encoder_steps']} encoder steps, "
        f"{res['tokens']} tokens, peak {res['peak_gib']:.2f} GiB, launches "
        f"{json.dumps(run['counts'])}; tracked streams vs solo f32 sessions: "
        f"tokens equal {same}, encoder max_abs_err "
        f"{', '.join(f'{g:.3e}' for g in gaps)} (tol {TOL_ENCODER_ABS:.0e}) "
        f"(wall {time.perf_counter() - t0:.1f} s)")
    if not all(same) or not max(gaps) <= TOL_ENCODER_ABS:
        failures.append(f"engine Q8_0 f32: tokens equal {same}, encoder "
                        f"gaps {gaps}")
    del run, eng
    reset_counts()
    prof = engine_step_profile(ServingEngine(
        q8_params, cfg, vocab, cc, n_slots=n, compute_dtype=f32,
        dsp="numpy"))
    for k, v in kernel_counts().items():
        launches[k] += v
    out["profile_q8"] = log_profile(
        "Q8_0 f32 R=13", prof, 3, failures, "w8a8_",
        {"ring_attn_cluster_kernel": cfg.n_layers,
         "q8_matmul": 10 * cfg.n_layers})

    # streams per card: W8A8 bf16 device DSP R = 13 at 8, 64 and 256 slots,
    # every slot at the real-time rate for 8 s (7 ticks), evicted at the end
    for slots in ENGINE_SLOT_COUNTS:
        t0 = time.perf_counter()
        run, _ = timed_run(w8_params, cc13, bf16, "device", slots,
                           dict(finalize=False), seconds=2 * ENGINE_SECONDS)
        res = summary(run, 13)
        check_engine_launches(f"W8A8 {slots} slots", run["counts"],
                              run["encoder_steps"], cfg, 10, "w8a8",
                              failures)
        out["slot_counts"][slots] = res
        log(f"  W8A8 bf16 device DSP R=13, {slots} slots: step p50 "
            f"{res['p50_ms']:.2f} / p90 {res['p90_ms']:.2f} ms (shift 1120 "
            f"ms), aggregate RTF {res['rtf']:.4f}, {res['ticks']} ticks, "
            f"{res['tokens']} tokens, peak {res['peak_gib']:.2f} GiB (wall "
            f"{time.perf_counter() - t0:.1f} s)")
        del run
    # slice 12: where the 256-slot tick's time goes (M = 3584 a matmul, the
    # tiled W8A8 design)
    slots = ENGINE_SLOT_COUNTS[-1]
    reset_counts()
    prof = engine_step_profile(ServingEngine(
        w8_params, cfg, vocab, cc13, n_slots=slots, compute_dtype=bf16,
        dsp="device"))
    for k, v in kernel_counts().items():
        launches[k] += v
    out[f"profile_w8a8_{slots}"] = log_profile(
        f"W8A8 bf16 R=13 {slots} slots", prof, 3, failures, "q8_",
        {"ring_attn_cluster_kernel": cfg.n_layers,
         "w8a8_matmul": 10 * cfg.n_layers})
    out["launches"] = launches
    return out


def sil_pcm() -> np.ndarray:
    """The endpointing audio (tests/test_serving.py:1363-1423): the two
    tone utterances of SIL_LABELS, each followed by 3 s of silence."""
    from nemotron_tpu_torch.utils.tones import render_tones

    rng = np.random.default_rng(7)

    def utt(labels, tail_s):
        n = int(0.30 * len(labels) * 16000) + int(tail_s * 16000)
        return render_tones(np.asarray(labels), np.full(len(labels), 0.25),
                            rng, 16, n, gaps=np.full(len(labels), 0.05))

    return np.concatenate([utt(SIL_LABELS[0], 3.0), utt(SIL_LABELS[1], 3.0)])


def engine_tones_phase(failures: list) -> dict:
    """The trained fixtures through the engine: tones_tiny.gguf, 8 streams
    of 15 s at ragged rates in both DSP modes at R = 0 and 13 (tokens
    against solo card sessions and the labels), and endpointing on
    tones_tiny_sil.gguf."""
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.streaming.serving import ServingEngine
    from nemotron_tpu_torch.utils.text import edit_distance
    from nemotron_tpu_torch.utils.tones import make_eval_streams

    here = os.path.dirname(os.path.abspath(__file__))
    params, cfg, vocab = load_model(os.path.join(here, "weights",
                                                 "tones_tiny.gguf"),
                                    device="cuda")
    audio, truths = make_eval_streams(TONES_STREAMS, TONES_SECONDS, TONES_N,
                                      seed=TONES_SEED)
    f32 = torch.float32
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    out = {}
    log(f"phase engine tones: {TONES_STREAMS} streams of {TONES_SECONDS:g} s"
        f" (seed {TONES_SEED}): streams {list(ENGINE_TONES_HALF)} at half "
        f"rate, {ENGINE_TONES_LATE} admitted late")
    for R in (0, 13):
        cc = CacheConfig(att_right_context=R, n_mels=cfg.n_mels)
        solo = [solo_session(params, cfg, vocab, cc, audio[s], f32)
                for s in range(TONES_STREAMS)]
        for dsp in ("numpy", "device"):
            eng = ServingEngine(params, cfg, vocab, cc,
                                n_slots=TONES_STREAMS, compute_dtype=f32,
                                dsp=dsp)
            torch.cuda.synchronize()
            reset_counts()
            with EncoderTap() as tap:
                run = engine_schedule(
                    eng, lambda s: audio[s], half=ENGINE_TONES_HALF,
                    late=(ENGINE_TONES_LATE,),
                    late_tick=int(TONES_SECONDS * 16000
                                  / cc.shift_samples) // 4, tap=tap)
                torch.cuda.synchronize()
                steps = tap.calls
            counts = kernel_counts()
            for k in launches:
                launches[k] += counts[k]
            got = [run["finals"][s] for s in range(TONES_STREAMS)]
            if dsp == "numpy":
                same = [g == w["final"] for g, w in zip(got, solo)]
            else:
                same = [streamed_part(g, w) == w["streamed"]
                        for g, w in zip(got, solo)]
            ter = token_error([[t for t, _ in g] for g in got], truths)
            lat = run["latency"]
            name = f"R={R} {dsp}"
            out[name] = dict(ter=ter, same_as_solo=same,
                             p50_ms=lat["p50"] * 1e3, p90_ms=lat["p90"] * 1e3,
                             rtf=run["stats"]["aggregate_rtf"],
                             ticks=run["ticks"], encoder_steps=steps,
                             launches=counts)
            how = ("equal" if dsp == "numpy"
                   else "equal over the chunks of real audio")
            log(f"  {name}: token error {ter:.4f}, tokens vs solo card "
                f"sessions {how} {sum(same)} of {len(same)}, step p50 "
                f"{lat['p50'] * 1e3:.2f}"
                f" / p90 {lat['p90'] * 1e3:.2f} ms, aggregate RTF "
                f"{run['stats']['aggregate_rtf']:.4f}, {run['ticks']} ticks, "
                f"launches {json.dumps(counts)}")
            want = {"attn": cfg.n_layers * steps, "q8": 0, "w8a8": 0}
            if not all(same) or not ter < TONES_TER_MAX or counts != want \
                    or not steps:
                failures.append(f"engine tones {name}: token error "
                                f"{ter:.4f}, same as solo {same}, launches "
                                f"{counts} (want {want})")

    # the W8A8 + int8 K/V tier on trained weights: bf16, device DSP, R = 13,
    # the same ragged schedule, against solo W8A8 bf16 sessions
    from nemotron_tpu_torch.params import quantize_model_params

    w8 = quantize_model_params(params, mode="w8a8")
    bf16 = torch.bfloat16
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels,
                     kv_cache_int8=True)
    solo = [solo_session(w8, cfg, vocab, cc, audio[s], bf16)
            for s in range(TONES_STREAMS)]
    eng = ServingEngine(w8, cfg, vocab, cc, n_slots=TONES_STREAMS,
                        compute_dtype=bf16, dsp="device")
    reset_counts()
    with EncoderTap() as tap:
        run = engine_schedule(
            eng, lambda s: audio[s], half=ENGINE_TONES_HALF,
            late=(ENGINE_TONES_LATE,),
            late_tick=int(TONES_SECONDS * 16000 / cc.shift_samples) // 4,
            tap=tap)
        torch.cuda.synchronize()
        steps = tap.calls
    counts = kernel_counts()
    for k in launches:
        launches[k] += counts[k]
    agree = [position_agreement(streamed_part(run["finals"][s], w),
                                w["streamed"])
             for s, w in enumerate(solo)]
    ter = token_error([[t for t, _ in run["finals"][s]]
                       for s in range(TONES_STREAMS)], truths)
    out["w8a8 R=13 device"] = dict(ter=ter, solo_agreement=agree,
                                   launches=counts)
    log(f"  W8A8 + int8 K/V bf16 R=13 device: token error {ter:.4f}, "
        f"position agreement with solo W8A8 bf16 sessions over the chunks of "
        f"real audio {min(agree):.4f}-{max(agree):.4f} (tol "
        f"{TOL_W8A8_TOKEN_AGREE}), launches {json.dumps(counts)}")
    want = {"attn": cfg.n_layers * steps, "q8": 0,
            "w8a8": 10 * cfg.n_layers * steps}
    if (min(agree) < TOL_W8A8_TOKEN_AGREE or not ter < TONES_TER_MAX
            or counts != want or not steps):
        failures.append(f"engine tones W8A8: agreement {agree}, token error "
                        f"{ter:.4f}, launches {counts} (want {want})")

    # endpointing (tests/test_serving.py:1363-1423) on the card
    sil, scfg, svocab = load_model(os.path.join(here, "weights",
                                                "tones_tiny_sil.gguf"),
                                   device="cuda")
    truth, pcm = SIL_LABELS, sil_pcm()
    for dsp in ("numpy", "device"):
        cc = CacheConfig(att_right_context=13, n_mels=scfg.n_mels)
        eng = ServingEngine(sil, scfg, svocab, cc, n_slots=2,
                            compute_dtype=f32, dsp=dsp,
                            endpoint_silence_s=1.0, endpoint_reset=True)
        s = eng.add_stream()
        q = cc.shift_samples
        events = []
        reset_counts()
        for t in range(len(pcm) // q):
            eng.feed_audio({s: pcm[t * q:(t + 1) * q]})
            eng.step()
            events.extend(eng.poll_endpoints())
        counts = kernel_counts()
        for k in launches:
            launches[k] += counts[k]
        labels = [[int(svocab[i].replace("▁T", "")) for i, _ in toks]
                  for _s, _t, toks in events]
        dist = [edit_distance(g, w) for g, w in zip(labels, truth)]
        done = eng.stats()["utterances_finalized"]
        out[f"endpoint {dsp}"] = dict(events=len(events), distances=dist,
                                      utterances_finalized=done)
        log(f"  endpointing ({dsp} DSP): {len(events)} events, labels "
            f"{labels}, Levenshtein to the truth {dist}, "
            f"utterances_finalized {done}")
        if len(events) != 2 or max(dist) > 1 or done != 2 \
                or not counts["attn"]:
            failures.append(f"engine endpointing {dsp}: {len(events)} events,"
                            f" distances {dist}, finalized {done}")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 9: the network server (slice 9)
# ---------------------------------------------------------------------------

def start_server_module(args, env, cwd):
    """`python -m nemotron_tpu_torch.asr_server` with `args`; returns the
    process (read its port with server_port)."""
    return subprocess.Popen(
        [sys.executable, "-m", "nemotron_tpu_torch.asr_server", *args,
         "--port", "0", "--tick-ms", "20"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=cwd)


def server_port(proc) -> tuple[int, str]:
    """The TCP port a server module prints on stderr when it listens, and
    that line."""
    head = []
    t_end = time.time() + 300
    while time.time() < t_end:
        line = proc.stderr.readline()
        if not line:
            break
        head.append(line)
        if line.startswith("listening on "):
            return int(line.split()[2].rsplit(":", 1)[1]), line.strip()
    raise RuntimeError("asr_server did not start: " + "".join(head)[-2000:])


def stop_process(proc) -> str:
    """Stop a server module with SIGINT (a clean stop); returns its
    stdout."""
    proc.send_signal(signal.SIGINT)
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return out


class ServerThread:
    """An ASRServer on its own event loop in a daemon thread; the engine's
    calls run in that loop's default thread pool, as in a deployment.
    Every tick that stepped the engine is timed: its wall
    (ASRServer._tick_once) less its wait for the engine lock, the wait,
    and the engine steps it ran under the lock with their own time."""

    def __init__(self, engine, **srv_kw):
        import asyncio
        import threading

        from nemotron_tpu_torch.server import ASRServer

        class TimedLock(asyncio.Lock):
            """The engine lock, recording for the holding task its wait
            and the engine's step count at acquire and at release."""

            def __init__(self):
                super().__init__()
                self.held = {}

            async def acquire(self):
                t0 = time.perf_counter()
                await super().acquire()
                self.held[asyncio.current_task()] = [
                    time.perf_counter() - t0, len(engine.step_times), None]
                return True

            def release(self):
                rec = self.held.get(asyncio.current_task())
                if rec is not None:
                    rec[2] = len(engine.step_times)
                super().release()

        self.loop = asyncio.new_event_loop()
        self.srv = ASRServer(engine, host="127.0.0.1", port=0,
                             http_stats_port=0, ws_port=0, **srv_kw)
        self.srv._lock = lock = TimedLock()
        self.ticks = []     # (own s, lock wait s, engine steps, their s)
        tick_once = self.srv._tick_once

        async def timed_tick():
            t0 = time.perf_counter()
            await tick_once()
            wall = time.perf_counter() - t0
            rec = lock.held.pop(asyncio.current_task(), None)
            if rec is not None and rec[2] is not None and rec[2] > rec[1]:
                wait, n0, n1 = rec
                self.ticks.append((wall - wait, wait, n1 - n0,
                                   sum(engine.step_times[n0:n1])))

        self.srv._tick_once = timed_tick
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.srv.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        if not started.wait(120):
            raise RuntimeError("server did not start")

    def engine_lock(self):
        """A context that holds the server's engine lock (taken on the
        server's loop), so that no engine call is in flight inside it."""
        import asyncio
        import contextlib
        import threading

        got, done = threading.Event(), threading.Event()

        async def hold():
            async with self.srv._lock:
                got.set()
                await asyncio.get_running_loop().run_in_executor(None,
                                                                 done.wait)

        @contextlib.contextmanager
        def held():
            fut = asyncio.run_coroutine_threadsafe(hold(), self.loop)
            if not got.wait(600):
                raise RuntimeError("engine lock not taken in 600 s")
            try:
                yield
            finally:
                done.set()
                fut.result(120)

        return held()

    def stop(self) -> None:
        import asyncio

        asyncio.run_coroutine_threadsafe(self.srv.stop(),
                                         self.loop).result(120)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        self.loop.close()


def percentiles(xs) -> dict:
    if not xs:
        return {"p50": float("nan"), "p90": float("nan"), "n": 0}
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)), "n": int(a.size)}


def stream_client(kind, host, port, pcm, rate, block, barrier=None,
                  wait_utterances=0, timeout=300.0) -> dict:
    """One streaming client (kind "tcp" or "ws") sending `pcm` in `block`
    samples, paced at `rate` x real time (0: as fast as the socket takes
    it), pumping events every 10 ms between blocks; before its END it
    waits on `barrier` (if given) and for `wait_utterances` UTTERANCE
    events (60 s at most). Returns the FINAL, the UTTERANCE events, the
    joined PARTIAL text, the first-PARTIAL latency (from the first audio
    block) and the END->FINAL latency, in s."""
    from nemotron_tpu_torch.client import ASRClient, WSASRClient
    from nemotron_tpu_torch.server import T_PARTIAL

    c = (ASRClient if kind == "tcp" else WSASRClient)(host, port,
                                                      timeout=timeout)
    first_partial = None
    try:
        ready = c.start()
        t0 = time.perf_counter()

        def look():
            nonlocal first_partial
            if first_partial is None and any(t == T_PARTIAL
                                             for t, _ in c.events):
                first_partial = time.perf_counter() - t0

        for i in range(0, pcm.size, block):
            c.send_audio(pcm[i:i + block])
            look()
            if rate:
                target = t0 + (i + block) / 16000.0 / rate
                while time.perf_counter() < target:
                    time.sleep(0.01)
                    c.pump()
                    look()
        if barrier is not None:
            barrier.wait(600)
        t_wait = time.perf_counter() + 60
        while len(c.utterances) < wait_utterances and \
                time.perf_counter() < t_wait:
            time.sleep(0.01)
            c.pump()
        c.pump()
        look()
        t_end = time.perf_counter()
        final = c.end()
        end_to_final = time.perf_counter() - t_end
        look()
        return dict(ready=ready, final=final, utterances=list(c.utterances),
                    partials=c.transcript, first_partial_s=first_partial,
                    end_to_final_s=end_to_final)
    finally:
        c.close()


def rest_client(http_port, pcm, timeout=300.0) -> dict:
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(f"http://127.0.0.1:{http_port}/transcribe",
                                 data=pcm.tobytes(), method="POST")
    body = urllib.request.urlopen(req, timeout=timeout).read()
    return dict(final=json.loads(body), latency_s=time.perf_counter() - t0)


def client_threads(ports, pcms, n_tcp, n_ws, n_rest, rate, block,
                   rest_start_s, barrier, wait_utterances) -> dict:
    """The clients of run_clients, one thread each, in this process."""
    import threading

    results, errors = {}, []

    def go(k, fn, *args):
        try:
            results[k] = fn(*args)
        except Exception as e:  # noqa: BLE001 -- raised below
            errors.append(f"client {k}: {e!r}")
            if barrier is not None:
                barrier.abort()

    threads = []
    for k in range(n_tcp + n_ws):
        kind, port = ("tcp", ports["tcp"]) if k < n_tcp else ("ws",
                                                               ports["ws"])
        threads.append(threading.Thread(target=go, args=(
            k, stream_client, kind, "127.0.0.1", port, pcms[k], rate, block,
            barrier, wait_utterances)))
    for j in range(n_rest):
        k = n_tcp + n_ws + j

        def rest(k=k, j=j):
            time.sleep(rest_start_s + 0.25 * j)
            return rest_client(ports["http"], pcms[k])

        threads.append(threading.Thread(target=go, args=(k, rest)))
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if errors or len(results) != len(threads):
        raise RuntimeError(f"server clients failed: {errors[:4]} "
                           f"({len(results)} of {len(threads)} done)")
    return results


def client_process(conn, *args) -> None:
    """Entry of the client process: client_threads, its result or error
    sent back through `conn`."""
    try:
        conn.send(("ok", client_threads(*args)))
    except Exception as e:  # noqa: BLE001 -- reported to the parent
        conn.send(("error", repr(e)))


def client_barrier(parties: int):
    """A barrier shared with the client process."""
    import multiprocessing

    return multiprocessing.get_context("spawn").Barrier(parties)


def run_clients(st, pcms, n_tcp, n_ws, n_rest, rate, block=1600,
                rest_start_s=1.0, barrier=None, wait_utterances=0) -> dict:
    """The server cells' load, all at once, from a process of its own (so
    that 64 client threads do not take the server's interpreter lock): n_tcp
    TCP and n_ws WebSocket clients streaming at `rate` x real time, and
    n_rest POST /transcribe requests, one every 0.25 s from rest_start_s
    on. Client k sends pcms[k] (TCP first, then WebSocket, then REST).
    With a `barrier` (client_barrier(n_tcp + n_ws + 1)) the streaming
    clients wait on it after their last block, before END. Any client's
    error is raised here; the process is always stopped."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    ours, theirs = ctx.Pipe()
    ports = {"tcp": st.srv.port, "ws": st.srv.ws_port,
             "http": st.srv.http_stats_port}
    proc = ctx.Process(target=client_process, daemon=True, args=(
        theirs, ports, list(pcms), n_tcp, n_ws, n_rest, rate, block,
        rest_start_s, barrier, wait_utterances))
    proc.start()
    try:
        t_end = time.perf_counter() + 1200
        while not ours.poll(1.0):
            if not proc.is_alive() or time.perf_counter() > t_end:
                raise RuntimeError(f"the client process ended (exit "
                                   f"{proc.exitcode}) or ran out of time "
                                   "without a result")
        status, res = ours.recv()
    finally:
        proc.join(60)
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    if status != "ok":
        if barrier is not None:
            barrier.abort()
        raise RuntimeError(res)
    return res


def check_payload(name, final, want_tokens, vocab, spf, tol, failures):
    """A FINAL (or REST) payload against the tokens it should carry: ids
    and frames equal, log-posteriors within tol, words equal to
    tokens_to_words of the tokens. Returns the largest log-posterior
    gap."""
    from nemotron_tpu_torch.utils.subtitles import tokens_to_words

    got = [tuple(t) for t in final["tokens"]]
    gap = max((abs(g[2] - w[2]) for g, w in zip(got, want_tokens)),
              default=0.0)
    words = [list(w) for w in tokens_to_words(got, vocab,
                                              seconds_per_frame=spf)]
    ok = ([t[:2] for t in got] == [t[:2] for t in want_tokens]
          and bool(got) and all(len(t) == 3 for t in got) and gap <= tol
          and final.get("words") == words)
    if not ok:
        failures.append(f"{name}: {len(got)} tokens against {len(want_tokens)}"
                        f", conf gap {gap:.3e} (tol {tol:.0e}), words "
                        f"{'equal' if final.get('words') == words else 'differ'}")
    return gap


def server_cell(name, params, cfg, vocab, cc, dtype, dsp, failures,
                kernel, per_layer, solo_check) -> dict:
    """One full-width server cell: an engine of SERVER_SLOTS slots with
    confidence behind an ASRServer and the load of run_clients at the
    real-time rate, then every client's result held against a solo
    session by `solo_check(results)`. The profile (CUPTI, which sees the
    kernels of every thread) covers the load from its start until every
    streaming client has sent its audio, and is stopped under the engine
    lock, so that its launches fall into whole engine steps; the ENDs go
    out after it."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from nemotron_tpu_torch.streaming.serving import ServingEngine

    n_clients = SERVER_TCP + SERVER_WS + SERVER_REST
    eng = ServingEngine(params, cfg, vocab, cc, n_slots=SERVER_SLOTS,
                        compute_dtype=dtype, dsp=dsp, confidence=True)
    st = ServerThread(eng)
    try:
        # warm-up: one stream through every path of a tick, then reset
        run_clients(st, [seeded_pcm(900 + k, 2.5) for k in range(3)], 1, 1,
                    1, 0)
        eng.step_times.clear()
        st.ticks.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        box = {}
        barrier = client_barrier(SERVER_TCP + SERVER_WS + 1)
        pcms = [seeded_pcm(k, SERVER_SECONDS) for k in range(n_clients)]

        def load():
            try:
                box["run"] = run_clients(st, pcms, SERVER_TCP, SERVER_WS,
                                         SERVER_REST, 1.0, barrier=barrier)
            except Exception as e:  # noqa: BLE001 -- raised below
                box["error"] = e
                barrier.abort()

        with EncoderTap() as tap:
            # device activity only: the window holds ~40 engine steps of
            # ~6,000 launches each, and host-op events would multiply the
            # trace the summary walks
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            time.sleep(PROFILE_HEAD_S)
            t0 = time.perf_counter()
            loader = threading.Thread(target=load, daemon=True)
            loader.start()
            try:
                barrier.wait(600)      # every stream has sent its audio
            except threading.BrokenBarrierError:
                pass
            with st.engine_lock():
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
                prof.stop()
                window_steps, window_counts = tap.calls, kernel_counts()
            loader.join(900)
            steps = tap.calls
        if "error" in box or "run" not in box:
            raise RuntimeError(f"server {name}: the load failed: "
                               f"{box.get('error')!r}")
        prof = profile_summary(prof, wall_us)
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        results = box["run"]
        stats = st.srv.stats()
    finally:
        st.stop()
    tick_ms = [w * 1e3 for w, _, _, _ in st.ticks]
    wait_ms = [w * 1e3 for _, w, _, _ in st.ticks]
    overhead_ms = [(w - e) * 1e3 for w, _, _, e in st.ticks]
    eng_ms = [t * 1e3 for t in eng.step_times]
    streams = [results[k] for k in range(SERVER_TCP + SERVER_WS)]
    e2f = percentiles([r["end_to_final_s"] * 1e3 for r in streams])
    fp = [r["first_partial_s"] for r in streams]
    first = percentiles([x * 1e3 for x in fp if x is not None])
    rest = percentiles([results[k]["latency_s"] * 1e3
                        for k in range(SERVER_TCP + SERVER_WS, n_clients)])
    busy = prof["busy_us"] / prof["wall_us"] if prof["wall_us"] else 0.0
    attn_n = launches_of(prof, "ring_attn_cluster_kernel")
    mm_prefix = f"{kernel}_matmul"
    mm_n = launches_of(prof, mm_prefix)
    other = "q8" if kernel == "w8a8" else "w8a8"
    out = dict(
        tick_ms=percentiles(tick_ms), engine_step_ms=percentiles(eng_ms),
        server_overhead_ms=percentiles(overhead_ms),
        lock_wait_ms=percentiles(wait_ms),
        steps_per_tick=float(np.mean([n for _, _, n, _ in st.ticks] or [0])),
        end_to_final_ms=e2f, first_partial_ms=first, rest_ms=rest,
        partial_never=sum(x is None for x in fp), busy_share=busy,
        wall_ms=prof["wall_us"] / 1e3, busy_ms=prof["busy_us"] / 1e3,
        encoder_steps=steps, window_encoder_steps=window_steps,
        ticks=len(st.ticks), peak_gib=peak, launches=counts,
        window_launches=window_counts,
        launches_per_step={
            "ring_attn_cluster_kernel": attn_n / max(window_steps, 1),
            mm_prefix: mm_n / max(window_steps, 1)},
        engine_rtf=sum(eng.step_times) / (n_clients * SERVER_SECONDS),
        connections_total=stats["connections_total"])
    log(f"  server {name}: {SERVER_TCP} TCP + {SERVER_WS} WebSocket clients "
        f"at the real-time rate, {SERVER_REST} POST /transcribe, "
        f"{SERVER_SECONDS:g} s each; {len(st.ticks)} ticks that stepped "
        f"({steps} encoder steps): server tick p50 "
        f"{out['tick_ms']['p50']:.2f} / p90 {out['tick_ms']['p90']:.2f} ms "
        f"({out['steps_per_tick']:.2f} engine steps a tick; the tick's time "
        f"outside its engine steps p50 "
        f"{out['server_overhead_ms']['p50']:.2f} / p90 "
        f"{out['server_overhead_ms']['p90']:.2f} ms; its wait for the "
        f"engine lock p50 {out['lock_wait_ms']['p50']:.2f} / p90 "
        f"{out['lock_wait_ms']['p90']:.2f} ms), engine step p50 "
        f"{out['engine_step_ms']['p50']:.2f} / p90 "
        f"{out['engine_step_ms']['p90']:.2f} ms, engine RTF "
        f"{out['engine_rtf']:.4f}; END->FINAL p50 "
        f"{e2f['p50']:.2f} / p90 {e2f['p90']:.2f} ms; first PARTIAL p50 "
        f"{first['p50']:.2f} / p90 {first['p90']:.2f} ms ({out['partial_never']}"
        f" streams saw none before FINAL); REST p50 {rest['p50']:.2f} / p90 "
        f"{rest['p90']:.2f} ms; profile of the streaming part (to the "
        f"last audio block, {window_steps} encoder steps): device busy "
        f"{prof['busy_us'] / 1e3:.2f} of {prof['wall_us'] / 1e3:.2f} ms "
        f"({100 * busy:.1f}%), launches per encoder step by name: "
        f"ring_attn_cluster_kernel {attn_n / max(window_steps, 1):g}, "
        f"{mm_prefix} {mm_n / max(window_steps, 1):g}; wrapper counts over "
        f"the whole load {json.dumps(counts)}; peak {peak:.2f} GiB")
    for kname, us in prof["by_name"][:6]:
        log(f"    {us / 1e3:9.3f} ms  {prof['count'][kname]:7d} launches  "
            f"{kname}")
    want = {"attn": cfg.n_layers * steps,
            kernel: per_layer * cfg.n_layers * steps, other: 0}
    if (not steps or not window_steps or counts != want
            or attn_n != cfg.n_layers * window_steps
            or window_counts["attn"] != attn_n
            or mm_n != per_layer * cfg.n_layers * window_steps
            or window_counts[kernel] != mm_n
            or prof["busy_us"] <= 0 or stats["connections_total"]
            != SERVER_TCP + SERVER_WS + 2):        # + the warm-up's two
        failures.append(f"server {name}: launches {counts} in {steps} "
                        f"encoder steps (want {want}); profile {attn_n}, "
                        f"{mm_n} in {window_steps} (wrappers "
                        f"{window_counts}), busy {prof['busy_us']:.0f} us")
    out.update(solo_check(results))
    return out


def server_phase(gguf_path: str, failures: list) -> dict:
    """The two full-width server cells: Q8_0 f32 with host DSP (every
    client's FINAL or REST payload equal to that of a directly driven
    engine, 8 of them also to solo sessions', log-posteriors within
    TOL_CONF_ABS) and W8A8 + int8 K/V bf16 with device DSP (agreement of
    8 clients with solo bf16 sessions as a reading)."""
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import quantize_model_params
    from nemotron_tpu_torch.streaming.serving import ServingEngine
    from nemotron_tpu_torch.streaming.session import StreamSession

    q8_params, cfg, vocab = full_width_model(gguf_path, "cuda")
    n_clients = SERVER_TCP + SERVER_WS + SERVER_REST
    out = {}
    log(f"phase server: ASRServer over a {SERVER_SLOTS}-slot ServingEngine "
        f"with confidence at full width, R = 13")

    def solo_sessions(params, cc, dtype, ks):
        """One StreamSession (confidence on), reset for each client: its
        tokens over the chunks of real audio and after the finalize."""
        sess = StreamSession(params, cfg, vocab, cc, compute_dtype=dtype,
                             confidence=True)
        solos = {}
        for k in ks:
            sess.reset()
            sess.process(seeded_pcm(k, SERVER_SECONDS))
            streamed, frames = list(sess.get_tokens(0)), sess.frame_offset
            sess.finalize()
            solos[k] = dict(streamed=streamed, frames=frames,
                            final=list(sess.get_tokens(0)))
        return solos

    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    spf = cc.subsampling_factor * cc.hop_length / cc.sample_rate
    # the clients held to solo sessions: TCP, WebSocket and REST alike
    ws0, rest0 = SERVER_TCP, SERVER_TCP + SERVER_WS
    track = (list(range(min(4, SERVER_TCP)))
             + list(range(ws0, ws0 + min(2, SERVER_WS)))
             + list(range(rest0, rest0 + min(2, SERVER_REST))))

    def q8_check(results):
        """Every client against the same audio through a directly driven
        64-slot engine (fed at once, one finalize_streams), and the tracked
        clients against solo sessions: 64 solo sessions would take about
        as long as every other server phase together."""
        t0 = time.perf_counter()
        eng = ServingEngine(q8_params, cfg, vocab, cc, n_slots=SERVER_SLOTS,
                            compute_dtype=torch.float32, dsp="numpy",
                            confidence=True)
        slots = eng.add_streams(n_clients)
        eng.feed_audio({s: seeded_pcm(s, SERVER_SECONDS) for s in slots})
        eng.step()
        direct = [toks for _, toks in
                  eng.finalize_streams(slots, return_tokens=True)]
        del eng
        solos = solo_sessions(q8_params, cc, torch.float32, track)
        checks = [(f"client {k} vs the direct engine", k, direct[k])
                  for k in range(n_clients)] + [
                  (f"client {k} vs its solo session", k, solos[k]["final"])
                  for k in track]
        bad, gaps = len(failures), []
        for name, k, want in checks:
            gaps.append(check_payload(f"server Q8_0 {name}",
                                      results[k]["final"], want, vocab, spf,
                                      TOL_CONF_ABS, failures))
        for k in range(SERVER_TCP + SERVER_WS):
            if results[k]["partials"] != results[k]["final"]["text"]:
                failures.append(f"server Q8_0 client {k}: PARTIALs do not "
                                "join to the FINAL text")
        ok = len(failures) == bad
        log(f"  Q8_0 f32: the FINAL/REST tokens of all {n_clients} clients "
            f"equal to a directly driven engine's and those of clients "
            f"{track} to their solo f32 sessions (confidence on): {ok}; "
            f"words equal to tokens_to_words; largest log-posterior gap "
            f"{max(gaps):.3e} (tol {TOL_CONF_ABS:.0e}) (references "
            f"{time.perf_counter() - t0:.1f} s)")
        return dict(all_equal=ok, clients=n_clients, solo_tracked=track,
                    conf_gap=max(gaps))

    t0 = time.perf_counter()
    out["q8_f32"] = server_cell("Q8_0 f32 host DSP", q8_params, cfg, vocab,
                                cc, torch.float32, "numpy", failures, "q8",
                                10, q8_check)
    log(f"  (cell wall {time.perf_counter() - t0:.1f} s)")

    w8 = quantize_model_params(q8_params, mode="w8a8")
    cc8 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels,
                      kv_cache_int8=True)

    def w8_check(results):
        solos = solo_sessions(w8, cc8, torch.bfloat16, track)
        agree = []
        for k in track:
            got = [tuple(t)[:2] for t in results[k]["final"]["tokens"]
                   if t[1] < solos[k]["frames"]]
            agree.append(position_agreement(
                got, [t[:2] for t in solos[k]["streamed"]]))
            if not results[k]["final"]["tokens"]:
                failures.append(f"server W8A8 client {k}: no tokens")
        log(f"  W8A8 bf16 (a reading, the tier is chaotic at full width): "
            f"position agreement with solo W8A8 bf16 sessions over the "
            f"chunks of real audio, {len(track)} clients: min "
            f"{min(agree):.4f}, mean {float(np.mean(agree)):.4f}")
        return dict(solo_agreement_min=min(agree),
                    solo_agreement_mean=float(np.mean(agree)),
                    tracked=len(track))

    t0 = time.perf_counter()
    out["w8a8_bf16"] = server_cell("W8A8 bf16 device DSP", w8, cfg, vocab,
                                   cc8, torch.bfloat16, "device", failures,
                                   "w8a8", 10, w8_check)
    log(f"  (cell wall {time.perf_counter() - t0:.1f} s)")
    return out


def server_tones_phase(failures: list) -> dict:
    """The trained fixtures through the server (f32, the engine's default
    device DSP, confidence on): 8 TCP clients of 15 s at R = 0 and R = 13
    (token error against the labels, an SRT from the FINAL words against
    write_subtitles of the same tokens), and endpointing on
    tones_tiny_sil.gguf (2 UTTERANCE events with words, each within
    Levenshtein 1 of its labels)."""
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.streaming.serving import ServingEngine
    from nemotron_tpu_torch.utils.subtitles import (format_srt,
                                                    words_to_cues,
                                                    write_subtitles)
    from nemotron_tpu_torch.utils.text import edit_distance
    from nemotron_tpu_torch.utils.tones import make_eval_streams

    here = os.path.dirname(os.path.abspath(__file__))
    params, cfg, vocab = load_model(os.path.join(here, "weights",
                                                 "tones_tiny.gguf"),
                                    device="cuda")
    audio, truths = make_eval_streams(TONES_STREAMS, TONES_SECONDS, TONES_N,
                                      seed=TONES_SEED)
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    out = {}
    log(f"phase server tones: {TONES_STREAMS} TCP clients of "
        f"{TONES_SECONDS:g} s (seed {TONES_SEED}), 4x the real-time rate")
    for R in (0, 13):
        cc = CacheConfig(att_right_context=R, n_mels=cfg.n_mels)
        eng = ServingEngine(params, cfg, vocab, cc, n_slots=TONES_STREAMS,
                            compute_dtype=torch.float32, confidence=True)
        st = ServerThread(eng)
        reset_counts()
        try:
            res = run_clients(st, audio, TONES_STREAMS, 0, 0, 4.0)
        finally:
            st.stop()
        counts = kernel_counts()
        for k in launches:
            launches[k] += counts[k]
        finals = [res[k]["final"] for k in range(TONES_STREAMS)]
        ter = token_error([[t[0] for t in f["tokens"]] for f in finals],
                          truths)
        srt_ok = True
        with tempfile.TemporaryDirectory() as tmp:
            for k, f in enumerate(finals):
                path = os.path.join(tmp, f"{k}.srt")
                write_subtitles(path, [tuple(t) for t in f["tokens"]], vocab,
                                "srt")
                with open(path, encoding="utf-8") as fh:
                    srt_ok &= fh.read() == format_srt(words_to_cues(
                        f["words"])) != ""
        ticks = [w * 1e3 for w, _, _, _ in st.ticks]
        out[f"R={R}"] = dict(ter=ter, srt_equal=srt_ok,
                             tick_ms=percentiles(ticks), launches=counts,
                             dsp=eng.dsp_mode)
        log(f"  R={R} ({eng.dsp_mode} DSP): token error {ter:.4f} (tol "
            f"{TONES_TER_MAX}), SRT from FINAL words equal to write_subtitles "
            f"of the tokens: {srt_ok}, server tick p50 "
            f"{out[f'R={R}']['tick_ms']['p50']:.2f} / p90 "
            f"{out[f'R={R}']['tick_ms']['p90']:.2f} ms, launches "
            f"{json.dumps(counts)}")
        if not ter < TONES_TER_MAX or not srt_ok or not counts["attn"]:
            failures.append(f"server tones R={R}: token error {ter:.4f}, srt "
                            f"{srt_ok}, launches {counts}")

    sil, scfg, svocab = load_model(os.path.join(here, "weights",
                                                "tones_tiny_sil.gguf"),
                                   device="cuda")
    truth, pcm = SIL_LABELS, sil_pcm()
    eng = ServingEngine(sil, scfg, svocab,
                        CacheConfig(att_right_context=13, n_mels=scfg.n_mels),
                        n_slots=2, compute_dtype=torch.float32,
                        confidence=True, endpoint_silence_s=1.0,
                        endpoint_reset=True)
    st = ServerThread(eng)
    reset_counts()
    try:
        res = run_clients(st, [pcm], 1, 0, 0, 4.0, wait_utterances=2)[0]
    finally:
        st.stop()
    counts = kernel_counts()
    for k in launches:
        launches[k] += counts[k]
    utts = res["utterances"]
    labels = [[int(svocab[t[0]].replace("▁T", "")) for t in u["tokens"]]
              for u in utts]
    dist = [edit_distance(g, w) for g, w in zip(labels, truth)]
    with_words = all(u.get("words") for u in utts)
    out["endpoint"] = dict(events=len(utts), distances=dist,
                           words=with_words, dsp=eng.dsp_mode)
    log(f"  endpointing ({eng.dsp_mode} DSP): {len(utts)} UTTERANCE events, "
        f"labels {labels}, Levenshtein to the truth {dist}, words on every "
        f"event {with_words}")
    if len(utts) != 2 or max(dist) > 1 or not with_words \
            or [u["index"] for u in utts] != [0, 1]:
        failures.append(f"server endpointing: {len(utts)} events, distances "
                        f"{dist}, words {with_words}")
    out["launches"] = launches
    return out


def conf_annotations_close(a: str, b: str, tol: float = 0.01) -> bool:
    """Two transcripts equal once each {p=x.xx} is compared within `tol`
    (a log-posterior within the card tolerance can round to the next
    hundredth of a posterior)."""
    import re

    pat = re.compile(r"\{p=(\d+\.\d+)\}")
    pa, pb = pat.findall(a), pat.findall(b)
    return (pat.sub("{p}", a) == pat.sub("{p}", b) and len(pa) == len(pb)
            and all(abs(float(x) - float(y)) <= tol + 1e-9
                    for x, y in zip(pa, pb)))


def cli_phase(failures: list) -> dict:
    """The user's entry points on the card, each against the same command
    with --cpu: the batch CLI with --confidence --srt, the streaming CLI
    with --timestamps --confidence --vtt=FILE (stdout equal up to the
    {p=...} hundredths, subtitle files byte-equal); then
    `python -m nemotron_tpu_torch.asr_server` on the card with
    `python -m nemotron_tpu_torch.asr_client` replaying a recording over
    TCP with --srt (the server's defaults: bf16, device DSP): the
    transcript's token error against the labels, the SRT's words against
    the transcript's."""
    from nemotron_tpu_torch.utils.tones import make_eval_streams

    here = os.path.dirname(os.path.abspath(__file__))
    fixture = os.path.join(here, "weights", "tones_tiny.gguf")
    env = dict(os.environ, PYTHONPATH=here)
    out = {}
    audio, truths = make_eval_streams(2, 8.0, TONES_N, seed=TONES_SEED + 1)

    def start(args, cwd):
        return (subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env,
                                 cwd=cwd), args, time.perf_counter())

    def finish(started):
        proc, args, t0 = started
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{' '.join(args[:2])}: exit {proc.returncode}:"
                               f" {err[-2000:]}")
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        # the four CLI runs at once (the CPU runs need no card; the card
        # runs' walls are not the subject here)
        started = {}
        for dev in ("cuda", "cpu"):
            d = os.path.join(tmp, dev)
            os.makedirs(d)
            paths = []
            for k in range(2):
                paths.append(os.path.join(d, f"s{k}.pcm"))
                audio[k].astype("<i2").tofile(paths[-1])
            flag = ["--cpu"] if dev == "cpu" else []
            started[dev, "batch"] = start(
                ["-m", "nemotron_tpu_torch.cli_transcribe", fixture, *paths,
                 "--confidence", "--srt", *flag], d)
            started[dev, "stream"] = start(
                ["-m", "nemotron_tpu_torch.cli", fixture, paths[0], "80",
                 "13", "--timestamps", "--confidence",
                 f"--vtt={os.path.join(d, 's0.vtt')}", *flag], d)
        done = {key: finish(st) for key, st in started.items()}
        runs = {}
        for dev in ("cuda", "cpu"):
            d = os.path.join(tmp, dev)
            subs = {}
            for name in ("s0.srt", "s1.srt", "s0.vtt"):
                with open(os.path.join(d, name), "rb") as f:
                    subs[name] = f.read()
            runs[dev] = dict(batch=done[dev, "batch"][0].replace(d, "D"),
                             stream=done[dev, "stream"][0], subs=subs,
                             wall_s=dict(batch=done[dev, "batch"][1],
                                         stream=done[dev, "stream"][1]))
        same_subs = runs["cuda"]["subs"] == runs["cpu"]["subs"]
        batch_ok = conf_annotations_close(runs["cuda"]["batch"],
                                          runs["cpu"]["batch"])
        stream_ok = conf_annotations_close(runs["cuda"]["stream"],
                                           runs["cpu"]["stream"])
        out["clis"] = dict(batch_equal=batch_ok, stream_equal=stream_ok,
                           subtitles_equal=same_subs,
                           batch_stdout_exact=runs["cuda"]["batch"]
                           == runs["cpu"]["batch"],
                           stream_stdout_exact=runs["cuda"]["stream"]
                           == runs["cpu"]["stream"],
                           wall_s={d: runs[d]["wall_s"] for d in runs})
        log(f"  CLIs on the card against --cpu: batch --confidence --srt "
            f"stdout {'equal' if batch_ok else 'DIFFERENT'} (exact: "
            f"{out['clis']['batch_stdout_exact']}), streaming --timestamps "
            f"--confidence --vtt stdout {'equal' if stream_ok else 'DIFFERENT'}"
            f" (exact: {out['clis']['stream_stdout_exact']}), SRT/VTT files "
            f"byte-equal {same_subs}; walls {json.dumps(out['clis']['wall_s'])}")
        if not (batch_ok and stream_ok and same_subs):
            failures.append(f"CLIs on the card: {out['clis']}")

        # the server and client modules as a user runs them
        proc = start_server_module([fixture, "--slots", "4", "--confidence"],
                                   env, here)
        try:
            port, listening = server_port(proc)
            srt = os.path.join(tmp, "client.srt")
            transcript, ct = finish(start(
                ["-m", "nemotron_tpu_torch.asr_client", f"127.0.0.1:{port}",
                 os.path.join(tmp, "cpu", "s1.pcm"), "--rate", "max",
                 "--srt", srt], tmp))
            with open(srt, "rb") as f:
                client_srt = f.read()
        finally:
            server_out = stop_process(proc)
        # the client's transcript against the recording's labels, and its
        # SRT against the transcript's words
        import re

        from nemotron_tpu_torch.params import load_model

        ids = {piece: i for i, piece in
               enumerate(load_model(fixture, device="cpu")[2])}
        got = [ids.get(f"\u2581{w}", -1) for w in transcript.split()]
        ter = token_error([got], [list(truths[1])])
        cue_words = " ".join(
            ln for ln in client_srt.decode().splitlines()
            if ln and not ln.isdigit() and "-->" not in ln).split()
        ok = (ter < TONES_TER_MAX and cue_words == transcript.split()
              and server_out == "" and "device=cuda" in listening
              and bool(re.search(r"\d --> \d", client_srt.decode())))
        out["server_entry_point"] = dict(ter=ter, srt_words_equal=cue_words
                                         == transcript.split(),
                                         server_stdout_empty=server_out == "",
                                         client_wall_s=ct)
        log(f"  asr_server on the card ({listening}) with asr_client "
            f"--srt over TCP: token error {ter:.4f} against the labels (tol "
            f"{TONES_TER_MAX}), SRT cue words equal to the transcript's "
            f"{cue_words == transcript.split()}, server stdout empty "
            f"{server_out == ''} (client wall {ct:.1f} s)")
        if not ok:
            failures.append(f"asr_server/asr_client on the card: "
                            f"{out['server_entry_point']}, {listening!r}")
    return out


# ---------------------------------------------------------------------------
# phase 10: the rest of the quant tiers and snapshots (slice 10)
# ---------------------------------------------------------------------------

def sq_quantize(dense, cfg, cc, pcm, static: bool = True):
    """SmoothQuant on the params' device: calibrated on the log-mel of
    `pcm` (int16, 1-D) with cc's chunked visibility, folded and
    W8A8-quantized, with static activation scales when `static`."""
    from nemotron_tpu_torch.config import PreprocessorConfig
    from nemotron_tpu_torch.frontend.preprocessor import StreamingPreprocessor
    from nemotron_tpu_torch.ops.smoothquant import smooth_quantize

    pre = StreamingPreprocessor(
        dense.preprocessor.filterbank.float().cpu().numpy(),
        dense.preprocessor.window.float().cpu().numpy(),
        cfg=PreprocessorConfig(n_mels=cfg.n_mels), device=dense.device)
    mel = pre.process(pcm)
    return smooth_quantize(dense, cfg, mel, att_chunk=cc.chunk_enc_len,
                           static_act=static)


def sessions_equal(a, b) -> bool:
    """Two sessions' tokens and every state leaf bit-equal."""
    import torch

    return a.tokens == b.tokens and all(
        torch.equal(getattr(x, f), getattr(y, f))
        for x, y in ((a.enc_state, b.enc_state), (a.dec_state, b.dec_state))
        for f in x.__dataclass_fields__)


def snapshot_session(make, pcm, cut, tmp):
    """A session saved after pcm[:, :cut], resumed in a fresh one from the
    file: (uninterrupted, resumed, save s, load s, file bytes)."""
    import torch

    path = os.path.join(tmp, "session.npz")
    ref = make()
    ref.process(pcm[:, :cut])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref.save(path)
    save_s = time.perf_counter() - t0
    ref.process(pcm[:, cut:])
    ref.finalize()
    res = make()
    t0 = time.perf_counter()
    res.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    res.process(pcm[:, cut:])
    res.finalize()
    return ref, res, save_s, load_s, os.path.getsize(path)


def snapshot_engine(make, tmp) -> dict:
    """The 64-slot engine on a ragged load (the last ENGINE_HALF slots at
    half rate), saved half-way with a partial PCM block staged, and
    loaded into a fresh engine that finishes the load: every slot's final
    tokens against the uninterrupted engine's."""
    import torch

    eng = make()
    n, q = eng.n_slots, eng.cc.shift_samples
    pcm = {s: seeded_pcm(s, ENGINE_SECONDS) for s in range(n)}
    feeds, pos = [], {s: 0 for s in range(n)}
    while any(pos[s] < pcm[s].size for s in range(n)):
        t, f = len(feeds), {}
        for s in range(n):
            if s >= n - ENGINE_HALF and t % 2:
                continue
            a = pcm[s][pos[s]:pos[s] + q]
            if a.size:
                f[s] = a
                pos[s] += a.size
        feeds.append(f)
    cut = len(feeds) // 2
    staged = {0: feeds[cut][0][:q // 2]}
    feeds[cut][0] = feeds[cut][0][q // 2:]
    path = os.path.join(tmp, "engine.npz")

    def drive(e, ticks):
        for t in ticks:
            e.feed_audio(feeds[t])
            e.step()

    eng.add_streams(n)
    drive(eng, range(cut))
    eng.feed_audio(staged)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.save(path)
    save_s = time.perf_counter() - t0
    drive(eng, range(cut, len(feeds)))
    want = eng.finalize_streams(list(range(n)), return_tokens=True)
    del eng
    res = make()
    t0 = time.perf_counter()
    res.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    drive(res, range(cut, len(feeds)))
    got = res.finalize_streams(list(range(n)), return_tokens=True)
    return dict(equal_slots=sum(g == w for g, w in zip(got, want)),
                slots=n, tokens=sum(len(w[1]) for w in want), save_s=save_s,
                load_s=load_s, bytes=os.path.getsize(path), ticks=len(feeds),
                cut_tick=cut)


def quant_tier_phase(gguf_path: str, failures: list) -> dict:
    """Slice 10 at full width, COMPARE_LAYERS layers: SmoothQuant
    calibrated on the card, then
    w8a8-sq-static with int4 rings (bf16, 8 streams) in the four modes,
    launches a step by name; the int8 dynamic tier timed beside it, and
    readings against it and the port's CPU run; --rc-by-layer on Q8_0 f32
    against the CPU (exact); the 64-slot engine on both tiers; snapshots
    on the card (sessions, the CPU continuing a card snapshot, the 64-slot
    engine in both DSP modes). Garbage of the earlier phases is collected
    first, so that the peaks are this phase's."""
    import gc

    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import quantize_model_params, to_device
    from nemotron_tpu_torch.streaming.serving import ServingEngine
    from nemotron_tpu_torch.streaming.session import StreamSession

    bf16, f32 = torch.bfloat16, torch.float32
    out = {"modes": {}}
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    gc.collect()

    def count(fn):
        return counted(fn, launches)

    t0 = time.perf_counter()
    dense, cfg, vocab = compare_model(full_width_model(gguf_path, "cuda"))
    dense = dense_of(dense)
    cc13 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels,
                       kv_cache_int4=True)
    t1 = time.perf_counter()
    sq = sq_quantize(dense, cfg, cc13, seeded_pcm(SQ_CALIB_STREAM,
                                                  SQ_CALIB_SECONDS))
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t1
    del dense
    act = [float(sq.layers.attn_q_w.act_scale[l]) for l in (0, cfg.n_layers - 1)]
    out["calibration_s"] = calib_s
    log(f"phase quant tiers ({cfg.n_layers} layers): the dense weights "
        f"(Q8_0 dequantized) {t1 - t0:.1f} s; SmoothQuant on the "
        f"card over {SQ_CALIB_SECONDS:g} s of seeded PCM, fold, W8A8 and "
        f"static scales {calib_s:.1f} s; attn q static scale layer 0 "
        f"{act[0]:.4e}, layer {cfg.n_layers - 1} {act[1]:.4e}")

    S = W8A8_STREAMS
    pcm = np.stack([seeded_pcm(s) for s in range(S)])
    tokens13 = None
    for R in MODES:
        cc = CacheConfig(att_right_context=R, n_mels=cfg.n_mels,
                         kv_cache_int4=True)
        run_session(sq, cfg, vocab, cc, pcm[:, :cc.chunk_samples * 2], bf16)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        sess, n = count(lambda: run_session(
            sq, cfg, vocab, cc, pcm[:, :int(mode_seconds(R) * 16000)], bf16))
        chunks = sess.total_chunks
        toks = [sess.get_tokens(s) for s in range(S)]
        res = dict(chunks=chunks, tokens=sum(map(len, toks)),
                   chunk_ms=sess.chunk_seconds / max(chunks, 1) * 1e3,
                   rtf=sess.rtf, launches=n,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        out["modes"][f"R={R}"] = res
        log(f"  w8a8-sq-static + int4 K/V bf16 S={S} R={R}: {chunks} chunks, "
            f"{res['tokens']} tokens, mean chunk {res['chunk_ms']:.2f} ms, "
            f"RTF {sess.rtf:.4f}, peak {res['peak_gib']:.2f} GiB, launches "
            f"{json.dumps(n)}, ring {tuple(sess.enc_state.k_cache.shape)} "
            f"{str(sess.enc_state.k_cache.dtype)[6:]}")
        want = {"attn": cfg.n_layers * chunks, "q8": 0,
                "w8a8": 10 * cfg.n_layers * chunks}
        if not chunks or n != want or not res["tokens"]:
            failures.append(f"quant tier R={R}: launches {n} (want {want})")
        if R == 13:
            tokens13 = toks
        del sess

    # launches a step by name, in a profile of R = 13 chunks
    sess = StreamSession(sq, cfg, vocab, cc13, n_streams=S,
                         compute_dtype=bf16)
    sess.process(pcm[:, :cc13.chunk_samples * 2])
    warm = sess.total_chunks
    prof, n = count(lambda: profile_window(lambda: sess.process(pcm)))
    steps = sess.total_chunks - warm
    attn_k = launches_of(prof, "ring_attn_cluster_kernel<__nv_bfloat16, nib4")
    w8_k = launches_of(prof, "w8a8_matmul")
    busy = prof["busy_us"] / max(prof["wall_us"], 1e-9)
    out["profile"] = dict(steps=steps, attn_per_step=attn_k / max(steps, 1),
                          w8a8_per_step=w8_k / max(steps, 1),
                          busy_share=busy)
    log(f"  profile R=13 ({steps} chunks): device busy {100 * busy:.1f}%; "
        f"per step {attn_k / max(steps, 1):g} int4 attention launches "
        f"(ring_attn_cluster_kernel<bf16, nib4>), {w8_k / max(steps, 1):g} "
        f"W8A8 launches, Q8 launches {launches_of(prof, 'q8_')}")
    if (not steps or attn_k != cfg.n_layers * steps
            or w8_k != 10 * cfg.n_layers * steps or launches_of(prof, "q8_")
            or n["w8a8"] != w8_k):
        failures.append(f"quant tier profile: {attn_k} int4 attention and "
                        f"{w8_k} W8A8 launches in {steps} steps")
    del sess

    # the int8 dynamic tier on the same audio, timed beside this tier
    # (dynamic, static, static, dynamic); then readings of their agreement
    # and of the port's CPU run of this tier (f32 on both devices):
    # full-width W8A8 is chaotic under int8 rounding (the W8A8 path
    # phase), so these are readings
    q8, _, _ = compare_model(full_width_model(gguf_path, "cuda"))
    w8 = quantize_model_params(q8, mode="w8a8")
    cc8 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels,
                      kv_cache_int8=True)
    side = {"int8 dynamic": [], "sq-static int4": []}
    for name in ("int8 dynamic", "sq-static int4", "sq-static int4",
                 "int8 dynamic"):
        p, c = (w8, cc8) if name == "int8 dynamic" else (sq, cc13)
        dyn, _ = count(lambda: run_session(p, cfg, vocab, c, pcm, bf16))
        side[name].append(dyn.chunk_seconds / dyn.total_chunks * 1e3)
    out["beside_int8"] = side
    log(f"  R=13 bf16 S={S} chunk ms, in turns: int8 dynamic "
        f"{side['int8 dynamic'][0]:.2f}, {side['int8 dynamic'][1]:.2f}; "
        f"sq-static + int4 {side['sq-static int4'][0]:.2f}, "
        f"{side['sq-static int4'][1]:.2f}")
    vs_dyn = [position_agreement(tokens13[s], dyn.get_tokens(s))
              for s in range(S)]
    card32, _ = count(lambda: run_session(sq, cfg, vocab, cc13, pcm, f32))
    cpu32 = run_session(to_device(sq, "cpu"), cfg, vocab, cc13, pcm, f32)
    vs_cpu = [position_agreement(card32.get_tokens(s), cpu32.get_tokens(s))
              for s in range(S)]
    out["readings"] = dict(vs_int8_dynamic=vs_dyn, card_vs_cpu_f32=vs_cpu)
    log(f"  readings at R=13, S={S}: position agreement with the int8 "
        f"dynamic tier (bf16) {min(vs_dyn):.4f}-{max(vs_dyn):.4f}; card vs "
        f"CPU in f32 {min(vs_cpu):.4f}-{max(vs_cpu):.4f}")
    del dyn, card32, cpu32

    # per-layer right context on the exact tier: Q8_0 f32, S = 1
    cpu_q8, _, _ = compare_model(full_width_model(gguf_path, "cpu"))
    ccr = CacheConfig(att_right_context=13, n_mels=cfg.n_mels,
                      att_right_context_by_layer=RC_BY_LAYER)
    card, n = count(lambda: run_session(q8, cfg, vocab, ccr, pcm[:1], f32))
    cpu = run_session(cpu_q8, cfg, vocab, ccr, pcm[:1], f32)
    plain = run_session(cpu_q8, cfg, vocab, CacheConfig(
        att_right_context=13, n_mels=cfg.n_mels), pcm[:1], f32)
    same = card.get_tokens(0) == cpu.get_tokens(0)
    chunks = card.total_chunks
    out["rc_by_layer"] = dict(tokens_equal_cpu=same, chunks=chunks,
                              tokens=len(card.get_tokens(0)), launches=n,
                              differs_from_uniform=cpu.get_tokens(0)
                              != plain.get_tokens(0))
    log(f"  --rc-by-layer {RC_BY_LAYER} R=13 Q8_0 f32 S=1: tokens card vs "
        f"CPU {'equal' if same else 'DIFFER'} ({len(cpu.get_tokens(0))} "
        f"tokens, {chunks} chunks; tokens differ from uniform R=13: "
        f"{out['rc_by_layer']['differs_from_uniform']}), launches "
        f"{json.dumps(n)}")
    if not same or not chunks or n != {"attn": cfg.n_layers * chunks,
                                       "q8": 10 * cfg.n_layers * chunks,
                                       "w8a8": 0}:
        failures.append(f"rc-by-layer: tokens equal {same}, launches {n}")
    del card, cpu, plain

    # the 64-slot engine on the new tier and, beside it, on the int8
    # dynamic tier: device DSP, R = 13, the engine phase's ragged schedule
    n_slots = ENGINE_SLOTS
    res = {}
    for name, p, c in (("sq-static int4", sq, cc13),
                       ("int8 dynamic", w8, cc8)):
        eng = ServingEngine(p, cfg, vocab, c, n_slots=n_slots,
                            compute_dtype=bf16, dsp="device")
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        with EncoderTap() as tap:
            run, n = count(lambda: engine_schedule(
                eng, lambda sid: seeded_pcm(sid, ENGINE_SECONDS),
                **ragged_plan(n_slots, ENGINE_SECONDS, c.shift_samples)))
        check_engine_launches(f"{name} R=13", n, tap.calls, cfg, 10, "w8a8",
                              failures)
        lat = run["latency"]
        res[name] = dict(p50_ms=lat["p50"] * 1e3, p90_ms=lat["p90"] * 1e3,
                         rtf=run["stats"]["aggregate_rtf"], ticks=run["ticks"],
                         encoder_steps=tap.calls,
                         tokens=sum(map(len, run["finals"].values())),
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del eng, run
    prof, n = count(lambda: engine_step_profile(ServingEngine(
        sq, cfg, vocab, cc13, n_slots=n_slots, compute_dtype=bf16,
        dsp="device")))
    res["profile"] = log_profile(
        "w8a8-sq-static + int4 bf16 R=13", prof, 3, failures, "q8_",
        {"ring_attn_cluster_kernel<__nv_bfloat16, nib4": cfg.n_layers,
         "w8a8_matmul": 10 * cfg.n_layers})
    out["engine"] = res
    for name in ("sq-static int4", "int8 dynamic"):
        r = res[name]
        log(f"  engine {n_slots} slots {name} bf16 device DSP R=13: tick p50 "
            f"{r['p50_ms']:.2f} / p90 {r['p90_ms']:.2f} ms, aggregate RTF "
            f"{r['rtf']:.4f}, {r['encoder_steps']} encoder steps, "
            f"{r['tokens']} tokens, peak {r['peak_gib']:.2f} GiB")

    # snapshots on the card
    out["snapshots"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
        for name, params, ccs, dtype, streams in (
                ("Q8_0 f32 S=1", q8, cc, f32, 1),
                ("W8A8 + int8 K/V bf16 S=8", w8, cc8, bf16, S)):
            (ref, res_s, save_s, load_s, size), _ = count(
                lambda: snapshot_session(
                    lambda: StreamSession(params, cfg, vocab, ccs,
                                          n_streams=streams,
                                          compute_dtype=dtype),
                    pcm[:streams], SNAPSHOT_CUT, tmp))
            ok = sessions_equal(ref, res_s) and len(ref.tokens[0]) > 0
            row = dict(bit_equal=ok, save_s=save_s, load_s=load_s,
                       bytes=size, tokens=sum(map(len, ref.tokens)))
            if streams == 1:
                # the card's mid-stream snapshot continued on the CPU
                on_cpu = StreamSession(cpu_q8, cfg, vocab, ccs)
                on_cpu.load(os.path.join(tmp, "session.npz"))
                on_cpu.process(pcm[:1, SNAPSHOT_CUT:])
                on_cpu.finalize()
                cpu_ref = run_session(cpu_q8, cfg, vocab, ccs, pcm[:1], f32)
                row["cpu_continues_to_cpu_tokens"] = (
                    on_cpu.get_tokens(0) == cpu_ref.get_tokens(0))
                ok = ok and row["cpu_continues_to_cpu_tokens"]
            out["snapshots"][name] = row
            log(f"  snapshot {name} R=13 cut at {SNAPSHOT_CUT} samples: "
                f"resumed tokens and state leaves bit-equal {row['bit_equal']}"
                f"{', CPU continuation = CPU tokens ' + str(row.get('cpu_continues_to_cpu_tokens')) if streams == 1 else ''}; "
                f"save {save_s * 1e3:.1f} ms, load {load_s * 1e3:.1f} ms, "
                f"{size / 2 ** 20:.2f} MiB")
            if not ok:
                failures.append(f"snapshot {name}: {row}")
            del ref, res_s
        for name, params, ccs, dtype, dsp in (
                ("Q8_0 f32 host DSP", q8, cc, f32, "numpy"),
                ("W8A8 + int8 K/V bf16 device DSP", w8, cc8, bf16, "device")):
            row, _ = count(lambda: snapshot_engine(
                lambda: ServingEngine(params, cfg, vocab, ccs,
                                      n_slots=ENGINE_SLOTS,
                                      compute_dtype=dtype, dsp=dsp), tmp))
            out["snapshots"][f"engine {name}"] = row
            log(f"  snapshot engine {ENGINE_SLOTS} slots {name} R=13, saved "
                f"at tick {row['cut_tick']} of {row['ticks']}: "
                f"{row['equal_slots']} of {row['slots']} slots' tokens equal "
                f"the uninterrupted run ({row['tokens']} tokens); save "
                f"{row['save_s'] * 1e3:.1f} ms, load {row['load_s'] * 1e3:.1f}"
                f" ms, {row['bytes'] / 2 ** 20:.2f} MiB")
            if row["equal_slots"] != row["slots"] or not row["tokens"]:
                failures.append(f"snapshot engine {name}: {row}")
    out["launches"] = launches
    return out


def tones_quant_phase(failures: list) -> dict:
    """The trained tones fixture (Dh = 16: the int4 kernel's 8-byte rows),
    8 streams of 15 s, R = 13: int4 rings in f32, and w8a8-sq-static with
    int4 rings in bf16 (calibrated on the first 20 s of another seeded
    recording), each with token error < 10% against the labels."""
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.utils.tones import make_eval_streams

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "weights", "tones_tiny.gguf")
    params, cfg, vocab = load_model(path, device="cuda")
    dense = load_model(path, device="cuda", keep_quantized=False)[0]
    audio, truths = make_eval_streams(TONES_STREAMS, TONES_SECONDS, TONES_N,
                                      seed=TONES_SEED)
    calib, _ = make_eval_streams(1, 20.0, TONES_N, seed=TONES_SEED + 7)
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels,
                     kv_cache_int4=True)
    sq = sq_quantize(dense, cfg, cc, calib[0])
    out, launches = {}, {"attn": 0, "q8": 0, "w8a8": 0}
    for name, p, dtype in (("int4 f32", params, torch.float32),
                           ("w8a8-sq-static + int4 bf16", sq,
                            torch.bfloat16)):
        torch.cuda.synchronize()
        reset_counts()
        sess = run_session(p, cfg, vocab, cc, audio, dtype)
        torch.cuda.synchronize()
        n = kernel_counts()
        for k in launches:
            launches[k] += n[k]
        got = [[t for t, _ in sess.get_tokens(s)]
               for s in range(TONES_STREAMS)]
        ter = token_error(got, truths)
        chunks = sess.total_chunks
        out[name] = dict(ter=ter, chunk_ms=sess.chunk_seconds
                         / max(chunks, 1) * 1e3, launches=n)
        log(f"  tones {name} R=13 S={TONES_STREAMS}: token error {ter:.4f} "
            f"(tol {TONES_TER_MAX}), mean chunk {out[name]['chunk_ms']:.2f} "
            f"ms, launches {json.dumps(n)}")
        want_w8 = 0 if dtype == torch.float32 else 10 * cfg.n_layers * chunks
        if (not ter < TONES_TER_MAX or n["attn"] != cfg.n_layers * chunks
                or n["w8a8"] != want_w8):
            failures.append(f"tones {name}: token error {ter:.4f}, "
                            f"launches {n}")
    out["launches"] = launches
    return out


def cli_quant_phase(failures: list) -> dict:
    """The entry points on the card with the slice's flags, against --cpu,
    on the tones fixture: the streaming CLI with --kv-int4, with
    --rc-by-layer=13,6,1,0 (exact tiers: stdout equal) and with
    --quantize=w8a8-sq-static --calib=FILE (int8 rounding: stdout
    agreement stated, token error < 10% on the card); then
    `asr_server --kv-int4 --rc-by-layer 13,6,1,0` on the card replayed
    into by `asr_client` (token error < 10%)."""
    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.utils.tones import make_eval_streams

    here = os.path.dirname(os.path.abspath(__file__))
    fixture = os.path.join(here, "weights", "tones_tiny.gguf")
    env = dict(os.environ, PYTHONPATH=here)
    audio, truths = make_eval_streams(2, 8.0, TONES_N, seed=TONES_SEED + 3)
    ids = {piece: i for i, piece in
           enumerate(load_model(fixture, device="cpu")[2])}

    def ter_of(text, k):
        got = [ids.get(f"▁{w}", -1) for w in text.split()]
        return token_error([got], [list(truths[k])])

    def run(args, timeout=300):
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env,
                                cwd=here)
        return proc, t0, timeout

    def finish(started):
        proc, t0, timeout = started
        try:
            so, se = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            so, se = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"exit {proc.returncode}: {se[-2000:]}")
        return so, time.perf_counter() - t0

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for k in range(2):
            paths.append(os.path.join(tmp, f"s{k}.pcm"))
            audio[k].astype("<i2").tofile(paths[-1])
        cells = {"--kv-int4": ["--kv-int4"],
                 "--rc-by-layer": ["--rc-by-layer=13,6,1,0"],
                 "--quantize=w8a8-sq-static": [
                     "--quantize=w8a8-sq-static", f"--calib={paths[1]}"]}
        started = {(name, dev): run(["-m", "nemotron_tpu_torch.cli", fixture,
                                     paths[0], "80", "13", *flags,
                                     *(["--cpu"] if dev == "cpu" else [])])
                   for name, flags in cells.items() for dev in ("cuda", "cpu")}
        done = {key: finish(st) for key, st in started.items()}
        for name in cells:
            card, cpu = done[name, "cuda"][0], done[name, "cpu"][0]
            exact = name != "--quantize=w8a8-sq-static"
            ter = ter_of(card, 0)
            out[name] = dict(stdout_equal=card == cpu, ter_card=ter,
                             ter_cpu=ter_of(cpu, 0),
                             wall_s=done[name, "cuda"][1])
            log(f"  streaming CLI {name} on the card against --cpu: stdout "
                f"{'equal' if card == cpu else 'different'}"
                f"{'' if exact else ' (int8 rounding: a reading)'}; token "
                f"error card {ter:.4f}, CPU {out[name]['ter_cpu']:.4f}")
            if (exact and card != cpu) or not ter < TONES_TER_MAX:
                failures.append(f"CLI {name}: {out[name]}")

        proc = start_server_module([fixture, "--slots", "4", "--kv-int4",
                                    "--rc-by-layer", "13,6,1,0"], env, here)
        try:
            port, listening = server_port(proc)
            transcript, ct = finish(run(
                ["-m", "nemotron_tpu_torch.asr_client", f"127.0.0.1:{port}",
                 paths[1], "--rate", "max"]))
        finally:
            stop_process(proc)
        ter = ter_of(transcript, 1)
        out["asr_server"] = dict(ter=ter, client_wall_s=ct,
                                 on_card="device=cuda" in listening)
        log(f"  asr_server --kv-int4 --rc-by-layer 13,6,1,0 on the card "
            f"({listening}) with asr_client: token error {ter:.4f} (tol "
            f"{TONES_TER_MAX}), client wall {ct:.1f} s")
        if not ter < TONES_TER_MAX or not out["asr_server"]["on_card"]:
            failures.append(f"asr_server quant flags: {out['asr_server']}")
    return out


# ---------------------------------------------------------------------------
# slice 13: lockstep serving, cohorts and the serve entry point
# ---------------------------------------------------------------------------

def lockstep_run(eng, pcm, pipelined: bool = True,
                 finalize: bool = False) -> dict:
    """Drive a LockstepEngine over `pcm` [S, N], one chunk shift of samples
    a tick (the last block the remainder), pipelined or plain: each tick's
    host-clock ms (a pipelined tick also brings back the tick before it)
    and whether it ran a chunk, the chunks, the tokens of the chunks of
    real audio after flush_pipeline ("streamed") and, with finalize, the
    tokens after it ("final")."""
    import torch

    q = eng.cc.shift_samples
    tick = eng.tick_pipelined if pipelined else eng.tick
    ms, ran = [], []
    for ofs in range(0, pcm.shape[1], q):
        k = eng.total_chunks
        t0 = time.perf_counter()
        tick(pcm[:, ofs:ofs + q])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        ran.append(eng.total_chunks > k)
    eng.flush_pipeline()
    out = dict(tick_ms=ms, ran_chunk=ran, chunks=eng.total_chunks,
               streamed=[list(t) for t in eng.tokens],
               tokens=sum(map(len, eng.tokens)))
    if finalize:
        eng.finalize()
        out["final"] = [list(t) for t in eng.tokens]
    return out


def engine_ticks(eng, pcm) -> dict:
    """A ServingEngine fed as lockstep_run feeds a LockstepEngine: every
    slot one chunk shift of `pcm` [S, N] a tick (a partial last block stays
    staged), each tick's host-clock ms of its feed_audio + step and whether
    it ran a chunk; its own step p50 (every device tick), the chunks a slot
    and the tokens."""
    import torch

    q = eng.cc.shift_samples
    slots = eng.add_streams(pcm.shape[0])
    ms, ran = [], []
    for ofs in range(0, pcm.shape[1], q):
        k = int(eng.frame_offsets[slots[0]])
        t0 = time.perf_counter()
        eng.feed_audio({s: pcm[i, ofs:ofs + q] for i, s in enumerate(slots)})
        eng.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        ran.append(int(eng.frame_offsets[slots[0]]) > k)
    out = dict(tick_ms=ms, ran_chunk=ran,
               chunks=int(eng.frame_offsets[slots[0]]) // eng.cc.valid_out_len,
               tokens=sum(len(eng.tokens[s]) for s in slots),
               step_p50_ms=eng.latency_percentiles()["p50"] * 1e3)
    for s in slots:
        eng.remove_stream(s)
    return out


def tick_summary(run, cc, n_streams) -> dict:
    """Tick p50/p90 (host clock) over the ticks that ran a chunk (a tick
    of DSP alone, or none, takes a fraction of one) and aggregate RTF
    (every tick's seconds over the audio all streams decoded) of a run of
    lockstep_run or engine_ticks."""
    t = np.asarray(run["tick_ms"])
    chunk_t = t[np.asarray(run["ran_chunk"])]
    audio_s = (run["chunks"] * n_streams * cc.valid_out_len
               * cc.subsampling_factor * cc.hop_length / cc.sample_rate)
    return dict(p50_ms=float(np.percentile(chunk_t, 50)),
                p90_ms=float(np.percentile(chunk_t, 90)), ticks=int(t.size),
                chunk_ticks=int(chunk_t.size), chunks=run["chunks"],
                rtf=float(t.sum() / 1e3 / audio_s))


def shared_weights(engines) -> bool:
    """Every weight leaf and the position projections of each later engine
    (and, for lockstep engines, the DSP window and filterbank) lie at
    engine 0's data_ptr."""
    from nemotron_tpu_torch.params import flatten

    def ptrs(eng):
        p = {k: v.data_ptr() for k, v in flatten(eng.params).items()}
        p["pos_heads"] = eng.pos_heads.data_ptr()
        if hasattr(eng, "filterbank"):
            p["window"] = eng.window.data_ptr()
            p["filterbank"] = eng.filterbank.data_ptr()
        return p

    return all(ptrs(eng) == ptrs(engines[0]) for eng in engines[1:])


def lockstep_phase(gguf_path: str, failures: list) -> dict:
    """Slice 13 at full width, COMPARE_LAYERS layers (the serve entry
    points: the 24-layer GGUF).
    (1) Q8_0 f32, 8 streams, R = 13, tick_pipelined over 4 s of seeded PCM:
        the tokens of the chunks of real audio equal 8 solo f32 sessions'
        (the exact tier), one attention and 10 Q8 launches a layer a
        chunk; the
        finals against the sessions' as a reading (the lockstep pads
        silence PCM where a session pads zero mel, as in JAX).
    (2) W8A8 + int8 K/V bf16, 64 streams, the four modes, beside a 64-slot
        device-DSP ServingEngine fed the same audio at the real-time rate,
        in turns (lockstep, engine, engine, lockstep; each tick timed as
        the user's call: tick_pipelined, or feed_audio + step; 2 s a stream
        at R = 0 and 1): tick p50/p90 over the ticks that ran a chunk
        against the mode's limit, aggregate RTF, peak GiB,
        launches a chunk (a layer: one attention, 10 W8A8); at R = 13 two
        streams
        against solo bf16 sessions (w8a8_solo_readings, as the engine
        phase: position agreement beside its controls, token counts
        checked; the agreement held to 95%) and a profile of 3 ticks (busy
        share, launches a tick by name).
    (3) 256 streams at R = 13, one timing.
    (4) CohortScheduler(2 x 32) and ServingCohorts(2 x 32, device DSP),
        Q8_0 f32, R = 13: engine 1's weights at engine 0's data_ptr, each
        cohort's tokens equal to a solo engine of its own.
    (5) `python -m nemotron_tpu_torch.serve` with --lockstep and without on
        the card (64 streams, W8A8 + int8 K/V): exit 0 and the summary.
        Both are child processes started before (3), beside (3) and (4)."""
    import gc

    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import quantize_model_params
    from nemotron_tpu_torch.streaming.cohorts import (CohortScheduler,
                                                      ServingCohorts)
    from nemotron_tpu_torch.streaming.lockstep import LockstepEngine
    from nemotron_tpu_torch.streaming.serving import ServingEngine

    bf16, f32 = torch.bfloat16, torch.float32
    gc.collect()
    q8_params, cfg, vocab = compare_model(full_width_model(gguf_path,
                                                           "cuda"))
    w8_params = quantize_model_params(q8_params, mode="w8a8")
    out = {"modes": {}}
    launches = {"attn": 0, "q8": 0, "w8a8": 0}

    def count(fn):
        """counted(fn) and the encoder steps it ran."""
        with EncoderTap() as tap:
            r, n = counted(fn, launches)
        return r, n, tap.calls

    # (1) Q8_0 f32, 8 streams, against solo f32 sessions
    t0 = time.perf_counter()
    S = W8A8_STREAMS
    cc13 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    pcm = np.stack([seeded_pcm(s) for s in range(S)])
    eng = LockstepEngine(q8_params, cfg, vocab, cc13, n_streams=S,
                         compute_dtype=f32)
    run, n, steps = count(lambda: lockstep_run(eng, pcm, finalize=True))
    check_engine_launches("lockstep Q8_0 f32", n, steps, cfg, 10, "q8",
                          failures)
    solos = [solo_session(q8_params, cfg, vocab, cc13, pcm[s], f32)
             for s in range(S)]
    same = [run["streamed"][s] == solos[s]["streamed"]
            and len(solos[s]["streamed"]) > 0 for s in range(S)]
    same_final = [run["final"][s] == solos[s]["final"] for s in range(S)]
    res = tick_summary(run, cc13, S) | dict(
        tokens=sum(map(len, run["streamed"])), launches=n,
        solo_tokens_equal=same, solo_finals_equal=same_final)
    out["q8_f32_8"] = res
    log(f"  lockstep Q8_0 f32, {S} streams, R=13, pipelined: tick p50 "
        f"{res['p50_ms']:.2f} / p90 {res['p90_ms']:.2f} ms, RTF "
        f"{res['rtf']:.4f}, {res['chunks']} chunks, {res['tokens']} tokens, "
        f"launches {json.dumps(n)} in {steps} encoder steps; tokens of the "
        f"real-audio chunks equal to solo f32 sessions {same}; finals "
        f"(reading) {same_final} (wall {time.perf_counter() - t0:.1f} s)")
    if not all(same):
        failures.append(f"lockstep Q8_0 f32: tokens equal to solo sessions "
                        f"{same}")
    del eng, run, solos

    # (2) W8A8 + int8 K/V bf16, 64 streams, four modes, beside the engine
    # on the same audio, in turns (lockstep, engine, engine, lockstep); at
    # R = 0 and 1 over the first 2 s (25 and 12 ticks a run: the phase's
    # time limit, PERF.md §4); R = 13, whose streams are held to solo
    # sessions, at 24 layers (at 4 the tier's int8 rounding moved a stream
    # below the 95% bound)
    n64 = ENGINE_SLOTS
    pcm64 = np.stack([seeded_pcm(s) for s in range(n64)])
    w8_by_depth = {cfg.n_layers: (w8_params, cfg)}
    full_cfg = full_width_model(gguf_path, "cuda")[1]
    w8_by_depth[full_cfg.n_layers] = (full_width_w8a8(gguf_path), full_cfg)
    for R in MODES:
        t0 = time.perf_counter()
        w8_mode, cfg_mode = w8_by_depth[full_cfg.n_layers if R == 13
                                        else cfg.n_layers]
        cc = CacheConfig(att_right_context=R, n_mels=cfg.n_mels,
                         kv_cache_int8=True)
        pcm = pcm64[:, :int(mode_seconds(R) * 16000)]
        res = dict(limit_ms=SHIFT_MS[R], lockstep=[], engine=[])
        for kind in ("lockstep", "engine", "engine", "lockstep"):
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            if kind == "lockstep":
                eng = LockstepEngine(w8_mode, cfg_mode, vocab, cc,
                                     n_streams=n64)
                run, n, steps = count(lambda: lockstep_run(eng, pcm))
            else:
                eng = ServingEngine(w8_mode, cfg_mode, vocab, cc,
                                    n_slots=n64, compute_dtype=bf16,
                                    dsp="device")
                run, n, steps = count(lambda: engine_ticks(eng, pcm))
            check_engine_launches(f"{kind} W8A8 R={R}", n, steps, cfg_mode,
                                  10, "w8a8", failures)
            res[kind].append(tick_summary(run, cc, n64) | dict(
                launches=n, tokens=run["tokens"],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
                | ({"step_p50_ms": run["step_p50_ms"]}
                   if kind == "engine" else {}))
            if kind == "lockstep" and not res["lockstep"][1:]:
                first = run
            del eng, run
        out["modes"][f"R={R}"] = res
        lk, en = res["lockstep"], res["engine"]
        log(f"  W8A8 bf16 int8 K/V, {n64} streams, {cfg_mode.n_layers} "
            f"layers, R={R} (limit "
            f"{SHIFT_MS[R]} ms), in turns L E E L, ticks that ran a "
            f"chunk: lockstep tick p50 "
            f"{lk[0]['p50_ms']:.2f} / {lk[1]['p50_ms']:.2f} ms (p90 "
            f"{lk[0]['p90_ms']:.2f} / {lk[1]['p90_ms']:.2f}), RTF "
            f"{lk[0]['rtf']:.4f}, {lk[0]['ticks']} ticks "
            f"({lk[0]['chunk_ticks']} with a chunk), {lk[0]['chunks']} "
            f"chunks, {lk[0]['tokens']} "
            f"tokens, peak {lk[0]['peak_gib']:.2f} "
            f"GiB, launches {json.dumps(lk[0]['launches'])}; {n64}-slot "
            f"engine (device DSP), feed_audio + step: p50 "
            f"{en[0]['p50_ms']:.2f} / {en[1]['p50_ms']:.2f} ms (p90 "
            f"{en[0]['p90_ms']:.2f} / {en[1]['p90_ms']:.2f}; its own step "
            f"p50 {en[0]['step_p50_ms']:.2f} / {en[1]['step_p50_ms']:.2f}), "
            f"RTF {en[0]['rtf']:.4f}, {en[0]['chunk_ticks']} ticks with a "
            f"chunk, {en[0]['chunks']} chunks, peak "
            f"{en[0]['peak_gib']:.2f} GiB (wall "
            f"{time.perf_counter() - t0:.1f} s)")
        if R == 13:
            # the lockstep feeds a stream exactly what its solo session
            # decodes (no masks, no realignment): held to the tier's 95%
            res["solo"] = w8a8_solo_readings(
                dict(pcm={s: pcm64[s] for s in range(n64)},
                     finals={s: first["streamed"][s] for s in range(n64)}),
                w8_mode, cfg_mode, vocab, cc, R, failures, [0, n64 - 1])
            low = {sid: r["engine"] for sid, r in res["solo"].items()
                   if r["engine"] < TOL_W8A8_TOKEN_AGREE}
            if low:
                failures.append(f"lockstep W8A8 R=13: position agreement "
                                f"with solo bf16 sessions {low} < "
                                f"{TOL_W8A8_TOKEN_AGREE}")
        del first

    # the busy share over 3 profiled R = 13 ticks (after 2: one chunk a
    # tick from then on)
    cc13_8 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels,
                         kv_cache_int8=True)
    q = cc13_8.shift_samples
    gc.collect()
    eng = LockstepEngine(w8_params, cfg, vocab, cc13_8, n_streams=n64)
    blocks = [pcm64[:, t * q:(t + 1) * q] for t in range(2)] + \
        [np.roll(pcm64, 7 * t, axis=1)[:, :q] for t in range(3)]

    def profiled():
        for blk in blocks[:2]:
            eng.tick(blk)
        with EncoderTap() as tap:
            prof = profile_window(lambda: [eng.tick(b) for b in blocks[2:]])
        prof["encoder_steps"] = tap.calls
        return prof

    prof, _n, _steps = count(profiled)
    out["profile"] = log_profile(
        "lockstep W8A8 bf16 R=13 64 streams", prof, 3, failures, "q8_",
        {"ring_attn_cluster_kernel": cfg.n_layers,
         "w8a8_matmul": 10 * cfg.n_layers})
    del eng

    # (5) the serve entry point on the card, with --lockstep and without:
    # two child processes started here, beside (3) and (4)
    t_serve = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    serve_tmp = tempfile.mkdtemp(prefix="serve_")
    serve_pcm = os.path.join(serve_tmp, "s.pcm")
    seeded_pcm(7).tofile(serve_pcm)
    procs = {mode: subprocess.Popen(
        [sys.executable, "-m", "nemotron_tpu_torch.serve", gguf_path,
         serve_pcm, "--streams", str(n64), "--seconds", str(AUDIO_SECONDS),
         "--quantize", "w8a8", "--kv-int8",
         *(["--lockstep"] if mode == "lockstep" else [])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=here,
        env=dict(os.environ, PYTHONPATH=here))
        for mode in ("lockstep", "engine")}

    try:
        # (3) 256 streams at R = 13, one timing (8 s a stream)
        t0 = time.perf_counter()
        n256 = ENGINE_SLOT_COUNTS[-1]
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        eng = LockstepEngine(w8_params, cfg, vocab, cc13_8, n_streams=n256)
        pcm256 = np.stack([seeded_pcm(s, 2 * ENGINE_SECONDS)
                           for s in range(n256)])
        run, n, steps = count(lambda: lockstep_run(eng, pcm256))
        check_engine_launches("lockstep W8A8 256 streams", n, steps, cfg, 10,
                              "w8a8", failures)
        res = tick_summary(run, cc13_8, n256) | dict(
            launches=n, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        out["streams_256"] = res
        log(f"  lockstep W8A8 bf16, {n256} streams, R=13: tick p50 "
            f"{res['p50_ms']:.2f} / p90 {res['p90_ms']:.2f} ms (limit 1120 "
            f"ms), "
            f"RTF {res['rtf']:.4f}, {res['ticks']} ticks, {res['chunks']} "
            f"chunks, peak {res['peak_gib']:.2f} GiB (wall "
            f"{time.perf_counter() - t0:.1f} s)")
        del eng, run, pcm256

        # (4) cohorts, Q8_0 f32, R = 13: shared weights, each cohort = a solo
        # engine of its own
        t0 = time.perf_counter()
        B = 32
        pcm_c = [pcm64[c * B:(c + 1) * B] for c in range(2)]
        N = pcm64.shape[1]

        def cohorts():
            sched = CohortScheduler(q8_params, cfg, vocab, cc13, n_streams=B,
                                    n_cohorts=2, compute_dtype=f32)
            share = shared_weights(sched.engines)
            for ofs in range(0, N, cc13.shift_samples):
                for c in range(2):
                    sched.tick(c, pcm_c[c][:, ofs:ofs + cc13.shift_samples],
                               pipelined=True)
            sched.finalize()
            toks = [sched.engines[c].tokens for c in range(2)]
            solo = []
            for c in range(2):
                e = LockstepEngine(q8_params, cfg, vocab, cc13, n_streams=B,
                                   compute_dtype=f32)
                solo.append(lockstep_run(e, pcm_c[c], pipelined=False,
                                         finalize=True)["final"])
            return share, [toks[c] == solo[c] for c in range(2)], toks

        def serving_cohorts():
            rc = ServingCohorts(q8_params, cfg, vocab, cc13, n_slots=B,
                                n_cohorts=2, compute_dtype=f32, dsp="device")
            share = shared_weights(rc.engines)
            solo = [ServingEngine(q8_params, cfg, vocab, cc13, n_slots=B,
                                  compute_dtype=f32, dsp="device")
                    for _ in range(2)]
            gids = [[rc.add_stream(cohort=c) for _ in range(B)]
                    for c in range(2)]
            for e in solo:
                e.add_streams(B)
            for ofs in range(0, N, cc13.shift_samples):
                for c in range(2):
                    blk = pcm_c[c][:, ofs:ofs + cc13.shift_samples]
                    rc.feed_audio({g: blk[i] for i, g in enumerate(gids[c])})
                    rc.step(c)
                    solo[c].feed_audio({i: blk[i] for i in range(B)})
                    solo[c].step()
            got = [rc.engines[c].finalize_streams(list(range(B)), True)
                   for c in range(2)]
            want = [solo[c].finalize_streams(list(range(B)), True)
                    for c in range(2)]
            return share, [got[c] == want[c] for c in range(2)], got

        (share_l, eq_l, toks_l), n_l, _ = count(cohorts)
        (share_r, eq_r, toks_r), n_r, _ = count(serving_cohorts)
        out["cohorts"] = dict(lockstep_shared=share_l, lockstep_equal=eq_l,
                              ragged_shared=share_r, ragged_equal=eq_r,
                              lockstep_tokens=sum(len(t) for c in toks_l
                                                  for t in c),
                              ragged_tokens=sum(len(t[1]) for c in toks_r
                                                for t in c),
                              launches={k: n_l[k] + n_r[k] for k in n_l})
        log(f"  cohorts, Q8_0 f32 R=13, 2 x {B}: CohortScheduler weights "
            f"shared "
            f"{share_l}, cohorts equal to solo lockstep engines {eq_l} "
            f"({out['cohorts']['lockstep_tokens']} tokens); ServingCohorts "
            f"(device DSP) weights shared {share_r}, cohorts equal to solo "
            f"engines {eq_r} ({out['cohorts']['ragged_tokens']} tokens) (wall "
            f"{time.perf_counter() - t0:.1f} s)")
        if not (share_l and share_r and all(eq_l) and all(eq_r)
                and out["cohorts"]["lockstep_tokens"]
                and out["cohorts"]["ragged_tokens"]):
            failures.append(f"cohorts: {out['cohorts']}")
        del q8_params, w8_params
        gc.collect()
        torch.cuda.empty_cache()
    except BaseException:
        for proc in procs.values():      # stop the children, then raise
            proc.kill()
            proc.communicate()
        raise

    # (5) the serve entry points, started before (3)
    out["serve"] = {}
    for mode, proc in procs.items():
        try:
            so, se = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            so, se = proc.communicate()
        summary = [ln for ln in se.splitlines()
                   if "aggregate real-time" in ln or "per-tick" in ln]
        slots = [ln for ln in so.splitlines() if ln.startswith("[slot ")]
        out["serve"][mode] = dict(rc=proc.returncode, summary=summary,
                                  slot_lines=len(slots))
        log(f"  serve --{mode} (64 streams, W8A8 + int8 K/V, both processes "
            f"at once, beside (3) and (4)): exit {proc.returncode}; "
            + " | ".join(summary))
        if proc.returncode or not summary or len(slots) != 3:
            failures.append(f"serve {mode}: exit {proc.returncode}, "
                            f"stderr {se[-1500:]}")
    shutil.rmtree(serve_tmp, ignore_errors=True)
    log(f"  serve entry points: wall {time.perf_counter() - t_serve:.1f} s "
        f"from their start")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# slice 14: the RNN-T beam family (beam search, LM fusion and rescoring,
# logit boost, the two-pass refiner)
# ---------------------------------------------------------------------------

def beam_session(params, cfg, vocab, cc, pcm, dtype, lm=None, finalize=True,
                 chunks=None, **kw):
    """A K = BEAM_K StreamSession over `pcm` [S, N] (one chunk shift of
    samples a call); with `chunks`, it stops once that many chunks ran."""
    from nemotron_tpu_torch.streaming.session import StreamSession

    sess = StreamSession(params, cfg, vocab, cc, n_streams=pcm.shape[0],
                         compute_dtype=dtype, beam_size=BEAM_K,
                         beam_expansions=BEAM_EXPANSIONS,
                         max_beam_tokens=BEAM_MAX_TOKENS, lm=lm,
                         lm_weight=BEAM_LM_WEIGHT, **kw)
    q = cc.shift_samples
    for i in range(0, pcm.shape[1], q):
        if chunks is not None and sess.total_chunks >= chunks:
            break
        sess.process(pcm[:, i:i + q])
    if finalize:
        sess.finalize()
    return sess


def greedy_path(params, cfg, encs):
    """The greedy decode's path over the encoder outputs `encs` (chunks of
    [1, T, D], the decoder state carried) and its total log-prob: each
    emission's log softmax and each frame's closing blank (after
    MAX_SYMBOLS_PER_STEP emissions the blank that the beam's force-finish
    scores), the score tests/test_beam.py holds the K = 1 beam to."""
    import torch

    from nemotron_tpu_torch.config import MAX_SYMBOLS_PER_STEP
    from nemotron_tpu_torch.models import decoder as dec_mod
    from nemotron_tpu_torch.ops.lstm import lstm_step

    dp, blank = params.decoder, cfg.blank_token
    st = dec_mod.init_decoder_state(cfg, 1, encs[0].dtype, encs[0].device)
    h, c, prev = st.h, st.c, torch.tensor([blank], device=encs[0].device)
    emb = dp.embedding.to(encs[0].dtype)
    score, tokens = 0.0, []
    for enc in encs:
        ep = dec_mod.joint_project_enc(params.joint, enc)[0]
        for t in range(ep.shape[0]):
            for sym in range(MAX_SYMBOLS_PER_STEP + 1):
                out, h2, c2 = lstm_step(dp, emb[prev], h, c)
                lp = torch.log_softmax(dec_mod.joint_logits(
                    params.joint, ep[t:t + 1], out)[0].float(), -1)
                v = int(lp.argmax())
                if v == blank or sym == MAX_SYMBOLS_PER_STEP:
                    score += float(lp[blank])
                    break
                score += float(lp[v])
                tokens.append(v)
                h, c, prev = h2, c2, prev.fill_(v)
    return score, tokens


def peaked_params(params):
    """The full-width random model with its prediction side peaked: the
    label embedding and the joint's prediction projection x20, the joint's
    output layer x2. At the seed's scale the joint's log-probs are nearly
    flat: every emission then costs more than the blank that would end the
    frame, and every beam stays empty. Peaked, the hypotheses emit and
    differ. The LSTM's own weights stay as they are: scaled up (as
    tests/test_torch_beam.py's peaked_arrays does at the tiny width), the
    640-wide recurrence amplifies rounding differences from step to step,
    and the card, the CPU and two batch sizes of one card then decode
    different hypotheses from equal inputs (a CPU rehearsal: f32 against
    f64, scores 180 apart). With the LSTM as it is, f32 and f64 agree
    token for token within 6e-5 of the scores. The encoder's Q8_0 and W8A8
    weights are shared with the plain model."""
    import dataclasses

    dp, jp = params.decoder, params.joint
    dec = dataclasses.replace(dp, embedding=dp.embedding * 20)
    joint = dataclasses.replace(jp, dec_w=jp.dec_w * 20, dec_b=jp.dec_b * 20,
                                out_w=jp.out_w * 2, out_b=jp.out_b * 2)
    return dataclasses.replace(params, decoder=dec, joint=joint)


def beam_rows(state, rows=None) -> list:
    """Rows of a BeamState as plain lists: each slot's score, length and
    tokens (cut at its length)."""
    scores = state.scores.float().cpu().tolist()
    lengths = state.lengths.cpu().tolist()
    toks = state.tokens.cpu().tolist()
    return [dict(scores=scores[r], lengths=lengths[r],
                 tokens=[t[:n] for t, n in zip(toks[r], lengths[r])])
            for r in (range(len(scores)) if rows is None else rows)]


def compare_beams(name, got: list, want: list, failures: list) -> dict:
    """Hold beams (beam_rows) to a reference's, slot by slot: every slot's
    score within TOL_BEAM_SCORE, whether or not its tokens are equal (a
    slot whose tokens differ can only be a near-tie, and is printed with
    its gap); each row's best hypothesis (score / max(length, 1), as
    best_hypothesis(length_norm=True) selects it) non-empty, and equal to
    the reference's unless the reference's margin of the best over the
    runner-up is under TOL_BEAM_SCORE."""
    worst, differ, best_equal, best_len = 0.0, [], [], []
    if len(got) != len(want):
        failures.append(f"{name}: {len(got)} rows, reference {len(want)}")
    for r, (g, w) in enumerate(zip(got, want)):
        for k, (gs, ws) in enumerate(zip(g["scores"], w["scores"])):
            gap = abs(gs - ws)
            worst = max(worst, gap)
            if g["tokens"][k] != w["tokens"][k]:
                differ.append((r, k, gap))
        wsel = [x / max(n, 1) for x, n in zip(w["scores"], w["lengths"])]
        gsel = [x / max(n, 1) for x, n in zip(g["scores"], g["lengths"])]
        order = sorted(range(len(wsel)), key=lambda k: -wsel[k])
        gbest = max(range(len(gsel)), key=lambda k: gsel[k])
        wtoks, gtoks = w["tokens"][order[0]], g["tokens"][gbest]
        margin = wsel[order[0]] - wsel[order[1]] if len(order) > 1 else 1.0
        best_equal.append(gtoks == wtoks)
        best_len.append(len(wtoks))
        if not wtoks or not gtoks:
            failures.append(f"{name}: row {r}'s best hypothesis is empty")
        elif gtoks != wtoks and not margin < TOL_BEAM_SCORE:
            failures.append(f"{name}: row {r}'s best hypothesis differs "
                            f"without a near-tie (margin {margin})")
    for r, k, gap in differ:
        log(f"    {name}: row {r} slot {k} tokens differ (a near-tie), "
            f"score gap {gap:.3e}")
    if not worst <= TOL_BEAM_SCORE:
        failures.append(f"{name}: score gap {worst} (tol {TOL_BEAM_SCORE})")
    return dict(score_gap=worst, slots_differ=len(differ),
                best_equal=best_equal, best_tokens=best_len)


def full_width_lm(cfg, device):
    """A seeded random label LM at the decoder's width (2 LSTM layers of
    640 over the 1025 labels)."""
    from nemotron_tpu_torch.models.lm import (lm_params_from_arrays,
                                              random_lm_arrays)

    return lm_params_from_arrays(random_lm_arrays(
        cfg.vocab_size, hidden=cfg.decoder_dim, n_layers=2, seed=SEED + 14,
        scale=0.05), device=device)


def start_cpu_job(fn: str, *args, threads: int = 4) -> subprocess.Popen:
    """chip_smoke.<fn>(*args) in a child process on the CPU (`threads`
    threads), so that a CPU reference runs while this process drives the
    card."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {here!r}); import torch; "
            f"torch.set_num_threads({threads}); import chip_smoke; "
            f"chip_smoke.{fn}(*{list(args)!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=here,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_job(proc: subprocess.Popen, out_path: str, timeout=900) -> dict:
    """Wait for a start_cpu_job child and read the JSON it wrote."""
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"CPU job exit {proc.returncode}: {err[-2000:]}")
    with open(out_path, encoding="utf-8") as f:
        return json.load(f)


def cpu_beam_reference(gguf_path: str, out_path: str) -> None:
    """The K = 4 Q8_0 f32 R = 13 session of the peaked model over
    BEAM_CPU_CHUNKS chunks on the CPU (beam_phase's reference): its beam
    (beam_rows) and chunk count, as JSON."""
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import load_model

    params, cfg, vocab = load_model(gguf_path, device="cpu")
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    pcm = seeded_pcm(1, (BEAM_CPU_CHUNKS + 1) * cc.shift_samples / 16000)
    sess = beam_session(peaked_params(params), cfg, vocab, cc, pcm[None],
                        torch.float32, finalize=False, chunks=BEAM_CPU_CHUNKS)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(dict(rows=beam_rows(sess.beam_state),
                       chunks=sess.total_chunks), f)


def cpu_tones_reference(out_path: str) -> None:
    """beam_tones_phase's CPU references: the K = 4 session with the tones
    LM over the tones streams, and transcribe_batch's rescored n-best
    lists, as JSON."""
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.models.lm import load_lm
    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.streaming.session import transcribe_batch
    from nemotron_tpu_torch.utils.tones import make_eval_streams

    here = os.path.dirname(os.path.abspath(__file__))
    params, cfg, vocab = load_model(os.path.join(here, "weights",
                                                 "tones_tiny.gguf"),
                                    device="cpu")
    lm = load_lm(os.path.join(here, "weights", "tones_tiny_lm.gguf"), "cpu")
    audio, _ = make_eval_streams(TONES_STREAMS, TONES_SECONDS, TONES_N,
                                 seed=TONES_SEED)
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    sess = beam_session(params, cfg, vocab, cc, audio, torch.float32, lm=lm)
    nb = transcribe_batch(params, cfg, vocab, list(audio), lm=lm,
                          **TONES_NBEST_KW)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(dict(tokens=[sess.get_tokens(s)
                               for s in range(TONES_STREAMS)], nbest=nb), f)


def beam_phase(gguf_path: str, failures: list) -> dict:
    """Slice 14 at full width, COMPARE_LAYERS layers but for the card
    against the CPU, at 24 (the seeded Q8_0 GGUF, its prediction side
    peaked by peaked_params so that the beams emit). Every beam is held to
    its reference by compare_beams: each slot's score within
    TOL_BEAM_SCORE, tokens equal but for near-ties, best hypotheses
    non-empty and equal.
    (1) K = 1 against greedy, Q8_0 f32, S = 1, the four modes: the K = 1
        beam's best log-prob at least the greedy path's (tests/test_beam.py
        gates the same floor: K = 1 keeps the best finished hypothesis,
        greedy the argmax label of each step, so their tokens differ where
        an emission costs more than its blank; on these weights K = 1
        emits a few tokens at R = 13 and none in the shorter chunks, the
        greedy path ten a frame); token counts and agreement printed.
    (2) card vs CPU: a K = 4 session over BEAM_CPU_CHUNKS chunks at R = 13,
        its beam against the CPU's; 24 attention and 240 Q8 launches a
        chunk.
    (3) beam_decode with and without the LM on one chunk under
        torch.cuda.set_sync_debug_mode("error"): no host sync.
    (4) the 64-slot ServingEngine, K = 4, Q8_0 f32, host and device DSP,
        the engine phase's ragged schedule: each tracked slot's beam
        against its solo K = 4 session's after the same chunks, and (host
        DSP) its finalized best hypothesis equal to the solo session's.
    (5) LockstepEngine, K = 4, 8 streams: each stream's beam against its
        solo session's after the same chunks.
    (6) readings, W8A8 + int8 K/V bf16, K = 4: mean chunk ms at S = 8 in
        the four modes (24 / 240 launches a chunk checked), the 64-slot
        engine's tick p50 / p90 at R = 13 with and without the LM, a
        3-tick profile (busy share, launches a tick by kernel name) and the
        beam's own device ms for a tick's chunk."""
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.models import beam as beam_mod
    from nemotron_tpu_torch.models import encoder as enc_mod
    from nemotron_tpu_torch.params import quantize_model_params
    from nemotron_tpu_torch.streaming.lockstep import LockstepEngine
    from nemotron_tpu_torch.streaming.serving import ServingEngine

    f32, bf16 = torch.float32, torch.bfloat16
    tmp = tempfile.mkdtemp()
    ref_path = os.path.join(tmp, "ref.json")
    ref_job = start_cpu_job("cpu_beam_reference", gguf_path, ref_path)
    q8_full, cfg_full, vocab = full_width_model(gguf_path, "cuda")
    q8, cfg = cut_layers(q8_full, cfg_full, COMPARE_LAYERS)
    qp = peaked_params(q8)
    w8 = quantize_model_params(qp, mode="w8a8")
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    out = {"k1_vs_greedy": {}, "w8a8_sessions": {}}
    log(f"phase beam: K = {BEAM_K}, {BEAM_EXPANSIONS} expansions a frame, "
        f"{BEAM_MAX_TOKENS} token slots a hypothesis, full width, "
        f"{cfg.n_layers} layers, the "
        f"prediction side peaked")

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    def want_counts(chunks, kernel, n_layers=cfg.n_layers):
        other = "w8a8" if kernel == "q8" else "q8"
        return {"attn": n_layers * chunks,
                kernel: 10 * n_layers * chunks, other: 0}

    # (1) K = 1 against greedy
    pcm = seeded_pcm(0)
    for R in MODES:
        cc = CacheConfig(att_right_context=R, n_mels=cfg.n_mels)
        encs = chunk_encoder_outputs(qp, cfg, cc, pcm)
        bst = beam_mod.init_beam_state(cfg, 1, 1, BEAM_MAX_TOKENS, f32,
                                       qp.device)
        for o in encs:
            bst = beam_mod.beam_decode(qp, cfg, o, bst, 1, BEAM_EXPANSIONS)
        btok, blen, bscore = beam_mod.best_hypothesis(bst)
        beam_toks = btok[0, :int(blen[0])].tolist()
        g_score, g_toks = greedy_path(qp, cfg, encs)
        agree = position_agreement(beam_toks, g_toks)
        ok = float(bscore[0]) >= g_score - TOL_BEAM_SCORE
        out["k1_vs_greedy"][f"R={R}"] = dict(
            beam_score=float(bscore[0]), greedy_score=g_score,
            beam_tokens=len(beam_toks), greedy_tokens=len(g_toks),
            agreement=agree, chunks=len(encs))
        log(f"  K=1 vs greedy R={R} ({len(encs)} chunks): K=1 log-prob "
            f"{float(bscore[0]):.3f} >= greedy path {g_score:.3f}: {ok}; "
            f"tokens K=1 {len(beam_toks)}, greedy {len(g_toks)}, position "
            f"agreement {agree:.4f}")
        if not ok:
            failures.append(f"beam K=1 R={R}: log-prob {float(bscore[0])} "
                            f"below the greedy path's {g_score}")

    # (2) card vs CPU, K = 4, R = 13, at 24 layers (the CPU's run is the
    # child's; compared at the end of the phase)
    cc13 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    pcm = seeded_pcm(1, (BEAM_CPU_CHUNKS + 1) * cc13.shift_samples / 16000)
    qp_full = peaked_params(q8_full)
    beam_session(qp_full, cfg_full, vocab, cc13,
                 pcm[None, :3 * cc13.shift_samples], f32)      # warm-up
    card, card_counts = counted(lambda: beam_session(
        qp_full, cfg_full, vocab, cc13, pcm[None], f32, finalize=False,
        chunks=BEAM_CPU_CHUNKS), launches)
    del qp_full
    card_chunks = card.total_chunks
    if card_chunks != BEAM_CPU_CHUNKS or card_counts != want_counts(
            card_chunks, "q8", cfg_full.n_layers):
        failures.append(f"beam card session: {card_chunks} chunks, launches "
                        f"{card_counts}")

    # (3) no host sync in beam_decode, with and without the LM
    lm = full_width_lm(cfg, "cuda")
    st = enc_mod.init_encoder_state(cfg, cc13, 8, f32, qp.device)
    ph = enc_mod.precompute_pos_heads(qp, cfg, cc13)
    mel = torch.randn((8, cc13.chunk_mel_frames, cfg.n_mels),
                      generator=torch.Generator().manual_seed(SEED)).cuda()
    enc_out, _ = enc_mod.encode_chunk(qp, cfg, cc13, mel, st, ph)
    sync_ok = {}
    for name, use_lm in (("no LM", None), ("LM", lm)):
        bst = beam_mod.init_beam_state(cfg, 8, BEAM_K, BEAM_MAX_TOKENS, f32,
                                       qp.device, lm=use_lm)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            beam_mod.beam_decode(qp, cfg, enc_out, bst, BEAM_K,
                                 BEAM_EXPANSIONS, lm=use_lm)
            sync_ok[name] = True
        except RuntimeError as e:
            sync_ok[name] = False
            failures.append(f"beam_decode ({name}) synced with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    out["no_sync"] = sync_ok
    log(f"  beam_decode under set_sync_debug_mode('error'), 8 streams, one "
        f"R=13 chunk: no host sync {json.dumps(sync_ok)}")

    # (4) the 64-slot engine against solo sessions, host and device DSP
    n = ENGINE_SLOTS
    out["engine"] = {}
    for dsp in ("numpy", "device"):
        t0 = time.perf_counter()
        eng = ServingEngine(qp, cfg, vocab, cc13, n_slots=n,
                            compute_dtype=f32, dsp=dsp, beam_size=BEAM_K,
                            beam_expansions=BEAM_EXPANSIONS,
                            max_beam_tokens=BEAM_MAX_TOKENS)
        plan = ragged_plan(n, ENGINE_SECONDS, cc13.shift_samples)
        track = tracked_streams(n)
        rows = {}

        def keep_rows(stream_of):
            slot_of = {sid: s for s, sid in stream_of.items()}
            got = beam_rows(eng.beam_state, [slot_of[t] for t in track])
            rows.update(zip(track, got))

        run, counts = counted(lambda: engine_schedule(
            eng, lambda sid: seeded_pcm(sid, ENGINE_SECONDS),
            finalize=dsp == "numpy", before_end=keep_rows, **plan),
            launches)
        solo_rows, finals_same = [], []
        for sid in track:
            p = run["pcm"][sid][None]
            chunks = run["frames"][sid] // cc13.valid_out_len
            # host DSP: the whole stream, as the engine had it before the
            # finalize; device DSP: the chunks of real audio it ran
            solo = beam_session(qp, cfg, vocab, cc13, p, f32,
                                finalize=False,
                                chunks=None if dsp == "numpy" else chunks)
            if solo.total_chunks != chunks:
                failures.append(f"beam engine {dsp} stream {sid}: "
                                f"{chunks} chunks, solo {solo.total_chunks}")
            solo_rows += beam_rows(solo.beam_state)
            if dsp == "numpy":
                solo.finalize()
            want = solo.get_tokens(0)
            finals_same.append(run["finals"][sid] == want and len(want) > 0)
        cmp = compare_beams(f"beam engine {dsp}", [rows[t] for t in track],
                            solo_rows, failures)
        lat = run["latency"]
        out["engine"][dsp] = cmp | dict(
            finals_equal=finals_same, p50_ms=lat["p50"] * 1e3,
            p90_ms=lat["p90"] * 1e3, ticks=run["ticks"], launches=counts)
        log(f"  engine {n} slots K={BEAM_K} Q8_0 f32 {dsp} DSP R=13 "
            f"(ragged): tracked slots' beams vs solo sessions after the same "
            f"chunks: score max_abs_err {cmp['score_gap']:.3e} (tol "
            f"{TOL_BEAM_SCORE:.0e}), {cmp['slots_differ']} slots with other "
            f"tokens, best hypotheses equal {cmp['best_equal']} "
            f"({cmp['best_tokens']} tokens); "
            f"{'finalized' if dsp == 'numpy' else 'removed'} best hypotheses"
            f" equal {finals_same}; step p50 {lat['p50'] * 1e3:.2f} / p90 "
            f"{lat['p90'] * 1e3:.2f} ms, {run['ticks']} ticks, launches "
            f"{json.dumps(counts)} (wall {time.perf_counter() - t0:.1f} s)")
        if not all(finals_same):
            failures.append(f"beam engine {dsp}: best hypotheses equal "
                            f"{finals_same}")
        del eng, run

    # (5) the lockstep engine against solo sessions
    S = BEAM_LOCK_STREAMS
    pcm = np.stack([seeded_pcm(s) for s in range(S)])
    eng = LockstepEngine(qp, cfg, vocab, cc13, n_streams=S, compute_dtype=f32,
                         beam_size=BEAM_K, beam_expansions=BEAM_EXPANSIONS,
                         max_beam_tokens=BEAM_MAX_TOKENS)
    q = cc13.shift_samples

    def lock_run():
        for i in range(0, pcm.shape[1], q):
            eng.tick_pipelined(pcm[:, i:i + q])
        eng.flush_pipeline()
        eng.refresh_transcripts()

    _, counts = counted(lock_run, launches)
    solo_rows, same = [], []
    for s in range(S):
        solo = beam_session(qp, cfg, vocab, cc13, pcm[s:s + 1], f32,
                            finalize=False, chunks=eng.total_chunks)
        solo_rows += beam_rows(solo.beam_state)
        same.append(eng.tokens[s] == solo.get_tokens(0)
                    and solo.total_chunks == eng.total_chunks)
    cmp = compare_beams("beam lockstep", beam_rows(eng.beam_state),
                        solo_rows, failures)
    out["lockstep"] = cmp | dict(transcripts_equal=same,
                                 chunks=eng.total_chunks, launches=counts)
    log(f"  lockstep {S} streams K={BEAM_K} Q8_0 f32 R=13 ({eng.total_chunks} "
        f"chunks): beams vs solo sessions: score max_abs_err "
        f"{cmp['score_gap']:.3e}, {cmp['slots_differ']} slots with other "
        f"tokens, best hypotheses equal {cmp['best_equal']} "
        f"({cmp['best_tokens']} tokens); transcripts equal {same}, launches "
        f"{json.dumps(counts)}")
    if not all(same) or counts != want_counts(eng.total_chunks, "q8"):
        failures.append(f"beam lockstep: transcripts equal {same}, launches "
                        f"{counts}")
    del eng

    # (6) readings: W8A8 + int8 K/V bf16
    card_name = gpu_name_and_power()
    cc_w = {R: CacheConfig(att_right_context=R, n_mels=cfg.n_mels,
                           kv_cache_int8=True) for R in MODES}
    pcm = np.stack([seeded_pcm(s) for s in range(W8A8_STREAMS)])
    beam_session(w8, cfg, vocab, cc_w[13], pcm[:, :3 * q], bf16)  # warm-up
    for R in MODES:
        sess, counts = counted(lambda: beam_session(
            w8, cfg, vocab, cc_w[R], pcm, bf16, finalize=False), launches)
        chunks = sess.total_chunks
        ms = sess.chunk_seconds / max(chunks, 1) * 1e3
        out["w8a8_sessions"][f"R={R}"] = dict(chunk_ms=ms, chunks=chunks,
                                              launches=counts)
        log(f"  W8A8 + int8 K/V bf16 K={BEAM_K} S={W8A8_STREAMS} R={R}: "
            f"mean chunk {ms:.2f} ms over {chunks} chunks, launches "
            f"{json.dumps(counts)} ({card_name})")
        if not chunks or counts != want_counts(chunks, "w8a8"):
            failures.append(f"beam W8A8 R={R}: launches {counts}")
    lm_bf16 = full_width_lm(cfg, "cuda")
    out["w8a8_engine"] = {}
    for name, use_lm in (("no LM", None), ("LM", lm_bf16)):
        eng = ServingEngine(w8, cfg, vocab, cc_w[13], n_slots=n,
                            compute_dtype=bf16, dsp="device",
                            beam_size=BEAM_K,
                            beam_expansions=BEAM_EXPANSIONS,
                            max_beam_tokens=BEAM_MAX_TOKENS, lm=use_lm,
                            lm_weight=BEAM_LM_WEIGHT)
        run, counts = counted(lambda: engine_ticks(
            eng, np.stack([seeded_pcm(s, 2 * ENGINE_SECONDS)
                           for s in range(n)])), launches)
        res = tick_summary(run, cc_w[13], n)
        out["w8a8_engine"][name] = res | dict(launches=counts)
        log(f"  engine {n} slots W8A8 bf16 device DSP R=13 K={BEAM_K} "
            f"({name}): tick p50 {res['p50_ms']:.2f} / p90 "
            f"{res['p90_ms']:.2f} ms over {res['chunk_ticks']} chunk ticks, "
            f"aggregate RTF {res['rtf']:.4f}, launches {json.dumps(counts)} "
            f"({card_name})")
    eng = ServingEngine(w8, cfg, vocab, cc_w[13], n_slots=n,
                        compute_dtype=bf16, dsp="device", beam_size=BEAM_K,
                        beam_expansions=BEAM_EXPANSIONS,
                        max_beam_tokens=BEAM_MAX_TOKENS)
    reset_counts()
    prof = engine_step_profile(eng, 3)
    add(kernel_counts())
    busy = prof["busy_us"] / prof["wall_us"] if prof["wall_us"] else 0.0
    total = sum(prof["count"].values())
    out["profile"] = dict(wall_ms=prof["wall_us"] / 1e3,
                          busy_ms=prof["busy_us"] / 1e3, busy_share=busy,
                          launches_per_tick=total / 3,
                          by_name={k: prof["count"][k] / 3
                                   for k, _ in prof["by_name"][:12]})
    log(f"  profile engine {n} slots W8A8 bf16 R=13 K={BEAM_K}, 3 ticks: "
        f"wall {prof['wall_us'] / 1e3:.2f} ms, device busy "
        f"{prof['busy_us'] / 1e3:.2f} ms ({100 * busy:.1f}%), "
        f"{total / 3:.0f} launches a tick ({card_name})")
    for kname, us in prof["by_name"][:12]:
        log(f"    {us / 3e3:8.3f} ms  {prof['count'][kname] / 3:8.0f} "
            f"launches a tick  {kname}")
    if prof["busy_us"] <= 0 or prof["encoder_steps"] != 3:
        failures.append(f"beam engine profile: busy {prof['busy_us']}, "
                        f"{prof['encoder_steps']} encoder steps")
    # the beam's own device time for one tick's chunk: beam_decode over a
    # 64-slot R = 13 chunk of encoder output, alone
    w8p = eng.params
    st = enc_mod.init_encoder_state(cfg, cc_w[13], n, bf16, q8.device)
    mel = torch.randn((n, cc_w[13].chunk_mel_frames, cfg.n_mels),
                      generator=torch.Generator().manual_seed(SEED)).cuda()
    enc_out, _ = enc_mod.encode_chunk(w8p, cfg, cc_w[13], mel.to(bf16), st,
                                      eng.pos_heads)
    bst = beam_mod.init_beam_state(cfg, n, BEAM_K, BEAM_MAX_TOKENS, bf16,
                                   q8.device)
    beam_mod.beam_decode(w8p, cfg, enc_out, bst, BEAM_K, BEAM_EXPANSIONS)
    bp = profile_window(lambda: beam_mod.beam_decode(
        w8p, cfg, enc_out, bst, BEAM_K, BEAM_EXPANSIONS))
    out["beam_alone"] = dict(wall_ms=bp["wall_us"] / 1e3,
                             device_ms=bp["busy_us"] / 1e3,
                             launches=sum(bp["count"].values()))
    log(f"  beam_decode alone, {n} slots x K={BEAM_K}, one R=13 chunk "
        f"({cc_w[13].valid_out_len} frames): wall {bp['wall_us'] / 1e3:.2f} "
        f"ms, device {bp['busy_us'] / 1e3:.2f} ms, "
        f"{sum(bp['count'].values())} launches ({card_name})")

    # (2) the card's K = 4 session against the CPU's
    ref = finish_job(ref_job, ref_path)
    shutil.rmtree(tmp, ignore_errors=True)
    if ref["chunks"] != card_chunks:
        failures.append(f"beam card vs CPU: {card_chunks} chunks, CPU "
                        f"{ref['chunks']}")
    cmp = compare_beams("beam card vs CPU", beam_rows(card.beam_state),
                        ref["rows"], failures)
    out["card_vs_cpu"] = cmp | dict(
        chunks=card_chunks, launches=card_counts,
        chunk_ms=card.chunk_seconds / max(card_chunks, 1) * 1e3)
    log(f"  K={BEAM_K} session card vs CPU, Q8_0 f32 R=13, {card_chunks} "
        f"chunks: score max_abs_err {cmp['score_gap']:.3e} (tol "
        f"{TOL_BEAM_SCORE:.0e}), {cmp['slots_differ']} of {BEAM_K} slots "
        f"with other tokens, best hypothesis equal {cmp['best_equal']} "
        f"({cmp['best_tokens']} tokens), mean chunk "
        f"{out['card_vs_cpu']['chunk_ms']:.2f} ms, launches "
        f"{json.dumps(card_counts)} ({card_name})")
    out["launches"] = launches
    return out


def beam_tones_phase(failures: list) -> dict:
    """The trained fixtures on the card against the port's CPU path:
    tones_tiny.gguf with tones_tiny_lm.gguf (K = 4, lm_weight 0.3) over the
    tones phase's 8 seeded streams at R = 13 (token error printed, tokens
    equal); the same streams through a 64-slot ServingEngine (host DSP,
    finalized tokens equal to the CPU session's) and a LockstepEngine, each
    with the LM, their beams held to the card session's before its
    finalize (compare_beams); transcribe_batch(lm_rescore=True, return_nbest=4) on the same
    audio (texts equal, scores within TOL_BEAM_SCORE); the server module
    with --refine on tones_tiny_sil.gguf (UTTERANCE events and their
    "refined" texts equal to the same module run with --cpu); the
    streaming CLI with --boost, greedy and with --beam and --lm (stdout
    equal to --cpu). The CPU references, the CLIs and the servers run in
    child processes from the start of the phase, beside the card work."""
    import threading

    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.models.lm import load_lm
    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.streaming.lockstep import LockstepEngine
    from nemotron_tpu_torch.streaming.serving import ServingEngine
    from nemotron_tpu_torch.streaming.session import transcribe_batch
    from nemotron_tpu_torch.utils.tones import make_eval_streams

    here = os.path.dirname(os.path.abspath(__file__))
    fixture = os.path.join(here, "weights", "tones_tiny.gguf")
    lm_path = os.path.join(here, "weights", "tones_tiny_lm.gguf")
    sil = os.path.join(here, "weights", "tones_tiny_sil.gguf")
    env = dict(os.environ, PYTHONPATH=here, OMP_NUM_THREADS="2")
    audio, truths = make_eval_streams(TONES_STREAMS, TONES_SECONDS, TONES_N,
                                      seed=TONES_SEED)
    tmp = tempfile.mkdtemp()
    ref_path = os.path.join(tmp, "ref.json")
    ref_job = start_cpu_job("cpu_tones_reference", ref_path)
    # the streaming CLI with --boost (greedy, and with --beam and --lm), on
    # the card and with --cpu; the server module with --refine on the
    # silence-robust fixture, on the card and with --cpu
    pcm_path = os.path.join(tmp, "a.pcm")
    audio[0, :8 * 16000].astype("<i2").tofile(pcm_path)
    clis = {}
    for name, extra in (("boost", []), ("boost beam lm",
                                        [f"--beam={BEAM_K}",
                                         f"--lm={lm_path}"])):
        for dev in ("cuda", "cpu"):
            clis[name, dev] = subprocess.Popen(
                [sys.executable, "-m", "nemotron_tpu_torch.cli", fixture,
                 pcm_path, "80", "13", "--boost=T3:1.5,T7:-1", *extra,
                 *(["--cpu"] if dev == "cpu" else [])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=here)
    servers = {dev: start_server_module(
        [sil, "--slots", "2", "--endpoint-silence", "1", "--endpoint-reset",
         "--refine", "--refine-beam", str(BEAM_K), "--lm", lm_path,
         *(["--cpu"] if dev == "cpu" else [])], env, here)
        for dev in ("cuda", "cpu")}

    card = load_model(fixture, device="cuda")
    cfg, vocab = card[1], card[2]
    lm_card = load_lm(lm_path, "cuda")
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    out = {}
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    q = cc.shift_samples
    beam_kw = dict(compute_dtype=torch.float32, beam_size=BEAM_K,
                   beam_expansions=BEAM_EXPANSIONS,
                   max_beam_tokens=BEAM_MAX_TOKENS, lm=lm_card,
                   lm_weight=BEAM_LM_WEIGHT)

    def fused():
        """The card session, its beam kept before the finalize."""
        sess = beam_session(card[0], cfg, vocab, cc, audio, torch.float32,
                            lm=lm_card, finalize=False)
        rows, chunks = beam_rows(sess.beam_state), sess.total_chunks
        sess.finalize()
        return sess, rows, chunks

    (got, got_rows, got_chunks), counts = counted(fused, launches)

    def engine_run():
        eng = ServingEngine(card[0], cfg, vocab, cc, n_slots=ENGINE_SLOTS,
                            dsp="numpy", **beam_kw)
        slots = eng.add_streams(TONES_STREAMS)
        for i in range(0, audio.shape[1], q):
            eng.feed_audio({s: audio[k, i:i + q]
                            for k, s in enumerate(slots)})
            eng.step()
        rows = beam_rows(eng.beam_state, slots)
        chunks = [int(eng.frame_offsets[s]) // cc.valid_out_len
                  for s in slots]
        ends = eng.finalize_streams(slots, return_tokens=True)
        return rows, chunks, [[list(t) for t in toks] for _, toks in ends]

    (eng_rows, eng_chunks, eng_finals), eng_counts = counted(engine_run,
                                                             launches)
    lock = LockstepEngine(card[0], cfg, vocab, cc, n_streams=TONES_STREAMS,
                          **beam_kw)

    def lock_run():
        for i in range(0, audio.shape[1], q):
            lock.tick_pipelined(audio[:, i:i + q])
        lock.flush_pipeline()

    _, lock_counts = counted(lock_run, launches)
    nb, nb_counts = counted(lambda: transcribe_batch(
        card[0], cfg, vocab, list(audio), lm=lm_card, **TONES_NBEST_KW),
        launches)

    # the server module with --refine, card and CPU at once
    events, errors = {}, []

    def replay(dev):
        try:
            r = stream_client("tcp", "127.0.0.1", server_port(servers[dev])[0],
                              sil_pcm(), 0.0, 1600, wait_utterances=2)
            events[dev] = (r["ready"], r["utterances"])
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            errors.append(f"{dev}: {e!r}")

    try:
        threads = [threading.Thread(target=replay, args=(d,))
                   for d in servers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        for proc in servers.values():
            stop_process(proc)
    cli_out = {k: p.communicate(timeout=600) + (p.returncode,)
               for k, p in clis.items()}
    ref = finish_job(ref_job, ref_path)
    shutil.rmtree(tmp, ignore_errors=True)

    toks = [[t for t, _ in got.get_tokens(s)] for s in range(TONES_STREAMS)]
    same = [list(map(list, got.get_tokens(s))) for s in
            range(TONES_STREAMS)] == ref["tokens"]
    ter = token_error(toks, truths)
    out["fusion"] = dict(ter=ter, same_as_cpu=same, launches=counts,
                         chunk_ms=got.chunk_seconds
                         / max(got.total_chunks, 1) * 1e3)
    log(f"  tones K={BEAM_K} + tones_tiny_lm (weight {BEAM_LM_WEIGHT}) R=13 "
        f"S={TONES_STREAMS}: token error {ter:.4f}, tokens vs CPU "
        f"{'equal' if same else 'DIFFER'}, mean chunk "
        f"{out['fusion']['chunk_ms']:.2f} ms, launches {json.dumps(counts)}")
    if not same or counts["attn"] != cfg.n_layers * got.total_chunks:
        failures.append(f"beam tones fusion: tokens vs CPU equal {same}, "
                        f"launches {counts}")

    finals_same = eng_finals == ref["tokens"]
    cmp = compare_beams("tones engine + LM", eng_rows, got_rows, failures)
    out["engine"] = cmp | dict(finals_equal_cpu=finals_same,
                               chunks=eng_chunks, launches=eng_counts)
    log(f"  tones {ENGINE_SLOTS}-slot engine K={BEAM_K} + LM, host DSP, "
        f"{TONES_STREAMS} streams: beams vs the card session's after the "
        f"same {got_chunks} chunks: score max_abs_err "
        f"{cmp['score_gap']:.3e}, {cmp['slots_differ']} slots with other "
        f"tokens, best hypotheses equal {cmp['best_equal']}; finalized "
        f"tokens vs CPU {'equal' if finals_same else 'DIFFER'}, launches "
        f"{json.dumps(eng_counts)}")
    if (not finals_same or eng_chunks != [got_chunks] * TONES_STREAMS
            or not eng_counts["attn"]):
        failures.append(f"beam tones engine: finals vs CPU {finals_same}, "
                        f"chunks {eng_chunks} (session {got_chunks}), "
                        f"launches {eng_counts}")
    cmp = compare_beams("tones lockstep + LM", beam_rows(lock.beam_state),
                        got_rows, failures)
    out["lockstep"] = cmp | dict(chunks=lock.total_chunks,
                                 launches=lock_counts)
    log(f"  tones lockstep K={BEAM_K} + LM, {TONES_STREAMS} streams "
        f"({lock.total_chunks} chunks): beams vs the card session's: score "
        f"max_abs_err {cmp['score_gap']:.3e}, {cmp['slots_differ']} slots "
        f"with other tokens, best hypotheses equal {cmp['best_equal']}, "
        f"launches {json.dumps(lock_counts)}")
    if (lock.total_chunks != got_chunks
            or lock_counts["attn"] != cfg.n_layers * got_chunks):
        failures.append(f"beam tones lockstep: {lock.total_chunks} chunks "
                        f"(session {got_chunks}), launches {lock_counts}")

    nb_cpu = ref["nbest"]
    texts_same = [[t for t, _ in a] for a in nb] == \
        [[t for t, _ in a] for a in nb_cpu]
    gap = max(abs(s - w) for a, b in zip(nb, nb_cpu)
              for (_, s), (_, w) in zip(a, b))
    best = [[vocab.index("▁" + w) for w in a[0][0].split()] for a in nb]
    out["rescore_nbest"] = dict(texts_equal=texts_same, score_gap=gap,
                                ter_best=token_error(best, truths),
                                launches=nb_counts)
    log(f"  transcribe_batch lm_rescore n-best {BEAM_K} of the "
        f"{TONES_STREAMS} streams: texts vs CPU "
        f"{'equal' if texts_same else 'DIFFER'}, score max_abs_err "
        f"{gap:.3e} (tol {TOL_BEAM_SCORE:.0e}), token error of the best "
        f"{out['rescore_nbest']['ter_best']:.4f}, launches "
        f"{json.dumps(nb_counts)}")
    if not texts_same or not gap <= TOL_BEAM_SCORE:
        failures.append(f"beam tones rescoring: texts equal {texts_same}, "
                        f"score gap {gap}")

    out["cli"] = {}
    for name in ("boost", "boost beam lm"):
        a, b = cli_out[name, "cuda"], cli_out[name, "cpu"]
        ok = a[2] == b[2] == 0 and a[0] == b[0] and a[0].strip() != ""
        out["cli"][name] = ok
        log(f"  streaming CLI --boost{' --beam --lm' if 'lm' in name else ''}"
            f" on the card vs --cpu: stdout {'equal' if ok else 'DIFFERENT'}"
            f" ({len(a[0].split())} words)")
        if not ok:
            failures.append(f"CLI {name}: card {a[2]} {a[0][:80]!r} "
                            f"{a[1][-300:]!r}, cpu {b[2]} {b[0][:80]!r}")

    utts = {d: [(u["text"], u.get("refined")) for u in e[1]]
            for d, e in events.items()}
    ok = (not errors and utts.get("cuda") == utts.get("cpu")
          and len(utts["cuda"]) == 2 and all(r for _, r in utts["cuda"])
          and events["cuda"][0]["refined"] is True)
    out["refine"] = dict(events=utts.get("cuda"), equal_to_cpu=ok)
    log(f"  asr_server --refine (K={BEAM_K} + LM) on tones_tiny_sil: "
        f"UTTERANCE (online, refined) {utts.get('cuda')}, equal to --cpu "
        f"{ok}")
    if not ok:
        failures.append(f"server --refine: {utts}, errors {errors}")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# slice 15: TDT and CTC decoding
# ---------------------------------------------------------------------------

def tdt_pcm(cc, stream: int = 0) -> np.ndarray:
    """[1, N] seeded PCM for TDT_CHUNKS chunks of `cc` (and one shift
    more)."""
    return seeded_pcm(stream, (TDT_CHUNKS + 1) * cc.shift_samples
                      / 16000)[None]


def tdt_ctc_trace(params, cfg, vocab, cc, pcm, dtype, chunks=None, **kw):
    """A StreamSession (options `kw`) over `pcm` [S, N], one chunk shift of
    samples a call, stopped once `chunks` chunks ran (None: the whole PCM,
    no finalize). Returns the session and, for each chunk, stream 0's new
    tokens and its carry after the chunk (ctc_prev with ctc=True, else
    tdt_skip)."""
    from nemotron_tpu_torch.streaming.session import StreamSession

    sess = StreamSession(params, cfg, vocab, cc, n_streams=pcm.shape[0],
                         compute_dtype=dtype, **kw)
    q = cc.shift_samples
    trace = []
    for i in range(0, pcm.shape[1], q):
        if chunks is not None and sess.total_chunks >= chunks:
            break
        k, n = sess.total_chunks, len(sess.get_tokens(0))
        sess.process(pcm[:, i:i + q])
        if sess.total_chunks > k:
            carry = sess.ctc_prev[0] if sess.ctc else sess.tdt_skip[0]
            trace.append(dict(tokens=[list(t) for t in sess.get_tokens(0)[n:]],
                              carry=int(carry)))
    return sess, trace


def tdt_beam_rows(state, rows=None) -> list:
    """beam_rows of a TdtBeamState with each slot's time pointer (t) and
    symbol count (sym)."""
    out = beam_rows(state, rows)
    t, sym = state.t.cpu().tolist(), state.sym.cpu().tolist()
    for r, row in zip(range(len(t)) if rows is None else rows, out):
        row.update(t=t[r], sym=sym[r])
    return out


def chunk_encoder_outputs(params, cfg, cc, pcm, chunks=None) -> list:
    """The encoder outputs [1, T, D] of a one-stream session's chunks over
    `pcm` [N] (the 9-frame zero seed, one chunk shift a step; the first
    `chunks` of them, or all), computed directly."""
    import torch

    from nemotron_tpu_torch.config import PreprocessorConfig
    from nemotron_tpu_torch.frontend.preprocessor import StreamingPreprocessor
    from nemotron_tpu_torch.models import encoder as enc_mod

    pre = StreamingPreprocessor(
        params.preprocessor.filterbank.float().cpu().numpy(),
        params.preprocessor.window.float().cpu().numpy(),
        cfg=PreprocessorConfig(n_mels=cfg.n_mels), device=params.device)
    mel = np.concatenate([np.zeros((1, cc.pre_encode_cache_size, cfg.n_mels),
                                   np.float32), pre.process(pcm[None])], 1)
    st = enc_mod.init_encoder_state(cfg, cc, 1, torch.float32, params.device)
    ph = enc_mod.precompute_pos_heads(params, cfg, cc)
    outs = []
    for i in range(0, mel.shape[1] - cc.chunk_mel_frames + 1,
                   cc.shift_mel_frames):
        o, st = enc_mod.encode_chunk(params, cfg, cc, torch.from_numpy(
            np.ascontiguousarray(mel[:, i:i + cc.chunk_mel_frames])).to(
                params.device), st, ph)
        outs.append(o)
        if len(outs) == chunks:
            break
    return outs


def count_syncs(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): its result and
    the host syncs it made (the warnings that mode raises), by the source
    line that made them ({"file:line": count})."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            r = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    where: dict[str, int] = {}
    for w in seen:
        if "synchroniz" in str(w.message):
            key = f"{os.path.basename(w.filename)}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return r, where


def cpu_tdt_ctc_reference(tdt_path: str, out_path: str) -> None:
    """tdt_ctc_phase's CPU references: first the phase's GGUF
    (write_tdt_ctc_gguf; the card waits for it), then, on the CPU, the TDT
    greedy session with confidence and the CTC session over TDT_CHUNKS
    chunks in the four modes (tdt_ctc_trace) and the K = BEAM_K TDT beam
    over TDT_CHUNKS chunks at R = 13 (tdt_beam_rows), as JSON."""
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import load_model

    write_tdt_ctc_gguf(tdt_path)
    params, cfg, vocab = load_model(tdt_path, device="cpu")
    out = {"tdt": {}, "ctc": {}}
    for R in MODES:
        cc = CacheConfig(att_right_context=R, n_mels=cfg.n_mels)
        for fam, kw in (("tdt", dict(confidence=True)), ("ctc", dict(
                ctc=True))):
            _, out[fam][f"R={R}"] = tdt_ctc_trace(
                params, cfg, vocab, cc, tdt_pcm(cc), torch.float32,
                TDT_CHUNKS, **kw)
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    sess, _ = tdt_ctc_trace(params, cfg, vocab, cc, tdt_pcm(cc),
                            torch.float32, TDT_CHUNKS, beam_size=BEAM_K,
                            max_beam_tokens=BEAM_MAX_TOKENS)
    out["beam"] = dict(rows=tdt_beam_rows(sess.beam_state),
                       chunks=sess.total_chunks)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(out, f)


def tdt_ctc_phase(tdt_path: str, ref_job, ref_path: str, w8_runs: dict,
                  failures: list) -> dict:
    """Slice 15 at full width: the second seeded GGUF (TDT_DURATIONS, a CTC
    head, the heads shaped by shape_tdt_ctc_heads), written and decoded on
    the CPU by the child `ref_job` while the earlier phases ran.
    (1) card vs CPU, Q8_0 f32 S = 1, TDT_CHUNKS chunks, the four modes:
        the TDT walk with confidence (each chunk's tokens with frames and
        tdt_skip equal, confidences within TOL_CONF_ABS) and ctc=True
        (tokens with frames and ctc_prev equal); 24 attention and 240 Q8
        launches a chunk; what they compared printed (tokens, the walk's
        jumps and overshoots; the CTC ids and the repeats collapsed).
    (2) the R = 13 stream's encoder outputs: the walk chunk by chunk with
        the skip carry equal to one call over all the chunks' frames (the
        JAX package's streaming gate, tests/test_tdt_streaming.py) and to
        the session's tokens; the K = 1 beam equal to the walk (tokens and
        overshoot; tests/test_tdt.py); the host syncs of one TDT greedy
        chunk and of one K = BEAM_K beam chunk (readings).
    (3) card vs CPU, the K = BEAM_K TDT beam over TDT_CHUNKS chunks at
        R = 13: compare_beams, and t and sym equal in every slot.
    (4) on the COMPARE_LAYERS cut (since slice 18, to keep the script's
        time with the slice's phase; same-card comparisons, as the engine
        and lockstep phases'): the 64-slot ServingEngine, Q8_0 f32, the
        engine phase's ragged schedule, TDT greedy with host DSP
        (finalized tokens of the tracked streams equal to solo sessions')
        and CTC with device DSP (their tokens over the chunks of real
        audio); the LockstepEngine, 8 streams, in both families (the
        real-audio chunks' tokens equal to solo sessions'); every compared
        list non-empty.
    (5) readings, W8A8 + int8 K/V bf16: mean chunk ms at S = 8 in the four
        modes for TDT greedy and CTC (beside this run's RNN-T greedy), the
        64-slot device-DSP engine's tick p50 / p90 at R = 13 for TDT
        greedy, TDT beam K = BEAM_K and CTC, a 3-tick profile of each and
        the decode's own device ms for a 64-slot chunk."""
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.models import ctc as ctc_mod
    from nemotron_tpu_torch.models import decoder as dec_mod
    from nemotron_tpu_torch.models import encoder as enc_mod
    from nemotron_tpu_torch.models import tdt as tdt_mod
    from nemotron_tpu_torch.models.beam import best_hypothesis
    from nemotron_tpu_torch.params import quantize_model_params
    from nemotron_tpu_torch.streaming.lockstep import LockstepEngine
    from nemotron_tpu_torch.streaming.serving import ServingEngine

    f32, bf16 = torch.float32, torch.bfloat16
    t0 = time.perf_counter()
    t_end = time.time() + 900
    while not os.path.exists(tdt_path):
        if ref_job.poll() is not None:
            finish_job(ref_job, ref_path)          # raises with its stderr
        if time.time() > t_end:
            raise RuntimeError("the TDT/CTC GGUF was not written in 900 s")
        time.sleep(1.0)
    q8, cfg, vocab = full_width_model(tdt_path, "cuda")
    dev, blank = q8.device, cfg.blank_token
    card_name = gpu_name_and_power()
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    out = {}
    V, D = cfg.vocab_size, len(cfg.tdt_durations or ())
    log(f"phase TDT/CTC: the GGUF waited for and loaded in "
        f"{time.perf_counter() - t0:.1f} s; durations {cfg.tdt_durations}, "
        f"joint output "
        f"{tuple(q8.joint.out_w.shape)}, CTC head "
        f"{None if q8.ctc is None else tuple(q8.ctc.out_w.shape)}, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, vocab {V}")
    if (cfg.tdt_durations != TDT_DURATIONS or q8.ctc is None
            or tuple(q8.joint.out_w.shape) != (cfg.joint_dim, V + D)):
        failures.append(f"TDT/CTC GGUF: durations {cfg.tdt_durations}, "
                        f"joint {tuple(q8.joint.out_w.shape)}, CTC head "
                        f"{q8.ctc is not None}")

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    def want_counts(chunks, kernel):
        other = "w8a8" if kernel == "q8" else "q8"
        return {"attn": cfg.n_layers * chunks,
                kernel: 10 * cfg.n_layers * chunks, other: 0}

    cc_of = {R: CacheConfig(att_right_context=R, n_mels=cfg.n_mels)
             for R in MODES}
    cc13 = cc_of[13]
    families = (("tdt", dict(confidence=True)), ("ctc", dict(ctc=True)))

    # (1) card sessions, the four modes (compared with the CPU at the end)
    tdt_ctc_trace(q8, cfg, vocab, cc13, tdt_pcm(cc13)[:, :2
                                                   * cc13.shift_samples],
                  f32, confidence=True)                        # warm-up
    card = {"tdt": {}, "ctc": {}}
    for R in MODES:
        for fam, kw in families:
            (sess, trace), n = counted(lambda: tdt_ctc_trace(
                q8, cfg, vocab, cc_of[R], tdt_pcm(cc_of[R]), f32,
                TDT_CHUNKS, **kw), launches)
            card[fam][R] = dict(trace=trace, counts=n,
                                chunk_ms=sess.chunk_seconds
                                / max(sess.total_chunks, 1) * 1e3)
            if (sess.total_chunks != TDT_CHUNKS
                    or n != want_counts(TDT_CHUNKS, "q8")):
                failures.append(f"TDT/CTC {fam} R={R}: "
                                f"{sess.total_chunks} chunks, launches {n}")

    # (2) the walk on the R = 13 stream's encoder outputs
    encs = chunk_encoder_outputs(q8, cfg, cc13, tdt_pcm(cc13)[0], TDT_CHUNKS)
    T = encs[0].shape[1]
    st, skip, walk, skips = (dec_mod.init_decoder_state(cfg, 1, f32, dev),
                             None, [], [])
    for i, e in enumerate(encs):
        toks, st, skip = tdt_mod.tdt_greedy_decode(q8, cfg, e, st,
                                                   skip_in=skip)
        walk += [(t, f + i * T) for t, f in
                 dec_mod.tokens_to_list(toks[0].cpu().numpy(), blank)]
        skips.append(int(skip[0]))
    one = tdt_mod.tdt_greedy_decode(q8, cfg, torch.cat(encs, 1),
                                    dec_mod.init_decoder_state(cfg, 1, f32,
                                                               dev))[0]
    one = dec_mod.tokens_to_list(one[0].cpu().numpy(), blank)
    sess13 = [tuple(t[:2]) for c in card["tdt"][13]["trace"]
              for t in c["tokens"]]
    frames = sorted({f for _, f in walk})
    jumps = sorted(set(np.diff(frames).tolist())) if len(frames) > 1 else []
    bst = tdt_mod.init_tdt_beam_state(cfg, 1, 1, BEAM_MAX_TOKENS, f32, dev)
    for e in encs:
        bst = tdt_mod.tdt_beam_decode(q8, cfg, e, bst, 1)
    btok, blen, _ = best_hypothesis(bst)
    k1 = btok[0, :int(blen[0])].tolist()
    k1_same = k1 == [t for t, _ in walk] and int(bst.t[0, 0]) == skips[-1]
    ids = ctc_mod.frame_ids(q8, torch.cat(encs, 1))[0].tolist()
    nb = [i for i in ids if i != blank]
    repeats = sum(a == b != blank for a, b in zip(ids, ids[1:]))
    out["walk"] = dict(tokens=len(walk), distinct=len({t for t, _ in walk}),
                       frames_emitting=len(frames), frames=T * len(encs),
                       emission_gaps=jumps, skips=skips,
                       chunked_equals_one_shot=walk == one,
                       session_equals_walk=sess13 == walk,
                       k1_equals_greedy=k1_same,
                       ctc_distinct=len(set(nb)), ctc_repeats=repeats,
                       ctc_blank_frames=len(ids) - len(nb))
    log(f"  TDT walk R=13 over {len(encs)} chunks ({T} frames each): "
        f"{len(walk)} tokens ({out['walk']['distinct']} ids) on "
        f"{len(frames)} of {T * len(encs)} frames, gaps between emitting "
        f"frames {jumps}, overshoot carried {skips}; chunked with the skip "
        f"carry equal to one call over all frames {walk == one}, equal to "
        f"the session's {sess13 == walk}; K=1 beam equal to it (tokens "
        f"and overshoot) {k1_same}; CTC head on the same frames: "
        f"{len(set(nb))} distinct non-blank ids, {repeats} repeats "
        f"collapsed, {len(ids) - len(nb)} blank frames")
    if not (walk and walk == one and sess13 == walk and k1_same
            and max(jumps or [0]) > 1 and len(set(nb)) >= 2 and repeats):
        failures.append(f"TDT walk: {out['walk']}")
    g_out, g_syncs = count_syncs(lambda: tdt_mod.tdt_greedy_decode(
        q8, cfg, encs[-1], st, skip_in=skip, with_iters=True))
    bst4 = tdt_mod.init_tdt_beam_state(cfg, 1, BEAM_K, BEAM_MAX_TOKENS, f32,
                                       dev)
    _, b_syncs = count_syncs(lambda: tdt_mod.tdt_beam_decode(
        q8, cfg, encs[-1], bst4, BEAM_K))
    out["syncs"] = dict(greedy=sum(g_syncs.values()), greedy_at=g_syncs,
                        greedy_iterations=g_out[-1],
                        beam=sum(b_syncs.values()), beam_at=b_syncs)
    log(f"  host syncs of one R=13 chunk ({T} frames) under "
        f"set_sync_debug_mode('warn'): TDT greedy {sum(g_syncs.values())} "
        f"({g_out[-1]} loop iterations; by line {json.dumps(g_syncs)}), "
        f"TDT beam K={BEAM_K} {sum(b_syncs.values())} (by line "
        f"{json.dumps(b_syncs)})")

    # (3) the K = BEAM_K TDT beam session (compared with the CPU at the end)
    (bsess, _), bcounts = counted(lambda: tdt_ctc_trace(
        q8, cfg, vocab, cc13, tdt_pcm(cc13), f32, TDT_CHUNKS,
        beam_size=BEAM_K, max_beam_tokens=BEAM_MAX_TOKENS), launches)
    brows = tdt_beam_rows(bsess.beam_state)
    if bcounts != want_counts(bsess.total_chunks, "q8"):
        failures.append(f"TDT beam session: launches {bcounts}")

    # (4) the engines against solo sessions, on the COMPARE_LAYERS cut
    # (same-card comparisons, as the engine and lockstep phases' since
    # PR 17; slice 18)
    q8c, cfgc = cut_layers(q8, cfg, COMPARE_LAYERS)
    n = ENGINE_SLOTS
    plan = ragged_plan(n, ENGINE_SECONDS, cc13.shift_samples)
    out["engine"], out["lockstep"] = {}, {}
    for (fam, kw), dsp in zip(families, ("numpy", "device")):
        kw = {k: v for k, v in kw.items() if k == "ctc"}
        t0 = time.perf_counter()
        eng = ServingEngine(q8c, cfgc, vocab, cc13, n_slots=n,
                            compute_dtype=f32, dsp=dsp, **kw)
        with EncoderTap() as tap:
            run, counts = counted(lambda: engine_schedule(
                eng, lambda sid: seeded_pcm(sid, ENGINE_SECONDS), **plan),
                launches)
        check_engine_launches(f"{fam} {dsp} DSP", counts, tap.calls, cfgc,
                              10, "q8", failures)
        same, lens = [], []
        for sid in tracked_streams(n):
            solo = solo_session(q8c, cfgc, vocab, cc13, run["pcm"][sid],
                                f32, **kw)
            got, want = ((run["finals"][sid], solo["final"]) if dsp == "numpy"
                         else (streamed_part(run["finals"][sid], solo),
                               solo["streamed"]))
            same.append(got == want and len(want) > 0)
            lens.append(len(want))
        lat = run["latency"]
        out["engine"][fam] = dict(dsp=dsp, tokens_equal=same, tokens=lens,
                                  p50_ms=lat["p50"] * 1e3,
                                  p90_ms=lat["p90"] * 1e3, launches=counts,
                                  encoder_steps=tap.calls)
        log(f"  engine {n} slots {fam.upper()} Q8_0 f32 {dsp} DSP R=13 "
            f"(ragged): tracked streams' tokens equal to solo sessions "
            f"{same} ({lens} tokens; {'finalized' if dsp == 'numpy' else 'the real-audio chunks'}), "
            f"step p50 {lat['p50'] * 1e3:.2f} / p90 {lat['p90'] * 1e3:.2f} "
            f"ms, launches {json.dumps(counts)} in {tap.calls} encoder steps "
            f"(wall {time.perf_counter() - t0:.1f} s)")
        if not all(same):
            failures.append(f"engine {fam} {dsp}: tokens equal {same}")
        del eng, run
        S = BEAM_LOCK_STREAMS
        pcm = np.stack([seeded_pcm(s) for s in range(S)])
        lock = LockstepEngine(q8c, cfgc, vocab, cc13, n_streams=S,
                              compute_dtype=f32, **kw)
        with EncoderTap() as tap:
            run, counts = counted(lambda: lockstep_run(lock, pcm), launches)
        check_engine_launches(f"lockstep {fam}", counts, tap.calls, cfgc, 10,
                              "q8", failures)
        solos = [solo_session(q8c, cfgc, vocab, cc13, pcm[s], f32, **kw)
                 for s in range(S)]
        same = [run["streamed"][s] == solos[s]["streamed"]
                and len(solos[s]["streamed"]) > 0 for s in range(S)]
        out["lockstep"][fam] = dict(tokens_equal=same, launches=counts,
                                    chunks=run["chunks"],
                                    tokens=run["tokens"])
        log(f"  lockstep {S} streams {fam.upper()} Q8_0 f32 R=13 "
            f"({run['chunks']} chunks, {run['tokens']} tokens): tokens of "
            f"the real-audio chunks equal to solo sessions {same}, launches "
            f"{json.dumps(counts)} in {tap.calls} encoder steps")
        if not all(same):
            failures.append(f"lockstep {fam}: tokens equal {same}")
        del lock, run, solos

    # (5) readings: W8A8 + int8 K/V bf16
    w8 = quantize_model_params(q8, mode="w8a8")
    cc_w = {R: CacheConfig(att_right_context=R, n_mels=cfg.n_mels,
                           kv_cache_int8=True) for R in MODES}
    pcm8 = np.stack([seeded_pcm(s, TDT_READ_SECONDS)
                     for s in range(W8A8_STREAMS)])
    tdt_ctc_trace(w8, cfg, vocab, cc_w[13], pcm8, bf16)         # warm-up
    out["w8a8_sessions"] = {}
    for fam, kw in families:
        kw = {k: v for k, v in kw.items() if k == "ctc"}
        for R in MODES:
            (sess, _), counts = counted(lambda: tdt_ctc_trace(
                w8, cfg, vocab, cc_w[R], pcm8, bf16, **kw), launches)
            chunks = sess.total_chunks
            ms = sess.chunk_seconds / max(chunks, 1) * 1e3
            rnnt = w8_runs.get(f"R={R}", {}).get("chunk_ms", float("nan"))
            out["w8a8_sessions"][f"{fam} R={R}"] = dict(
                chunk_ms=ms, chunks=chunks, rnnt_chunk_ms=rnnt,
                tokens=sum(len(sess.get_tokens(s))
                           for s in range(W8A8_STREAMS)))
            log(f"  W8A8 + int8 K/V bf16 {fam.upper()} S={W8A8_STREAMS} "
                f"R={R}: mean chunk {ms:.2f} ms over {chunks} chunks (RNN-T "
                f"greedy in this run's W8A8 path phase: {rnnt:.2f} ms), "
                f"launches {json.dumps(counts)} ({card_name})")
            if not chunks or counts != want_counts(chunks, "w8a8"):
                failures.append(f"TDT/CTC W8A8 {fam} R={R}: launches "
                                f"{counts}")
    out["w8a8_engine"] = {}
    for name, kw in (("tdt", {}), ("tdt beam", dict(
            beam_size=BEAM_K, max_beam_tokens=BEAM_MAX_TOKENS)),
                     ("ctc", dict(ctc=True))):
        eng = ServingEngine(w8, cfg, vocab, cc_w[13], n_slots=n,
                            compute_dtype=bf16, dsp="device", **kw)
        run, counts = counted(lambda: engine_ticks(eng, np.stack(
            [seeded_pcm(s, 2 * ENGINE_SECONDS) for s in range(n)])),
            launches)
        res = tick_summary(run, cc_w[13], n)
        eng = ServingEngine(w8, cfg, vocab, cc_w[13], n_slots=n,
                            compute_dtype=bf16, dsp="device", **kw)
        reset_counts()
        prof = engine_step_profile(eng, 3)
        add(kernel_counts())
        busy = prof["busy_us"] / prof["wall_us"] if prof["wall_us"] else 0.0
        # the decode alone over one 64-slot R = 13 chunk of encoder output
        st = enc_mod.init_encoder_state(cfg, cc_w[13], n, bf16, dev)
        mel = torch.randn((n, cc13.chunk_mel_frames, cfg.n_mels),
                          generator=torch.Generator().manual_seed(SEED))
        enc_out, _ = enc_mod.encode_chunk(eng.params, cfg, cc_w[13],
                                          mel.to(dev, bf16), st,
                                          eng.pos_heads)
        if name == "ctc":
            def decode():
                return ctc_mod.frame_ids(eng.params, enc_out).cpu()
        elif name == "tdt":
            dst = dec_mod.init_decoder_state(cfg, n, bf16, dev)

            def decode():
                return tdt_mod.tdt_greedy_decode(eng.params, cfg, enc_out,
                                                 dst)[0].cpu()
        else:
            bst = tdt_mod.init_tdt_beam_state(cfg, n, BEAM_K,
                                              BEAM_MAX_TOKENS, bf16, dev)

            def decode():
                return tdt_mod.tdt_beam_decode(eng.params, cfg, enc_out,
                                               bst, BEAM_K).scores.cpu()
        decode()
        # ten calls a window, for a mean
        reps = 10
        dp = profile_window(lambda: [decode() for _ in range(reps)])
        dp = dict(wall_us=dp["wall_us"] / reps, busy_us=dp["busy_us"] / reps,
                  count={k: n / reps for k, n in dp["count"].items()})
        out["w8a8_engine"][name] = res | dict(
            launches=counts, busy_share=busy,
            profile_wall_ms=prof["wall_us"] / 1e3,
            profile_busy_ms=prof["busy_us"] / 1e3,
            launches_per_tick=sum(prof["count"].values()) / 3,
            decode_wall_ms=dp["wall_us"] / 1e3,
            decode_device_ms=dp["busy_us"] / 1e3,
            decode_launches=sum(dp["count"].values()))
        log(f"  engine {n} slots W8A8 bf16 device DSP R=13 {name.upper()}: "
            f"tick p50 {res['p50_ms']:.2f} / p90 {res['p90_ms']:.2f} ms over "
            f"{res['chunk_ticks']} chunk ticks, RTF {res['rtf']:.4f}; "
            f"3-tick profile: wall {prof['wall_us'] / 1e3:.2f} ms, busy "
            f"{prof['busy_us'] / 1e3:.2f} ms ({100 * busy:.1f}%), "
            f"{sum(prof['count'].values()) / 3:.0f} launches a tick; the "
            f"decode alone for a 64-slot chunk (mean of {reps} calls): "
            f"{dp['busy_us'] / 1e3:.3f} device ms in "
            f"{dp['wall_us'] / 1e3:.2f} ms, "
            f"{sum(dp['count'].values()):.0f} launches ({card_name})")
        for kname, us in prof["by_name"][:6]:
            log(f"    {us / 3e3:8.3f} ms  {prof['count'][kname] / 3:8.0f} "
                f"launches a tick  {kname}")
        if prof["busy_us"] <= 0 or prof["encoder_steps"] != 3:
            failures.append(f"TDT/CTC engine profile {name}: busy "
                            f"{prof['busy_us']}, {prof['encoder_steps']} "
                            "encoder steps")
        del eng, run

    # card vs CPU
    ref = finish_job(ref_job, ref_path)
    out["card_vs_cpu"] = {}
    for fam, _ in families:
        for R in MODES:
            got, want = card[fam][R]["trace"], ref[fam][f"R={R}"]
            toks = [t for c in got for t in c["tokens"]]
            same = ([[t[:2] for t in c["tokens"]] for c in got]
                    == [[t[:2] for t in c["tokens"]] for c in want]
                    and [c["carry"] for c in got]
                    == [c["carry"] for c in want])
            conf_gap = max((abs(a[2] - b[2]) for c, w in zip(got, want)
                            for a, b in zip(c["tokens"], w["tokens"])),
                           default=0.0) if fam == "tdt" else 0.0
            res = dict(equal=same, conf_gap=conf_gap, tokens=len(toks),
                       distinct=len({t[0] for t in toks}),
                       carries=[c["carry"] for c in got],
                       chunk_ms=card[fam][R]["chunk_ms"],
                       launches=card[fam][R]["counts"])
            out["card_vs_cpu"][f"{fam} R={R}"] = res
            log(f"  {fam.upper()} Q8_0 f32 S=1 R={R}, {TDT_CHUNKS} chunks, "
                f"card vs CPU: tokens with frames and "
                f"{'ctc_prev' if fam == 'ctc' else 'tdt_skip'} each chunk "
                f"{'equal' if same else 'DIFFER'} ({len(toks)} tokens, "
                f"{res['distinct']} ids, carries {res['carries']})"
                + (f", confidence max_abs_err {conf_gap:.3e} (tol "
                   f"{TOL_CONF_ABS:.0e})" if fam == "tdt" else "")
                + f", mean chunk {res['chunk_ms']:.2f} ms ({card_name})")
            if not same or not toks or not conf_gap <= TOL_CONF_ABS:
                failures.append(f"{fam} R={R} card vs CPU: {res}")
    cmp = compare_beams("TDT beam card vs CPU", brows, ref["beam"]["rows"],
                        failures)
    ts_same = [(g["t"], g["sym"]) == (w["t"], w["sym"])
               for g, w in zip(brows, ref["beam"]["rows"])]
    out["beam_card_vs_cpu"] = cmp | dict(t_sym_equal=ts_same,
                                         launches=bcounts)
    log(f"  TDT beam K={BEAM_K} Q8_0 f32 R=13, {bsess.total_chunks} chunks, "
        f"card vs CPU: score max_abs_err {cmp['score_gap']:.3e} (tol "
        f"{TOL_BEAM_SCORE:.0e}), {cmp['slots_differ']} slots with other "
        f"tokens, t and sym equal {ts_same}, best hypothesis equal "
        f"{cmp['best_equal']} ({cmp['best_tokens']} tokens), launches "
        f"{json.dumps(bcounts)}")
    if not all(ts_same) or ref["beam"]["chunks"] != bsess.total_chunks:
        failures.append(f"TDT beam card vs CPU: t/sym equal {ts_same}, "
                        f"chunks {bsess.total_chunks} vs "
                        f"{ref['beam']['chunks']}")
    out["launches"] = launches
    return out


def cpu_tdt_ctc_tones_reference(out_path: str) -> None:
    """tdt_ctc_tones_phase's CPU references: the tones streams (R = 13)
    through tones_tiny_tdt.gguf greedy and K = BEAM_K with
    tones_tiny_lm.gguf, and through tones_tiny_hybrid.gguf with ctc=True;
    each stream's tokens, as JSON."""
    import torch

    from nemotron_tpu_torch.models.lm import load_lm
    from nemotron_tpu_torch.params import load_model

    here = os.path.dirname(os.path.abspath(__file__))
    lm = load_lm(os.path.join(here, "weights", "tones_tiny_lm.gguf"), "cpu")
    out = {name: fixture_tokens(load_model(os.path.join(
        here, "weights", f"{gguf}.gguf"), device="cpu"), torch.float32, kw
        | ({"lm": lm} if kw.get("beam_size") else {}))
        for name, gguf, kw in TDT_FIXTURE_RUNS}
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(out, f)


# the trained fixtures' runs: (name, GGUF, session options)
TDT_FIXTURE_RUNS = (
    ("tdt", "tones_tiny_tdt", {}),
    ("tdt beam + LM", "tones_tiny_tdt", dict(
        beam_size=BEAM_K, max_beam_tokens=BEAM_MAX_TOKENS,
        lm_weight=BEAM_LM_WEIGHT)),
    ("hybrid ctc", "tones_tiny_hybrid", dict(ctc=True)))


def fixture_tokens(model, dtype, kw) -> list:
    """The tones streams (R = 13, finalized) through `model` (load_model's
    triple) in a session with options `kw`: each stream's tokens."""
    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.streaming.session import StreamSession
    from nemotron_tpu_torch.utils.tones import make_eval_streams

    params, cfg, vocab = model
    audio, _ = make_eval_streams(TONES_STREAMS, TONES_SECONDS, TONES_N,
                                 seed=TONES_SEED)
    sess = StreamSession(params, cfg, vocab, CacheConfig(
        att_right_context=13, n_mels=cfg.n_mels), n_streams=TONES_STREAMS,
        compute_dtype=dtype, **kw)
    sess.process(audio)
    sess.finalize()
    return [[list(t) for t in sess.get_tokens(s)]
            for s in range(TONES_STREAMS)]


def tdt_ctc_tones_phase(failures: list) -> dict:
    """The trained TDT and hybrid fixtures on the card against the port's
    CPU path, over the tones phase's 8 seeded streams at R = 13:
    tones_tiny_tdt.gguf greedy and K = BEAM_K with tones_tiny_lm.gguf,
    tones_tiny_hybrid.gguf with ctc=True (tokens equal to the CPU's, token
    error printed, attention launched); the server module with --ctc on the hybrid fixture (READY's "decode" is
    "ctc"; the FINAL equal to the same module with --cpu) and
    cli_transcribe --ctc (stdout equal to --cpu). The CPU references, the
    CLIs and the servers run in child processes beside the card work."""
    import threading

    import torch

    from nemotron_tpu_torch.models.lm import load_lm
    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.utils.tones import make_eval_streams

    here = os.path.dirname(os.path.abspath(__file__))
    hybrid = os.path.join(here, "weights", "tones_tiny_hybrid.gguf")
    env = dict(os.environ, PYTHONPATH=here, OMP_NUM_THREADS="2")
    audio, truths = make_eval_streams(TONES_STREAMS, TONES_SECONDS, TONES_N,
                                      seed=TONES_SEED)
    tmp = tempfile.mkdtemp()
    ref_path = os.path.join(tmp, "ref.json")
    ref_job = start_cpu_job("cpu_tdt_ctc_tones_reference", ref_path)
    paths = [os.path.join(tmp, f"{i}.pcm") for i in range(2)]
    for i, p in enumerate(paths):
        audio[i, :(8 - 2 * i) * 16000].astype("<i2").tofile(p)
    clis = {dev: subprocess.Popen(
        [sys.executable, "-m", "nemotron_tpu_torch.cli_transcribe", hybrid,
         *paths, "--ctc", *(["--cpu"] if dev == "cpu" else [])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=here) for dev in ("cuda", "cpu")}
    # host DSP on both (a device-DSP finalize pads silence PCM where the
    # host pads zero mel, so their last chunks differ by design)
    servers = {dev: start_server_module(
        [hybrid, "--slots", "2", "--ctc", "--dsp", "numpy",
         *(["--cpu"] if dev == "cpu" else [])], env, here)
        for dev in ("cuda", "cpu")}
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    lm = load_lm(os.path.join(here, "weights", "tones_tiny_lm.gguf"), "cuda")
    models = {}
    out = {}
    got = {}
    for name, gguf, kw in TDT_FIXTURE_RUNS:
        if gguf not in models:
            models[gguf] = load_model(os.path.join(here, "weights",
                                                   f"{gguf}.gguf"),
                                      device="cuda")
        got[name], n = counted(lambda: fixture_tokens(
            models[gguf], torch.float32, kw
            | ({"lm": lm} if kw.get("beam_size") else {})), launches)
        out[name] = dict(launches=n, tokens=sum(map(len, got[name])))
        if not n["attn"]:
            failures.append(f"tones {name}: no attention launch")

    events, errors = {}, []

    def replay(dev):
        try:
            events[dev] = stream_client("tcp", "127.0.0.1",
                                        server_port(servers[dev])[0],
                                        audio[2, :6 * 16000], 0.0, 1600)
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            errors.append(f"{dev}: {e!r}")

    try:
        threads = [threading.Thread(target=replay, args=(d,))
                   for d in servers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        for proc in servers.values():
            stop_process(proc)
    cli_out = {k: p.communicate(timeout=600) + (p.returncode,)
               for k, p in clis.items()}
    ref = finish_job(ref_job, ref_path)
    shutil.rmtree(tmp, ignore_errors=True)

    for name, _, _ in TDT_FIXTURE_RUNS:
        ter = token_error([[t[0] for t in s] for s in got[name]], truths)
        same = got[name] == ref[name]
        out[name].update(ter=ter, same_as_cpu=same)
        log(f"  tones {name} R=13 S={TONES_STREAMS}: token error {ter:.4f}, "
            f"tokens vs CPU {'equal' if same else 'DIFFER'} "
            f"({out[name]['tokens']} tokens), launches "
            f"{json.dumps(out[name]['launches'])}")
        if not same or not out[name]["tokens"]:
            failures.append(f"tones {name}: tokens vs CPU equal {same}")
    finals = {d: (e["ready"].get("decode"), e["final"]["text"],
                  e["final"]["tokens"]) for d, e in events.items()}
    ok = bool(not errors and finals.get("cuda") == finals.get("cpu")
              and finals["cuda"][0] == "ctc" and finals["cuda"][1])
    out["server"] = dict(decode=finals.get("cuda", (None,))[0],
                         equal_to_cpu=ok)
    log(f"  asr_server --ctc on tones_tiny_hybrid: READY decode "
        f"{out['server']['decode']!r}, FINAL "
        f"{finals.get('cuda', (None, ''))[1][:60]!r}, equal to --cpu {ok}")
    if not ok:
        failures.append(f"asr_server --ctc: {finals}, errors {errors}")
    a, b = cli_out["cuda"], cli_out["cpu"]
    ok = a[2] == b[2] == 0 and a[0] == b[0] and a[0].count("\t") == 2
    out["cli_transcribe"] = ok
    log(f"  cli_transcribe --ctc on tones_tiny_hybrid, 2 files, card vs "
        f"--cpu: stdout {'equal' if ok else 'DIFFERENT'} "
        f"({len(a[0].split())} words)")
    if not ok:
        failures.append(f"cli_transcribe --ctc: card {a[2]} {a[0][:80]!r} "
                        f"{a[1][-300:]!r}, cpu {b[2]} {b[0][:80]!r}")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# slice 16: training
# ---------------------------------------------------------------------------

def cut_layers(params, cfg, n: int):
    """The first n conformer layers of `params` (full width, reduced depth)
    and the config that says so."""
    import dataclasses

    layers = params.layers
    cut = dataclasses.replace(layers, **{
        f.name: getattr(layers, f.name)[:n]
        for f in dataclasses.fields(layers)})
    return (dataclasses.replace(params, layers=cut),
            dataclasses.replace(cfg, n_layers=n))


def train_batch(params, cfg) -> dict:
    """The fixed batch of the full-width training phase: TRAIN_BATCH
    utterances of TRAIN_SECONDS of seeded PCM through the params' own
    frontend on the host, TRAIN_LABELS seeded labels each."""
    from nemotron_tpu_torch.config import PreprocessorConfig
    from nemotron_tpu_torch.frontend.preprocessor import \
        StreamingPreprocessor
    from nemotron_tpu_torch.utils.tones import enc_frames_of_mel

    pre = StreamingPreprocessor(
        params.preprocessor.filterbank.detach().cpu().numpy(),
        params.preprocessor.window.detach().cpu().numpy(),
        n_streams=TRAIN_BATCH,
        cfg=PreprocessorConfig(n_mels=cfg.n_mels), device="cpu")
    pcm = np.stack([seeded_pcm(s, TRAIN_SECONDS) for s in range(TRAIN_BATCH)])
    mel = pre.process(pcm)
    rng = np.random.default_rng(SEED + 16)
    return {"mel": mel,
            "labels": rng.integers(0, cfg.vocab_size - 1,
                                   (TRAIN_BATCH, TRAIN_LABELS)),
            "mel_lengths": np.full(TRAIN_BATCH, enc_frames_of_mel(
                mel.shape[1])),
            "label_lengths": np.full(TRAIN_BATCH, TRAIN_LABELS)}


def loss_and_grads(params, cfg, batch, **kw):
    """loss_fn and the gradient of every leaf (zeros where the loss does
    not reach it), as (float, {path: tensor})."""
    from nemotron_tpu_torch.params import flatten
    from nemotron_tpu_torch.training import loss_fn

    import torch

    leaves = flatten(params)
    for v in leaves.values():
        v.grad = None
    loss = loss_fn(params, cfg, batch, **kw)
    loss.backward()
    return loss.item(), {k: (v.grad if v.grad is not None
                             else torch.zeros_like(v))
                         for k, v in leaves.items()}


def cpu_training_reference(gguf_path: str, out_path: str) -> None:
    """training_phase's CPU reference: the full-width GGUF dense on the CPU,
    cut to TRAIN_CUT_LAYERS layers; loss_fn and every leaf's gradient on
    the fixed batch (att_chunk TRAIN_CHUNK), then one train step at the
    constant TRAIN_LR and the loss at the updated params. Gradients to
    out_path + '.npz', the losses as JSON."""
    import torch

    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.training import (loss_fn, make_optimizer,
                                             make_train_step, trainable)

    while not os.path.exists(gguf_path):
        time.sleep(1.0)
    full, cfg, _ = load_model(gguf_path, device="cpu", keep_quantized=False)
    params, cut = cut_layers(full, cfg, TRAIN_CUT_LAYERS)
    params = trainable(params)
    del full
    batch = train_batch(params, cut)
    loss, grads = loss_and_grads(params, cut, batch, att_chunk=TRAIN_CHUNK)
    np.savez(out_path + ".npz", **{k: g.numpy() for k, g in grads.items()})
    opt, sched = make_optimizer(params, TRAIN_LR)
    step = make_train_step(cut, opt, sched, att_chunk=TRAIN_CHUNK)
    step_loss = float(step(params, batch))
    with torch.no_grad():
        after = float(loss_fn(params, cut, batch, att_chunk=TRAIN_CHUNK))
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(dict(loss=loss, step_loss=step_loss, after=after), f)


def grad_gaps(got: dict, want: dict) -> dict:
    """Per leaf: max |got - want| over the leaf's max |want| (0 where both
    are zero)."""
    out = {}
    for k, w in want.items():
        g = got[k].detach().float().cpu().numpy()
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        out[k] = err / scale if scale > 0 else err
    return out


def finite_grads(grads: dict) -> bool:
    import torch

    return all(bool(torch.isfinite(g).all()) for g in grads.values())


def training_phase(gguf_path: str, tdt_path: str, ref_job, ref_path: str,
                   failures: list) -> dict:
    """Slice 16 at full width, on dense f32 parameters (load_model(...,
    keep_quantized=False)) and the fixed batch (train_batch: TRAIN_BATCH
    utterances of TRAIN_SECONDS, TRAIN_LABELS labels each, chunked
    attention at R = 13's chunk).
    (a) a TRAIN_CUT_LAYERS-layer cut of the full-width GGUF: loss_fn and
        every leaf's gradient against the port's CPU run of the same cut
        (the child `ref_job`), within TOL_TRAIN_LOSS_REL and
        TOL_TRAIN_GRAD_REL of the leaf's max |g|; one train step at the
        constant TRAIN_LR, the loss at the updated params against the
        CPU's; no CUDA kernel of the port launches (the three counts stay
        0 through the phase's card work).
    (b) the 24 layers, on the card only: remat against no remat (loss and
        every gradient within TOL_REMAT_*); TRAIN_STEPS steps (the loss
        falls), step ms with and without remat, peak GiB, utterance-seconds
        trained a second; one step each with delay_penalty 0.01, on the
        phase-14 GGUF (TDT durations, a CTC head) with sigma 0.05, and
        with the CTC term at weight 0.3: finite losses and gradients."""
    import torch

    from nemotron_tpu_torch.params import flatten, load_model
    from nemotron_tpu_torch.training import (loss_fn, make_optimizer,
                                             make_train_step, trainable)

    from nemotron_tpu_torch.config import CacheConfig

    assert CacheConfig(att_right_context=13).chunk_enc_len == TRAIN_CHUNK
    out: dict = {}
    torch.cuda.synchronize()
    reset_counts()
    full, cfg, _ = load_model(gguf_path, device=CARD, keep_quantized=False)
    batch = train_batch(full, cfg)
    log(f"phase training: {TRAIN_BATCH} utterances of {TRAIN_SECONDS:g} s "
        f"({batch['mel'].shape[1]} mel frames, {int(batch['mel_lengths'][0])}"
        f" encoder frames), {TRAIN_LABELS} labels each, att_chunk "
        f"{TRAIN_CHUNK}, f32")

    # (a) the cut against the CPU
    cut_params, cut = cut_layers(full, cfg, TRAIN_CUT_LAYERS)
    cut_params = trainable(cut_params)
    loss, grads = loss_and_grads(cut_params, cut, batch,
                                 att_chunk=TRAIN_CHUNK)
    opt, sched = make_optimizer(cut_params, TRAIN_LR)
    step_loss = float(make_train_step(cut, opt, sched,
                                      att_chunk=TRAIN_CHUNK)(cut_params,
                                                             batch))
    with torch.no_grad():
        after = float(loss_fn(cut_params, cut, batch, att_chunk=TRAIN_CHUNK))
    del opt, sched
    ref = finish_job(ref_job, ref_path)
    want = dict(np.load(ref_path + ".npz"))
    gaps = grad_gaps(grads, want)
    worst = max(gaps, key=gaps.get)
    loss_rel = abs(loss - ref["loss"]) / abs(ref["loss"])
    after_rel = abs(after - ref["after"]) / abs(ref["after"])
    out["cut"] = dict(layers=TRAIN_CUT_LAYERS, loss=loss, cpu_loss=ref["loss"],
                      loss_rel=loss_rel, step_loss=step_loss,
                      after=after, cpu_after=ref["after"],
                      after_rel=after_rel, worst_grad=worst,
                      worst_grad_rel=gaps[worst])
    log(f"  {TRAIN_CUT_LAYERS}-layer cut vs CPU: loss {loss:.6f} (CPU "
        f"{ref['loss']:.6f}, rel {loss_rel:.2e}, tol {TOL_TRAIN_LOSS_REL:g});"
        f" worst gradient {worst} {gaps[worst]:.2e} of its max (tol "
        f"{TOL_TRAIN_GRAD_REL:g}, {len(gaps)} leaves); after one step at lr "
        f"{TRAIN_LR:g}: {after:.6f} (CPU {ref['after']:.6f}, rel "
        f"{after_rel:.2e})")
    if (not loss_rel <= TOL_TRAIN_LOSS_REL or not after_rel
            <= TOL_TRAIN_LOSS_REL or not gaps[worst] <= TOL_TRAIN_GRAD_REL
            or not after < loss or set(gaps) != set(grads)):
        failures.append(f"training cut vs CPU: loss rel {loss_rel:.2e}, "
                        f"after-step rel {after_rel:.2e}, gradient {worst} "
                        f"{gaps[worst]:.2e}, loss {loss} -> {after}")
    del cut_params, grads, want

    # (b) the 24 layers on the card
    params = trainable(full)
    del full
    torch.cuda.empty_cache()
    l0, g0 = loss_and_grads(params, cfg, batch, att_chunk=TRAIN_CHUNK)
    g0 = {k: v.clone() for k, v in g0.items()}
    l1, g1 = loss_and_grads(params, cfg, batch, att_chunk=TRAIN_CHUNK,
                            remat=True)
    remat_gap = max(float(((a - g1[k]).abs()
                           - TOL_REMAT_GRAD_REL * g1[k].abs()).max())
                    for k, a in g0.items())
    out["remat"] = dict(loss=l0, remat_loss=l1, grad_excess=remat_gap)
    log(f"  24 layers: loss {l0:.6f}, with remat {l1:.6f}; gradients "
        f"within rtol {TOL_REMAT_GRAD_REL:g} + atol {TOL_REMAT_GRAD_ABS:g} "
        f"(largest excess over rtol {remat_gap:.2e})")
    if (abs(l0 - l1) > TOL_REMAT_LOSS_REL * abs(l0)
            or remat_gap > TOL_REMAT_GRAD_ABS):
        failures.append(f"training remat: loss {l0} vs {l1}, gradient "
                        f"excess {remat_gap:.2e}")
    del g0, g1
    opt, sched = make_optimizer(params, TRAIN_LR)
    times = {}
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for remat, n in ((False, TRAIN_STEPS), (True, TRAIN_REMAT_STEPS)):
        step = make_train_step(cfg, opt, sched, remat=remat,
                               att_chunk=TRAIN_CHUNK)
        walls = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(params, batch)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        # the first no-remat step also warms the allocator and cuBLAS
        times["remat" if remat else "plain"] = walls[1:]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # where a step's time goes: one no-remat step under the profiler
    step = make_train_step(cfg, opt, sched, att_chunk=TRAIN_CHUNK)
    prof = profile_window(lambda: losses.append(float(step(params, batch))))
    out["profile"] = dict(wall_ms=prof["wall_us"] / 1e3,
                          busy_ms=prof["busy_us"] / 1e3,
                          busy_share=prof["busy_us"] / prof["wall_us"],
                          launches=sum(prof["count"].values()),
                          top=[(k, us / 1e3, prof["count"][k])
                               for k, us in prof["by_name"][:8]])
    log(f"  one step profiled: wall {prof['wall_us'] / 1e3:.2f} ms, busy "
        f"{prof['busy_us'] / 1e3:.2f} ms "
        f"({100 * out['profile']['busy_share']:.1f}%), "
        f"{out['profile']['launches']} launches")
    for kname, ms, n in out["profile"]["top"]:
        log(f"    {ms:8.3f} ms  {n:6d} launches  {kname}")
    plain_ms = float(np.mean(times["plain"]) * 1e3)
    remat_ms = float(np.mean(times["remat"]) * 1e3)
    utt_s = TRAIN_BATCH * TRAIN_SECONDS / (plain_ms / 1e3)
    out["steps"] = dict(losses=losses, step_ms=plain_ms,
                        remat_step_ms=remat_ms, peak_gib=peak,
                        utterance_s_per_s=utt_s,
                        utterance_s_per_s_remat=TRAIN_BATCH * TRAIN_SECONDS
                        / (remat_ms / 1e3))
    log(f"  {TRAIN_STEPS} steps at lr {TRAIN_LR:g} (then "
        f"{TRAIN_REMAT_STEPS} with remat, and one profiled): losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; step {plain_ms:.2f} ms, "
        f"with remat {remat_ms:.2f} ms; peak {peak:.2f} GiB; "
        f"{utt_s:.2f} utterance-seconds trained a second")
    if not (all(np.isfinite(losses))
            and losses[TRAIN_STEPS - 1] < losses[0]):
        failures.append(f"training 24 layers: losses {losses} do not fall")

    # the variants: one train step each, finite loss and gradients
    def one_step(p, c, opt, sched, **kw):
        loss = float(make_train_step(c, opt, sched, att_chunk=TRAIN_CHUNK,
                                     **kw)(p, batch))
        return loss, {k: v.grad for k, v in flatten(p).items()}

    variants = {}
    loss, grads = one_step(params, cfg, opt, sched, delay_penalty=0.01)
    variants["delay_penalty=0.01"] = (loss, finite_grads(grads))
    del params, opt, sched, grads
    torch.cuda.empty_cache()
    tdt, tcfg, _ = load_model(tdt_path, device=CARD, keep_quantized=False)
    tdt = trainable(tdt)
    opt, sched = make_optimizer(tdt, TRAIN_LR)
    for name, vkw in (("TDT sigma=0.05", dict(tdt_sigma=0.05)),
                      ("TDT + CTC weight=0.3", dict(tdt_sigma=0.05,
                                                     ctc_weight=0.3))):
        loss, grads = one_step(tdt, tcfg, opt, sched, **vkw)
        ok = finite_grads(grads)
        if "CTC" in name:       # the head takes a gradient from the term
            ok = ok and float(grads["ctc.out_w"].abs().max()) > 0
        variants[name] = (loss, ok)
    del tdt, opt, sched, grads
    torch.cuda.empty_cache()
    out["variants"] = {k: dict(loss=v[0], finite=v[1])
                       for k, v in variants.items()}
    for name, (loss, ok) in variants.items():
        log(f"  one step, {name}: loss {loss:.4f}, gradients "
            f"{'finite' if ok else 'NOT finite (or no CTC gradient)'}")
        if not (np.isfinite(loss) and ok):
            failures.append(f"training {name}: loss {loss}, gradients ok "
                            f"{ok}")
    torch.cuda.synchronize()
    counts = kernel_counts()
    out["launches"] = counts
    log(f"  kernel launches through the phase: {json.dumps(counts)} (want "
        f"none: training runs no kernel of the port)")
    if any(counts.values()):
        failures.append(f"training launched a kernel of the port: {counts}")
    return out


def start_module(module: str, args: list, env: dict, cwd: str):
    """`python -m nemotron_tpu_torch.<module> args` in a child process."""
    return subprocess.Popen(
        [sys.executable, "-m", f"nemotron_tpu_torch.{module}", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=cwd)


def finish_module(proc, name: str, failures: list,
                  timeout: float = 600) -> tuple[str, str]:
    """Wait for a start_module child; (stdout, stderr). A non-zero exit or
    a timeout is a failure."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        failures.append(f"{name}: timed out after {timeout:g} s")
        return out, err
    if proc.returncode:
        failures.append(f"{name}: exit {proc.returncode}: {err[-1500:]}")
    return out, err


def step_lines(stderr: str) -> dict:
    """{step: the line without its wall-time field}."""
    out = {}
    for line in stderr.splitlines():
        if line.startswith("step ") and "  [" in line:
            head, tail = line.split("  [", 1)
            out[int(head.split()[1])] = head + tail.split("]", 1)[1]
    return out


def training_tones_phase(failures: list) -> dict:
    """Slice 16 on the trained tones fixture and the tiny config, on the
    card:
    (c) weights/tones_tiny.gguf fine-tuned FT_STEPS steps on TonesSampler
        batches at the constant lr FT_LR with the fixture recipe's sampler
        (docs/TRAINING.md: 16 tones, 16 an utterance, 4 at the least,
        history 192, chunks 14 and 1 in turn), saved with save_model,
        loaded on the card and streamed over the tones phase's 8 streams
        at R = 13: token error < TONES_TER_MAX and the tokens equal to the
        port's CPU run of the saved file.
    (d) `python -m nemotron_tpu_torch.train --random --config tiny --task
        tones` for SCRATCH_STEPS steps: the last loss below half of step
        0's.
    (e) the entry points on the card against --cpu: train on the fixture
        (step 0's line equal to --cpu's, the val TER included), --checkpoint
        at step 2 then --resume to step 4 (the lines of the uninterrupted
        card run), its --save GGUF through `python -m nemotron_tpu_torch.cli`
        (stdout equal to --cpu's), and train_lm --steps 40 --save (its NLL
        falls; the saved LM, read with load_lm, scores held-out grammar
        sequences below the untrained LM)."""
    import concurrent.futures

    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.frontend.preprocessor import mel_filterbank_slaney
    from nemotron_tpu_torch.models import lm as lm_mod
    from nemotron_tpu_torch.params import load_model, save_model
    from nemotron_tpu_torch.training import (make_optimizer, make_train_step,
                                             trainable)
    from nemotron_tpu_torch.utils.tones import (TonesSampler,
                                                grammar_transitions,
                                                make_eval_streams,
                                                markov_labels)

    here = os.path.dirname(os.path.abspath(__file__))
    fixture = os.path.join(here, "weights", "tones_tiny.gguf")
    env = dict(os.environ, PYTHONPATH=here, OMP_NUM_THREADS="2")
    tmp = tempfile.mkdtemp()
    out: dict = {}

    # the entry points start first and run beside the fine-tune
    ck, out_a, lm_path = (os.path.join(tmp, n)
                          for n in ("ck.pt", "a.gguf", "lm.gguf"))
    base = ["--task", "tones", "--eval-every", "1", "--val", str(ENTRY_VAL),
            "--batch", "4", "--history-max", "0"]
    jobs = {
        "train A": start_module("train", [fixture, *base, "--steps", "4",
                                          "--save", out_a], env, here),
        "train B": start_module("train", [fixture, *base, "--steps", "2",
                                          "--checkpoint", ck], env, here),
        "train --cpu": start_module("train", [fixture, *base, "--steps",
                                              "1", "--cpu"], env, here),
        "scratch": start_module("train", [
            "--random", "--config", "tiny", "--task", "tones", "--steps",
            str(SCRATCH_STEPS), "--eval-every", str(SCRATCH_STEPS - 1),
            *SCRATCH_FLAGS], env, here),
        "train_lm": start_module("train_lm", ["--steps", "40", "--save",
                                              lm_path], env, here),
    }

    # (c) the fine-tune, in this process
    params, cfg, vocab = load_model(fixture, device=CARD,
                                    keep_quantized=False)
    params = trainable(params)
    fb = mel_filterbank_slaney(cfg.n_mels).astype(np.float32)
    win = np.hanning(400).astype(np.float32)
    samplers = [TonesSampler(fb, win, cfg.n_mels, 16, 16, FT_BATCH,
                             seed=SEED + 1, tones_per_utt_min=4,
                             history_max=192, device="cpu")
                for _ in range(2)]
    opt, sched = make_optimizer(params, FT_LR)
    chunks = (14, 1)
    steps = {c: make_train_step(cfg, opt, sched, att_chunk=c)
             for c in chunks}
    losses = []
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        pending = {i: pool.submit(samplers[i % 2].sample, i)
                   for i in range(2)}
        t0 = time.perf_counter()
        for i in range(FT_STEPS):
            b = pending.pop(i).result()
            if i + 2 < FT_STEPS:
                pending[i + 2] = pool.submit(samplers[i % 2].sample, i + 2)
            losses.append(steps[chunks[i % 2]](params, b))
        losses = [float(x) for x in losses]
        ft_s = time.perf_counter() - t0
    saved = os.path.join(tmp, "finetuned.gguf")
    save_model(saved, params, cfg, vocab=vocab)
    del params, opt, sched, steps
    audio, truths = make_eval_streams(TONES_STREAMS, TONES_SECONDS, TONES_N,
                                      seed=TONES_SEED)
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    tokens = {}
    for name, dev in (("card", CARD), ("cpu", "cpu")):
        p, c, v = load_model(saved, device=dev)
        sess = run_session(p, c, v, cc, audio, torch.float32)
        tokens[name] = [[t for t, _ in sess.get_tokens(s)]
                        for s in range(TONES_STREAMS)]
    ter = token_error(tokens["card"], truths)
    same = tokens["card"] == tokens["cpu"]
    out["finetune"] = dict(steps=FT_STEPS, batch=FT_BATCH, lr=FT_LR,
                           first_loss=losses[0], last_loss=losses[-1],
                           wall_s=ft_s, ter=ter, same_as_cpu=same)
    log(f"  fine-tune of {os.path.basename(fixture)}: {FT_STEPS} steps of "
        f"{FT_BATCH} fresh utterances at lr {FT_LR:g} in {ft_s:.1f} s "
        f"(losses {losses[0]:.4f} .. {losses[-1]:.4f}); saved, loaded on "
        f"the card, {TONES_STREAMS} streams at R = 13: token error "
        f"{ter:.4f}, tokens vs CPU {'equal' if same else 'DIFFER'}")
    if not (ter < TONES_TER_MAX and same and all(np.isfinite(losses))):
        failures.append(f"training fine-tune: token error {ter:.4f}, tokens "
                        f"vs CPU equal {same}, losses {losses}")

    # (e) resume from B's checkpoint; the CLI on A's saved GGUF
    _, err_b = finish_module(jobs.pop("train B"), "train B", failures)
    jobs["train C"] = start_module("train", [fixture, *base, "--steps", "4",
                                             "--resume", ck], env, here)
    _, err_a = finish_module(jobs.pop("train A"), "train A", failures)
    pcm = os.path.join(tmp, "a.pcm")
    audio[0, :8 * 16000].astype("<i2").tofile(pcm)
    cli_args = [out_a, pcm, "80", "13"]
    jobs["cli"] = start_module("cli", cli_args, env, here)
    jobs["cli --cpu"] = start_module("cli", cli_args + ["--cpu"], env, here)
    res = {name: finish_module(proc, name, failures)
           for name, proc in jobs.items()}

    a, b_, c_ = (step_lines(e) for e in (err_a, err_b, res["train C"][1]))
    cpu0 = step_lines(res["train --cpu"][1]).get(0)
    resumed = {**b_, **c_}
    out["entry"] = dict(card_step0=a.get(0), cpu_step0=cpu0,
                        uninterrupted=a, resumed=resumed,
                        cli_same=res["cli"][0] == res["cli --cpu"][0])
    log(f"  train (card): {a.get(0)!r}; --cpu: {cpu0!r}")
    log(f"  --checkpoint at 2 and --resume to 4: "
        f"{'equal to' if resumed == a else 'DIFFER from'} the uninterrupted "
        f"run's lines ({len(a)} lines)")
    log(f"  cli on the saved GGUF (card vs --cpu): "
        f"{'equal' if out['entry']['cli_same'] else 'DIFFER'} "
        f"({len(res['cli'][0].split())} words)")
    if a.get(0) is None or a.get(0) != cpu0:
        failures.append(f"train entry step 0: card {a.get(0)!r} vs CPU "
                        f"{cpu0!r}")
    if resumed != a or len(a) != 4:
        failures.append(f"train --resume: {resumed} vs {a}")
    if not out["entry"]["cli_same"] or not res["cli"][0].strip():
        failures.append("cli on the trained GGUF: card vs --cpu differ or "
                        "empty")

    # (d) from scratch
    lines = step_lines(res["scratch"][1])
    first, last = (float(lines[i].split()[3]) if i in lines else None
                   for i in (0, SCRATCH_STEPS - 1))
    out["scratch"] = dict(steps=SCRATCH_STEPS, first_loss=first,
                          last_loss=last, flags=SCRATCH_FLAGS, lines=lines)
    log(f"  from scratch, tiny, {SCRATCH_STEPS} steps "
        f"({' '.join(SCRATCH_FLAGS)}): loss {first} -> {last}; "
        f"{list(lines.values())}")
    if first is None or last is None or not last < 0.5 * first:
        failures.append(f"training from scratch: loss {first} -> {last}")

    # train_lm: the NLL falls, and the saved LM beats the untrained one
    nll = {int(f[1].rstrip(":")): float(f[3]) for f in (
        line.split() for line in res["train_lm"][1].splitlines())
        if len(f) == 4 and f[0] == "step" and f[2] == "nll"}
    _, lcfg, _ = load_model(fixture, device="cpu", keep_quantized=False)
    trans = grammar_transitions(16, 3, 17)
    rng = np.random.default_rng(SEED + 999)
    labels = torch.tensor(np.stack([markov_labels(rng, 64, trans)
                                    for _ in range(16)]), device=CARD)
    lengths = torch.full((16,), 64, device=CARD)
    held = {}
    for name, lm in (("trained", lm_mod.load_lm(lm_path, device=CARD)),
                     ("untrained", lm_mod.lm_params_from_arrays(
                         lm_mod.random_lm_arrays(lcfg.vocab_size, hidden=48,
                                                 seed=0, scale=0.08),
                         device=CARD))):
        with torch.no_grad():
            held[name] = float(lm_mod.lm_sequence_nll(
                lm, labels, lengths, lcfg.blank_token))
    out["train_lm"] = dict(nll=nll, heldout=held)
    log(f"  train_lm --steps 40: nll {nll.get(0)} -> {nll.get(39)}; the "
        f"saved LM on held-out grammar sequences {held['trained']:.4f} "
        f"(untrained {held['untrained']:.4f})")
    if not (nll.get(39, np.inf) < nll.get(0, -np.inf)
            and held["trained"] < held["untrained"]):
        failures.append(f"train_lm: nll {nll}, held-out {held}")
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# slice 17: multi-GPU (a mesh of torch.distributed ranks)
# ---------------------------------------------------------------------------

# (a) a one-rank NCCL mesh against the unsharded engines: MG_SLOTS slots
# (streams), one quantum (R = 13: 1.12 s) of seeded PCM a slot a tick,
# MG_TICKS ticks; the ServingEngine in turns (unsharded, mesh, mesh,
# unsharded) for its tick times
MG_SLOTS, MG_TICKS = 64, 3
# (b) two ranks sharing the card over gloo at model-parallel 2: the Q8_0
# f32 engine (host DSP) and the W8A8 bf16 engine (device DSP) on (a)'s
# schedule; encode_chunk over MG_ENC_CHUNKS chunks of MG_ENC_STREAMS
# streams of seeded mel (the Q8_0 and the W8A8 weights, f32), held within
# MG_CONTROL_FACTOR times the gap of a control (the one-rank encoder
# against itself with its mel moved by two f32 ulps; for the W8A8
# weights, the larger gap of a move up and down); the W8A8 engine's
# tokens held as the W8A8 path holds them (TOL_W8A8_TOKEN_AGREE); layer
# 0's first W8A8 FFN on MG_PROBE_ROWS seeded f32 rows within
# TOL_MG_PROBE_REL of the one-rank product's largest value (the partial
# sums meet in another order; a w2 split with the local K's own
# activation groups misses it ~1e3-fold: PROBE_REL in
# tests/test_torch_mesh.py)
MG_ENC_STREAMS, MG_ENC_CHUNKS, MG_CONTROL_FACTOR = 4, 3, 4.0
MG_PROBE_ROWS, TOL_MG_PROBE_REL = 896, 1e-5
# (c) two ranks, data-parallel 2: MultihostLockstep and MultihostServing,
# MG_DP_ROWS rows a rank
MG_DP_ROWS = 32
# (d) a model-parallel-2 train step on the TRAIN_CUT_LAYERS-layer cut
# against one rank: loss within TOL_MG_LOSS_REL (relative), every
# gradient within TOL_MG_GRAD_REL of its leaf's largest |g| (the CPU
# tests' training tolerances, tests/test_torch_mesh_training.py)
TOL_MG_LOSS_REL, TOL_MG_GRAD_REL = 1e-6, 1e-5
# (e) the entry points' audio
MG_ENTRY_SECONDS = 2.5


def mg_pcm(row: int, n: int) -> np.ndarray:
    """n samples of stream `row`'s seeded PCM."""
    return seeded_pcm(1700 + row, (n + 1) / 16000)[:n]


def mg_token_lists(eng, slots) -> dict:
    return {str(s): [[int(v) for v in t] for t in eng.tokens[s]]
            for s in slots}


def mg_serving_run(eng, ticks: int, row0: int = 0):
    """Every free slot admitted (a multi-process engine's own), one quantum
    of its seeded PCM (stream row0 + slot) a tick: (tick seconds, tokens by
    slot)."""
    import torch

    q = eng.cc.shift_samples
    slots = eng.add_streams(getattr(eng, "n_local", eng.n_slots))
    audio = {s: mg_pcm(row0 + s, q * ticks) for s in slots}
    times = []
    for t in range(ticks):
        eng.feed_audio({s: audio[s][t * q:(t + 1) * q] for s in slots})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, mg_token_lists(eng, slots)


def mg_lockstep_run(eng, ticks: int, rows, make=None, snap=None):
    """One quantum of each row's seeded PCM a tick; with `make` and
    `snap`, the engine is saved halfway and a fresh one from make() loads
    it and goes on. Returns (tick seconds, tokens by local index, the
    engine)."""
    import torch

    q = eng.cc.shift_samples
    audio = np.stack([mg_pcm(r, q * ticks) for r in rows])
    times = []
    for t in range(ticks):
        if make is not None and t == ticks // 2:
            eng.save(snap)
            eng = make()
            eng.load(snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.tick(audio[:, t * q:(t + 1) * q])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, mg_token_lists(eng, range(len(rows))), eng


def mg_state(eng) -> dict:
    """Every device state leaf of an engine over every row and head (the
    mesh gathers them), as numpy."""
    from nemotron_tpu_torch.parallel import mesh as mesh_mod
    from nemotron_tpu_torch.streaming.serving import ServingEngine
    from nemotron_tpu_torch.utils import npz

    out = {}
    for side in ("enc", "dec"):
        st = getattr(eng, f"{side}_state")
        if eng.mesh is not None and not hasattr(eng, "local_rows"):
            st = mesh_mod.gather_state(st, eng.mesh, eng._heads_split()
                                       if side == "enc" else False)
        for k, v in vars(st).items():
            out[f"{side}/{k}"] = npz.to_numpy(v)
    if isinstance(eng, ServingEngine):
        for k in ("front_res", "front_last", "mel_buf_dev"):
            if getattr(eng, k, None) is not None:
                out[k] = eng._whole(getattr(eng, k))
    else:
        for k, v in (("front_last", eng.front.last_sample),
                     ("front_res", eng.front.residue),
                     ("mel_buf", eng.mel_buf)):
            out[k] = eng._fetch_block(v, 0)
    return out


def mg_equal_states(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes()
        for k in a)


def mg_encode(params, cfg, cc, nudge_ulps: int = 0) -> dict:
    """encode_chunk over MG_ENC_CHUNKS chunks of MG_ENC_STREAMS streams of
    seeded mel (f32), with the rank's heads under a mesh; the outputs and
    the K/V rings (gathered over the model axis)."""
    import torch

    from nemotron_tpu_torch.models import encoder as enc_mod
    from nemotron_tpu_torch.parallel.collectives import gather_along

    rng = np.random.default_rng(SEED + 17)
    mels = rng.standard_normal((MG_ENC_CHUNKS, MG_ENC_STREAMS,
                                cc.chunk_mel_frames, cfg.n_mels)).astype(
        np.float32)
    if nudge_ulps:
        mels = (mels * np.float32(1 + nudge_ulps * 2.0 ** -23)).astype(
            np.float32)
    dev = params.device
    st = enc_mod.init_encoder_state(cfg, cc, MG_ENC_STREAMS, torch.float32,
                                    dev, n_heads=enc_mod.local_heads(params,
                                                                     cfg))
    ph = enc_mod.precompute_pos_heads(params, cfg, cc)
    outs = []
    with torch.no_grad():
        for m in mels:
            o, st = enc_mod.encode_chunk(params, cfg, cc,
                                         torch.from_numpy(m).to(dev), st, ph)
            outs.append(o)
    rings = {"k_cache": st.k_cache, "v_cache": st.v_cache}
    tp = params.tp
    if tp is not None and tp.attn:
        rings = {k: gather_along(v, 2, tp.group, tp.size, tp.index)
                 for k, v in rings.items()}
    return {"out": torch.stack(outs).cpu().numpy(),
            **{k: v.cpu().numpy() for k, v in rings.items()}}


def mg_ffn_probe(params, cfg) -> np.ndarray:
    """Layer 0's first FFN (a rank's share summed over the model axis
    where the pair is split) on MG_PROBE_ROWS seeded f32 rows."""
    import torch

    from nemotron_tpu_torch.models.encoder import _group
    from nemotron_tpu_torch.ops.basic import ffn

    lp = params.layers.unstack(cfg.n_layers)[0]
    x = np.random.default_rng(SEED + 18).standard_normal(
        (MG_PROBE_ROWS, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        y = ffn(torch.from_numpy(x).to(params.device), lp.ffn1_w1,
                lp.ffn1_w2, _group(params.tp, "ffn1"))
    return y.cpu().numpy()


def mg_train_step(params, cfg, mesh=None):
    """One train step of `params` (whole, or a rank's share under `mesh`)
    on the training phase's batch: (loss, norm, {leaf: whole gradient})."""
    from nemotron_tpu_torch import training
    from nemotron_tpu_torch.parallel.mesh import gather_param
    from nemotron_tpu_torch.params import flatten

    batch = train_batch(params, cfg)
    opt, sched = training.make_optimizer(params, TRAIN_LR, 10)
    step = training.make_train_step(cfg, opt, sched, att_chunk=TRAIN_CHUNK,
                                    mesh=mesh)
    loss = float(step(params, batch))
    grads = {k: gather_param(v.grad, k, params.tp).cpu().numpy()
             for k, v in flatten(params).items()}
    return loss, float(step.grad_norm), grads


def mesh_rank_job(addr: str, rank: int, world: int, gguf_path: str,
                  w8_path: str, dense_path: str, out_dir: str) -> None:
    """One of the two ranks of the multi-GPU phase, sharing the card over
    gloo (the kernels are built already; the rank only loads them): (b)
    model-parallel 2 -- the Q8_0 f32 and W8A8 bf16 engines on (a)'s
    schedule, the all_reduce calls and bytes of their ticks, a profile of
    a Q8_0 tick, encode_chunk's outputs and rings (Q8_0 and W8A8), the
    W8A8 FFN probe; (c) data-parallel 2 --
    MultihostLockstep (straight, and saved / loaded halfway) and
    MultihostServing, MG_DP_ROWS rows a rank; (d) a model-parallel-2 train
    step on the 2-layer cut. Writes JSON (and rank 0 the arrays) to
    out_dir."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from nemotron_tpu_torch import training
    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.device import resolve_device
    from nemotron_tpu_torch.parallel import multihost as mh
    from nemotron_tpu_torch.parallel.mesh import (init_world, make_mesh,
                                                  shard_params)
    from nemotron_tpu_torch.params import load_model, to_device
    from nemotron_tpu_torch.streaming.serving import ServingEngine

    t0 = time.perf_counter()
    dev = resolve_device("cuda:0")
    init_world(f"tcp://{addr}", world, rank, "gloo")
    res = {"rank": rank, "walls": {}}
    bf16, f32 = torch.bfloat16, torch.float32

    # (b) model-parallel 2
    mesh = make_mesh(model_parallel=2, device=dev)
    q8, cfg, vocab = load_model(gguf_path, device=dev)
    cc13 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    eng = ServingEngine(q8, cfg, vocab, cc13, n_slots=MG_SLOTS,
                        compute_dtype=f32, dsp="numpy", mesh=mesh)
    lp = eng.params.layers
    res["split"] = [eng.params.tp.ffn1, eng.params.tp.ffn2,
                    eng.params.tp.attn]
    res["local_shapes"] = {f: list(getattr(lp, f).q.shape[1:]) for f in (
        "ffn1_w1", "ffn1_w2", "attn_q_w", "attn_pos_w", "attn_out_w",
        "conv_pw1_w")}
    res["local_heads"] = eng.params.tp.n_heads
    calls = {"n": 0, "bytes": 0}
    all_reduce = dist.all_reduce

    def counting(t, *a, **kw):
        calls["n"] += 1
        calls["bytes"] += t.numel() * t.element_size()
        return all_reduce(t, *a, **kw)

    dist.all_reduce = counting
    reset_counts()
    res["q8_times"], res["q8_tokens"] = mg_serving_run(eng, MG_TICKS)
    dist.all_reduce = all_reduce
    res["q8_counts"] = kernel_counts()
    res["q8_collectives"] = dict(calls)
    # a profiled tick of both ranks (rank 0 reads its profile)
    q = cc13.shift_samples
    slots = list(range(MG_SLOTS))
    eng.feed_audio({s: mg_pcm(s, q * (MG_TICKS + 1))[MG_TICKS * q:]
                    for s in slots})
    if rank == 0:
        prof = profile_window(eng.step)
        res["profile"] = dict(
            busy_us=prof["busy_us"], wall_us=prof["wall_us"],
            attn=launches_of(prof, "ring_attn_cluster_kernel"),
            q8=launches_of(prof, "q8_matmul"),
            top=prof["by_name"][:6])
    else:
        eng.step()
    del eng
    enc = mg_encode(shard_params(q8, mesh), cfg, cc13)
    w8 = to_device(torch.load(w8_path, weights_only=False), dev)
    cc8 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels,
                      kv_cache_int8=True)
    eng = ServingEngine(w8, cfg, vocab, cc8, n_slots=MG_SLOTS,
                        compute_dtype=bf16, dsp="device", mesh=mesh)
    res["w8_split"] = (None if eng.params.tp is None else
                       [eng.params.tp.ffn1, eng.params.tp.ffn2,
                        eng.params.tp.attn])
    reset_counts()
    res["w8_times"], res["w8_tokens"] = mg_serving_run(eng, MG_TICKS)
    res["w8_counts"] = kernel_counts()
    del eng
    w8_local = shard_params(w8, mesh)
    enc_w8 = mg_encode(w8_local, cfg, cc13)
    probe = mg_ffn_probe(w8_local, cfg)
    del w8_local, w8

    res["walls"]["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (c) data-parallel 2
    dp = make_mesh(model_parallel=1, device=dev)
    rows = list(range(rank * MG_DP_ROWS, (rank + 1) * MG_DP_ROWS))

    def lock():
        return mh.MultihostLockstep(q8, cfg, vocab, cc13,
                                    n_streams=2 * MG_DP_ROWS,
                                    compute_dtype=f32, mesh=dp)

    eng = lock()
    assert [int(r) for r in eng.local_rows] == rows
    _, res["lock_tokens"], eng = mg_lockstep_run(eng, MG_TICKS, rows)
    lock_state = mg_state(eng)
    _, res["lock_resumed_tokens"], eng = mg_lockstep_run(
        lock(), MG_TICKS, rows, make=lock,
        snap=os.path.join(out_dir, "lock_snap.npz"))
    res["lock_resumed_equal"] = mg_equal_states(mg_state(eng), lock_state)
    del eng
    eng = mh.MultihostServing(q8, cfg, vocab, cc13, n_slots=2 * MG_DP_ROWS,
                              compute_dtype=f32, mesh=dp)
    _, res["mh_serving_tokens"] = mg_serving_run(eng, MG_TICKS)
    del eng, q8

    res["walls"]["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (d) a model-parallel-2 train step on the 2-layer cut
    dense = to_device(torch.load(dense_path, weights_only=False), dev)
    cut_cfg = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    params = training.trainable(shard_params(dense, mesh))
    res["train_loss"], res["train_norm"], grads = mg_train_step(
        params, cut_cfg, mesh)
    res["walls"]["d"] = time.perf_counter() - t0

    with open(os.path.join(out_dir, f"rank{rank}.json"), "w",
              encoding="utf-8") as f:
        json.dump(res, f)
    np.savez(os.path.join(out_dir, f"lock_state{rank}.npz"), **lock_state)
    if rank == 0:
        np.savez(os.path.join(out_dir, "enc.npz"), **enc)
        np.savez(os.path.join(out_dir, "enc_w8.npz"), **enc_w8,
                 probe=probe)
        np.savez(os.path.join(out_dir, "grads.npz"), **grads)
    dist.destroy_process_group()


def start_rank_jobs(gguf_path, w8_path, dense_path, out_dir) -> list:
    """The two ranks of mesh_rank_job, started together."""
    addr = f"127.0.0.1:{free_port()}"
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for r in range(2):
        code = (f"import sys; sys.path.insert(0, {here!r}); import torch; "
                f"torch.set_num_threads(2); import chip_smoke; "
                f"chip_smoke.mesh_rank_job({addr!r}, {r}, 2, {gguf_path!r}, "
                f"{w8_path!r}, {dense_path!r}, {out_dir!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=here,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def p50(xs) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, 50))


def multi_gpu_phase(gguf_path: str, failures: list) -> dict:
    """Slice 17 at full width (24 layers, d_model 1024, the seeded GGUF).
    The card is one H100, so nothing here is a multi-GPU speed: (a) a
    one-rank NCCL mesh, and (b)-(d) two ranks sharing the card over gloo,
    show that the sharded code is correct.
    (a) ServingEngine(mesh=) (64 slots, W8A8 + int8 K/V bf16, device DSP,
        R = 13; in turns with the unsharded engine) and LockstepEngine
        (mesh=) (64 streams), and the Q8_0 f32 engine (host DSP): tokens
        and every state leaf bit-equal to the unsharded engine's, launches
        a tick by kernel equal (one attention and ten matmuls a layer an
        encoder step); the tick p50 beside the unsharded engine's.
    (b) model-parallel 2 over two ranks: the Q8_0 f32 engine's tokens
        equal to (a)'s, encode_chunk's output and rings within
        MG_CONTROL_FACTOR times a control's gap; the W8A8 bf16 engine
        (its FFNs split, the attention whole) decoding as many tokens a
        slot as (a)'s, its position agreement at least
        TOL_W8A8_TOKEN_AGREE; the W8A8 weights' encode_chunk (f32) within
        MG_CONTROL_FACTOR times their control's gap, and layer 0's FFN
        within TOL_MG_PROBE_REL of the one-rank product;
        a profiled tick (24 attention and 240 Q8 launches at the rank's
        local shapes), the all_reduce calls and bytes of a tick, and the
        tick p50 (two ranks sharing one card).
    (c) data-parallel 2: MultihostLockstep and MultihostServing, 32 rows a
        rank, tokens and state bit-equal to a one-process engine of the
        same rows; a per-rank save / load halfway equal to the straight
        run.
    (d) a model-parallel-2 train step on the 2-layer cut against one rank.
    (e) `serve --mesh 1` and `--mesh 2`, `serve --lockstep --coordinator`
        (two processes) and `train --model-parallel 2`: exit 0 with their
        summaries.
    (a)'s timed turns run first, on an idle card; then the ranks and the
    entry points start, and the rest of (a) and the references of (b)-(d)
    run beside them (their times are not readings)."""
    import shutil as _shutil

    import torch
    import torch.distributed as dist

    from nemotron_tpu_torch import training
    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.parallel.mesh import make_mesh
    from nemotron_tpu_torch.params import to_device
    from nemotron_tpu_torch.streaming.lockstep import LockstepEngine
    from nemotron_tpu_torch.streaming.serving import ServingEngine

    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    q8, cfg, vocab = full_width_model(gguf_path, "cuda")
    t0 = time.perf_counter()
    w8 = full_width_w8a8(gguf_path)
    log(f"phase multi-GPU: full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}); W8A8 weights {time.perf_counter() - t0:.1f} s")

    # (a) a one-rank NCCL mesh against the unsharded engines
    mesh1 = make_mesh(device="cuda:0")
    cc13 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    cc8 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels,
                      kv_cache_int8=True)
    runs = {"unsharded": [], "mesh": []}
    for kind in ("unsharded", "mesh", "mesh", "unsharded"):
        eng = ServingEngine(w8, cfg, vocab, cc8, n_slots=MG_SLOTS,
                            compute_dtype=bf16, dsp="device",
                            mesh=mesh1 if kind == "mesh" else None)
        (times, toks), n = counted(lambda: mg_serving_run(eng, MG_TICKS),
                                   launches)
        runs[kind].append(dict(times=times, tokens=toks, counts=n,
                               state=mg_state(eng)))
        del eng
    u, m = runs["unsharded"][0], runs["mesh"][0]
    same = (u["tokens"] == m["tokens"] and mg_equal_states(u["state"],
                                                           m["state"])
            and all(r["tokens"] == u["tokens"] for r in runs["unsharded"]
                    + runs["mesh"]))
    steps = m["counts"]["attn"] // cfg.n_layers
    counts_ok = (u["counts"] == m["counts"] and steps > 0
                 and m["counts"]["attn"] == cfg.n_layers * steps
                 and m["counts"]["w8a8"] == 10 * cfg.n_layers * steps
                 and m["counts"]["q8"] == 0)
    if not (same and counts_ok):
        failures.append(f"multi-GPU (a) W8A8 engine on a one-rank mesh: "
                        f"tokens and state equal {same}, launches "
                        f"{m['counts']} vs {u['counts']}")
    eng_p50 = {k: p50([t for r in v for t in r["times"][1:]])
               for k, v in runs.items()}
    out["a_engine"] = dict(equal=same, counts=m["counts"], steps=steps,
                           tick_p50_ms=eng_p50)
    log(f"  (a) ServingEngine W8A8 + int8 K/V bf16 device DSP, {MG_SLOTS} "
        f"slots, R=13, one-rank {mesh1.backend} mesh vs unsharded, in turns: "
        f"tokens and every state leaf bit-equal {same}; launches "
        f"{m['counts']} in {steps} encoder steps ({cfg.n_layers} attention, "
        f"{10 * cfg.n_layers} W8A8 a step); tick p50 (ticks 2-{MG_TICKS}) "
        f"mesh {eng_p50['mesh']:.2f} / unsharded {eng_p50['unsharded']:.2f}"
        f" ms")
    log(f"  (a) timed turns: wall {time.perf_counter() - t0:.1f} s")

    # the ranks' inputs: the W8A8 weights and the dense 2-layer cut (the
    # Q8_0 weights dequantized in f32), as files
    tmp = tempfile.mkdtemp(prefix="mg_")
    w8_path = os.path.join(tmp, "w8.pt")
    torch.save(to_device(w8, "cpu"), w8_path)
    cut, cut_cfg = cut_layers(q8, cfg, TRAIN_CUT_LAYERS)
    dense = dense_of(cut)
    dense_path = os.path.join(tmp, "dense_cut.pt")
    torch.save(to_device(dense, "cpu"), dense_path)
    pcm_path = os.path.join(tmp, "entry.pcm")
    mg_pcm(0, int(MG_ENTRY_SECONDS * 16000)).tofile(pcm_path)

    # (b)-(d) on two ranks, and (e), beside the parent's references
    t_start = time.perf_counter()
    ranks = start_rank_jobs(gguf_path, w8_path, dense_path, tmp)
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    serve_args = [gguf_path, pcm_path, "--streams", "4", "--slots", "4",
                  "--seconds", str(MG_ENTRY_SECONDS)]
    coord = f"127.0.0.1:{free_port()}"
    entries = {
        "serve --mesh 1": [start_module("serve", serve_args + ["--mesh", "1"],
                                        env, here)],
        "serve --mesh 2": [start_module("serve", serve_args + ["--mesh", "2"],
                                        env, here)],
        "serve --coordinator": [start_module(
            "serve", serve_args + ["--lockstep", "--coordinator", coord,
                                   "--num-processes", "2", "--process-id",
                                   str(i)], env, here) for i in (0, 1)],
        "train --model-parallel 2": [start_module(
            "train", ["--random", "--config", "tiny", "--steps", "3",
                      "--batch", "4", "--eval-every", "1",
                      "--model-parallel", "2"], env, here)],
    }
    try:
        lock = {}
        for kind in ("unsharded", "mesh"):
            eng = LockstepEngine(w8, cfg, vocab, cc8, n_streams=MG_SLOTS,
                                 compute_dtype=bf16,
                                 mesh=mesh1 if kind == "mesh" else None)
            (times, toks, eng), n = counted(
                lambda: mg_lockstep_run(eng, MG_TICKS, range(MG_SLOTS)),
                launches)
            lock[kind] = dict(times=times, tokens=toks, counts=n,
                              state=mg_state(eng))
            del eng
        same = (lock["mesh"]["tokens"] == lock["unsharded"]["tokens"]
                and mg_equal_states(lock["mesh"]["state"],
                                    lock["unsharded"]["state"])
                and lock["mesh"]["counts"] == lock["unsharded"]["counts"]
                and lock["mesh"]["counts"]["attn"] > 0)
        if not same:
            failures.append("multi-GPU (a) LockstepEngine on a one-rank mesh: "
                            "tokens, state or launches differ")
        out["a_lockstep"] = dict(equal=same, counts=lock["mesh"]["counts"],
                                 tick_p50_ms={k: p50(v["times"][1:])
                                              for k, v in lock.items()})
        log(f"  (a) LockstepEngine, {MG_SLOTS} streams, one-rank mesh vs "
            f"unsharded: tokens, state and launches equal {same} "
            f"({lock['mesh']['counts']}); tick p50 beside the ranks: mesh "
            f"{out['a_lockstep']['tick_p50_ms']['mesh']:.2f} / unsharded "
            f"{out['a_lockstep']['tick_p50_ms']['unsharded']:.2f} ms")
        del lock, runs
        # the Q8_0 f32 engine, unsharded and on the one-rank mesh: (b)'s
        # reference
        q8runs = {}
        for kind in ("unsharded", "mesh"):
            eng = ServingEngine(q8, cfg, vocab, cc13, n_slots=MG_SLOTS,
                                compute_dtype=f32, dsp="numpy",
                                mesh=mesh1 if kind == "mesh" else None)
            (times, toks), n = counted(lambda: mg_serving_run(eng, MG_TICKS),
                                       launches)
            q8runs[kind] = dict(times=times, tokens=toks, counts=n,
                                state=mg_state(eng))
            del eng
        same = (q8runs["mesh"]["tokens"] == q8runs["unsharded"]["tokens"]
                and mg_equal_states(q8runs["mesh"]["state"],
                                    q8runs["unsharded"]["state"])
                and q8runs["mesh"]["counts"] == q8runs["unsharded"]["counts"])
        if not same:
            failures.append("multi-GPU (a) Q8_0 f32 engine on a one-rank mesh: "
                            "tokens, state or launches differ")
        out["a_q8"] = dict(equal=same, counts=q8runs["mesh"]["counts"],
                           tick_p50_ms={k: p50(v["times"][1:])
                                        for k, v in q8runs.items()})
        log(f"  (a) ServingEngine Q8_0 f32 host DSP, {MG_SLOTS} slots: one-rank "
            f"mesh vs unsharded equal {same} ({q8runs['mesh']['counts']}); tick "
            f"p50 mesh {out['a_q8']['tick_p50_ms']['mesh']:.2f} / unsharded "
            f"{out['a_q8']['tick_p50_ms']['unsharded']:.2f} ms")
        dist.destroy_process_group()
        enc_ref = mg_encode(q8, cfg, cc13)
        enc_ctl = mg_encode(q8, cfg, cc13, nudge_ulps=2)
        w8_ref = mg_encode(w8, cfg, cc13)
        w8_ctl = [mg_encode(w8, cfg, cc13, nudge_ulps=n) for n in (2, -2)]
        probe_ref = mg_ffn_probe(w8, cfg)
        del w8
        halves = []
        for h in range(2):
            rows = list(range(h * MG_DP_ROWS, (h + 1) * MG_DP_ROWS))
            eng = LockstepEngine(q8, cfg, vocab, cc13, n_streams=MG_DP_ROWS,
                                 compute_dtype=f32)
            _, ltoks, eng = mg_lockstep_run(eng, MG_TICKS, rows)
            lstate = mg_state(eng)
            del eng
            eng = ServingEngine(q8, cfg, vocab, cc13, n_slots=MG_DP_ROWS,
                                compute_dtype=f32, dsp="numpy")
            _, stoks = mg_serving_run(eng, MG_TICKS, row0=h * MG_DP_ROWS)
            del eng
            halves.append(dict(lock=ltoks, lock_state=lstate, serving={
                str(int(s) + h * MG_DP_ROWS): v for s, v in stoks.items()}))
        ref_params = training.trainable(to_device(dense, "cuda"))
        ref_loss, ref_norm, ref_grads = mg_train_step(ref_params, cut_cfg)
        del ref_params
        results = []
        for r, p in enumerate(ranks):
            try:
                _, err = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            if p.returncode:
                failures.append(f"multi-GPU rank {r}: exit {p.returncode}: "
                                f"{err[-2000:]}")
        rank_wall = time.perf_counter() - t_start
        entry_out = {name: [finish_module(p, f"multi-GPU (e) {name}",
                                          failures, timeout=600)
                            for p in procs]
                     for name, procs in entries.items()}
    finally:
        for p in ranks + [p for v in entries.values() for p in v]:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in ranks):
        _shutil.rmtree(tmp, ignore_errors=True)
        return out
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json"), encoding="utf-8") as f:
            results.append(json.load(f))
    r0 = results[0]

    # (b) model-parallel 2
    want = q8runs["unsharded"]["tokens"]
    q8_equal = all(r["q8_tokens"] == want for r in results)
    enc = dict(np.load(os.path.join(tmp, "enc.npz")))
    gap = {k: float(np.abs(enc[k] - enc_ref[k]).max()) for k in enc_ref}
    ctl = {k: float(np.abs(enc_ctl[k] - enc_ref[k]).max()) for k in enc_ref}
    tol = {k: MG_CONTROL_FACTOR * max(ctl[k], 1e-7) for k in ctl}
    enc_ok = all(gap[k] <= tol[k] for k in gap)
    enc_w8 = dict(np.load(os.path.join(tmp, "enc_w8.npz")))
    probe = enc_w8.pop("probe")
    w8_gap = {k: float(np.abs(enc_w8[k] - w8_ref[k]).max()) for k in w8_ref}
    w8_ctl = {k: max(float(np.abs(c[k] - w8_ref[k]).max()) for c in w8_ctl)
              for k in w8_ref}
    w8_tol = {k: MG_CONTROL_FACTOR * max(w8_ctl[k], 1e-7) for k in w8_ctl}
    probe_gap = float(np.abs(probe - probe_ref).max()
                      / np.abs(probe_ref).max())
    w8_enc_ok = (all(w8_gap[k] <= w8_tol[k] for k in w8_gap)
                 and probe_gap <= TOL_MG_PROBE_REL)
    w8_want = u["tokens"]
    agree = [position_agreement([tuple(t) for t in r0["w8_tokens"][s]],
                                [tuple(t) for t in w8_want[s]])
             for s in w8_want]
    w8_counts_ok = all(len(r0["w8_tokens"][s]) == len(w8_want[s])
                       and w8_want[s] for s in w8_want)
    w8_ok = (w8_counts_ok and w8_enc_ok and r0["w8_split"] == [True, True,
                                                                 False]
             and min(agree) >= TOL_W8A8_TOKEN_AGREE)
    prof = r0["profile"]
    steps_b = r0["q8_counts"]["attn"] // cfg.n_layers
    prof_ok = (prof["attn"] > 0 and prof["attn"] % cfg.n_layers == 0
               and prof["q8"] == 10 * prof["attn"]
               and r0["q8_counts"]["q8"] == 10 * cfg.n_layers * steps_b
               and steps_b > 0 and r0["local_heads"] == cfg.n_heads // 2
               and r0["split"] == [True, True, True])
    coll = r0["q8_collectives"]
    if not (q8_equal and enc_ok and w8_ok and prof_ok):
        failures.append(
            f"multi-GPU (b) model-parallel 2: Q8_0 tokens equal {q8_equal}, "
            f"encoder gaps {gap} (tol {tol}), W8A8 token counts "
            f"{w8_counts_ok}, agreement {min(agree):.4f} (tol "
            f"{TOL_W8A8_TOKEN_AGREE}), encoder gaps {w8_gap} (tol {w8_tol}),"
            f" FFN probe {probe_gap:.3e} (tol {TOL_MG_PROBE_REL:.0e}), split "
            f"{r0['w8_split']}; profile {prof['attn']} attention / "
            f"{prof['q8']} Q8 launches, split {r0['split']}")
    out["b"] = dict(q8_tokens_equal=q8_equal, encoder_gap=gap,
                    encoder_control=ctl, w8a8_encoder_gap=w8_gap,
                    w8a8_encoder_control=w8_ctl, w8a8_ffn_probe_rel=probe_gap,
                    w8a8_agreement_min=min(agree),
                    w8a8_agreement_mean=float(np.mean(agree)),
                    w8a8_split=r0["w8_split"],
                    local_shapes=r0["local_shapes"],
                    profile=dict(attn=prof["attn"], q8=prof["q8"],
                                 busy_us=prof["busy_us"],
                                 wall_us=prof["wall_us"]),
                    collectives_a_tick=dict(
                        calls=coll["n"] / MG_TICKS,
                        mib=coll["bytes"] / MG_TICKS / 2 ** 20),
                    tick_p50_ms=dict(q8=p50(r0["q8_times"][1:]),
                                     w8a8=p50(r0["w8_times"][1:])),
                    launches=dict(q8=r0["q8_counts"], w8a8=r0["w8_counts"]))
    log(f"  (b) model-parallel 2, two ranks sharing one card over gloo "
        f"(local heads {r0['local_heads']}, local (K, N) "
        f"{r0['local_shapes']}; products split {r0['split']}, W8A8 "
        f"{r0['w8_split']}): Q8_0 f32 engine tokens equal to (a)'s "
        f"{q8_equal}; encode_chunk gap "
        + ", ".join(f"{k} {gap[k]:.3e} (control {ctl[k]:.3e})" for k in gap)
        + f"; W8A8 bf16 engine: token counts equal {w8_counts_ok}, position "
        f"agreement with (a)'s min {min(agree):.4f} (tol "
        f"{TOL_W8A8_TOKEN_AGREE}) mean {float(np.mean(agree)):.4f}; W8A8 "
        f"encode_chunk (f32) gap "
        + ", ".join(f"{k} {w8_gap[k]:.3e} (control {w8_ctl[k]:.3e})"
                    for k in w8_gap)
        + f", layer 0's FFN {probe_gap:.3e} of its max (tol "
        f"{TOL_MG_PROBE_REL:.0e}); profiled tick: {prof['attn']} "
        f"attention and {prof['q8']} Q8 launches, device busy "
        f"{prof['busy_us'] / 1e3:.2f} of {prof['wall_us'] / 1e3:.2f} ms; "
        f"all_reduce a tick: {coll['n'] / MG_TICKS:g} calls, "
        f"{coll['bytes'] / MG_TICKS / 2 ** 20:.2f} MiB; tick p50 (two ranks "
        f"sharing one card) Q8_0 {out['b']['tick_p50_ms']['q8']:.2f} ms, "
        f"W8A8 {out['b']['tick_p50_ms']['w8a8']:.2f} ms")
    for line in prof["top"]:
        log(f"      {line[1] / 1e3:9.3f} ms  {line[0]}")

    # (c) data-parallel 2
    lock_ok = serv_ok = True
    for r, res in enumerate(results):
        h = halves[r]
        st = dict(np.load(os.path.join(tmp, f"lock_state{r}.npz")))
        lock_ok &= (res["lock_tokens"] == h["lock"]
                    and res["lock_resumed_tokens"] == h["lock"]
                    and res["lock_resumed_equal"]
                    and mg_equal_states(st, h["lock_state"]))
        serv_ok &= res["mh_serving_tokens"] == h["serving"]
    if not (lock_ok and serv_ok):
        failures.append(f"multi-GPU (c) data-parallel 2: MultihostLockstep "
                        f"equal {lock_ok}, MultihostServing equal {serv_ok}")
    out["c"] = dict(lockstep_equal=lock_ok, serving_equal=serv_ok,
                    rows_a_rank=MG_DP_ROWS)
    log(f"  (c) data-parallel 2, {MG_DP_ROWS} rows a rank: MultihostLockstep"
        f" tokens and state bit-equal to one-process engines of the same "
        f"rows, and its per-rank save / load halfway equal: {lock_ok}; "
        f"MultihostServing tokens equal: {serv_ok}")

    # (d) training
    grads = dict(np.load(os.path.join(tmp, "grads.npz")))
    loss_ok = (abs(r0["train_loss"] - ref_loss)
               <= TOL_MG_LOSS_REL * abs(ref_loss))
    norm_ok = (abs(r0["train_norm"] - ref_norm)
               <= TOL_MG_LOSS_REL * abs(ref_norm))
    worst = max(float(np.abs(grads[k] - ref_grads[k]).max())
                / max(float(np.abs(ref_grads[k]).max()), 1e-30)
                for k in ref_grads)
    if not (loss_ok and norm_ok and worst <= TOL_MG_GRAD_REL
            and grads.keys() == ref_grads.keys()):
        failures.append(f"multi-GPU (d) training: loss {r0['train_loss']} vs"
                        f" {ref_loss}, norm {r0['train_norm']} vs {ref_norm},"
                        f" worst gradient gap {worst:.3e} of a leaf's max")
    out["d"] = dict(loss=r0["train_loss"], loss_one_rank=ref_loss,
                    norm=r0["train_norm"], norm_one_rank=ref_norm,
                    worst_grad_rel=worst)
    log(f"  (d) train step, {TRAIN_CUT_LAYERS}-layer cut, model-parallel 2 "
        f"vs one rank: loss {r0['train_loss']:.6f} / {ref_loss:.6f}, norm "
        f"{r0['train_norm']:.6f} / {ref_norm:.6f}, worst gradient gap "
        f"{worst:.3e} of a leaf's max (tol {TOL_MG_GRAD_REL:.0e})")

    # (e) the entry points
    want_lines = {
        "serve --mesh 1": ["rank 0/1: backend nccl, device cuda:0",
                           "aggregate real-time"],
        "serve --mesh 2": ["rank 0/2: backend gloo, device cuda:0",
                           "rank 1/2: backend gloo, device cuda:0",
                           "aggregate real-time"],
        "serve --coordinator": ["backend gloo, device cuda:0",
                                "aggregate real-time"],
        "train --model-parallel 2": [
            "devices: 1, mesh {'data': 1, 'model': 1}", "step     2"]}
    ent = {}
    for name, outs in entry_out.items():
        ok = all(all(w in err for w in want_lines[name]) for _, err in outs)
        if not ok:
            failures.append(f"multi-GPU (e) {name}: summary lines missing")
        ent[name] = ok
        summary = [ln for _, err in outs for ln in err.splitlines()
                   if "aggregate real-time" in ln or ln.startswith(
                       ("devices:", "rank ", "process "))]
        log(f"  (e) {name}: exit 0 and its summary {ok}: "
            + " | ".join(summary[:4]))
    out["e"] = ent
    out["ranks_wall_s"] = rank_wall
    log(f"  the ranks: {rank_wall:.1f} s from their start to their end "
        f"(rank 0: (b) {r0['walls']['b']:.1f} s with its start and loads, "
        f"(c) {r0['walls']['c']:.1f} s, (d) {r0['walls']['d']:.1f} s)")
    out["launches"] = launches
    _shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# slice 18: dump tracing, the profiler reader, the native bindings and beam
# decode on a mesh
# ---------------------------------------------------------------------------

# (b) the chunks the traced session runs; (c) the CLI's audio in chunks
# (the finalize may add one)
UN_CHUNKS, UN_CLI_CHUNKS = 8, 4
# (d) the native-DSP engine: slots, ticks of one quantum each, the slots
# held to solo sessions, and the native mel's tolerance against the numpy
# backend's (the JAX package's log-mel tolerance)
UN_SLOTS, UN_TICKS = 16, 4
UN_TRACKED = (0, 15)
TOL_NATIVE_MEL = 2e-4
# (e) the beam engine on a mesh: slots and ticks
UN_BEAM_SLOTS, UN_BEAM_TICKS = 4, 4


def un_pcm(row: int, n: int) -> np.ndarray:
    """n samples of stream `row`'s seeded PCM."""
    return seeded_pcm(1800 + row, (n + 1) / 16000)[:n]


def un_beam_engine(params, cfg, vocab, mesh=None):
    """(e)'s ServingEngine over the peaked model (peaked_params: its beams
    emit): K = BEAM_K, f32, host DSP, R = 13."""
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.streaming.serving import ServingEngine

    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    return ServingEngine(peaked_params(params), cfg, vocab, cc,
                         n_slots=UN_BEAM_SLOTS, compute_dtype=torch.float32,
                         dsp="numpy", beam_size=BEAM_K, mesh=mesh)


def un_beam_run(eng) -> dict:
    """Every slot admitted and fed one quantum of its PCM a tick; the
    refreshed best hypotheses' tokens by slot."""
    q = eng.cc.shift_samples
    slots = eng.add_streams(eng.n_slots)
    for t in range(UN_BEAM_TICKS):
        eng.feed_audio({s: un_pcm(s, q * UN_BEAM_TICKS)[t * q:(t + 1) * q]
                        for s in slots})
        eng.step()
    eng.refresh_transcripts()
    return mg_token_lists(eng, slots)


def un_beam_leaves(eng) -> dict:
    """Every beam-state leaf (gathered over the data axis on a mesh) and
    every encoder and decoder state leaf, as numpy."""
    from nemotron_tpu_torch.models import beam as beam_mod
    from nemotron_tpu_torch.parallel import mesh as mesh_mod
    from nemotron_tpu_torch.utils import npz

    beam = eng.beam_state
    if eng.mesh is not None:
        beam = mesh_mod.gather_stream_major(beam, eng.mesh)
    out = {f"beam/{k}": npz.to_numpy(v)
           for k, v in beam_mod.leaves(beam).items()}
    return out | mg_state(eng)


def beam_rank_job(addr: str, rank: int, world: int, gguf_path: str,
                  out_path: str, device: str) -> None:
    """One of (e)'s two ranks, sharing the card over gloo (the kernels are
    built already): the beam engine on a data-parallel 2 mesh over (e)'s
    schedule; rank 0 writes the tokens."""
    import torch.distributed as dist

    from nemotron_tpu_torch.device import resolve_device
    from nemotron_tpu_torch.parallel.mesh import init_world, make_mesh
    from nemotron_tpu_torch.params import load_model

    dev = resolve_device(device)
    init_world(f"tcp://{addr}", world, rank, "gloo")
    mesh = make_mesh(model_parallel=1, device=dev)
    params, cfg, vocab = load_model(gguf_path, device=dev)
    toks = un_beam_run(un_beam_engine(params, cfg, vocab, mesh))
    if rank == 0:
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(toks, f)
    dist.destroy_process_group()


def start_beam_ranks(gguf_path: str, out_path: str, device: str) -> list:
    """The two ranks of beam_rank_job on `device`, started together."""
    addr = f"127.0.0.1:{free_port()}"
    here = os.path.dirname(os.path.abspath(__file__))
    return [subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {here!r}); import torch; "
         f"torch.set_num_threads(2); import chip_smoke; "
         f"chip_smoke.beam_rank_job({addr!r}, {r}, 2, {gguf_path!r}, "
         f"{out_path!r}, {device!r})"], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]


def params_equal(a, b) -> bool:
    """Every leaf of two ModelParams equal (dtype, shape and bytes)."""
    import torch

    from nemotron_tpu_torch.params import flatten

    fa, fb = flatten(a), flatten(b)
    return fa.keys() == fb.keys() and all(
        not isinstance(v, torch.Tensor)
        or (v.dtype == fb[k].dtype and torch.equal(v, fb[k]))
        for k, v in fa.items())


def utils_native_phase(gguf_path: str, failures: list) -> dict:
    """Slice 18 at full width (24 layers, d_model 1024, the seeded Q8_0
    GGUF), R = 13:
    (a) NativeGGUF over the GGUF: every tensor's bytes equal to the plain
        reader's; load_model through it (the "auto" default the other
        phases loaded with) and load_model(use_native=False): every
        parameter equal. Both reads' host wall (warm page cache).
    (b) a traced session on the card (f32, one stream, UN_CHUNKS chunks)
        beside an untraced one: tokens and every state leaf bit-equal,
        24 attention and 240 Q8 launches a chunk in both; the 24
        layer_NN_out files and the other four, with their shapes;
        encoder_out equal to the last layer's output; read_dump round
        trips (appending its records again writes the same bytes).
    (c) `python -m nemotron_tpu_torch.cli ... --profile=DIR` on the card
        (a child process): a trace in DIR, step_percentiles' n_steps = the
        CLI's chunks less drop_first, every step's device time > 0, and
        the ring and Q8 kernels among its kernel events.
    (d) ServingEngine(dsp="native") with UN_SLOTS slots for UN_TICKS
        ticks: dsp_mode "native"; its tracked slots' tokens equal to solo
        sessions with the native frontend; the native mel within
        TOL_NATIVE_MEL of the numpy backend's (FFT on the card); the
        native DSP's host ms a tick beside the device DSP's device ms for
        the same slots.
    (e) ServingEngine(beam_size=BEAM_K) on a one-rank NCCL mesh against
        the unsharded engine: tokens, scores and every beam-state and
        state leaf bit-equal; then two gloo ranks sharing the card (data
        2), their tokens equal to the unsharded engine's.
    (c) and (e)'s ranks run as child processes beside (a), (b) and (d)."""
    import torch

    from nemotron_tpu_torch import gguf_native
    from nemotron_tpu_torch.config import (MAX_SYMBOLS_PER_STEP, CacheConfig,
                                           PreprocessorConfig)
    from nemotron_tpu_torch.frontend.device_frontend import (
        init_frontend_state, mel_frontend_step)
    from nemotron_tpu_torch.frontend.preprocessor import (
        StreamingPreprocessor, pad_window)
    from nemotron_tpu_torch.gguf import read_gguf
    from nemotron_tpu_torch.parallel.mesh import make_mesh
    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.streaming.serving import ServingEngine
    from nemotron_tpu_torch.streaming.session import (CHUNK_STEP_RANGE,
                                                      StreamSession)
    from nemotron_tpu_torch.utils import dump, profiler

    f32 = torch.float32
    out = {}
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    q8, cfg, vocab = full_width_model(gguf_path, CARD)
    cc13 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    tmp = tempfile.mkdtemp(prefix="un_")
    # the children: (c)'s CLI and (e)'s two ranks
    n_cli = cc13.chunk_samples + (UN_CLI_CHUNKS - 1) * cc13.shift_samples
    pcm_path = os.path.join(tmp, "cli.pcm")
    un_pcm(0, n_cli).tofile(pcm_path)
    prof_dir = os.path.join(tmp, "prof")
    here = os.path.dirname(os.path.abspath(__file__))
    cli = start_module("cli", [gguf_path, pcm_path, "80", "13",
                               f"--profile={prof_dir}",
                               *(["--cpu"] if CARD == "cpu" else [])],
                       dict(os.environ), here)
    beam_out = os.path.join(tmp, "beam_ranks.json")
    card0 = f"{CARD}:0" if CARD == "cuda" else CARD
    ranks = start_beam_ranks(gguf_path, beam_out, card0)
    walls, t_part = {}, time.perf_counter()
    try:
        # (a) the native GGUF loader
        t0 = time.perf_counter()
        nat = read_gguf(gguf_path, use_native=True)
        t_nat = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = read_gguf(gguf_path, use_native=False)
        t_plain = time.perf_counter() - t0
        same_bytes = (list(nat.tensors) == list(plain.tensors) and all(
            t.shape == plain.tensors[n].shape
            and t.ggml_type == plain.tensors[n].ggml_type
            and np.array_equal(t.raw, np.frombuffer(plain.tensors[n].raw,
                                                    np.uint8))
            for n, t in nat.tensors.items()))
        n_bytes = sum(len(t.raw) for t in plain.tensors.values())
        n_tensors = len(plain.tensors)
        del nat, plain
        native_default = gguf_native.available()
        t0 = time.perf_counter()
        plain_params = load_model(gguf_path, device=CARD,
                                  use_native=False)[0]
        t_load = time.perf_counter() - t0
        same_params = params_equal(q8, plain_params)
        del plain_params
        if not (same_bytes and same_params and native_default):
            failures.append(f"utils-native (a): tensor bytes equal "
                            f"{same_bytes}, load_model params equal "
                            f"{same_params}, native loader built "
                            f"{native_default}")
        out["a"] = dict(tensors=n_tensors, bytes=n_bytes, native_read_s=t_nat,
                        plain_read_s=t_plain, plain_load_model_s=t_load,
                        bytes_equal=same_bytes, params_equal=same_params)
        log(f"  (a) NativeGGUF: {out['a']['tensors']} tensors, {n_bytes} "
            f"bytes equal to the plain reader's {same_bytes}; read "
            f"{t_nat:.3f} s (mmap views) vs {t_plain:.3f} s (read copies), "
            f"warm page cache; load_model params equal with and without it "
            f"{same_params} (plain load_model {t_load:.1f} s)")

        walls["a"], t_part = time.perf_counter() - t_part, time.perf_counter()
        # (b) a traced session beside an untraced one
        trace_dir = os.path.join(tmp, "trace")
        sessions, counts = {}, {}
        q = cc13.shift_samples
        pcm = un_pcm(1, q * (UN_CHUNKS + 2))
        for name, kw in (("plain", {}), ("traced", {"trace_dir": trace_dir})):
            sess = StreamSession(q8, cfg, vocab, cc13, compute_dtype=f32,
                                 **kw)

            def feed(sess=sess):
                i = 0
                while sess.total_chunks < UN_CHUNKS:
                    sess.process(pcm[i * q:(i + 1) * q])
                    i += 1

            t0 = time.perf_counter()
            _, counts[name] = counted(feed, launches)
            sessions[name] = (sess, time.perf_counter() - t0)
        (tr, t_tr), (pl, t_pl) = sessions["traced"], sessions["plain"]
        equal = tr.get_tokens(0) == pl.get_tokens(0) and all(
            torch.equal(getattr(a, f), getattr(b, f))
            for a, b in ((tr.enc_state, pl.enc_state),
                         (tr.dec_state, pl.dec_state))
            for f in vars(a))
        want_counts = {"attn": cfg.n_layers * UN_CHUNKS,
                       "q8": 10 * cfg.n_layers * UN_CHUNKS, "w8a8": 0}
        T = cc13.chunk_enc_len
        shapes = {"mel.bin": (UN_CHUNKS * cc13.chunk_mel_frames, cfg.n_mels),
                  "pre_encode_out.bin": (UN_CHUNKS * T, cfg.d_model),
                  "encoder_out.bin": (UN_CHUNKS * cc13.valid_out_len,
                                      cfg.d_model),
                  "tokens.bin": (UN_CHUNKS * cc13.valid_out_len,
                                 MAX_SYMBOLS_PER_STEP)}
        shapes |= {f"layer_{l:02d}_out.bin": (UN_CHUNKS * T, cfg.d_model)
                   for l in range(cfg.n_layers)}
        files = sorted(os.listdir(trace_dir))
        got = {f: dump.read_dump(os.path.join(trace_dir, f)) for f in files}
        shapes_ok = files == sorted(shapes) and all(
            got[f].shape == s for f, s in shapes.items())
        last_ok = np.array_equal(
            got["encoder_out.bin"],
            got[f"layer_{cfg.n_layers - 1:02d}_out.bin"][
                np.arange(UN_CHUNKS * T) % T < cc13.valid_out_len])
        rt_dir = os.path.join(tmp, "roundtrip")
        os.makedirs(rt_dir)
        for f, arr in got.items():
            for rec in np.split(arr, UN_CHUNKS):
                dump.append_dump(os.path.join(rt_dir, f), rec)
        round_trip = all(
            open(os.path.join(rt_dir, f), "rb").read()
            == open(os.path.join(trace_dir, f), "rb").read() for f in files)
        counts_ok = counts["traced"] == counts["plain"] == want_counts
        if not (equal and counts_ok and shapes_ok and last_ok
                and round_trip):
            failures.append(
                f"utils-native (b) traced session: tokens and state equal "
                f"{equal}, launches {counts} (want {want_counts}), files "
                f"{len(files)} with their shapes {shapes_ok}, encoder_out = "
                f"last layer {last_ok}, read_dump round trip {round_trip}")
        out["b"] = dict(equal=equal, counts=counts, files=len(files),
                        shapes_ok=shapes_ok, encoder_out_is_last=last_ok,
                        round_trip=round_trip, wall_traced_s=t_tr,
                        wall_plain_s=t_pl,
                        chunk_ms_traced=tr.chunk_seconds / UN_CHUNKS * 1e3,
                        chunk_ms_plain=pl.chunk_seconds / UN_CHUNKS * 1e3,
                        tokens=len(pl.get_tokens(0)))
        log(f"  (b) traced session, {UN_CHUNKS} chunks f32: tokens "
            f"({len(pl.get_tokens(0))}) and every state leaf bit-equal "
            f"{equal}; launches traced {counts['traced']} / untraced "
            f"{counts['plain']}; {len(files)} dump files with their shapes "
            f"{shapes_ok}; encoder_out = layer {cfg.n_layers - 1} "
            f"{last_ok}; read_dump round trip {round_trip}; chunk "
            f"{out['b']['chunk_ms_traced']:.2f} ms traced / "
            f"{out['b']['chunk_ms_plain']:.2f} untraced (host clock)")
        del sessions, tr, pl, got

        walls["b"], t_part = time.perf_counter() - t_part, time.perf_counter()
        # (d) the native-DSP engine
        eng = ServingEngine(q8, cfg, vocab, cc13, n_slots=UN_SLOTS,
                            compute_dtype=f32, dsp="native")
        slots = eng.add_streams(UN_SLOTS)
        audio = {s: un_pcm(100 + s, q * UN_TICKS) for s in slots}
        feed_ms = []

        def ticks():
            for t in range(UN_TICKS):
                t0 = time.perf_counter()
                eng.feed_audio({s: audio[s][t * q:(t + 1) * q]
                                for s in slots})
                feed_ms.append((time.perf_counter() - t0) * 1e3)
                eng.step()

        counted(ticks, launches)
        tokens_ok, mel_err = True, 0.0
        pcfg = PreprocessorConfig(n_mels=cfg.n_mels)
        fb = q8.preprocessor.filterbank.float().cpu().numpy()
        win = q8.preprocessor.window.float().cpu().numpy()
        for s in UN_TRACKED:
            solo = StreamSession(q8, cfg, vocab, cc13, compute_dtype=f32,
                                 frontend="native")
            (_, n) = counted(lambda: solo.process(audio[s]), launches)
            tokens_ok &= solo.get_tokens(0) == eng.tokens[s]
            mels = [StreamingPreprocessor(fb, win, cfg=pcfg, device=CARD,
                                          backend=b).process(audio[s])
                    for b in ("native", "numpy")]
            mel_err = max(mel_err, float(np.abs(mels[0] - mels[1]).max()))
        # the device DSP's time for the same slots: one quantum of each
        front = init_frontend_state(UN_SLOTS, CARD, pcfg)
        block = torch.from_numpy(np.stack([audio[s][:q] for s in slots])).to(
            CARD)
        wdev = torch.from_numpy(pad_window(win, pcfg.n_fft)).to(CARD)
        fdev = torch.from_numpy(fb).to(CARD)
        for _ in range(3):
            mel_frontend_step(block, front, wdev, fdev, pcfg)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            mel_frontend_step(block, front, wdev, fdev, pcfg)
        end.record()
        torch.cuda.synchronize()
        dev_ms = start.elapsed_time(end) / 20
        native_ms = float(np.percentile(feed_ms[1:], 50))
        ok = (eng.dsp_mode == "native" and tokens_ok
              and mel_err <= TOL_NATIVE_MEL)
        n_tok = {s: len(eng.tokens[s]) for s in UN_TRACKED}
        if not ok:
            failures.append(f"utils-native (d) native-DSP engine: dsp_mode "
                            f"{eng.dsp_mode}, tokens equal to solo native "
                            f"sessions {tokens_ok}, native mel against numpy "
                            f"{mel_err:.3e} (tol {TOL_NATIVE_MEL:g})")
        out["d"] = dict(dsp_mode=eng.dsp_mode, tokens_equal=tokens_ok,
                        tokens=n_tok, mel_max_abs_err=mel_err,
                        native_ms_tick_p50=native_ms, device_dsp_ms=dev_ms,
                        chunk_steps=len(eng.step_times))
        log(f"  (d) ServingEngine dsp={eng.dsp_mode}, {UN_SLOTS} slots, "
            f"{UN_TICKS} ticks: tracked slots' tokens {n_tok} equal to solo "
            f"native sessions {tokens_ok}; native mel vs numpy (FFT on the "
            f"card) max_abs_err {mel_err:.3e} (tol {TOL_NATIVE_MEL:g}); "
            f"native DSP {native_ms:.3f} ms a tick (host, p50) vs device "
            f"DSP {dev_ms:.3f} ms (CUDA events) for {UN_SLOTS} slots")
        del eng

        walls["d"], t_part = time.perf_counter() - t_part, time.perf_counter()
        # (e) the beam engine on a one-rank NCCL mesh
        mesh1 = make_mesh(device=card0)
        res = {}
        for kind in ("unsharded", "mesh"):
            eng = un_beam_engine(q8, cfg, vocab,
                                 mesh1 if kind == "mesh" else None)
            toks, _ = counted(lambda: un_beam_run(eng), launches)
            res[kind] = (toks, un_beam_leaves(eng))
            del eng
        same = (res["mesh"][0] == res["unsharded"][0]
                and mg_equal_states(res["mesh"][1], res["unsharded"][1]))
        emitted = sum(len(v) for v in res["unsharded"][0].values())
        walls["e"], t_part = time.perf_counter() - t_part, time.perf_counter()
    finally:
        cli_out, cli_err = finish_module(cli, "utils-native (c) cli "
                                         "--profile", failures)
        rank_logs = [p.communicate(timeout=600) for p in ranks]
    walls["children"] = time.perf_counter() - t_part
    rank_ok = all(p.returncode == 0 for p in ranks)
    gloo_same = rank_ok and json.load(open(beam_out)) == res["unsharded"][0]
    if not (same and gloo_same and emitted):
        failures.append(
            f"utils-native (e) beam K={BEAM_K} on a mesh: one-rank "
            f"{mesh1.backend} mesh bit-equal {same}, two gloo ranks' tokens "
            f"equal {gloo_same} (exits {[p.returncode for p in ranks]}: "
            f"{[e[-800:] for _, e in rank_logs if e]}), tokens {emitted}")
    out["e"] = dict(one_rank_equal=same, gloo_equal=gloo_same,
                    tokens=emitted, backend=mesh1.backend)
    log(f"  (e) beam K={BEAM_K}, {UN_BEAM_SLOTS} slots, {UN_BEAM_TICKS} "
        f"ticks: one-rank {mesh1.backend} mesh vs unsharded, tokens "
        f"({emitted}), scores and every beam and state leaf bit-equal "
        f"{same}; two gloo ranks sharing the card (data 2): tokens equal "
        f"{gloo_same}")

    # (c) the CLI's profile
    try:
        chunks = int(cli_err.split("processed ")[1].split()[0])
        trace = profiler.latest_trace(prof_dir)
        durs = profiler.module_durations_ms(trace)[CHUNK_STEP_RANGE]
        st = profiler.step_percentiles(prof_dir, match=CHUNK_STEP_RANGE)
        with open(trace, encoding="utf-8") as f:
            kernels = {e["name"] for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"}
        ring = any("ring_attn_cluster_kernel" in k for k in kernels)
        q8k = any("q8_matmul" in k for k in kernels)
        line = f"profiler trace written to {prof_dir}" in cli_err
        ok = (line and st["n_steps"] == chunks - 1 and len(durs) == chunks
              and min(durs) > 0 and ring and q8k)
        out["c"] = dict(chunks=chunks, steps=st, min_step_ms=min(durs),
                        ring_kernel=ring, q8_kernel=q8k, line=line)
    except (IndexError, ValueError, KeyError, FileNotFoundError) as e:
        ok, out["c"] = False, dict(error=repr(e))
    if not ok:
        failures.append(f"utils-native (c) cli --profile: {out['c']}")
    else:
        log(f"  (c) cli --profile on the card: {chunks} chunk steps, "
            f"step_percentiles {st['n_steps']} steps p50 "
            f"{st['p50_ms']:.3f} / p90 {st['p90_ms']:.3f} / max "
            f"{st['max_ms']:.3f} device ms (min {min(durs):.3f}); ring "
            f"and Q8 kernels in the trace {ring and q8k}")
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"  parts (s): {', '.join(f'{k} {v:.1f}' for k, v in walls.items())}"
        f" (children: the wait for (c)'s CLI and (e)'s ranks after (e))")
    out["launches"], out["walls"] = launches, walls
    return out


# ---------------------------------------------------------------------------
# slice 19: the evaluation entry points (nemotron_tpu_torch/scripts/)
# ---------------------------------------------------------------------------

# (a) token_agreement --full: seconds of audio a stream (4 streams, R = 0
# and 13); the static W8A8 tier (SmoothQuant with frozen activation
# scales) on the full-width GGUF's dense weights at R = 13. The blank-bias
# search (on R = 13 chunks) starts at EVAL_BLANK_BIAS, which it keeps: from
# the default 3.0 it took four probes to settle at 6.75, with 40 f32
# reference tokens at R = 13 against 320 at 6.0. At either bias R = 0's
# f32 reference emits nothing, and the harness skips that mode
EVAL_SECONDS = 2.0
EVAL_BLANK_BIAS = 6.0
EVAL_FULL_ARGS = ["--full", "--modes", "0,13", "--streams", "4", "--seeds",
                  "1", "--seconds", f"{EVAL_SECONDS:g}", "--blank-bias",
                  f"{EVAL_BLANK_BIAS:g}"]
# (b) compare_outputs: audio long enough that the batch pass's encoder
# matmuls exceed the Q8 kernel's M* = 96 rows (7.7 s): 9 s = 113 frames
EVAL_CMP_SECONDS = 9.0
# (c) the trained fixtures: each entry point's flags (after its name)
EVAL_TONES = {
    "token_agreement": ["--gguf", "tones_tiny.gguf", "--tones", "16",
                        "--seconds", "6", "--streams", "2", "--seeds", "1",
                        "--modes", "13"],
    "beam_quality": ["--seconds", "6", "--streams", "2", "--seeds", "1",
                     "--modes", "13"],
    "lm_quality": ["--seconds", "6", "--streams", "2", "--seeds", "1",
                   "--modes", "13"],
    "tdt_quality": ["--seconds", "6", "--streams", "2", "--seeds", "1"],
    "hybrid_quality": ["--seconds", "6", "--streams", "2", "--seeds", "1"],
    # the host DSP on both sides: the device DSP runs a stream one chunk
    # behind real time, which would move the endpoints against the CPU's
    "refine_quality": ["--streams", "2", "--utts-per-stream", "2",
                       "--utt-tones", "4", "--seeds", "1", "--dsp", "numpy"],
    "emission_delay": ["--seconds", "6", "--streams", "2", "--modes",
                       "0,13"],
}
# token_agreement's bf16 and int8 tiers, card against the CPU's run of
# the same entry point: the card's kernels round bf16 at other points than
# the CPU's plain versions, so a near-tie may flip a token (one flip of
# the ~45 reference tokens moves agreement 2.2 and TER 2.3 points)
TOL_EVAL_AGREEMENT_PCT = 7.0
TOL_EVAL_TER_PCT = 7.0


def eval_args(name: str, cpu: bool = False) -> list:
    """EVAL_TONES[name] with the fixture's path made whole (and --cpu)."""
    weights = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "weights")
    return [os.path.join(weights, a) if a.endswith(".gguf") else a
            for a in EVAL_TONES[name]] + (["--cpu"] if cpu else [])


def run_entry(name: str, args: list) -> tuple[int, str, str]:
    """nemotron_tpu_torch.scripts.<name>.main in this process with both of
    its streams captured: (exit code, stdout, stderr). The stderr of a
    run that exits other than 0 also goes to this process's stderr."""
    import importlib
    import io

    mod = importlib.import_module(f"nemotron_tpu_torch.scripts.{name}")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main([name, *args])
    if rc:
        sys.stderr.write(err.getvalue())
    return rc, out.getvalue(), err.getvalue()


def eval_json(name: str, out: str):
    """An entry point's result: the summary JSON (token_agreement), the
    lines of JSON (emission_delay) or the last line's JSON."""
    if name == "token_agreement":
        return json.loads(out)
    if name == "emission_delay":
        return [json.loads(ln) for ln in out.strip().splitlines()]
    return json.loads(out.strip().splitlines()[-1])


def eval_cmp_pcm(path: str) -> str:
    """(b)'s seeded audio written to `path`."""
    seeded_pcm(2, EVAL_CMP_SECONDS).tofile(path)
    return path


def cpu_eval_reference(gguf_path: str, pcm_path: str, out_path: str) -> None:
    """The eval phase's CPU runs: compare_outputs --cpu on the full-width
    Q8_0 GGUF and each EVAL_TONES entry point with --cpu, their stdout
    (as JSON)."""
    res = {}
    rc, out, _err = run_entry("compare_outputs", [
        gguf_path, eval_cmp_pcm(pcm_path), "--right-context", "13", "--cpu"])
    res["compare_outputs"] = [rc, out]
    for name in EVAL_TONES:
        res[name] = list(run_entry(name, eval_args(name, cpu=True))[:2])
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(res, f)


def eval_tones_card(out_path: str) -> None:
    """(c) in a child process on the card: each EVAL_TONES entry point
    through its main; as JSON, {name: [exit code, stdout]} and the
    launches of them all."""
    n = {"attn": 0, "q8": 0, "w8a8": 0}
    t0 = time.perf_counter()
    runs = {name: list(counted(lambda: run_entry(name, eval_args(name)),
                               n)[0][:2]) for name in EVAL_TONES}
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"runs": runs, "launches": n,
                   "wall": time.perf_counter() - t0}, f)


def eval_kind(params, cc, dtype) -> str:
    """A token_agreement configuration by its ring type (dense, int8 or
    int4; +x-ring for the shared ring), its encoder matmuls (dense, q8,
    w8a8 dynamic or w8a8-static) and its compute dtype."""
    from nemotron_tpu_torch.ops.quant import QTensor, QTensorW8A8

    ring = ("int4" if cc.kv_cache_int4 else "int8" if cc.kv_cache_int8
            else "dense") + ("+x-ring" if cc.shared_cache else "")
    w = params.layers.ffn1_w1
    mm = ("w8a8-static" if isinstance(w, QTensorW8A8)
          and w.act_scale is not None else "w8a8" if isinstance(w, QTensorW8A8)
          else "q8" if isinstance(w, QTensor) else "dense")
    return f"{ring} {mm} {str(dtype).split('.')[-1]}"


def eval_full_agreement(gguf_path: str, out_path: str) -> None:
    """(a) in a child process on the card: `token_agreement` with
    EVAL_FULL_ARGS through its main, each run_config's launches counted
    (eval_kind); then the static W8A8 tier (make_w8a8_sq(static_act=True))
    of the full-width GGUF's dense weights against their f32 decode at
    R = 13 (4 streams of EVAL_SECONDS), through the module's run_config.
    As JSON: exit code, summary, launches, the static tier, walls."""
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.scripts import token_agreement as ta

    by_kind: dict = {}
    plain_run = ta.run_config

    def counted_run(params, cfg, cc, dtype, audio, chunk):
        n = {"attn": 0, "q8": 0, "w8a8": 0}
        toks, _ = counted(lambda: plain_run(params, cfg, cc, dtype, audio,
                                            chunk), n)
        kind = by_kind.setdefault(eval_kind(params, cc, dtype),
                                  dict.fromkeys(n, 0))
        for k, v in n.items():
            kind[k] += v
        return toks

    ta.run_config = counted_run
    t0 = time.perf_counter()
    try:
        rc, text, _err = run_entry("token_agreement", EVAL_FULL_ARGS)
    finally:
        ta.run_config = plain_run
    wall = time.perf_counter() - t0

    q8, cfg, _ = full_width_model(gguf_path, CARD)
    dense = dense_of(q8)
    cal = np.stack([ta.synth_audio(int(EVAL_SECONDS * 16000), 990 + s)
                    for s in range(2)])
    static = ta.make_w8a8_sq(dense, cfg, cal, static_act=True)
    cc13 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    audio = np.stack([seeded_pcm(s, EVAL_SECONDS) for s in range(4)])
    ref = plain_run(dense, cfg, cc13, torch.float32, audio,
                    cc13.chunk_samples)
    n_static = {"attn": 0, "q8": 0, "w8a8": 0}
    got, _ = counted(lambda: plain_run(static, cfg, cc13, torch.bfloat16,
                                       audio, cc13.chunk_samples), n_static)
    flips = sum(ta.levenshtein(g, r) for g, r in zip(got, ref))
    denom = sum(max(len(g), len(r), 1) for g, r in zip(got, ref))
    static_tier = dict(agreement_pct=round(100 * (1 - flips / denom), 2),
                       flips=flips, ref_tokens=sum(map(len, ref)),
                       launches=n_static)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"rc": rc, "summary": json.loads(text) if rc == 0 else {},
                   "launches": by_kind, "static": static_tier,
                   "walls": {"harness": wall,
                             "static": time.perf_counter() - t0 - wall}}, f)


def eval_phase(gguf_path: str, children: dict, failures: list) -> dict:
    """Slice 19: the evaluation entry points through their main(argv) on
    the card.
    (a) eval_full_agreement's child process, started with the utils-native
        phase: `token_agreement` with EVAL_FULL_ARGS (random weights at the
        published widths, the blank bias searched from EVAL_BLANK_BIAS, 4
        streams, R = 0 and 13): every configuration ran in each mode whose
        dense-f32 reference emitted, and R = 13's did; each
        configuration's agreement and flips; the launches of each run by
        ring type and matmul (the ring kernel on dense, int8 and int4
        rings, the W8A8 kernel dynamic). Then the static W8A8 tier of the
        full-width GGUF's dense weights: the W8A8 kernel static.
    (b) `compare_outputs` on the full-width Q8_0 GGUF over EVAL_CMP_SECONDS
        of audio, R = 13, here: exit 0, the [batch] and [streaming] lines
        equal to the CPU's run; the Q8 kernel launched in both designs
        (split-K in the session's steps, tiled in the batch pass), told
        by the geometry each launch took (q8_launch_geometry).
    (c) the trained fixtures: each EVAL_TONES entry point on the card
        (eval_tones_card's child, started with (a)'s) against its CPU run
        (a child process started with the TDT/CTC one): every f32 result
        equal; token_agreement's bf16 and int8 tiers within
        TOL_EVAL_AGREEMENT_PCT / TOL_EVAL_TER_PCT.
    children: {"full" | "tones" | "cpu": (process, the JSON it writes)}."""
    from nemotron_tpu_torch.ops import quant_kernel

    out: dict = {}
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    walls, t_part = {}, time.perf_counter()

    # (b) compare_outputs on the Q8_0 GGUF: both Q8 designs
    tmp = tempfile.mkdtemp(prefix="ev_")
    pcm_path = eval_cmp_pcm(os.path.join(tmp, "cmp.pcm"))
    res = {}
    designs = {"splitk": 0, "tiled": 0}
    plain_geometry = quant_kernel.q8_launch_geometry

    def tallied(M, K, N, sms):
        g = plain_geometry(M, K, N, sms)
        designs[g.design] += 1
        return g

    def compare():
        res["rc"], res["out"], _err = run_entry("compare_outputs", [
            gguf_path, pcm_path, "--right-context", "13"])

    quant_kernel.q8_launch_geometry = tallied
    try:
        _, n_cmp = counted(compare, launches)
    finally:
        quant_kernel.q8_launch_geometry = plain_geometry
    walls["b"], t_part = time.perf_counter() - t_part, time.perf_counter()
    shutil.rmtree(tmp, ignore_errors=True)

    # the children: (a), (c) on the card and the CPU runs
    cpu, full, tones = (finish_job(*children[k])
                        for k in ("cpu", "full", "tones"))
    walls["wait"] = time.perf_counter() - t_part
    cards = tones["runs"]
    for k in launches:
        launches[k] += tones["launches"][k]

    # (a) the harness at full width and the static tier (the child's run)
    summary, by_kind = full["summary"], full["launches"]
    for n in [*by_kind.values(), full["static"]["launches"]]:
        for k in launches:
            launches[k] += n[k]
    st = out["a_static"] = full["static"]
    if not (st["ref_tokens"] and st["launches"]["w8a8"]
            and st["launches"]["attn"]):
        failures.append(f"eval (a) w8a8-sq-static-bf16: {st}")
    # the harness skips a mode whose f32 reference emitted nothing (as the
    # JAX script does): every configuration ran in each mode it kept, and
    # it kept R = 13
    modes = {k.split("/")[0] for k in summary}
    want = {f"{m}/{c}" for m in modes | {"R13"} for c in (
        "dense-bf16", "w8a8-bf16", "w8a8-int8kv-bf16", "w8a8-int4kv-bf16",
        "shared-bf16", "w8a8-shared-int8kv-bf16", "w8a8-sq-bf16",
        "w8a8-sq-int8kv-bf16")}
    rings = {k.split()[0] for k, n in by_kind.items() if n["attn"]}
    ok = (full["rc"] == 0 and set(summary) == want
          and all(v["ref_tokens"] > 0 for v in summary.values())
          and {"dense", "int8", "int4"} <= rings
          and by_kind.get("int8 w8a8 bfloat16", {}).get("w8a8", 0) > 0)
    out["a"] = dict(rc=full["rc"], walls=full["walls"], launches=by_kind,
                    agreement={k: (v["agreement_pct"], v["runs"][0]["flips"],
                                   v["ref_tokens"])
                               for k, v in sorted(summary.items())})
    if not ok:
        failures.append(f"eval (a) token_agreement --full: exit {full['rc']},"
                        f" keys {sorted(summary)}, launches {by_kind}")
    log(f"  (a) token_agreement {' '.join(EVAL_FULL_ARGS)} (a child process "
        f"on the card, {full['walls']['harness']:.1f} s): exit {full['rc']}; "
        f"modes kept {sorted(modes)} (a mode whose f32 reference emits "
        f"nothing is skipped); "
        f"agreement % (flips / f32 reference tokens): " + "; ".join(
            f"{k} {a:.2f} ({fl}/{n})"
            for k, (a, fl, n) in out["a"]["agreement"].items()))
    for k, v in by_kind.items():
        log(f"      launches {k}: {json.dumps(v)}")
    log(f"  (a) w8a8-sq-static-bf16 (the GGUF's dense weights, R = 13, 4 "
        f"streams x {EVAL_SECONDS:g} s; the child, "
        f"{full['walls']['static']:.1f} s): agreement "
        f"{st['agreement_pct']:.2f}% ({st['flips']} flips / "
        f"{st['ref_tokens']} f32 tokens), launches "
        f"{json.dumps(st['launches'])}")

    lines = [ln for ln in res["out"].splitlines()
             if ln.startswith(("[batch]", "[streaming]"))]
    cpu_lines = [ln for ln in cpu["compare_outputs"][1].splitlines()
                 if ln.startswith(("[batch]", "[streaming]"))]
    ok = (res["rc"] == 0 and len(lines) == 2 and lines == cpu_lines
          and designs["splitk"] > 0 and designs["tiled"] > 0
          and n_cmp["q8"] == sum(designs.values()))
    out["b"] = dict(rc=res["rc"], same_as_cpu=lines == cpu_lines,
                    launches=n_cmp, designs=designs,
                    stats=res["out"].splitlines()[-1] if res["out"] else "")
    if not ok:
        failures.append(f"eval (b) compare_outputs: {out['b']}, card "
                        f"{[ln[:120] for ln in lines]}, CPU "
                        f"{[ln[:120] for ln in cpu_lines]}")
    log(f"  (b) compare_outputs, Q8_0 GGUF, {EVAL_CMP_SECONDS:g} s, R = 13: "
        f"exit {res['rc']}; [batch] and [streaming] equal to the CPU's "
        f"{lines == cpu_lines}; {out['b']['stats']}; launches "
        f"{json.dumps(n_cmp)}, Q8 by design {json.dumps(designs)}")
    out["c"] = {}
    for name, (rc, text) in cards.items():
        c_rc, c_text = cpu[name]
        try:
            got, want = eval_json(name, text), eval_json(name, c_text)
        except (ValueError, IndexError) as e:
            got, want = repr(e), None
        gaps = {}
        if name == "token_agreement" and isinstance(got, dict) \
                and isinstance(want, dict) and set(got) == set(want):
            gaps = {k: (abs(got[k]["agreement_pct"] - w["agreement_pct"]),
                        abs(got[k]["ter_pct"] - w["ter_pct"]))
                    for k, w in want.items()}
            same = (got["R13/f32-ref"] == want["R13/f32-ref"]
                    and all(got[k]["ref_tokens"] == w["ref_tokens"]
                            for k, w in want.items())
                    and all(a <= TOL_EVAL_AGREEMENT_PCT
                            and t <= TOL_EVAL_TER_PCT
                            for a, t in gaps.values()))
        else:
            same = got == want
        ok = rc == 0 and c_rc == 0 and same
        out["c"][name] = dict(ok=ok, equal=got == want, card=got)
        if not ok:
            failures.append(f"eval (c) {name}: exit {rc} (CPU {c_rc}), card "
                            f"{got} against CPU {want}")
        verdict = ("equal" if got == want else
                   "within tolerance" if ok else "DIFFERENT")
        brief = ({k: (v["agreement_pct"], v["ter_pct"])
                  for k, v in got.items()}
                 if name == "token_agreement" and isinstance(got, dict)
                 else got)
        log(f"  (c) {name}: card against --cpu {verdict}: "
            f"{json.dumps(brief)}")
        if gaps:
            log("      |card - CPU| (agreement, TER points): " + "; ".join(
                f"{k} {a:.2f}, {t:.2f}" for k, (a, t) in gaps.items()))
    log(f"  parts (s): {', '.join(f'{k} {v:.1f}' for k, v in walls.items())}"
        f" (wait: for the children after (b); (c) and (a) "
        f"{tones['wall']:.1f} and {sum(full['walls'].values()):.1f} s in "
        f"theirs)")
    out["launches"], out["walls"] = launches, walls
    return out


# ---------------------------------------------------------------------------
# phase 20: the numpy oracle and the parity ladder (slice 20)
# ---------------------------------------------------------------------------

# (b)'s NeMo-style checkpoint: the full-width GGUF's seeded weights (SEED,
# token 5's joint bias) cut to PARITY_LAYERS layers at the published widths
PARITY_LAYERS = 4
# (a): debug_conv_layers on the first and the last layer's conv module,
# debug_joint_trace over PARITY_TRACE_FRAMES frames
PARITY_CONV_LAYERS = (0, 23)
PARITY_TRACE_FRAMES = 8
# the ladder's stages that must pass (stage 5's agreements are held to the
# CPU's ladder within TOL_EVAL_AGREEMENT_PCT instead of its 95% bar: random
# weights sit on a blank-or-token edge)
PARITY_NEED = ("load", "stages", "greedy", "streaming R=13")
# the card's child of (b) waits at most this long for the CPU child's
# checkpoint (written within ~20 s of that child's start, some 400 s
# before)
PARITY_WAIT_S = 600


# the kernels' names in a profile, by the wrappers' count keys
KERNEL_NAMES = {"attn": "ring_attn_cluster_kernel", "q8": "q8_matmul",
                "w8a8": "w8a8_matmul"}


def counted_by_name(fn, launches: dict):
    """fn() under counted and profile_window: (its result, the wrappers'
    launches, the profile's launches by kernel name); the wrappers'
    launches are added to `launches`."""
    box = []
    prof, n = counted(lambda: profile_window(lambda: box.append(fn())),
                      launches)
    return box[0], n, {k: launches_of(prof, v)
                       for k, v in KERNEL_NAMES.items()}


def write_nemo_checkpoint(path: str) -> None:
    """(b)'s checkpoint: random_weight_arrays at SEED with token 5's joint
    bias (the full-width GGUF's weights, in NeMo's names and conv shapes)
    cut to PARITY_LAYERS layers, as a .nemo tar of model_weights.ckpt,
    model_config.yaml and tokenizer.vocab (t0 ... without the blank, which
    the converter appends); written to a temporary name and renamed."""
    import io
    import tarfile

    import torch

    from nemotron_tpu_torch.config import ModelConfig
    from nemotron_tpu_torch.params import random_weight_arrays

    cfg = ModelConfig()
    arrays = random_weight_arrays(cfg, seed=SEED)
    arrays["joint.joint_net.2.bias"][5] = 2.0
    keep = {n: torch.from_numpy(a) for n, a in arrays.items()
            if not n.startswith("encoder.layers.")
            or int(n.split(".")[2]) < PARITY_LAYERS}
    ckpt = io.BytesIO()
    torch.save(keep, ckpt)
    config = (f"encoder:\n  d_model: {cfg.d_model}\n  n_heads: "
              f"{cfg.n_heads}\n  n_layers: {PARITY_LAYERS}\n")
    vocab = "".join(f"t{i}\t0.0\n" for i in range(cfg.vocab_size - 1))
    with tarfile.open(path + ".part", "w") as tar:
        for name, data in (("model_config.yaml", config.encode()),
                           ("model_weights.ckpt", ckpt.getvalue()),
                           ("tokenizer.vocab", vocab.encode())):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    os.replace(path + ".part", path)


def check_converted(path: str, want: dict) -> dict:
    """A converted GGUF's tensors against the checkpoint's (`want`, after
    convert_conv_weights): F32 tensors equal, Q8_0 tensors equal to the
    source's own Q8_0 round trip (quantize_q8_0, dequantize_q8_0: the
    block rounding), and the largest |tensor - source| of the Q8_0 ones."""
    from nemotron_tpu_torch import gguf

    g = gguf.read_gguf(path)
    n_f32 = n_q8 = 0
    q8_err = 0.0
    bad = [n for n in g.tensors if n not in want]
    for name, a in want.items():
        t = g.tensors.get(name)
        got = None if t is None else t.to_numpy()
        if got is None or got.shape != a.shape:
            bad.append(name)
        elif t.ggml_type == gguf.GGML_F32:
            n_f32 += np.array_equal(got, a)
        elif t.ggml_type == gguf.GGML_Q8_0:
            ref = gguf.dequantize_q8_0(gguf.quantize_q8_0(a), a.size)
            n_q8 += np.array_equal(got, ref.reshape(a.shape))
            q8_err = max(q8_err, float(np.abs(got - a).max()))
        else:
            bad.append(name)
    ok = not bad and n_f32 + n_q8 == len(want)
    return dict(ok=ok, tensors=len(g.tensors), f32_equal=n_f32,
                q8_0_equal=n_q8, q8_0_max_abs=q8_err, bad=bad[:4])


def parity_conversions(nemo_path: str, out_dir: str, cpu: bool) -> dict:
    """(b)'s converters through their main (with --cpu for the CPU's
    side): convert_to_gguf unquantized and with --quantize q8_0,
    convert_weights .nemo -> NEMO bin -> GGUF. Each output is held to the
    checkpoint's tensors (check_converted; the bin to the raw state dict,
    exactly); the files' sha256 let the card's side be held to the CPU's
    byte for byte."""
    import hashlib

    from nemotron_tpu_torch.scripts.convert_to_gguf import (
        convert_conv_weights, load_checkpoint)
    from nemotron_tpu_torch.utils.nemo_bin import read_nemo_bin

    flag = ["--cpu"] if cpu else []
    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, f"parity_{k}")
             for k in ("f32.gguf", "q8_0.gguf", "bin", "bin.gguf")}
    t0 = time.perf_counter()
    rcs = [run_entry(name, args + flag)[0] for name, args in (
        ("convert_to_gguf", [nemo_path, paths["f32.gguf"]]),
        ("convert_to_gguf", [nemo_path, paths["q8_0.gguf"], "--quantize",
                             "q8_0"]),
        ("convert_weights", [nemo_path, paths["bin"]]),
        ("convert_weights", [paths["bin"], paths["bin.gguf"]]))]
    wall = time.perf_counter() - t0
    raw, _vocab, _config = load_checkpoint(nemo_path)
    want = convert_conv_weights(raw)
    checks = {k: check_converted(paths[k], want)
              for k in ("f32.gguf", "q8_0.gguf", "bin.gguf")}
    b = read_nemo_bin(paths["bin"])
    checks["bin"] = dict(ok=set(b) == set(raw) and all(
        np.array_equal(b[n], raw[n]) for n in raw), tensors=len(b))
    sha = {}
    for k, p in paths.items():
        with open(p, "rb") as f:
            sha[k] = hashlib.file_digest(f, "sha256").hexdigest()
    return dict(rcs=rcs, checks=checks, sha256=sha, wall=wall,
                gguf=paths["f32.gguf"])


def parity_ladder_side(nemo_path: str, out_dir: str, cpu: bool) -> dict:
    """(b) on the CPU's side (cpu: it writes the checkpoint first,
    write_nemo_checkpoint, and passes --cpu) or on the card's (it waits for
    the CPU child's checkpoint): the conversions (parity_conversions) and
    `run_parity --quick` on the unquantized GGUF, the card's launches
    counted. Returns
    the conversions, the ladder's exit code, stdout, stderr and launches,
    its wall and the wait."""
    t0 = time.perf_counter()
    if cpu:
        write_nemo_checkpoint(nemo_path)
    while not os.path.exists(nemo_path):
        if time.perf_counter() - t0 > PARITY_WAIT_S:
            raise RuntimeError(f"no checkpoint {nemo_path} after "
                               f"{PARITY_WAIT_S} s")
        time.sleep(1.0)
    waited = time.perf_counter() - t0
    flag = ["--cpu"] if cpu else []
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    conv = parity_conversions(nemo_path, out_dir, cpu)
    t1 = time.perf_counter()

    def ladder():
        return run_entry("run_parity", [conv["gguf"], "--quick", *flag])

    (rc, out, err), _ = (ladder(), None) if cpu else counted(ladder,
                                                             launches)
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"conversions": conv, "rc": rc, "out": out, "err": err,
            "launches": launches, "wall": time.perf_counter() - t1,
            "waited": waited}


def parity_cpu_child(nemo_path: str, out_dir: str, out_path: str) -> None:
    """(b)'s CPU side (parity_ladder_side with --cpu) in a child process
    started with the other CPU references; as JSON."""
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(parity_ladder_side(nemo_path, out_dir, cpu=True), f)


def parity_card_child(gguf_path: str, nemo_path: str, out_dir: str,
                      out_path: str) -> None:
    """(a)'s tool runs and (b)'s card side in a child process on the card,
    started before the multi-GPU phase.
    (a): run_parity --quick, debug_conv_layers at each PARITY_CONV_LAYERS
    and debug_joint_trace --frames PARITY_TRACE_FRAMES on the full-width
    GGUF, the tools sharing one load of it (scripts.sharing_loads), each
    run's launches counted (the ladder's also by name, counted_by_name):
    {run: [exit code, stdout, stderr, launches]}. As JSON: (a), the
    ladder's launches by name, its wall, (b)."""
    from nemotron_tpu_torch.scripts import sharing_loads

    runs = {"run_parity": [gguf_path, "--quick"],
            **{f"debug_conv_layers {layer}": [gguf_path, "--layer",
                                              str(layer)]
               for layer in PARITY_CONV_LAYERS},
            "debug_joint_trace": [gguf_path, "--frames",
                                  str(PARITY_TRACE_FRAMES)]}
    t0 = time.perf_counter()
    a, by_name = {}, None
    with sharing_loads():
        for key, args in runs.items():
            n = {"attn": 0, "q8": 0, "w8a8": 0}

            def run():
                return run_entry(key.split()[0], args)

            if key == "run_parity":
                res, _, by_name = counted_by_name(run, n)
            else:
                res, _ = counted(run, n)
            a[key] = [*res, n]
    wall = time.perf_counter() - t0
    b = parity_ladder_side(nemo_path, out_dir, cpu=False)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"a": a, "a_by_name": by_name, "a_wall": wall, "b": b}, f)


def ladder_rows(out: str) -> dict:
    """run_parity's PASS/FAIL table: {stage: (passed, detail)}."""
    import re

    rows, inside = {}, False
    for ln in out.splitlines():
        if ln.startswith("==== parity ladder"):
            inside = True
        elif ln.startswith("===="):
            inside = False
        elif inside:
            m = re.match(r"  (.+?)\s+(PASS|FAIL)  (.*)$", ln)
            if m:
                rows[m.group(1)] = (m.group(2) == "PASS", m.group(3))
    return rows


def stage_errors(text: str) -> list:
    """The per-stage lines of compare_layers / debug_conv_layers in
    `text`: [(flag, stage, max_abs)]."""
    import re

    return [(m.group(1).strip(), m.group(2).strip(), float(m.group(3)))
            for m in re.finditer(r"\[(OK |DIFF|SHAPE)\] (.+?)\s+max_abs "
                                 r"(\S+)", text)]


def agreement_of(detail: str) -> float | None:
    """A quant stage's token agreement in percent."""
    import re

    m = re.search(r"token agreement ([0-9.]+)%", detail)
    return float(m.group(1)) if m else None


def parity_full_width(runs: dict, by_name: dict, out: dict, launches: dict,
                      failures: list) -> None:
    """parity_phase's (a) from the card child's tool runs (`runs`; the
    ladder's launches by kernel name `by_name`), its results into `out`,
    its launches into `launches`. Every check is the card's against the
    numpy oracle, and one that fails is a failure of the run."""
    rc, text, err, n_a = runs["run_parity"]
    rows = ladder_rows(text)
    bad = [s for s in PARITY_NEED if not rows.get(s, (False,))[0]]
    stages = stage_errors(err)
    out["a_ladder"] = dict(rc=rc, rows=rows, launches=n_a, by_name=by_name,
                           stages=stages)
    log(f"  (a) run_parity --quick, full-width Q8_0 GGUF (24 layers): exit "
        f"{rc}; launches {json.dumps(n_a)}, in the profile by kernel name "
        f"{json.dumps(by_name)}")
    for s, (ok, detail) in rows.items():
        log(f"      {s}: {'PASS' if ok else 'FAIL'} {detail}")
    for flag, name, e in stages:
        log(f"      [{flag}] {name}: max_abs {e:.3e}")
    if not (n_a["attn"] and n_a["q8"]) or by_name != n_a:
        failures.append(f"parity (a): launches {n_a}, by name {by_name}")
    if rc or bad:
        failures.append(f"parity (a) run_parity: exit {rc}, {bad} not PASS")

    for layer in PARITY_CONV_LAYERS:
        rc, text, _err, n = runs[f"debug_conv_layers {layer}"]
        st = stage_errors(text)
        worst = text.strip().splitlines()[-1] if text.strip() else ""
        out[f"a_conv_{layer}"] = dict(rc=rc, stages=st, worst=worst,
                                      launches=n)
        log(f"  (a) debug_conv_layers --layer {layer}: exit {rc}; {worst}; "
            + ", ".join(f"{name} {e:.2e}" for _f, name, e in st))
        flags = [f for f in ("DIFF", "SHAPE") if f"[{f}]" in text]
        if rc or flags or not st:
            failures.append(f"parity (a) debug_conv_layers --layer {layer}: "
                            f"exit {rc}, flags {flags}")

    rc, text, _err, n = runs["debug_joint_trace"]
    lines = text.strip().splitlines() or [""]
    out["a_trace"] = dict(rc=rc, steps=len(lines) - 1, last=lines[-1],
                          launches=n)
    log(f"  (a) debug_joint_trace --frames {PARITY_TRACE_FRAMES}: exit {rc}; "
        f"{len(lines) - 1} symbol steps; {lines[-1]}")
    if rc or "no divergence" not in lines[-1]:
        failures.append(f"parity (a) debug_joint_trace: exit {rc}, "
                        f"{lines[-1]}")
    for run in runs.values():
        for k in launches:
            launches[k] += run[3][k]


def parity_phase(children: dict, failures: list) -> dict:
    """Slice 20: the numpy oracle (nemotron_tpu_torch.oracle) and the
    parity tools through their main(argv) on the card, in two child
    processes: the CPU's (parity_cpu_child), started with the other CPU
    references, and the card's (parity_card_child), started before the
    multi-GPU phase.
    (a) The full-width Q8_0 GGUF (24 layers, dequantized for the oracle;
        one load shared by the tools): `run_parity --quick`: load, stages
        (compare_layers: subsampling, encoder, decoder step, joint, a
        streaming chunk at R = 13 through the ring kernel), greedy (tokens
        exact against the oracle) and streaming R=13 (compare_outputs: the
        Q8 kernel) PASS, exit 0; each stage's max_abs logged; the ring
        and Q8 kernels launched, as many times by the wrappers' counts as
        by name in a profile of the ladder.
        `debug_conv_layers --layer L` for PARITY_CONV_LAYERS: no DIFF;
        `debug_joint_trace --frames PARITY_TRACE_FRAMES`: no divergence.
    (b) The NeMo-style checkpoint (write_nemo_checkpoint, by the CPU
        child): convert_to_gguf (f32, q8_0) and convert_weights (.nemo ->
        bin -> gguf) on the card's side: every converted tensor equal to
        the checkpoint's (Q8_0: its block rounding), every file equal to
        the CPU's byte for byte; `run_parity --quick` on the f32 GGUF:
        PARITY_NEED PASS, and stage 5's agreements (q8_0, w8a8, with int8
        and int4 rings: the Q8 and W8A8 kernels, the ring kernel on three
        ring types) within TOL_EVAL_AGREEMENT_PCT of the CPU's ladder (not
        its 95% bar); the three kernels launched.
    Stage 5 alone is held to the CPU: random weights put its tokens on a
    blank-or-token edge, on the CPU as on the card. Every other check is
    the card's against the oracle, and one that fails fails the run.
    children: {"cpu" | "card": (process, the JSON it writes)}."""
    out: dict = {}
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    t0 = time.perf_counter()
    cpu, child = (finish_job(*children[k]) for k in ("cpu", "card"))
    walls = {"wait": time.perf_counter() - t0, "card_a": child["a_wall"],
             "card_b": child["b"]["wall"], "cpu_b": cpu["wall"]}
    parity_full_width(child["a"], child["a_by_name"], out, launches,
                      failures)

    # (b) the NeMo-style checkpoint: the children's conversions and ladders
    card = child["b"]
    conv = card["conversions"]
    same_bytes = conv["sha256"] == cpu["conversions"]["sha256"]
    ok = (conv["rcs"] == [0] * 4 and same_bytes
          and all(c["ok"] for c in conv["checks"].values()))
    out["b_conversions"] = dict(rcs=conv["rcs"], checks=conv["checks"],
                                same_bytes_as_cpu=same_bytes,
                                wall=conv["wall"])
    log(f"  (b) {PARITY_LAYERS}-layer full-width .nemo (the card's child, "
        f"{card['waited']:.1f} s waiting for the checkpoint): convert_to_gguf"
        f" (f32, q8_0), convert_weights (.nemo -> bin -> gguf) in "
        f"{conv['wall']:.1f} s: exits {conv['rcs']}; files equal to the CPU "
        f"child's byte for byte {same_bytes}")
    for k, c in conv["checks"].items():
        log(f"      {k}: {json.dumps(c)}")
    if not ok:
        failures.append(f"parity (b) conversions: {out['b_conversions']}")
    rc, text, err, n_b = card["rc"], card["out"], card["err"], \
        card["launches"]
    for k in launches:
        launches[k] += n_b[k]
    rows, cpu_rows = ladder_rows(text), ladder_rows(cpu["out"])
    bad = [s for s in PARITY_NEED if not rows.get(s, (False,))[0]]
    quant = {s: (agreement_of(d), agreement_of(cpu_rows.get(s, (0, ""))[1]))
             for s, (_ok, d) in rows.items() if s.startswith("quant ")}
    gaps = {s: abs(a - c) for s, (a, c) in quant.items()
            if a is not None and c is not None}
    out["b_ladder"] = dict(rc=rc, cpu_rc=cpu["rc"], rows=rows,
                           quant=quant, launches=n_b,
                           stages=stage_errors(err),
                           cpu_stages=stage_errors(cpu["err"]))
    log(f"  (b) run_parity --quick on the converted f32 GGUF: exit {rc} "
        f"({card['wall']:.1f} s; the --cpu child: exit {cpu['rc']}, "
        f"{cpu['wall']:.1f} s); launches {json.dumps(n_b)}")
    for s, (ok, detail) in rows.items():
        log(f"      {s}: {'PASS' if ok else 'FAIL'} {detail}"
            + (f" | CPU {cpu_rows[s][1]}" if s in cpu_rows else ""))
    for (flag, name, e), (_f, _n, ce) in zip(out["b_ladder"]["stages"],
                                              out["b_ladder"]["cpu_stages"]):
        log(f"      [{flag}] {name}: max_abs {e:.3e} (CPU {ce:.3e})")
    if bad:
        failures.append(f"parity (b) run_parity: {bad} not PASS")
    for s, (ok, _d) in rows.items():
        if s.startswith("quant ") and not ok and not cpu_rows.get(
                s, (True,))[0]:
            log(f"  FINDING: (b) {s} is under the 95% bar on the CPU too: "
                f"the random model's blank-or-token edge, not the card's")
    if (len(gaps) != 4 or set(quant) != {s for s in cpu_rows
                                          if s.startswith("quant ")}
            or max(gaps.values()) > TOL_EVAL_AGREEMENT_PCT):
        failures.append(f"parity (b) stage 5, card against CPU: {quant}")
    if not (n_b["attn"] and n_b["q8"] and n_b["w8a8"]):
        failures.append(f"parity (b): launches {n_b}")
    log(f"  parts (s): {', '.join(f'{k} {v:.1f}' for k, v in walls.items())}"
        f" (wait: for the children; card_a, card_b, cpu_b: the parts' walls "
        f"in theirs)")
    out["launches"], out["walls"] = launches, walls
    return out


def kernels_line(res: dict, q8_m_star: int, w8a8_m_star: int) -> list:
    """The `kernels` JSON of a whole run: each kernel's launches on the
    main paths (every phase's count), its time, plain time, bound and
    library time from the kernel phases, at the shapes the rows name."""
    attn, q8, w8 = res["attention"], res["q8"], res["w8a8"]
    runs, w8_runs, full = res["main-path"], res["w8a8-path"], \
        res["full-utterance"]
    engine, server, quant = res["engine"], res["server"], res["quant"]
    lock, beam, tdt = res["lockstep"], res["beam"], res["tdt-ctc"]
    tones, engine_tones = res["tones"], res["engine-tones"]
    server_tones, tones_quant = res["server-tones"], res["tones-quant"]
    beam_tones, tdt_tones = res["beam-tones"], res["tdt-tones"]
    mgpu, utils_native = res["multi-gpu"], res["utils-native"]
    evaluation, parity = res["eval"], res["parity"]
    server_n = {k: server["q8_f32"]["launches"][k]
                + server["w8a8_bf16"]["launches"][k]
                + server_tones["launches"][k] for k in ("attn", "q8", "w8a8")}
    engine_n = {k: engine["launches"][k] + engine_tones["launches"][k]
                + server_n[k] + quant["launches"][k]
                + tones_quant["launches"][k] + lock["launches"][k]
                + beam["launches"][k] + beam_tones["launches"][k]
                + tdt["launches"][k] + tdt_tones["launches"][k]
                + mgpu["launches"][k] + utils_native["launches"][k]
                + evaluation["launches"][k] + parity["launches"][k]
                for k in engine["launches"]}

    def w8_layer(M, mode=()):
        rows = [(w8[(*mode, M, K, N)], c) for (K, N), c in Q8_SHAPES.items()]
        keys = [k for k, v in rows[0][0].items()
                if isinstance(v, float) and k != "max_abs_err"] + ["bytes",
                                                                   "ops"]
        t = {k: sum(r[k] * c for r, c in rows) for k in keys}
        # the layer's library time: the faster weight layout for the layer
        t["library_ms"] = min(t["int_mm_kn_ms"], t["int_mm_cm_ms"])
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["ops"] / PEAK_FLOPS["int8"] else "operations")
        t["design"] = rows[0][0]["design"]
        return t

    w8_112 = w8_layer(112)
    a13 = attn[13]

    def q8_layer(M):
        keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops",
                "splitk_ms") + (("tiled_ms",) if M in Q8_CROSSOVER_MS else ())
        t = {k: sum(q8[(M, K, N)][k] * c for (K, N), c in Q8_SHAPES.items())
             for k in keys}
        t["design"] = q8[(M, 1024, 1024)]["design"]
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["flops"] / PEAK_FLOPS["float32"]
                         else "operations")
        return t

    layer_ms = q8_layer(14)
    tones_n = tones["launches"]
    attn_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "max_abs_err")
    kernels = [
        {"name": "fused_ring_attention", "route": "cuda",
         "source": "nemotron_tpu_torch/csrc/ring_attn.cu",
         "replaces": "nemotron_tpu/ops/ring_attn_kernel.py:87",
         "launches": sum(r["attn_launches"] for r in runs.values())
         + sum(r["attn_launches"] for r in w8_runs.values())
         + tones_n["attn"] + engine_n["attn"],
         "max_abs_err": a13["max_abs_err"], "ms": a13["ms"],
         "plain_ms": a13["plain_ms"], "bound_ms": a13["bound_ms"],
         "bound_by": a13["bound_by"], "library_ms": a13["library_ms"],
         "shape": "one call, B=1 H=8 Q=14 KV=84 Dh=128 f32 dense rings",
         "modes": {f"R={R}": {k: attn[R][k] for k in ("Q", "KV") + attn_keys}
                   for R in MODES},
         "w8a8_variant": {k: attn["w8a8"][k] for k in attn_keys}
         | {"shape": "one call, B=8 H=8 Q=14 KV=84 Dh=128 bf16 int8 rings; "
                     "no library call computes it"},
         "engine_w8a8": {k: attn["engine_w8a8"][k] for k in attn_keys}
         | {"shape": "one call, B=64 (engine slots) H=8 Q=14 KV=84 Dh=128 "
                     "bf16 int8 rings; no library call computes it"},
         "engine_f32": {k: attn["engine_f32"][k] for k in attn_keys}
         | {"shape": "one call, B=64 (engine slots) H=8 Q=14 KV=84 Dh=128 "
                     "f32 dense rings"},
         "int4_variant": {k: attn["int4"][k] for k in attn_keys}
         | {"shape": "one call, B=8 H=8 Q=14 KV=84 Dh=128 bf16 int4 rings "
                     "(packed two a byte); no library call computes it"},
         "engine_int4": {k: attn["engine_int4"][k] for k in attn_keys}
         | {"shape": "one call, B=64 (engine slots) H=8 Q=14 KV=84 Dh=128 "
                     "bf16 int4 rings; no library call computes it"},
         "model_parallel_2": {k: attn["mp2_f32"][k] for k in attn_keys}
         | {"shape": "one call, B=64 (engine slots) H=4 (a model-parallel-2 "
                     "rank's heads) Q=14 KV=84 Dh=128 f32 dense rings"}},
        {"name": "q8_matmul", "route": "cuda",
         "source": "nemotron_tpu_torch/csrc/q8_matmul.cu",
         "replaces": "nemotron_tpu/ops/quant_kernel.py:58",
         "launches": sum(r["q8_launches"] for r in runs.values())
         + full["launches"]["q8"] + engine_n["q8"],
         "max_abs_err": max(v["max_abs_err"] for (m, _, _), v in q8.items()
                            if m == 14),
         "ms": layer_ms["ms"], "plain_ms": layer_ms["plain_ms"],
         "bound_ms": layer_ms["bound_ms"], "bound_by": layer_ms["bound_by"],
         "library_ms": layer_ms["library_ms"],
         "shape": "one layer's 10 calls, M=14 f32: (K,N) 5x(1024,1024) "
                  "2x(1024,4096) 2x(4096,1024) 1x(1024,2048)",
         "per_m": {f"M={M}": {k: v for k, v in q8_layer(M).items()
                              if k not in ("bytes", "flops")}
                   for M in (1, 14, *Q8_CROSSOVER_MS)},
         "m_star": q8_m_star,
         "model_parallel_2": {
             f"{what} ({K},{N})": {k: q8[(ENGINE_M, K, N)][k] for k in (
                 "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "design", "max_abs_err")}
             for (K, N), what in LOCAL_SHAPES.items()}
         | {"shape": "one call at M=896 (64 slots x 14), f32: a "
                     "model-parallel-2 rank's (K,N)"},
         "designs": "splitk (split-K cluster) for M <= m_star, tiled (128 x "
                    "128 tiles, dequantized once a block) above; per_m gives "
                    "both designs' layer times at the crossover rows"},
        {"name": "w8a8_matmul", "route": "cuda",
         "source": "nemotron_tpu_torch/csrc/w8a8_matmul.cu",
         "replaces": "nemotron_tpu/ops/w8a8_kernel.py:52",
         "launches": sum(r["w8a8_launches"] for r in w8_runs.values())
         + tones_n["w8a8"] + engine_n["w8a8"],
         "max_abs_err": w8["max_abs_err"],
         "ms": w8_112["ms"], "plain_ms": w8_112["plain_ms"],
         "bound_ms": w8_112["bound_ms"], "bound_by": w8_112["bound_by"],
         "library_ms": w8_112["library_ms"],
         "shape": "one layer's 10 calls, M=112 (8 streams x 14) bf16: same "
                  "(K,N); one kernel launch a call; library = torch._int_mm "
                  "on pre-quantized int8 activations, without the quantize "
                  "and rescale (rows padded to 32 below M = 17), the faster "
                  "of the [K, N] weight and a column-major copy",
         "per_m": {f"M={M}": {k: v for k, v in w8_layer(M).items()
                              if k not in ("bytes", "ops")}
                   for M in (8, *W8A8_CROSSOVER_MS)}
         | {"M=672 call": {k: w8[(672, 1024, 1024)][k]
                           for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "design",
                                     "splitk_ms", "tiled_ms", "int_mm_kn_ms",
                                     "int_mm_cm_ms")}
            | {"shape": "one call, (K,N) = (1024,1024)"}},
         "static_per_m": {f"M={M}": {k: v for k, v in
                                     w8_layer(M, ("static",)).items()
                                     if k not in ("bytes", "ops")}
                          for M in (8, *W8A8_CROSSOVER_MS)},
         "static_shape": "one layer's 10 calls, bf16, static activation "
                         "scale (SmoothQuant); library = the same _int_mm",
         "m_star": w8a8_m_star,
         "model_parallel_2": {
             f"{what} ({K},{N}){' static' if mode else ''}": {
                 k: w8[(*mode, ENGINE_M, K, N)][k] for k in (
                     "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                     "design", "max_abs_err")}
             for (K, N), what in W8A8_LOCAL_SHAPES.items()
             for mode in ((), ("static",))}
         | {"shape": "one call at M=896 (64 slots x 14), bf16: a "
                     "model-parallel-2 rank's FFN (K,N), dynamic and "
                     "static"},
         "designs": "splitk (split-K clusters of up to 8 blocks, each "
                    "quantizing its own slice of x) for M <= m_star, tiled "
                    "(128 x 128 tiles, x quantized once a block for 128 "
                    "columns) above; per_m gives both designs' layer times "
                    "at the crossover rows"},
    ]
    return kernels


# the phases in the order a whole run takes them, by the name that
# `--phase NAME` gives; the full-width GGUF, the TDT/CTC GGUF and the CPU
# reference jobs are made for the chosen phases that need them
PHASES = {
    "attention": "attention kernel",
    "q8": "Q8 kernel",
    "w8a8": "W8A8 kernel",
    "main-path": "Q8_0 main path",
    "w8a8-path": "W8A8 path",
    "full-utterance": "full utterance",
    "engine": "serving engine (slice 8)",
    "server": "server (slice 9)",
    "quant": "quant tiers and snapshots (slice 10)",
    "lockstep": "lockstep, cohorts and serve (slice 13)",
    "beam": "beam family (slice 14)",
    "tdt-ctc": "TDT and CTC (slice 15)",
    "multi-gpu": "multi-GPU (slice 17)",
    "utils-native": "dump tracing, profiler, native bindings, mesh beam "
                    "(slice 18)",
    "eval": "evaluation entry points (slice 19)",
    "parity": "oracle and parity ladder (slice 20)",
    "training": "training (slice 16)",
    "tones": "tones",
    "engine-tones": "serving engine tones (slice 8)",
    "server-tones": "server tones (slice 9)",
    "clis": "CLIs and server entry points (slice 9)",
    "tones-quant": "tones quant tiers (slice 10)",
    "clis-quant": "CLIs and server with the quant flags (slice 10)",
    "beam-tones": "beam family on the trained fixtures (slice 14)",
    "tdt-tones": "TDT and CTC on the trained fixtures (slice 15)",
    "training-tones": "training on the trained fixture and the tiny config "
                      "(slice 16)",
}
FULL_WIDTH_PHASES = ("main-path", "w8a8-path", "full-utterance", "engine",
                     "server", "quant", "lockstep", "beam", "training",
                     "multi-gpu", "utils-native", "eval", "parity")


def chosen_phases(argv: list[str]) -> set | None:
    """The phases named by `--phase NAME` (repeatable; `--phase=NAME` too),
    or None (every phase) without one. An unknown name raises
    SystemExit(2)."""
    names, i = [], 0
    while i < len(argv):
        a = argv[i]
        if a == "--phase" and i + 1 < len(argv):
            names.append(argv[i + 1])
            i += 2
            continue
        if a.startswith("--phase="):
            names.append(a.split("=", 1)[1])
        else:
            print(f"error: unknown argument {a!r}; usage: chip_smoke.py "
                  f"[--phase NAME ...], NAME one of {', '.join(PHASES)}",
                  file=sys.stderr)
            raise SystemExit(2)
        i += 1
    bad = [n for n in names if n not in PHASES]
    if bad:
        print(f"error: unknown phase {', '.join(bad)}; one of "
              f"{', '.join(PHASES)}", file=sys.stderr)
        raise SystemExit(2)
    return set(names) if names else None


def main() -> int:
    want = chosen_phases(sys.argv[1:])
    try:
        import torch
    except ImportError:
        print("error: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nemotron_tpu_torch.ops import cuda_build
    from nemotron_tpu_torch.device import resolve_device
    from nemotron_tpu_torch.ops.quant_kernel import SPLITK_MAX_M
    from nemotron_tpu_torch.ops.w8a8_kernel import \
        SPLITK_MAX_M as W8A8_SPLITK_MAX_M

    t_start = time.perf_counter()
    resolve_device("cuda")
    card = gpu_name_and_power()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x {torch.cuda.device_count()}")
    if want is not None:
        log(f"phases: {', '.join(n for n in PHASES if n in want)}")

    t0 = time.perf_counter()
    cuda_build.build_all()
    log(f"phase build: {', '.join(cuda_build.KERNELS)} built for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")

    failures: list[str] = []
    res: dict = {}

    def chosen(key):
        return want is None or key in want

    def phase(key, fn, *args):
        if not chosen(key):
            return None
        t0 = time.perf_counter()
        res[key] = fn(*args, failures)
        log(f"phase {PHASES[key]}: wall {time.perf_counter() - t0:.1f} s")
        return res[key]

    with tempfile.TemporaryDirectory() as tmp:
        # the full-width GGUF is written by a child process while the
        # kernel phases run on the card
        path = os.path.join(tmp, "full_width_q8.gguf")
        full = any(chosen(k) for k in FULL_WIDTH_PHASES)
        t0 = time.perf_counter()
        gguf_job = (start_cpu_job("write_full_width_gguf", path) if full
                    else None)
        phase("attention", attention_phase)
        phase("q8", q8_phase)
        phase("w8a8", w8a8_phase)
        if gguf_job is not None:
            _, err = gguf_job.communicate()
            if gguf_job.returncode:
                raise RuntimeError(f"writing the GGUF: exit "
                                   f"{gguf_job.returncode}: {err[-2000:]}")
            log(f"phase main path: {os.path.getsize(path) / 2 ** 30:.2f} GiB"
                f" GGUF written by a child process beside the kernel phases, "
                f"ready {time.perf_counter() - t0:.1f} s after its start")
        jobs = []

        def job(key, fn, *args, threads=4):
            """A CPU reference child for phase `key`, if it runs."""
            if not chosen(key):
                return None
            jobs.append(start_cpu_job(fn, *args, threads=threads))
            return jobs[-1]

        try:
            # the W8A8 path's and the full utterance's CPU runs: child
            # processes beside the card's work from the main path on
            w8_ref = os.path.join(tmp, "w8a8_ref.pt")
            fu_ref = os.path.join(tmp, "full_utterance_ref.pt")
            w8_job = job("w8a8-path", "cpu_w8a8_reference", path, w8_ref,
                         threads=5)
            fu_job = job("full-utterance", "cpu_full_utterance_reference",
                         path, fu_ref, threads=3)
            phase("main-path", main_path_phase, path)
            phase("w8a8-path", w8a8_path_phase, path, w8_job, w8_ref)
            phase("full-utterance", full_utterance_phase, path, fu_job,
                  fu_ref)
            phase("engine", engine_phase, path)
            phase("server", server_phase, path)
            phase("quant", quant_tier_phase, path)
            # the TDT/CTC GGUF is written, and decoded on the CPU, by a
            # child process while the lockstep and beam phases run
            tdt_path = os.path.join(tmp, "full_width_tdt_ctc.gguf")
            tdt_ref = os.path.join(tmp, "tdt_ctc_ref.json")
            tdt_job = (start_cpu_job("cpu_tdt_ctc_reference", tdt_path,
                                     tdt_ref)
                       if chosen("tdt-ctc") or chosen("training") else None)
            jobs.append(tdt_job)
            # the eval phase's CPU runs (the trained fixtures' entry points
            # and compare_outputs at full width) beside the phases up to it
            ev_ref = os.path.join(tmp, "eval_ref.json")
            ev_job = job("eval", "cpu_eval_reference", path,
                         os.path.join(tmp, "eval_cmp.pcm"), ev_ref, threads=2)
            # the parity phase's checkpoint, its conversions and its ladder
            # with --cpu, beside the phases up to it
            nemo_path = os.path.join(tmp, "parity.nemo")
            par_cpu = os.path.join(tmp, "parity_cpu.json")
            par_children = {"cpu": (job(
                "parity", "parity_cpu_child", nemo_path,
                os.path.join(tmp, "parity_cpu"), par_cpu, threads=2),
                par_cpu)}
            phase("lockstep", lockstep_phase, path)
            phase("beam", beam_phase, path)
            # the training phase's CPU reference (a 2-layer cut of the
            # same GGUF) runs beside the TDT and CTC phase
            train_ref = os.path.join(tmp, "training_ref.json")
            train_job = job("training", "cpu_training_reference", path,
                            train_ref)
            phase("tdt-ctc", tdt_ctc_phase, tdt_path, tdt_job, tdt_ref,
                  res.get("w8a8-path", {}))
            # the parity phase's tool runs, conversions and ladder: a child
            # process on the card beside the multi-GPU, utils-native and
            # eval phases (it takes ~45-100 s; beside utils-native alone it
            # outlasted the eval phase by up to 29 s)
            par_card = os.path.join(tmp, "parity_card.json")
            par_children["card"] = (job(
                "parity", "parity_card_child", path, nemo_path,
                os.path.join(tmp, "parity_card"), par_card, threads=2),
                par_card)
            phase("multi-gpu", multi_gpu_phase, path)
            # the eval phase's full-width harness and its runs of the
            # trained fixtures: child processes on the card beside the
            # utils-native phase (which waits on its own children)
            ev_full = os.path.join(tmp, "eval_full.json")
            ev_tones = os.path.join(tmp, "eval_tones.json")
            ev_children = {
                "cpu": (ev_job, ev_ref),
                "full": (job("eval", "eval_full_agreement", path, ev_full,
                             threads=2), ev_full),
                "tones": (job("eval", "eval_tones_card", ev_tones,
                              threads=1), ev_tones)}
            phase("utils-native", utils_native_phase, path)
            phase("eval", eval_phase, path, ev_children)
            phase("parity", parity_phase, par_children)
            if chosen("training") and not chosen("tdt-ctc"):
                finish_job(tdt_job, tdt_ref)     # the TDT GGUF is written
            full_width_model.cache_clear()
            full_width_w8a8.cache_clear()
            phase("training", training_phase, path, tdt_path, train_job,
                  train_ref)
        finally:
            for j in jobs:
                if j is not None and j.poll() is None:
                    j.kill()
                    j.communicate()
        full_width_model.cache_clear()
    for key, fn in (("tones", tones_phase),
                    ("engine-tones", engine_tones_phase),
                    ("server-tones", server_tones_phase),
                    ("clis", cli_phase),
                    ("tones-quant", tones_quant_phase),
                    ("clis-quant", cli_quant_phase),
                    ("beam-tones", beam_tones_phase),
                    ("tdt-tones", tdt_ctc_tones_phase),
                    ("training-tones", training_tones_phase)):
        phase(key, fn)
    for key, value in res.items():
        if key not in ("attention", "q8", "w8a8"):   # logged line by line
            log(f"{PHASES[key]}: " + json.dumps(value, default=str))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    if want is None:
        print(json.dumps({"kernels": kernels_line(
            res, SPLITK_MAX_M, W8A8_SPLITK_MAX_M)}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
