#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

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
     for bit at M = 896 in both dtypes, and both designs timed per layer
     at the crossover rows M = 16, 32, 64, 96, 112, 128, 256, 804 and
     896
     through the same entry point (`q8_matmul_as`); the profiles count Q8
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
     rings in all four modes, then with the shared x-ring at R=13; launch
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
     re-admitted, every slot finalized), 4 s of audio a stream: W8A8 +
     int8 K/V in bf16 with the DSP on the device in all four modes (step
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
     R = 13, driven by 48 TCP and 8 WebSocket clients streaming 4 s of
     seeded PCM each at the real-time rate and 8 POST /transcribe
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
     with int4 rings (bf16, 8 streams) in the four modes (launches a step
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
     versions bit for bit from M = 16 on (M* and M* + 1, 804, 896, 897 and
     3584 besides the main paths' rows), in both modes and dtypes, checks
     repeated calls in both, and times both designs per layer in both modes
     at the crossover rows M = 16-3584 through the same entry point
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
 13. one JSON line of kernel results, the card's name and power limit, and
     last the line {"ok": true, "device": {...}}. Each phase prints its
     wall time.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
AUDIO_SECONDS = 4.0
MODES = (0, 1, 6, 13)
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
# the network server (slice 9): a 64-slot engine behind an ASRServer, 48 TCP
# and 8 WebSocket clients streaming 4 s each at the real-time rate in
# 100 ms blocks, and 8 POST /transcribe requests of 4 s; the clients'
# log-posteriors against solo sessions within the Q8_0 path's card
# tolerance (TOL_ENCODER_ABS)
SERVER_SLOTS, SERVER_TCP, SERVER_WS, SERVER_REST = 64, 48, 8, 8
SERVER_SECONDS = 4.0
TOL_CONF_ABS = 1e-3
# slice 10: the quant tiers and snapshots. SmoothQuant calibrates on 4 s of
# seeded PCM (its own stream, not one the sessions decode); per-layer right
# context as NeMo's lookahead groups; snapshots cut mid-stream, mid-chunk
SQ_CALIB_STREAM, SQ_CALIB_SECONDS = 900, 4.0
RC_BY_LAYER = (13, 6, 1, 0)
SNAPSHOT_CUT = 30_000         # samples into a 4 s stream (R = 13: mid-chunk)


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


def profile_window(fn) -> dict:
    """Device time and launch count by kernel name and the device's busy
    share over one call of `fn`, from torch.profiler (CUPTI). Kernels run
    on one stream, so the sum of their durations is the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return profile_summary(prof, wall_us)


def profile_summary(prof, wall_us: float) -> dict:
    """Device time and launches by kernel name, and the busy time, of a
    finished torch.profiler run over `wall_us` of wall time. Reads the raw
    activity records (`prof.events()` would build an event tree first, a
    minute for a few hundred thousand launches)."""
    from torch.autograd import DeviceType

    raw_ns: dict[str, int] = {}
    raw_n: dict[str, int] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
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

    def inputs(B, Q, KV, dt, ring_dt, n_stacks=1, dh=Dh):
        """ring_dt: the compute dtype, torch.int8, or "int4" (packed)."""
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

    def timed(R, B, dt, ring_dt, with_library, n_stacks=8, iters=2000):
        cc = CacheConfig(att_right_context=R)
        Q, KV = cc.chunk_enc_len, cc.kv_len
        x = inputs(B, Q, KV, dt, ring_dt, n_stacks=n_stacks)
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
        r = dict(Q=Q, KV=KV, B=B, ms=ms, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=bound_ms, bytes=nbytes,
                 flops=flops, max_abs_err=err,
                 bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                           >= flops / peak else "operations"))
        lib_txt = f"sdpa {lib_ms * 1e3:.2f} us, " if with_library else ""
        ring_name = ring_dt if isinstance(ring_dt, str) else str(ring_dt)[6:]
        log(f"  R={R} Q={Q} KV={KV} B={B} {str(dt)[6:]} ring="
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
    return per_mode


Q8_SHAPES = {(1024, 1024): 5, (1024, 4096): 2, (4096, 1024): 2,
             (1024, 2048): 1}   # (K, N): calls per layer (q/k/v/out/pw2,
#                                  ffn w1 x2, ffn w2 x2, pw1)


# slice 11: the Q8 kernel's crossover rows, where both designs are timed
Q8_CROSSOVER_MS = (16, 32, 64, 96, 112, 128, 256, FULL_UTT_M, ENGINE_M)


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
    # engine batches, ragged tiles (17, 257)
    log(f"phase kernels: q8_matmul vs q8_matmul_ref (M* = {SPLITK_MAX_M})")
    star = SPLITK_MAX_M
    for M in (1, 14, 112, 17, 257, FULL_UTT_M, ENGINE_M, star - 1, star,
              star + 1):
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
    for M in sorted({1, 14, *Q8_CROSSOVER_MS}):
        iters = 500 if M <= 16 else 100
        for (K, N) in Q8_SHAPES:
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


# slice 12: the W8A8 kernel's crossover rows, where both designs are timed
# per layer in both modes: the streaming rows of 1-8 streams, the shared
# x-ring (672), the full-utterance batch, the 64- and 256-slot engines
W8A8_CROSSOVER_MS = (16, 32, 56, 64, 96, 112, 128, 256, 288, 672,
                     FULL_UTT_M, ENGINE_M, ENGINE_SLOT_COUNTS[-1] * 14)


def w8a8_phase(failures: list) -> dict:
    import torch

    from nemotron_tpu_torch.ops.quant_kernel import sm_count
    from nemotron_tpu_torch.ops.w8a8_kernel import (SPLITK_MAX_M,
                                                    splitk_geometry,
                                                    tiled_geometry,
                                                    tiled_splits,
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
                                  ENGINE_SLOT_COUNTS[-1] * 14)
              for (K, N) in Q8_SHAPES] + [(3, 96, 56), (900, 96, 56),
                                          (900, 512, 56)]
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
    for M in (8, *W8A8_CROSSOVER_MS):
        iters = 500 if M <= 16 else 200 if M <= 256 else 100 if M <= 1000 \
            else 30
        for (K, N) in Q8_SHAPES:
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
    # the tiled design's every split of K at the 64-slot engine's M (the
    # geometry takes the least split that gives a block an SM)
    splits = {}
    for (K, N) in Q8_SHAPES:
        n = max(2, (192 << 20) // (K * N))
        ws = weights(K, N, n)
        x = act(ENGINE_M, K, torch.bfloat16)
        splits[f"{K},{N}"] = {
            sp: time_calls([lambda q=q, cs=cs, geo=tiled_geometry(
                ENGINE_M, K, N, sms, sp): w8a8_matmul_as(x, q, cs, None, geo)
                for q, cs in ws], 100) for sp in tiled_splits(K)}
        log(f"  tiled M={ENGINE_M} K={K} N={N} dynamic by split: "
            + ", ".join(f"{sp}: {ms * 1e3:.2f} us" for sp, ms in
                        splits[f"{K},{N}"].items())
            + f" (the geometry takes "
            f"{tiled_geometry(ENGINE_M, K, N, sms).split})")
        del ws
    out["tiled_splits"] = splits
    out["max_abs_err"] = worst
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def write_full_width_gguf(path: str):
    """Seeded full-width random-weight GGUF, encoder matmuls as Q8_0 (the
    reference converter's default selection), with the converter's conv
    weight layouts and a joint bias on token 5 so that tokens are emitted."""
    from nemotron_tpu_torch import gguf
    from nemotron_tpu_torch.config import ModelConfig
    from nemotron_tpu_torch.ops.quant import should_quantize
    from nemotron_tpu_torch.params import random_weight_arrays

    cfg = ModelConfig()
    arrays = random_weight_arrays(cfg, seed=SEED)
    arrays["joint.joint_net.2.bias"][5] = 2.0
    for name, a in list(arrays.items()):
        if name.endswith(".conv.depthwise_conv.weight") and a.ndim == 3:
            arrays[name] = a.squeeze(1).T
        elif name.endswith((".conv.pointwise_conv1.weight",
                            ".conv.pointwise_conv2.weight")) and a.ndim == 3:
            arrays[name] = a.squeeze(2)
    quantize = {n: gguf.GGML_Q8_0 for n, a in arrays.items()
                if should_quantize(n, a)}
    vocab = [f"t{i}" for i in range(cfg.vocab_size)]
    meta = {
        "general.architecture": "nemo",
        "tokenizer.vocab": gguf.encode_vocab(vocab),
        "nemo.n_mels": cfg.n_mels, "nemo.d_model": cfg.d_model,
        "nemo.n_heads": cfg.n_heads, "nemo.d_head": cfg.d_head,
        "nemo.d_ff": cfg.d_ff, "nemo.n_layers": cfg.n_layers,
        "nemo.kernel_size": cfg.kernel_size,
        "nemo.vocab_size": cfg.vocab_size,
    }
    gguf.write_gguf(path, meta, arrays, quantize=quantize)
    return len(quantize)


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
    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.streaming.session import StreamSession

    t0 = time.perf_counter()
    params, cfg, vocab = load_model(gguf_path, device="cuda")
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
    cpu_params, _, _ = load_model(gguf_path, device="cpu")
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


def w8a8_path_phase(gguf_path: str, failures: list) -> dict:
    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.ops.w8a8_kernel import w8a8_matmul
    from nemotron_tpu_torch.params import load_model, quantize_model_params

    t0 = time.perf_counter()
    params, cfg, vocab = load_model(gguf_path, device="cuda")
    params = quantize_model_params(params, mode="w8a8")
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
        sess = run_session(params, cfg, vocab, cc, pcm, bf16)
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
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels,
                     kv_cache_int8=True)
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

    # f32, R = 13, the same config on the card and the port's CPU run
    cpu_params = quantize_model_params(
        load_model(gguf_path, device="cpu")[0], mode="w8a8")
    card = run_session(params, cfg, vocab, cc, pcm, f32)
    cpu = run_session(cpu_params, cfg, vocab, cc, pcm, f32)
    agree = [position_agreement(card.get_tokens(s), cpu.get_tokens(s))
             for s in range(S)]
    log(f"  R=13 f32 S={S} tokens card vs CPU: {sum(a == 1 for a in agree)} "
        f"of {S} streams equal, position agreement {min(agree):.4f}-"
        f"{max(agree):.4f} ({sum(len(cpu.get_tokens(s)) for s in range(S))} "
        f"tokens; tol {TOL_W8A8_TOKEN_AGREE})")
    if min(agree) < TOL_W8A8_TOKEN_AGREE:
        failures.append(f"W8A8 R=13 f32 tokens card vs CPU: agreement "
                        f"{min(agree):.4f}")

    # the encoder over n_seg + 2 chunks: the int8 rings fill and wrap
    n_seg = cc.kv_len // cc.chunk_enc_len
    mels = np.random.default_rng(SEED + 1).standard_normal(
        (n_seg + 2, S, cc.chunk_mel_frames, cfg.n_mels)).astype(np.float32)
    nudged = (mels * np.float32(1 + W8A8_CONTROL_ULPS * 2.0 ** -23)
              ).astype(np.float32)
    o_cpu, st_cpu, calls = encoder_run(cpu_params, cfg, cc, mels, f32,
                                       record_last=True)
    o_ctl, st_ctl, _ = encoder_run(cpu_params, cfg, cc, nudged, f32)
    o_card, st_card, _ = encoder_run(params, cfg, cc, mels, f32)
    o_bf16, st_bf16, _ = encoder_run(params, cfg, cc, mels, bf16)

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
    bf = run_session(params, cfg, vocab, cc, pcm, bf16)
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


def full_utterance_phase(gguf_path: str, failures: list) -> dict:
    import torch

    from nemotron_tpu_torch.models import decoder as dec_mod
    from nemotron_tpu_torch.models import encoder as enc_mod
    from nemotron_tpu_torch.params import load_model
    from nemotron_tpu_torch.streaming import session as sess_mod
    from nemotron_tpu_torch.utils.text import tokens_to_text

    params, cfg, vocab = load_model(gguf_path, device="cuda")
    cpu_params, _, _ = load_model(gguf_path, device="cpu")
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

    # card vs the port's CPU run on the CPU's mel: the encoder output (and
    # the control that fixes its tolerance), then greedy tokens
    mel, lengths = sess_mod.batch_mel(cpu_params, cfg, utts)
    nudged = (mel * np.float32(1 + W8A8_CONTROL_ULPS * 2.0 ** -23)
              ).astype(np.float32)
    enc, toks = {}, {}
    for name, p, m in (("cpu", cpu_params, mel), ("control", cpu_params,
                                                  nudged),
                       ("card", params, mel)):
        lens = torch.from_numpy(lengths).to(p.device)
        e = enc_mod.encode_batch(p, cfg, torch.from_numpy(m).to(p.device),
                                 enc_lengths=lens)
        if name != "control":
            st = dec_mod.init_decoder_state(cfg, len(utts), torch.float32,
                                            p.device)
            toks[name] = dec_mod.greedy_decode(p, cfg, e, st,
                                               enc_lengths=lens)[0].cpu()
        enc[name] = e.float().cpu()
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
    half = utts[1].size // 2
    chains = {}
    for name, p in (("card", params), ("cpu", cpu_params)):
        st, off, out = None, 0, []
        for seg in (utts[1][:half], utts[1][half:]):
            text, tl, st, off = sess_mod.transcribe_batch_with_state(
                p, cfg, vocab, seg, dec_state=st, frame_offset=off)
            out.append((text, tl, off))
        chains[name] = out
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
                    finalize: bool = True) -> dict:
    """Drive a fresh engine through a ragged schedule, one chunk shift of
    samples a tick: every slot but `late` admitted at once, the slots in
    `half` fed every other tick, `late` admitted at `late_tick`, and the
    `evict` slots evicted at `evict_tick` (their recordings dropped from
    `tap`) and re-admitted with new streams (stream ids from n_slots up)
    of the same rate; then every slot finalized in one finalize_streams
    call (or, finalize=False, evicted). pcm_of(stream id) gives a stream's
    PCM. Returns the final tokens and PCM per stream id, the slot each
    stream ended in, and the stats and latency percentiles of the
    streaming ticks (before the finalize)."""
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
    ends = (eng.finalize_streams(slots, return_tokens=True) if finalize
            else [eng.remove_stream(s, return_tokens=True) for s in slots])
    finals = {stream_of[s]: toks for s, (_text, toks) in zip(slots, ends)}
    return dict(finals=finals, slot_of={sid: s for s, sid in
                                        stream_of.items()},
                pcm=pcm, stats=stats, latency=latency, ticks=tick)


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


def solo_session(params, cfg, vocab, cc, pcm, dtype) -> dict:
    """One StreamSession over one stream's PCM: the tokens of the chunks of
    real audio ("streamed", before the finalize) and the frames they
    cover, and the tokens after the finalize ("final"), whose last chunk
    is padded with zero mel."""
    from nemotron_tpu_torch.streaming.session import StreamSession

    sess = StreamSession(params, cfg, vocab, cc, compute_dtype=dtype)
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
    from nemotron_tpu_torch.params import load_model, quantize_model_params
    from nemotron_tpu_torch.streaming.serving import ServingEngine

    bf16, f32 = torch.bfloat16, torch.float32
    q8_params, cfg, vocab = load_model(gguf_path, device="cuda")
    w8_params = quantize_model_params(q8_params, mode="w8a8")
    n = ENGINE_SLOTS

    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    out = {"modes": {}, "slot_counts": {}}
    log(f"phase engine: ServingEngine at full width, {n} slots, "
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
        plan = ragged_plan(n, ENGINE_SECONDS, cc.shift_samples)
        run, _ = timed_run(w8_params, cc, bf16, "device", n, plan)
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
    from nemotron_tpu_torch.utils.tones import make_eval_streams, render_tones

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
    rng = np.random.default_rng(7)
    truth = ([3, 11, 6, 0, 14, 9], [8, 2, 15])

    def utt(labels, tail_s):
        n = int(0.30 * len(labels) * 16000) + int(tail_s * 16000)
        return render_tones(np.asarray(labels), np.full(len(labels), 0.25),
                            rng, 16, n, gaps=np.full(len(labels), 0.05))

    pcm = np.concatenate([utt(truth[0], 3.0), utt(truth[1], 3.0)])
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
    from nemotron_tpu_torch.params import load_model, quantize_model_params
    from nemotron_tpu_torch.streaming.serving import ServingEngine
    from nemotron_tpu_torch.streaming.session import StreamSession

    q8_params, cfg, vocab = load_model(gguf_path, device="cuda")
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
    from nemotron_tpu_torch.utils.tones import make_eval_streams, render_tones

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
    rng = np.random.default_rng(7)
    truth = ([3, 11, 6, 0, 14, 9], [8, 2, 15])

    def utt(labels, tail_s):
        n = int(0.30 * len(labels) * 16000) + int(tail_s * 16000)
        return render_tones(np.asarray(labels), np.full(len(labels), 0.25),
                            rng, 16, n, gaps=np.full(len(labels), 0.05))

    pcm = np.concatenate([utt(truth[0], 3.0), utt(truth[1], 3.0)])
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
        proc = subprocess.Popen(
            [sys.executable, "-m", "nemotron_tpu_torch.asr_server", fixture,
             "--port", "0", "--slots", "4", "--confidence", "--tick-ms",
             "20"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=here)
        try:
            port, head = None, []
            t_end = time.time() + 180
            while port is None and time.time() < t_end:
                line = proc.stderr.readline()
                if not line:
                    break
                head.append(line)
                if line.startswith("listening on "):
                    port = int(line.split()[2].rsplit(":", 1)[1])
                    listening = line.strip()
            if port is None:
                raise RuntimeError("asr_server did not start: "
                                   + "".join(head)[-2000:])
            srt = os.path.join(tmp, "client.srt")
            transcript, ct = finish(start(
                ["-m", "nemotron_tpu_torch.asr_client", f"127.0.0.1:{port}",
                 os.path.join(tmp, "cpu", "s1.pcm"), "--rate", "max",
                 "--srt", srt], tmp))
            with open(srt, "rb") as f:
                client_srt = f.read()
        finally:
            proc.send_signal(signal.SIGINT)        # a clean stop
            try:
                server_out, _ = proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                server_out, _ = proc.communicate()
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
    """Slice 10 at full width: SmoothQuant calibrated on the card, then
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
    from nemotron_tpu_torch.params import (load_model, quantize_model_params,
                                           to_device)
    from nemotron_tpu_torch.streaming.serving import ServingEngine
    from nemotron_tpu_torch.streaming.session import StreamSession

    bf16, f32 = torch.bfloat16, torch.float32
    out = {"modes": {}}
    launches = {"attn": 0, "q8": 0, "w8a8": 0}
    gc.collect()

    def count(fn):
        return counted(fn, launches)

    t0 = time.perf_counter()
    dense, cfg, vocab = load_model(gguf_path, device="cuda",
                                   keep_quantized=False)
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
    log(f"phase quant tiers: dense load {t1 - t0:.1f} s; SmoothQuant on the "
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
        sess, n = count(lambda: run_session(sq, cfg, vocab, cc, pcm, bf16))
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
    q8, _, _ = load_model(gguf_path, device="cuda")
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
    cpu_q8, _, _ = load_model(gguf_path, device="cpu")
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

        proc = subprocess.Popen(
            [sys.executable, "-m", "nemotron_tpu_torch.asr_server", fixture,
             "--port", "0", "--slots", "4", "--kv-int4", "--rc-by-layer",
             "13,6,1,0", "--tick-ms", "20"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=here)
        try:
            port, head = None, []
            t_end = time.time() + 180
            while port is None and time.time() < t_end:
                line = proc.stderr.readline()
                if not line:
                    break
                head.append(line)
                if line.startswith("listening on "):
                    port = int(line.split()[2].rsplit(":", 1)[1])
                    listening = line.strip()
            if port is None:
                raise RuntimeError("asr_server did not start: "
                                   + "".join(head)[-2000:])
            transcript, ct = finish(run(
                ["-m", "nemotron_tpu_torch.asr_client", f"127.0.0.1:{port}",
                 paths[1], "--rate", "max"]))
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
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
    """Slice 13 at full width.
    (1) Q8_0 f32, 8 streams, R = 13, tick_pipelined over 4 s of seeded PCM:
        the tokens of the chunks of real audio equal 8 solo f32 sessions'
        (the exact tier), 24 attention and 240 Q8 launches a chunk; the
        finals against the sessions' as a reading (the lockstep pads
        silence PCM where a session pads zero mel, as in JAX).
    (2) W8A8 + int8 K/V bf16, 64 streams, the four modes, beside a 64-slot
        device-DSP ServingEngine fed the same audio at the real-time rate,
        in turns (lockstep, engine, engine, lockstep; each tick timed as
        the user's call: tick_pipelined, or feed_audio + step; 2 s a stream
        at R = 0 and 1): tick p50/p90 over the ticks that ran a chunk
        against the mode's limit, aggregate RTF, peak GiB,
        launches a chunk (24 attention, 240 W8A8); at R = 13 two streams
        against solo bf16 sessions (w8a8_solo_readings, as the engine
        phase: position agreement beside its controls, token counts
        checked; the agreement held to 95%) and a profile of 3 ticks (busy
        share, launches a tick by name).
    (3) 256 streams at R = 13, one timing.
    (4) CohortScheduler(2 x 32) and ServingCohorts(2 x 32, device DSP),
        Q8_0 f32, R = 13: engine 1's weights at engine 0's data_ptr, each
        cohort's tokens equal to a solo engine of its own.
    (5) `python -m nemotron_tpu_torch.serve` with --lockstep and without on
        the card (64 streams, W8A8 + int8 K/V): exit 0 and the summary."""
    import gc

    import torch

    from nemotron_tpu_torch.config import CacheConfig
    from nemotron_tpu_torch.params import load_model, quantize_model_params
    from nemotron_tpu_torch.streaming.cohorts import (CohortScheduler,
                                                      ServingCohorts)
    from nemotron_tpu_torch.streaming.lockstep import LockstepEngine
    from nemotron_tpu_torch.streaming.serving import ServingEngine

    bf16, f32 = torch.bfloat16, torch.float32
    gc.collect()
    q8_params, cfg, vocab = load_model(gguf_path, device="cuda")
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
    # time limit, PERF.md §4)
    n64 = ENGINE_SLOTS
    pcm64 = np.stack([seeded_pcm(s) for s in range(n64)])
    for R in MODES:
        t0 = time.perf_counter()
        cc = CacheConfig(att_right_context=R, n_mels=cfg.n_mels,
                         kv_cache_int8=True)
        pcm = pcm64[:, :pcm64.shape[1] // 2] if R < 6 else pcm64
        res = dict(limit_ms=SHIFT_MS[R], lockstep=[], engine=[])
        for kind in ("lockstep", "engine", "engine", "lockstep"):
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            if kind == "lockstep":
                eng = LockstepEngine(w8_params, cfg, vocab, cc, n_streams=n64)
                run, n, steps = count(lambda: lockstep_run(eng, pcm))
            else:
                eng = ServingEngine(w8_params, cfg, vocab, cc, n_slots=n64,
                                    compute_dtype=bf16, dsp="device")
                run, n, steps = count(lambda: engine_ticks(eng, pcm))
            check_engine_launches(f"{kind} W8A8 R={R}", n, steps, cfg, 10,
                                  "w8a8", failures)
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
        log(f"  W8A8 bf16 int8 K/V, {n64} streams, R={R} (limit "
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
                w8_params, cfg, vocab, cc, R, failures, [0, n64 - 1])
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
        f"{res['p50_ms']:.2f} / p90 {res['p90_ms']:.2f} ms (limit 1120 ms), "
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
    log(f"  cohorts, Q8_0 f32 R=13, 2 x {B}: CohortScheduler weights shared "
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

    # (5) the serve entry point on the card, with --lockstep and without
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "s.pcm")
        seeded_pcm(7).tofile(path)
        procs = {}
        for mode in ("lockstep", "engine"):
            procs[mode] = subprocess.Popen(
                [sys.executable, "-m", "nemotron_tpu_torch.serve", gguf_path,
                 path, "--streams", str(n64), "--seconds",
                 str(AUDIO_SECONDS), "--quantize", "w8a8", "--kv-int8",
                 *(["--lockstep"] if mode == "lockstep" else [])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=here, env=dict(os.environ, PYTHONPATH=here))
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
            log(f"  serve --{mode} (64 streams, W8A8 + int8 K/V, both "
                f"processes at once): exit {proc.returncode}; "
                + " | ".join(summary))
            if proc.returncode or not summary or len(slots) != 3:
                failures.append(f"serve {mode}: exit {proc.returncode}, "
                                f"stderr {se[-1500:]}")
    log(f"  serve entry points: wall {time.perf_counter() - t0:.1f} s")
    out["launches"] = launches
    return out


def main() -> int:
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

    t0 = time.perf_counter()
    cuda_build.build_all()
    log(f"phase build: {', '.join(cuda_build.KERNELS)} built for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")

    failures: list[str] = []

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args, failures)
        log(f"phase {name}: wall {time.perf_counter() - t0:.1f} s")
        return out

    attn = phase("attention kernel", attention_phase)
    q8 = phase("Q8 kernel", q8_phase)
    w8 = phase("W8A8 kernel", w8a8_phase)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "full_width_q8.gguf")
        t0 = time.perf_counter()
        n_q = write_full_width_gguf(path)
        log(f"phase main path: wrote {os.path.getsize(path) / 2 ** 30:.2f} "
            f"GiB GGUF ({n_q} Q8_0 tensors) in "
            f"{time.perf_counter() - t0:.1f} s")
        runs = phase("Q8_0 main path", main_path_phase, path)
        w8_runs = phase("W8A8 path", w8a8_path_phase, path)
        full = phase("full utterance", full_utterance_phase, path)
        engine = phase("serving engine (slice 8)", engine_phase, path)
        server = phase("server (slice 9)", server_phase, path)
        quant = phase("quant tiers and snapshots (slice 10)",
                      quant_tier_phase, path)
        lock = phase("lockstep, cohorts and serve (slice 13)",
                     lockstep_phase, path)
    tones = phase("tones", tones_phase)
    engine_tones = phase("serving engine tones (slice 8)", engine_tones_phase)
    server_tones = phase("server tones (slice 9)", server_tones_phase)
    clis = phase("CLIs and server entry points (slice 9)", cli_phase)
    tones_quant = phase("tones quant tiers (slice 10)", tones_quant_phase)
    clis_quant = phase("CLIs and server with the quant flags (slice 10)",
                       cli_quant_phase)
    server_n = {k: server["q8_f32"]["launches"][k]
                + server["w8a8_bf16"]["launches"][k]
                + server_tones["launches"][k] for k in ("attn", "q8", "w8a8")}
    engine_n = {k: engine["launches"][k] + engine_tones["launches"][k]
                + server_n[k] + quant["launches"][k]
                + tones_quant["launches"][k] + lock["launches"][k]
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
                     "bf16 int4 rings; no library call computes it"}},
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
         "m_star": SPLITK_MAX_M,
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
         "m_star": W8A8_SPLITK_MAX_M,
         "tiled_splits_m896": {shape: {str(sp): ms for sp, ms in row.items()}
                               for shape, row in w8["tiled_splits"].items()},
         "designs": "splitk (split-K clusters of up to 8 blocks, each "
                    "quantizing its own slice of x) for M <= m_star, tiled "
                    "(128 x 128 tiles, x quantized once a block for 128 "
                    "columns) above; per_m gives both designs' layer times "
                    "at the crossover rows"},
    ]
    modes = {f"R={R}": {k: v for k, v in r.items() if k != "tokens"}
             | {"n_tokens": len(r["tokens"])} for R, r in runs.items()}
    log("main path: " + json.dumps(modes))
    log("W8A8 path: " + json.dumps(w8_runs))
    log("full utterance: " + json.dumps(full))
    log("tones: " + json.dumps(tones))
    log("serving engine: " + json.dumps(engine))
    log("serving engine tones: " + json.dumps(engine_tones))
    log("server: " + json.dumps(server))
    log("server tones: " + json.dumps(server_tones))
    log("CLIs and entry points: " + json.dumps(clis))
    log("quant tiers and snapshots: " + json.dumps(quant))
    log("tones quant tiers: " + json.dumps(tones_quant))
    log("CLIs and server with the quant flags: " + json.dumps(clis_quant))
    log("lockstep, cohorts and serve: " + json.dumps(lock))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
