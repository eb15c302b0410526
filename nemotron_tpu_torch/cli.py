"""Streaming transcription CLI of the port.

The counterpart of `cli/transcribe_stream.py`, with the reference binary's
argv contract (src/transcribe_stream.cpp:27-36):

    python -m nemotron_tpu_torch.cli <model.gguf> <audio.pcm|-|--stdin>
                                     [chunk_ms] [right_context]
                                     [--cpu|--cuda|--metal|--tpu]
                                     [--quantize=q8_0|w8a8|w8a8-sq|
                                                 w8a8-sq-static]
                                     [--calib=FILE] [--kv-int8|--kv-int4]
                                     [--shared-cache] [--rc-by-layer=13,6,1,0]
                                     [--timestamps] [--confidence]
                                     [--srt=FILE|--vtt=FILE] [--beam=K]
                                     [--lm=lm.gguf] [--lm-weight=W]
                                     [--lm-bonus=B]
                                     [--boost=piece:weight,...] [--ctc]
                                     [--trace=DIR] [--profile=DIR]

  - input: raw s16le 16 kHz mono PCM file, or '-' / '--stdin' for stdin;
    .wav files decode directly (PCM16 or float32, any sample rate --
    polyphase-resampled, stereo averaged) and are replayed as raw PCM
  - chunk_ms is advisory (>=10 warning); the actual read size comes from the
    cache config, as in the reference (src/transcribe_stream.cpp:119,143-146)
  - right_context in {0, 1, 6, 13} selects the latency mode
  - runs on the CUDA card unless --cpu is given; --cuda asks for the card
    (the default), --metal and --tpu warn and are ignored, as the JAX CLI
    warns on the backends it lacks; --cpu with --cuda is an error
  - --quantize=q8_0|w8a8 requantizes the encoder matmul weights at load
    (a Q8_0 GGUF served as W8A8); w8a8-sq folds SmoothQuant scales into
    the dense weights first, calibrated on the input's first 20 s (or on
    --calib=FILE, which stdin input needs), and w8a8-sq-static also
    freezes the calibrated activation scales
  - --kv-int8 / --kv-int4 keep int8 / int4 K/V rings, --shared-cache one
    shared x-ring per layer, --rc-by-layer=13,6,1,0 a right context per
    layer group (NeMo's per-layer lookahead)
  - --timestamps puts each word's start time in {seconds} before it,
    --confidence its posterior in {p=...}; --srt=FILE / --vtt=FILE write
    subtitle cues from the timed tokens at the end (=FILE is required:
    stdout carries the incremental transcript)
  - --beam=K decodes with the batched RNN-T beam search: the best
    hypothesis may rewrite earlier text, so the whole transcript is
    printed at the end; --lm=lm.gguf adds LM shallow fusion to it (labels
    score log P_rnnt + W * log P_lm + B, W = 0.3 by default)
  - --boost=piece:weight,... adds a log-space boost to those tokens'
    logits (folded into the joint's output bias)
  - --ctc decodes a hybrid checkpoint with its CTC head (greedy collapse)
    instead of the transducer; a TDT checkpoint decodes with the
    duration-aware walk (or beam) with no flag
  - --trace=DIR dumps each chunk's intermediates (mel, pre_encode_out,
    layer_NN_out, encoder_out, tokens) into DIR in the reference's binary
    dump format (greedy RNN-T only); --profile=DIR writes a torch.profiler
    Chrome trace of the streaming loop into DIR (utils/profiler.py reads
    each chunk step's device time from it)
  - incremental text on stdout; config + stats on stderr
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import time


_FLAGS = ("--cpu", "--cuda", "--metal", "--tpu", "--kv-int8", "--kv-int4",
          "--shared-cache", "--timestamps", "--confidence", "--ctc")
_VALUED = ("--quantize=", "--calib=", "--rc-by-layer=", "--srt", "--vtt",
           "--beam=", "--lm=", "--lm-weight=", "--lm-bonus=", "--boost=",
           "--trace=", "--profile=")
_SQ_MODES = ("w8a8-sq", "w8a8-sq-static")


def device_from_flags(flags: list[str]) -> str | None:
    """The device the reference's device flags ask for: "cuda" unless
    --cpu is given. --metal and --tpu are not backends of this port: they
    warn and are ignored, as the JAX CLIs warn on the backends they lack.
    --cpu with --cuda is an error: printed, and None returned."""
    if "--cpu" in flags and "--cuda" in flags:
        print("error: --cpu and --cuda ask for different devices",
              file=sys.stderr)
        return None
    device = "cpu" if "--cpu" in flags else "cuda"
    for f in flags:
        if f in ("--metal", "--tpu"):
            using = "the CPU (--cpu)" if device == "cpu" else "the CUDA card"
            print(f"warning: {f} is not a backend of this port; using "
                  f"{using}", file=sys.stderr)
    return device


def calibrate(params, cfg, cc, quant_mode: str, calib_path: str | None,
              audio_path: str):
    """SmoothQuant for --quantize=w8a8-sq[-static], as
    cli/transcribe_stream.py does it: calibrate on the first 20 s of
    --calib=FILE, or of the input file (stdin input needs --calib), with
    the streaming chunk's visibility; fold, W8A8-quantize and, for the
    static mode, freeze the activation scales. Returns the params, or None
    after printing the error."""
    from .config import PreprocessorConfig
    from .frontend.preprocessor import StreamingPreprocessor
    from .ops.smoothquant import smooth_quantize
    from .utils.audio import read_audio_file

    if calib_path is None and audio_path != "-":
        calib_path = audio_path
    if calib_path is None:
        print(f"error: --quantize={quant_mode} with stdin input needs "
              "--calib=FILE (a representative audio clip)", file=sys.stderr)
        return None
    calib_audio = read_audio_file(calib_path)[:20 * 16000]
    pre = StreamingPreprocessor(
        params.preprocessor.filterbank.float().cpu().numpy(),
        params.preprocessor.window.float().cpu().numpy(), n_streams=1,
        cfg=PreprocessorConfig(n_mels=cfg.n_mels), device=params.device)
    mel = pre.process(calib_audio)
    if mel.shape[1] == 0:
        print(f"error: calibration clip {calib_path} too short",
              file=sys.stderr)
        return None
    params = smooth_quantize(params, cfg, mel, att_chunk=cc.chunk_enc_len,
                             static_act=quant_mode.endswith("-static"))
    print(f"runtime quantization: {quant_mode} (calibrated on "
          f"{mel.shape[1]} mel frames of {calib_path})", file=sys.stderr)
    return params


def beam_lm_flags(flags: list[str]):
    """(beam, lm_path, lm_weight, lm_bonus) from --beam=, --lm=,
    --lm-weight= and --lm-bonus=, or None after printing the error for a
    value that is not a number (the JAX CLIs' message)."""
    beam, lm_path, lm_weight, lm_bonus = 1, None, 0.3, 0.0
    try:
        for f in flags:
            if f.startswith("--beam="):
                beam = int(f.split("=", 1)[1])
            elif f.startswith("--lm="):
                lm_path = f.split("=", 1)[1]
            elif f.startswith("--lm-weight="):
                lm_weight = float(f.split("=", 1)[1])
            elif f.startswith("--lm-bonus="):
                lm_bonus = float(f.split("=", 1)[1])
    except ValueError:
        print("error: --beam takes an integer, --lm-weight a float",
              file=sys.stderr)
        return None
    return beam, lm_path, lm_weight, lm_bonus


def load_lm_flag(lm_path: str | None, device: str):
    """The --lm file as LMParams on `device` (None without --lm), or
    False after printing the error for a missing or foreign file."""
    if lm_path is None:
        return None
    from .models.lm import load_lm

    try:
        return load_lm(lm_path, device=device)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return False


def apply_boost_flags(params, flags: list[str], vocab, announce: bool):
    """Fold each --boost=piece:weight,... into the joint's output bias, or
    return None after printing the error for a bad item or an unknown
    piece. `announce` prints the streaming CLI's stderr line."""
    from .params import apply_logit_bias, parse_boost_spec

    for f in flags:
        if f.startswith("--boost="):
            spec = f.split("=", 1)[1]
            try:
                params = apply_logit_bias(params, parse_boost_spec(spec),
                                          vocab)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return None
            if announce:
                print(f"logit boost applied: {spec}", file=sys.stderr)
    return params


def main(argv: list[str]) -> int:
    # --stdin is positional (it IS the audio argument); map it to '-'
    argv_t = ["-" if a == "--stdin" else a for a in argv[1:]]
    args = [a for a in argv_t if not a.startswith("--")]
    flags = [a for a in argv_t if a.startswith("--")]
    if len(args) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    unknown = [f for f in flags
               if f not in _FLAGS and not f.startswith(_VALUED)]
    if unknown:
        print(f"error: unsupported flag(s) {' '.join(unknown)} (this port "
              f"takes {', '.join(_FLAGS)}, --quantize=q8_0|w8a8|w8a8-sq|"
              "w8a8-sq-static, --calib=FILE, --rc-by-layer=R,.., "
              "--srt=FILE|--vtt=FILE, --beam=K, --lm=FILE, --lm-weight=W, "
              "--lm-bonus=B, --boost=piece:weight,.., --trace=DIR and "
              "--profile=DIR)", file=sys.stderr)
        return 1
    sub_fmt, sub_out = None, None
    for f in flags:
        if f.startswith(("--srt=", "--vtt=")):
            if sub_fmt is not None and sub_fmt != f[2:5]:
                print("error: --srt and --vtt are mutually exclusive "
                      "(one subtitle format per run)", file=sys.stderr)
                return 1
            sub_fmt, sub_out = f[2:5], f.split("=", 1)[1]
        elif f.startswith(("--srt", "--vtt")):
            print(f"error: streaming {f} requires {f}=FILE (stdout carries "
                  "the incremental transcript)", file=sys.stderr)
            return 1
    device = device_from_flags(flags)
    if device is None:
        return 1
    quant_mode, calib_path, rc_pat = None, None, None
    trace_dir, profile_dir = None, None
    for f in flags:
        if f.startswith("--trace="):
            trace_dir = f.split("=", 1)[1]
        elif f.startswith("--profile="):
            profile_dir = f.split("=", 1)[1]
        elif f.startswith("--quantize="):
            quant_mode = f.split("=", 1)[1]
        elif f.startswith("--calib="):
            calib_path = f.split("=", 1)[1]
        elif f.startswith("--rc-by-layer="):
            rc_pat = f.split("=", 1)[1]

    model_path, audio_path = args[0], args[1]
    chunk_ms = int(args[2]) if len(args) > 2 else 0
    right_context = int(args[3]) if len(args) > 3 else 13
    if chunk_ms and chunk_ms < 10:
        print(f"warning: chunk_ms {chunk_ms} < 10, ignoring", file=sys.stderr)
    if right_context not in (0, 1, 6, 13):
        print(f"warning: right_context {right_context} is non-standard "
              "(expected 0, 1, 6 or 13)", file=sys.stderr)

    import dataclasses

    import numpy as np

    from .config import CacheConfig
    from .params import load_model, quantize_model_params
    from .streaming.session import StreamSession

    if not os.path.exists(model_path):
        print(f"error: model file not found: {model_path}", file=sys.stderr)
        return 1
    try:
        # SmoothQuant folds its scales into the DENSE weights
        params, cfg, vocab = load_model(
            model_path, device=device,
            keep_quantized=quant_mode not in _SQ_MODES)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if quant_mode and quant_mode not in _SQ_MODES:
        try:
            params = quantize_model_params(params, mode=quant_mode)
        except KeyError:
            print(f"error: unknown --quantize mode '{quant_mode}' "
                  "(expected q8_0, w8a8, w8a8-sq or w8a8-sq-static)",
                  file=sys.stderr)
            return 1
        print(f"runtime quantization: {quant_mode}", file=sys.stderr)
    params = apply_boost_flags(params, flags, vocab, announce=True)
    if params is None:
        return 1
    cc = CacheConfig(att_right_context=right_context, n_mels=cfg.n_mels,
                     kv_cache_int8="--kv-int8" in flags,
                     shared_cache="--shared-cache" in flags)
    if cc.kv_cache_int8:
        print("int8 K/V cache rings enabled", file=sys.stderr)
    if "--kv-int4" in flags:
        cc = dataclasses.replace(cc, kv_cache_int8=False, kv_cache_int4=True)
        print("int4 K/V cache rings enabled", file=sys.stderr)
    if cc.shared_cache:
        print("shared channel cache (x-ring) enabled", file=sys.stderr)
    if rc_pat is not None:
        try:
            pat = tuple(int(v) for v in rc_pat.split(","))
            cc = dataclasses.replace(cc, att_right_context_by_layer=pat)
            cc.rc_schedule(cfg.n_layers)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(f"per-layer right context: {pat}", file=sys.stderr)
    if quant_mode in _SQ_MODES:
        params = calibrate(params, cfg, cc, quant_mode, calib_path,
                           audio_path)
        if params is None:
            return 1
    print(f"config: chunk={cc.chunk_mel_frames} mel frames "
          f"({cc.latency_ms} ms), shift={cc.shift_mel_frames}, "
          f"valid_out={cc.valid_out_len}, left_context={cc.att_left_context}",
          file=sys.stderr)
    beam_lm = beam_lm_flags(flags)
    if beam_lm is None:
        return 1
    beam, lm_path, lm_weight, lm_bonus = beam_lm
    if beam > 1:
        print(f"beam search: K={beam} (incremental output disabled; "
              "the best hypothesis may rewrite as chunks arrive)",
              file=sys.stderr)
        if sub_fmt is not None:
            print("error: --srt/--vtt require greedy decode: cues need "
                  "per-token frame alignment", file=sys.stderr)
            return 1
    lm = load_lm_flag(lm_path, device)
    if lm is False:
        return 1
    if lm is not None:
        print(f"LM shallow fusion: {lm_path} (weight {lm_weight})",
              file=sys.stderr)
    try:
        sess = StreamSession(params, cfg, vocab, cc, trace_dir=trace_dir,
                             timestamp_words="--timestamps" in flags,
                             confidence_words="--confidence" in flags,
                             beam_size=beam, ctc="--ctc" in flags, lm=lm,
                             lm_weight=lm_weight, lm_bonus=lm_bonus)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if audio_path == "-":
        src = sys.stdin.buffer
    else:
        src = open(audio_path, "rb")
        head = src.read(12)
        if head[:4] == b"RIFF":  # WAV: decode fully, replay as raw PCM
            from .utils.audio import read_audio_bytes

            data = head + src.read()
            src.close()
            src = io.BytesIO(read_audio_bytes(data).tobytes())
        else:
            src.seek(0)
    chunk_bytes = cc.chunk_samples * 2
    window = contextlib.ExitStack()
    if profile_dir:
        from .utils.profiler import profile

        window.enter_context(profile(profile_dir))

    t_start = time.perf_counter()
    n_samples = 0
    try:
        while True:
            buf = src.read(chunk_bytes)
            if not buf:
                break
            audio = np.frombuffer(buf, dtype="<i2")
            n_samples += audio.size
            text = sess.process(audio)
            if text:
                sys.stdout.write(text)
                sys.stdout.flush()
    finally:
        if src is not sys.stdin.buffer:
            src.close()

    before = len(sess.get_transcript(0))
    final = sess.finalize()
    if beam > 1:
        # beam transcripts may rewrite earlier text; nothing was printed
        # incrementally, so the whole final best hypothesis goes out here
        sys.stdout.write(final)
    elif len(final) > before:  # text emitted by the flush chunk
        sys.stdout.write(final[before:])
    sys.stdout.write("\n")
    sys.stdout.flush()

    if sub_fmt is not None:
        from .utils.subtitles import write_subtitles

        n = write_subtitles(sub_out, sess.get_tokens(0), vocab, sub_fmt)
        print(f"wrote {n} cues to {sub_out}", file=sys.stderr)

    window.close()          # the profile window: stop and export
    if profile_dir:
        print(f"profiler trace written to {profile_dir}", file=sys.stderr)

    elapsed = time.perf_counter() - t_start
    audio_s = n_samples / 16000.0
    print(f"\nprocessed {sess.total_chunks} chunks, {audio_s:.2f}s audio "
          f"in {elapsed:.2f}s (RTF {elapsed / max(audio_s, 1e-9):.4f}) "
          f"on {params.device}", file=sys.stderr)
    print(f"frontend {sess.frontend_seconds:.3f}s, "
          f"chunk-step {sess.chunk_seconds:.3f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
