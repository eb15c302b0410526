"""Streaming transcription CLI of the port.

The counterpart of `cli/transcribe_stream.py`, with the reference binary's
argv contract (src/transcribe_stream.cpp:27-36):

    python -m nemotron_tpu_torch.cli <model.gguf> <audio.pcm|-|--stdin>
                                     [chunk_ms] [right_context]
                                     [--cpu|--cuda|--metal|--tpu]
                                     [--quantize=q8_0|w8a8] [--kv-int8]
                                     [--shared-cache]

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
    (a Q8_0 GGUF served as W8A8), --kv-int8 keeps int8 K/V rings,
    --shared-cache one shared x-ring per layer
  - incremental text on stdout; config + stats on stderr
"""

from __future__ import annotations

import io
import os
import sys
import time


_FLAGS = ("--cpu", "--cuda", "--metal", "--tpu", "--kv-int8", "--shared-cache")


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


def main(argv: list[str]) -> int:
    # --stdin is positional (it IS the audio argument); map it to '-'
    argv_t = ["-" if a == "--stdin" else a for a in argv[1:]]
    args = [a for a in argv_t if not a.startswith("--")]
    flags = [a for a in argv_t if a.startswith("--")]
    if len(args) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    later = [f for f in flags if f.startswith(("--quantize=w8a8-sq",
                                                "--kv-int4", "--rc-by-layer="))]
    if later:
        print(f"error: {' '.join(later)} comes with a later slice of this "
              "port (SmoothQuant, int4 rings, per-layer right context)",
              file=sys.stderr)
        return 1
    unknown = [f for f in flags if f not in _FLAGS
               and not f.startswith("--quantize=")]
    if unknown:
        print(f"error: unsupported flag(s) {' '.join(unknown)} (this port "
              f"takes {', '.join(_FLAGS)} and --quantize=q8_0|w8a8)",
              file=sys.stderr)
        return 1
    device = device_from_flags(flags)
    if device is None:
        return 1
    quant_mode = None
    for f in flags:
        if f.startswith("--quantize="):
            quant_mode = f.split("=", 1)[1]

    model_path, audio_path = args[0], args[1]
    chunk_ms = int(args[2]) if len(args) > 2 else 0
    right_context = int(args[3]) if len(args) > 3 else 13
    if chunk_ms and chunk_ms < 10:
        print(f"warning: chunk_ms {chunk_ms} < 10, ignoring", file=sys.stderr)
    if right_context not in (0, 1, 6, 13):
        print(f"warning: right_context {right_context} is non-standard "
              "(expected 0, 1, 6 or 13)", file=sys.stderr)

    import numpy as np

    from .config import CacheConfig
    from .params import load_model, quantize_model_params
    from .streaming.session import StreamSession

    if not os.path.exists(model_path):
        print(f"error: model file not found: {model_path}", file=sys.stderr)
        return 1
    try:
        params, cfg, vocab = load_model(model_path, device=device)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if quant_mode:
        try:
            params = quantize_model_params(params, mode=quant_mode)
        except KeyError:
            print(f"error: unknown --quantize mode '{quant_mode}' "
                  "(expected q8_0, w8a8, w8a8-sq or w8a8-sq-static)",
                  file=sys.stderr)
            return 1
        print(f"runtime quantization: {quant_mode}", file=sys.stderr)
    cc = CacheConfig(att_right_context=right_context, n_mels=cfg.n_mels,
                     kv_cache_int8="--kv-int8" in flags,
                     shared_cache="--shared-cache" in flags)
    if cc.kv_cache_int8:
        print("int8 K/V cache rings enabled", file=sys.stderr)
    if cc.shared_cache:
        print("shared channel cache (x-ring) enabled", file=sys.stderr)
    print(f"config: chunk={cc.chunk_mel_frames} mel frames "
          f"({cc.latency_ms} ms), shift={cc.shift_mel_frames}, "
          f"valid_out={cc.valid_out_len}, left_context={cc.att_left_context}",
          file=sys.stderr)
    sess = StreamSession(params, cfg, vocab, cc)

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
    if len(final) > before:  # text emitted by the flush chunk
        sys.stdout.write(final[before:])
    sys.stdout.write("\n")
    sys.stdout.flush()

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
