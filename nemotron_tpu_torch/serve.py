"""Many-stream serving demo of the port: N concurrent streams replaying a
PCM/WAV file through the continuous-batching engine or the lockstep
engine, with aggregate throughput and tick-latency percentiles.

The counterpart of `scripts/serve.py`:

    python -m nemotron_tpu_torch.serve <model.gguf> <audio.pcm|.wav>
        [--streams N] [--slots S] [--right-context R] [--seconds T]
        [--quantize q8_0|w8a8|w8a8-sq|w8a8-sq-static] [--kv-int8|--kv-int4]
        [--rc-by-layer 13,6,1,0] [--lockstep] [--dsp auto|numpy|device]
        [--confidence] [--endpoint-silence S] [--endpoint-reset] [--cpu]

  - --lockstep: every stream advances every tick through LockstepEngine
    (DSP, encoder and greedy decode in one tick, pipelined one tick
    deep); without it the ragged ServingEngine with S slots and --dsp
  - streams are staggered: each starts at another offset into the audio,
    wrapping around, and takes one chunk shift of samples a tick
  - runs on the CUDA card unless --cpu is given, in bf16; -sq modes
    calibrate SmoothQuant on the audio's first 20 s
  - the summary (aggregate real-time, tick p50/p90/p99) goes to stderr,
    the first three streams' transcripts to stdout
  - --beam, --lm* and --ctc come with the decode-variants slice of this
    port, --mesh and --coordinator with the multi-GPU slice and
    --dsp native with the native-bindings slice: each exits 1
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .asr_server import flag_value, later_flag, positional_args

# flags of scripts/serve.py that come with later slices of the port
_LATER = {
    "--beam": "decode-variants", "--lm": "decode-variants",
    "--lm-weight": "decode-variants", "--lm-bonus": "decode-variants",
    "--ctc": "decode-variants", "--mesh": "multi-GPU",
    "--coordinator": "multi-GPU", "--num-processes": "multi-GPU",
    "--process-id": "multi-GPU",
}
_VALUED = ("--streams", "--slots", "--right-context", "--seconds",
           "--quantize", "--rc-by-layer", "--dsp", "--endpoint-silence")
_SWITCHES = ("--kv-int8", "--kv-int4", "--lockstep", "--confidence",
             "--endpoint-reset", "--cpu")
_SQ_MODES = ("w8a8-sq", "w8a8-sq-static")


def main(argv: list[str]) -> int:
    refused = later_flag(argv[1:], _LATER)
    if refused:
        print(f"error: {refused}", file=sys.stderr)
        return 1
    args = positional_args(argv, _VALUED, _SWITCHES)
    if args is None:
        return 1
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 1

    def opt(name, default, cast):
        return flag_value(argv, name, default, cast)

    n_streams = opt("--streams", 8, int)
    n_slots = opt("--slots", max(8, n_streams), int)
    R = opt("--right-context", 13, int)
    seconds = opt("--seconds", 10.0, float)
    quant_mode = opt("--quantize", None, str)
    ep_s = opt("--endpoint-silence", 0.0, float)
    ep_kw = dict(confidence="--confidence" in argv,
                 endpoint_silence_s=ep_s if ep_s > 0 else None,
                 endpoint_reset="--endpoint-reset" in argv)
    device = "cpu" if "--cpu" in argv else "cuda"

    import dataclasses
    import os

    from .cli import calibrate
    from .config import CacheConfig
    from .params import load_model, quantize_model_params
    from .streaming.lockstep import LockstepEngine
    from .streaming.serving import ServingEngine
    from .utils.audio import read_audio_file

    for path in args:
        if not os.path.exists(path):
            print(f"error: file not found: {path}", file=sys.stderr)
            return 1
    try:
        # SmoothQuant folds its scales into the DENSE weights
        params, cfg, vocab = load_model(
            args[0], device=device,
            keep_quantized=quant_mode not in _SQ_MODES)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if quant_mode and quant_mode not in _SQ_MODES:
        try:
            params = quantize_model_params(params, mode=quant_mode)
        except (KeyError, NotImplementedError):
            print(f"error: unknown --quantize mode '{quant_mode}'",
                  file=sys.stderr)
            return 1
    cc = CacheConfig(att_right_context=R, n_mels=cfg.n_mels,
                     kv_cache_int8="--kv-int8" in argv)
    if "--kv-int4" in argv:
        cc = dataclasses.replace(cc, kv_cache_int8=False, kv_cache_int4=True)
    rc_pat = opt("--rc-by-layer", None, str)
    if rc_pat:
        try:
            cc = dataclasses.replace(
                cc, att_right_context_by_layer=tuple(
                    int(v) for v in rc_pat.split(",")))
            cc.rc_schedule(cfg.n_layers)  # validate early
        except ValueError as e:
            print(f"error: bad --rc-by-layer pattern {rc_pat!r}: {e}",
                  file=sys.stderr)
            return 1
    if quant_mode in _SQ_MODES:
        params = calibrate(params, cfg, cc, quant_mode, None, args[1])
        if params is None:
            return 1
    audio = read_audio_file(args[1])

    offsets = [(i * len(audio)) // max(n_streams, 1)
               for i in range(n_streams)]
    tick = cc.shift_samples  # one chunk of audio a stream a tick
    n_ticks = int(seconds * 16000 / tick)

    def block_for(i):
        start = offsets[i] % len(audio)
        blk = np.resize(np.roll(audio, -start)[:tick], tick)
        offsets[i] += tick
        return blk

    n_utts = 0

    def report_utterances(events) -> None:
        nonlocal n_utts
        for slot, text, _toks in events:
            n_utts += 1
            if n_utts <= 5:
                print(f"[utterance slot {slot}] {text.strip()}",
                      file=sys.stderr)

    if "--lockstep" in argv:
        try:
            eng = LockstepEngine(params, cfg, vocab, cc, n_streams=n_streams,
                                 **ep_kw)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        slots = list(range(n_streams))
        tick_times = []
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            pcm = np.stack([block_for(s) for s in slots])
            tt = time.perf_counter()
            eng.tick_pipelined(pcm)
            tick_times.append(time.perf_counter() - tt)
            report_utterances(eng.poll_endpoints())
        eng.flush_pipeline()
        report_utterances(eng.poll_endpoints())
        wall = time.perf_counter() - t0
        if ep_s > 0:
            print(f"utterances finalized: {n_utts}", file=sys.stderr)
        audio_s = eng.total_chunks * n_streams * cc.valid_out_len \
            * cc.subsampling_factor * cc.hop_length / cc.sample_rate
        t = np.asarray(tick_times)
        st = {"audio_seconds_decoded": audio_s,
              "aggregate_rtf": wall / max(audio_s, 1e-9),
              "latency": {"p50": float(np.percentile(t, 50)),
                          "p90": float(np.percentile(t, 90)),
                          "p99": float(np.percentile(t, 99))}
              if t.size else {}}
    else:
        try:
            eng = ServingEngine(params, cfg, vocab, cc, n_slots=n_slots,
                                dsp=opt("--dsp", "auto", str), **ep_kw)
            slots = eng.add_streams(n_streams)
        except (ValueError, NotImplementedError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            eng.feed_audio({s: block_for(i) for i, s in enumerate(slots)})
            eng.step()
            report_utterances(eng.poll_endpoints())
        wall = time.perf_counter() - t0
        st = eng.stats()
        if ep_s > 0:
            print(f"utterances finalized: {st['utterances_finalized']}",
                  file=sys.stderr)
    print(f"streams={n_streams} slots={n_slots} mode=R{R}"
          f"{' ' + quant_mode if quant_mode else ''} device={eng.device}",
          file=sys.stderr)
    audio_s = st["audio_seconds_decoded"]
    print(f"decoded {audio_s:.1f}s of audio in {wall:.2f}s wall "
          f"({audio_s / max(wall, 1e-9):.1f}x aggregate real-time); engine "
          f"aggregate RTF {st['aggregate_rtf']:.5f}", file=sys.stderr)
    lat = st["latency"]
    if lat:
        print(f"per-tick latency p50 {lat['p50']*1e3:.1f} ms  "
              f"p90 {lat['p90']*1e3:.1f} ms  p99 {lat['p99']*1e3:.1f} ms",
              file=sys.stderr)
    for s in slots[:3]:
        print(f"[slot {s}] {eng.transcripts[s][:70]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
