"""Streaming ASR server of the port: many network clients, one ServingEngine
slab on the card.

The counterpart of `scripts/asr_server.py`:

    python -m nemotron_tpu_torch.asr_server <model.gguf> [--host H]
        [--port P] [--slots S] [--right-context R] [--rc-by-layer 13,6,1,0]
        [--quantize q8_0|w8a8] [--kv-int8|--kv-int4]
        [--dsp auto|native|numpy|device]
        [--confidence] [--endpoint-silence S] [--endpoint-reset]
        [--beam K] [--lm lm.gguf] [--lm-weight W] [--lm-bonus B]
        [--refine] [--refine-beam K] [--ctc]
        [--tick-ms T] [--http-stats PORT] [--ws-port PORT]
        [--stats-every SECONDS] [--cpu]

  - protocol: see nemotron_tpu_torch/server.py (length-prefixed frames;
    s16le 16 kHz mono PCM in, JSON transcript events out); --http-stats
    serves GET /metrics, GET /stats and POST /transcribe, --ws-port the
    WebSocket transport; port 0 picks a free port (printed on stderr)
  - drive it with `python -m nemotron_tpu_torch.asr_client` or
    nemotron_tpu_torch.client.ASRClient
  - runs on the CUDA card unless --cpu is given, in bf16 (the engine's
    compute dtype)
  - stdout stays quiet (transcripts belong to the clients); configuration
    and periodic stats go to stderr
  - --kv-int4 keeps int4 K/V rings (packed two a byte), --rc-by-layer a
    right context per layer group (NeMo's per-layer lookahead)
  - --beam K decodes every tick with the batched beam search (revisable
    PARTIAL events, replace=true), --lm adds LM shallow fusion to it
  - --refine (two-pass serving, needs --endpoint-silence): each endpointed
    utterance is re-decoded offline with a beam of --refine-beam
    hypotheses (4; with the --lm, if given) and its UTTERANCE event
    carries the result as "refined"
  - --ctc decodes a hybrid checkpoint with its CTC head; a TDT checkpoint
    decodes with the duration-aware walk (or beam) with no flag
  - --dsp picks the engine's DSP: "native" the C++ host frontend
    (native/frontend.cpp, built into build/native/ at first use; exit 1
    when it cannot be built), "auto" the card's DSP on the card, else
    native when it builds, else numpy
  - scripts/asr_server.py has no --coordinator, and neither has this
    server (an unsupported flag: exit 1)
"""

from __future__ import annotations

import asyncio
import sys
import time

_VALUED = ("--host", "--port", "--slots", "--right-context", "--quantize",
           "--dsp", "--endpoint-silence", "--tick-ms", "--http-stats",
           "--ws-port", "--stats-every", "--rc-by-layer", "--beam", "--lm",
           "--lm-weight", "--lm-bonus", "--refine-beam")
_SWITCHES = ("--kv-int8", "--kv-int4", "--confidence", "--endpoint-reset",
             "--cpu", "--refine", "--ctc")


def positional_args(argv: list[str], valued, switches) -> list | None:
    """The positional arguments of argv[1:], or None after printing the
    error for a flag in `valued` without its value or a flag that is in
    neither `valued` nor `switches`."""
    args, i = [], 1
    while i < len(argv):
        a = argv[i]
        if a in valued:
            if i + 1 >= len(argv):
                print(f"error: {a} needs a value", file=sys.stderr)
                return None
            i += 2
            continue
        if a.startswith("--") and a not in switches:
            print(f"error: unsupported flag {a}", file=sys.stderr)
            return None
        if not a.startswith("--"):
            args.append(a)
        i += 1
    return args


def flag_value(argv: list[str], name: str, default, cast):
    """The value after flag `name` in argv through `cast`, or `default`
    when the flag is absent; an invalid value exits 1."""
    if name not in argv:
        return default
    raw = argv[argv.index(name) + 1]
    try:
        return cast(raw)
    except ValueError:
        print(f"error: invalid value for {name}: {raw!r}", file=sys.stderr)
        raise SystemExit(1)


def main(argv: list[str]) -> int:
    args = positional_args(argv, _VALUED, _SWITCHES)
    if args is None:
        return 1
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 1

    def opt(name, default, cast):
        return flag_value(argv, name, default, cast)

    host = opt("--host", "127.0.0.1", str)
    port = opt("--port", 8765, int)
    n_slots = opt("--slots", 64, int)
    R = opt("--right-context", 13, int)
    dsp = opt("--dsp", "auto", str)
    tick_ms = opt("--tick-ms", 0.0, float)
    stats_every = opt("--stats-every", 30.0, float)
    # utterance endpointing: after S seconds of post-emission silence a
    # slot fires an UTTERANCE event and its prediction network restarts
    ep_s = opt("--endpoint-silence", 0.0, float)
    http_stats = opt("--http-stats", -1, int)
    ws_port = opt("--ws-port", -1, int)
    quant_mode = opt("--quantize", None, str)
    beam_k = opt("--beam", 1, int)
    lm_path = opt("--lm", None, str)
    lm_weight = opt("--lm-weight", 0.3, float)
    lm_bonus = opt("--lm-bonus", 0.0, float)
    # two-pass serving: the engine keeps each utterance's audio and the
    # refiner re-decodes it with a beam (+ the --lm) at its endpoint
    refine = "--refine" in argv
    refine_beam = opt("--refine-beam", 4, int)
    device = "cpu" if "--cpu" in argv else "cuda"

    import dataclasses
    import os

    from .cli import load_lm_flag
    from .config import CacheConfig
    from .params import load_model, quantize_model_params
    from .server import ASRServer
    from .streaming.serving import ServingEngine

    if not os.path.exists(args[0]):
        print(f"error: model file not found: {args[0]}", file=sys.stderr)
        return 1
    try:
        params, cfg, vocab = load_model(args[0], device=device)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    lm = load_lm_flag(lm_path, device)
    if lm is False:
        return 1
    if quant_mode:
        try:
            params = quantize_model_params(params, mode=quant_mode)
        except (KeyError, NotImplementedError) as e:
            print(f"error: --quantize {quant_mode}: {e}", file=sys.stderr)
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
    try:
        engine = ServingEngine(params, cfg, vocab, cc, n_slots=n_slots,
                               dsp=dsp, beam_size=beam_k,
                               lm=None if refine else lm,
                               lm_weight=lm_weight, lm_bonus=lm_bonus,
                               confidence="--confidence" in argv,
                               ctc="--ctc" in argv,
                               endpoint_silence_s=ep_s if ep_s > 0 else None,
                               endpoint_reset="--endpoint-reset" in argv,
                               keep_segment_audio=refine)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    refiner = None
    if refine:
        from .streaming.refine import SegmentRefiner

        try:
            refiner = SegmentRefiner(params, cfg, vocab,
                                     beam_size=refine_beam, lm=lm,
                                     lm_weight=lm_weight, lm_bonus=lm_bonus)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    server = ASRServer(engine, host=host, port=port,
                       tick_interval=tick_ms / 1000.0 if tick_ms else None,
                       http_stats_port=http_stats if http_stats >= 0
                       else None,
                       ws_port=ws_port if ws_port >= 0 else None,
                       refiner=refiner)

    async def run():
        await server.start()
        print(f"listening on {server.host}:{server.port}  "
              f"slots={n_slots} R={R} dsp={engine.dsp_mode} "
              f"beam={beam_k} device={engine.device} tick="
              f"{server.tick_interval * 1000:.0f}ms",
              file=sys.stderr, flush=True)
        if server.http_stats_port is not None:
            print(f"http on {server.host}:{server.http_stats_port} "
                  "(GET /metrics, GET /stats, POST /transcribe)",
                  file=sys.stderr, flush=True)
        if server.ws_port is not None:
            print(f"websocket on ws://{server.host}:{server.ws_port}/",
                  file=sys.stderr, flush=True)
        last = time.time()
        try:
            while True:
                await asyncio.sleep(1.0)
                if stats_every and time.time() - last >= stats_every:
                    last = time.time()
                    st = server.stats()
                    print(f"stats: conns={st['connections']} "
                          f"total={st['connections_total']} "
                          f"active_slots={st['active_slots']} "
                          f"steps={st['engine_steps']} "
                          f"rtf={st['aggregate_rtf']:.4f}",
                          file=sys.stderr, flush=True)
        finally:
            await server.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        print("shutting down", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
