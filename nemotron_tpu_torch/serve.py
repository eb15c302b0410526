"""Many-stream serving demo of the port: N concurrent streams replaying a
PCM/WAV file through the continuous-batching engine or the lockstep
engine, with aggregate throughput and tick-latency percentiles.

The counterpart of `scripts/serve.py`:

    python -m nemotron_tpu_torch.serve <model.gguf> <audio.pcm|.wav>
        [--streams N] [--slots S] [--right-context R] [--seconds T]
        [--quantize q8_0|w8a8|w8a8-sq|w8a8-sq-static] [--kv-int8|--kv-int4]
        [--rc-by-layer 13,6,1,0] [--lockstep]
        [--dsp auto|native|numpy|device]
        [--confidence] [--endpoint-silence S] [--endpoint-reset]
        [--beam K] [--lm lm.gguf] [--lm-weight W] [--lm-bonus B] [--ctc]
        [--mesh N] [--coordinator H:P --num-processes N --process-id I]
        [--cpu]

  - --lockstep: every stream advances every tick through LockstepEngine
    (DSP, encoder and decode in one tick, pipelined one tick deep);
    without it the ragged ServingEngine with S slots and --dsp
  - --beam K decodes with the batched beam search in either engine, --lm
    adds LM shallow fusion to it; --ctc decodes a hybrid checkpoint with
    its CTC head (a TDT checkpoint decodes TDT with no flag)
  - streams are staggered: each starts at another offset into the audio,
    wrapping around, and takes one chunk shift of samples a tick
  - runs on the CUDA card unless --cpu is given, in bf16; -sq modes
    calibrate SmoothQuant on the audio's first 20 s
  - the summary (aggregate real-time, tick p50/p90/p99) goes to stderr,
    the first three streams' transcripts to stdout
  - --mesh N starts N local ranks under torch.distributed.run (or runs
    as a rank of the N that a launcher started), one device each (cuda:i,
    or the CPU under --cpu), over a data-parallel mesh (parallel/
    mesh.py): NCCL
    where every rank has a card of its own, gloo where ranks share one;
    each rank prints its backend and device on stderr, rank 0 the summary
  - --coordinator H:P --num-processes N --process-id I (with --lockstep):
    this process is rank I of N serving one MultihostLockstep slab
    (parallel/multihost.py), feeding and reading only its own rows; rank
    0 creates the world at H:P
  - --dsp native runs the ServingEngine's DSP in the C++ host frontend
    (native/frontend.cpp, built into build/native/ at first use; exit 1
    when it cannot be built)
  - --beam K with --mesh N: each rank holds its rows of the beam state
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .asr_server import flag_value, positional_args

_VALUED = ("--streams", "--slots", "--right-context", "--seconds",
           "--quantize", "--rc-by-layer", "--dsp", "--endpoint-silence",
           "--beam", "--lm", "--lm-weight", "--lm-bonus", "--mesh",
           "--coordinator", "--num-processes", "--process-id")
_SWITCHES = ("--kv-int8", "--kv-int4", "--lockstep", "--confidence",
             "--endpoint-reset", "--cpu", "--ctc")
_SQ_MODES = ("w8a8-sq", "w8a8-sq-static")


def start_ranks(argv: list[str], n: int) -> int:
    """`--mesh N` in a process that no launcher started: run this command
    as N ranks on this host under torch.distributed.run (which stops every
    rank when one fails); its exit code."""
    import subprocess

    return subprocess.call([sys.executable, "-m", "torch.distributed.run",
                            "--standalone", "--nproc-per-node", str(n), "-m",
                            "nemotron_tpu_torch.serve", *argv[1:]])


def join_mesh(n: int, device: str):
    """In a rank of the launcher's world (RANK, WORLD_SIZE, LOCAL_RANK and
    MASTER_ADDR/PORT in the environment): join it and return (the
    data-parallel mesh, this rank's device), printing its backend."""
    import os

    import torch

    from .parallel.mesh import backend_for, init_world, make_mesh

    rank = int(os.environ["RANK"])
    if int(os.environ["WORLD_SIZE"]) != n:
        raise ValueError(f"--mesh {n} in a world of "
                         f"{os.environ['WORLD_SIZE']} ranks")
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = f"cuda:{local % max(torch.cuda.device_count(), 1)}"
    else:   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    backend = init_world("env://", n, rank, backend_for(n, device))
    mesh = make_mesh(device=device)
    print(f"rank {rank}/{n}: backend {backend}, device {device}",
          file=sys.stderr)
    return mesh, device


def main(argv: list[str]) -> int:
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
    beam_k = opt("--beam", 1, int)
    ep_kw = dict(confidence="--confidence" in argv, ctc="--ctc" in argv,
                 endpoint_silence_s=ep_s if ep_s > 0 else None,
                 endpoint_reset="--endpoint-reset" in argv, beam_size=beam_k,
                 lm_weight=opt("--lm-weight", 0.3, float),
                 lm_bonus=opt("--lm-bonus", 0.0, float))
    device = "cpu" if "--cpu" in argv else "cuda"
    mesh_n = opt("--mesh", 0, int)
    coordinator = opt("--coordinator", None, str)
    if mesh_n and coordinator:
        print("error: --mesh and --coordinator exclude each other",
              file=sys.stderr)
        return 1
    if mesh_n < 0 or (mesh_n and (n_streams if "--lockstep" in argv
                                  else n_slots) % mesh_n):
        print(f"error: --mesh {mesh_n}: the streams and slots must be "
              "divisible by the ranks (the data axis)", file=sys.stderr)
        return 1
    if coordinator:
        # JAX's rule: the ragged ServingEngine's admission calls are
        # per-process data-dependent
        if "--lockstep" not in argv:
            print("error: multihost serving requires --lockstep (the "
                  "ragged ServingEngine's admission calls are per-process "
                  "data-dependent)", file=sys.stderr)
            return 1
        if opt("--num-processes", 2, int) < 2:
            print("error: MultihostLockstep needs a torch.distributed "
                  "world of two or more ranks; use --lockstep alone in one "
                  "process", file=sys.stderr)
            return 1
    import os

    mesh = None
    rank = 0
    if mesh_n:
        if "RANK" not in os.environ:
            return start_ranks(argv, mesh_n)
        try:
            mesh, device = join_mesh(mesh_n, device)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        rank = mesh.rank
    elif coordinator:
        import torch

        from .parallel.multihost import init_multihost

        rank = opt("--process-id", 0, int)
        n_proc = opt("--num-processes", 2, int)
        if device == "cuda":
            device = f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
        else:   # the processes may share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_proc))
        backend = init_multihost(coordinator, n_proc, rank,
                                 cpu_gloo=device == "cpu")
        print(f"process {rank}/{n_proc}: backend {backend}, device "
              f"{device}", file=sys.stderr)

    import dataclasses

    from .cli import calibrate, load_lm_flag
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
    ep_kw["lm"] = load_lm_flag(opt("--lm", None, str), device)
    if ep_kw["lm"] is False:
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
            if coordinator:
                # one slab over every process's ranks; this process feeds
                # and reads only its own rows (global row indices)
                from .parallel.multihost import MultihostLockstep

                eng = MultihostLockstep(params, cfg, vocab, cc,
                                        n_streams=n_streams, **ep_kw)
                rows = [int(r) for r in eng.local_rows]
            else:
                eng = LockstepEngine(params, cfg, vocab, cc,
                                     n_streams=n_streams, mesh=mesh, **ep_kw)
                rows = list(range(n_streams))
        except (ValueError, RuntimeError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        slots = list(range(len(rows)))  # engine-local indices
        tick_times = []
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            pcm = np.stack([block_for(r) for r in rows])
            tt = time.perf_counter()
            eng.tick_pipelined(pcm)
            tick_times.append(time.perf_counter() - tt)
            report_utterances(eng.poll_endpoints())
        eng.flush_pipeline()
        report_utterances(eng.poll_endpoints())
        wall = time.perf_counter() - t0
        if ep_s > 0:
            print(f"utterances finalized: {n_utts}", file=sys.stderr)
        audio_s = eng.total_chunks * len(rows) * cc.valid_out_len \
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
                                dsp=opt("--dsp", "auto", str), mesh=mesh,
                                **ep_kw)
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
        if ep_s > 0 and rank == 0:
            print(f"utterances finalized: {st['utterances_finalized']}",
                  file=sys.stderr)
    eng.refresh_transcripts()
    if mesh is not None and rank != 0:
        return 0          # rank 0 of a mesh reports for every rank
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
