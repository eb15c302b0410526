"""Training entry point of the port: RNN-T / TDT (and hybrid CTC) training on
one CUDA card.

The counterpart of `scripts/train.py`, with its flags and its stderr
lines:

    python -m nemotron_tpu_torch.train <model.gguf | --random>
        [--config tiny|small|mid|full] [--steps N] [--batch B] [--lr LR]
        [--remat] [--save out.gguf] [--checkpoint ck.pt] [--resume ck.pt]
        [--cpu] [--task memorize|tones] [--tones N] [--utt-tones U]
        [--utt-tones-min M] [--history-max R] [--pool N]
        [--long-gap-prob P] [--delay-penalty L] [--ctc-weight W]
        [--tdt-durations 0,1,2,3] [--tdt-sigma S] [--val N]
        [--prefetch K] [--att-chunks 14,1] [--eval-every N] [--seed S]
        [--model-parallel M]

  - --random trains seeded random weights of the --config size (full,
    the 0.6B model, by default; Glorot init for --task tones); a GGUF is
    loaded dense (keep_quantized=False): the port's quantized kernels
    have no backward.
  - --task memorize (default) trains on one fixed random batch; --task
    tones on the synthetic tone-transcription task, FRESH audio every
    step rendered by --prefetch host threads (deterministic in seed and
    step, so --resume replays the same stream), with streaming-equivalent
    chunked attention alternating over --att-chunks, and reports the
    held-out token error (TER) of greedy (or TDT) decoding; --pool N
    trains on a fixed pool of N utterances (overfit and debug only).
  - the optimizer: clip by global norm 1.0, AdamW (weight decay 1e-4),
    a linear warmup then a cosine to 0.1 lr (training.make_optimizer).
  - --checkpoint writes the train state every --eval-every steps and at
    the end (the port's own file layout); --resume continues from one.
  - runs on the card unless --cpu is given.
  - the step runs over a mesh of every rank of the world (parallel/
    mesh.py): one rank, or the ranks a launcher such as
    `python -m torch.distributed.run --nproc-per-node N` starts (RANK,
    WORLD_SIZE and MASTER_ADDR/PORT in the environment; one card a rank,
    or the CPU under --cpu); --model-parallel M splits the encoder over
    M of them where M divides the rank count, else 1 (scripts/train.py's
    rule), the batch rows over the rest. Rank 0 prints and writes.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import sys
import time

import numpy as np
import torch


def tones_vocab(n_tones: int, vocab_size: int) -> list[str]:
    """A readable vocab for a tones model: the tones, the unused ids with
    short names (7-byte GGUF slots), blank last."""
    return ([f"▁T{i}" for i in range(n_tones)]
            + [f"▁u{i}" for i in range(n_tones, vocab_size - 1)]
            + ["<blank>"])


def config_of(size: str):
    """The --config sizes of scripts/train.py."""
    from .config import ModelConfig

    if size == "tiny":
        return ModelConfig(n_mels=32, d_model=128, n_heads=8, d_head=16,
                           d_ff=256, n_layers=4, vocab_size=64,
                           decoder_dim=64, joint_dim=64,
                           subsampling_channels=16)
    if size == "small":
        return ModelConfig(n_mels=64, d_model=192, n_heads=8, d_head=24,
                           d_ff=512, n_layers=6, vocab_size=64,
                           decoder_dim=128, joint_dim=128,
                           subsampling_channels=32)
    if size == "mid":
        return ModelConfig(n_mels=80, d_model=512, n_heads=8, d_head=64,
                           d_ff=2048, n_layers=8, vocab_size=256,
                           decoder_dim=320, joint_dim=320,
                           subsampling_channels=64)
    return ModelConfig()


def synthetic_batch(cfg, batch: int, mel_frames: int = 57,
                    n_labels: int = 5, seed: int = 0) -> dict:
    """The fixed random batch of --task memorize (numpy; the same draws as
    scripts/train.py's)."""
    from .utils.tones import enc_frames_of_mel

    rng = np.random.default_rng(seed)
    return {
        "mel": rng.standard_normal((batch, mel_frames, cfg.n_mels)).astype(
            np.float32),
        "labels": rng.integers(0, cfg.vocab_size - 1,
                               (batch, n_labels)).astype(np.int32),
        "mel_lengths": np.full((batch,), enc_frames_of_mel(mel_frames),
                               np.int32),
        "label_lengths": np.full((batch,), n_labels, np.int32),
    }


@torch.no_grad()
def ter_on_batch(params, cfg, batch: dict, att_chunk=None,
                 ctc: bool = False) -> float:
    """Token error rate of a batch: sum of edit distances over the sum of
    label lengths, decoding with greedy RNN-T, the TDT walk (a TDT
    config) or, with ctc, the CTC head."""
    from .models import decoder as dec_mod
    from .models.ctc import ctc_greedy_decode
    from .models.encoder import encode_batch
    from .models.tdt import tdt_greedy_decode
    from .training import as_batch
    from .utils.text import edit_distance

    b = as_batch(batch, params.device)
    enc = encode_batch(params, cfg, b["mel"], enc_lengths=b["mel_lengths"],
                       att_chunk=att_chunk)
    B = enc.shape[0]
    if ctc:
        hyps = ctc_greedy_decode(params, cfg, enc,
                                 enc_lengths=b["mel_lengths"])
    else:
        state = dec_mod.init_decoder_state(cfg, B, enc.dtype, enc.device)
        decode = (tdt_greedy_decode if cfg.tdt_durations
                  else dec_mod.greedy_decode)
        tokens = decode(params, cfg, enc, state,
                        enc_lengths=b["mel_lengths"])[0]
        hyps = [[t for t, _f in row] for row in dec_mod.tokens_to_list(
            tokens.cpu().numpy(), cfg.blank_token)]
    labels = b["labels"].cpu().numpy()
    lens = b["label_lengths"].cpu().numpy()
    dist = tot = 0
    for i in range(B):
        ref = labels[i, :lens[i]].tolist()
        dist += edit_distance(hyps[i], ref)
        tot += len(ref)
    return dist / max(tot, 1)


def join_world(device: str) -> tuple[int, int]:
    """(ranks, this rank) of the world a launcher started (RANK and
    WORLD_SIZE in the environment), joined here; (1, 0) without one."""
    import os

    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n < 2:
        return 1, 0
    from .parallel.mesh import backend_for, init_world

    rank = int(os.environ["RANK"])
    init_world("env://", n, rank, backend_for(n, device))
    if device == "cpu":     # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    return n, rank


def main(argv: list[str]) -> int:
    from .asr_server import flag_value as opt

    def opt_val(name, default, cast):
        return opt(argv, name, default, cast)

    mp = opt_val("--model-parallel", 1, int)
    if mp < 1:
        print(f"error: --model-parallel {mp}: the model axis needs at "
              "least one rank", file=sys.stderr)
        return 1
    device = "cpu" if "--cpu" in argv else "cuda"
    steps = opt_val("--steps", 20, int)
    batch = opt_val("--batch", 8, int)
    lr = opt_val("--lr", 1e-4, float)
    task = opt_val("--task", "memorize", str)
    seed = opt_val("--seed", 0, int)

    from . import params as P
    from .config import CacheConfig
    from .device import resolve_device
    from .parallel.mesh import make_mesh, shard_params
    from .training import (load_train_state, make_optimizer,
                           make_train_step, save_train_state, trainable)

    n_ranks, rank = join_world(device)
    if device == "cuda":
        device = f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
    dev = resolve_device(device)
    mesh = make_mesh(model_parallel=mp if n_ranks % mp == 0 else 1,
                     device=dev)
    if batch % mesh.data:
        print(f"error: --batch {batch} not divisible by the data axis "
              f"({mesh.data})", file=sys.stderr)
        return 1

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, file=sys.stderr, flush=True)
    ctc_w = opt_val("--ctc-weight", 0.0, float)
    if argv[1:] and argv[1] == "--random":
        cfg = config_of(opt_val("--config", "full", str))
        # TDT family: the joint's output widens by the duration head
        if "--tdt-durations" in argv:
            cfg = dataclasses.replace(cfg, tdt_durations=tuple(
                int(d) for d in opt_val("--tdt-durations", "", str)
                .split(",")))
        arrays = P.random_weight_arrays(
            cfg, seed=seed, init="glorot" if task == "tones" else "bench",
            ctc_head=ctc_w > 0)
    elif argv[1:] and not argv[1].startswith("--"):
        params, cfg, _ = P.load_model(argv[1], device=dev,
                                      keep_quantized=False)
        arrays = None
    else:
        print(__doc__, file=sys.stderr)
        return 1

    pool = val = None
    att_chunks = [None]
    if task == "tones":
        from .frontend.preprocessor import mel_filterbank_slaney
        from .utils import tones

        n_tones = opt_val("--tones", 16, int)
        utt_tones = opt_val("--utt-tones", 10, int)
        # variable utterance length: a fixed count teaches the decoder to
        # stop after exactly U tokens (utils/tones.py)
        utt_tones_min = opt_val("--utt-tones-min",
                                max(1, utt_tones // 3), int)
        # decoder warm-up history: without it the prediction network
        # learns the absolute emission count (utils/tones.py)
        hist_max = opt_val("--history-max", 192, int)
        # silence augmentation: long post-tone gaps teach silence -> blank
        long_gap_prob = opt_val("--long-gap-prob", 0.0, float)
        pool_n = opt_val("--pool", 0, int)
        if n_tones >= cfg.vocab_size - 1:
            print(f"error: --tones {n_tones} must be < vocab-1",
                  file=sys.stderr)
            return 1
        # a real mel filterbank: the tones are only separable through a
        # frequency-sensitive frontend, and the saved GGUF carries it
        fb = mel_filterbank_slaney(cfg.n_mels).astype(np.float32)
        win = np.hanning(400).astype(np.float32)
        if arrays is not None:
            arrays["preprocessor.featurizer.fb"] = fb
            arrays["preprocessor.featurizer.window"] = win
        # the data is rendered on the host, as the JAX package's is, so a
        # run on the card trains on the same mel as one with --cpu
        val = tones.make_dataset(opt_val("--val", 64, int), utt_tones,
                                 n_tones, fb, win, cfg.n_mels,
                                 seed=seed + 999983, device="cpu")
        if pool_n:
            say(f"rendering tones pool: {pool_n} utts x {utt_tones} "
                f"tones of {n_tones}")
            pool = tones.make_dataset(pool_n, utt_tones, n_tones, fb, win,
                                      cfg.n_mels, seed=seed, device="cpu")
        # streaming-equivalent chunked attention (encoder frames a chunk):
        # by default the R = 13 and R = 0 chunk geometries in turn
        cc13 = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
        cc0 = CacheConfig(att_right_context=0, n_mels=cfg.n_mels)
        default_chunks = f"{cc13.chunk_enc_len},{cc0.chunk_enc_len}"
        att_chunks = [None if c in ("none", "full") else int(c) for c in
                      opt_val("--att-chunks", default_chunks, str)
                      .split(",")]

    if arrays is not None:
        params = P.params_from_arrays(arrays, cfg, device=dev)
    params = trainable(shard_params(params, mesh))
    say(f"devices: {n_ranks}, mesh {mesh.shape}, batch {batch}, task "
        f"{task}, att_chunks {att_chunks}")

    opt_, sched = make_optimizer(params, lr, steps)
    # default 0: on the tones task lambda = 0.05 stalls training (the
    # cumulative penalty outweighs a tone's information)
    delay_pen = opt_val("--delay-penalty", 0.0, float)
    if ctc_w > 0 and params.ctc is None:
        print("error: --ctc-weight needs a model with a CTC head "
              "(ctc_decoder.* tensors; --random adds one)", file=sys.stderr)
        return 1
    if cfg.tdt_durations and delay_pen:
        print("error: --delay-penalty applies to the RNN-T lattice only "
              "(TDT trains duration-aware)", file=sys.stderr)
        return 1
    step_fns = {c: make_train_step(cfg, opt_, sched, remat="--remat" in argv,
                                   att_chunk=c, delay_penalty=delay_pen,
                                   ctc_weight=ctc_w,
                                   tdt_sigma=opt_val("--tdt-sigma", 0.05,
                                                     float), mesh=mesh)
                for c in att_chunks}

    execs: list = []
    if task == "tones" and not pool_n:
        # FRESH regime: K host threads each own one (stateful) sampler;
        # thread j % K renders step j, deterministic in (seed, step)
        K = opt_val("--prefetch", 3, int)
        execs = [concurrent.futures.ThreadPoolExecutor(1) for _ in range(K)]
        samplers = [tones.TonesSampler(fb, win, cfg.n_mels, n_tones,
                                       utt_tones, batch, seed=seed + 1,
                                       tones_per_utt_min=utt_tones_min,
                                       history_max=hist_max,
                                       long_gap_prob=long_gap_prob,
                                       device="cpu")
                    for _ in range(K)]
        pending: dict = {}

        def _ensure(i):
            for j in range(i, min(i + K, steps)):
                if j not in pending:
                    pending[j] = execs[j % K].submit(
                        samplers[j % K].sample, j)

        def next_batch(i):
            _ensure(i)
            b = pending.pop(i).result()
            _ensure(i + 1)
            return b
    elif task == "tones":
        data_rng = np.random.default_rng(seed + 1)
        pool_size = pool["labels"].shape[0]

        def next_batch(i):
            idx = data_rng.integers(0, pool_size, batch)
            return {k: v[idx] for k, v in pool.items()}
    else:
        bt = synthetic_batch(cfg, batch)

        def next_batch(i):
            return bt

    try:
        start = 0
        if "--resume" in argv:
            ck = argv[argv.index("--resume") + 1]
            start = load_train_state(ck, params, opt_, sched)
            say(f"resumed from {ck} at step {start}")

        ck = (argv[argv.index("--checkpoint") + 1]
              if "--checkpoint" in argv else None)
        eval_every = opt_val("--eval-every", max(steps // 10, 1), int)
        ctc_ter = ctc_w > 0
        t0 = time.perf_counter()
        for i in range(start, steps):
            fn = step_fns[att_chunks[i % len(att_chunks)]]
            loss = fn(params, next_batch(i))
            if i % eval_every == 0 or i == steps - 1:
                msg = (f"step {i:5d}  loss {float(loss):.4f}"
                       f"  [{time.perf_counter() - t0:.0f}s]")
                if val is not None:
                    ter = ter_on_batch(params, cfg, val,
                                       att_chunk=att_chunks[0])
                    msg += f"  val TER {ter * 100:.2f}%"
                    if ctc_ter:
                        ter = ter_on_batch(params, cfg, val,
                                           att_chunk=att_chunks[0], ctc=True)
                        msg += f"  ctc TER {ter * 100:.2f}%"
                say(msg)
                if ck is not None and i > start:
                    # a periodic snapshot (written then renamed) so a long
                    # run survives a crash
                    save_train_state(ck, params, opt_, sched, step=i + 1)
    finally:
        for ex in execs:
            ex.shutdown(wait=True, cancel_futures=True)

    if ck is not None:
        save_train_state(ck, params, opt_, sched, step=steps)
        say(f"checkpointed to {ck}")

    if "--save" in argv:
        out = argv[argv.index("--save") + 1]
        # a readable vocab for the tones task, so the CLIs render text
        vocab = tones_vocab(n_tones, cfg.vocab_size) if task == "tones" \
            else None
        P.save_model(out, params, cfg, vocab=vocab)
        say(f"saved trained weights to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
