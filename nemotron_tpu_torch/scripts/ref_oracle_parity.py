"""Parity against the reference's own C++ oracle.

The port's counterpart of scripts/ref_oracle_parity.py, with its flags,
its stages, its gates, its lines and its exit codes. It compiles the
reference repository's plain-C++ oracle model (its src/reference/*.cpp:
no ggml, only libc and libm) and its standalone streaming preprocessor
(src/preprocessor.cpp) through native/ref_oracle.cpp, runs them on
fixtures written here, and diffs their outputs against the port stage by
stage:

  build      g++ on native/ref_oracle.cpp and the checkout's sources
             (native/Makefile's ref_oracle flags), into build/native/
  frontend   the reference preprocessor (one-shot, and chunked, which
             must equal its one-shot bit for bit) against
             StreamingPreprocessor (numpy framing) on the same int16
             audio, filterbank and window, with an f64-FFT referee
  encoder    the reference ConvSubsampling and 24-layer ConformerEncoder
             against conv_subsampling / encode_batch on one mel and one
             set of full-size weights (written once as NEMO v1 f16 by
             utils/nemo_bin.py; both loaders widen f16 to f32 exactly),
             and the relative position table
  decoder    RNNTDecoder::forward_step + RNNTJoint::forward over an
             11-token walk against ops.lstm.lstm_step + joint_logits
  greedy     ASRPipeline::transcribe's tokens against encode_batch +
             greedy_decode: exact (the blank bias is calibrated so that
             blank wins a realistic share of the decisions)

    python -m nemotron_tpu_torch.scripts.ref_oracle_parity [--seconds 1.0]
        [--seed 3] [--cache DIR] [--json OUT.json] [--workdir DIR] [--cpu]

The checkout is $NEMOTRON_REF_DIR (default ~/reference), with
src/reference/ in it. Without it, or without g++, or when the build
fails, the build stage FAILs and the script exits 3 (the environment
cannot run the gate); otherwise it exits 0 when every stage passes and 1
otherwise. The weights (~1.2 GB f16) are cached under --cache (default
build/ref_oracle/, gitignored) and reused while their seed matches.

Gates: frontend max_abs <= 5e-4 with median <= 1e-6, p99 <= 5e-5 and at
least as close to the f64 referee as the reference; encoder max_abs <=
5e-5 (subsampling too), position table <= 2e-6; decoder max_abs <= 1e-5
on the decoder output, 2e-5 on the joint's logits; greedy exact.

Differences from the JAX script: the model stages run on the card unless
--cpu (the JAX script pins JAX to the CPU; TF32 is off on the card, so
the f32 products keep full precision); the binary is built into
build/native/ rather than native/; the cache defaults to build/ref_oracle/.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..utils.dump import append_dump, compare, read_dump
from ._common import device_of, host

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE = os.path.join(REPO, "native")
BIN = os.path.join(REPO, "build", "native", "ref_oracle")
# native/Makefile's REF_CXXFLAGS: C++20 for the reference preprocessor's
# <span>; no FMA contraction, so that the scalar math is bit-stable
REF_CXXFLAGS = ("-O3", "-std=c++20", "-march=native", "-ffp-contract=off")


def record(results: list, stage: str, ok: bool, detail: str,
           **extra) -> None:
    results.append({"stage": stage, "ok": bool(ok), "detail": detail,
                    **extra})
    print(f"[{'PASS' if ok else 'FAIL'}] {stage}: {detail}")


def run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed rc={proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def build_binary(results: list, ref_dir: str) -> bool:
    if not os.path.isdir(os.path.join(ref_dir, "src", "reference")):
        record(results, "build", False,
               f"reference checkout not found at {ref_dir}")
        return False
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        record(results, "build", False, f"toolchain unavailable: no {cxx}")
        return False
    srcs = sorted(glob.glob(os.path.join(ref_dir, "src", "reference",
                                         "*.cpp")))
    srcs.append(os.path.join(ref_dir, "src", "preprocessor.cpp"))
    os.makedirs(os.path.dirname(BIN), exist_ok=True)
    try:
        run([cxx, *REF_CXXFLAGS, f"-I{ref_dir}/src/reference",
             f"-I{ref_dir}/src", "-o", BIN,
             os.path.join(NATIVE, "ref_oracle.cpp"), *srcs])
    except (RuntimeError, OSError) as e:
        record(results, "build", False, f"toolchain unavailable: {e}")
        return False
    record(results, "build", True,
           "build/native/ref_oracle built from reference sources")
    return True


def gen_audio(seconds: float, seed: int) -> np.ndarray:
    """A deterministic speech-like fixture: tone chords and AM noise
    bursts (scripts/ref_oracle_parity.py:102-113)."""
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n, dtype=np.float64) / 16000.0
    x = np.zeros(n)
    for f0 in (220.0, 443.0, 1187.0):
        x += 0.2 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6.28))
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.1 * t))
    x += 0.15 * env * rng.standard_normal(n)
    x *= 0.5
    return np.clip(x * 32767, -32768, 32767).astype(np.int16)


def _mel_f64(audio: np.ndarray, fb: np.ndarray, win: np.ndarray):
    """The f64-FFT referee of the shared mel definition (reference
    src/preprocessor.cpp:330-395): scale, pre-emphasis, 256-zero center
    pad, Hann-512 window, |rfft|^2, the filterbank product, log."""
    from ..frontend.preprocessor import pad_window

    x = audio.astype(np.float64) / 32768.0
    emph = x - 0.97 * np.concatenate([[0.0], x[:-1]])
    buf = np.concatenate([np.zeros(256), emph])
    n_frames = (buf.size - 512) // 160 + 1
    idx = np.arange(n_frames)[:, None] * 160 + np.arange(512)[None, :]
    frames = buf[idx] * pad_window(win, 512).astype(np.float64)
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    return np.log(power @ fb.T.astype(np.float64) + 2.0 ** -24)


def stage_frontend(results, workdir, pcm_path, audio, device):
    """The reference preprocessor against StreamingPreprocessor (numpy
    framing, the spectral pass on `device`)."""
    from ..frontend.preprocessor import (StreamingPreprocessor, hann_window,
                                         mel_filterbank_slaney)

    fb = mel_filterbank_slaney().astype(np.float32)           # [128, 257]
    win = hann_window(400).astype(np.float32)
    fb_path = os.path.join(workdir, "fb.f32")
    win_path = os.path.join(workdir, "win.f32")
    fb.tofile(fb_path)
    win.tofile(win_path)

    pp = StreamingPreprocessor(fb, win, n_streams=1, device=device,
                               backend="numpy")
    my_mel = pp.process(audio)[0]                             # [T, 128]
    my_mel_path = os.path.join(workdir, "my.mel")
    if os.path.exists(my_mel_path):   # append_dump grows a file
        os.remove(my_mel_path)
    append_dump(my_mel_path, my_mel)

    ref_mel_path = os.path.join(workdir, "ref.mel")
    run([BIN, "preprocess", fb_path, win_path, pcm_path, ref_mel_path])
    ref_mel = read_dump(ref_mel_path)

    # Two f32 FFTs (the reference's scalar radix-2 and torch.fft) differ
    # by ~1e-4 in the log domain at near-silent bins, where log(power +
    # 2^-24) magnifies each one's rounding; so the gate is attributed:
    # tight at the median and p99, bounded at the worst bin, and at least
    # as close to an f64-FFT referee as the reference itself.
    mel64 = _mel_f64(audio, fb, win)
    if ref_mel.shape == my_mel.shape == mel64.shape:
        s = compare(ref_mel, my_mel)
        ref64 = compare(ref_mel, mel64)
        my64 = compare(my_mel, mel64)
        ok = (s["median_abs"] <= 1e-6 and s["p99_abs"] <= 5e-5
              and s["max_abs"] <= 5e-4
              and my64["max_abs"] <= ref64["max_abs"])
        record(results, "frontend", ok,
               f"mel {my_mel.shape}: vs ref median {s['median_abs']:.1e} "
               f"p99 {s['p99_abs']:.1e} max {s['max_abs']:.1e}; "
               f"f64 referee: ref {ref64['max_abs']:.1e}, "
               f"mine {my64['max_abs']:.1e} (mine at least as accurate)",
               max_abs=float(s["max_abs"]), p99_abs=float(s["p99_abs"]),
               median_abs=float(s["median_abs"]),
               ref_vs_f64_max=float(ref64["max_abs"]),
               mine_vs_f64_max=float(my64["max_abs"]))
    else:
        record(results, "frontend", False,
               f"SHAPE mismatch mine {my_mel.shape} ref {ref_mel.shape}")

    # the reference, chunked: its residue ring and pre-emphasis carry
    # across calls must give its own one-shot output bit for bit
    ref_mel_c_path = os.path.join(workdir, "ref_chunked.mel")
    run([BIN, "preprocess_chunked", fb_path, win_path, pcm_path,
         ref_mel_c_path, "1600"])                             # 100 ms chunks
    ref_mel_c = read_dump(ref_mel_c_path)
    okc = (ref_mel_c.shape == ref_mel.shape
           and np.array_equal(ref_mel_c, ref_mel))
    record(results, "frontend_chunked", okc,
           "reference 100 ms-chunked == reference one-shot (bit-exact); "
           "chunked-vs-mine therefore matches the one-shot gate")
    return my_mel_path


def _params(arrays, device):
    from ..config import ModelConfig
    from ..params import params_from_arrays

    cfg = ModelConfig()
    return params_from_arrays(arrays, cfg, device=device), cfg


def ensure_weights(cache: str, seed: int, mel_path: str, device) -> dict:
    """Full-size NEMO v1 f16 weights with a calibrated blank bias, made or
    reused: {path, arrays (read back from the f16 file, so both sides see
    the C++ loader's bits), blank_bias}."""
    from ..config import ModelConfig
    from ..models.decoder import (init_decoder_state, joint_logits,
                                  joint_project_enc)
    from ..models.encoder import encode_batch
    from ..ops.lstm import lstm_step
    from ..params import random_weight_arrays
    from ..utils.nemo_bin import read_nemo_bin, write_nemo_bin

    os.makedirs(cache, exist_ok=True)
    model_path = os.path.join(cache, "model.bin")
    meta_path = os.path.join(cache, "model.meta.json")
    want = {"seed": seed, "version": 3}
    if os.path.exists(model_path) and os.path.exists(meta_path):
        with open(meta_path) as f:
            have = json.load(f)
        if {k: have.get(k) for k in want} == want:
            print(f"[cache] reusing {model_path} "
                  f"(blank_bias {have['blank_bias']:.3f})")
            return {"path": model_path,
                    "arrays": read_nemo_bin(model_path),
                    "blank_bias": have["blank_bias"]}

    cfg = ModelConfig()
    print("[weights] generating full-size random arrays "
          f"(d_model={cfg.d_model}, {cfg.n_layers} layers) ...")
    arrays = random_weight_arrays(cfg, seed=seed)

    # The blank bias: the 40th percentile, over the frames, of the gap
    # between the best non-blank logit and blank's under the initial
    # (post-blank-step) decoder state, so blank wins ~40% of those
    # decisions -- a mix of emissions and blanks that runs both the
    # state-update and the state-freeze paths of the reference's greedy
    # decode (its greedy_decode.cpp:43-47).
    print("[weights] calibrating blank bias on the mel fixture ...")
    params, _ = _params(arrays, device)
    mel = torch.from_numpy(read_dump(mel_path)[None]).to(device)
    enc = encode_batch(params, cfg, mel)
    st = init_decoder_state(cfg, 1, torch.float32, device)
    emb = params.decoder.embedding[torch.tensor([cfg.blank_token],
                                                device=device)]
    dec_out, _, _ = lstm_step(params.decoder, emb, st.h, st.c)
    logits = host(joint_logits(params.joint,
                               joint_project_enc(params.joint, enc),
                               dec_out[:, None]))             # [1, T, V]
    frame_max = logits[0, :, :cfg.blank_token].max(axis=-1)   # [T]
    gap = frame_max - logits[0, :, cfg.blank_token]
    blank_bias = float(np.round(np.percentile(gap, 40), 3))
    arrays["joint.joint_net.2.bias"] = arrays["joint.joint_net.2.bias"].copy()
    arrays["joint.joint_net.2.bias"][cfg.blank_token] += np.float32(blank_bias)

    print(f"[weights] writing f16 NEMO v1 to {model_path} "
          f"(blank_bias {blank_bias:+.3f}) ...")
    write_nemo_bin(model_path, arrays, f16=True)
    with open(meta_path, "w") as f:
        json.dump({**want, "blank_bias": blank_bias}, f)
    return {"path": model_path, "arrays": read_nemo_bin(model_path),
            "blank_bias": blank_bias}


def stage_encoder(results, workdir, model_path, arrays, mel_path, device):
    from ..models.encoder import encode_batch
    from ..ops.conv import conv_subsampling
    from ..ops.rel_attention import pos_emb_descending

    params, cfg = _params(arrays, device)
    mel_np = read_dump(mel_path)
    mel = torch.from_numpy(mel_np[None]).to(device)

    outdir = os.path.join(workdir, "ref_enc")
    os.makedirs(outdir, exist_ok=True)
    run([BIN, "encode", model_path, mel_path, outdir])

    my_sub = host(conv_subsampling(params.subsampling, mel))[0]
    ref_sub = read_dump(os.path.join(outdir, "sub_out.bin"))
    ss = compare(ref_sub, my_sub)
    ok = ref_sub.shape == my_sub.shape and ss["max_abs"] <= 5e-5
    record(results, "encoder_subsampling", ok,
           f"sub_out {my_sub.shape}: max_abs {ss['max_abs']:.2e}",
           max_abs=float(ss["max_abs"]))

    my_enc = host(encode_batch(params, cfg, mel))[0]
    ref_enc = read_dump(os.path.join(outdir, "enc_out.bin"))
    se = compare(ref_enc, my_enc)
    ok = ref_enc.shape == my_enc.shape and se["max_abs"] <= 5e-5
    record(results, "encoder", ok,
           f"enc_out {my_enc.shape}: max_abs {se['max_abs']:.2e} "
           f"corr {se['corr']:.6f}",
           max_abs=float(se["max_abs"]))

    my_pos = pos_emb_descending(my_sub.shape[0], cfg.d_model)
    ref_pos = read_dump(os.path.join(outdir, "pos_emb.bin"))
    sp = compare(ref_pos, my_pos)
    ok = ref_pos.shape == my_pos.shape and sp["max_abs"] <= 2e-6
    record(results, "pos_emb", ok, f"pos_emb {my_pos.shape}: "
           f"max_abs {sp['max_abs']:.2e}", max_abs=float(sp["max_abs"]))
    return my_enc, ref_enc


def stage_decoder(results, workdir, model_path, arrays, device):
    from ..models.decoder import joint_logits, joint_project_enc
    from ..ops.lstm import lstm_step

    params, cfg = _params(arrays, device)
    outdir = os.path.join(workdir, "ref_dec")
    os.makedirs(outdir, exist_ok=True)
    run([BIN, "decstep", model_path, outdir])

    # native/ref_oracle.cpp cmd_decstep's inputs: an encoder frame exact in
    # f32 and the same 11-token walk
    d = np.arange(1024)
    enc_frame = (((d * 37) % 101).astype(np.int32) - 50).astype(
        np.float32) / 64.0
    tokens = [1024, 5, 17, 999, 0, 511, 1023, 256, 77, 1024, 42]

    h = torch.zeros((1, cfg.decoder_layers, cfg.decoder_dim), device=device)
    c = torch.zeros_like(h)
    enc_proj = joint_project_enc(
        params.joint, torch.from_numpy(enc_frame[None]).to(device))
    dec_hist, logit_hist = [], []
    for tok in tokens:
        emb = params.decoder.embedding[torch.tensor([tok], device=device)]
        dec_out, h, c = lstm_step(params.decoder, emb, h, c)
        logits = joint_logits(params.joint, enc_proj, dec_out)
        dec_hist.append(host(dec_out)[0])
        logit_hist.append(host(logits)[0])

    ref_dec = read_dump(os.path.join(outdir, "dec_out.bin"))
    ref_log = read_dump(os.path.join(outdir, "logits.bin"))
    sd = compare(ref_dec, np.stack(dec_hist))
    sl = compare(ref_log, np.stack(logit_hist))
    ok = sd["max_abs"] <= 1e-5 and sl["max_abs"] <= 2e-5
    record(results, "decoder_joint", ok,
           f"dec_out max_abs {sd['max_abs']:.2e}, "
           f"logits max_abs {sl['max_abs']:.2e} over {len(tokens)} steps",
           dec_max_abs=float(sd["max_abs"]),
           logit_max_abs=float(sl["max_abs"]))


def stage_greedy(results, model_path, arrays, mel_path, device):
    from ..models.decoder import greedy_decode, init_decoder_state
    from ..models.encoder import encode_batch

    params, cfg = _params(arrays, device)
    mel = torch.from_numpy(read_dump(mel_path)[None]).to(device)

    out = run([BIN, "greedy", model_path, mel_path])
    ref_tokens: list[int] = []
    min_margin = n_decisions = None
    for line in out.splitlines():
        if line.startswith("tokens:"):
            body = line.split(":", 1)[1].strip()
            ref_tokens = [int(x) for x in body.split(",")] if body else []
        elif line.startswith("min_margin:"):
            min_margin = float(line.split(":")[1])
        elif line.startswith("n_decisions:"):
            n_decisions = int(line.split(":")[1])

    enc = encode_batch(params, cfg, mel)
    toks, _ = greedy_decode(params, cfg, enc,
                            init_decoder_state(cfg, 1, torch.float32,
                                               device))
    toks = host(toks)[0].reshape(-1)
    my_tokens = [int(t) for t in toks if t != cfg.blank_token]

    ok = my_tokens == ref_tokens and len(ref_tokens) > 0
    blanks = (n_decisions - len(ref_tokens)) if n_decisions else 0
    first_diff = next((i for i, (a, b) in enumerate(zip(my_tokens,
                                                        ref_tokens))
                       if a != b), min(len(my_tokens), len(ref_tokens)))
    record(results, "greedy", ok,
           f"{len(ref_tokens)} tokens exact"
           f" ({blanks}/{n_decisions} decisions were blank,"
           f" ref min argmax margin {min_margin:.4f})" if ok else
           f"MISMATCH mine {len(my_tokens)} toks vs ref {len(ref_tokens)}: "
           f"first diff at {first_diff}",
           n_tokens=len(ref_tokens), min_margin=min_margin,
           n_decisions=n_decisions)


def _emit(path: str | None, results: list) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(results, f, indent=1)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv if argv is None else argv
    ap = argparse.ArgumentParser(prog="ref_oracle_parity")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--cache",
                    default=os.path.join(REPO, "build", "ref_oracle"))
    ap.add_argument("--json", default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv[1:])

    from .run_parity import reference_checkout

    device = device_of(args.cpu)
    results: list = []
    workdir = args.workdir or tempfile.mkdtemp(prefix="ref_oracle_")
    os.makedirs(workdir, exist_ok=True)

    if not build_binary(results, reference_checkout()):
        _emit(args.json, results)
        return 3  # the environment cannot run the gate

    audio = gen_audio(args.seconds, args.seed)
    pcm_path = os.path.join(workdir, "audio.pcm")
    audio.tofile(pcm_path)

    with torch.no_grad():
        mel_path = stage_frontend(results, workdir, pcm_path, audio, device)
        w = ensure_weights(args.cache, args.seed, mel_path, device)
        stage_encoder(results, workdir, w["path"], w["arrays"], mel_path,
                      device)
        stage_decoder(results, workdir, w["path"], w["arrays"], device)
        stage_greedy(results, w["path"], w["arrays"], mel_path, device)

    _emit(args.json, results)
    n_fail = sum(not r["ok"] for r in results)
    print(f"\n{'ALL PASS' if n_fail == 0 else f'{n_fail} FAILURES'} "
          f"({len(results)} stages) -- reference C++ vs torch")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
