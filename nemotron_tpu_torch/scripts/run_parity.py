"""One-command full parity ladder for a GGUF, the port against the numpy
oracle. The counterpart of `scripts/run_parity.py`:

    python -m nemotron_tpu_torch.scripts.run_parity <model.gguf>
        [audio.pcm] [--expect transcript.txt] [--reference-dir DIR]
        [--reference-oracle] [--trace-dir DIR] [--cpu] [--quick]

Runs, in order, and prints a docs/STATUS.md-style PASS/FAIL table
(reference docs/STATUS.md:241-260):

  1. load        -- GGUF parses, hparams sane, tensor census
  2. stages      -- per-stage torch-vs-numpy-oracle diff on the weights
                    (compare_layers: subsampling, full encoder, decoder
                    step, joint, streaming chunks)
  3. greedy      -- EXACT token match, the port's greedy decode vs the
                    oracle's, on the weights
  4. streaming   -- all four latency modes (R = 13 alone with --quick):
                    batch-vs-streaming transcript stats (compare_outputs
                    per mode)
  5. quant       -- if the GGUF is f32: quantize in memory (q8_0, w8a8,
                    w8a8 with int8 and int4 K/V rings) and report bf16
                    token agreement vs the f32 transcript (bar 95%)
  6. expected    -- optional: WER-style diff against a transcript produced
                    by the reference C++ binary or NeMo (--expect)
  7. reference   -- optional (--reference-dir /path/to/nemotron-speech.cpp):
                    build the reference C++ binary via its Makefile if
                    needed, run `nemotron-asr.cpp <gguf> <pcm> 1120 13` on
                    the same audio and diff transcripts with
                    compare_outputs --expect. Skips (PASS with a note) when
                    the binary can't be built here.
  8. ref oracle  -- optional (--reference-oracle): the reference's own
                    ggml-free C++ oracle (scripts/ref_oracle_parity.py, a
                    JAX script not ported yet). Skips (PASS with a note)
                    when g++ or the checkout ($NEMOTRON_REF_DIR, default
                    ~/reference) is missing; with both present the stage
                    FAILs as not run, since only the JAX package runs it.

The sub-tools (compare_layers, compare_outputs) run in this process
through their main(argv), where the JAX script starts child processes;
their stdout then their stderr go to this process's stderr, as the JAX
script writes a child's. compare_layers takes the ladder's own load of
the GGUF (scripts/_common.sharing_loads). Runs on the CUDA card unless
--cpu is given. Exit code 0 when every stage passes, 2 otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import os
import shutil
import subprocess
import sys
import tempfile
import traceback

import numpy as np
import torch

from ._common import (dense_model, device_of, host, levenshtein, positionals,
                      sharing_loads)

VALUE_FLAGS = ("--expect", "--trace-dir", "--reference-dir")


def reference_checkout() -> str:
    """The reference checkout that stage 8 looks for: $NEMOTRON_REF_DIR,
    else ~/reference."""
    return os.environ.get("NEMOTRON_REF_DIR",
                          os.path.expanduser(os.path.join("~", "reference")))


def record(results: list, stage: str, ok: bool, detail: str) -> None:
    results.append((stage, ok, detail))
    print(f"[{'PASS' if ok else 'FAIL'}] {stage}: {detail}", file=sys.stderr)


def run_tool(name: str, args: list[str]) -> tuple[int, str]:
    """nemotron_tpu_torch.scripts.<name>.main in this process: its exit
    code (1 for an exception, whose traceback is in the output, as a child
    process's) and its stdout then its stderr, which also go to stderr."""
    mod = importlib.import_module(f"{__package__}.{name}")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = mod.main([name, *args])
        except SystemExit as e:
            if e.code is None or isinstance(e.code, int):
                rc = e.code or 0
            else:
                print(e.code, file=sys.stderr)
                rc = 1
        except Exception:
            traceback.print_exc()
            rc = 1
    text = out.getvalue() + err.getvalue()
    sys.stderr.write(text)
    return rc, text


def main(argv: list[str]) -> int:
    args = positionals(argv, VALUE_FLAGS)
    if not args:
        print(__doc__, file=sys.stderr)
        return 1
    device = device_of("--cpu" in argv)
    with tempfile.TemporaryDirectory(prefix="run_parity_") as tmp, \
            sharing_loads():
        return ladder(argv, args, device, tmp)


def ladder(argv: list[str], args: list[str], device: torch.device,
           tmp: str) -> int:
    gguf_path = args[0]
    cpu = ["--cpu"] if "--cpu" in argv else []
    quick = "--quick" in argv
    results: list = []

    from .. import gguf
    from .. import params as P
    from ..config import CacheConfig
    from ..models import decoder as dec_mod
    from ..oracle.model import OracleModel

    # ---- 1. load ----
    try:
        params, cfg, vocab, arrays, g = dense_model(gguf_path, device)
        n_q = sum(1 for t in g.tensors.values()
                  if t.ggml_type != gguf.GGML_F32)
        record(results, "load", True,
               f"{len(g.tensors)} tensors ({n_q} quantized), "
               f"{cfg.n_layers} layers, d_model={cfg.d_model}, "
               f"vocab={len(vocab)}")
    except Exception as e:
        record(results, "load", False, f"{type(e).__name__}: {e}")
        return finish(results)

    # audio fixture
    if len(args) > 1:
        audio = np.fromfile(args[1], dtype="<i2")
        audio_path = args[1]
    else:
        rng = np.random.default_rng(0)
        t = np.arange(16000 * 4) / 16000.0
        audio = ((0.3 * np.sin(2 * np.pi * 440 * t)
                  + 0.05 * rng.standard_normal(t.size)) * 16000
                 ).astype(np.int16)
        audio_path = os.path.join(tmp, "run_parity_audio.pcm")
        audio.tofile(audio_path)
        print("note: no audio given; using synthetic 4 s fixture "
              "(supply real speech for a meaningful transcript gate)",
              file=sys.stderr)

    # ---- 2. per-stage oracle diff ----
    rc, _ = run_tool("compare_layers", [gguf_path, *cpu])
    record(results, "stages", rc == 0, "per-stage torch vs numpy oracle "
           f"(compare_layers rc={rc}, gate max_abs < 1e-2)")

    # ---- 3. exact greedy token match vs oracle ----
    oracle = OracleModel(arrays, cfg)
    rng = np.random.default_rng(1)
    T = 12 if quick else 40
    enc = (rng.standard_normal((T, cfg.d_model)) * 2).astype(np.float32)
    want, _ = oracle.greedy_decode(enc)
    st = dec_mod.init_decoder_state(cfg, 1, torch.float32, device)
    toks, _ = dec_mod.greedy_decode(
        params, cfg, torch.from_numpy(enc).to(device)[None], st)
    got = dec_mod.tokens_to_list(host(toks)[0], cfg.blank_token)
    match = got == [(t_, f) for t_, f in want]
    record(results, "greedy", match,
           f"{len(got)}/{len(want)} tokens exact" if match else
           f"MISMATCH: got {len(got)} want {len(want)} tokens")

    # ---- 4. streaming, all four latency modes ----
    modes = [13] if quick else [0, 1, 6, 13]
    for R in modes:
        rc, _ = run_tool("compare_outputs",
                         [gguf_path, audio_path, "--right-context", str(R),
                          *cpu])
        record(results, f"streaming R={R}", rc == 0,
               f"batch vs streaming transcripts (rc={rc})")

    # ---- 5. quantized token agreement (f32 models only) ----
    if not any(t.ggml_type != gguf.GGML_F32 for t in g.tensors.values()):
        from ..streaming.session import StreamSession

        cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)

        def run_one(p, ccx, dtype):
            s = StreamSession(p, cfg, vocab, ccx, compute_dtype=dtype)
            s.process(audio)
            s.finalize()
            return [t_ for t_, _f in s.get_tokens(0)]

        ref = run_one(params, cc, torch.float32)
        w8a8 = P.quantize_model_params(params, "w8a8")
        for name, p, ccx in (
                ("q8_0", P.quantize_model_params(params, "q8_0"), cc),
                ("w8a8", w8a8, cc),
                ("w8a8+int8kv", w8a8,
                 dataclasses.replace(cc, kv_cache_int8=True)),
                ("w8a8+int4kv", w8a8,
                 dataclasses.replace(cc, kv_cache_int4=True))):
            got = run_one(p, ccx, torch.bfloat16)
            dist = levenshtein(got, ref)
            agr = 1 - dist / max(len(ref), len(got), 1)
            record(results, f"quant {name}", agr >= 0.95,
                   f"token agreement {agr*100:.1f}% "
                   f"({dist} edits / {len(ref)} ref tokens)")

    # ---- 6. expected transcript ----
    if "--expect" in argv:
        exp = argv[argv.index("--expect") + 1]
        rc, _ = run_tool("compare_outputs",
                         [gguf_path, audio_path, "--expect", exp, *cpu])
        record(results, "expected transcript", rc == 0,
               f"WER-style gate vs {exp} (rc={rc}, bar 0.10)")

    # ---- 7. reference C++ binary (when a checkout + toolchain exist) ----
    if "--reference-dir" in argv:
        ref_dir = argv[argv.index("--reference-dir") + 1]
        ref_transcript = reference_transcript(ref_dir, gguf_path, audio_path)
        if ref_transcript is None:
            record(results, "reference binary", True,
                   "skipped: nemotron-asr.cpp absent and not buildable "
                   "here (needs the ggml clone + toolchain); ladder "
                   "remains oracle-gated")
        else:
            exp_path = os.path.join(tmp, "run_parity_reference_transcript.txt")
            with open(exp_path, "w") as f:
                f.write(ref_transcript)
            rc, _ = run_tool("compare_outputs",
                             [gguf_path, audio_path, "--expect", exp_path,
                              *cpu])
            record(results, "reference binary", rc == 0,
                   f"transcript diff vs {ref_dir}/nemotron-asr.cpp "
                   f"(rc={rc}, WER bar 0.10)")

    # ---- 8. reference C++ ORACLE (ggml-free; runnable offline) ----
    # The JAX package's scripts/ref_oracle_parity.py compiles the
    # reference's own oracle and holds the JAX pipeline to it; the port has
    # no counterpart yet, so with the checkout present the stage cannot
    # pass here.
    if "--reference-oracle" in argv:
        ref_dir = reference_checkout()
        if (shutil.which("g++") is None
                or not os.path.isdir(os.path.join(ref_dir, "src",
                                                  "reference"))):
            record(results, "reference oracle", True,
                   "skipped: g++ or reference checkout unavailable")
        else:
            record(results, "reference oracle", False,
                   f"not run: the checkout {ref_dir} is present, but "
                   "ref_oracle_parity is not ported to nemotron_tpu_torch "
                   "yet (ROADMAP.md, Queue 1); run scripts/"
                   "ref_oracle_parity.py with the JAX package")

    return finish(results)


def reference_transcript(ref_dir: str, gguf_path: str,
                         audio_path: str) -> str | None:
    """Run the reference streaming binary (building it first if needed) on
    the same GGUF + PCM; returns its stdout transcript, or None when the
    binary is unavailable (no checkout / no ggml / build failure).

    Reference argv contract: `nemotron-asr.cpp <model.gguf> <audio.pcm>
    [chunk_ms] [right_context]` (reference src/transcribe_stream.cpp:27-36),
    transcript on stdout, stats on stderr."""
    bin_path = os.path.join(ref_dir, "nemotron-asr.cpp")
    if not os.path.isdir(ref_dir):
        print(f"reference dir {ref_dir} does not exist", file=sys.stderr)
        return None
    if not os.path.exists(bin_path):
        print(f"building reference binary in {ref_dir} ...", file=sys.stderr)
        try:
            b = subprocess.run(["make", "-C", ref_dir, "nemotron-asr.cpp"],
                               capture_output=True, text=True, timeout=1800)
        except (OSError, subprocess.TimeoutExpired) as e:
            print(f"reference build failed to run: {e}", file=sys.stderr)
            return None
        if b.returncode != 0 or not os.path.exists(bin_path):
            sys.stderr.write(b.stderr[-2000:])
            return None
    try:
        proc = subprocess.run([bin_path, gguf_path, audio_path,
                               "1120", "13", "--cpu"],
                              capture_output=True, text=True, timeout=3600)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"reference binary failed to run: {e}", file=sys.stderr)
        return None
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-2000:])
        return None
    return proc.stdout.strip()


def finish(results: list) -> int:
    print("\n==== parity ladder ====")
    width = max(len(s) for s, _, _ in results)
    ok_all = True
    for stage, ok, detail in results:
        ok_all &= ok
        print(f"  {stage:{width}s}  {'PASS' if ok else 'FAIL'}  {detail}")
    print(f"==== {'ALL PASS' if ok_all else 'FAILURES PRESENT'} ====")
    return 0 if ok_all else 2


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
