"""Batch (whole-file) transcription CLI of the port.

The counterpart of `cli/transcribe.py` (reference src/transcribe.cpp):

    python -m nemotron_tpu_torch.cli_transcribe <model.gguf>
        <audio.pcm|.wav> [more audio files...]
        [--cpu|--cuda|--metal|--tpu] [--timestamps] [--confidence]
        [--srt[=FILE]|--vtt[=FILE]] [--beam=K] [--nbest=N]
        [--lm=lm.gguf] [--lm-weight=W] [--lm-bonus=B] [--lm-rescore]
        [--boost=piece:weight,...] [--ctc]

  - input: raw s16le 16 kHz mono PCM, or WAV (PCM16 or float32, any sample
    rate -- polyphase-resampled, stereo averaged)
  - several files are transcribed in ONE batched, length-masked encoder
    pass and one decode (the reference is batch = 1)
  - --beam=K decodes with the batched RNN-T beam search; --nbest=N prints
    the N best hypotheses a file with their total log-probs, best first
    (implies --beam=N without --beam); --lm=lm.gguf adds LM shallow fusion
    (labels score log P_rnnt + W * log P_lm + B, W = 0.3 by default),
    --lm-rescore reranks the finished beam with the LM instead;
    --boost=piece:weight,... adds a log-space boost to those tokens' logits;
    --ctc decodes a hybrid checkpoint with its CTC head (greedy; a TDT
    checkpoint decodes with the duration-aware walk or beam with no flag)
  - stdout: the text for one file, `path<TAB>text` lines for several;
    --timestamps puts each word's start time in {seconds} before it,
    --confidence its posterior in {p=...} (exp of the least log-posterior
    of its pieces, from the greedy loop's log softmax)
  - --srt / --vtt write subtitle cues (words grouped at silence gaps, a
    maximum duration and line length) next to each audio file, or to
    FILE when given with a single input; they, --timestamps and
    --confidence need greedy decode, and the subtitles refuse --ctc
  - runs on the CUDA card unless --cpu is given; --cuda asks for the card
    (the default), --metal and --tpu warn and are ignored; --cpu with
    --cuda is an error
  - the audio seconds, wall time and RTF go to stderr
"""

from __future__ import annotations

import os
import sys
import time

from .cli import apply_boost_flags, device_from_flags, load_lm_flag

_FLAGS = ("--cpu", "--cuda", "--metal", "--tpu", "--timestamps",
          "--confidence", "--lm-rescore", "--ctc")
_VALUED = ("--srt", "--vtt", "--beam", "--nbest", "--lm", "--lm-weight",
           "--lm-bonus", "--boost")


def main(argv: list[str]) -> int:
    args = [a for a in argv[1:] if not a.startswith("--")]
    flags = [a for a in argv[1:] if a.startswith("--")]
    if len(args) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    for f in flags:
        name = f.split("=", 1)[0]
        if f not in _FLAGS and name not in _VALUED:
            print(f"error: unsupported flag {f} (this port takes "
                  f"{', '.join(_FLAGS)}, --srt[=FILE], --vtt[=FILE], "
                  "--beam=K, --nbest=N, --lm=FILE, --lm-weight=W, "
                  "--lm-bonus=B and --boost=piece:weight,..)",
                  file=sys.stderr)
            return 1
    device = device_from_flags(flags)
    if device is None:
        return 1

    from .params import load_model
    from .streaming.session import transcribe_batch
    from .utils.audio import read_audio_file
    from .utils.subtitles import write_subtitles
    from .utils.text import tokens_to_text

    if not os.path.exists(args[0]):
        print(f"error: model file not found: {args[0]}", file=sys.stderr)
        return 1
    try:
        params, cfg, vocab = load_model(args[0], device=device)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    beam, nbest = 1, None
    lm_path, lm_weight, lm_bonus = None, 0.3, 0.0
    try:
        for f in flags:
            if f.startswith("--beam="):
                beam = int(f.split("=", 1)[1])
            elif f.startswith("--nbest="):
                nbest = int(f.split("=", 1)[1])
            elif f.startswith("--lm="):
                lm_path = f.split("=", 1)[1]
            elif f.startswith("--lm-weight="):
                lm_weight = float(f.split("=", 1)[1])
            elif f.startswith("--lm-bonus="):
                lm_bonus = float(f.split("=", 1)[1])
    except ValueError:
        print("error: --beam/--nbest take an integer, --lm-weight a float",
              file=sys.stderr)
        return 1
    if nbest is not None and beam == 1:
        beam = nbest
    subs = [f for f in flags if f.split("=", 1)[0] in ("--srt", "--vtt")]
    if len({f[2:5] for f in subs}) > 1:
        print("error: --srt and --vtt are mutually exclusive (one subtitle "
              "format per run)", file=sys.stderr)
        return 1
    sub_fmt = subs[-1][2:5] if subs else None
    sub_out = subs[-1].split("=", 1)[1] if subs and "=" in subs[-1] else None
    ctc = "--ctc" in flags
    if sub_fmt is not None and (beam != 1 or nbest is not None or ctc):
        print("error: --srt/--vtt require greedy decode (no --beam/"
              "--nbest/--ctc): cues need per-token frame alignment",
              file=sys.stderr)
        return 1
    if sub_out is not None and len(args) > 2:
        print("error: --srt=FILE/--vtt=FILE take one audio file; omit =FILE "
              "to write one subtitle file per input", file=sys.stderr)
        return 1
    lm = load_lm_flag(lm_path, device)
    if lm is False:
        return 1
    params = apply_boost_flags(params, flags, vocab, announce=False)
    if params is None:
        return 1
    audios = [read_audio_file(a) for a in args[1:]]
    t0 = time.perf_counter()
    lm_kw = dict(lm=lm, lm_weight=lm_weight, lm_bonus=lm_bonus,
                 lm_rescore="--lm-rescore" in flags)
    if nbest is not None:
        try:
            nbests = transcribe_batch(params, cfg, vocab, audios,
                                      beam_size=beam, return_nbest=nbest,
                                      **lm_kw)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        for path, hyps in zip(args[1:], nbests):
            for rank, (text, score) in enumerate(hyps):
                prefix = f"{path}\t" if len(audios) > 1 else ""
                print(f"{prefix}[{rank}] score={score:.3f}\t{text}")
        report(audios, t0, params.device)
        return 0
    if "--confidence" in flags and beam > 1:
        print("error: confidence requires greedy decode", file=sys.stderr)
        return 1
    # as in cli/transcribe.py, the confidence and subtitle outputs take
    # the greedy transducer path whatever the LM and --ctc flags say
    if ("--confidence" not in flags and sub_fmt is None
            and (beam > 1 or lm is not None or "--lm-rescore" in flags
                 or ctc)):
        try:
            texts = transcribe_batch(params, cfg, vocab, audios,
                                     timestamp_words="--timestamps" in flags,
                                     beam_size=beam, ctc=ctc, **lm_kw)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print_texts(args[1:], texts)
        report(audios, t0, params.device)
        return 0
    # the token lists carry what every output needs: frames for
    # --timestamps and subtitles, log-posteriors for --confidence
    _, tls = transcribe_batch(params, cfg, vocab, audios,
                              return_confidence=True)
    if sub_fmt is not None:
        for path, tl in zip(args[1:], tls):
            out = sub_out or os.path.splitext(path)[0] + "." + sub_fmt
            n = write_subtitles(out, tl, vocab, sub_fmt)
            print(f"wrote {n} cues to {out}", file=sys.stderr)
    texts = [tokens_to_text(tl, vocab,
                            timestamp_words="--timestamps" in flags,
                            confidence_words="--confidence" in flags)
             for tl in tls]
    print_texts(args[1:], texts)
    report(audios, t0, params.device)
    return 0


def print_texts(paths: list[str], texts: list[str]) -> None:
    """The text for one file, `path<TAB>text` lines for several."""
    if len(texts) == 1:
        print(texts[0])
    else:
        for path, text in zip(paths, texts):
            print(f"{path}\t{text}")


def report(audios, t0: float, device) -> None:
    """The audio seconds, wall time and RTF on stderr."""
    elapsed = time.perf_counter() - t0
    audio_s = sum(a.size for a in audios) / 16000.0
    print(f"{audio_s:.2f}s audio in {elapsed:.2f}s "
          f"(RTF {elapsed / max(audio_s, 1e-9):.4f}) on {device}",
          file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
