"""Batch (whole-file) transcription CLI of the port.

The counterpart of `cli/transcribe.py` (reference src/transcribe.cpp):

    python -m nemotron_tpu_torch.cli_transcribe <model.gguf>
        <audio.pcm|.wav> [more audio files...]
        [--cpu|--cuda|--metal|--tpu] [--timestamps]

  - input: raw s16le 16 kHz mono PCM, or WAV (PCM16 or float32, any sample
    rate -- polyphase-resampled, stereo averaged)
  - several files are transcribed in ONE batched, length-masked encoder
    pass and one greedy decode (the reference is batch = 1)
  - stdout: the text for one file, `path<TAB>text` lines for several;
    --timestamps puts each word's start time in {seconds} before it
  - runs on the CUDA card unless --cpu is given; --cuda asks for the card
    (the default), --metal and --tpu warn and are ignored; --cpu with
    --cuda is an error
  - the audio seconds, wall time and RTF go to stderr
"""

from __future__ import annotations

import os
import sys
import time

from .cli import device_from_flags

_FLAGS = ("--cpu", "--cuda", "--metal", "--tpu", "--timestamps")
# flags of cli/transcribe.py that come with later slices of the port
_LATER = {
    "--beam": "decode-variants", "--nbest": "decode-variants",
    "--ctc": "decode-variants", "--lm": "decode-variants",
    "--lm-weight": "decode-variants", "--lm-bonus": "decode-variants",
    "--lm-rescore": "decode-variants", "--boost": "decode-variants",
    "--confidence": "timestamps, confidence and subtitles",
    "--srt": "timestamps, confidence and subtitles",
    "--vtt": "timestamps, confidence and subtitles",
}


def main(argv: list[str]) -> int:
    args = [a for a in argv[1:] if not a.startswith("--")]
    flags = [a for a in argv[1:] if a.startswith("--")]
    if len(args) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    for f in flags:
        name = f.split("=", 1)[0]
        if name in _LATER:
            print(f"error: {name} comes with the {_LATER[name]} slice of "
                  "this port", file=sys.stderr)
            return 1
        if f not in _FLAGS:
            print(f"error: unsupported flag {f} (this port takes "
                  f"{', '.join(_FLAGS)})", file=sys.stderr)
            return 1
    device = device_from_flags(flags)
    if device is None:
        return 1

    from .params import load_model
    from .streaming.session import transcribe_batch
    from .utils.audio import read_audio_file

    if not os.path.exists(args[0]):
        print(f"error: model file not found: {args[0]}", file=sys.stderr)
        return 1
    try:
        params, cfg, vocab = load_model(args[0], device=device)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    audios = [read_audio_file(a) for a in args[1:]]
    t0 = time.perf_counter()
    texts = transcribe_batch(params, cfg, vocab,
                             audios if len(audios) > 1 else audios[0],
                             timestamp_words="--timestamps" in flags)
    elapsed = time.perf_counter() - t0
    if len(audios) == 1:
        print(texts)
    else:
        for path, text in zip(args[1:], texts):
            print(f"{path}\t{text}")
    audio_s = sum(a.size for a in audios) / 16000.0
    print(f"{audio_s:.2f}s audio in {elapsed:.2f}s "
          f"(RTF {elapsed / max(audio_s, 1e-9):.4f}) on {params.device}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
