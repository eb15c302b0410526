"""Stream an audio file (or stdin) to a running server of the port
(`python -m nemotron_tpu_torch.asr_server`) and print the incremental
transcript -- the reference CLI's UX (src/transcribe_stream.cpp:143-191)
over the network. The counterpart of `scripts/asr_client.py`:

    python -m nemotron_tpu_torch.asr_client <host:port>
        <audio.pcm|audio.wav|-> [--rate real|max] [--block-ms MS]
        [--stats] [--ws] [--srt FILE | --vtt FILE]

--srt/--vtt write a subtitle file from the FINAL event's word timings
(the server detokenizes and sends [[start_s, end_s, word], ...]; cue
segmentation is utils/subtitles.words_to_cues).

--rate real paces the upload at real time (one block per block's worth of
wall clock), max streams as fast as the socket takes it. Incremental text
goes to stdout as it arrives; the summary goes to stderr.
"""

from __future__ import annotations

import sys
import time


def main(argv: list[str]) -> int:
    args = [a for a in argv[1:] if not a.startswith("--")]
    if len(args) < 2:
        print(__doc__, file=sys.stderr)
        return 1

    def opt(name, default, cast):
        if name not in argv:
            return default
        raw = argv[argv.index(name) + 1]
        try:
            return cast(raw)
        except ValueError:
            print(f"error: invalid value for {name}: {raw!r}",
                  file=sys.stderr)
            raise SystemExit(1)

    try:
        host, port = args[0].rsplit(":", 1)
        port = int(port)
    except ValueError:
        print(f"error: bad address {args[0]!r} (want host:port)",
              file=sys.stderr)
        return 1
    rate = opt("--rate", "real", str)
    block_ms = opt("--block-ms", 100.0, float)

    from .client import ASRClient, WSASRClient
    from .utils.audio import read_audio_bytes, read_audio_file

    if args[1] == "-":
        audio = read_audio_bytes(sys.stdin.buffer.read())
    else:
        audio = read_audio_file(args[1])

    # --ws speaks the server's WebSocket transport (asr_server
    # --ws-port) instead of the raw TCP protocol; same session semantics
    client = (WSASRClient if "--ws" in argv else ASRClient)(host, port)
    info = client.start()
    print(f"connected: slot={info['slot']} "
          f"chunk={info['chunk_samples']} samples", file=sys.stderr)

    block = max(1, int(16000 * block_ms / 1000.0))
    printed = ""

    shown_utts = 0

    def show() -> None:
        nonlocal printed, shown_utts
        t = client.transcript
        if t.startswith(printed):
            sys.stdout.write(t[len(printed):])
        else:                      # beam revision: reprint on a fresh line
            sys.stdout.write("\n" + t)
        printed = t
        sys.stdout.flush()
        # endpoint events (server started with --endpoint-silence)
        for utt in client.utterances[shown_utts:]:
            line = f"[utterance {utt['index']}] {utt['text'].strip()}"
            if "refined" in utt:   # two-pass server (--refine)
                line += f"  => {utt['refined'].strip()}"
            print(line, file=sys.stderr)
        shown_utts = len(client.utterances)

    t0 = time.time()
    for i in range(0, len(audio), block):
        client.send_audio(audio[i:i + block])
        show()
        if rate == "real":
            target = t0 + (i + block) / 16000.0
            delay = target - time.time()
            if delay > 0:
                time.sleep(delay)
    final = client.end()
    show()
    sys.stdout.write("\n")
    wall = time.time() - t0
    if "--stats" in argv:
        st = client.stats()
        print(f"server stats: {st}", file=sys.stderr)
    print(f"audio {len(audio) / 16000.0:.1f} s in {wall:.1f} s wall; "
          f"{len(final['tokens'])} tokens", file=sys.stderr)
    if opt("--srt", None, str) and opt("--vtt", None, str):
        print("error: --srt and --vtt are mutually exclusive (one output "
              "file, one format)", file=sys.stderr)
        client.close()
        return 2
    sub_path = opt("--srt", None, str) or opt("--vtt", None, str)
    if sub_path is not None:
        # The server omits "words" when its engine cannot provide
        # emission-aligned frames (beam mode) or predates the field; a
        # silently empty subtitle file would look like success.
        if not final.get("words"):
            print("error: --srt/--vtt requested but the server's FINAL "
                  "event carries no word timings (beam-mode engines and "
                  "older servers omit them); re-run the server with greedy "
                  "decode for subtitle export", file=sys.stderr)
            client.close()
            return 2
        from .utils.subtitles import format_srt, format_vtt, words_to_cues

        cues = words_to_cues(final["words"])
        fmt = format_srt if opt("--srt", None, str) else format_vtt
        with open(sub_path, "w", encoding="utf-8") as f:
            f.write(fmt(cues))
        print(f"wrote {len(cues)} cues to {sub_path}", file=sys.stderr)
    client.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
