"""Subtitle export (SRT / WebVTT) from timed token lists.

The port's own copy of `nemotron_tpu/utils/subtitles.py`.

Beyond the reference: it stops at per-token `{sec}` word timestamps
(reference src/nemo-ggml.h:343-355 `timed_token.to_seconds`,
src/nemo-ggml.cpp:1432-1458). Here the same frame clock (1 encoder frame
= 8 mel hops = 1280 samples = 80 ms) drives full subtitle-cue
segmentation: words are grouped into display cues split at silence gaps,
a maximum cue duration, and a maximum line length, then formatted as
SubRip (.srt) or WebVTT (.vtt).

Timing model: RNN-T emits each token at one encoder frame (its emission
frame, not a span), so a word's start is its first piece's frame and its
end is its last piece's frame plus one frame width. Cue end times get a
short lead-out (up to ``tail_s``) clipped so cues never overlap -- the
standard subtitle convention of keeping text on screen briefly after the
last word.
"""

from __future__ import annotations

from .text import SECONDS_PER_FRAME, SP_SPACE

# Cue = (start_seconds, end_seconds, text)


def tokens_to_words(tokens: list[tuple], vocab: list[str],
                    seconds_per_frame: float | None = None
                    ) -> list[tuple[float, float, str]]:
    """Group (token_id, frame[, conf]) pieces into words.

    Returns (start_s, end_s, text) per word. A word begins at a piece
    carrying the SentencePiece space marker (or at the first valid piece);
    its end is the last piece's frame + one frame width. Out-of-range ids
    are skipped, matching tokens_to_text.

    seconds_per_frame: the encoder frame clock. Defaults to the standard
    geometry (subsampling 8 x hop 160 / 16 kHz = 80 ms); pass the
    cc-derived value (subsampling_factor*hop_length/sample_rate) for
    models with non-default geometry so word timings match the
    frame_seconds the server advertises."""
    spf = SECONDS_PER_FRAME if seconds_per_frame is None \
        else float(seconds_per_frame)
    words: list[tuple[float, float, str]] = []
    cur: list[str] = []
    start = last = 0.0
    for tok in tokens:
        tid, frame = int(tok[0]), int(tok[1])
        if not (0 <= tid < len(vocab)):
            continue
        piece = vocab[tid]
        t = frame * spf
        if piece.startswith(SP_SPACE) and cur:
            words.append((start, last + spf, "".join(cur)))
            cur = []
        if not cur:
            start = t
        cur.append(piece[len(SP_SPACE):] if piece.startswith(SP_SPACE)
                   else piece)
        last = t
    if cur:
        words.append((start, last + spf, "".join(cur)))
    return [(s, e, w) for (s, e, w) in words if w]


def tokens_to_cues(tokens: list[tuple], vocab: list[str],
                   max_gap_s: float = 1.0, max_dur_s: float = 6.0,
                   max_chars: int = 84, tail_s: float = 0.5,
                   seconds_per_frame: float | None = None
                   ) -> list[tuple[float, float, str]]:
    """Segment timed tokens into subtitle cues (tokens_to_words then
    words_to_cues)."""
    return words_to_cues(tokens_to_words(tokens, vocab,
                                         seconds_per_frame=seconds_per_frame),
                         max_gap_s=max_gap_s, max_dur_s=max_dur_s,
                         max_chars=max_chars, tail_s=tail_s)


def words_to_cues(words: list[tuple[float, float, str]],
                  max_gap_s: float = 1.0, max_dur_s: float = 6.0,
                  max_chars: int = 84, tail_s: float = 0.5
                  ) -> list[tuple[float, float, str]]:
    """Segment timed words into subtitle cues.

    A new cue starts when (a) the silence gap since the previous word
    exceeds ``max_gap_s``, (b) adding the word would push the cue past
    ``max_dur_s`` from its first word, or (c) past ``max_chars``
    characters. Cue end times are extended by up to ``tail_s`` of
    lead-out, clipped at the next cue's start. Word timings may come from
    tokens_to_words or from a server FINAL/UTTERANCE event's "words"
    field (the network client has no vocab to detokenize with)."""
    words = [(float(s), float(e), str(w)) for s, e, w in words]
    if not words:
        return []
    groups: list[list[tuple[float, float, str]]] = [[words[0]]]
    for w in words[1:]:
        g = groups[-1]
        text_len = sum(len(x[2]) for x in g) + len(g)  # + joining spaces
        if (w[0] - g[-1][1] > max_gap_s
                or w[1] - g[0][0] > max_dur_s
                or text_len + len(w[2]) > max_chars):
            groups.append([w])
        else:
            g.append(w)
    cues: list[tuple[float, float, str]] = []
    for i, g in enumerate(groups):
        start, end = g[0][0], g[-1][1]
        lead_out = end + tail_s
        if i + 1 < len(groups):
            lead_out = min(lead_out, groups[i + 1][0][0])
        cues.append((start, max(end, lead_out), " ".join(x[2] for x in g)))
    return cues


def _fmt_time(seconds: float, ms_sep: str) -> str:
    ms = round(seconds * 1000)
    h, ms = divmod(ms, 3600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{ms_sep}{ms:03d}"


def format_srt(cues: list[tuple[float, float, str]]) -> str:
    """SubRip: 1-based index, `HH:MM:SS,mmm --> HH:MM:SS,mmm`, text."""
    out = []
    for i, (start, end, text) in enumerate(cues, 1):
        out.append(f"{i}\n{_fmt_time(start, ',')} --> "
                   f"{_fmt_time(end, ',')}\n{text}\n")
    return "\n".join(out)


def format_vtt(cues: list[tuple[float, float, str]]) -> str:
    """WebVTT: `WEBVTT` header then `HH:MM:SS.mmm --> HH:MM:SS.mmm` cues."""
    out = ["WEBVTT\n"]
    for start, end, text in cues:
        out.append(f"{_fmt_time(start, '.')} --> "
                   f"{_fmt_time(end, '.')}\n{text}\n")
    return "\n".join(out)


def write_subtitles(path: str, tokens: list[tuple], vocab: list[str],
                    fmt: str, **cue_kwargs) -> int:
    """Render tokens to ``path`` in ``fmt`` ('srt' | 'vtt').

    Returns the number of cues written. An empty token list writes a
    valid empty file (bare WEBVTT header / zero-byte SRT)."""
    if fmt not in ("srt", "vtt"):
        raise ValueError(f"unknown subtitle format: {fmt!r}")
    cues = tokens_to_cues(tokens, vocab, **cue_kwargs)
    text = format_srt(cues) if fmt == "srt" else format_vtt(cues)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return len(cues)
