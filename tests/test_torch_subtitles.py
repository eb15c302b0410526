"""Subtitle export, the port's copy (nemotron_tpu_torch/utils/subtitles.py):
every case of tests/test_subtitles.py run against it (word grouping, cue
segmentation, SRT / WebVTT formatting, files), and the same seeded token
lists through both packages' functions, output for output. The CLI flags
are compared with the JAX CLIs in tests/test_torch_cli.py."""

import numpy as np
import pytest

from nemotron_tpu_torch.utils.subtitles import (format_srt, format_vtt,
                                                tokens_to_cues,
                                                tokens_to_words,
                                                words_to_cues,
                                                write_subtitles)
from nemotron_tpu_torch.utils.text import SECONDS_PER_FRAME

SP = "▁"
VOCAB = [SP + "hi", SP + "the", "re", "x", SP + "ok", SP + "a"]


def frames(sec: float) -> int:
    return round(sec / SECONDS_PER_FRAME)


def test_word_grouping():
    toks = [(0, 0), (1, frames(0.4)), (2, frames(0.48))]
    words = tokens_to_words(toks, VOCAB)
    assert [w[2] for w in words] == ["hi", "there"]
    assert words[0][0] == 0.0
    assert words[0][1] == pytest.approx(SECONDS_PER_FRAME)
    assert words[1][0] == pytest.approx(0.4, abs=0.02)
    # word end = last piece's frame + one frame width
    assert words[1][1] == pytest.approx(0.48 + SECONDS_PER_FRAME, abs=0.02)


def test_word_grouping_skips_bad_ids_and_leading_continuation():
    # out-of-range ids are dropped (tokens_to_text parity); a continuation
    # piece with no preceding word start still begins a word
    toks = [(99, 0), (2, 1), (0, 5)]
    words = tokens_to_words(toks, VOCAB)
    assert [w[2] for w in words] == ["re", "hi"]


def test_confidence_triples_accepted():
    toks = [(0, 0, -0.1), (4, 10, -0.2)]
    assert [w[2] for w in tokens_to_words(toks, VOCAB)] == ["hi", "ok"]


def test_gap_split():
    toks = [(0, 0), (4, frames(0.5)), (0, frames(3.0))]
    cues = tokens_to_cues(toks, VOCAB, max_gap_s=1.0)
    assert [c[2] for c in cues] == ["hi ok", "hi"]
    # lead-out: first cue extends 0.5 s past its last word's end (gap is
    # large enough that the next cue's start doesn't clip it)
    last_end = frames(0.5) * SECONDS_PER_FRAME + SECONDS_PER_FRAME
    assert cues[0][1] == pytest.approx(last_end + 0.5)
    assert cues[1][0] == pytest.approx(frames(3.0) * SECONDS_PER_FRAME)


def test_lead_out_clipped_at_next_cue():
    # gap 0.32 s with max_gap 0.2: split, and the 0.5 s lead-out would
    # cross the next cue's start -> clipped to it
    toks = [(0, 0), (4, frames(SECONDS_PER_FRAME + 0.32))]
    cues = tokens_to_cues(toks, VOCAB, max_gap_s=0.2, tail_s=0.5)
    assert len(cues) == 2
    assert cues[0][1] == pytest.approx(cues[1][0])


def test_duration_split():
    # one word every 0.8 s for 10 s: no gap ever exceeds 1 s, but cues are
    # capped at max_dur_s=6
    toks = [(0, frames(0.8 * i)) for i in range(13)]
    cues = tokens_to_cues(toks, VOCAB, max_dur_s=6.0)
    assert len(cues) >= 2
    assert all(c[1] - c[0] <= 6.0 + 0.5 for c in cues)
    assert sum(len(c[2].split()) for c in cues) == 13


def test_char_split():
    toks = [(5, frames(0.2 * i)) for i in range(10)]  # ten 1-char words
    cues = tokens_to_cues(toks, VOCAB, max_chars=7)
    # "a a a a" is 7 chars -> 4 words per cue
    assert [c[2] for c in cues] == ["a a a a", "a a a a", "a a"]


def test_words_to_cues_json_shapes():
    # server events deliver words as JSON lists (not tuples); ints for
    # whole-second times must coerce cleanly
    cues = words_to_cues([[0, 1, "hi"], [1.2, 2, "there"]])
    assert len(cues) == 1 and cues[0][2] == "hi there"


def test_srt_format_exact():
    cues = [(0.0, 1.5, "hi there"), (3661.25, 3662.0, "ok")]
    srt = format_srt(cues)
    assert srt == ("1\n00:00:00,000 --> 00:00:01,500\nhi there\n\n"
                   "2\n01:01:01,250 --> 01:01:02,000\nok\n")


def test_vtt_format_exact():
    cues = [(0.08, 1.0, "hi")]
    assert format_vtt(cues) == \
        "WEBVTT\n\n00:00:00.080 --> 00:00:01.000\nhi\n"


def test_write_subtitles(tmp_path):
    toks = [(0, 0), (4, 5)]
    p = tmp_path / "out.srt"
    assert write_subtitles(str(p), toks, VOCAB, "srt") == 1
    assert "-->" in p.read_text()
    v = tmp_path / "out.vtt"
    assert write_subtitles(str(v), toks, VOCAB, "vtt") == 1
    assert v.read_text().startswith("WEBVTT")
    with pytest.raises(ValueError):
        write_subtitles(str(p), toks, VOCAB, "ass")


def test_empty_tokens(tmp_path):
    p = tmp_path / "e.vtt"
    assert write_subtitles(str(p), [], VOCAB, "vtt") == 0
    assert p.read_text() == "WEBVTT\n"
    s = tmp_path / "e.srt"
    assert write_subtitles(str(s), [], VOCAB, "srt") == 0
    assert s.read_text() == ""


# ---- the port's copy against the JAX package --------------------------------


def random_tokens(rng, n, with_conf):
    """n (id, frame[, logp]) tokens over VOCAB plus out-of-range ids, frames
    increasing with random gaps (some beyond the cue gap)."""
    frames = np.cumsum(rng.choice([0, 1, 2, 5, 20], n))
    ids = rng.integers(-1, len(VOCAB) + 1, n)
    return [(int(i), int(f), float(-rng.random())) if with_conf
            else (int(i), int(f)) for i, f in zip(ids, frames)]


@pytest.mark.parametrize("seed", range(6))
def test_subtitles_match_jax(seed, tmp_path):
    from nemotron_tpu.utils import subtitles as jsub

    rng = np.random.default_rng(seed)
    toks = random_tokens(rng, int(rng.integers(0, 80)), seed % 2 == 1)
    kw = dict(max_gap_s=float(rng.uniform(0.2, 1.5)),
              max_dur_s=float(rng.uniform(1.0, 6.0)),
              max_chars=int(rng.integers(5, 84)),
              tail_s=float(rng.uniform(0, 0.6)))
    spf = [None, 0.04][seed % 2]
    assert tokens_to_words(toks, VOCAB, seconds_per_frame=spf) == \
        jsub.tokens_to_words(toks, VOCAB, seconds_per_frame=spf)
    cues = tokens_to_cues(toks, VOCAB, seconds_per_frame=spf, **kw)
    assert cues == jsub.tokens_to_cues(toks, VOCAB, seconds_per_frame=spf,
                                       **kw)
    words = [list(w) for w in tokens_to_words(toks, VOCAB)]
    assert words_to_cues(words, **kw) == jsub.words_to_cues(words, **kw)
    assert format_srt(cues) == jsub.format_srt(cues)
    assert format_vtt(cues) == jsub.format_vtt(cues)
    for fmt in ("srt", "vtt"):
        got, want = tmp_path / f"t.{fmt}", tmp_path / f"j.{fmt}"
        assert write_subtitles(str(got), toks, VOCAB, fmt, **kw) == \
            jsub.write_subtitles(str(want), toks, VOCAB, fmt, **kw)
        assert got.read_bytes() == want.read_bytes()
