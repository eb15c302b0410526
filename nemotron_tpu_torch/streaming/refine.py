"""Two-pass serving: online greedy segmentation, then an offline beam
re-decode of each finished utterance.

The port's counterpart of `nemotron_tpu/streaming/refine.py`:

  1. the ServingEngine runs online greedy decode with utterance
     endpointing and keep_segment_audio=True (each slot keeps the current
     utterance's PCM, cut at the endpointer's processed-frame boundary);
  2. each finished utterance is re-decoded offline in one batch: beam
     search with LM shallow fusion (or second-pass rescoring), with a
     fresh LM history for every utterance.

The refined text arrives one endpoint silence after the greedy partials;
clients show the greedy text live and replace it utterance by utterance.
"""

from __future__ import annotations

import numpy as np
import torch

from .session import transcribe_batch

# a degenerate cut (the endpointer fired on an empty buffer) is padded to
# one 25 ms window
MIN_SEGMENT_SAMPLES = 400


class SegmentRefiner:
    """Batched offline re-decode of endpointed utterance segments.

    refine(segments) runs one transcribe_batch over all segments (beam,
    optional LM fusion or rescoring). drain(engine) polls the engine's
    endpoint events with their audio and returns [(slot, online_text,
    refined_text, tokens)] a finished utterance."""

    def __init__(self, params, cfg, vocab, beam_size: int = 4,
                 beam_expansions: int | None = None, lm=None,
                 lm_weight: float = 0.3, lm_bonus: float = 0.0,
                 lm_rescore: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        if beam_size <= 1:
            raise ValueError("refinement is a beam re-decode; beam_size>1")
        self.params = params
        self.cfg = cfg
        self.vocab = vocab
        self.beam_size = beam_size
        self.beam_expansions = beam_expansions
        self.lm = lm
        self.lm_weight = lm_weight
        self.lm_bonus = lm_bonus
        self.lm_rescore = lm_rescore
        self.dtype = compute_dtype

    def refine(self, segments: list[np.ndarray]) -> list[str]:
        """Re-decode raw-PCM segments (one utterance each) in one batch.

        The mel time axis is padded to the next power-of-two frame count
        (at least 128) through transcribe_batch's min_mel_frames, the JAX
        package's bucket: padded frames are masked, and the same padding
        keeps the texts equal to the JAX package's (the last real frame of
        a padded utterance sees one padded mel frame through the causal
        subsampling, in both packages). The JAX package also pads the
        batch to a power of two with silence rows, to bound its jit
        compiles; rows never interact, so eager PyTorch runs only the real
        ones."""
        if not segments:
            return []
        segs = [np.asarray(s, np.int16) for s in segments]
        segs = [s if s.size >= MIN_SEGMENT_SAMPLES
                else np.pad(s, (0, MIN_SEGMENT_SAMPLES - s.size))
                for s in segs]
        # an upper bound on the longest segment's mel frames (hop 160; +4
        # covers the center pad and the residue), bucketed up
        mel_upper = max(s.size for s in segs) // 160 + 4
        tm_bucket = 128
        while tm_bucket < mel_upper:
            tm_bucket *= 2
        return transcribe_batch(
            self.params, self.cfg, self.vocab, segs,
            compute_dtype=self.dtype, beam_size=self.beam_size,
            beam_expansions=self.beam_expansions, lm=self.lm,
            lm_weight=self.lm_weight, lm_bonus=self.lm_bonus,
            lm_rescore=self.lm_rescore, min_mel_frames=tm_bucket)

    def drain(self, engine) -> list[tuple[int, str, str, list]]:
        """Poll the engine's finished utterances and refine them in one
        batch: [(slot, online_text, refined_text, tokens)]."""
        events = engine.poll_endpoints(with_audio=True)
        if not events:
            return []
        refined = self.refine([seg for _s, _t, _tk, seg in events])
        return [(s, text, rtext, toks)
                for (s, text, toks, _seg), rtext in zip(events, refined)]
