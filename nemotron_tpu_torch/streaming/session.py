"""Streaming session engine and full-utterance transcription.

The port's counterpart of `nemotron_tpu/streaming/session.py` (RNN-T,
TDT and CTC decoding) and of the reference's nemo_stream_* API
(src/nemo-stream.h:176-312). One `StreamSession` manages S parallel
streams: host-side PCM->mel frontend and mel buffer, plus `chunk_step`,
which runs the cached encoder and the greedy decode on the params' device
and brings back only int32 tokens (or `chunk_step_beam`, whose K
hypotheses stay on the device). A TDT checkpoint decodes with the
duration-aware walk or beam (`chunk_step_tdt`, `chunk_step_tdt_beam`), a
hybrid checkpoint with ctc=True with its CTC head (`chunk_step_ctc`, the
collapse on the host). `transcribe_batch` is the reference's whole-file
path (src/transcribe.cpp): several utterances in one length-masked
encoder pass and one greedy or beam decode, with n-best lists, LM shallow
fusion and second-pass LM rescoring.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import (MAX_SYMBOLS_PER_STEP, CacheConfig, ModelConfig,
                      PreprocessorConfig)
from ..frontend.preprocessor import StreamingPreprocessor
from ..models import beam as beam_mod
from ..models import ctc as ctc_mod
from ..models import decoder as dec_mod
from ..models import encoder as enc_mod
from ..models import tdt as tdt_mod
from ..models.lm import lm_to_device
from ..parallel import mesh as mesh_mod
from ..params import ModelParams, cast_params
from ..utils import npz
from ..utils.dump import DumpTracer
from ..utils.tones import enc_frames_of_mel
from ..utils.text import tokens_to_text

_DTYPES = (torch.float32, torch.bfloat16)
# the torch.profiler range of a session's chunk step (utils/profiler.py)
CHUNK_STEP_RANGE = "chunk_step"


def chunk_step(params: ModelParams, cfg: ModelConfig, cc: CacheConfig,
               mel_chunk: torch.Tensor, enc_state, dec_state, pos_heads,
               with_confidence: bool = False):
    """Fused streaming step: cached encoder + greedy RNN-T decode.

    mel_chunk: [S, chunk_mel_frames, n_mels]
    Returns (tokens [S, valid_out, MAX_SYMBOLS] int32 blank-padded,
             enc_state', dec_state'), and with_confidence also each
    emission's log-posterior, confs [S, valid_out, MAX_SYMBOLS] f32, last
    (the JAX package's _chunk_step_conf_jit). The K/V rings of `enc_state`
    are updated in place (see encoder.encode_chunk)."""
    enc_out, enc_state = enc_mod.encode_chunk(params, cfg, cc, mel_chunk,
                                              enc_state, pos_heads)
    out = dec_mod.greedy_decode(params, cfg, enc_out, dec_state,
                                with_confidence=with_confidence)
    return (out[0], enc_state) + out[1:]


def chunk_step_captured(params: ModelParams, cfg: ModelConfig,
                        cc: CacheConfig, mel_chunk: torch.Tensor, enc_state,
                        dec_state, pos_heads):
    """chunk_step with the encoder's named intermediates captured (dump
    tracing; nemotron_tpu/streaming/session.py:355-361): (tokens,
    enc_state', dec_state', inter), inter as encoder.encode_chunk's
    capture. Tokens and state are those of chunk_step."""
    enc_out, enc_state, inter = enc_mod.encode_chunk(
        params, cfg, cc, mel_chunk, enc_state, pos_heads, capture=True)
    tokens, dec_state = dec_mod.greedy_decode(params, cfg, enc_out,
                                              dec_state)
    return tokens, enc_state, dec_state, inter


def chunk_step_masked(params: ModelParams, cfg: ModelConfig, cc: CacheConfig,
                      mel_chunk: torch.Tensor, enc_state, dec_state,
                      pos_heads, step_mask: torch.Tensor,
                      with_confidence: bool = False):
    """chunk_step for continuous batching: `step_mask` [S] bool marks the
    streams that advance; the rest keep their caches, decoder state and
    valid_len and emit nothing (their mel rows are padding, their confs
    0)."""
    enc_out, enc_state = enc_mod.encode_chunk(params, cfg, cc, mel_chunk,
                                              enc_state, pos_heads,
                                              step_mask=step_mask)
    out = dec_mod.greedy_decode(params, cfg, enc_out, dec_state,
                                step_mask=step_mask,
                                with_confidence=with_confidence)
    return (out[0], enc_state) + out[1:]


def chunk_step_beam(params: ModelParams, cfg: ModelConfig, cc: CacheConfig,
                    mel_chunk: torch.Tensor, enc_state, beam_state,
                    pos_heads, beam_size: int, expansions: int, lm=None,
                    lm_weight: float = 0.3, lm_bonus: float = 0.0):
    """chunk_step with the batched RNN-T beam search as its decode
    (nemotron_tpu/streaming/session.py:221-238): the K-hypothesis
    BeamState carries across chunks in place of the greedy DecoderState.
    Returns (enc_state', beam_state'); no token tensor leaves the device
    (`beam.best_hypothesis` reads them)."""
    enc_out, enc_state = enc_mod.encode_chunk(params, cfg, cc, mel_chunk,
                                              enc_state, pos_heads)
    beam_state = beam_mod.beam_decode(params, cfg, enc_out, beam_state,
                                      beam_size, expansions, lm=lm,
                                      lm_weight=lm_weight, lm_bonus=lm_bonus)
    return enc_state, beam_state


def chunk_step_masked_beam(params: ModelParams, cfg: ModelConfig,
                           cc: CacheConfig, mel_chunk: torch.Tensor,
                           enc_state, beam_state, pos_heads,
                           step_mask: torch.Tensor, beam_size: int,
                           expansions: int, lm=None, lm_weight: float = 0.3,
                           lm_bonus: float = 0.0):
    """chunk_step_beam for continuous batching
    (nemotron_tpu/streaming/session.py:243-264): slots outside `step_mask`
    [S] keep their caches and their whole beam (a 0 frame limit in
    beam_decode's enc_lengths)."""
    enc_out, enc_state = enc_mod.encode_chunk(params, cfg, cc, mel_chunk,
                                              enc_state, pos_heads,
                                              step_mask=step_mask)
    t_lim = torch.where(step_mask, enc_out.shape[1], 0).to(torch.int32)
    beam_state = beam_mod.beam_decode(params, cfg, enc_out, beam_state,
                                      beam_size, expansions,
                                      enc_lengths=t_lim, lm=lm,
                                      lm_weight=lm_weight, lm_bonus=lm_bonus)
    return enc_state, beam_state


def chunk_step_tdt(params: ModelParams, cfg: ModelConfig, cc: CacheConfig,
                   mel_chunk: torch.Tensor, enc_state, dec_state, pos_heads,
                   skip: torch.Tensor, step_mask: torch.Tensor | None = None,
                   with_confidence: bool = False):
    """chunk_step for TDT checkpoints (nemotron_tpu/streaming/session.py:
    284-313, serving.py:340-364): the cached encoder, then the
    duration-aware greedy walk. `skip` [S] int32 carries a jump that
    overshot the previous chunk into this one; `step_mask` [S] freezes the
    masked streams (caches, decoder state and skip). Returns (tokens
    [S, valid_out, MAX] int32, enc_state', dec_state', skip', confs
    [S, valid_out, MAX] f32 or None)."""
    enc_out, enc_state = enc_mod.encode_chunk(params, cfg, cc, mel_chunk,
                                              enc_state, pos_heads,
                                              step_mask=step_mask)
    out = tdt_mod.tdt_greedy_decode(params, cfg, enc_out, dec_state,
                                    skip_in=skip, step_mask=step_mask,
                                    with_confidence=with_confidence)
    tokens, confs = (out[0], out[1]) if with_confidence else (out[0], None)
    dec_state, skip = out[-2:]
    return tokens, enc_state, dec_state, skip, confs


def chunk_step_tdt_beam(params: ModelParams, cfg: ModelConfig,
                        cc: CacheConfig, mel_chunk: torch.Tensor, enc_state,
                        beam_state, pos_heads, beam_size: int, lm=None,
                        lm_weight: float = 0.3, lm_bonus: float = 0.0,
                        step_mask: torch.Tensor | None = None):
    """chunk_step with the duration-aware TDT beam search as its decode
    (nemotron_tpu/streaming/session.py:316-336, serving.py:367-385): the
    TdtBeamState carries each hypothesis's overshoot across chunks, and
    masked streams keep their caches and whole beam. Returns (enc_state',
    beam_state')."""
    enc_out, enc_state = enc_mod.encode_chunk(params, cfg, cc, mel_chunk,
                                              enc_state, pos_heads,
                                              step_mask=step_mask)
    beam_state = tdt_mod.tdt_beam_decode(params, cfg, enc_out, beam_state,
                                         beam_size, step_mask=step_mask,
                                         lm=lm, lm_weight=lm_weight,
                                         lm_bonus=lm_bonus)
    return enc_state, beam_state


def chunk_step_ctc(params: ModelParams, cfg: ModelConfig, cc: CacheConfig,
                   mel_chunk: torch.Tensor, enc_state, pos_heads,
                   step_mask: torch.Tensor | None = None,
                   with_confidence: bool = False):
    """chunk_step decoding with a hybrid checkpoint's CTC head
    (nemotron_tpu/streaming/session.py:267-281, 339-352, serving.py:
    388-409): the cached encoder and the head's per-frame argmax. CTC has
    no decoder state; the host carries each stream's last frame id for a
    repeat spanning two chunks. Returns (ids [S, valid_out] int32, logp
    [S, valid_out] f32 (the argmax's log-posterior) or None, enc_state')."""
    enc_out, enc_state = enc_mod.encode_chunk(params, cfg, cc, mel_chunk,
                                              enc_state, pos_heads,
                                              step_mask=step_mask)
    if with_confidence:
        ids, logp = ctc_mod.frame_log_posteriors(params, enc_out)
        return ids, logp, enc_state
    return ctc_mod.frame_ids(params, enc_out), None, enc_state


def check_decode_options(params, cfg: ModelConfig, ctc: bool, beam_size: int,
                         endpoint_reset: bool = False,
                         excludes: str = "beam") -> tuple[bool, bool]:
    """The JAX package's checks of ctc=True (a CTC head, no beam, no
    decoder reset: CTC has no prediction network); `excludes` names what
    the message says CTC excludes (the session's "beam/tracing"). Returns
    (ctc, tdt): a TDT checkpoint decodes TDT unless ctc=True."""
    if ctc:
        if params.ctc is None:
            raise ValueError("ctc=True needs a model with a CTC head "
                             "(ctc_decoder.* tensors)")
        if beam_size > 1:
            raise ValueError(f"ctc decode excludes {excludes} (CTC beam "
                             "would be a prefix search; decode the hybrid's "
                             "RNN-T head for beam)")
        if endpoint_reset:
            raise ValueError("endpoint_reset resets the prediction network; "
                             "CTC decode has none")
    return bool(ctc), bool(cfg.tdt_durations) and not ctc


def init_beam(cfg: ModelConfig, tdt: bool, batch: int, beam_size: int,
              max_tokens: int, dtype: torch.dtype, device, lm=None):
    """A fresh beam of the decode family: TdtBeamState for TDT, else
    BeamState."""
    init = tdt_mod.init_tdt_beam_state if tdt else beam_mod.init_beam_state
    return init(cfg, batch, beam_size, max_tokens, dtype, device, lm=lm)


def check_beam_options(beam_size: int, lm, confidence: bool = False,
                       timestamp_words: bool = False) -> None:
    """The JAX package's ValueErrors for options that need greedy decode
    or a beam."""
    if beam_size > 1:
        if timestamp_words:
            raise ValueError("word timestamps require greedy decode")
        if confidence:
            raise ValueError("confidence requires greedy decode (beam "
                             "hypotheses carry whole-sequence scores)")
    if lm is not None and beam_size <= 1:
        raise ValueError("LM shallow fusion requires beam_size > 1 "
                         "(the LM rescored search IS the beam)")


def best_transcripts(beam_state, vocab, rows, mesh=None) -> dict:
    """{row: (tokens, text)} of each row's current best hypothesis
    (length-normalized selection, the serving default): one device call
    and one [S, U] download. Beam tokens carry no frame (0). Under a mesh
    the beam state holds this rank's rows (parallel.mesh.
    shard_stream_major), and the best hypotheses of every row are gathered
    over the data axis."""
    btok, blen, _ = beam_mod.best_hypothesis(beam_state, length_norm=True)
    if mesh is not None:
        btok, blen = (mesh_mod.gather_rows(t, mesh) for t in (btok, blen))
    btok, blen = btok.cpu().numpy(), blen.cpu().numpy()
    out = {}
    for s in rows:
        toks = [(int(t), 0) for t in btok[s, :blen[s]]]
        out[int(s)] = (toks, tokens_to_text(toks, vocab))
    return out


def beam_leaves(beam_state, mesh=None) -> dict:
    """The beam state's snapshot leaves under the JAX package's beam/*
    keys (beam/lm_h and beam/lm_c with an LM); every row of them under a
    mesh (gathered over the data axis)."""
    if mesh is not None:
        beam_state = mesh_mod.gather_stream_major(beam_state, mesh)
    return {f"beam/{k}": npz.to_numpy(v)
            for k, v in beam_mod.leaves(beam_state).items()}


def restore_beam(st, beam_size: int, lm, dtype: torch.dtype, device,
                 what: str = "session", tdt: bool = False):
    """The BeamState (TdtBeamState when `tdt`) of a snapshot's beam/*
    leaves as fresh tensors on `device`, after the JAX package's checks of
    the beam width, LM fusion and beam family (a TDT beam carries beam/t
    and beam/sym). The caller has checked that both sides decode with a
    beam."""
    if st["beam/h"].shape[1] != beam_size:
        raise ValueError(f"snapshot beam width K={st['beam/h'].shape[1]} != "
                         f"{what} beam_size={beam_size}")
    has_lm = "beam/lm_h" in st
    if has_lm != (lm is not None):
        raise ValueError(
            f"snapshot/{what} LM-fusion mismatch: snapshot "
            f"{'carries' if has_lm else 'has no'} LM state, {what} "
            f"lm={'set' if lm is not None else 'None'}")
    if ("beam/t" in st) != tdt:
        family = ("TDT", "RNN-T")
        raise ValueError(
            f"snapshot/{what} beam-family mismatch: snapshot is "
            f"{family['beam/t' not in st]}, {what} is {family[not tdt]}")
    f32, i32 = torch.float32, torch.int32
    types = {"h": dtype, "c": dtype, "prev_token": i32, "scores": f32,
             "tokens": i32, "lengths": i32, "lm_h": dtype, "lm_c": dtype}
    if tdt:
        types |= {"t": i32, "sym": i32}
    cls = tdt_mod.TdtBeamState if tdt else beam_mod.BeamState
    return cls(**{k: npz.to_tensor(st[f"beam/{k}"], t, device)
                  for k, t in types.items() if f"beam/{k}" in st})


class StreamSession:
    """Lifecycle mirror of nemo_stream_init / process_incremental / finalize /
    get_transcript / get_tokens / reset. Runs on the params' device in
    `compute_dtype` (float32 or bfloat16: float leaves of the params, the
    position bias, both states and each mel chunk; quantized weights keep
    int8 and f32 scales), with the f32 filterbank and window the params
    carry.

    timestamp_words puts each word's start time ({seconds}) in the
    transcript; confidence makes the tokens (id, frame, log_posterior)
    triples; confidence_words (which implies it) also puts each word's
    posterior ({p=...}) in the transcript.

    beam_size > 1 decodes each chunk with the batched beam search
    (beam_expansions label rounds a frame, max_beam_tokens token slots a
    hypothesis); the K-hypothesis state carries across chunks and the
    transcript is the current best hypothesis, so earlier text may be
    rewritten: `process` returns "" and `get_transcript` / `finalize` read
    it. lm (models/lm.LMParams) adds shallow fusion to that beam:
    lm_weight * log P_lm + lm_bonus on every label.

    A TDT checkpoint (cfg.tdt_durations) decodes with the duration-aware
    walk, carrying each stream's jump overshoot (`tdt_skip`), or with the
    duration-aware beam; ctc=True decodes a hybrid checkpoint with its CTC
    head (greedy, with confidence and word timestamps; the collapse carries
    each stream's last frame id across chunks, `ctc_prev`).

    trace_dir: every chunk appends its named intermediates (mel,
    pre_encode_out, layer_{l:02d}_out, encoder_out, tokens) to dump files
    in that directory, in the reference's binary format (utils/dump.py;
    the reference's my_bin/ tracing, src/nemo-stream.cpp:880-958). Greedy
    RNN-T only, as in the JAX package; the traced step's tokens and state
    are the untraced step's.

    frontend: the StreamingPreprocessor backend. "auto" (the default)
    resolves as the JAX session's does on the CPU, to its native C++ DSP
    (so the mel is JAX's bit for bit), and on the card to "numpy" (the FFT
    on the card); "numpy" and "native" ask for one."""

    def __init__(self, params: ModelParams, cfg: ModelConfig,
                 vocab: list[str] | None = None,
                 cache_config: CacheConfig | None = None,
                 n_streams: int = 1,
                 compute_dtype: torch.dtype = torch.float32,
                 trace_dir: str | None = None,
                 timestamp_words: bool = False,
                 beam_size: int = 1,
                 beam_expansions: int | None = None,
                 max_beam_tokens: int = 4096,
                 confidence: bool = False,
                 confidence_words: bool = False,
                 ctc: bool = False,
                 lm=None, lm_weight: float = 0.3,
                 lm_bonus: float = 0.0, frontend: str = "auto"):
        # the JAX package's refusals, in its order (session.py:425-462):
        # tracing captures the greedy RNN-T step only
        traced = trace_dir is not None
        if traced and beam_size > 1 and not timestamp_words:
            raise ValueError("tracing supports greedy decode only")
        check_beam_options(beam_size, lm, confidence or confidence_words,
                           timestamp_words)
        if traced and (confidence or confidence_words):
            raise ValueError("confidence and tracing are mutually exclusive "
                             "(the traced step has no confidence output)")
        self.ctc, self.tdt = check_decode_options(params, cfg, ctc, beam_size,
                                                  excludes="beam/tracing")
        if traced and self.ctc:
            raise ValueError("ctc decode excludes beam/tracing (CTC beam "
                             "would be a prefix search; decode the "
                             "hybrid's RNN-T head for beam)")
        if traced and self.tdt:
            raise ValueError("tracing supports greedy decode only")
        self.tracer = DumpTracer(trace_dir) if traced else None
        _check_dtype(compute_dtype)
        self.params = cast_params(params, compute_dtype)
        self.dtype = compute_dtype
        self.device = params.device
        self.cfg = cfg
        self.cc = cache_config or CacheConfig(n_mels=cfg.n_mels)
        self.vocab = vocab or []
        self.n_streams = n_streams
        self.timestamp_words = timestamp_words
        self.confidence = confidence or confidence_words
        self.confidence_words = confidence_words
        self.beam_size = beam_size
        self.beam_expansions = (beam_expansions if beam_expansions is not None
                                else MAX_SYMBOLS_PER_STEP)
        self.max_beam_tokens = max_beam_tokens
        self.lm = None if lm is None else lm_to_device(lm, self.device)
        self.lm_weight = float(lm_weight)
        self.lm_bonus = float(lm_bonus)

        self.preproc = StreamingPreprocessor(
            params.preprocessor.filterbank.float().cpu().numpy(),
            params.preprocessor.window.float().cpu().numpy(),
            n_streams=n_streams,
            cfg=PreprocessorConfig(n_mels=cfg.n_mels), device=self.device,
            backend=frontend)
        self.pos_heads = enc_mod.precompute_pos_heads(
            self.params, cfg, self.cc, compute_dtype)
        self.reset()

    def reset(self) -> None:
        """Clear caches and transcript (reference src/nemo-stream.cpp:81-101)."""
        cfg, cc, S = self.cfg, self.cc, self.n_streams
        self.enc_state = enc_mod.init_encoder_state(cfg, cc, S, self.dtype,
                                                    self.device)
        self.dec_state = dec_mod.init_decoder_state(cfg, S, self.dtype,
                                                    self.device)
        self.beam_state = None
        if self.beam_size > 1:
            self.beam_state = init_beam(cfg, self.tdt, S, self.beam_size,
                                        self.max_beam_tokens, self.dtype,
                                        self.device, lm=self.lm)
        # the CTC collapse carry: each stream's raw last frame id of the
        # previous chunk (-1 at the start: matches nothing); the TDT jump
        # carry: frames to skip at the start of the next chunk
        self.ctc_prev = np.full(S, -1, np.int64)
        self.tdt_skip = torch.zeros((S,), dtype=torch.int32,
                                    device=self.device)
        self.preproc.reset()
        # 9-frame zero-seeded overlap (reference src/nemo-stream.cpp:58-60)
        self.mel_buffer = np.zeros((S, cc.pre_encode_cache_size, cfg.n_mels),
                                   np.float32)
        self.tokens: list[list[tuple]] = [[] for _ in range(S)]
        self.transcripts = [""] * S
        self.frame_offset = 0
        # stats (reference src/nemo-stream.h:228-252)
        self.total_audio_seconds = 0.0
        self.total_compute_seconds = 0.0
        self.frontend_seconds = 0.0
        self.chunk_seconds = 0.0
        self.total_chunks = 0

    def process(self, audio_i16: np.ndarray) -> list[str] | str:
        """Feed PCM ([S, N] or [N] int16); returns newly decoded text per
        stream (a plain str when the input was 1-D)."""
        squeeze = audio_i16.ndim == 1
        if squeeze:
            audio_i16 = audio_i16[None]
        t0 = time.perf_counter()
        self.total_audio_seconds += (
            audio_i16.shape[1] / self.preproc.cfg.sample_rate)
        mel = self.preproc.process(audio_i16)
        self.frontend_seconds += time.perf_counter() - t0
        if mel.shape[1]:
            self.mel_buffer = np.concatenate([self.mel_buffer, mel], axis=1)
        new_text = self._drain_chunks()
        self.total_compute_seconds += time.perf_counter() - t0
        return new_text[0] if squeeze else new_text

    def process_mel(self, mel: np.ndarray) -> list[str]:
        """Feed mel frames directly ([S, T, n_mels])."""
        t0 = time.perf_counter()
        self.mel_buffer = np.concatenate([self.mel_buffer, mel], axis=1)
        out = self._drain_chunks()
        self.total_compute_seconds += time.perf_counter() - t0
        return out

    def _drain_chunks(self) -> list[str]:
        cc = self.cc
        new_text = [""] * self.n_streams
        while self.mel_buffer.shape[1] >= cc.chunk_mel_frames:
            chunk = torch.from_numpy(np.ascontiguousarray(
                self.mel_buffer[:, :cc.chunk_mel_frames])).to(
                    self.device, self.dtype)
            t0 = time.perf_counter()
            # the profiler range of one chunk step (utils/profiler.py reads
            # its device time), its host fetch included
            with torch.profiler.record_function(CHUNK_STEP_RANGE):
                emitted, n_frames = self._step(chunk)
            self.chunk_seconds += time.perf_counter() - t0
            self.total_chunks += 1
            self.mel_buffer = self.mel_buffer[:, cc.shift_mel_frames:]
            self.frame_offset += n_frames
            if emitted is None:           # a beam step: the transcripts
                self._refresh_beam_transcripts()      # are rewritten
                continue
            for s, toks in emitted.items():
                self.tokens[s].extend(toks)
                text = tokens_to_text(toks, self.vocab,
                                      timestamp_words=self.timestamp_words,
                                      confidence_words=self.confidence_words)
                self.transcripts[s] += text
                new_text[s] += text
        return new_text

    def _step(self, chunk: torch.Tensor) -> tuple[dict | None, int]:
        """One chunk step of the session's decode family, the device state
        updated: ({stream: tokens} emitted this chunk, or None for a beam
        step; the encoder frames it covered)."""
        cc = self.cc
        if self.beam_state is not None:
            if self.tdt:
                self.enc_state, self.beam_state = chunk_step_tdt_beam(
                    self.params, self.cfg, cc, chunk, self.enc_state,
                    self.beam_state, self.pos_heads, self.beam_size,
                    self.lm, self.lm_weight, self.lm_bonus)
            else:
                self.enc_state, self.beam_state = chunk_step_beam(
                    self.params, self.cfg, cc, chunk, self.enc_state,
                    self.beam_state, self.pos_heads, self.beam_size,
                    self.beam_expansions, self.lm, self.lm_weight,
                    self.lm_bonus)
            return None, cc.valid_out_len
        if self.ctc:
            ids, logp, self.enc_state = chunk_step_ctc(
                self.params, self.cfg, cc, chunk, self.enc_state,
                self.pos_heads, with_confidence=self.confidence)
            ids = ids.cpu().numpy()                     # [S, valid_out]
            return ctc_mod.collapse_chunk(
                ids, self.ctc_prev, range(self.n_streams),
                self.cfg.blank_token, self.frame_offset,
                None if logp is None else logp.cpu().numpy()), ids.shape[1]
        confs = None
        if self.tdt:
            (tokens, self.enc_state, self.dec_state, self.tdt_skip,
             confs) = chunk_step_tdt(
                self.params, self.cfg, cc, chunk, self.enc_state,
                self.dec_state, self.pos_heads, self.tdt_skip,
                with_confidence=self.confidence)
        elif self.tracer is not None:
            tokens, self.enc_state, self.dec_state = self._traced_step(chunk)
        else:
            out = chunk_step(self.params, self.cfg, cc, chunk,
                             self.enc_state, self.dec_state, self.pos_heads,
                             with_confidence=self.confidence)
            tokens, self.enc_state, self.dec_state = out[:3]
            confs = out[3] if self.confidence else None
        tokens = tokens.cpu().numpy()           # [S, valid_out, MAX]
        return dec_mod.extract_emitted(
            tokens, self.cfg.blank_token,
            np.full(self.n_streams, self.frame_offset, np.int64),
            confs=None if confs is None else confs.cpu().numpy()), \
            tokens.shape[1]

    def _traced_step(self, chunk: torch.Tensor):
        """The greedy chunk step with its intermediates captured, each
        appended to its dump file under the JAX package's names
        (nemotron_tpu/streaming/session.py:673-685): mel, pre_encode_out,
        layer_{l:02d}_out, encoder_out, tokens."""
        tokens, enc_state, dec_state, inter = chunk_step_captured(
            self.params, self.cfg, self.cc, chunk, self.enc_state,
            self.dec_state, self.pos_heads)
        self.tracer("mel", chunk)
        self.tracer("pre_encode_out", inter["pre_encode_out"])
        layer_out = inter["layer_out"].float().cpu().numpy()
        for l in range(layer_out.shape[0]):
            self.tracer(f"layer_{l:02d}_out", layer_out[l])
        self.tracer("encoder_out", inter["encoder_out"])
        self.tracer("tokens", tokens.float())
        return tokens, enc_state, dec_state

    def _refresh_beam_transcripts(self) -> None:
        """Rewrite transcripts and tokens from the current best hypothesis
        (nemotron_tpu/streaming/session.py:660-671)."""
        for s, (toks, text) in best_transcripts(
                self.beam_state, self.vocab, range(self.n_streams)).items():
            self.tokens[s] = toks
            self.transcripts[s] = text

    def finalize(self) -> list[str] | str:
        """Flush: pad the remaining mel buffer out to one more chunk if any
        *new* (non-overlap) frames are pending, then return transcripts."""
        cc = self.cc
        pending = self.mel_buffer.shape[1] - cc.pre_encode_cache_size
        if pending > 0:
            pad = cc.chunk_mel_frames - self.mel_buffer.shape[1]
            if pad > 0:
                self.mel_buffer = np.concatenate(
                    [self.mel_buffer,
                     np.zeros((self.n_streams, pad, self.cfg.n_mels),
                              np.float32)], axis=1)
            self._drain_chunks()
        return (self.transcripts[0] if self.n_streams == 1
                else list(self.transcripts))

    def get_transcript(self, stream: int = 0) -> str:
        return self.transcripts[stream]

    # -- checkpoint / resume --------------------------------------------------

    def state_dict(self) -> dict:
        """Full session snapshot, with the JAX package's keys
        (nemotron_tpu/streaming/session.py:689-716): encoder caches, decoder
        state, DSP state, mel buffer, tokens, transcripts. Device leaves
        come back as numpy arrays (bf16 upcast to f32, which is exact); a
        beam session adds its beam/* leaves (beam/t and beam/sym for TDT), a
        CTC session its ctc_prev and a TDT session its tdt_skip."""
        st = {f"enc/{k}": npz.to_numpy(getattr(self.enc_state, k))
              for k in ("k_cache", "v_cache", "conv_cache", "valid_len",
                        "phase", "k_scale", "v_scale")}
        st |= {f"dec/{k}": npz.to_numpy(getattr(self.dec_state, k))
               for k in ("h", "c", "prev_token")}
        if self.beam_state is not None:
            st |= beam_leaves(self.beam_state)
        if self.ctc:
            st["ctc_prev"] = self.ctc_prev.copy()
        if self.tdt:
            st["tdt_skip"] = npz.to_numpy(self.tdt_skip)
        return st | {
            "preproc": self.preproc.state_dict(),
            "mel_buffer": self.mel_buffer.copy(),
            "tokens": [list(t) for t in self.tokens],
            "transcripts": list(self.transcripts),
            "frame_offset": self.frame_offset,
        }

    def load_state_dict(self, st: dict) -> None:
        """Restore a snapshot of `state_dict` (or of the JAX package's
        session): fresh tensors on the session's device in its dtypes, so
        the in-place ring writes never touch the arrays handed in. A
        snapshot of another decode mode (CTC, TDT, greedy against beam,
        width, LM fusion, beam family) raises ValueError, as the JAX
        package's session does."""
        if self.ctc and "ctc_prev" not in st:
            raise ValueError("session decodes with ctc=True but the "
                             "snapshot carries no ctc_prev (saved from an "
                             "RNN-T-decode session)")
        if not self.ctc and "ctc_prev" in st:
            raise ValueError("snapshot carries CTC collapse state but this "
                             "session decodes RNN-T (ctc=False)")
        if self.tdt and "tdt_skip" not in st:
            raise ValueError("session decodes TDT but the snapshot carries "
                             "no tdt_skip (saved from another decode mode)")
        if not self.tdt and "tdt_skip" in st:
            raise ValueError("snapshot carries TDT skip state but this "
                             "session does not decode TDT")
        has_beam = "beam/h" in st
        if self.beam_size > 1 and not has_beam:
            raise ValueError(
                f"session has beam_size={self.beam_size} but the snapshot "
                "carries no beam state (saved from a greedy session)")
        if self.beam_size <= 1 and has_beam:
            raise ValueError(
                f"snapshot carries beam state (K={st['beam/h'].shape[1]}) "
                "but this session decodes greedily (beam_size=1)")
        beam_state = (restore_beam(st, self.beam_size, self.lm, self.dtype,
                                   self.device, tdt=self.tdt)
                      if has_beam else None)
        self.enc_state, self.dec_state = restore_states(
            st, self.cc, self.dtype, self.device)
        self.beam_state = beam_state
        if self.ctc:
            self.ctc_prev = np.asarray(st["ctc_prev"], np.int64).copy()
        if self.tdt:
            self.tdt_skip = npz.to_tensor(st["tdt_skip"], torch.int32,
                                          self.device)
        self.preproc.load_state_dict(st["preproc"])
        self.mel_buffer = np.asarray(st["mel_buffer"], np.float32).copy()
        self.tokens = [[tuple(t) for t in ts] for ts in st["tokens"]]
        self.transcripts = list(st["transcripts"])
        self.frame_offset = int(st["frame_offset"])

    def save(self, path: str) -> None:
        """Write the snapshot as an .npz in the JAX package's format
        (session.py:800-818): tokens/{s} int64 [n, 2], or float64 [n, 3]
        with confidence."""
        st = self.state_dict()
        flat = {k: v for k, v in st.items() if isinstance(v, np.ndarray)}
        flat["preproc/last_sample"] = st["preproc"]["last_sample"]
        flat["preproc/residue"] = st["preproc"]["residue"]
        flat["frame_offset"] = np.int64(st["frame_offset"])
        for s, toks in enumerate(st["tokens"]):
            flat[f"tokens/{s}"] = token_rows(toks, self.confidence)
        flat["transcripts"] = np.asarray(st["transcripts"], dtype=object)
        npz.savez(path, flat)

    def load(self, path: str) -> None:
        """Read a snapshot written by `save` (or by the JAX package)."""
        z = npz.NpzView(np.load(path, allow_pickle=True))
        st = {k: z[k] for k in z.files
              if not k.startswith(("preproc/", "tokens/"))
              and k not in ("transcripts", "frame_offset")}
        st["preproc"] = {"last_sample": z["preproc/last_sample"],
                         "residue": z["preproc/residue"]}
        st["tokens"] = [token_list(z[f"tokens/{s}"])
                        for s in range(self.n_streams)]
        st["transcripts"] = [str(t) for t in z["transcripts"]]
        st["frame_offset"] = int(z["frame_offset"])
        self.load_state_dict(st)

    def get_tokens(self, stream: int = 0) -> list[tuple]:
        """(id, frame) pairs, or (id, frame, log_posterior) triples when
        the session was built with confidence."""
        return self.tokens[stream]

    @property
    def rtf(self) -> float:
        """Real-time factor: compute seconds per audio second."""
        if self.total_audio_seconds == 0:
            return 0.0
        return self.total_compute_seconds / self.total_audio_seconds


def restore_states(st, cc: CacheConfig, dtype: torch.dtype, device,
                   put=None):
    """(EncoderState, DecoderState) from a snapshot's enc/* and dec/*
    leaves: the rings in int8 when quantized (int8 or packed int4), else
    in `dtype`, as fresh tensors on `device`. put(array, dtype,
    stream_axis): how a leaf becomes a tensor (default: the whole array
    on `device`)."""
    if put is None:
        def put(a, t, _axis):
            return npz.to_tensor(a, t, device)
    ring = torch.int8 if cc.kv_quant_max is not None else dtype
    f32, i32 = torch.float32, torch.int32
    enc = enc_mod.EncoderState(**{
        k: put(st[f"enc/{k}"], t, 0 if k in ("valid_len", "phase") else 1)
        for k, t in (
            ("k_cache", ring), ("v_cache", ring), ("k_scale", f32),
            ("v_scale", f32), ("conv_cache", dtype), ("valid_len", i32),
            ("phase", i32))})
    dec = dec_mod.DecoderState(**{
        k: put(st[f"dec/{k}"], t, 0) for k, t in (
            ("h", dtype), ("c", dtype), ("prev_token", i32))})
    return enc, dec


def token_rows(toks: list, confidence: bool) -> np.ndarray:
    """A stream's tokens as snapshot rows: int64 [n, 2] (id, frame), or
    float64 [n, 3] (id, frame, log_posterior) with confidence."""
    if confidence:
        return np.asarray(toks, np.float64).reshape(-1, 3)
    return np.asarray(toks, np.int64).reshape(-1, 2)


def token_list(rows) -> list[tuple]:
    """Snapshot rows back to token tuples (pairs or triples)."""
    return [(int(r[0]), int(r[1]), float(r[2])) if len(r) == 3
            else (int(r[0]), int(r[1])) for r in rows]


def batch_mel(params: ModelParams, cfg: ModelConfig, utterances,
              min_mel_frames: int = 0):
    """Log-mel of each utterance (int16 PCM, 1-D) through its own
    StreamingPreprocessor on the params' device ("auto": the native DSP on
    the CPU, as the JAX package's, the FFT on the card), zero-padded along
    time to max(longest, min_mel_frames) frames. Returns (mel [B, Tm,
    n_mels] f32 numpy, enc_lengths [B] int32 numpy: each utterance's
    encoder frames)."""
    fb = params.preprocessor.filterbank.float().cpu().numpy()
    win = params.preprocessor.window.float().cpu().numpy()
    mels = []
    for audio in utterances:
        pre = StreamingPreprocessor(fb, win,
                                    cfg=PreprocessorConfig(n_mels=cfg.n_mels),
                                    device=params.device, backend="auto")
        mels.append(pre.process(np.asarray(audio).reshape(1, -1))[0])
    Tm = max(max(m.shape[0] for m in mels), min_mel_frames)
    mel = np.zeros((len(mels), Tm, cfg.n_mels), np.float32)
    for i, m in enumerate(mels):
        mel[i, :m.shape[0]] = m
    enc_lengths = np.array([enc_frames_of_mel(m.shape[0]) for m in mels],
                           np.int32)
    return mel, enc_lengths


def _check_dtype(compute_dtype) -> None:
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype}: float32 or "
                         "bfloat16")


def transcribe_batch(params: ModelParams, cfg: ModelConfig,
                     vocab: list[str], audio_i16,
                     timestamp_words: bool = False,
                     compute_dtype: torch.dtype = torch.float32,
                     beam_size: int = 1,
                     beam_expansions: int | None = None,
                     return_confidence: bool = False,
                     return_nbest: int | None = None,
                     ctc: bool = False, lm=None, lm_weight: float = 0.3,
                     lm_bonus: float = 0.0, lm_rescore: bool = False,
                     min_mel_frames: int = 0):
    """Offline full-utterance transcription, greedy or beam (the
    reference's `transcribe` path: src/transcribe.cpp, nemo_transcribe_audio
    src/nemo-ggml.cpp:1585-1598; nemotron_tpu/streaming/session.py:879-1133).
    There is no 164 s position-table cap: the table is sized per call.

    audio_i16: one int16 PCM array (returns its text, a str), or a list or
    tuple of them (returns a list of texts), transcribed in one
    length-masked encoder pass and one decode. The mel runs on the params'
    device in f32; the encoder and the decoder in compute_dtype (f32 or
    bf16), with the params as they are (each op casts its weights to the
    activations' dtype, as the JAX package does).

    return_confidence (greedy only): returns (texts, token_lists) instead
    (for one utterance: (text, token_list)), each token list of (id,
    frame, log_posterior) triples from the greedy loop's log softmax at
    the emitting frame.

    beam_size > 1 decodes with the batched beam search (beam_expansions
    label rounds a frame). return_nbest=N (beam only) returns, per
    utterance, the N best hypotheses as (text, raw total log-prob), best
    first by the length-normalized score. lm adds shallow fusion to the
    search; with lm_rescore=True the search runs without it and the LM
    reranks the finished K hypotheses by raw_score + lm_weight *
    lm_sequence_logp + lm_bonus * length (return_nbest then reports those
    combined scores).

    A TDT checkpoint decodes with the duration-aware walk, or with the
    duration-aware beam for beam_size > 1 (the same n-best and rescoring
    epilogue). ctc=True decodes a hybrid checkpoint with its CTC head
    (greedy; return_confidence gives each token the argmax log-posterior
    at its first frame).

    min_mel_frames pads the batched mel's time axis to at least this many
    frames (masked out of the attention, as the shorter utterances'
    padding is)."""
    if return_confidence and beam_size > 1:
        raise ValueError("confidence requires greedy decode")
    if return_nbest is not None and beam_size <= 1:
        raise ValueError("n-best output requires beam_size > 1")
    check_beam_options(beam_size, lm)
    if lm_rescore and lm is None:
        raise ValueError("lm_rescore needs an LM (lm=)")
    if ctc and (beam_size > 1 or timestamp_words):
        raise ValueError("ctc decode is plain greedy (no beam or word "
                         "timestamps; confidence IS supported)")
    if ctc and params.ctc is None:
        raise ValueError("model has no CTC head (ctc_decoder.* tensors)")
    _check_dtype(compute_dtype)
    single = not isinstance(audio_i16, (list, tuple))
    utterances = [audio_i16] if single else audio_i16
    mel, enc_lengths = batch_mel(params, cfg, utterances, min_mel_frames)
    dev = params.device
    lengths = torch.from_numpy(enc_lengths).to(dev)
    enc = enc_mod.encode_batch(
        params, cfg, torch.from_numpy(mel).to(dev, compute_dtype),
        enc_lengths=lengths)
    if ctc:
        blank = cfg.blank_token
        if return_confidence:
            ids, lps = (x.cpu().numpy()
                        for x in ctc_mod.frame_log_posteriors(params, enc))
            token_lists = [ctc_mod.collapse_with_confidence(
                ids[i], lps[i], blank, int(enc_lengths[i]))
                for i in range(len(utterances))]
            texts = [tokens_to_text(tl, vocab) for tl in token_lists]
            return ((texts[0], token_lists[0]) if single
                    else (texts, token_lists))
        texts = [tokens_to_text([(i, 0) for i in ids], vocab)
                 for ids in ctc_mod.ctc_greedy_decode(
                     params, cfg, enc, enc_lengths=enc_lengths)]
        return texts[0] if single else texts
    if beam_size > 1:
        if timestamp_words:
            raise ValueError("word timestamps require greedy decode "
                             "(beam hypotheses carry no frame alignment)")
        out = _beam_texts(params, cfg, vocab, enc, lengths, compute_dtype,
                          beam_size, beam_expansions, return_nbest, lm,
                          lm_weight, lm_bonus, lm_rescore)
        return out[0] if single else out
    dec_state = dec_mod.init_decoder_state(cfg, len(utterances),
                                           compute_dtype, dev)
    if cfg.tdt_durations:
        out = tdt_mod.tdt_greedy_decode(params, cfg, enc, dec_state,
                                        enc_lengths=lengths,
                                        with_confidence=return_confidence)
        confs = out[1] if return_confidence else None
    else:
        out = dec_mod.greedy_decode(params, cfg, enc, dec_state,
                                    enc_lengths=lengths,
                                    with_confidence=return_confidence)
        confs = out[2] if return_confidence else None
    tokens = out[0].cpu().numpy()
    if return_confidence:
        emitted = dec_mod.extract_emitted(tokens, cfg.blank_token,
                                          confs=confs.cpu().numpy())
        token_lists = [emitted.get(i, []) for i in range(len(utterances))]
        texts = [tokens_to_text(tl, vocab, timestamp_words=timestamp_words)
                 for tl in token_lists]
        return ((texts[0], token_lists[0]) if single
                else (texts, token_lists))
    texts = [tokens_to_text(toks, vocab, timestamp_words=timestamp_words)
             for toks in dec_mod.tokens_to_list(tokens, cfg.blank_token)]
    return texts[0] if single else texts


def _beam_texts(params, cfg, vocab, enc, lengths, dtype, beam_size,
                beam_expansions, return_nbest, lm, lm_weight, lm_bonus,
                lm_rescore) -> list:
    """transcribe_batch's beam epilogue (nemotron_tpu/streaming/session.py:
    1025-1110): each utterance's text, or its n-best list of (text,
    score). A TDT checkpoint searches with the duration-aware beam."""
    dev = params.device
    B = enc.shape[0]
    if lm is not None:
        lm = lm_to_device(lm, dev)
    # second-pass rescoring runs the search acoustic-only
    lm_search = None if lm_rescore else lm
    tdt = bool(cfg.tdt_durations)
    state = init_beam(cfg, tdt, B, beam_size,
                      enc.shape[1] * MAX_SYMBOLS_PER_STEP, dtype, dev,
                      lm=lm_search)
    if tdt:
        state = tdt_mod.tdt_beam_decode(params, cfg, enc, state, beam_size,
                                        lengths, None, lm_search, lm_weight,
                                        lm_bonus)
    else:
        state = beam_mod.beam_decode(
            params, cfg, enc, state, beam_size,
            beam_expansions if beam_expansions is not None
            else MAX_SYMBOLS_PER_STEP, lengths, lm_search, lm_weight,
            lm_bonus)

    def text(tok_row, n) -> str:
        return tokens_to_text([(int(t), 0) for t in tok_row[:n]], vocab)

    if lm_rescore:
        from ..models.lm import rescore_nbest

        # rescore the full beam, then take the requested n
        ntok, nlen, nsc = beam_mod.n_best(state, None, length_norm=False)
        order, comb = rescore_nbest(lm, ntok, nlen, nsc, cfg.blank_token,
                                    lm_weight, lm_bonus)
        order, comb = order.cpu().numpy(), comb.cpu().numpy()
        ntok, nlen = ntok.cpu().numpy(), nlen.cpu().numpy()
        if return_nbest is not None:
            return [[(text(ntok[i, j], nlen[i, j]), float(comb[i, j]))
                     for j in order[i, :return_nbest]] for i in range(B)]
        return [text(ntok[i, order[i, 0]], nlen[i, order[i, 0]])
                for i in range(B)]
    if return_nbest is not None:
        ntok, nlen, nsc = (x.cpu().numpy() for x in beam_mod.n_best(
            state, return_nbest, length_norm=True))
        return [[(text(ntok[i, j], nlen[i, j]), float(nsc[i, j]))
                 for j in range(ntok.shape[1])] for i in range(B)]
    btok, blen, _ = beam_mod.best_hypothesis(state, length_norm=True)
    btok, blen = btok.cpu().numpy(), blen.cpu().numpy()
    return [text(btok[i], blen[i]) for i in range(B)]


def transcribe_batch_with_state(params: ModelParams, cfg: ModelConfig,
                                vocab: list[str], audio_i16,
                                dec_state=None, frame_offset: int = 0,
                                compute_dtype: torch.dtype = torch.float32):
    """Whole-segment transcription carrying the decoder state across calls
    (the reference's nemo_transcribe_audio_with_state,
    src/nemo-ggml.cpp:1603-1683; nemotron_tpu/streaming/session.py:
    1136-1170): successive segments share the LSTM state and prev_token,
    and token frames continue from `frame_offset`. Only the decoder state
    carries over; the encoder sees each segment on its own (StreamSession
    keeps the encoder's caches).

    Returns (text, tokens [(id, abs_frame)], dec_state',
    next_frame_offset)."""
    _check_dtype(compute_dtype)
    mel, _ = batch_mel(params, cfg, [audio_i16])
    dev = params.device
    enc = enc_mod.encode_batch(params, cfg,
                               torch.from_numpy(mel).to(dev, compute_dtype))
    if dec_state is None:
        dec_state = dec_mod.init_decoder_state(cfg, 1, compute_dtype, dev)
    tokens, dec_state = dec_mod.greedy_decode(params, cfg, enc, dec_state)
    toks = [(tid, frame + frame_offset) for tid, frame in
            dec_mod.tokens_to_list(tokens[0].cpu().numpy(), cfg.blank_token)]
    return (tokens_to_text(toks, vocab), toks, dec_state,
            frame_offset + enc.shape[1])
