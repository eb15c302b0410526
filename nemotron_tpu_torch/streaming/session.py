"""Streaming session engine and full-utterance transcription.

The port's counterpart of `nemotron_tpu/streaming/session.py` (greedy
RNN-T path) and of the reference's nemo_stream_* API
(src/nemo-stream.h:176-312). One `StreamSession` manages S parallel
streams: host-side PCM->mel frontend and mel buffer, plus `chunk_step`,
which runs the cached encoder and the greedy decode on the params' device
and brings back only int32 tokens. `transcribe_batch` is the reference's
whole-file path (src/transcribe.cpp): several utterances in one
length-masked encoder pass and one greedy decode.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import CacheConfig, ModelConfig, PreprocessorConfig
from ..frontend.preprocessor import StreamingPreprocessor
from ..models import decoder as dec_mod
from ..models import encoder as enc_mod
from ..params import ModelParams, cast_params
from ..utils.tones import enc_frames_of_mel
from ..utils.text import tokens_to_text

_DTYPES = (torch.float32, torch.bfloat16)


def chunk_step(params: ModelParams, cfg: ModelConfig, cc: CacheConfig,
               mel_chunk: torch.Tensor, enc_state, dec_state, pos_heads):
    """Fused streaming step: cached encoder + greedy RNN-T decode.

    mel_chunk: [S, chunk_mel_frames, n_mels]
    Returns (tokens [S, valid_out, MAX_SYMBOLS] int32 blank-padded,
             enc_state', dec_state'). The K/V rings of `enc_state` are
    updated in place (see encoder.encode_chunk)."""
    enc_out, enc_state = enc_mod.encode_chunk(params, cfg, cc, mel_chunk,
                                              enc_state, pos_heads)
    tokens, dec_state = dec_mod.greedy_decode(params, cfg, enc_out, dec_state)
    return tokens, enc_state, dec_state


def chunk_step_masked(params: ModelParams, cfg: ModelConfig, cc: CacheConfig,
                      mel_chunk: torch.Tensor, enc_state, dec_state,
                      pos_heads, step_mask: torch.Tensor):
    """chunk_step for continuous batching: `step_mask` [S] bool marks the
    streams that advance; the rest keep their caches, decoder state and
    valid_len and emit nothing (their mel rows are padding)."""
    enc_out, enc_state = enc_mod.encode_chunk(params, cfg, cc, mel_chunk,
                                              enc_state, pos_heads,
                                              step_mask=step_mask)
    tokens, dec_state = dec_mod.greedy_decode(params, cfg, enc_out, dec_state,
                                              step_mask=step_mask)
    return tokens, enc_state, dec_state


class StreamSession:
    """Lifecycle mirror of nemo_stream_init / process_incremental / finalize /
    get_transcript / get_tokens / reset. Runs on the params' device in
    `compute_dtype` (float32 or bfloat16: float leaves of the params, the
    position bias, both states and each mel chunk; quantized weights keep
    int8 and f32 scales), with the f32 filterbank and window the params
    carry."""

    def __init__(self, params: ModelParams, cfg: ModelConfig,
                 vocab: list[str] | None = None,
                 cache_config: CacheConfig | None = None,
                 n_streams: int = 1,
                 compute_dtype: torch.dtype = torch.float32,
                 trace_dir: str | None = None,
                 beam_size: int = 1,
                 confidence: bool = False,
                 ctc: bool = False):
        if beam_size > 1:
            raise NotImplementedError("beam search comes with the decode-"
                                      "variants slice of the port")
        if ctc:
            raise NotImplementedError("CTC decode comes with the decode-"
                                      "variants slice of the port")
        if cfg.tdt_durations:
            raise NotImplementedError("TDT decode comes with the decode-"
                                      "variants slice of the port")
        if confidence:
            raise NotImplementedError("confidence comes with the decode-"
                                      "variants slice of the port")
        if trace_dir is not None:
            raise NotImplementedError("dump tracing comes with the utils "
                                      "slice of the port")
        _check_dtype(compute_dtype)
        self.params = cast_params(params, compute_dtype)
        self.dtype = compute_dtype
        self.device = params.device
        self.cfg = cfg
        self.cc = cache_config or CacheConfig(n_mels=cfg.n_mels)
        self.vocab = vocab or []
        self.n_streams = n_streams

        self.preproc = StreamingPreprocessor(
            params.preprocessor.filterbank.float().cpu().numpy(),
            params.preprocessor.window.float().cpu().numpy(),
            n_streams=n_streams,
            cfg=PreprocessorConfig(n_mels=cfg.n_mels), device=self.device)
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
        self.preproc.reset()
        # 9-frame zero-seeded overlap (reference src/nemo-stream.cpp:58-60)
        self.mel_buffer = np.zeros((S, cc.pre_encode_cache_size, cfg.n_mels),
                                   np.float32)
        self.tokens: list[list[tuple[int, int]]] = [[] for _ in range(S)]
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
            tokens, self.enc_state, self.dec_state = chunk_step(
                self.params, self.cfg, cc, chunk, self.enc_state,
                self.dec_state, self.pos_heads)
            tokens = tokens.cpu().numpy()   # [S, valid_out, MAX]
            self.chunk_seconds += time.perf_counter() - t0
            self.total_chunks += 1
            self.mel_buffer = self.mel_buffer[:, cc.shift_mel_frames:]

            emitted = dec_mod.extract_emitted(
                tokens, self.cfg.blank_token,
                np.full(self.n_streams, self.frame_offset, np.int64))
            for s, toks in emitted.items():
                self.tokens[s].extend(toks)
                text = tokens_to_text(toks, self.vocab)
                self.transcripts[s] += text
                new_text[s] += text
            self.frame_offset += tokens.shape[1]
        return new_text

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

    def get_tokens(self, stream: int = 0) -> list[tuple[int, int]]:
        return self.tokens[stream]

    @property
    def rtf(self) -> float:
        """Real-time factor: compute seconds per audio second."""
        if self.total_audio_seconds == 0:
            return 0.0
        return self.total_compute_seconds / self.total_audio_seconds


def batch_mel(params: ModelParams, cfg: ModelConfig, utterances,
              min_mel_frames: int = 0):
    """Log-mel of each utterance (int16 PCM, 1-D) through its own
    StreamingPreprocessor on the params' device, zero-padded along time to
    max(longest, min_mel_frames) frames. Returns (mel [B, Tm, n_mels] f32
    numpy, enc_lengths [B] int32 numpy: each utterance's encoder frames)."""
    fb = params.preprocessor.filterbank.float().cpu().numpy()
    win = params.preprocessor.window.float().cpu().numpy()
    mels = []
    for audio in utterances:
        pre = StreamingPreprocessor(fb, win,
                                    cfg=PreprocessorConfig(n_mels=cfg.n_mels),
                                    device=params.device)
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
                     return_confidence: bool = False,
                     return_nbest: int | None = None,
                     ctc: bool = False, lm=None,
                     min_mel_frames: int = 0):
    """Offline full-utterance transcription, greedy RNN-T (the reference's
    `transcribe` path: src/transcribe.cpp, nemo_transcribe_audio
    src/nemo-ggml.cpp:1585-1598; nemotron_tpu/streaming/session.py:879-958,
    1121-1133). There is no 164 s position-table cap: the table is sized
    per call.

    audio_i16: one int16 PCM array (returns its text, a str), or a list or
    tuple of them (returns a list of texts), transcribed in one
    length-masked encoder pass and one greedy decode. The mel runs on the
    params' device in f32; the encoder and the decoder in compute_dtype
    (f32 or bf16), with the params as they are (each op casts its weights
    to the activations' dtype, as the JAX package does).

    min_mel_frames pads the batched mel's time axis to at least this many
    frames (masked out of the attention, as the shorter utterances'
    padding is). Beam search, confidence, n-best lists, CTC, LM fusion and TDT
    checkpoints come with later slices of the port and raise
    NotImplementedError."""
    if beam_size > 1 or return_nbest is not None or lm is not None:
        raise NotImplementedError("beam search, n-best lists and LM fusion "
                                  "come with the decode-variants slice of "
                                  "the port")
    if ctc:
        raise NotImplementedError("CTC decode comes with the decode-variants "
                                  "slice of the port")
    if cfg.tdt_durations:
        raise NotImplementedError("TDT decode comes with the decode-variants "
                                  "slice of the port")
    if return_confidence:
        raise NotImplementedError("confidence comes with the timestamps, "
                                  "confidence and subtitles slice of the "
                                  "port")
    _check_dtype(compute_dtype)
    single = not isinstance(audio_i16, (list, tuple))
    utterances = [audio_i16] if single else audio_i16
    mel, enc_lengths = batch_mel(params, cfg, utterances, min_mel_frames)
    dev = params.device
    lengths = torch.from_numpy(enc_lengths).to(dev)
    enc = enc_mod.encode_batch(
        params, cfg, torch.from_numpy(mel).to(dev, compute_dtype),
        enc_lengths=lengths)
    dec_state = dec_mod.init_decoder_state(cfg, len(utterances),
                                           compute_dtype, dev)
    tokens, _ = dec_mod.greedy_decode(params, cfg, enc, dec_state,
                                      enc_lengths=lengths)
    texts = [tokens_to_text(toks, vocab, timestamp_words=timestamp_words)
             for toks in dec_mod.tokens_to_list(tokens.cpu().numpy(),
                                                cfg.blank_token)]
    return texts[0] if single else texts


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
