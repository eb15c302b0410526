"""Many-stream continuous-batching serving engine (greedy RNN-T).

The port's counterpart of `nemotron_tpu/streaming/serving.py` without its
decode variants, mesh and snapshots. A fixed slab of `n_slots` stream slots
keeps its state on the params' device; admission and eviction zero a
slot's slices (the reference's reset semantics, src/nemo-stream.cpp:81-101,
per slot).

Each engine tick runs ONE step-masked chunk step over all slots: slots
without a full chunk buffered are masked out (their device state frozen,
not fed padding), so streams arrive and advance at independent rates and
join and leave while the others run. Ring phases are kept in lockstep; a
slot that skipped ticks has its ring realigned (rolled) when it resumes,
so every stream's transcript equals its solo run's.

The DSP runs on the host (`dsp="numpy"`: numpy framing per slot, one
`torch.fft` spectral pass over every fed slot's frames) or on the device
(`dsp="device"`: raw int16 PCM in, the whole DSP chain inside the tick).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import CacheConfig, ModelConfig, PreprocessorConfig
from ..frontend.device_frontend import (FrontendState, frames_after,
                                        mel_frontend_step, residue_after)
from ..frontend.preprocessor import StreamingPreprocessor, pad_window
from ..models import decoder as dec_mod
from ..models import encoder as enc_mod
from ..params import ModelParams, cast_params
from ..utils.text import tokens_to_text
from .session import _check_dtype, chunk_step_masked


class _MelBuffer:
    """Per-slot mel FIFO as a list of parts: appends are O(1); the parts are
    joined only when a chunk is consumed (once per tick per ready slot)."""

    __slots__ = ("parts", "count")

    def __init__(self, seed: np.ndarray):
        self.parts = [seed]
        self.count = seed.shape[0]

    def append(self, mel: np.ndarray) -> None:
        self.parts.append(mel)
        self.count += mel.shape[0]

    def compact(self) -> np.ndarray:
        if len(self.parts) > 1:
            self.parts = [np.concatenate(self.parts)]
        return self.parts[0]

    def drop(self, k: int) -> None:
        self.parts = [self.compact()[k:]]  # view, no copy
        self.count -= k


class _SegmentBuffer:
    """Per-slot raw PCM of the CURRENT utterance (keep_segment_audio),
    addressed in absolute samples since admission, so that a segment cut
    lands on the endpointer's processed-frame boundary (buffered but
    unprocessed audio, which may hold the next utterance's onset, stays).
    Bounded by `cap` samples: overflow drops the oldest audio and marks
    the segment truncated."""

    __slots__ = ("parts", "abs0", "total", "cap", "truncated")

    def __init__(self, cap: int):
        self.parts: list[np.ndarray] = []
        self.abs0 = 0          # absolute sample index of parts[0][0]
        self.total = 0         # buffered samples
        self.cap = cap
        self.truncated = False

    def append(self, pcm: np.ndarray) -> None:
        self.parts.append(pcm)
        self.total += pcm.size
        if self.total > self.cap:
            drop = self.total - self.cap
            self.parts = [self.compact()[drop:]]
            self.abs0 += drop
            self.total = self.cap
            self.truncated = True

    def cut(self, upto_abs: int) -> np.ndarray:
        """Return the buffered samples in [abs0, upto_abs) and drop them."""
        buf = self.compact()
        k = max(0, min(int(upto_abs) - self.abs0, buf.size))
        seg, rest = buf[:k], buf[k:]
        self.parts = [rest] if rest.size else []
        self.abs0 += k
        self.total = rest.size
        self.truncated = False
        return seg

    def compact(self) -> np.ndarray:
        if len(self.parts) > 1:
            self.parts = [np.concatenate(self.parts)]
        return self.parts[0] if self.parts else np.zeros(0, np.int16)


class _PcmBuffer:
    """Per-slot raw-PCM FIFO (device DSP): O(1) appends, joined only when a
    DSP quantum is consumed."""

    __slots__ = ("parts", "count")

    def __init__(self):
        self.parts: list[np.ndarray] = []
        self.count = 0

    def append(self, pcm: np.ndarray) -> None:
        self.parts.append(pcm)
        self.count += pcm.shape[0]

    def take(self, k: int) -> np.ndarray:
        if len(self.parts) > 1:
            self.parts = [np.concatenate(self.parts)]
        buf = self.parts[0] if self.parts else np.zeros(0, np.int16)
        out, self.parts = buf[:k], [buf[k:]]
        self.count -= k
        return out


def _reset_slots(enc_state, dec_state, mask: np.ndarray, blank_token: int):
    """Zero every masked slot's caches and decoder state in place, one
    index_fill_ per leaf (admission and eviction both come down to this)."""
    idx = torch.from_numpy(np.flatnonzero(mask)).to(enc_state.k_cache.device)
    for leaf, dim, value in (
            (enc_state.k_cache, 1, 0), (enc_state.v_cache, 1, 0),
            (enc_state.conv_cache, 1, 0), (enc_state.k_scale, 1, 1.0),
            (enc_state.v_scale, 1, 1.0), (enc_state.valid_len, 0, 0),
            (enc_state.phase, 0, 0), (dec_state.h, 0, 0),
            (dec_state.c, 0, 0), (dec_state.prev_token, 0, blank_token)):
        leaf.index_fill_(dim, idx, value)
    return enc_state, dec_state


def _reset_slot(enc_state, dec_state, slot: int, blank_token: int):
    """_reset_slots for one slot."""
    mask = np.zeros(enc_state.valid_len.shape[0], bool)
    mask[slot] = True
    return _reset_slots(enc_state, dec_state, mask, blank_token)


def _reset_decoder_slots(dec_state, mask: torch.Tensor, blank_token: int):
    """A fresh prediction network for the masked slots. Utterance
    endpointing resets only the decoder (LSTM h/c and prev_token): the
    encoder's caches keep rolling, so acoustic context carries across the
    utterance boundary (the reference has no endpointer; its decoder state
    lives for the whole stream, src/nemo-ggml.h:358-398)."""
    m3 = mask[:, None, None]
    return dec_mod.DecoderState(
        h=torch.where(m3, 0, dec_state.h),
        c=torch.where(m3, 0, dec_state.c),
        prev_token=torch.where(mask, blank_token, dec_state.prev_token).to(
            dec_state.prev_token.dtype))


def _device_dsp_front(cc: CacheConfig, pcfg: PreprocessorConfig, pcm_i16,
                      front_res, front_last, mel_buf, window, filterbank,
                      dsp_mask, fresh_mask):
    """The DSP half of the device tick: scale, pre-emphasis, framing, rFFT
    and mel for every slot, kept for the DSP-advancing ones, then the
    two-offset insert into their mel buffers. Frozen slots' DSP state and
    mel buffer pass through unchanged. Returns (front_res, front_last,
    mel_buf)."""
    mel, new = mel_frontend_step(
        pcm_i16, FrontendState(last_sample=front_last, residue=front_res),
        window, filterbank, pcfg)
    front_res = torch.where(dsp_mask[:, None], new.residue, front_res)
    front_last = torch.where(dsp_mask, new.last_sample, front_last)

    mel = mel.to(mel_buf.dtype)
    F = mel.shape[1]
    fresh_off = cc.pre_encode_cache_size          # after the 9-frame seed
    steady_off = cc.chunk_mel_frames - 1          # invariant: see _RCAP
    buf_fresh = mel_buf.clone()
    buf_fresh[:, fresh_off:fresh_off + F - 1] = mel[:, 1:]
    buf_steady = mel_buf.clone()
    buf_steady[:, steady_off:steady_off + F] = mel
    m3 = (dsp_mask & fresh_mask)[:, None, None]
    s3 = (dsp_mask & ~fresh_mask)[:, None, None]
    mel_buf = torch.where(m3, buf_fresh, torch.where(s3, buf_steady, mel_buf))
    return front_res, front_last, mel_buf


def _mel_buf_shift(cc: CacheConfig, mel_buf, consume_mask):
    """Drop one chunk shift of frames from the consuming slots' buffers."""
    shifted = torch.cat([mel_buf[:, cc.shift_mel_frames:],
                         torch.zeros_like(mel_buf[:, :cc.shift_mel_frames])],
                        dim=1)
    return torch.where(consume_mask[:, None, None], shifted, mel_buf)


def _device_dsp_tick(params, cfg: ModelConfig, cc: CacheConfig,
                     pcfg: PreprocessorConfig, pcm_i16, front_res,
                     front_last, mel_buf, enc_state, dec_state, pos_heads,
                     window, filterbank, dsp_mask: np.ndarray,
                     fresh_mask: np.ndarray, consume_mask: np.ndarray):
    """One ragged tick with the DSP on the device: the DSP for every
    DSP-advancing slot, the two-offset mel-buffer insert, then ONE masked
    encoder + decode chunk step for the consuming slots.

    Three host masks carry the raggedness: `dsp_mask` (the slot consumes
    one PCM quantum), `fresh_mask` (its first quantum since admission: the
    zero residue yields one leading artifact frame, dropped by writing
    frames[1:] at the fresh offset; ServingEngine._RCAP) and `consume_mask`
    (a full chunk is buffered after the insert). Frozen slots' DSP state,
    mel buffer, caches and decoder state pass through unchanged. A tick in
    which no slot consumes runs no encoder (tokens None): a fully masked
    chunk step changes nothing. Returns (tokens, front_res, front_last,
    mel_buf, enc_state, dec_state)."""
    dev = mel_buf.device
    dsp_m, fresh_m, consume_m = (torch.from_numpy(m).to(dev) for m in
                                 (dsp_mask, fresh_mask, consume_mask))
    front_res, front_last, mel_buf = _device_dsp_front(
        cc, pcfg, pcm_i16, front_res, front_last, mel_buf, window,
        filterbank, dsp_m, fresh_m)
    tokens = None
    if consume_mask.any():
        tokens, enc_state, dec_state = chunk_step_masked(
            params, cfg, cc, mel_buf[:, :cc.chunk_mel_frames], enc_state,
            dec_state, pos_heads, consume_m)
        mel_buf = _mel_buf_shift(cc, mel_buf, consume_m)
    return tokens, front_res, front_last, mel_buf, enc_state, dec_state


class ServingEngine:
    """Continuous batching over `n_slots` stream slots on the params'
    device, in `compute_dtype` (float32 or bfloat16), with greedy RNN-T.

    dsp: "numpy" (host framing, one spectral pass a tick), "device" (the
    DSP inside the tick; the stream runs one chunk behind real time until
    `finalize_stream`) or "auto" ("device" when the params live on CUDA,
    else "numpy").

    endpoint_silence_s: a slot that emitted at least one token and then
    stays silent this long (in encoder frames) fires an endpoint event
    (`poll_endpoints`); endpoint_reset=True also gives it a fresh
    prediction network; keep_segment_audio=True keeps each utterance's PCM
    (at most max_segment_s) for `poll_endpoints(with_audio=True)`.

    Beam search, CTC, TDT checkpoints and LM fusion (the decode-variants
    slice), confidence (the timestamps/confidence slice), a device mesh
    (multi-GPU), snapshots (the snapshots slice) and dsp="native" (the
    native-bindings slice) come with later slices of the port and raise
    NotImplementedError."""

    def __init__(self, params: ModelParams, cfg: ModelConfig,
                 vocab: list[str] | None = None,
                 cache_config: CacheConfig | None = None,
                 n_slots: int = 64, mesh=None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dsp: str = "auto", beam_size: int = 1,
                 confidence: bool = False,
                 endpoint_silence_s: float | None = None,
                 endpoint_reset: bool = False,
                 ctc: bool = False, lm=None,
                 keep_segment_audio: bool = False,
                 max_segment_s: float = 120.0):
        if beam_size > 1 or lm is not None:
            raise NotImplementedError("beam search and LM fusion come with "
                                      "the decode-variants slice of the port")
        if ctc:
            raise NotImplementedError("CTC decode comes with the decode-"
                                      "variants slice of the port")
        if cfg.tdt_durations:
            raise NotImplementedError("TDT decode comes with the decode-"
                                      "variants slice of the port")
        if confidence:
            raise NotImplementedError("confidence comes with the timestamps, "
                                      "confidence and subtitles slice of the "
                                      "port")
        if mesh is not None:
            raise NotImplementedError("a device mesh comes with the "
                                      "multi-GPU slice of the port")
        if dsp == "native":
            raise NotImplementedError("the native frontend comes with the "
                                      "utils and native-bindings slice of "
                                      "the port")
        if dsp not in ("auto", "numpy", "device"):
            raise ValueError(f"dsp={dsp!r}: 'auto', 'numpy' or 'device'")
        _check_dtype(compute_dtype)
        self.cfg = cfg
        self.cc = cache_config or CacheConfig(n_mels=cfg.n_mels)
        self.vocab = vocab or []
        self.n_slots = n_slots
        self.dtype = compute_dtype
        self.device = params.device

        # Utterance endpointing: silence is counted in encoder output frames
        # (subsampling * hop = 80 ms of audio by default, the reference's
        # timed_token unit, src/nemo-ggml.h:343-355). endpoint_reset trades
        # (measured on the tones fixture in the JAX package): with it, an
        # utterance's last tokens still inside the 70-frame window can be
        # re-emitted as a phantom utterance; without it, carried decoder
        # state can miss an utterance's leading tokens after long silences.
        self._ep_frames = None
        self._ep_reset = bool(endpoint_reset)
        if endpoint_silence_s is not None:
            frame_s = (self.cc.subsampling_factor * self.cc.hop_length
                       / self.cc.sample_rate)
            self._ep_frames = max(1, round(endpoint_silence_s / frame_s))
        self.keep_segment_audio = bool(keep_segment_audio)
        if self.keep_segment_audio:
            if self._ep_frames is None:
                raise ValueError("keep_segment_audio needs endpointing "
                                 "(endpoint_silence_s) to bound segments")
            self._seg_cap = int(max_segment_s * self.cc.sample_rate)
            self.seg_buffers = [_SegmentBuffer(self._seg_cap)
                                for _ in range(n_slots)]
            # samples of one encoder output frame (the endpointer's unit)
            self._seg_spf = (self.cc.subsampling_factor
                             * self.cc.hop_length)

        dev = self.device
        self.params = cast_params(params, compute_dtype)
        self.pos_heads = enc_mod.precompute_pos_heads(
            self.params, cfg, self.cc, compute_dtype)
        self.enc_state = enc_mod.init_encoder_state(cfg, self.cc, n_slots,
                                                    compute_dtype, dev)
        self.dec_state = dec_mod.init_decoder_state(cfg, n_slots,
                                                    compute_dtype, dev)

        fb = params.preprocessor.filterbank.float().cpu().numpy()
        win = params.preprocessor.window.float().cpu().numpy()
        pcfg = PreprocessorConfig(n_mels=cfg.n_mels)
        self._pcfg = pcfg
        if dsp == "auto":
            dsp = "device" if dev.type == "cuda" else "numpy"
        self.dsp_mode = dsp
        self.preprocs: list[StreamingPreprocessor] = []
        if dsp == "device":
            # Each slot advances by one chunk shift of samples a DSP step,
            # so after its first quantum the residue length is a constant
            # (_RCAP) and every slot's DSP batches with fixed shapes. A fresh
            # slot starts with _RCAP zeros instead of the n_fft/2 center
            # pad; its first quantum then yields one extra leading artifact
            # frame, dropped in _device_dsp_front. After that the frames and
            # residue are sample-exact with a solo stream.
            self._quantum = self.cc.shift_samples
            r1 = residue_after(pcfg.initial_pad, self._quantum, pcfg)
            self._RCAP = residue_after(r1, self._quantum, pcfg)
            assert residue_after(self._RCAP, self._quantum, pcfg) \
                == self._RCAP, "quantum has no steady-state residue length"
            self._F = frames_after(self._RCAP, self._quantum, pcfg)
            assert self._F == self.cc.shift_mel_frames
            self._drop = self._F - frames_after(pcfg.initial_pad,
                                                self._quantum, pcfg)
            assert self._drop == 1, (
                "fresh-slot artifact-frame count changed; _device_dsp_front "
                "writes mel[:, 1:] at the fresh offset")
            self._window = torch.from_numpy(
                pad_window(win, pcfg.n_fft)).to(dev)
            self._filterbank = torch.from_numpy(fb).to(dev)
            cap = self.cc.chunk_mel_frames + self.cc.shift_mel_frames - 1
            self.front_res = torch.zeros((n_slots, self._RCAP),
                                         dtype=torch.float32, device=dev)
            self.front_last = torch.zeros((n_slots,), dtype=torch.float32,
                                          device=dev)
            self.mel_buf_dev = torch.zeros((n_slots, cap, cfg.n_mels),
                                           dtype=compute_dtype, device=dev)
            # host bookkeeping: per-slot PCM FIFOs, mel fill levels and the
            # first-quantum flag
            self.pcm_fifos = [_PcmBuffer() for _ in range(n_slots)]
            self.mel_fill = np.full(n_slots, self.cc.pre_encode_cache_size,
                                    np.int64)
            self.fresh = np.ones(n_slots, bool)
        else:
            self.preprocs = [
                StreamingPreprocessor(fb, win, n_streams=1, cfg=pcfg,
                                      device=dev)
                for _ in range(n_slots)]

        self.active = np.zeros(n_slots, bool)
        self.mel_buffers = [self._fresh_mel_buffer() for _ in range(n_slots)]
        self.tokens: list[list[tuple[int, int]]] = [[] for _ in range(n_slots)]
        self.transcripts = [""] * n_slots
        self.frame_offsets = np.zeros(n_slots, np.int64)
        self.step_times: list[float] = []
        # endpoint bookkeeping (host side; the device work is one masked
        # decoder reset in a tick that fired an endpoint)
        self.ep_silence = np.zeros(n_slots, np.int64)   # frames since emit
        self.ep_emitted = np.zeros(n_slots, bool)       # tokens this utt?
        self.ep_utt_start = np.zeros(n_slots, np.int64)  # idx into tokens[s]
        # (slot, end_idx, pcm) with end_idx = len(tokens[slot]) AT FIRE
        # TIME, so tokens of the next utterance emitted before the poll are
        # never given to the finished one
        self._ep_pending: list[tuple] = []
        # lifetime counters: evicted slots' work stays in stats()
        self.frames_retired = 0
        self.tokens_retired = 0
        self.utterances_retired = 0
        # ring lockstep: all advancing slots write at one ring phase; a slot
        # that skipped ticks is realigned on resume (encoder.realign_ring)
        self.n_seg = self.cc.kv_len // self.cc.chunk_enc_len
        self.phase_counter = 0
        self.slot_phase = np.zeros(n_slots, np.int64)

    def _fresh_mel_buffer(self) -> _MelBuffer:
        # 9-frame zero-seeded overlap (reference src/nemo-stream.cpp:58-60)
        return _MelBuffer(np.zeros(
            (self.cc.pre_encode_cache_size, self.cfg.n_mels), np.float32))

    def _dsp_reset(self, slot: int) -> None:
        if self.dsp_mode == "device":
            self.front_res[slot] = 0.0
            self.front_last[slot] = 0.0
            self.mel_buf_dev[slot] = 0
            self.pcm_fifos[slot] = _PcmBuffer()
            self.mel_fill[slot] = self.cc.pre_encode_cache_size
            self.fresh[slot] = True
        else:
            self.preprocs[slot].reset()

    # -- admission / eviction -------------------------------------------------

    def add_stream(self) -> int:
        free = np.flatnonzero(~self.active)
        if free.size == 0:
            raise RuntimeError("no free stream slots")
        slot = int(free[0])
        self.active[slot] = True
        self._clear_slot(slot)
        return slot

    def add_streams(self, count: int) -> list[int]:
        """Bulk admission: claim `count` free slots with one reset of the
        device state."""
        free = np.flatnonzero(~self.active)
        if free.size < count:
            raise RuntimeError(f"need {count} free slots, have {free.size}")
        slots = free[:count]
        mask = np.zeros(self.n_slots, bool)
        mask[slots] = True
        self.enc_state, self.dec_state = _reset_slots(
            self.enc_state, self.dec_state, mask, self.cfg.blank_token)
        for s in slots:
            s = int(s)
            self.active[s] = True
            self._dsp_reset(s)
            self.mel_buffers[s] = self._fresh_mel_buffer()
            self.tokens[s] = []
            self.transcripts[s] = ""
            self.frame_offsets[s] = 0
            self.slot_phase[s] = 0
        return [int(s) for s in slots]

    def remove_stream(self, slot: int, return_tokens: bool = False):
        """Evict the slot and return its transcript (with
        return_tokens=True: (text, [(id, frame), ...]))."""
        text = self.transcripts[slot]
        toks = list(self.tokens[slot])
        self.active[slot] = False
        self._clear_slot(slot)
        return (text, toks) if return_tokens else text

    def finalize_stream(self, slot: int, return_tokens: bool = False):
        """Flush the slot's pending audio: drain whole chunks, pad the
        trailing partial chunk (the session's finalize), then evict and
        return the final transcript (with return_tokens=True: (text,
        tokens))."""
        return self.finalize_streams([slot], return_tokens)[0]

    def finalize_streams(self, slots, return_tokens: bool = False) -> list:
        """finalize_stream for several slots at once: their pads go into
        the same ticks (the slots are independent under the step mask, so
        each result equals its own finalize_stream's). Returns the final
        transcripts in the order of `slots`."""
        for slot in slots:
            assert self.active[slot], f"slot {slot} inactive"
        if self.dsp_mode == "device":
            # silence-PCM pad, not zero mel. The device path runs one chunk
            # behind real time (the first quantum is one mel frame short of
            # a chunk, and the deficit persists): one quantum of silence
            # flushes the frames pending in the mel buffer, and audio left
            # in the FIFO (a partial quantum) takes a second one to be
            # decoded. The JAX package pads only that partial quantum out
            # and so drops the audio in it.
            self.step()                 # drain whole quanta
            for slot in slots:
                fifo = self.pcm_fifos[slot]
                if fifo.count > 0 or not self.fresh[slot]:
                    n_quanta = 2 if fifo.count > 0 else 1
                    fifo.append(np.zeros(n_quanta * self._quantum
                                         - fifo.count, np.int16))
            self.step()
        else:
            if any(self.mel_buffers[s].count >= self.cc.chunk_mel_frames
                   for s in slots):
                self.step()  # drain full chunks before padding the tails
            padded = False
            for slot in slots:
                buf = self.mel_buffers[slot]
                if buf.count > self.cc.pre_encode_cache_size:
                    pad = self.cc.chunk_mel_frames - buf.count
                    if pad > 0:
                        buf.append(np.zeros((pad, self.cfg.n_mels),
                                            np.float32))
                    padded = True
            if padded:
                self.step()
        return [self.remove_stream(s, return_tokens) for s in slots]

    def _clear_slot(self, slot: int) -> None:
        self.enc_state, self.dec_state = _reset_slot(
            self.enc_state, self.dec_state, slot, self.cfg.blank_token)
        self._dsp_reset(slot)
        self.mel_buffers[slot] = self._fresh_mel_buffer()
        self.frames_retired += int(self.frame_offsets[slot])
        self.tokens_retired += len(self.tokens[slot])
        self.tokens[slot] = []
        self.transcripts[slot] = ""
        self.frame_offsets[slot] = 0
        self.ep_silence[slot] = 0
        self.ep_emitted[slot] = False
        self.ep_utt_start[slot] = 0
        self._ep_pending = [p for p in self._ep_pending if p[0] != slot]
        if self.keep_segment_audio:
            self.seg_buffers[slot] = _SegmentBuffer(self._seg_cap)
        # the device phase is 0 now; the slot's first step realigns it to
        # the engine's phase
        self.slot_phase[slot] = 0

    # -- the engine tick -------------------------------------------------------

    def feed_audio(self, audio_by_slot: dict[int, np.ndarray]) -> None:
        """Stage int16 PCM per slot; slots advance at independent rates (a
        slot that falls behind skips ticks, its device state frozen by the
        step mask)."""
        for slot in audio_by_slot:
            assert self.active[slot], f"slot {slot} inactive"
        if self.keep_segment_audio:
            for slot, audio in audio_by_slot.items():
                self.seg_buffers[slot].append(
                    np.asarray(audio, np.int16).ravel())
        if self.dsp_mode == "device":
            # stage raw PCM only; the DSP runs inside the tick
            for slot, audio in audio_by_slot.items():
                self.pcm_fifos[slot].append(
                    np.asarray(audio, np.int16).ravel())
            return
        slots, frames_list = [], []
        for slot, audio in audio_by_slot.items():
            frames = self.preprocs[slot].frame_only(
                np.asarray(audio, np.int16)[None])[0]
            if frames.shape[0]:
                slots.append(slot)
                frames_list.append(frames)
        if not slots:
            return
        # ONE spectral pass over every fed slot's frames (concatenated on
        # the frame axis), split back per slot
        mel_all = self.preprocs[0].spectral(np.concatenate(frames_list))
        ofs = 0
        for slot, frames in zip(slots, frames_list):
            c = frames.shape[0]
            self.mel_buffers[slot].append(mel_all[ofs:ofs + c])
            ofs += c

    def _ready(self) -> np.ndarray:
        need = self.cc.chunk_mel_frames
        return np.array(
            [self.active[s] and self.mel_buffers[s].count >= need
             for s in range(self.n_slots)], bool)

    def _realign(self, slots) -> None:
        """Roll the ring of each slot that skipped ticks to the engine's
        phase before it advances."""
        for s in slots:
            if self.slot_phase[s] != self.phase_counter:
                delta = int((self.phase_counter - self.slot_phase[s])
                            % self.n_seg)
                self.enc_state = enc_mod.realign_ring(
                    self.enc_state, int(s), delta, self.cc.chunk_enc_len)
                self.slot_phase[s] = self.phase_counter

    def _emit(self, tokens: np.ndarray, out: dict[int, str]) -> dict:
        """Append each slot's emitted tokens and text; returns them per
        slot. Masked slots emit only blanks."""
        emitted = dec_mod.extract_emitted(tokens, self.cfg.blank_token,
                                          self.frame_offsets)
        for slot, toks in emitted.items():
            self.tokens[slot].extend(toks)
            text = tokens_to_text(toks, self.vocab)
            self.transcripts[slot] += text
            out[slot] = out.get(slot, "") + text
        return emitted

    # -- utterance endpointing --------------------------------------------------

    def _ep_update(self, emitted: dict, advanced: np.ndarray,
                   frames_advanced: int) -> None:
        """Called once per tick AFTER frame_offsets advanced: track each
        slot's silence (encoder frames since its last token), queue endpoint
        events, and reset the fired slots' decoder state in one call."""
        if self._ep_frames is None or advanced.size == 0:
            return
        self.ep_silence[advanced] += frames_advanced
        for slot, toks in emitted.items():
            # silence restarts after the LAST token's frame, which can sit
            # mid-chunk: offsets are post-advance, frames are absolute
            last_frame = toks[-1][1]
            self.ep_silence[slot] = max(
                0, int(self.frame_offsets[slot]) - (last_frame + 1))
            self.ep_emitted[slot] = True
        fired = [int(s) for s in advanced
                 if self.ep_emitted[s]
                 and self.ep_silence[s] >= self._ep_frames]
        if not fired:
            return
        for s in fired:
            seg = None
            if self.keep_segment_audio:
                if self.seg_buffers[s].truncated:
                    print(f"warning: slot {s} utterance exceeded the "
                          f"{self._seg_cap / self.cc.sample_rate:.0f} s "
                          "retention cap; its segment is missing its oldest "
                          "audio", file=sys.stderr)
                # cut at the PROCESSED-frame boundary: buffered audio past
                # it (possibly the next utterance's onset) stays
                seg = self.seg_buffers[s].cut(
                    int(self.frame_offsets[s]) * self._seg_spf)
            self._ep_pending.append((s, len(self.tokens[s]), seg))
            self.ep_emitted[s] = False
            self.ep_silence[s] = 0
        if self._ep_reset:
            mask = np.zeros(self.n_slots, bool)
            mask[fired] = True
            self.dec_state = _reset_decoder_slots(
                self.dec_state, torch.from_numpy(mask).to(self.device),
                self.cfg.blank_token)

    def poll_endpoints(self, with_audio: bool = False):
        """Drain the utterance-endpoint events: one (slot, text, tokens) per
        utterance that ended since the last poll (with_audio=True, for
        engines built with keep_segment_audio: (slot, text, tokens, pcm)).
        The boundary was fixed at fire time; the slot's cumulative
        transcript is untouched."""
        if with_audio and not self.keep_segment_audio:
            raise ValueError("with_audio needs keep_segment_audio=True")
        out = []
        for s, end, seg in self._ep_pending:
            start = int(self.ep_utt_start[s])
            toks = self.tokens[s][start:end]
            text = tokens_to_text(toks, self.vocab)
            out.append((s, text, toks, seg) if with_audio
                       else (s, text, toks))
            self.ep_utt_start[s] = end
            self.utterances_retired += 1
        self._ep_pending = []
        return out

    def step(self) -> dict[int, str]:
        """Run masked chunk steps while any slot has a full chunk buffered;
        returns the new text per slot. Slots without enough mel are masked
        out of the step (state frozen), not fed padding."""
        if self.dsp_mode == "device":
            return self._step_device()
        cc = self.cc
        out: dict[int, str] = {}
        ready = self._ready()
        while ready.any():
            chunk_np = np.zeros(
                (self.n_slots, cc.chunk_mel_frames, self.cfg.n_mels),
                np.float32)
            ready_slots = np.flatnonzero(ready)
            for s in ready_slots:
                chunk_np[s] = self.mel_buffers[s].compact()[
                    :cc.chunk_mel_frames]
            self._realign(ready_slots)
            # cast to the compute dtype on the HOST, so that a bf16 upload
            # ships 2 bytes an element (the tick's largest upload)
            chunk = torch.from_numpy(chunk_np).to(self.dtype).to(self.device)
            mask = torch.from_numpy(ready).to(self.device)
            t0 = time.perf_counter()
            tokens, self.enc_state, self.dec_state = chunk_step_masked(
                self.params, self.cfg, cc, chunk, self.enc_state,
                self.dec_state, self.pos_heads, mask)
            tokens = tokens.cpu().numpy()       # [S, valid_out, MAX]
            self.step_times.append(time.perf_counter() - t0)

            for slot in ready_slots:
                self.mel_buffers[slot].drop(cc.shift_mel_frames)
            emitted = self._emit(tokens, out)
            self.frame_offsets[ready_slots] += tokens.shape[1]
            self._ep_update(emitted, ready_slots, tokens.shape[1])
            self.phase_counter = (self.phase_counter + 1) % self.n_seg
            self.slot_phase[ready] = self.phase_counter
            ready = self._ready()
        return out

    def _step_device(self) -> dict[int, str]:
        """Device-DSP ticks: each gives every slot with a full PCM quantum
        (cc.shift_samples) staged one quantum of DSP, and runs ONE masked
        chunk step for the slots whose buffer then holds a full chunk;
        loops until no slot has a quantum staged. The host stacks one
        [S, quantum] int16 upload; the DSP runs on the device."""
        cc = self.cc
        S = self.n_slots
        out: dict[int, str] = {}
        while True:
            dsp = np.array([self.active[s]
                            and self.pcm_fifos[s].count >= self._quantum
                            for s in range(S)], bool)
            if not dsp.any():
                break
            fresh = self.fresh & dsp
            gain = np.where(dsp,
                            np.where(fresh, self._F - self._drop, self._F),
                            0)
            post_fill = self.mel_fill + gain
            consume = post_fill >= cc.chunk_mel_frames
            # the invariant that pins the two static write offsets
            steady_off = cc.chunk_mel_frames - 1
            for s in np.flatnonzero(dsp):
                want = (cc.pre_encode_cache_size if self.fresh[s]
                        else steady_off)
                assert self.mel_fill[s] == want, (
                    f"slot {s} fill {self.mel_fill[s]} != {want}")
            self._realign(np.flatnonzero(consume))

            pcm = np.zeros((S, self._quantum), np.int16)
            for s in np.flatnonzero(dsp):
                pcm[s] = self.pcm_fifos[s].take(self._quantum)
            pcm = torch.from_numpy(pcm).to(self.device)
            t0 = time.perf_counter()
            (tokens, self.front_res, self.front_last, self.mel_buf_dev,
             self.enc_state, self.dec_state) = _device_dsp_tick(
                self.params, self.cfg, cc, self._pcfg, pcm, self.front_res,
                self.front_last, self.mel_buf_dev, self.enc_state,
                self.dec_state, self.pos_heads, self._window,
                self._filterbank, dsp, fresh, consume)
            if tokens is not None:
                tokens = tokens.cpu().numpy()
            elif self.device.type == "cuda":    # a DSP-only tick
                torch.cuda.synchronize(self.device)
            self.step_times.append(time.perf_counter() - t0)

            self.mel_fill = np.where(consume,
                                     post_fill - cc.shift_mel_frames,
                                     post_fill)
            self.fresh = self.fresh & ~dsp
            if consume.any():
                emitted = self._emit(tokens, out)
                self.frame_offsets[np.flatnonzero(consume)] += \
                    cc.valid_out_len
                self._ep_update(emitted, np.flatnonzero(consume),
                                cc.valid_out_len)
                self.phase_counter = (self.phase_counter + 1) % self.n_seg
                self.slot_phase[consume] = self.phase_counter
        return out

    # -- snapshots (a later slice) ---------------------------------------------

    def save(self, path: str) -> None:
        raise NotImplementedError("engine snapshots come with the snapshots "
                                  "slice of the port")

    def load(self, path: str) -> None:
        raise NotImplementedError("engine snapshots come with the snapshots "
                                  "slice of the port")

    # -- stats -----------------------------------------------------------------

    def latency_percentiles(self) -> dict[str, float]:
        if not self.step_times:
            return {}
        t = np.asarray(self.step_times)
        return {"p50": float(np.percentile(t, 50)),
                "p90": float(np.percentile(t, 90)),
                "p99": float(np.percentile(t, 99)),
                "mean": float(t.mean())}

    def stats(self) -> dict:
        """Engine counters (the reference's stats block,
        src/transcribe_stream.cpp:184-191, over many streams)."""
        frame_s = (self.cc.subsampling_factor * self.cc.hop_length
                   / self.cc.sample_rate)
        audio_s = (float(self.frame_offsets.sum())
                   + self.frames_retired) * frame_s
        compute_s = float(np.sum(self.step_times))
        return {
            "active_slots": int(self.active.sum()),
            "n_slots": self.n_slots,
            "engine_steps": len(self.step_times),
            "audio_seconds_decoded": audio_s,
            "compute_seconds": compute_s,
            "aggregate_rtf": compute_s / audio_s if audio_s else 0.0,
            "latency": self.latency_percentiles(),
            "tokens_emitted": (int(sum(len(t) for t in self.tokens))
                               + self.tokens_retired),
            "utterances_finalized": self.utterances_retired,
        }
