"""Many-stream continuous-batching serving engine (RNN-T, TDT and CTC).

The port's counterpart of `nemotron_tpu/streaming/serving.py`. A fixed
slab of `n_slots` stream slots keeps its state on the params' device (or,
under a mesh, each rank its rows of it); admission and eviction zero a
slot's slices (the reference's reset semantics, src/nemo-stream.cpp:81-101,
per slot).

Each engine tick runs ONE step-masked chunk step over all slots: slots
without a full chunk buffered are masked out (their device state frozen,
not fed padding), so streams arrive and advance at independent rates and
join and leave while the others run. The chunk step is the decode family's
(`ServingEngine._decode`: greedy or beam RNN-T, the TDT walk or beam, the
CTC head); one shared tail (`_advance`) turns its output into text. Ring
phases are kept in lockstep; a slot that skipped ticks has its ring
realigned (rolled) when it resumes, so every stream's transcript equals
its solo run's.

The DSP runs on the host (`dsp="numpy"`: numpy framing per slot, one
`torch.fft` spectral pass over every fed slot's frames; `dsp="native"`:
one ragged call of the C++ frontend over every fed slot) or on the device
(`dsp="device"`: raw int16 PCM in, the whole DSP chain inside the tick).

`save` / `load` snapshot the whole engine in the JAX package's .npz format:
a fresh engine with the same slots resumes every stream exactly.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import CacheConfig, ModelConfig, PreprocessorConfig
from ..frontend.device_frontend import (FrontendState, frames_after,
                                        mel_frontend_step, residue_after)
from ..frontend import native as native_frontend
from ..frontend.preprocessor import StreamingPreprocessor, pad_window
from ..config import MAX_SYMBOLS_PER_STEP
from ..models import beam as beam_mod
from ..models import ctc as ctc_mod
from ..models import decoder as dec_mod
from ..models import encoder as enc_mod
from ..models.lm import lm_to_device
from ..parallel import mesh as mesh_mod
from ..params import ModelParams, cast_params
from ..utils import npz
from ..utils.text import tokens_to_text
from .session import (_check_dtype, beam_leaves, best_transcripts,
                      check_decode_options, chunk_step_ctc,
                      chunk_step_masked, chunk_step_masked_beam,
                      chunk_step_tdt, chunk_step_tdt_beam, init_beam,
                      restore_beam, restore_states, token_list, token_rows)


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


def _reset_beam_slots(beam_state, mask: np.ndarray, blank_token: int):
    """Give every masked slot a fresh beam in place (hypothesis 0 live at
    score 0, the others empty, a TDT beam's t and sym 0;
    nemotron_tpu/streaming/serving.py:175-202), one index_fill_ per
    leaf."""
    idx = torch.from_numpy(np.flatnonzero(mask)).to(beam_state.h.device)
    for k, leaf in beam_mod.leaves(beam_state).items():
        leaf.index_fill_(0, idx, {"prev_token": blank_token,
                                  "scores": beam_mod.NEG_INF,
                                  "tokens": blank_token}.get(k, 0))
    beam_state.scores[:, 0].index_fill_(0, idx, 0.0)
    return beam_state


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


def _device_dsp_tick(cc: CacheConfig, pcfg: PreprocessorConfig, pcm_i16,
                     front_res, front_last, mel_buf, window, filterbank,
                     dsp_mask: np.ndarray, fresh_mask: np.ndarray,
                     consume_mask: np.ndarray, decode,
                     any_consume: bool | None = None):
    """One ragged tick with the DSP on the device
    (nemotron_tpu/streaming/serving.py:269-496): the DSP for every
    DSP-advancing slot, the two-offset mel-buffer insert, then ONE masked
    chunk step, `decode(mel_chunk, consume)`, for the consuming slots (the
    engine's decode family: greedy or beam, RNN-T, TDT or CTC).

    Three host masks carry the raggedness: `dsp_mask` (the slot consumes
    one PCM quantum), `fresh_mask` (its first quantum since admission: the
    zero residue yields one leading artifact frame, dropped by writing
    frames[1:] at the fresh offset; ServingEngine._RCAP) and `consume_mask`
    (a full chunk is buffered after the insert). Frozen slots' DSP state,
    mel buffer, caches and decoder state pass through unchanged. A tick in
    which no slot consumes runs no encoder (result None): a fully masked
    chunk step changes nothing. `any_consume` overrides that test (a mesh
    rank's masks hold its rows only, and every rank must run the step
    when any row consumes). Returns (decode's result, front_res,
    front_last, mel_buf)."""
    dev = mel_buf.device
    dsp_m, fresh_m, consume_m = (torch.from_numpy(m).to(dev) for m in
                                 (dsp_mask, fresh_mask, consume_mask))
    front_res, front_last, mel_buf = _device_dsp_front(
        cc, pcfg, pcm_i16, front_res, front_last, mel_buf, window,
        filterbank, dsp_m, fresh_m)
    result = None
    if consume_mask.any() if any_consume is None else any_consume:
        result = decode(mel_buf[:, :cc.chunk_mel_frames], consume_m)
        mel_buf = _mel_buf_shift(cc, mel_buf, consume_m)
    return result, front_res, front_last, mel_buf


def check_engine_snapshot(z, beam_size: int, lm, dtype: torch.dtype,
                          device, ctc: bool = False, tdt: bool = False):
    """An engine snapshot's decode mode against the engine's (the JAX
    engines' checks): TDT against not, CTC against not, greedy against
    beam; returns the snapshot's beam state (None for greedy)."""
    for key, what, mine in (("tdt_skip", "TDT", tdt), ("ctc_prev", "CTC",
                                                         ctc)):
        if (key in z) != mine:
            raise ValueError(f"snapshot/engine {what}-mode mismatch: the "
                             f"snapshot {'carries' if key in z else 'has no'}"
                             f" {what} state")
    has_beam = "beam/h" in z
    if (beam_size > 1) != has_beam:
        raise ValueError(
            "snapshot/engine beam-mode mismatch: snapshot "
            f"{'carries' if has_beam else 'has no'} beam state, engine "
            f"beam_size={beam_size}")
    return (restore_beam(z, beam_size, lm, dtype, device, "engine", tdt=tdt)
            if has_beam else None)


class ServingEngine:
    """Continuous batching over `n_slots` stream slots on the params'
    device, in `compute_dtype` (float32 or bfloat16), with RNN-T greedy or
    beam decode.

    dsp: "numpy" (host framing, one spectral pass a tick), "native" (ONE
    C++ frontend over every slot: one ragged call a tick frames, transforms
    and filters every fed slot at its own sample count, with each slot's
    DSP state in C++; raises when its library cannot be built or loaded),
    "device" (the DSP inside the tick; the stream runs one chunk behind
    real time until `finalize_stream`) or "auto", which resolves as the
    JAX engine's (nemotron_tpu/streaming/serving.py:650-726): "device" when
    the params live on CUDA, else "native" when the library builds and
    loads, else "numpy". `dsp_mode` names the one resolved.

    confidence: tokens become (id, frame, log_posterior) triples (the
    greedy loop's log softmax at the emitting frame), in `tokens`,
    `finalize_stream(return_tokens=True)` and `poll_endpoints`.

    endpoint_silence_s: a slot that emitted at least one token and then
    stays silent this long (in encoder frames) fires an endpoint event
    (`poll_endpoints`); endpoint_reset=True also gives it a fresh
    prediction network; keep_segment_audio=True keeps each utterance's PCM
    (at most max_segment_s) for `poll_endpoints(with_audio=True)`.

    beam_size > 1 decodes every tick with the batched beam search (with LM
    shallow fusion when `lm` is given): frozen slots keep their whole beam,
    so raggedness works as in greedy mode. Beam transcripts are revisable:
    `step` returns {} and `refresh_transcripts` / `finalize_stream` read
    the current best hypotheses. Endpointing and confidence need greedy
    decode.

    A TDT checkpoint decodes with the duration-aware walk (each slot
    carries its jump overshoot, `tdt_skip`) or beam; ctc=True decodes a
    hybrid checkpoint with its CTC head (the collapse carry `ctc_prev` on
    the host).

    mesh (parallel.mesh.Mesh): every rank of the mesh builds the engine
    with the same arguments, is given the same calls and keeps the whole
    host state, as a process of a JAX multi-controller run does
    (nemotron_tpu/streaming/serving.py:636-647). The data axis splits the
    slot rows of the device work (each rank holds its rows' caches,
    decoder state and device DSP state); the model axis splits the
    encoder's FFNs and heads (parallel.mesh.shard_params). Tokens (and
    confidences, CTC ids) are gathered over the data axis each step, so
    every rank's `tokens`, `transcripts` and events equal the unsharded
    engine's. The decoder and joint stay whole, so the greedy loop's host
    syncs involve no collective. Every rank of a model group must issue
    the same sequence of encoder calls: the ragged decisions (admission,
    realign, the finalize loops, endpointing) are made from the host
    state, which is the same on every rank by construction, and a tick
    that steps any slot runs the chunk step on every rank (its rows
    masked where none of them is ready). A beam engine on a mesh holds its
    rows of the beam state (JAX's shard_stream_major, nemotron_tpu/
    streaming/serving.py:636-647); the best hypotheses are gathered over
    the data axis when the transcripts are refreshed, and the whole beam
    state when a snapshot is saved."""

    def __init__(self, params: ModelParams, cfg: ModelConfig,
                 vocab: list[str] | None = None,
                 cache_config: CacheConfig | None = None,
                 n_slots: int = 64, mesh=None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dsp: str = "auto", beam_size: int = 1,
                 beam_expansions: int | None = None,
                 max_beam_tokens: int = 4096,
                 confidence: bool = False,
                 endpoint_silence_s: float | None = None,
                 endpoint_reset: bool = False,
                 ctc: bool = False, lm=None, lm_weight: float = 0.3,
                 lm_bonus: float = 0.0,
                 keep_segment_audio: bool = False,
                 max_segment_s: float = 120.0):
        if confidence and beam_size > 1:
            raise ValueError("confidence requires greedy decode")
        if lm is not None and beam_size <= 1:
            raise ValueError("LM shallow fusion requires beam_size > 1")
        self.ctc, self.tdt = check_decode_options(params, cfg, ctc,
                                                  beam_size, endpoint_reset)
        if endpoint_silence_s is not None and beam_size > 1:
            raise ValueError("endpointing requires greedy decode")
        if dsp not in ("auto", "numpy", "native", "device"):
            raise ValueError(f"dsp={dsp!r}: 'auto', 'numpy', 'native' or "
                             "'device'")
        _check_dtype(compute_dtype)
        self.cfg = cfg
        self.cc = cache_config or CacheConfig(n_mels=cfg.n_mels)
        self.vocab = vocab or []
        self.n_slots = n_slots
        self.dtype = compute_dtype
        # the device rows [lo, hi) this rank holds (all of them off a mesh)
        self.mesh = mesh
        self._lo, self._hi = (0, n_slots) if mesh is None else \
            mesh.row_span(n_slots)
        if mesh is not None:
            params = mesh_mod.shard_params(params, mesh)
        self.device = params.device
        self.confidence = bool(confidence)
        self.beam_size = beam_size
        self.beam_expansions = (beam_expansions if beam_expansions is not None
                                else MAX_SYMBOLS_PER_STEP)
        self.lm = None if lm is None else lm_to_device(lm, self.device)
        self.lm_weight = float(lm_weight)
        self.lm_bonus = float(lm_bonus)

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
        B = self._hi - self._lo
        self.params = cast_params(params, compute_dtype)
        self.pos_heads = enc_mod.precompute_pos_heads(
            self.params, cfg, self.cc, compute_dtype)
        self.enc_state = enc_mod.init_encoder_state(
            cfg, self.cc, B, compute_dtype, dev,
            n_heads=enc_mod.local_heads(self.params, cfg))
        self.dec_state = dec_mod.init_decoder_state(cfg, B, compute_dtype,
                                                    dev)
        # beam mode: K hypotheses a slot (the server reads beam_state to
        # pick its PARTIAL semantics); transcripts are rebuilt from it
        # lazily, once a tick has advanced it (_beam_dirty)
        self.beam_state = None
        self._beam_dirty = False
        if beam_size > 1:
            self.beam_state = init_beam(cfg, self.tdt, B, beam_size,
                                        max_beam_tokens, compute_dtype, dev,
                                        lm=self.lm)
        # the TDT jump carry (device) and the CTC collapse carry (host)
        self.tdt_skip = (torch.zeros((B,), dtype=torch.int32, device=dev)
                         if self.tdt else None)
        self.ctc_prev = np.full(n_slots, -1, np.int64) if self.ctc else None

        fb = params.preprocessor.filterbank.float().cpu().numpy()
        win = params.preprocessor.window.float().cpu().numpy()
        pcfg = PreprocessorConfig(n_mels=cfg.n_mels)
        self._pcfg = pcfg
        if dsp == "auto":
            dsp = ("device" if dev.type == "cuda" else
                   "native" if native_frontend.available() else "numpy")
        self.dsp_mode = dsp
        self.preprocs: list[StreamingPreprocessor] = []
        self.native_fe = None
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
            self.front_res = torch.zeros((B, self._RCAP),
                                         dtype=torch.float32, device=dev)
            self.front_last = torch.zeros((B,), dtype=torch.float32,
                                          device=dev)
            self.mel_buf_dev = torch.zeros((B, cap, cfg.n_mels),
                                           dtype=compute_dtype, device=dev)
            # host bookkeeping: per-slot PCM FIFOs, mel fill levels and the
            # first-quantum flag
            self.pcm_fifos = [_PcmBuffer() for _ in range(n_slots)]
            self.mel_fill = np.full(n_slots, self.cc.pre_encode_cache_size,
                                    np.int64)
            self.fresh = np.ones(n_slots, bool)
        elif dsp == "native":
            self.native_fe = native_frontend.NativeFrontend(
                fb, pad_window(win, pcfg.n_fft), n_streams=n_slots,
                n_fft=pcfg.n_fft, hop=pcfg.n_window_stride,
                n_mels=cfg.n_mels, preemph=pcfg.preemph,
                log_zero_guard=pcfg.log_zero_guard)
        else:
            self.preprocs = [
                StreamingPreprocessor(fb, win, n_streams=1, cfg=pcfg,
                                      device=dev, backend="numpy")
                for _ in range(n_slots)]

        self.active = np.zeros(n_slots, bool)
        self.mel_buffers = [self._fresh_mel_buffer() for _ in range(n_slots)]
        self.tokens: list[list[tuple]] = [[] for _ in range(n_slots)]
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

    # -- the rows of the device work (a mesh rank holds its rows only) -------

    def _rows(self, a: np.ndarray) -> np.ndarray:
        """This rank's rows of a host array over every slot."""
        return a[self._lo:self._hi]

    def _row(self, slot: int) -> int | None:
        """A slot's row in the device state, None where another rank holds
        it."""
        return slot - self._lo if self._lo <= slot < self._hi else None

    def _whole(self, x: torch.Tensor) -> np.ndarray:
        """A per-slot device tensor of this rank's rows -> numpy over every
        slot (gathered over the data axis under a mesh; bf16 upcast to
        f32)."""
        if self.mesh is not None:
            x = mesh_mod.gather_rows(x, self.mesh)
        return npz.to_numpy(x)

    def _heads_split(self) -> bool:
        """Whether the K/V rings hold a rank's share of the heads."""
        return mesh_mod.rings_split(self.params, self.cc)

    def _fresh_mel_buffer(self) -> _MelBuffer:
        # 9-frame zero-seeded overlap (reference src/nemo-stream.cpp:58-60)
        return _MelBuffer(np.zeros(
            (self.cc.pre_encode_cache_size, self.cfg.n_mels), np.float32))

    def _dsp_reset(self, slot: int) -> None:
        if self.dsp_mode == "device":
            r = self._row(slot)
            if r is not None:
                self.front_res[r] = 0.0
                self.front_last[r] = 0.0
                self.mel_buf_dev[r] = 0
            self.pcm_fifos[slot] = _PcmBuffer()
            self.mel_fill[slot] = self.cc.pre_encode_cache_size
            self.fresh[slot] = True
        elif self.native_fe is not None:
            self.native_fe.reset_fresh(slot)
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
            self.enc_state, self.dec_state, self._rows(mask),
            self.cfg.blank_token)
        self._reset_decode_carries(mask)
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
        return_tokens=True: (text, [(id, frame[, log_posterior]), ...]));
        a beam slot's tokens carry frame 0."""
        self.refresh_transcripts()
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

    def _reset_decode_carries(self, mask: np.ndarray) -> None:
        """A fresh beam, TDT jump carry and CTC collapse carry for the
        masked slots (nemotron_tpu/streaming/serving.py:836-844)."""
        if self.beam_state is not None:
            self.beam_state = _reset_beam_slots(self.beam_state,
                                                self._rows(mask),
                                                self.cfg.blank_token)
        if self.tdt_skip is not None:
            self.tdt_skip.index_fill_(0, torch.from_numpy(np.flatnonzero(
                self._rows(mask))).to(self.device), 0)
        if self.ctc_prev is not None:
            self.ctc_prev[mask] = -1

    def _clear_slot(self, slot: int) -> None:
        mask = np.zeros(self.n_slots, bool)
        mask[slot] = True
        self.enc_state, self.dec_state = _reset_slots(
            self.enc_state, self.dec_state, self._rows(mask),
            self.cfg.blank_token)
        self._reset_decode_carries(mask)
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
        if self.native_fe is not None:
            # ONE ragged C++ call: framing, FFT and mel of every fed slot
            # at its own sample count (nemo_frontend_process_ragged)
            for slot, mel in self.native_fe.process_ragged(
                    audio_by_slot).items():
                if mel.shape[0]:
                    self.mel_buffers[slot].append(mel)
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
                r = self._row(int(s))
                if r is not None:
                    self.enc_state = enc_mod.realign_ring(
                        self.enc_state, r, delta, self.cc.chunk_enc_len)
                self.slot_phase[s] = self.phase_counter

    def _decode(self, chunk: torch.Tensor, mask: torch.Tensor):
        """ONE masked chunk step of the engine's decode family over all
        slots (a mesh rank's rows; `mask` [S] bool on the device: the
        advancing ones), the device state updated. Returns its host half
        over every slot: (tokens [S, T, MAX],
        confs or None) for greedy RNN-T and TDT, (ids [S, T], log-posteriors
        or None) for CTC, None for a beam (its transcripts are refreshed
        lazily; the device is synchronized, so the tick's time covers its
        work)."""
        p, cfg, cc = self.params, self.cfg, self.cc
        if self.beam_state is not None:
            if self.tdt:
                self.enc_state, self.beam_state = chunk_step_tdt_beam(
                    p, cfg, cc, chunk, self.enc_state, self.beam_state,
                    self.pos_heads, self.beam_size, self.lm, self.lm_weight,
                    self.lm_bonus, step_mask=mask)
            else:
                self.enc_state, self.beam_state = chunk_step_masked_beam(
                    p, cfg, cc, chunk, self.enc_state, self.beam_state,
                    self.pos_heads, mask, self.beam_size,
                    self.beam_expansions, self.lm, self.lm_weight,
                    self.lm_bonus)
            self._beam_dirty = True
            self._sync()
            return None
        if self.ctc:
            out, extra, self.enc_state = chunk_step_ctc(
                p, cfg, cc, chunk, self.enc_state, self.pos_heads,
                step_mask=mask, with_confidence=self.confidence)
        elif self.tdt:
            (out, self.enc_state, self.dec_state, self.tdt_skip,
             extra) = chunk_step_tdt(
                p, cfg, cc, chunk, self.enc_state, self.dec_state,
                self.pos_heads, self.tdt_skip, step_mask=mask,
                with_confidence=self.confidence)
        else:
            res = chunk_step_masked(p, cfg, cc, chunk, self.enc_state,
                                    self.dec_state, self.pos_heads, mask,
                                    with_confidence=self.confidence)
            out, self.enc_state, self.dec_state = res[:3]
            extra = res[3] if self.confidence else None
        return self._whole(out), None if extra is None else self._whole(extra)

    def _emit(self, result, slots: np.ndarray, out: dict[int, str]) -> dict:
        """Append each advancing slot's emitted tokens and text from a
        `_decode` result (with confidence: triples with their
        log-posteriors); returns them per slot. Masked slots emit nothing:
        a greedy step leaves them blank, the CTC collapse reads only
        `slots`."""
        first, second = result
        if self.ctc:
            emitted = ctc_mod.collapse_chunk(
                first.astype(np.int64), self.ctc_prev, slots,
                self.cfg.blank_token, self.frame_offsets, second)
        else:
            emitted = dec_mod.extract_emitted(first, self.cfg.blank_token,
                                              self.frame_offsets,
                                              confs=second)
        for slot, toks in emitted.items():
            self.tokens[slot].extend(toks)
            text = tokens_to_text(toks, self.vocab)
            self.transcripts[slot] += text
            out[slot] = out.get(slot, "") + text
        return emitted

    def _advance(self, stepped: np.ndarray, result, out: dict) -> None:
        """After a chunk step of the slots in the [S] bool mask `stepped`:
        emit a greedy or CTC step's tokens and update the endpointer (a
        beam step, result None, leaves the transcripts to
        refresh_transcripts), then advance the slots' frame offsets and
        chunk phase."""
        slots = np.flatnonzero(stepped)
        emitted = None if result is None else self._emit(result, slots, out)
        self.frame_offsets[slots] += self.cc.valid_out_len
        if emitted is not None:
            self._ep_update(emitted, slots, self.cc.valid_out_len)
        self.phase_counter = (self.phase_counter + 1) % self.n_seg
        self.slot_phase[stepped] = self.phase_counter

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
                self.dec_state,
                torch.from_numpy(self._rows(mask)).to(self.device),
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
            chunk = torch.from_numpy(self._rows(chunk_np)).to(self.dtype).to(
                self.device)
            mask = torch.from_numpy(self._rows(ready)).to(self.device)
            t0 = time.perf_counter()
            result = self._decode(chunk, mask)
            self.step_times.append(time.perf_counter() - t0)

            for slot in ready_slots:
                self.mel_buffers[slot].drop(cc.shift_mel_frames)
            self._advance(ready, result, out)
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
            pcm = torch.from_numpy(self._rows(pcm)).to(self.device)
            t0 = time.perf_counter()
            (result, self.front_res, self.front_last,
             self.mel_buf_dev) = _device_dsp_tick(
                cc, self._pcfg, pcm, self.front_res, self.front_last,
                self.mel_buf_dev, self._window, self._filterbank,
                self._rows(dsp), self._rows(fresh), self._rows(consume),
                self._decode, any_consume=bool(consume.any()))
            if not consume.any():               # a DSP-only tick
                self._sync()
            self.step_times.append(time.perf_counter() - t0)

            self.mel_fill = np.where(consume,
                                     post_fill - cc.shift_mel_frames,
                                     post_fill)
            self.fresh = self.fresh & ~dsp
            if consume.any():
                self._advance(consume, result, out)
        return out

    def _sync(self) -> None:
        """Wait for the device, so that a tick's time covers its work (a
        greedy tick brings its tokens to the host, which waits too)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def refresh_transcripts(self) -> list[str]:
        """Beam mode: rewrite every active slot's transcript and tokens from
        its current best hypothesis (nemotron_tpu/streaming/serving.py:
        1191-1205), one device call and one [S, U] download, only when a
        tick advanced the beam since the last refresh. Greedy transcripts
        are already incremental: a no-op."""
        if self.beam_state is not None and self._beam_dirty:
            for s, (toks, text) in best_transcripts(
                    self.beam_state, self.vocab,
                    np.flatnonzero(self.active), self.mesh).items():
                self.tokens[s] = toks
                self.transcripts[s] = text
            self._beam_dirty = False
        return list(self.transcripts)

    # -- checkpoint / resume ---------------------------------------------------

    def _dsp_state(self, slot: int, front=None) -> dict:
        """A slot's DSP state; `front` (device DSP): (residue, last_sample)
        of every slot, fetched once."""
        if self.dsp_mode == "device":
            res, last = front
            return {"last_sample": last[slot:slot + 1],
                    "residue": res[slot:slot + 1]}
        if self.native_fe is not None:
            return self.native_fe.slot_state_dict(slot)
        return self.preprocs[slot].state_dict()

    def _dsp_load_state(self, slot: int, st: dict) -> None:
        if self.dsp_mode == "device":
            r = self._row(slot)
            if r is not None:
                self.front_res[r] = torch.from_numpy(
                    np.asarray(st["residue"], np.float32).ravel().copy())
                self.front_last[r] = float(
                    np.asarray(st["last_sample"]).ravel()[0])
        elif self.native_fe is not None:
            self.native_fe.load_slot_state_dict(slot, st)
        else:
            self.preprocs[slot].load_state_dict(st)

    def save(self, path: str) -> None:
        """Snapshot the whole engine (all slots' device state, DSP state,
        admission map, endpointing, transcripts) as an .npz with the JAX
        package's keys (nemotron_tpu/streaming/serving.py:1351-1425).
        Restoring into a fresh engine with the same n_slots, cache config
        and DSP mode resumes every active stream exactly. On a mesh every
        rank calls it with the same path: the rows and heads are gathered,
        and rank 0 writes the file the unsharded engine writes.

        Device DSP (`devdsp/*`): the device mel buffer, its fill levels,
        the first-quantum flags and the PCM FIFOs, as the JAX engine's. The
        buffers mean the same in both packages; only the finalize differs
        (this port decodes a partial last quantum that the JAX engine
        drops), so a resumed stream ends as this port's engine ends it. A
        beam engine adds its beam/* leaves (and writes the transcripts of
        its current best hypotheses); a TDT engine its tdt_skip, a CTC
        engine its ctc_prev."""
        self.refresh_transcripts()
        enc, dec = self.enc_state, self.dec_state
        if self.mesh is not None:
            enc = mesh_mod.gather_state(enc, self.mesh, self._heads_split())
            dec = mesh_mod.gather_state(dec, self.mesh)
        flat = {f"enc/{k}": getattr(enc, k)
                for k in ("k_cache", "v_cache", "conv_cache", "valid_len",
                          "phase", "k_scale", "v_scale")}
        flat |= {f"dec/{k}": getattr(dec, k)
                 for k in ("h", "c", "prev_token")}
        flat |= {
            "active": self.active,
            "frame_offsets": self.frame_offsets,
            "transcripts": np.asarray(self.transcripts, dtype=object),
            "phase_counter": np.int64(self.phase_counter),
            "slot_phase": self.slot_phase,
        }
        if self.beam_state is not None:
            flat |= beam_leaves(self.beam_state, self.mesh)
        if self.tdt_skip is not None:
            flat["tdt_skip"] = self._whole(self.tdt_skip)
        if self.ctc_prev is not None:
            flat["ctc_prev"] = self.ctc_prev
        if self._ep_frames is not None:
            flat["ep/silence"] = self.ep_silence
            flat["ep/emitted"] = self.ep_emitted
            flat["ep/utt_start"] = self.ep_utt_start
            flat["ep/pending"] = np.asarray(
                [(s, e) for s, e, _seg in self._ep_pending],
                np.int64).reshape(-1, 2)
            for i, (_s, _e, seg) in enumerate(self._ep_pending):
                if seg is not None:
                    flat[f"ep/pending_seg/{i}"] = seg
        if self.keep_segment_audio:
            for s in range(self.n_slots):
                sb = self.seg_buffers[s]
                flat[f"seg/pcm/{s}"] = sb.compact()
                flat[f"seg/meta/{s}"] = np.asarray(
                    [sb.abs0, int(sb.truncated)], np.int64)
        front = ((self._whole(self.front_res), self._whole(self.front_last))
                 if self.dsp_mode == "device" else None)
        for s in range(self.n_slots):
            pp = self._dsp_state(s, front)
            flat[f"preproc/last_sample/{s}"] = pp["last_sample"]
            flat[f"preproc/residue/{s}"] = pp["residue"]
            flat[f"mel_buffer/{s}"] = self.mel_buffers[s].compact()
            flat[f"tokens/{s}"] = token_rows(self.tokens[s], self.confidence)
        if self.dsp_mode == "device":
            flat["devdsp/mel_buf"] = self._whole(self.mel_buf_dev)
            flat["devdsp/mel_fill"] = self.mel_fill
            flat["devdsp/fresh"] = self.fresh
            for s in range(self.n_slots):
                fifo = self.pcm_fifos[s]
                flat[f"devdsp/fifo/{s}"] = (
                    np.concatenate(fifo.parts) if fifo.parts
                    else np.zeros(0, np.int16))
        if self.mesh is None or self.mesh.rank == 0:
            npz.savez(path, flat)
        if self.mesh is not None:
            torch.distributed.barrier()

    def load(self, path: str) -> None:
        """Restore a snapshot written by `save` (or by the JAX engine) into
        this engine: fresh tensors on its device in its dtypes. The slot
        count must match; a snapshot of another decode mode (TDT, CTC,
        greedy against beam, width, LM fusion, beam family), or a host-DSP
        snapshot loaded into a device-DSP engine, raises ValueError."""
        z = npz.NpzView(np.load(path, allow_pickle=True))
        if z["active"].shape != (self.n_slots,):
            raise ValueError(f"snapshot has {z['active'].shape[0]} slots, "
                             f"the engine {self.n_slots}")
        beam_state = check_engine_snapshot(z, self.beam_size, self.lm,
                                           self.dtype, self.device,
                                           self.ctc, self.tdt)
        if self.dsp_mode == "device" and "devdsp/mel_buf" not in z:
            raise ValueError("snapshot was saved by a host-DSP engine; "
                             "device-DSP resume needs the device mel "
                             "buffer/fill state")
        self.enc_state, self.dec_state = restore_states(
            z, self.cc, self.dtype, self.device)
        if self.mesh is not None:
            self.enc_state = mesh_mod.shard_state(
                self.enc_state, self.mesh, self._heads_split())
            self.dec_state = mesh_mod.shard_state(self.dec_state, self.mesh)
            if beam_state is not None:
                beam_state = mesh_mod.shard_stream_major(beam_state,
                                                         self.mesh)
        self.beam_state = beam_state
        self._beam_dirty = beam_state is not None
        if self.tdt:
            self.tdt_skip = npz.to_tensor(self._rows(z["tdt_skip"]),
                                          torch.int32, self.device)
        if self.ctc:
            self.ctc_prev = z["ctc_prev"].astype(np.int64)
        self.active = z["active"].astype(bool)
        self.phase_counter = int(z["phase_counter"])
        self.slot_phase = z["slot_phase"].astype(np.int64)
        self.frame_offsets = z["frame_offsets"].astype(np.int64)
        if self._ep_frames is not None and "ep/silence" in z:
            self.ep_silence = z["ep/silence"].astype(np.int64)
            self.ep_emitted = z["ep/emitted"].astype(bool)
            self.ep_utt_start = z["ep/utt_start"].astype(np.int64)
            self._ep_pending = [
                (int(s), int(e),
                 z[f"ep/pending_seg/{i}"].astype(np.int16)
                 if f"ep/pending_seg/{i}" in z else None)
                for i, (s, e) in enumerate(z["ep/pending"].reshape(-1, 2))]
        if self.keep_segment_audio:
            for s in range(self.n_slots):
                sb = _SegmentBuffer(self._seg_cap)
                if f"seg/pcm/{s}" in z:
                    pcm = z[f"seg/pcm/{s}"].astype(np.int16)
                    meta = z[f"seg/meta/{s}"]
                    if pcm.size:
                        sb.parts = [pcm]
                        sb.total = pcm.size
                    sb.abs0 = int(meta[0])
                    sb.truncated = bool(meta[1])
                self.seg_buffers[s] = sb
        self.transcripts = [str(t) for t in z["transcripts"]]
        self.tokens = [token_list(z[f"tokens/{s}"])
                       for s in range(self.n_slots)]
        self.mel_buffers = [
            _MelBuffer(np.asarray(z[f"mel_buffer/{s}"], np.float32).copy())
            for s in range(self.n_slots)]
        for s in range(self.n_slots):
            self._dsp_load_state(
                s, {"last_sample": z[f"preproc/last_sample/{s}"],
                    "residue": z[f"preproc/residue/{s}"]})
        if self.dsp_mode == "device":
            self.mel_buf_dev = npz.to_tensor(self._rows(z["devdsp/mel_buf"]),
                                             self.dtype, self.device)
            self.mel_fill = z["devdsp/mel_fill"].astype(np.int64)
            self.fresh = z["devdsp/fresh"].astype(bool)
            self.pcm_fifos = [_PcmBuffer() for _ in range(self.n_slots)]
            for s in range(self.n_slots):
                blk = z[f"devdsp/fifo/{s}"].astype(np.int16)
                if blk.size:
                    self.pcm_fifos[s].append(blk)

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
