"""Lockstep many-stream serving: every stream advances every tick, PCM to
tokens on the params' device.

The port's counterpart of `nemotron_tpu/streaming/lockstep.py` (RNN-T
greedy or beam, with or without LM fusion, the TDT walk or beam, the CTC
head; greedy and beam decode over a mesh). Where `ServingEngine`
(serving.py) lets slots advance at independent rates, `LockstepEngine`
feeds one PCM block to all S streams at once and runs the whole pipeline
on the device:

    i16 PCM [S, N]
      -> DSP (scale, pre-emphasis, frame, window, rFFT, mel, log)
      -> mel ring (9-frame overlap seed, chunk assembly)
      -> cache-aware streaming encoder
      -> greedy RNN-T or TDT decode (or a beam search, whose state stays
         on the device; or the CTC head's per-frame argmax)
      -> int32 tokens [k, S, valid_out, MAX] (CTC: ids [k, S, valid_out])

Host work a tick: upload S*N int16 samples, download the token tensor, one
vectorized detokenization. The JAX package compiles the tick into one
program; the port runs the same steps eagerly, in the same order.

The chunk cadence does not depend on the data: how many chunks a tick
consumes follows from sample counts, so the host tracks the mel ring's
fill (`buf_len`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (MAX_SYMBOLS_PER_STEP, CacheConfig, ModelConfig,
                      PreprocessorConfig)
from ..frontend.device_frontend import (FrontendState, frames_after,
                                        init_frontend_state,
                                        mel_frontend_step)
from ..frontend.preprocessor import pad_window
from ..models import beam as beam_mod
from ..models import ctc as ctc_mod
from ..models import decoder as dec_mod
from ..models import encoder as enc_mod
from ..models import tdt as tdt_mod
from ..models.lm import lm_to_device
from ..parallel import mesh as mesh_mod
from ..params import ModelParams, cast_params
from ..utils import npz
from ..utils.text import tokens_to_text
from .serving import _reset_decoder_slots, check_engine_snapshot
from .session import (_check_dtype, beam_leaves, best_transcripts,
                      check_decode_options, init_beam, restore_states,
                      token_list, token_rows)


def _dsp_encode(cfg: ModelConfig, cc: CacheConfig, pcfg: PreprocessorConfig,
                buf_len: int, params, pcm_i16, front: FrontendState,
                mel_buf, enc_state, pos_heads, window, filterbank):
    """A tick's front half (nemotron_tpu/streaming/lockstep.py:46-75): the
    DSP, the insert of the new mel frames at `buf_len` (cast to the compute
    dtype), then for each full chunk the encoder and the shift of the mel
    ring with zero fill. Returns (enc_outs, front, mel_buf, enc_state); the
    K/V rings and the mel ring are written in place."""
    mel, front = mel_frontend_step(pcm_i16, front, window, filterbank, pcfg)
    f = mel.shape[1]
    if f:
        mel_buf[:, buf_len:buf_len + f] = mel.to(mel_buf.dtype)
    chunk, shift = cc.chunk_mel_frames, cc.shift_mel_frames
    fill = buf_len + f
    enc_outs = []
    while fill >= chunk:
        enc_out, enc_state = enc_mod.encode_chunk(
            params, cfg, cc, mel_buf[:, :chunk], enc_state, pos_heads)
        enc_outs.append(enc_out)
        mel_buf = torch.cat([mel_buf[:, shift:],
                             torch.zeros_like(mel_buf[:, :shift])], dim=1)
        fill -= shift
    return enc_outs, front, mel_buf, enc_state


def _fused_tick(cfg: ModelConfig, cc: CacheConfig, pcfg: PreprocessorConfig,
                buf_len: int, confidence: bool, params, pcm_i16,
                front: FrontendState, mel_buf, enc_state, dec_state,
                pos_heads, window, filterbank):
    """One greedy tick (nemotron_tpu/streaming/lockstep.py:78-111):
    `_dsp_encode`, then the greedy decode of each chunk. Returns (tokens
    [k, S, valid_out, MAX] int32, confs of the same shape f32 or None,
    front, mel_buf, enc_state, dec_state); `tokens` is a fresh tensor that
    no later tick writes."""
    S = pcm_i16.shape[0]
    enc_outs, front, mel_buf, enc_state = _dsp_encode(
        cfg, cc, pcfg, buf_len, params, pcm_i16, front, mel_buf, enc_state,
        pos_heads, window, filterbank)
    tokens_out, confs_out = [], []
    for enc_out in enc_outs:
        out = dec_mod.greedy_decode(params, cfg, enc_out, dec_state,
                                    with_confidence=confidence)
        tokens_out.append(out[0])
        dec_state = out[1]
        if confidence:
            confs_out.append(out[2])
    tokens, confs = _stack_chunks(tokens_out, confs_out if confidence
                                  else None, (S, cc.valid_out_len,
                                              MAX_SYMBOLS_PER_STEP),
                                  mel_buf.device)
    return tokens, confs, front, mel_buf, enc_state, dec_state


def _fused_tick_beam(cfg: ModelConfig, cc: CacheConfig,
                     pcfg: PreprocessorConfig, buf_len: int, beam_size: int,
                     expansions: int, params, pcm_i16, front: FrontendState,
                     mel_buf, enc_state, beam_state, pos_heads, window,
                     filterbank, lm=None, lm_weight: float = 0.3,
                     lm_bonus: float = 0.0):
    """One beam tick (nemotron_tpu/streaming/lockstep.py:116-137):
    `_dsp_encode`, then the batched beam search over each chunk. No token
    tensor leaves the device; returns (front, mel_buf, enc_state,
    beam_state)."""
    enc_outs, front, mel_buf, enc_state = _dsp_encode(
        cfg, cc, pcfg, buf_len, params, pcm_i16, front, mel_buf, enc_state,
        pos_heads, window, filterbank)
    for enc_out in enc_outs:
        beam_state = beam_mod.beam_decode(params, cfg, enc_out, beam_state,
                                          beam_size, expansions, lm=lm,
                                          lm_weight=lm_weight,
                                          lm_bonus=lm_bonus)
    return front, mel_buf, enc_state, beam_state


def _fused_tick_tdt(cfg: ModelConfig, cc: CacheConfig,
                    pcfg: PreprocessorConfig, buf_len: int, confidence: bool,
                    params, pcm_i16, front: FrontendState, mel_buf,
                    enc_state, dec_state, pos_heads, window, filterbank,
                    skip):
    """One TDT tick (nemotron_tpu/streaming/lockstep.py:142-180):
    `_dsp_encode`, then the duration-aware greedy walk over each chunk,
    threading the jump carry `skip` [S] through the tick's chunks. Returns
    (tokens [k, S, valid_out, MAX], confs or None, front, mel_buf,
    enc_state, dec_state, skip)."""
    S = pcm_i16.shape[0]
    enc_outs, front, mel_buf, enc_state = _dsp_encode(
        cfg, cc, pcfg, buf_len, params, pcm_i16, front, mel_buf, enc_state,
        pos_heads, window, filterbank)
    tokens_out, confs_out = [], []
    for enc_out in enc_outs:
        out = tdt_mod.tdt_greedy_decode(params, cfg, enc_out, dec_state,
                                        skip_in=skip,
                                        with_confidence=confidence)
        tokens_out.append(out[0])
        if confidence:
            confs_out.append(out[1])
        dec_state, skip = out[-2:]
    tokens, confs = _stack_chunks(tokens_out, confs_out if confidence
                                  else None, (S, cc.valid_out_len,
                                              MAX_SYMBOLS_PER_STEP),
                                  mel_buf.device)
    return tokens, confs, front, mel_buf, enc_state, dec_state, skip


def _fused_tick_tdt_beam(cfg: ModelConfig, cc: CacheConfig,
                         pcfg: PreprocessorConfig, buf_len: int,
                         beam_size: int, params, pcm_i16,
                         front: FrontendState, mel_buf, enc_state,
                         beam_state, pos_heads, window, filterbank, lm=None,
                         lm_weight: float = 0.3, lm_bonus: float = 0.0):
    """One TDT beam tick (nemotron_tpu/streaming/lockstep.py:183-204):
    `_dsp_encode`, then the duration-aware beam search over each chunk; the
    TdtBeamState carries each hypothesis's overshoot between chunks.
    Returns (front, mel_buf, enc_state, beam_state)."""
    enc_outs, front, mel_buf, enc_state = _dsp_encode(
        cfg, cc, pcfg, buf_len, params, pcm_i16, front, mel_buf, enc_state,
        pos_heads, window, filterbank)
    for enc_out in enc_outs:
        beam_state = tdt_mod.tdt_beam_decode(params, cfg, enc_out,
                                             beam_state, beam_size, lm=lm,
                                             lm_weight=lm_weight,
                                             lm_bonus=lm_bonus)
    return front, mel_buf, enc_state, beam_state


def _fused_tick_ctc(cfg: ModelConfig, cc: CacheConfig,
                    pcfg: PreprocessorConfig, buf_len: int, confidence: bool,
                    params, pcm_i16, front: FrontendState, mel_buf,
                    enc_state, pos_heads, window, filterbank):
    """One CTC tick (nemotron_tpu/streaming/lockstep.py:207-238):
    `_dsp_encode`, then the CTC head's per-frame argmax of each chunk (the
    collapse carry lives on the host). Returns (ids [k, S, valid_out]
    int32, the argmaxes' log-posteriors or None, front, mel_buf,
    enc_state)."""
    S = pcm_i16.shape[0]
    enc_outs, front, mel_buf, enc_state = _dsp_encode(
        cfg, cc, pcfg, buf_len, params, pcm_i16, front, mel_buf, enc_state,
        pos_heads, window, filterbank)
    ids_out, lp_out = [], []
    for enc_out in enc_outs:
        if confidence:
            ids, lp = ctc_mod.frame_log_posteriors(params, enc_out)
            lp_out.append(lp)
        else:
            ids = ctc_mod.frame_ids(params, enc_out)
        ids_out.append(ids)
    ids, logp = _stack_chunks(ids_out, lp_out if confidence else None,
                              (S, cc.valid_out_len), mel_buf.device)
    return ids, logp, front, mel_buf, enc_state


def _stack_chunks(firsts: list, seconds: list | None, shape: tuple, device):
    """A tick's per-chunk outputs stacked along a leading chunk axis
    ([0, *shape] int32 when the tick decoded no chunk), and the f32
    companions (confidences) likewise, or None."""
    if firsts:
        first = torch.stack(firsts)
    else:
        first = torch.zeros((0,) + shape, dtype=torch.int32, device=device)
    if seconds is None:
        return first, None
    return first, (torch.stack(seconds) if seconds
                   else torch.zeros(first.shape, dtype=torch.float32,
                                    device=device))


class LockstepEngine:
    """S streams at one shared cadence on the params' device, in
    `compute_dtype` (float32 or bfloat16), RNN-T greedy or beam, TDT greedy
    or beam (each stream carries its jump overshoot, `tdt_skip`), or the
    CTC head with ctc=True (the collapse carry `ctc_prev` on the host).

    Lifecycle as StreamSession's (reset / tick / finalize / transcripts),
    but `tick` takes one PCM block for ALL streams. Typical use: feed
    `cc.shift_samples` of audio a stream a tick (real time).

    confidence: tokens become (id, frame, log_posterior) triples.
    endpoint_silence_s / endpoint_reset: utterance endpointing as in
    ServingEngine (`poll_endpoints`).

    beam_size > 1 runs the batched beam search every tick (with LM shallow
    fusion when `lm` is given). Beam transcripts are revisable: `tick`
    returns {} and `refresh_transcripts` / `finalize` read the current
    best hypotheses (their tokens carry frame 0). Endpointing and
    confidence need greedy decode.

    mesh (parallel.mesh.Mesh): as ServingEngine's (JAX lockstep.py:346-400)
    -- every rank builds the engine alike, is given the same ticks and
    keeps the whole host state; the data axis splits the stream rows of
    the device state, the model axis the encoder's FFNs and heads; tokens
    are gathered over the data axis a tick. A beam engine holds its rows of
    the beam state (parallel.mesh.shard_stream_major, as JAX's
    lockstep.py:381-390); the best hypotheses are gathered when the
    transcripts are refreshed, the whole beam state when a snapshot is
    saved.

    Subclasses that feed only some rows from the host (the multi-process
    engine, parallel/multihost.py) preset `n_local` and `_local_rows`
    before this __init__ and override the host <-> device seams
    (`_put_pcm`, `_fetch_block`, `_unsnap_rows`, `_shard_loaded_state`)."""

    def __init__(self, params: ModelParams, cfg: ModelConfig,
                 vocab: list[str] | None = None,
                 cache_config: CacheConfig | None = None,
                 n_streams: int = 256,
                 compute_dtype: torch.dtype = torch.bfloat16, mesh=None,
                 beam_size: int = 1, beam_expansions: int | None = None,
                 max_beam_tokens: int = 4096, confidence: bool = False,
                 endpoint_silence_s: float | None = None,
                 endpoint_reset: bool = False, ctc: bool = False, lm=None,
                 lm_weight: float = 0.3, lm_bonus: float = 0.0):
        if confidence and beam_size > 1:
            raise ValueError("confidence requires greedy decode")
        if lm is not None and beam_size <= 1:
            raise ValueError("LM shallow fusion requires beam_size > 1")
        self.ctc, self.tdt = check_decode_options(params, cfg, ctc,
                                                  beam_size, endpoint_reset)
        if endpoint_silence_s is not None and beam_size > 1:
            raise ValueError("endpointing requires greedy decode")
        _check_dtype(compute_dtype)
        self.cfg = cfg
        self.cc = cache_config or CacheConfig(n_mels=cfg.n_mels)
        self.pcfg = PreprocessorConfig(n_mels=cfg.n_mels)
        self.vocab = vocab or []
        self.n_streams = n_streams
        # the host interface's rows (nemotron_tpu/streaming/lockstep.py:
        # 275-281): multi-process subclasses preset n_local/_local_rows
        # BEFORE this __init__, their hosts feeding and reading only their
        # own rows; otherwise local == global
        if not hasattr(self, "n_local"):
            self.n_local = n_streams
            self._local_rows = None
        # the device rows [lo, hi) this rank holds (all of them off a mesh)
        self.mesh = mesh
        self._lo, self._hi = (0, n_streams) if mesh is None else \
            mesh.row_span(n_streams)
        if mesh is not None:
            params = mesh_mod.shard_params(params, mesh)
        self.dtype = compute_dtype
        self.device = params.device
        self.confidence = bool(confidence)
        self.beam_size = beam_size
        self.beam_expansions = (beam_expansions if beam_expansions is not None
                                else MAX_SYMBOLS_PER_STEP)
        self.max_beam_tokens = max_beam_tokens
        self.lm = None if lm is None else lm_to_device(lm, self.device)
        self.lm_weight = float(lm_weight)
        self.lm_bonus = float(lm_bonus)
        # utterance endpointing, as ServingEngine's; in pipelined mode the
        # decoder reset lands one tick late (tokens are collected a tick
        # behind the dispatched state), harmless unless the next utterance
        # begins within that tick
        self._ep_frames = None
        self._ep_reset = bool(endpoint_reset)
        if endpoint_silence_s is not None:
            frame_s = (self.cc.subsampling_factor * self.cc.hop_length
                       / self.cc.sample_rate)
            self._ep_frames = max(1, round(endpoint_silence_s / frame_s))

        # a leaf already in the compute dtype is the same tensor after the
        # cast, so engines built from this one's params share its weights
        self.params = cast_params(params, compute_dtype)
        self.pos_heads = enc_mod.precompute_pos_heads(
            self.params, cfg, self.cc, compute_dtype)
        self.window = torch.from_numpy(pad_window(
            params.preprocessor.window.float().cpu().numpy(),
            self.pcfg.n_fft)).to(self.device)
        self.filterbank = params.preprocessor.filterbank.to(torch.float32)
        self.reset()

    def reset(self) -> None:
        cfg, cc, dev = self.cfg, self.cc, self.device
        S = self._hi - self._lo                 # this rank's device rows
        self.enc_state = enc_mod.init_encoder_state(
            cfg, cc, S, self.dtype, dev,
            n_heads=enc_mod.local_heads(self.params, cfg))
        self.dec_state = dec_mod.init_decoder_state(cfg, S, self.dtype, dev)
        self.beam_state = None
        if self.beam_size > 1:
            self.beam_state = init_beam(cfg, self.tdt, S, self.beam_size,
                                        self.max_beam_tokens, self.dtype,
                                        dev, lm=self.lm)
        # the TDT jump carry (device) and the CTC collapse carry (host)
        self.tdt_skip = (torch.zeros((S,), dtype=torch.int32, device=dev)
                         if self.tdt else None)
        n = self.n_local                        # the host's rows
        self.ctc_prev = np.full(n, -1, np.int64) if self.ctc else None
        # transcripts are rebuilt from the beam lazily, once a tick has
        # advanced it
        self._beam_dirty = False
        self.front = init_frontend_state(S, dev, self.pcfg)
        # 9-frame zero-seeded overlap (reference src/nemo-stream.cpp:58-60);
        # room for one chunk plus a shift and one frame of a ragged tick
        cap = cc.chunk_mel_frames + cc.shift_mel_frames + 1
        self.mel_buf = torch.zeros((S, cap, cfg.n_mels), dtype=self.dtype,
                                   device=dev)
        self.buf_len = cc.pre_encode_cache_size
        self.tokens: list[list[tuple]] = [[] for _ in range(n)]
        self.transcripts = [""] * n
        self.frame_offset = 0
        self.total_chunks = 0
        self.ep_silence = np.zeros(n, np.int64)
        self.ep_emitted = np.zeros(n, bool)
        self.ep_utt_start = np.zeros(n, np.int64)
        # (stream, end_idx) with end_idx taken at fire time, so that later
        # emissions never leak into the finished utterance's event
        self._ep_pending: list[tuple[int, int]] = []
        self.utterances_retired = 0
        self._pending = None
        # canonical tick size (samples), fixed by the first tick
        self._tick_samples: int | None = None

    # -- host <-> device boundary (parallel/multihost.py overrides these) ----

    def _dev_rows(self, a: np.ndarray, axis: int = 0) -> np.ndarray:
        """The device rows of a host array over the host's rows."""
        if self.mesh is None:
            return a
        return np.take(a, np.arange(self._lo, self._hi), axis=axis)

    def _put_pcm(self, pcm_i16: np.ndarray) -> torch.Tensor:
        """Host PCM block [n_local, N] -> int16 tensor of this rank's rows
        on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(
            self._dev_rows(pcm_i16), np.int16)).to(self.device)

    def _fetch_block(self, x: torch.Tensor, stream_axis: int) -> np.ndarray:
        """A device tensor of this rank's rows -> numpy over the host's
        rows along `stream_axis` (gathered over the data axis under a mesh;
        a copy, bf16 upcast to f32)."""
        if self.mesh is not None:
            x = mesh_mod.gather_rows(x, self.mesh, stream_axis)
        return npz.to_numpy(x)

    def _unsnap_rows(self, a, dtype, stream_axis: int) -> torch.Tensor:
        """Inverse of `_fetch_block` for snapshot restore: a snapshot leaf
        over the host's rows -> a fresh tensor of them on the device (all
        of them; `_shard_loaded_state` takes this rank's share)."""
        return npz.to_tensor(a, dtype, self.device)

    def _heads_split(self) -> bool:
        """Whether the K/V rings hold a rank's share of the heads."""
        return mesh_mod.rings_split(self.params, self.cc)

    def _shard_loaded_state(self) -> None:
        """After a load: this rank's rows and heads of the restored device
        state (a no-op off a mesh)."""
        if self.mesh is None:
            return
        m = self.mesh
        self.enc_state = mesh_mod.shard_state(self.enc_state, m,
                                              self._heads_split())
        self.dec_state = mesh_mod.shard_state(self.dec_state, m)
        self.front = mesh_mod.shard_state(self.front, m)
        if self.beam_state is not None:
            self.beam_state = mesh_mod.shard_stream_major(self.beam_state, m)
        lo, hi = self._lo, self._hi
        self.mel_buf = self.mel_buf[lo:hi].clone()
        if self.tdt_skip is not None:
            self.tdt_skip = self.tdt_skip[lo:hi].clone()

    def _whole_heads(self, x: torch.Tensor) -> torch.Tensor:
        """A ring leaf with every head (gathered over the model axis where
        the rings hold a rank's share)."""
        if not self._heads_split():
            return x
        return mesh_mod.gather_along(x, 2, self.mesh.model_group,
                                     self.mesh.model, self.mesh.model_index)

    def _writes_snapshot(self) -> bool:
        """Whether this rank writes the snapshot file (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    # -- the tick ------------------------------------------------------------

    def _chunks_in(self, fill: int) -> int:
        k = 0
        while fill >= self.cc.chunk_mel_frames:
            fill -= self.cc.shift_mel_frames
            k += 1
        return k

    def _issue(self, pcm_i16: np.ndarray):
        """Run one tick on the device; returns (result, frame offset base)
        for `_collect`: result is (tokens, confs or None) for greedy RNN-T
        and TDT, (ids, log-posteriors or None) for CTC, None for a
        beam."""
        assert pcm_i16.shape[0] == self.n_local
        cap = self.mel_buf.shape[1]
        f = frames_after(self.front.residue.shape[1], pcm_i16.shape[1],
                         self.pcfg)
        assert self.buf_len + f <= cap, (
            f"tick of {pcm_i16.shape[1]} samples would overflow the mel ring"
            f" ({self.buf_len}+{f} > {cap}); feed at most ~shift_samples"
            " per tick")
        common = (self.cfg, self.cc, self.pcfg, self.buf_len)
        pcm = self._put_pcm(pcm_i16)
        tail = (self.pos_heads, self.window, self.filterbank)
        result = None
        if self.beam_state is not None:
            lm = (self.lm, self.lm_weight, self.lm_bonus)
            if self.tdt:
                (self.front, self.mel_buf, self.enc_state,
                 self.beam_state) = _fused_tick_tdt_beam(
                    *common, self.beam_size, self.params, pcm, self.front,
                    self.mel_buf, self.enc_state, self.beam_state, *tail,
                    *lm)
            else:
                (self.front, self.mel_buf, self.enc_state,
                 self.beam_state) = _fused_tick_beam(
                    *common, self.beam_size, self.beam_expansions,
                    self.params, pcm, self.front, self.mel_buf,
                    self.enc_state, self.beam_state, *tail, *lm)
            self._beam_dirty = True
        elif self.ctc:
            (ids, logp, self.front, self.mel_buf,
             self.enc_state) = _fused_tick_ctc(
                *common, self.confidence, self.params, pcm, self.front,
                self.mel_buf, self.enc_state, *tail)
            result = (ids, logp)
        elif self.tdt:
            (tokens, confs, self.front, self.mel_buf, self.enc_state,
             self.dec_state, self.tdt_skip) = _fused_tick_tdt(
                *common, self.confidence, self.params, pcm, self.front,
                self.mel_buf, self.enc_state, self.dec_state, *tail,
                self.tdt_skip)
            result = (tokens, confs)
        else:
            (tokens, confs, self.front, self.mel_buf, self.enc_state,
             self.dec_state) = _fused_tick(
                *common, self.confidence, self.params, pcm, self.front,
                self.mel_buf, self.enc_state, self.dec_state, *tail)
            result = (tokens, confs)
        k = self._chunks_in(self.buf_len + f)
        self.buf_len = self.buf_len + f - k * self.cc.shift_mel_frames
        self.total_chunks += k
        base = self.frame_offset
        self.frame_offset += k * self.cc.valid_out_len
        return result, base

    def _collect(self, result, base: int) -> dict[int, str]:
        """Bring a tick's tokens (or CTC ids) to the host and fold them into
        the transcripts; returns the new text per stream (nothing in beam
        mode: its transcripts are rebuilt by refresh_transcripts)."""
        out: dict[int, str] = {}
        if result is None:
            return out
        first = self._fetch_block(result[0], 1)
        second = (None if result[1] is None
                  else self._fetch_block(result[1], 1))
        V = self.cc.valid_out_len
        for i in range(first.shape[0]):
            if self.ctc:
                emitted = ctc_mod.collapse_chunk(
                    first[i].astype(np.int64), self.ctc_prev,
                    range(self.n_local), self.cfg.blank_token,
                    base + i * V, None if second is None else second[i])
            else:
                emitted = dec_mod.extract_emitted(
                    first[i], self.cfg.blank_token,
                    np.full(self.n_local, base + i * V, np.int64),
                    confs=None if second is None else second[i])
            for s, toks in emitted.items():
                self.tokens[s].extend(toks)
                text = tokens_to_text(toks, self.vocab)
                self.transcripts[s] += text
                out[s] = out.get(s, "") + text
            if self._ep_frames is not None:
                self._ep_update(emitted, base + (i + 1) * V)
        return out

    def _ep_update(self, emitted: dict, current_offset: int) -> None:
        """One processed chunk (every stream advanced valid_out_len frames):
        ServingEngine._ep_update's silence accounting with one shared frame
        offset; the fired streams get a fresh prediction network with
        endpoint_reset."""
        self.ep_silence += self.cc.valid_out_len
        for s, toks in emitted.items():
            self.ep_silence[s] = max(0, current_offset - (toks[-1][1] + 1))
            self.ep_emitted[s] = True
        fired = np.flatnonzero(self.ep_emitted
                               & (self.ep_silence >= self._ep_frames))
        if fired.size == 0:
            return
        self._ep_pending.extend((int(s), len(self.tokens[int(s)]))
                                for s in fired)
        self.ep_emitted[fired] = False
        self.ep_silence[fired] = 0
        if self._ep_reset:
            mask = np.zeros(self.n_local, bool)
            mask[fired] = True
            self.dec_state = _reset_decoder_slots(
                self.dec_state,
                torch.from_numpy(self._dev_rows(mask)).to(self.device),
                self.cfg.blank_token)

    def poll_endpoints(self) -> list[tuple[int, str, list]]:
        """Drain the utterance-endpoint events: one (stream, text, tokens)
        per utterance that ended since the last poll (ServingEngine's
        contract)."""
        out = []
        for s, end in self._ep_pending:
            start = int(self.ep_utt_start[s])
            toks = self.tokens[s][start:end]
            out.append((s, tokens_to_text(toks, self.vocab), toks))
            self.ep_utt_start[s] = end
            self.utterances_retired += 1
        self._ep_pending = []
        return out

    def tick(self, pcm_i16: np.ndarray) -> dict[int, str]:
        """Advance every stream by pcm_i16 [S, N] samples; returns the new
        text per stream.

        The first tick's N is the canonical tick size. A later block larger
        than it is split into canonical sub-ticks plus an exact remainder
        (so it never overflows the mel ring), and a shorter one (the tail
        of a recording before finalize) runs at its exact size; both are
        sample-exact."""
        n = pcm_i16.shape[1]
        if self._tick_samples is None:
            self._tick_samples = n
        T = self._tick_samples
        if n <= T:
            return self._collect(*self._issue(pcm_i16))
        out: dict[int, str] = {}
        for ofs in range(0, n, T):
            for s, text in self._collect(
                    *self._issue(pcm_i16[:, ofs:ofs + T])).items():
                out[s] = out.get(s, "") + text
        return out

    def tick_pipelined(self, pcm_i16: np.ndarray) -> dict[int, str]:
        """Depth-1 pipelined tick: runs this tick and returns the PREVIOUS
        tick's text (one tick of text latency; the same dicts as `tick`,
        one call later). Call flush_pipeline() (or finalize()) to drain
        the last tick. The port's greedy loop syncs once an iteration, so
        little of the host work overlaps the device yet."""
        prev = self._pending
        self._pending = self._issue(pcm_i16)
        return self._collect(*prev) if prev is not None else {}

    def flush_pipeline(self) -> dict[int, str]:
        if self._pending is None:
            return {}
        prev, self._pending = self._pending, None
        return self._collect(*prev)

    def refresh_transcripts(self) -> list[str]:
        """Beam mode: rewrite every stream's transcript and tokens from its
        current best hypothesis (nemotron_tpu/streaming/lockstep.py:
        646-664), one device call and one [S, U] download, only when a
        tick advanced the beam since the last refresh. Greedy transcripts
        are already incremental: a no-op."""
        if self.beam_state is not None and self._beam_dirty:
            for s, (toks, text) in best_transcripts(
                    self.beam_state, self.vocab,
                    range(self.n_streams), self.mesh).items():
                self.tokens[s] = toks
                self.transcripts[s] = text
            self._beam_dirty = False
        return list(self.transcripts)

    # -- checkpoint / resume --------------------------------------------------

    def save(self, path: str) -> None:
        """Snapshot the device state, the tokens and the transcripts as an
        .npz with the JAX package's keys
        (nemotron_tpu/streaming/lockstep.py:677-733): a fresh engine of the
        same streams resumes exactly. The mel ring is written as f32; a beam
        engine adds its beam/* leaves, a TDT engine its tdt_skip, a CTC
        engine its ctc_prev."""
        self.flush_pipeline()
        self.refresh_transcripts()
        fetch = self._fetch_block
        heads = ("k_cache", "v_cache", "k_scale", "v_scale")
        flat = {f"enc/{k}": fetch(
            self._whole_heads(getattr(self.enc_state, k)) if k in heads
            else getattr(self.enc_state, k),
            0 if k in ("valid_len", "phase") else 1)
            for k in ("k_cache", "v_cache", "k_scale", "v_scale",
                      "conv_cache", "valid_len", "phase")}
        flat |= {f"dec/{k}": fetch(getattr(self.dec_state, k), 0)
                 for k in ("h", "c", "prev_token")}
        flat |= {
            "front/last_sample": fetch(self.front.last_sample, 0),
            "front/residue": fetch(self.front.residue, 0),
            "mel_buf": fetch(self.mel_buf, 0).astype(np.float32),
            "buf_len": np.int64(self.buf_len),
            "frame_offset": np.int64(self.frame_offset),
            "total_chunks": np.int64(self.total_chunks),
            "transcripts": np.asarray(self.transcripts, dtype=object),
        }
        if self.beam_state is not None:
            flat |= beam_leaves(self.beam_state, self.mesh)
        if self.tdt_skip is not None:
            flat["tdt_skip"] = fetch(self.tdt_skip, 0)
        if self.ctc_prev is not None:
            flat["ctc_prev"] = self.ctc_prev
        if self._ep_frames is not None:
            flat["ep/silence"] = self.ep_silence
            flat["ep/emitted"] = self.ep_emitted
            flat["ep/utt_start"] = self.ep_utt_start
            flat["ep/pending"] = np.asarray(self._ep_pending,
                                            np.int64).reshape(-1, 2)
        for s in range(self.n_local):
            flat[f"tokens/{s}"] = token_rows(self.tokens[s], self.confidence)
        if self._writes_snapshot():
            npz.savez(path, flat)
        if self.mesh is not None:
            torch.distributed.barrier()

    def load(self, path: str) -> None:
        """Restore a snapshot written by `save` (or by the JAX engine):
        fresh tensors on the engine's device in its dtypes. The stream
        count must match; a snapshot of another decode mode (TDT, CTC,
        greedy against beam, width, LM fusion, beam family) raises
        ValueError."""
        z = npz.NpzView(np.load(path, allow_pickle=True))
        if len(z["dec/prev_token"]) != self.n_local:
            raise ValueError(
                f"snapshot holds {len(z['dec/prev_token'])} stream rows, "
                f"engine owns {self.n_local}")
        beam_state = check_engine_snapshot(z, self.beam_size, self.lm,
                                           self.dtype, self.device,
                                           self.ctc, self.tdt)
        un = self._unsnap_rows
        self.enc_state, self.dec_state = restore_states(
            z, self.cc, self.dtype, self.device, put=un)
        self.beam_state = beam_state
        self._beam_dirty = beam_state is not None
        if self.tdt:
            self.tdt_skip = un(z["tdt_skip"], torch.int32, 0)
        if self.ctc:
            self.ctc_prev = z["ctc_prev"].astype(np.int64)
        f32 = torch.float32
        self.front = FrontendState(
            last_sample=un(z["front/last_sample"], f32, 0),
            residue=un(z["front/residue"], f32, 0))
        self.mel_buf = un(z["mel_buf"], self.dtype, 0)
        self.buf_len = int(z["buf_len"])
        self.frame_offset = int(z["frame_offset"])
        self.total_chunks = int(z["total_chunks"])
        if self._ep_frames is not None and "ep/silence" in z:
            self.ep_silence = z["ep/silence"].astype(np.int64)
            self.ep_emitted = z["ep/emitted"].astype(bool)
            self.ep_utt_start = z["ep/utt_start"].astype(np.int64)
            self._ep_pending = [(int(s), int(e))
                                for s, e in z["ep/pending"].reshape(-1, 2)]
        self.transcripts = [str(t) for t in z["transcripts"]]
        self.tokens = [token_list(z[f"tokens/{s}"])
                       for s in range(self.n_local)]
        self._pending = None
        self._shard_loaded_state()

    def finalize(self) -> list[str]:
        """Flush the pending (non-overlap) mel frames with one zero-padded
        chunk, as the session's finalize does; the pad runs at its exact
        size through the ragged tick. Returns the transcripts."""
        self.flush_pipeline()
        pending = self.buf_len - self.cc.pre_encode_cache_size
        if pending > 0:
            need = (self.cc.chunk_mel_frames - self.buf_len) * \
                self.pcfg.n_window_stride
            self.tick(np.zeros((self.n_local,
                                max(need, 0) + self.pcfg.n_fft), np.int16))
        return self.refresh_transcripts()
