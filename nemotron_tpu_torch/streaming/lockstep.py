"""Lockstep many-stream serving: every stream advances every tick, PCM to
tokens on the params' device.

The port's counterpart of `nemotron_tpu/streaming/lockstep.py` (greedy
RNN-T; no beam, CTC, TDT or LM tick, no mesh). Where `ServingEngine`
(serving.py) lets slots advance at independent rates, `LockstepEngine`
feeds one PCM block to all S streams at once and runs the whole pipeline
on the device:

    i16 PCM [S, N]
      -> DSP (scale, pre-emphasis, frame, window, rFFT, mel, log)
      -> mel ring (9-frame overlap seed, chunk assembly)
      -> cache-aware streaming encoder
      -> greedy RNN-T decode
      -> int32 tokens [k, S, valid_out, MAX]

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
from ..models import decoder as dec_mod
from ..models import encoder as enc_mod
from ..params import ModelParams, cast_params
from ..utils import npz
from ..utils.text import tokens_to_text
from .serving import _reset_decoder_slots
from .session import _check_dtype, restore_states, token_list, token_rows


def _fused_tick(cfg: ModelConfig, cc: CacheConfig, pcfg: PreprocessorConfig,
                buf_len: int, confidence: bool, params, pcm_i16,
                front: FrontendState, mel_buf, enc_state, dec_state,
                pos_heads, window, filterbank):
    """One greedy tick (nemotron_tpu/streaming/lockstep.py:46-111): the
    DSP, the insert of the new mel frames at `buf_len` (cast to the compute
    dtype), then for each full chunk the encoder, the greedy decode and the
    shift of the mel ring with zero fill. Returns (tokens [k, S, valid_out,
    MAX] int32, confs of the same shape f32 or None, front, mel_buf,
    enc_state, dec_state). The K/V rings and the mel ring are written in
    place; `tokens` is a fresh tensor that no later tick writes."""
    S = pcm_i16.shape[0]
    mel, front = mel_frontend_step(pcm_i16, front, window, filterbank, pcfg)
    f = mel.shape[1]
    if f:
        mel_buf[:, buf_len:buf_len + f] = mel.to(mel_buf.dtype)
    chunk, shift = cc.chunk_mel_frames, cc.shift_mel_frames
    fill = buf_len + f
    tokens_out, confs_out = [], []
    while fill >= chunk:
        enc_out, enc_state = enc_mod.encode_chunk(
            params, cfg, cc, mel_buf[:, :chunk], enc_state, pos_heads)
        out = dec_mod.greedy_decode(params, cfg, enc_out, dec_state,
                                    with_confidence=confidence)
        tokens_out.append(out[0])
        dec_state = out[1]
        if confidence:
            confs_out.append(out[2])
        mel_buf = torch.cat([mel_buf[:, shift:],
                             torch.zeros_like(mel_buf[:, :shift])], dim=1)
        fill -= shift
    if tokens_out:
        tokens = torch.stack(tokens_out)
    else:
        tokens = torch.zeros((0, S, cc.valid_out_len, MAX_SYMBOLS_PER_STEP),
                             dtype=torch.int32, device=mel_buf.device)
    confs = None
    if confidence:
        confs = (torch.stack(confs_out) if confs_out
                 else torch.zeros(tokens.shape, dtype=torch.float32,
                                  device=mel_buf.device))
    return tokens, confs, front, mel_buf, enc_state, dec_state


class LockstepEngine:
    """S streams at one shared cadence on the params' device, in
    `compute_dtype` (float32 or bfloat16), greedy RNN-T.

    Lifecycle as StreamSession's (reset / tick / finalize / transcripts),
    but `tick` takes one PCM block for ALL streams. Typical use: feed
    `cc.shift_samples` of audio a stream a tick (real time).

    confidence: tokens become (id, frame, log_posterior) triples.
    endpoint_silence_s / endpoint_reset: utterance endpointing as in
    ServingEngine (`poll_endpoints`).

    Beam search, CTC, TDT checkpoints and LM fusion (the decode-variants
    slice) and a device mesh (the multi-GPU slice) come with later slices
    of the port and raise NotImplementedError."""

    def __init__(self, params: ModelParams, cfg: ModelConfig,
                 vocab: list[str] | None = None,
                 cache_config: CacheConfig | None = None,
                 n_streams: int = 256,
                 compute_dtype: torch.dtype = torch.bfloat16, mesh=None,
                 beam_size: int = 1, confidence: bool = False,
                 endpoint_silence_s: float | None = None,
                 endpoint_reset: bool = False, ctc: bool = False, lm=None):
        if beam_size > 1 or lm is not None:
            raise NotImplementedError("beam search and LM fusion come with "
                                      "the decode-variants slice of the port")
        if ctc:
            raise NotImplementedError("CTC decode comes with the decode-"
                                      "variants slice of the port")
        if cfg.tdt_durations:
            raise NotImplementedError("TDT decode comes with the decode-"
                                      "variants slice of the port")
        if mesh is not None:
            raise NotImplementedError("a device mesh comes with the "
                                      "multi-GPU slice of the port")
        _check_dtype(compute_dtype)
        self.cfg = cfg
        self.cc = cache_config or CacheConfig(n_mels=cfg.n_mels)
        self.pcfg = PreprocessorConfig(n_mels=cfg.n_mels)
        self.vocab = vocab or []
        self.n_streams = n_streams
        self.dtype = compute_dtype
        self.device = params.device
        self.confidence = bool(confidence)
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
        cfg, cc, S, dev = self.cfg, self.cc, self.n_streams, self.device
        self.enc_state = enc_mod.init_encoder_state(cfg, cc, S, self.dtype,
                                                    dev)
        self.dec_state = dec_mod.init_decoder_state(cfg, S, self.dtype, dev)
        self.front = init_frontend_state(S, dev, self.pcfg)
        # 9-frame zero-seeded overlap (reference src/nemo-stream.cpp:58-60);
        # room for one chunk plus a shift and one frame of a ragged tick
        cap = cc.chunk_mel_frames + cc.shift_mel_frames + 1
        self.mel_buf = torch.zeros((S, cap, cfg.n_mels), dtype=self.dtype,
                                   device=dev)
        self.buf_len = cc.pre_encode_cache_size
        self.tokens: list[list[tuple]] = [[] for _ in range(S)]
        self.transcripts = [""] * S
        self.frame_offset = 0
        self.total_chunks = 0
        self.ep_silence = np.zeros(S, np.int64)
        self.ep_emitted = np.zeros(S, bool)
        self.ep_utt_start = np.zeros(S, np.int64)
        # (stream, end_idx) with end_idx taken at fire time, so that later
        # emissions never leak into the finished utterance's event
        self._ep_pending: list[tuple[int, int]] = []
        self.utterances_retired = 0
        self._pending = None
        # canonical tick size (samples), fixed by the first tick
        self._tick_samples: int | None = None

    # -- host <-> device boundary (the multi-GPU slice overrides these) ------

    def _put_pcm(self, pcm_i16: np.ndarray) -> torch.Tensor:
        """Host PCM block [S, N] -> int16 tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(pcm_i16, np.int16)).to(
            self.device)

    def _fetch_block(self, x: torch.Tensor, stream_axis: int) -> np.ndarray:
        """A device tensor -> numpy rows along `stream_axis` (all of them on
        one device; a copy, bf16 upcast to f32)."""
        return npz.to_numpy(x)

    # -- the tick ------------------------------------------------------------

    def _chunks_in(self, fill: int) -> int:
        k = 0
        while fill >= self.cc.chunk_mel_frames:
            fill -= self.cc.shift_mel_frames
            k += 1
        return k

    def _issue(self, pcm_i16: np.ndarray):
        """Run one tick on the device; returns (tokens, confs, frame offset
        base) for `_collect`."""
        assert pcm_i16.shape[0] == self.n_streams
        cap = self.mel_buf.shape[1]
        f = frames_after(self.front.residue.shape[1], pcm_i16.shape[1],
                         self.pcfg)
        assert self.buf_len + f <= cap, (
            f"tick of {pcm_i16.shape[1]} samples would overflow the mel ring"
            f" ({self.buf_len}+{f} > {cap}); feed at most ~shift_samples"
            " per tick")
        (tokens, confs, self.front, self.mel_buf, self.enc_state,
         self.dec_state) = _fused_tick(
            self.cfg, self.cc, self.pcfg, self.buf_len, self.confidence,
            self.params, self._put_pcm(pcm_i16), self.front, self.mel_buf,
            self.enc_state, self.dec_state, self.pos_heads, self.window,
            self.filterbank)
        k = self._chunks_in(self.buf_len + f)
        self.buf_len = self.buf_len + f - k * self.cc.shift_mel_frames
        self.total_chunks += k
        base = self.frame_offset
        self.frame_offset += k * self.cc.valid_out_len
        return tokens, confs, base

    def _collect(self, tokens, confs, base: int) -> dict[int, str]:
        """Bring a tick's tokens to the host and fold them into the
        transcripts; returns the new text per stream."""
        out: dict[int, str] = {}
        tokens = self._fetch_block(tokens, 1)
        if confs is not None:
            confs = self._fetch_block(confs, 1)
        V = self.cc.valid_out_len
        for i in range(tokens.shape[0]):
            emitted = dec_mod.extract_emitted(
                tokens[i], self.cfg.blank_token,
                np.full(self.n_streams, base + i * V, np.int64),
                confs=confs[i] if confs is not None else None)
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
            mask = torch.zeros(self.n_streams, dtype=torch.bool,
                               device=self.device)
            mask[torch.from_numpy(fired).to(self.device)] = True
            self.dec_state = _reset_decoder_slots(self.dec_state, mask,
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
        """Greedy transcripts are already incremental: a no-op (the beam
        rewrite comes with the decode-variants slice)."""
        return list(self.transcripts)

    # -- checkpoint / resume --------------------------------------------------

    def save(self, path: str) -> None:
        """Snapshot the device state, the tokens and the transcripts as an
        .npz with the JAX package's keys
        (nemotron_tpu/streaming/lockstep.py:677-733): a fresh engine of the
        same streams resumes exactly. The mel ring is written as f32."""
        self.flush_pipeline()
        fetch = self._fetch_block
        flat = {f"enc/{k}": fetch(getattr(self.enc_state, k),
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
        if self._ep_frames is not None:
            flat["ep/silence"] = self.ep_silence
            flat["ep/emitted"] = self.ep_emitted
            flat["ep/utt_start"] = self.ep_utt_start
            flat["ep/pending"] = np.asarray(self._ep_pending,
                                            np.int64).reshape(-1, 2)
        for s in range(self.n_streams):
            flat[f"tokens/{s}"] = token_rows(self.tokens[s], self.confidence)
        npz.savez(path, flat)

    def load(self, path: str) -> None:
        """Restore a snapshot written by `save` (or by the JAX engine):
        fresh tensors on the engine's device in its dtypes. The stream
        count must match; a snapshot of a beam, CTC or TDT engine raises
        ValueError."""
        z = npz.NpzView(np.load(path, allow_pickle=True))
        if len(z["dec/prev_token"]) != self.n_streams:
            raise ValueError(
                f"snapshot holds {len(z['dec/prev_token'])} stream rows, "
                f"engine owns {self.n_streams}")
        for key, what in (("tdt_skip", "TDT"), ("ctc_prev", "CTC"),
                          ("beam/h", "beam")):
            if key in z:
                raise ValueError(f"snapshot/engine {what}-mode mismatch: the "
                                 f"snapshot carries {what} state, this "
                                 "engine decodes greedy RNN-T")
        self.enc_state, self.dec_state = restore_states(
            z, self.cc, self.dtype, self.device)
        f32 = torch.float32
        self.front = FrontendState(
            last_sample=npz.to_tensor(z["front/last_sample"], f32,
                                      self.device),
            residue=npz.to_tensor(z["front/residue"], f32, self.device))
        self.mel_buf = npz.to_tensor(z["mel_buf"], self.dtype, self.device)
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
                       for s in range(self.n_streams)]
        self._pending = None

    def finalize(self) -> list[str]:
        """Flush the pending (non-overlap) mel frames with one zero-padded
        chunk, as the session's finalize does; the pad runs at its exact
        size through the ragged tick. Returns the transcripts."""
        self.flush_pipeline()
        pending = self.buf_len - self.cc.pre_encode_cache_size
        if pending > 0:
            need = (self.cc.chunk_mel_frames - self.buf_len) * \
                self.pcfg.n_window_stride
            self.tick(np.zeros((self.n_streams,
                                max(need, 0) + self.pcfg.n_fft), np.int16))
        return self.refresh_transcripts()
