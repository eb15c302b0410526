"""Multi-process serving over one mesh: a serving slab spanning the ranks
of a torch.distributed world, each process feeding and reading only its
own stream rows.

The port's counterpart of `nemotron_tpu/parallel/multihost.py`. A JAX
"process" (a host with its devices) maps to one MODEL GROUP of ranks:
the ranks of a group hold the same stream rows (each a share of the
encoder's FFNs and heads), and must be constructed alike and fed the same
PCM. Across groups the steady state has no collective: pure data
parallelism over streams, each group computing its own rows.

  - the host boundary is per group: `tick()` / `feed_audio()` take, and
    `tokens` / `transcripts` hold, only the rows of this rank's data index
    (`local_rows` maps local index -> global row);
  - the two lockstep hooks `_put_pcm` / `_fetch_block` (and the snapshot
    seams `_unsnap_rows` / `_shard_loaded_state`) are the whole surface;
    everything else (DSP, encoder, decode modes, endpoint accounting,
    detokenization) is inherited.

Tested without more than one card by subprocesses on gloo
(tests/test_torch_multihost.py), as the JAX package tests its own with
two CPU processes.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..models import encoder as enc_mod
from ..streaming import serving as serving_mod
from ..streaming.lockstep import LockstepEngine
from ..streaming.serving import ServingEngine
from ..utils import npz
from .mesh import backend_for, init_world, make_mesh, shard_state


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, *, cpu_gloo: bool = False) -> str:
    """Join (process 0: create) the world at `coordinator_address`
    ("host:port"), as rank `process_id` of `num_processes`. cpu_gloo=True
    forces gloo (the hermetic CPU configuration of the tests); otherwise
    NCCL where every rank can have a card of its own, gloo where ranks
    share one. Returns the backend."""
    return init_world(f"tcp://{coordinator_address}", num_processes,
                      process_id,
                      "gloo" if cpu_gloo else backend_for(num_processes))


def local_row_spans(mesh, n_streams: int):
    """The stream rows THIS rank's data index owns: (spans, rows), spans a
    sorted list of half-open (start, stop) global-row ranges, rows the
    flat global row indices."""
    lo, hi = mesh.row_span(n_streams)
    return [(lo, hi)], np.arange(lo, hi)


def put_stream_rows(mesh, local_block: np.ndarray, n_streams: int, spans):
    """This rank's rows ([n_local, ...], ordered as `local_row_spans`) on
    its device: the rank's part of the global [n_streams, ...] slab (no
    host ever holds the whole)."""
    assert sum(b - a for a, b in spans) == local_block.shape[0]
    return torch.from_numpy(np.ascontiguousarray(local_block)).to(
        mesh.device)


def put_stream_rows_axis(mesh, local_block: np.ndarray, n_streams: int,
                         spans, stream_axis: int, dtype=None):
    """`put_stream_rows` with the stream axis at `stream_axis` (encoder
    caches are [L, B, ...]), as a fresh tensor of `dtype`."""
    assert sum(b - a for a, b in spans) == local_block.shape[stream_axis]
    t = torch.from_numpy(np.ascontiguousarray(local_block))
    return t.to(device=mesh.device, dtype=dtype or t.dtype).clone()


def fetch_stream_rows(x, stream_axis: int, rows, first_row: int = 0):
    """The given global stream `rows` of `x` as numpy, x holding the rows
    from `first_row` on along `stream_axis` (a copy, bf16 upcast)."""
    return np.take(npz.to_numpy(x), np.asarray(rows) - first_row,
                   axis=stream_axis)


def _check_world(what: str, single: str) -> None:
    """JAX's refusal of a one-process cluster (process_count() < 2)."""
    if not dist.is_initialized() or dist.get_world_size() < 2:
        raise RuntimeError(f"{what} needs a torch.distributed world of two "
                           f"or more ranks (init_multihost); use {single} "
                           "in one process")


class MultihostLockstep(LockstepEngine):
    """LockstepEngine spanning every rank of a torch.distributed world.

    The device state is split over the mesh (`n_streams` across every data
    index); the host interface is LOCAL: `tick()` takes [engine.n_local,
    N] PCM for this rank's rows (`engine.local_rows` maps local index ->
    global row) and returns text keyed by local index.

    Collective-consistency contract -- every rank must:
      - construct the engine with identical config/params/n_streams,
      - issue the same sequence of tick()/finalize() calls with the SAME
        per-tick sample count (the ranks of a model group sum partial
        products inside every encoder layer; a divergent call sequence
        desyncs them),
      - and the ranks of a model group feed the same PCM.

    Not supported multihost: `endpoint_reset` (the reset is a collective
    whose firing is data-dependent per process), and beam decode (the JAX
    package's MultihostServing refuses it, nemotron_tpu/parallel/
    multihost.py:322-324, and so does this engine). Plain endpointing
    (events without decoder reset) is pure host accounting and works.

    `save`/`load` are per-process shard snapshots: every rank calls them
    COLLECTIVELY with the SAME path; each data index writes/reads its own
    `<path>.p<data index>.npz` holding only its stream rows (with every
    head: a model group gathers its heads, its first rank writes). Load
    requires the same process count/row ownership the snapshot was taken
    with."""

    def __init__(self, params, cfg, vocab=None, cache_config=None,
                 n_streams: int = 256, mesh=None, model_parallel: int = 1,
                 **kw):
        _check_world("MultihostLockstep", "LockstepEngine")
        if kw.get("beam_size", 1) > 1:
            raise ValueError("beam decode is not wired multihost "
                             "(staged beam-slot resets not implemented)")
        if kw.get("endpoint_reset"):
            raise ValueError("endpoint_reset is not supported multihost "
                             "(data-dependent collective); endpoint events "
                             "without reset work")
        if mesh is None:
            mesh = make_mesh(model_parallel=model_parallel,
                             device=params.device)
        if n_streams % mesh.data:
            raise ValueError(f"n_streams={n_streams} not divisible by the "
                             f"data axis ({mesh.data})")
        # preset BEFORE the base __init__ (which otherwise defaults
        # local == global); see LockstepEngine.__init__
        self._spans, rows = local_row_spans(mesh, n_streams)
        self._local_rows = rows
        self.n_local = len(rows)
        super().__init__(params, cfg, vocab, cache_config,
                         n_streams=n_streams, mesh=mesh, **kw)

    @property
    def local_rows(self) -> np.ndarray:
        """Global row index of each local stream (local i -> global)."""
        return self._local_rows

    def _dev_rows(self, a: np.ndarray, axis: int = 0) -> np.ndarray:
        return a                    # the host's rows are the device's

    def _put_pcm(self, pcm_i16: np.ndarray):
        return put_stream_rows(self.mesh, np.asarray(pcm_i16, np.int16),
                               self.n_streams, self._spans)

    def _fetch_block(self, x, stream_axis: int) -> np.ndarray:
        return fetch_stream_rows(x, stream_axis, self._local_rows,
                                 self._lo)

    def _unsnap_rows(self, a, dtype, stream_axis: int):
        return put_stream_rows_axis(self.mesh, npz.npz_decode(a),
                                    self.n_streams, self._spans,
                                    stream_axis, dtype=dtype)

    def _shard_loaded_state(self) -> None:
        # the rows are this rank's already (_unsnap_rows); take its heads
        self.enc_state = shard_state(self.enc_state, self.mesh,
                                     self._heads_split(), rows=False)

    def _writes_snapshot(self) -> bool:
        return self.mesh.model_index == 0

    def _rank_path(self, path: str) -> str:
        base = path[:-4] if path.endswith(".npz") else path
        return f"{base}.p{self.mesh.data_index}.npz"

    def save(self, path: str) -> None:
        """Collective per-process shard snapshot (see class docstring)."""
        super().save(self._rank_path(path))

    def load(self, path: str) -> None:
        super().load(self._rank_path(path))


class MultihostServing(ServingEngine):
    """Ragged continuous-batching `ServingEngine` spanning every rank of a
    torch.distributed world.

    The device slab is GLOBAL (`n_slots` across every data index, each
    rank holding its rows); the host interface is LOCAL: each process
    admits, feeds and reads only slots whose rows its own data index holds
    (`local_rows`). Host DSP only (dsp="numpy"); greedy / confidence /
    CTC / TDT decode modes (beam's staged slot resets are not wired).

    ## Collective-determinism contract

    SPMD requires every process to issue the SAME device-program sequence,
    but ragged serving is full of data-dependent host decisions (which
    slots are ready, who was just admitted, whose ring phase lags, whose
    endpoint fired). This engine makes the sequence deterministic by
    construction -- every `step()` call issues EXACTLY four collective
    programs regardless of local slot activity:

      1. staged full resets  (admissions / evictions since the last step),
      2. staged decoder-only resets (endpoint_reset fires),
      3. batched ring realign (models/encoder.py realign_rings; per-slot
         deltas, 0 = no-op -- the per-slot data-dependent realign_ring
         calls of the single-process engine would desync),
      4. ONE masked chunk step over the globally assembled ready mask.

    All four run even when every mask is empty. Every process must call
    step() at the same cadence (the lockstep-engine contract); a slot with
    more than one chunk buffered drains over successive calls instead of
    the single-process engine's data-dependent while loop.

    In the port a process is a model group of ranks, and the only
    collectives are the model-axis sums inside the encoder's layers:
    passes 1-3 are local to a rank, and pass 3 is skipped when every one
    of its rows' deltas is 0 (the same decision on every rank of a group,
    whose host state is the same).

    ## endpoint_reset, multihost

    SUPPORTED here via staging (the single-process engine resets fired
    slots' prediction networks immediately -- a data-dependent collective
    that MultihostLockstep must reject): a fired slot's decoder reset is
    folded into the NEXT step's pass-2 mask, landing one step late.
    Harmless by the same argument as the lockstep pipelined mode: blanks
    never advance the decoder state, so the only exposure is an utterance
    beginning within that single in-flight step.

    `finalize_stream` is not available (it would have to call step() a
    slot-dependent number of times from one process): feed whole chunks,
    run collective step()s until drained, then `remove_stream(slot)`.
    """

    def __init__(self, params, cfg, vocab=None, cache_config=None,
                 n_slots: int = 256, mesh=None, model_parallel: int = 1,
                 **kw):
        _check_world("MultihostServing", "ServingEngine")
        if kw.get("dsp", "numpy") == "device":
            raise ValueError("MultihostServing is host-DSP only "
                             "(dsp='numpy'); the device-DSP state is not "
                             "globally sharded")
        if kw.get("beam_size", 1) > 1:
            raise ValueError("beam decode is not wired multihost "
                             "(staged beam-slot resets not implemented)")
        kw["dsp"] = "numpy"
        # the base engine's immediate endpoint reset is a data-dependent
        # collective; run with it OFF and stage fires ourselves (pass 2)
        self._mh_ep_reset = bool(kw.pop("endpoint_reset", False))
        if mesh is None:
            mesh = make_mesh(model_parallel=model_parallel,
                             device=params.device)
        if n_slots % mesh.data:
            raise ValueError(f"n_slots={n_slots} not divisible by the "
                             f"data axis ({mesh.data})")
        self._spans, rows = local_row_spans(mesh, n_slots)
        self._local_rows = rows
        self._local_of = {int(r): i for i, r in enumerate(rows)}
        self.n_local = len(rows)
        self._staged_full = np.zeros(self.n_local, bool)
        self._staged_dec = np.zeros(self.n_local, bool)
        super().__init__(params, cfg, vocab, cache_config, n_slots=n_slots,
                         mesh=mesh, **kw)

    @property
    def local_rows(self) -> np.ndarray:
        return self._local_rows

    def _whole(self, x: torch.Tensor) -> np.ndarray:
        return npz.to_numpy(x)      # this rank's rows only: no gather

    # -- local-row slot management with staged device resets ---------------

    def add_stream(self) -> int:
        free = [int(r) for r in self._local_rows if not self.active[r]]
        if not free:
            raise RuntimeError("no free local stream slots")
        slot = free[0]
        self.active[slot] = True
        self._clear_slot(slot)
        return slot

    def add_streams(self, count: int) -> list:
        return [self.add_stream() for _ in range(count)]

    def _clear_slot(self, slot: int) -> None:
        """Host-side clear + STAGED device reset (applied at the next
        collective step) -- overrides the base's immediate device calls."""
        self._staged_full[self._local_of[int(slot)]] = True
        if self.ctc_prev is not None:
            self.ctc_prev[slot] = -1
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
            self.seg_buffers[slot] = serving_mod._SegmentBuffer(
                self._seg_cap)
        self.slot_phase[slot] = 0

    def finalize_stream(self, slot: int, return_tokens: bool = False):
        raise NotImplementedError(
            "finalize_stream is slot-locally data-dependent; feed whole "
            "chunks, run collective step()s until drained, then "
            "remove_stream(slot) -- see the class docstring")

    def finalize_streams(self, slots, return_tokens: bool = False):
        return self.finalize_stream(slots, return_tokens)

    def save(self, path: str) -> None:
        raise NotImplementedError("per-process snapshots are "
                                  "MultihostLockstep's")

    load = save

    def _ep_update(self, emitted: dict, advanced: np.ndarray,
                   frames_advanced: int) -> None:
        before = len(self._ep_pending)
        super()._ep_update(emitted, advanced, frames_advanced)
        if self._mh_ep_reset:
            for s, _end, _seg in self._ep_pending[before:]:
                self._staged_dec[self._local_of[int(s)]] = True

    # -- the deterministic collective step ----------------------------------

    def _to_global(self, a: np.ndarray, fill) -> np.ndarray:
        """A step result over this rank's rows -> over every slot, the
        other rows `fill` (blank tokens: nothing emitted)."""
        out = np.full((self.n_slots,) + a.shape[1:], fill, a.dtype)
        out[self._local_rows] = a
        return out

    def step(self) -> dict:
        cc = self.cc
        rows = self._local_rows
        dev = self.device
        blank = int(self.cfg.blank_token)
        out: dict = {}

        # pass 1+2: staged resets (always issued)
        full_mask, self._staged_full = (self._staged_full,
                                        np.zeros(self.n_local, bool))
        dec_mask, self._staged_dec = (self._staged_dec,
                                      np.zeros(self.n_local, bool))
        self.enc_state, self.dec_state = serving_mod._reset_slots(
            self.enc_state, self.dec_state, full_mask, blank)
        self.dec_state = serving_mod._reset_decoder_slots(
            self.dec_state, torch.from_numpy(dec_mask).to(dev), blank)
        if self.tdt_skip is not None:
            self.tdt_skip = torch.where(torch.from_numpy(full_mask).to(dev),
                                        0, self.tdt_skip)

        # local readiness + realign deltas to the shared write phase
        local_ready = np.array(
            [self.active[r] and self.mel_buffers[r].count
             >= cc.chunk_mel_frames for r in rows], bool)
        deltas = np.zeros(self.n_local, np.int32)
        for i, r in enumerate(rows):
            if local_ready[i] and self.slot_phase[r] != self.phase_counter:
                deltas[i] = (self.phase_counter - self.slot_phase[r]) \
                    % self.n_seg
                self.slot_phase[r] = self.phase_counter
        # pass 3: batched realign (skipped when every delta is 0)
        if deltas.any():
            self.enc_state = enc_mod.realign_rings(
                self.enc_state, torch.from_numpy(deltas), cc.chunk_enc_len)

        # pass 4: ONE masked chunk step over the local ready mask
        chunk_local = np.zeros(
            (self.n_local, cc.chunk_mel_frames, self.cfg.n_mels),
            np.float32)
        for i, r in enumerate(rows):
            if local_ready[i]:
                chunk_local[i] = self.mel_buffers[r].compact()[
                    : cc.chunk_mel_frames]
        chunk = torch.from_numpy(chunk_local).to(self.dtype).to(dev)
        mask = torch.from_numpy(local_ready).to(dev)
        t0 = time.perf_counter()
        first, second = self._decode(chunk, mask)
        self.step_times.append(time.perf_counter() - t0)

        # host fold-in for LOCAL ready slots (local-index results remapped
        # to global slot ids)
        for r in rows[local_ready]:
            self.mel_buffers[int(r)].drop(cc.shift_mel_frames)
        stepped = np.zeros(self.n_slots, bool)
        stepped[rows[local_ready]] = True
        result = (self._to_global(first, blank),
                  None if second is None else self._to_global(second, 0))
        self._advance(stepped, result, out)
        return out
