"""Phase-staggered cohort serving: stream capacity times the duty cycle.

The port's counterpart of `nemotron_tpu/streaming/cohorts.py`. A tick of a
slab of B streams takes a fraction of the chunk period; the rest of the
period the card waits for the next chunk of audio to exist. C independent
cohorts of B streams whose chunk arrivals are staggered by 1/C of the
period fill that wait: each incoming stream is assigned to the cohort
whose phase matches its arrival, the card serves the cohorts' ticks in
turn, and each chunk's latency stays one tick while capacity becomes
C x B, as far as the tick time and the memory for C x B streams' state
allow.

All cohorts share one copy of the weights on the device: engine c > 0 is
built from engine 0's cast params (`cast_params` returns the same tensor
for a leaf already in the compute dtype) and takes engine 0's position
projections. Global stream ids are `cohort * B + lane`.
"""

from __future__ import annotations

import numpy as np

from ..config import CacheConfig, ModelConfig
from ..params import ModelParams
from .lockstep import LockstepEngine
from .serving import ServingEngine


def _assign(cc: CacheConfig, n_cohorts: int, arrival_s: float) -> int:
    """The cohort whose tick phase comes next after an arrival at
    `arrival_s` (seconds, any epoch): the stream's first chunk completes
    as its cohort ticks."""
    period = cc.chunk_samples / cc.sample_rate
    frac = (arrival_s % period) / period
    return int(np.ceil(frac * n_cohorts)) % n_cohorts


class CohortScheduler:
    """C phase-staggered LockstepEngine cohorts sharing one weight set.

    The caller drives the cadence: at phase (c/C) * chunk_period it feeds
    cohort c one block of PCM a stream through `tick(c, pcm)`."""

    def __init__(self, params: ModelParams, cfg: ModelConfig,
                 vocab: list[str] | None = None,
                 cache_config: CacheConfig | None = None,
                 n_streams: int = 256, n_cohorts: int = 2, **engine_kw):
        if n_cohorts < 1:
            raise ValueError(f"n_cohorts must be >= 1, got {n_cohorts}")
        self.cfg = cfg
        self.cc = cache_config or CacheConfig(n_mels=cfg.n_mels)
        self.n_streams = n_streams          # per cohort
        self.n_cohorts = n_cohorts
        self.engines: list[LockstepEngine] = []
        for _ in range(n_cohorts):
            first = self.engines[0] if self.engines else None
            eng = LockstepEngine(first.params if first else params, cfg,
                                 vocab, self.cc, n_streams=n_streams,
                                 **engine_kw)
            if first:
                eng.pos_heads = first.pos_heads
                eng.window = first.window
                eng.filterbank = first.filterbank
            self.engines.append(eng)

    # -- stream ids -----------------------------------------------------------

    def stream_id(self, cohort: int, lane: int) -> int:
        return cohort * self.n_streams + lane

    def locate(self, stream_id: int) -> tuple[int, int]:
        return divmod(stream_id, self.n_streams)

    def assign(self, arrival_s: float) -> int:
        return _assign(self.cc, self.n_cohorts, arrival_s)

    # -- serving --------------------------------------------------------------

    def tick(self, cohort: int, pcm_i16: np.ndarray,
             pipelined: bool = False) -> dict[int, str]:
        """One cohort's tick (pcm_i16 [n_streams, samples]); the text dict
        is keyed by GLOBAL stream id."""
        eng = self.engines[cohort]
        out = (eng.tick_pipelined if pipelined else eng.tick)(pcm_i16)
        base = cohort * self.n_streams
        return {base + s: t for s, t in out.items()}

    def finalize(self) -> list[str]:
        """Flush every cohort; all C*B transcripts in global id order."""
        return [t for eng in self.engines for t in eng.finalize()]

    @property
    def transcripts(self) -> list[str]:
        return [t for eng in self.engines for t in eng.transcripts]

    def refresh_transcripts(self) -> list[str]:
        for eng in self.engines:
            eng.refresh_transcripts()
        return self.transcripts

    # -- snapshots ------------------------------------------------------------

    def save(self, prefix: str) -> None:
        """One snapshot file a cohort: <prefix>.cohort<k>.npz."""
        for c, eng in enumerate(self.engines):
            eng.save(f"{prefix}.cohort{c}.npz")

    def load(self, prefix: str) -> None:
        for c, eng in enumerate(self.engines):
            eng.load(f"{prefix}.cohort{c}.npz")


class ServingCohorts:
    """Phase-staggered cohorts of ragged ServingEngines: each cohort is a
    whole continuous-batching engine (per-slot rates, admission, eviction,
    ring realignment, endpointing). A stream lives its whole life in the
    cohort it was admitted to. The engines share the weights and the
    position projections; each keeps its own slot state and, with
    dsp="device", its own DSP buffers (a few KB of window and filterbank
    besides).

    Global stream ids are `cohort * n_slots + slot`."""

    def __init__(self, params: ModelParams, cfg: ModelConfig,
                 vocab: list[str] | None = None,
                 cache_config: CacheConfig | None = None,
                 n_slots: int = 64, n_cohorts: int = 2, **engine_kw):
        if n_cohorts < 1:
            raise ValueError(f"n_cohorts must be >= 1, got {n_cohorts}")
        self.cfg = cfg
        self.cc = cache_config or CacheConfig(n_mels=cfg.n_mels)
        self.n_slots = n_slots              # per cohort
        self.n_cohorts = n_cohorts
        self.engines: list[ServingEngine] = []
        for _ in range(n_cohorts):
            first = self.engines[0] if self.engines else None
            eng = ServingEngine(first.params if first else params, cfg,
                                vocab, self.cc, n_slots=n_slots, **engine_kw)
            if first:
                eng.pos_heads = first.pos_heads
            self.engines.append(eng)

    # -- stream ids -----------------------------------------------------------

    def stream_id(self, cohort: int, slot: int) -> int:
        return cohort * self.n_slots + slot

    def locate(self, stream_id: int) -> tuple[int, int]:
        return divmod(stream_id, self.n_slots)

    def assign(self, arrival_s: float) -> int:
        return _assign(self.cc, self.n_cohorts, arrival_s)

    # -- stream lifecycle ----------------------------------------------------

    def add_stream(self, cohort: int | None = None,
                   arrival_s: float | None = None) -> int:
        """Admit a stream; returns its GLOBAL id. The cohort comes from
        `arrival_s` when given, else it is the least loaded one."""
        if cohort is None:
            if arrival_s is not None:
                cohort = self.assign(arrival_s)
            else:
                cohort = min(range(self.n_cohorts),
                             key=lambda c: int(self.engines[c].active.sum()))
        return self.stream_id(cohort, self.engines[cohort].add_stream())

    def remove_stream(self, stream_id: int) -> str:
        c, s = self.locate(stream_id)
        return self.engines[c].remove_stream(s)

    def feed_audio(self, audio: dict[int, np.ndarray]) -> None:
        """{global stream id: int16 PCM}, forwarded to each cohort."""
        per: list[dict] = [{} for _ in range(self.n_cohorts)]
        for gid, pcm in audio.items():
            c, s = self.locate(gid)
            per[c][s] = pcm
        for c, d in enumerate(per):
            if d:
                self.engines[c].feed_audio(d)

    def step(self, cohort: int) -> dict[int, str]:
        """One cohort's engine tick at its phase; the new text is keyed by
        GLOBAL stream id."""
        out = self.engines[cohort].step()
        base = cohort * self.n_slots
        return {base + s: t for s, t in out.items()}

    # -- results --------------------------------------------------------------

    @property
    def transcripts(self) -> dict[int, str]:
        return {self.stream_id(c, s): eng.transcripts[s]
                for c, eng in enumerate(self.engines)
                for s in np.flatnonzero(eng.active).tolist()}

    @property
    def tokens(self) -> dict[int, list]:
        return {self.stream_id(c, s): eng.tokens[s]
                for c, eng in enumerate(self.engines)
                for s in np.flatnonzero(eng.active).tolist()}

    def stats(self) -> dict:
        per = [eng.stats() for eng in self.engines]
        return {"n_cohorts": self.n_cohorts,
                "active_slots": sum(p["active_slots"] for p in per),
                "engine_steps": sum(p["engine_steps"] for p in per),
                "cohorts": per}
