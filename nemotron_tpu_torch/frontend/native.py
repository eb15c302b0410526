"""ctypes binding for the native (C++) streaming audio frontend.

The port's counterpart of `nemotron_tpu/frontend/native.py`. The native
library implements the reference's stateful DSP preprocessor (reference
src/preprocessor.cpp) batched over streams, all on the host: framing,
pre-emphasis, its radix-2 f32 FFT and the mel filterbank (see
native/frontend.cpp), with a ragged entry point that serves any subset
of slots at their own sample counts in one call. It is built from
`native/frontend.cpp` into `build/native/` at first use (`native_build`).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .. import native_build

_lib = None
_error: Exception | None = None   # why the library is unavailable
_lib_lock = threading.Lock()


def _load() -> ctypes.CDLL | None:
    """The bound library, or None when it cannot be built or loaded."""
    global _lib, _error
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            lib = native_build.load("nemotron_frontend")
        except (OSError, RuntimeError) as e:
            _error = e
            return None

        lib.nemo_frontend_create.restype = ctypes.c_void_p
        lib.nemo_frontend_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        lib.nemo_frontend_free.argtypes = [ctypes.c_void_p]
        lib.nemo_frontend_reset.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.nemo_frontend_n_frames.restype = ctypes.c_int
        lib.nemo_frontend_n_frames.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.nemo_frontend_process.restype = ctypes.c_int
        lib.nemo_frontend_process.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.nemo_frontend_residue_len.restype = ctypes.c_int
        lib.nemo_frontend_residue_len.argtypes = [ctypes.c_void_p]
        lib.nemo_frontend_get_state.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
        lib.nemo_frontend_set_state.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        # ragged serving entry points (per-slot rates)
        lib.nemo_frontend_n_frames_s.restype = ctypes.c_int
        lib.nemo_frontend_n_frames_s.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.nemo_frontend_reset_fresh.argtypes = [
            ctypes.c_void_p, ctypes.c_int]
        lib.nemo_frontend_process_ragged.restype = ctypes.c_int
        lib.nemo_frontend_process_ragged.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
        lib.nemo_frontend_residue_len_s.restype = ctypes.c_int
        lib.nemo_frontend_residue_len_s.argtypes = [
            ctypes.c_void_p, ctypes.c_int]
        lib.nemo_frontend_get_state_s.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
        lib.nemo_frontend_set_state_s.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeFrontend:
    """Stateful PCM -> log-mel for S parallel streams, all host-side in C++.

    Mirrors StreamingPreprocessor's interface (process/reset/n_frames_for/
    state_dict) so the preprocessor and the serving engine can swap it in
    transparently. Raises RuntimeError when the library cannot be built or
    loaded."""

    def __init__(self, filterbank: np.ndarray, window_padded: np.ndarray,
                 n_streams: int = 1, n_fft: int = 512, hop: int = 160,
                 n_mels: int = 128, preemph: float = 0.97,
                 log_zero_guard: float = 2.0 ** -24):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                f"native frontend library unavailable: {_error}")
        self._lib = lib
        self.n_streams = n_streams
        self.n_mels = n_mels
        fb = np.ascontiguousarray(filterbank, np.float32)
        win = np.ascontiguousarray(window_padded, np.float32)
        assert win.size == n_fft and fb.shape == (n_mels, n_fft // 2 + 1)
        self._handle = ctypes.c_void_p(lib.nemo_frontend_create(
            n_streams, n_fft, 400, hop, n_mels,
            ctypes.c_float(preemph), ctypes.c_float(log_zero_guard),
            win.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            fb.ctypes.data_as(ctypes.POINTER(ctypes.c_float))))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.nemo_frontend_free(self._handle)
            self._handle = None

    def reset(self, stream: int | None = None) -> None:
        self._lib.nemo_frontend_reset(
            self._handle, -1 if stream is None else stream)

    def n_frames_for(self, n_new_samples: int) -> int:
        return self._lib.nemo_frontend_n_frames(self._handle, n_new_samples)

    def state_dict(self) -> dict[str, np.ndarray]:
        """Snapshot the DSP state (checkpoint/resume of a session)."""
        rl = self._lib.nemo_frontend_residue_len(self._handle)
        last = np.empty(self.n_streams, np.float32)
        residue = np.empty((self.n_streams, rl), np.float32)
        self._lib.nemo_frontend_get_state(
            self._handle,
            last.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            residue.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return {"last_sample": last, "residue": residue}

    def load_state_dict(self, state: dict[str, np.ndarray]) -> None:
        last = np.ascontiguousarray(state["last_sample"], np.float32)
        residue = np.ascontiguousarray(state["residue"], np.float32)
        assert last.shape == (self.n_streams,)
        assert residue.ndim == 2 and residue.shape[0] == self.n_streams
        self._lib.nemo_frontend_set_state(
            self._handle,
            last.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            residue.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            residue.shape[1])

    def process(self, audio_i16: np.ndarray) -> np.ndarray:
        squeeze = audio_i16.ndim == 1
        if squeeze:
            audio_i16 = audio_i16[None]
        S, N = audio_i16.shape
        assert S == self.n_streams
        audio = np.ascontiguousarray(audio_i16, "<i2")
        n_frames = self.n_frames_for(N)
        out = np.empty((S, n_frames, self.n_mels), np.float32)
        if n_frames or N:
            got = self._lib.nemo_frontend_process(
                self._handle,
                audio.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), N,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            assert got == n_frames
        return out

    # -- ragged serving entry points (per-slot rates) -----------------------

    def n_frames_for_slot(self, slot: int, n_new_samples: int) -> int:
        return self._lib.nemo_frontend_n_frames_s(self._handle, slot,
                                                  n_new_samples)

    def reset_fresh(self, slot: int) -> None:
        """Reset one slot to the fresh (center-pad) DSP state regardless of
        other slots' residue lengths (ragged admission semantics)."""
        self._lib.nemo_frontend_reset_fresh(self._handle, slot)

    def process_ragged(self, audio_by_slot: dict[int, np.ndarray]
                       ) -> dict[int, np.ndarray]:
        """Process an arbitrary subset of slots, each with its own sample
        count, in ONE native call (the serving engine's per-tick host DSP).
        Returns {slot: mel [frames_i, n_mels] f32}."""
        if not audio_by_slot:
            return {}
        slots = np.fromiter(audio_by_slot.keys(), np.int32)
        blocks = [np.ascontiguousarray(audio_by_slot[int(s)], "<i2").ravel()
                  for s in slots]
        counts = np.asarray([b.shape[0] for b in blocks], np.int32)
        offsets = np.concatenate(
            [[0], np.cumsum(counts[:-1])]).astype(np.int64)
        audio = (np.concatenate(blocks) if blocks
                 else np.zeros(0, "<i2")).astype("<i2")
        frames = np.asarray(
            [self.n_frames_for_slot(int(s), int(c))
             for s, c in zip(slots, counts)], np.int32)
        out = np.empty((int(frames.sum()), self.n_mels), np.float32)
        got_frames = np.zeros(len(slots), np.int32)
        got = self._lib.nemo_frontend_process_ragged(
            self._handle,
            audio.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(slots),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            got_frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        assert got == frames.sum() and (got_frames == frames).all()
        res, ofs = {}, 0
        for s, f in zip(slots, frames):
            res[int(s)] = out[ofs:ofs + f]
            ofs += f
        return res

    def slot_state_dict(self, slot: int) -> dict:
        rl = self._lib.nemo_frontend_residue_len_s(self._handle, slot)
        last = np.zeros(1, np.float32)
        residue = np.empty(rl, np.float32)
        self._lib.nemo_frontend_get_state_s(
            self._handle, slot,
            last.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            residue.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return {"last_sample": last, "residue": residue[None]}

    def load_slot_state_dict(self, slot: int, state: dict) -> None:
        residue = np.ascontiguousarray(state["residue"], np.float32).ravel()
        self._lib.nemo_frontend_set_state_s(
            self._handle, slot,
            ctypes.c_float(float(np.asarray(state["last_sample"]).ravel()[0])),
            residue.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            residue.shape[0])
