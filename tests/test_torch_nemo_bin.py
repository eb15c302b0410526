"""The NEMO v1 weight container, PyTorch port against the JAX package on
the CPU: files byte-identical to JAX's writer (f32 and f16), reads equal
to JAX's both ways, the malformed cases raising NemoBinError with JAX's
messages, and a read file feeding the port's params_from_arrays as the
in-memory arrays do."""

import dataclasses
import struct

import numpy as np
import pytest
import torch

from nemotron_tpu.utils import nemo_bin as jbin
from nemotron_tpu_torch.params import params_from_arrays
from nemotron_tpu_torch.utils import nemo_bin as tbin


def arrays_of(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"encoder.layers.0.weight": rng.standard_normal((3, 5)),
            "decoder.bias": rng.standard_normal(7).astype(np.float32),
            "joint.w": rng.standard_normal((2, 3, 4)).astype(np.float32),
            "scalarish": np.float32(2.5).reshape(()),
            "ünïcode.name": np.arange(4, dtype=np.float32)}


@pytest.mark.parametrize("f16", [False, True])
def test_bytes_equal_jax_writer(tmp_path, f16):
    arrays = arrays_of(0)
    tbin.write_nemo_bin(str(tmp_path / "p.bin"), arrays, f16=f16)
    jbin.write_nemo_bin(str(tmp_path / "j.bin"), arrays, f16=f16)
    assert (tmp_path / "p.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()


@pytest.mark.parametrize("f16,keep_f16", [(False, False), (True, False),
                                          (True, True)])
def test_reads_equal_jax(tmp_path, f16, keep_f16):
    """Each package reads the other's file to the same arrays (names,
    order, shapes, dtypes and values; f16 widened unless keep_f16)."""
    arrays = arrays_of(1)
    tbin.write_nemo_bin(str(tmp_path / "p.bin"), arrays, f16=f16)
    jbin.write_nemo_bin(str(tmp_path / "j.bin"), arrays, f16=f16)
    for path in ("p.bin", "j.bin"):
        got = tbin.read_nemo_bin(str(tmp_path / path), keep_f16=keep_f16)
        want = jbin.read_nemo_bin(str(tmp_path / path), keep_f16=keep_f16)
        assert list(got) == list(want) == list(arrays)
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _malformed() -> dict:
    rec = struct.pack("<I", 1) + b"w"
    return {
        "magic": b"GGUF" + b"\0" * 8,
        "version": b"NEMO" + struct.pack("<II", 2, 0),
        "count": b"NEMO" + struct.pack("<II", 1, 0xFFFFFFFF),
        "name_len": b"NEMO" + struct.pack("<III", 1, 1, 1 << 20),
        "n_dims": b"NEMO" + struct.pack("<II", 1, 1) + rec
        + struct.pack("<I", 9),
        "dtype": b"NEMO" + struct.pack("<II", 1, 1) + rec
        + struct.pack("<III", 1, 2, 7),
        "payload": b"NEMO" + struct.pack("<II", 1, 1) + rec
        + struct.pack("<II", 1, 100) + struct.pack("<I", 0) + b"\0" * 8,
        "header": b"NEM",
        "dims": b"NEMO" + struct.pack("<II", 1, 1) + rec
        + struct.pack("<II", 3, 2),
    }


@pytest.mark.parametrize("case", list(_malformed()))
def test_malformed_raise_nemo_bin_error_as_jax(tmp_path, case):
    """Every malformed file raises NemoBinError (a ValueError) with the
    JAX reader's message."""
    path = str(tmp_path / "bad.bin")
    with open(path, "wb") as f:
        f.write(_malformed()[case])
    with pytest.raises(jbin.NemoBinError) as want:
        jbin.read_nemo_bin(path)
    with pytest.raises(tbin.NemoBinError) as got:
        tbin.read_nemo_bin(path)
    assert str(got.value) == str(want.value)
    assert issubclass(tbin.NemoBinError, ValueError)


def test_read_file_feeds_params_from_arrays(model_setup, tmp_path):
    """The tiny model written to a NEMO file and read back gives the port
    the same parameters, leaf for leaf, as the in-memory arrays (f32), and
    the f16-rounded arrays' parameters from an f16 file."""
    arrays, _params, cfg = model_setup
    path = str(tmp_path / "model.bin")
    tbin.write_nemo_bin(path, arrays)
    want = params_from_arrays(arrays, cfg, device="cpu")
    got = params_from_arrays(tbin.read_nemo_bin(path), cfg, device="cpu")
    path16 = str(tmp_path / "model16.bin")
    tbin.write_nemo_bin(path16, arrays, f16=True)
    want16 = params_from_arrays(
        {k: np.asarray(v).astype(np.float16).astype(np.float32)
         for k, v in arrays.items()}, cfg, device="cpu")
    got16 = params_from_arrays(tbin.read_nemo_bin(path16), cfg, device="cpu")
    n = 0
    for a, b in ((got, want), (got16, want16)):
        for group in ("subsampling", "layers", "decoder", "joint",
                      "preprocessor"):
            ga, gb = getattr(a, group), getattr(b, group)
            for f in dataclasses.fields(ga):
                x, y = getattr(ga, f.name), getattr(gb, f.name)
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x, y), (group, f.name)
                    n += 1
    assert n > 40
