"""The check sees a wrong program: the control (the program in the
configuration's next lower precision) and the faults a served cell can
have, each planted under a whole run of a tiny cell on the CPU, with the
limits a sound run of it passes. Only the harness's look for a card is
skipped. One card means no exchange between chips, so that fault has no
place here.

The faults are planted twice: in a cell whose decoder emits labels, and
in one whose blank bias keeps it blank-only, as the benchmark's cells
are; there a decode fault changes no token, and the captured logits have
to show it."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny
from nemotron_tpu_torch.models import decoder as dec_mod
from nemotron_tpu_torch.models import encoder as enc_mod

LIMITS = {"logit_gap": 1e-3, "rows_missing": 0, "joint_rel": 1e-4,
          "state_rel": 1e-4}
# blank bias 2.0 emits labels; 40.0 none
BIASES = [2.0, 40.0]


def run_tiny(tmp_path, blank_bias=2.0, **kw):
    root = tiny.make_root(tmp_path, blank_bias=blank_bias, limits=LIMITS)
    return harness.run("tiny", 4242, 0.2, False, torch.device("cpu"),
                       time.perf_counter(), root=root, log=lambda s: None,
                       **kw)


@pytest.mark.parametrize("bias", BIASES)
def test_sound_run_passes(tmp_path, bias):
    out = run_tiny(tmp_path, bias)
    assert out["correct"], out["checks"]
    assert (out["readings"]["tokens"] > 0) == (bias == 2.0)


@pytest.mark.parametrize("control", [{"matmul": "w8a8", "kv_cache": "int8"},
                                     {"kv_cache": "int4"}])
def test_control_fails(tmp_path, control):
    out = run_tiny(tmp_path, overrides=control)
    assert not out["correct"]


def test_step_that_leaves_its_state_unchanged_fails(tmp_path, monkeypatch):
    real = enc_mod.encode_chunk

    def frozen(params, cfg, cc, mel, state, pos, **kw):
        k, v = state.k_cache.clone(), state.v_cache.clone()
        out, new = real(params, cfg, cc, mel, state, pos, **kw)
        new.k_cache.copy_(k)
        new.v_cache.copy_(v)
        return out, dataclasses_replace(new, conv_cache=state.conv_cache)

    monkeypatch.setattr(enc_mod, "encode_chunk", frozen)
    assert not run_tiny(tmp_path)["correct"]


def dataclasses_replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)


@pytest.mark.parametrize("bias", BIASES)
def test_decode_of_half_the_batch_fails(tmp_path, monkeypatch, bias):
    """The decode runs over the first half of the streams only; the rest
    get no labels and keep their state."""
    real = dec_mod.greedy_decode

    def half(params, cfg, enc, state, **kw):
        h = enc.shape[0] // 2
        part = dataclasses_replace(state, h=state.h[:h], c=state.c[:h],
                                   prev_token=state.prev_token[:h])
        out = real(params, cfg, enc[:h], part, **kw)
        tokens = torch.full((enc.shape[0],) + out[0].shape[1:],
                            cfg.blank_token, dtype=out[0].dtype)
        tokens[:h] = out[0]
        new = dataclasses_replace(
            state, h=torch.cat([out[1].h, state.h[h:]]),
            c=torch.cat([out[1].c, state.c[h:]]),
            prev_token=torch.cat([out[1].prev_token, state.prev_token[h:]]))
        return (tokens, new) + tuple(out[2:])

    monkeypatch.setattr(dec_mod, "greedy_decode", half)
    out = run_tiny(tmp_path, bias)
    assert out["checks"]["rows_missing"]["value"] > 0
    assert not out["correct"]


@pytest.mark.parametrize("bias", BIASES)
def test_wrong_prediction_network_fails(tmp_path, monkeypatch, bias):
    """The LSTM's output gate biased by the forget gate's slice."""
    real = dec_mod.lstm_step

    def wrong(dp, x, h, c):
        H = h.shape[-1]
        b = dp.b_ih.clone()
        b[:, 3 * H:] = dp.b_ih[:, H:2 * H]
        return real(dataclasses_replace(dp, b_ih=b), x, h, c)

    monkeypatch.setattr(dec_mod, "lstm_step", wrong)
    assert not run_tiny(tmp_path, bias)["correct"]


@pytest.mark.parametrize("bias", BIASES)
def test_wrong_joint_fails(tmp_path, monkeypatch, bias):
    """The joint's logits 1% off, too little to turn a decision."""
    real = dec_mod.joint_logits
    monkeypatch.setattr(dec_mod, "joint_logits",
                        lambda jp, e, d: real(jp, e, d) * 1.01)
    assert not run_tiny(tmp_path, bias)["correct"]


def test_half_the_batch_left_out_fails(tmp_path, monkeypatch):
    real = dec_mod.greedy_decode

    def half(params, cfg, enc, state, **kw):
        out = real(params, cfg, enc, state, **kw)
        tokens = out[0].clone()
        tokens[tokens.shape[0] // 2:] = cfg.blank_token
        return (tokens,) + tuple(out[1:])

    monkeypatch.setattr(dec_mod, "greedy_decode", half)
    assert not run_tiny(tmp_path)["correct"]


def test_token_altered_where_produced_fails(tmp_path, monkeypatch):
    real = dec_mod.greedy_decode

    def altered(params, cfg, enc, state, **kw):
        out = real(params, cfg, enc, state, **kw)
        tokens = out[0].clone()
        flat = tokens.view(tokens.shape[0], -1)
        # each stream's first label of the chunk, where it has one
        first = (flat != cfg.blank_token).int().argmax(dim=1)
        rows = torch.arange(flat.shape[0])
        tok = flat[rows, first]
        flat[rows, first] = torch.where(tok != cfg.blank_token,
                                        (tok + 1) % cfg.blank_token, tok)
        return (tokens,) + tuple(out[1:])

    monkeypatch.setattr(dec_mod, "greedy_decode", altered)
    assert not run_tiny(tmp_path)["correct"]
