"""The card against the CPU on small inputs, for the paths whose CPU tests
hold the port to the JAX package but which had no test on the card: the
RNN-T beam search, the TDT walk and the TDT beam, CTC decoding (direct
and through a streaming session), and one train step. Every test is
marked `cuda` and skips without a card.

The port alone is imported (no JAX, no conftest), so the tests also run
where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_on_card.py

The models are the CPU tests' tiny config with their peaking: the beam
test's (prediction network x20, joint x10), the TDT tests' (x5, x3) and
the CTC tests' (CTC head x8), so that the decodes emit and their choices
have margins."""

import numpy as np
import pytest
import torch

from nemotron_tpu_torch import params as tparams
from nemotron_tpu_torch import training as ttrain
from nemotron_tpu_torch.config import CacheConfig, ModelConfig
from nemotron_tpu_torch.models import beam as tbeam
from nemotron_tpu_torch.models import ctc as tctc
from nemotron_tpu_torch.models import decoder as tdec
from nemotron_tpu_torch.models import tdt as ttdt
from nemotron_tpu_torch.streaming.session import StreamSession

F32 = torch.float32
# beam scores, card against CPU: chip_smoke.py's TOL_BEAM_SCORE
TOL_BEAM_SCORE = 1e-3


def tiny_config(**kw) -> ModelConfig:
    """tests/conftest.py's tiny_config."""
    return ModelConfig(n_mels=32, d_model=64, n_heads=4, d_head=16, d_ff=96,
                       n_layers=3, kernel_size=9, vocab_size=41,
                       decoder_dim=48, joint_dim=56, subsampling_channels=16,
                       **kw)


def scaled(arrays: dict, dec: float, joint: float) -> dict:
    return {k: v * np.float32(dec if k.startswith("decoder.") else joint)
            if k.startswith(("decoder.", "joint.")) else v
            for k, v in arrays.items()}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def on_both(arrays: dict, cfg, card):
    """The params on the CPU and on the card, by name ("cpu", "cuda")."""
    return {"cpu": tparams.params_from_arrays(arrays, cfg, device="cpu"),
            "cuda": tparams.params_from_arrays(arrays, cfg, device=card)}


def enc_of(cfg, seed=42, B=3, T=6) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, cfg.d_model)).astype(np.float32) * 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("K,E", [(2, 3), (4, 10)])
def test_beam_decode_on_card_equals_cpu(card, K, E):
    """beam_decode on the peaked tiny model over a ragged batch: tokens and
    lengths equal to the CPU's, scores within TOL_BEAM_SCORE."""
    cfg = tiny_config()
    arrays = scaled(tparams.random_weight_arrays(cfg, seed=0), 20.0, 10.0)
    p = on_both(arrays, cfg, card)
    enc = enc_of(cfg)
    lengths = np.array([6, 2, 0], np.int32)
    out = {}
    for name, params in p.items():
        dev = params.device
        st = tbeam.init_beam_state(cfg, 3, K, 24, F32, dev)
        out[name] = tbeam.beam_decode(
            params, cfg, torch.from_numpy(enc).to(dev), st, K, E,
            torch.from_numpy(lengths).to(dev))
    for k in ("tokens", "lengths", "prev_token"):
        np.testing.assert_array_equal(getattr(out["cuda"], k).cpu().numpy(),
                                      getattr(out["cpu"], k).numpy(),
                                      err_msg=k)
    np.testing.assert_allclose(out["cuda"].scores.cpu().numpy(),
                               out["cpu"].scores.numpy(), rtol=0,
                               atol=TOL_BEAM_SCORE)
    assert int(out["cpu"].lengths.max()) > 0


def tdt_model(card):
    cfg = tiny_config(tdt_durations=(0, 1, 2, 3))
    arrays = scaled(tparams.random_weight_arrays(cfg, seed=3, ctc_head=True),
                    5.0, 3.0)
    return cfg, on_both(arrays, cfg, card)


@pytest.mark.cuda
def test_tdt_greedy_decode_on_card_equals_cpu(card):
    """The TDT walk over a ragged batch, with a carried skip: tokens,
    the decoder state's prev_token and tdt_skip (skip_out) exact."""
    cfg, p = tdt_model(card)
    enc = enc_of(cfg, T=9)
    out = {}
    for name, params in p.items():
        dev = params.device
        st = tdec.init_decoder_state(cfg, 3, F32, dev)
        out[name] = ttdt.tdt_greedy_decode(
            params, cfg, torch.from_numpy(enc).to(dev), st,
            skip_in=torch.tensor([0, 1, 2], dtype=torch.int32, device=dev),
            enc_lengths=torch.tensor([9, 7, 4], device=dev))
    toks_c, st_c, skip_c = out["cuda"]
    toks, st, skip = out["cpu"]
    np.testing.assert_array_equal(toks_c.cpu().numpy(), toks.numpy())
    np.testing.assert_array_equal(skip_c.cpu().numpy(), skip.numpy())
    np.testing.assert_array_equal(st_c.prev_token.cpu().numpy(),
                                  st.prev_token.numpy())
    assert (toks.numpy() != cfg.blank_token).any()


@pytest.mark.cuda
def test_tdt_beam_decode_on_card_equals_cpu(card):
    """The TDT beam (K = 4) over two chunks: t and sym exact after each,
    tokens and lengths exact, scores within TOL_BEAM_SCORE."""
    cfg, p = tdt_model(card)
    enc = enc_of(cfg, seed=7, T=12)
    out = {}
    for name, params in p.items():
        dev = params.device
        st = ttdt.init_tdt_beam_state(cfg, 3, 4, 24, F32, dev)
        x = torch.from_numpy(enc).to(dev)
        hist = []
        for a, b in ((0, 6), (6, 12)):
            st = ttdt.tdt_beam_decode(params, cfg, x[:, a:b], st, 4)
            hist.append({k: getattr(st, k).cpu().numpy()
                         for k in ("t", "sym", "tokens", "lengths",
                                   "scores")})
        out[name] = hist
    for got, want in zip(out["cuda"], out["cpu"]):
        for k in ("t", "sym", "tokens", "lengths"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                                   atol=TOL_BEAM_SCORE)
    assert out["cpu"][-1]["lengths"].max() > 0


@pytest.mark.cuda
def test_ctc_on_card_equals_cpu(card):
    """The CTC head's frame ids on a random encoder output, and a CTC
    streaming session over two streams (the ring-attention kernel on the
    card): ids, tokens with frames and ctc_prev exact."""
    cfg = tiny_config()
    arrays = tparams.random_weight_arrays(cfg, seed=0, ctc_head=True)
    arrays["ctc_decoder.decoder_layers.0.weight"] *= np.float32(8.0)
    p = on_both(arrays, cfg, card)
    enc = enc_of(cfg, seed=5, T=20)
    ids = {name: tctc.frame_ids(params, torch.from_numpy(enc).to(
        params.device)).cpu().numpy() for name, params in p.items()}
    np.testing.assert_array_equal(ids["cuda"], ids["cpu"])
    rng = np.random.default_rng(17)
    t = np.arange(32000) / 16000.0
    pcm = np.stack([(0.3 * np.sin(2 * np.pi * f * t)
                     + 0.05 * rng.standard_normal(32000)) * 16000
                    for f in (440.0, 880.0)]).astype(np.int16)
    cc = CacheConfig(att_right_context=1, att_left_context=12,
                     n_mels=cfg.n_mels)
    vocab = [f"w{i}" for i in range(cfg.vocab_size)]
    sess = {}
    for name, params in p.items():
        s = StreamSession(params, cfg, vocab, cc, n_streams=2, ctc=True)
        for i in range(0, 24000, 3000):
            s.process(pcm[:, i:i + 3000])
        sess[name] = s
    np.testing.assert_array_equal(sess["cuda"].ctc_prev, sess["cpu"].ctc_prev)
    for s in range(2):
        assert sess["cuda"].get_tokens(s) == sess["cpu"].get_tokens(s)
    assert any(sess["cpu"].get_tokens(s) for s in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rnnt", "tdt", "hybrid"])
def test_train_step_on_card_equals_cpu(card, kind):
    """One train step at constant lr 3e-4 on the tiny model (chunked
    attention, warm-up history; the CTC term for the hybrid): the loss
    within 1e-5 of the CPU's, every leaf's gradient within 1e-4 of its
    largest |g| (the CPU tests' bound against JAX), and the loss at the
    updated parameters within 1e-5. (The updated parameters themselves
    are not compared element by element: Adam's first step moves a
    weight by lr g / (|g| + eps), so a gradient of order eps, where the
    two devices' sums differ in sign, moves it either way.) None of the
    port's three CUDA kernels launches."""
    from nemotron_tpu_torch.ops.quant_kernel import q8_matmul
    from nemotron_tpu_torch.ops.ring_attn_kernel import fused_ring_attention
    from nemotron_tpu_torch.ops.w8a8_kernel import w8a8_matmul

    cfg = tiny_config(tdt_durations=(0, 1, 2, 3) if kind == "tdt" else None)
    arrays = tparams.random_weight_arrays(cfg, seed=0,
                                          ctc_head=kind == "hybrid")
    r = np.random.default_rng(0)
    b = {"mel": r.standard_normal((2, 41, cfg.n_mels)).astype(np.float32),
         "labels": r.integers(0, 40, (2, 3)), "mel_lengths": [6, 5],
         "label_lengths": [3, 2], "history": r.integers(0, 40, (2, 4))}
    kw = dict(att_chunk=2, ctc_weight=0.3 if kind == "hybrid" else 0.0)
    counts = (q8_matmul.launches, w8a8_matmul.launches,
              fused_ring_attention.launches)
    out = {}
    for name, params in on_both(arrays, cfg, card).items():
        params = ttrain.trainable(params)
        opt, sched = ttrain.make_optimizer(params, 3e-4)
        loss = float(ttrain.make_train_step(cfg, opt, sched, **kw)(params, b))
        grads = {k: (v.grad.cpu().numpy() if v.grad is not None else None)
                 for k, v in tparams.flatten(params).items()}
        with torch.no_grad():
            after = float(ttrain.loss_fn(params, cfg, b, **kw))
        out[name] = (loss, grads, after)
    assert counts == (q8_matmul.launches, w8a8_matmul.launches,
                      fused_ring_attention.launches)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-5)
    assert out["cpu"][2] < out["cpu"][0]
    for k, g in out["cpu"][1].items():
        scale = max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(out["cuda"][1][k], g, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
