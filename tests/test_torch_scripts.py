"""The port's evaluation entry points (`nemotron_tpu_torch/scripts/`)
against the JAX scripts of the same names, on the CPU, with the same
arguments and seeds; the JAX scripts run in this process (loaded by path
from scripts/), so that JAX is imported once.

  - every module, and the numpy oracle that the parity tools import,
    imports neither jax nor nemotron_tpu (a subprocess with both blocked),
    and every entry point asks for the card unless --cpu;
  - greedy_decode(with_iters=True) counts JAX's while_loop trips;
  - token_agreement on random weights: run_config's tokens equal JAX's in
    f32 (dense, int8 and int4 rings), and the harness's summary JSON has
    JAX's keys, the dense-f32 reference's token counts (so the same blank
    bias) and agreements within TOL_AGREEMENT_PCT on the bf16 tiers;
  - compare_outputs (f32 and Q8_0), analyze_streaming, gen_mel,
    export_layer_data, compare_tensors and layer_flamechart: stdout, dumps
    and files equal to the JAX scripts' (the layer dumps within the
    encoder's tolerance).
"""

import dataclasses
import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import tiny_config, write_tiny_gguf
from nemotron_tpu import params as jparams
from nemotron_tpu.ops import quant as jquant

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY_POINTS = ("token_agreement", "compare_outputs", "emission_delay",
                "beam_quality", "lm_quality", "tdt_quality",
                "hybrid_quality", "refine_quality", "analyze_streaming",
                "gen_mel", "export_layer_data", "compare_tensors",
                "layer_flamechart", "compare_layers", "debug_conv_layers",
                "debug_joint_trace", "run_parity", "convert_to_gguf",
                "convert_weights", "bench_engine", "bench_cohorts", "bench",
                "check_regression", "profile_step", "bench_batch",
                "bench_host_budget", "bench_step_variants",
                "bench_multichip", "nemo_reference", "ref_oracle_parity")
# the numpy oracle, which the parity tools import
ORACLE_MODULES = ("nemotron_tpu_torch.oracle",
                  "nemotron_tpu_torch.oracle.ops",
                  "nemotron_tpu_torch.oracle.preprocessor",
                  "nemotron_tpu_torch.oracle.model",
                  "nemotron_tpu_torch.oracle.beam")
# bf16 tiers: the port's and JAX's bf16 rounding points differ (XLA fuses
# and reorders), so a near-tie may flip; agreement in percent, TER in
# percent points
TOL_AGREEMENT_PCT = 10.0
TOL_TER_PCT = 5.0
# the layer dumps: tests/test_torch_dump.py's tolerance for a traced
# session's captures
TOL_DUMP = 5e-5


def jax_script(name: str):
    """scripts/<name>.py loaded as a module (its directory on sys.path,
    where lm_quality and refine_quality import beam_quality from)."""
    d = os.path.join(REPO, "scripts")
    if d not in sys.path:
        sys.path.insert(0, d)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(d, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_script(name: str):
    return importlib.import_module(f"nemotron_tpu_torch.scripts.{name}")


def run_jax(name: str, args: list, capsys, monkeypatch, rc: int = 0) -> str:
    """The JAX script's main over `args` in this process; its stdout. The
    argparse scripts read sys.argv, the others take argv."""
    mod = jax_script(name)
    argv = [f"{name}.py", *args]
    monkeypatch.setattr(sys, "argv", argv)
    capsys.readouterr()
    takes_argv = bool(inspect.signature(mod.main).parameters)
    assert (mod.main(argv) if takes_argv else mod.main()) == rc
    return capsys.readouterr().out


def run_port(name: str, args: list, capsys, rc: int = 0) -> str:
    capsys.readouterr()
    assert port_script(name).main([name, *args]) == rc
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tests' tiny random model with a joint bias on token 5 (so that
    text is emitted) as f32 and Q8_0 GGUFs, and 1.25 s of seeded noise."""
    cfg = tiny_config()
    arrays = jparams.random_weight_arrays(cfg, seed=0)
    arrays["joint.joint_net.2.bias"][5] = 2.0
    d = tmp_path_factory.mktemp("scripts")
    f32 = str(d / "tiny_f32.gguf")
    q8 = str(d / "tiny_q8.gguf")
    write_tiny_gguf(f32, arrays, cfg)
    write_tiny_gguf(q8, arrays, cfg, quantize={
        n: 8 for n, a in arrays.items()
        if jquant.should_quantize(n, a if a.ndim != 3 else a.squeeze())})
    pcm = str(d / "a.pcm")
    (np.random.default_rng(0).standard_normal(20000) * 8000).astype(
        "<i2").tofile(pcm)
    return {"f32": f32, "q8": q8, "pcm": pcm, "dir": d}


# -- the modules' imports and devices -----------------------------------------

BLOCKER = r'''
import importlib, json, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "nemotron_tpu"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
res = {}
for name in sys.argv[2:]:
    try:
        importlib.import_module(name if name.startswith("nemotron_tpu_torch.")
                                else "nemotron_tpu_torch.scripts." + name)
        res[name] = "ok"
    except Exception as e:
        res[name] = repr(e)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "nemotron_tpu")]
print(json.dumps({"modules": res, "loaded": bad}))
'''


@pytest.fixture(scope="module")
def imports_without_jax():
    """Every module of the scripts package imported in one subprocess in
    which jax and nemotron_tpu cannot be imported."""
    r = subprocess.run([sys.executable, "-c", BLOCKER, REPO, "_common",
                        *ENTRY_POINTS, *ORACLE_MODULES],
                       capture_output=True, text=True,
                       timeout=120, env=dict(os.environ,
                                             CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ("_common",) + ENTRY_POINTS + ORACLE_MODULES)
def test_script_imports_no_jax(imports_without_jax, name):
    assert imports_without_jax["modules"][name] == "ok"
    assert imports_without_jax["loaded"] == []


# the fewest arguments that reach each entry point's device choice
MINIMAL_ARGS = {"compare_outputs": ["m.gguf", "a.pcm"],
                "compare_layers": ["m.gguf"], "debug_conv_layers": ["m.gguf"],
                "debug_joint_trace": ["m.gguf"], "run_parity": ["m.gguf"],
                "convert_to_gguf": ["m.nemo", "out.gguf"],
                "convert_weights": ["m.bin", "out.gguf"],
                "gen_mel": ["a.pcm", "out.bin"],
                "export_layer_data": ["m.gguf", "a.pcm", "out"],
                "compare_tensors": ["a.bin", "b.bin"],
                "layer_flamechart": ["m.gguf"],
                "check_regression": ["--run"],
                "nemo_reference": ["m.nemo", "a.pcm"]}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(name):
    """Without --cpu each entry point asks for CUDA, which raises here
    (no card): nothing falls back to the CPU quietly."""
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        port_script(name).main([name, *MINIMAL_ARGS.get(name, [])])


# -- token_agreement ----------------------------------------------------------

AGREEMENT_CFG = dict(n_mels=32, d_model=128, n_heads=8, d_head=16,
                     d_ff=256, n_layers=4, vocab_size=64, decoder_dim=64,
                     joint_dim=64, subsampling_channels=16)


@pytest.mark.parametrize("rings", ["dense", "int8", "int4"])
def test_token_agreement_run_config_matches_jax(rings):
    """run_config (all streams through one StreamSession) in f32 on the
    harness's default model with its blank bias: tokens equal to JAX's,
    at R = 0 and 13, with each ring type."""
    import jax.numpy as jnp

    from nemotron_tpu.config import CacheConfig as JCC
    from nemotron_tpu.config import ModelConfig as JMC
    from nemotron_tpu_torch.config import CacheConfig as TCC
    from nemotron_tpu_torch.config import ModelConfig as TMC
    from nemotron_tpu_torch.params import params_from_arrays

    jta, tta = jax_script("token_agreement"), port_script("token_agreement")
    jcfg, tcfg = JMC(**AGREEMENT_CFG), TMC(**AGREEMENT_CFG)
    arrays = jparams.random_weight_arrays(jcfg, seed=0)
    arrays["joint.joint_net.2.bias"][jcfg.vocab_size - 1] = 0.3
    jp = jparams.params_from_arrays(arrays, jcfg)
    tp = params_from_arrays(arrays, tcfg, device="cpu")
    audio = np.stack([tta.synth_audio(24000, s) for s in range(2)])
    assert np.array_equal(audio, np.stack([jta.synth_audio(24000, s)
                                           for s in range(2)]))
    kw = {"dense": {}, "int8": {"kv_cache_int8": True},
          "int4": {"kv_cache_int4": True}}[rings]
    for R in (0, 13):
        jcc = JCC(att_right_context=R, n_mels=32, **kw)
        tcc = TCC(att_right_context=R, n_mels=32, **kw)
        want = jta.run_config(jp, jcfg, jcc, jnp.float32, audio,
                              jcc.chunk_samples)
        got = tta.run_config(tp, tcfg, tcc, torch.float32, audio,
                             tcc.chunk_samples)
        assert got == want and sum(map(len, want)) > 0


def test_token_agreement_harness_matches_jax(tmp_path, capsys, monkeypatch):
    """The harness on random weights (blank-bias search, SmoothQuant
    calibration, two bf16 configurations): JAX's keys, the same f32
    reference (token counts), agreements within TOL_AGREEMENT_PCT."""
    args = ["--seconds", "2", "--seeds", "1", "--streams", "1", "--modes",
            "13", "--cpu", "--configs", "dense-bf16,w8a8-sq-int8kv-bf16",
            "--blank-bias", "0.3"]
    want = json.loads(run_jax("token_agreement", args, capsys, monkeypatch))
    out = str(tmp_path / "agr.json")
    got = json.loads(run_port("token_agreement", args + ["--json", out],
                              capsys))
    assert json.load(open(out)) == got
    assert sorted(got) == sorted(want) == ["R13/dense-bf16",
                                           "R13/w8a8-sq-int8kv-bf16"]
    for k, w in want.items():
        g = got[k]
        assert sorted(g) == sorted(w)
        assert g["ref_tokens"] == w["ref_tokens"] > 0
        assert abs(g["agreement_pct"] - w["agreement_pct"]) \
            <= TOL_AGREEMENT_PCT, (k, g, w)


# -- greedy_decode(with_iters=): tdt_quality's RNN-T decode work --------------


@pytest.mark.parametrize("bias", [0.0, 40.0])
def test_greedy_decode_iters_match_jax(bias):
    """The loop's trip count equals JAX's while_loop's, plain, with a step
    mask and with valid lengths (bias 40 on a token drives every frame to
    the symbol cap, 0 leaves most frames blank); the tokens and the
    confidences returned beside it are unchanged."""
    import jax.numpy as jnp

    from nemotron_tpu.models import decoder as jdec
    from nemotron_tpu_torch.models import decoder as tdec
    from nemotron_tpu_torch.params import params_from_arrays

    cfg = tiny_config()
    arrays = jparams.random_weight_arrays(cfg, seed=0)
    arrays["joint.joint_net.2.bias"][5] += bias
    jp = jparams.params_from_arrays(arrays, cfg)
    tp = params_from_arrays(arrays, cfg, device="cpu")
    B, T = 3, 7
    enc = np.random.default_rng(3).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    for kw in ({}, {"step_mask": np.array([True, False, True])},
               {"enc_lengths": np.array([7, 2, 5], np.int32)}):
        want = jdec.greedy_decode(jp, cfg, jnp.asarray(enc),
                                  jdec.init_decoder_state(cfg, B),
                                  **{k: jnp.asarray(v) for k, v in kw.items()},
                                  with_iters=True)
        tst = tdec.init_decoder_state(cfg, B, torch.float32, "cpu")
        tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
        got = tdec.greedy_decode(tp, cfg, torch.from_numpy(enc), tst,
                                 with_iters=True, **tkw)
        assert isinstance(got[2], int) and got[2] == int(want[2]) > 0
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        conf = tdec.greedy_decode(tp, cfg, torch.from_numpy(enc), tst,
                                  with_confidence=True, with_iters=True,
                                  **tkw)
        assert conf[3] == got[2]
        np.testing.assert_array_equal(conf[0].numpy(), got[0].numpy())


# -- compare_outputs ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["f32", "q8"])
def test_compare_outputs_matches_jax(tiny, kind, capsys, monkeypatch):
    """Streaming (R = 1) against batch: the four lines equal JAX's, and
    --expect's gate exits 2 on a transcript that is far off in both."""
    args = [tiny[kind], tiny["pcm"], "--right-context", "1", "--cpu"]
    want = run_jax("compare_outputs", args, capsys, monkeypatch)
    got = run_port("compare_outputs", args, capsys)
    assert got == want and "batch-vs-streaming" in got
    expect = tiny["dir"] / "expect.txt"
    expect.write_text("nothing like it at all")
    args += ["--expect", str(expect)]
    assert run_port("compare_outputs", args, capsys, rc=2) == run_jax(
        "compare_outputs", args, capsys, monkeypatch, rc=2)


# -- the dump, mel and model-file tools ---------------------------------------


def test_analyze_streaming_matches_jax(tiny, capsys, monkeypatch):
    for args in ([], [tiny["f32"]]):
        want = run_jax("analyze_streaming", args, capsys, monkeypatch)
        got = run_port("analyze_streaming", [*args, "--cpu"], capsys)
        assert got == want and "PURE_CAUSAL" in got


@pytest.mark.parametrize("with_model", [False, True])
def test_gen_mel_matches_jax(tiny, with_model, capsys, monkeypatch):
    """The mel dump bit-equal to JAX's (the native frontend on the CPU),
    with the Slaney defaults or a model's filterbank (a 128-mel model: the
    JAX script's preprocessor refuses any other; the port's takes the
    filterbank's count, as the 32-mel tiny model shows)."""
    from nemotron_tpu_torch.utils.dump import read_dump

    model = []
    if with_model:
        cfg = dataclasses.replace(tiny_config(), n_mels=128)
        model = [str(tiny["dir"] / "mel128.gguf")]
        write_tiny_gguf(model[0], jparams.random_weight_arrays(cfg, seed=1),
                        cfg)
    a, b = str(tiny["dir"] / "j.mel.bin"), str(tiny["dir"] / "t.mel.bin")
    run_jax("gen_mel", [tiny["pcm"], a, *model], capsys, monkeypatch)
    run_port("gen_mel", [tiny["pcm"], b, *model, "--cpu"], capsys)
    assert read_dump(b).shape == (124, 128)    # 1.25 s, centre-padded
    assert open(a, "rb").read() == open(b, "rb").read()
    if with_model:
        run_port("gen_mel", [tiny["pcm"], b, tiny["f32"], "--cpu"], capsys)
        assert read_dump(b).shape == (124, 32)


@pytest.fixture(scope="module")
def exported(tiny):
    """export_layer_data of the tiny f32 model at R = 1 by both packages:
    their traced sessions' dumps and the .npy files made of them."""
    jdir, tdir = str(tiny["dir"] / "jx"), str(tiny["dir"] / "tx")
    for main, out in ((jax_script("export_layer_data").main, jdir),
                      (port_script("export_layer_data").main, tdir)):
        assert main(["export_layer_data", tiny["f32"], tiny["pcm"], out,
                     "--right-context", "1", "--cpu"]) == 0
    return jdir, tdir


def test_export_layer_data_matches_jax(exported):
    jdir, tdir = exported
    names = sorted(f for f in os.listdir(jdir) if f.endswith(".npy"))
    assert names == sorted(f for f in os.listdir(tdir) if f.endswith(".npy"))
    assert "layer_02_out.npy" in names and "encoder_out.npy" in names
    for n in names:
        want, got = np.load(os.path.join(jdir, n)), np.load(
            os.path.join(tdir, n))
        assert got.shape == want.shape, n
        np.testing.assert_allclose(got, want, atol=TOL_DUMP, err_msg=n)


def test_compare_tensors_matches_jax(exported, capsys, monkeypatch):
    """One pair of dumps and two dump directories (the port's traced
    session against JAX's): the same report line for line."""
    jdir, tdir = (os.path.join(d, "dumps") for d in exported)
    for args in ([os.path.join(jdir, "mel.bin"),
                  os.path.join(tdir, "mel.bin")], [jdir, tdir]):
        want = run_jax("compare_tensors", args, capsys, monkeypatch)
        got = run_port("compare_tensors", [*args, "--cpu"], capsys)
        assert got == want and "max_abs" in got


def test_layer_flamechart_matches_jax(tiny, capsys, monkeypatch):
    a, b = str(tiny["dir"] / "j.html"), str(tiny["dir"] / "t.html")
    want = run_jax("layer_flamechart", [tiny["q8"], a], capsys, monkeypatch)
    got = run_port("layer_flamechart", [tiny["q8"], b, "--cpu"], capsys)
    assert got == want and "tensors" in got
    assert open(a).read() == open(b).read()
