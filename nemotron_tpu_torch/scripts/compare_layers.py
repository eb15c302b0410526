"""Per-stage differential diff: the port's torch model against the numpy
oracle (`nemotron_tpu_torch.oracle`) on the same weights. The
counterpart of `scripts/compare_layers.py`:

    python -m nemotron_tpu_torch.scripts.compare_layers <model.gguf>
        [mel.bin] [--chunks N] [--cpu]

Runs the subsampling, the batch encoder, a decoder step, the joint and
the streaming chunks (R = 13) through both implementations on the same
input (a mel dump from gen_mel, or synthetic mel if omitted) and prints
max-abs / mean-abs / corr per stage, flagged OK below 1e-3. Exit code 2
when the worst streaming chunk differs by 1e-2 or more. Runs on the CUDA
card unless --cpu is given; a quantized GGUF is dequantized, as the
oracle reads it.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ._common import dense_model, device_of, host, positionals


def stat(name, a, b):
    from ..utils.dump import compare

    s = compare(host(a), host(b))
    flag = "OK " if s["max_abs"] < 1e-3 else "DIFF"
    print(f"  [{flag}] {name:28s} max_abs {s['max_abs']:.3e}  "
          f"mean_abs {s['mean_abs']:.3e}  corr {s['corr']:.6f}")
    return s["max_abs"]


def main(argv: list[str]) -> int:
    args = positionals(argv, ("--chunks",))
    if not args:
        print(__doc__, file=sys.stderr)
        return 1
    device = device_of("--cpu" in argv)
    n_chunks = 3
    if "--chunks" in argv:
        n_chunks = int(argv[argv.index("--chunks") + 1])

    from ..config import CacheConfig
    from ..models import decoder as dec_mod
    from ..models import encoder as enc_mod
    from ..ops.conv import conv_subsampling
    from ..ops.lstm import lstm_step
    from ..oracle.model import OracleModel, OracleStream
    from ..utils.dump import read_dump

    params, cfg, _vocab, arrays, _g = dense_model(args[0], device)
    oracle = OracleModel(arrays, cfg)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if len(args) > 1:
        mel = read_dump(args[1]).astype(np.float32)
    else:
        rng = np.random.default_rng(0)
        mel = rng.standard_normal((200, cfg.n_mels)).astype(np.float32) * 2 - 8

    print(f"model {args[0]}: {cfg.n_layers} layers d_model={cfg.d_model}; "
          f"mel {mel.shape}")

    # batch path
    print("batch encoder:")
    want_sub = oracle.conv_subsampling(mel)
    got_sub = conv_subsampling(params.subsampling, dev(mel)[None])[0]
    stat("conv_subsampling", got_sub, want_sub)
    want_enc = oracle.encoder(mel)
    got_enc = enc_mod.encode_batch(params, cfg, dev(mel)[None])[0]
    stat("encoder (all layers)", got_enc, want_enc)

    # decoder + joint on a few frames
    print("decoder/joint:")
    h = np.zeros((cfg.decoder_layers, cfg.decoder_dim), np.float32)
    c = np.zeros_like(h)
    dec_out, h, c = oracle.decoder_step(cfg.blank_token, h, c)
    st = dec_mod.init_decoder_state(cfg, 1, torch.float32, device)
    emb = params.decoder.embedding[st.prev_token.long()]
    got_dec, _, _ = lstm_step(params.decoder, emb, st.h, st.c)
    stat("decoder step", got_dec[0], dec_out)
    want_logits = oracle.joint(want_enc[0], dec_out)
    ep = dec_mod.joint_project_enc(params.joint, dev(want_enc[:1]))
    got_logits = dec_mod.joint_logits(params.joint, ep[0], got_dec)
    stat("joint logits", got_logits[0], want_logits)

    # streaming chunks
    cc = CacheConfig(att_right_context=13, n_mels=cfg.n_mels)
    print(f"streaming chunks (R=13, {n_chunks} chunks):")
    ostream = OracleStream(oracle, cc)
    state = enc_mod.init_encoder_state(cfg, cc, 1, torch.float32, device)
    pos_heads = enc_mod.precompute_pos_heads(params, cfg, cc)
    worst = 0.0
    for i in range(n_chunks):
        chunk = mel[i * cc.shift_mel_frames:][: cc.chunk_mel_frames]
        if chunk.shape[0] < cc.chunk_mel_frames:
            break
        want = ostream.encode_chunk(chunk)
        got, state = enc_mod.encode_chunk(params, cfg, cc, dev(chunk)[None],
                                          state, pos_heads)
        worst = max(worst, stat(f"chunk {i} encoder out", got[0], want))
    return 0 if worst < 1e-2 else 2


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
