"""Greedy-decode joint trace: steps the RNN-T label loop frame by frame
through both the port's torch model and the numpy oracle on the same
encoder output, printing per symbol step the decoder and logit
differences, the top logits and the emitted token, and stopping at the
first divergence -- the tool for localizing a greedy mismatch to decoder
vs joint vs argmax tie. The counterpart of `scripts/debug_joint_trace.py`:

    python -m nemotron_tpu_torch.scripts.debug_joint_trace <model.gguf>
        [--frames N] [--seed S] [--cpu]

Ends with "no divergence over N frames" (exit 0) or "FIRST DIVERGENCE at
frame t symbol s" (exit 2). Runs on the CUDA card unless --cpu is given.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ._common import dense_model, device_of, host, positionals


def main(argv: list[str]) -> int:
    args = positionals(argv, ("--frames", "--seed"))
    if not args:
        print(__doc__, file=sys.stderr)
        return 1
    device = device_of("--cpu" in argv)
    frames = 8
    if "--frames" in argv:
        frames = int(argv[argv.index("--frames") + 1])
    seed = 1
    if "--seed" in argv:
        seed = int(argv[argv.index("--seed") + 1])

    from ..config import MAX_SYMBOLS_PER_STEP
    from ..models import decoder as dec_mod
    from ..ops.lstm import lstm_step
    from ..oracle.model import OracleModel

    params, cfg, _vocab, arrays, _g = dense_model(args[0], device)
    oracle = OracleModel(arrays, cfg)

    rng = np.random.default_rng(seed)
    enc = (rng.standard_normal((frames, cfg.d_model)) * 2).astype(np.float32)
    blank = cfg.blank_token

    # oracle state
    oh = np.zeros((cfg.decoder_layers, cfg.decoder_dim), np.float32)
    oc = np.zeros_like(oh)
    oprev = blank
    # torch state
    jst = dec_mod.init_decoder_state(cfg, 1, torch.float32, device)
    enc_proj = dec_mod.joint_project_enc(params.joint,
                                         torch.from_numpy(enc).to(device))

    divergence = None
    for t in range(frames):
        for sym in range(MAX_SYMBOLS_PER_STEP):
            odec, oh2, oc2 = oracle.decoder_step(oprev, oh, oc)
            ologits = oracle.joint(enc[t], odec)
            otok = int(np.argmax(ologits))

            emb = params.decoder.embedding[jst.prev_token.long()]
            jdec, jh2, jc2 = lstm_step(params.decoder, emb, jst.h, jst.c)
            jl = host(dec_mod.joint_logits(params.joint, enc_proj[t][None],
                                           jdec))[0]
            jtok = int(np.argmax(jl))

            top = np.argsort(jl)[-3:][::-1]
            dec_diff = float(np.abs(host(jdec)[0] - odec).max())
            log_diff = float(np.abs(jl - ologits).max())
            mark = "" if jtok == otok else "   <-- TOKEN DIVERGES"
            print(f"frame {t:3d} sym {sym}: tok torch={jtok} oracle={otok} "
                  f"|dec diff {dec_diff:.2e} logit diff {log_diff:.2e} "
                  f"top3 {[(int(i), round(float(jl[i]), 3)) for i in top]}"
                  f"{mark}")
            if jtok != otok and divergence is None:
                divergence = (t, sym)

            if otok == blank or jtok == blank:
                # blank: state frozen, next frame
                # (reference src/nemo-ggml.cpp:1234-1245)
                break
            oprev, oh, oc = otok, oh2, oc2
            jst = dec_mod.DecoderState(
                h=jh2, c=jc2,
                prev_token=torch.tensor([jtok], dtype=torch.int32,
                                        device=device))
        if divergence:
            break

    if divergence:
        print(f"FIRST DIVERGENCE at frame {divergence[0]} "
              f"symbol {divergence[1]}")
        return 2
    print(f"no divergence over {frames} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
