"""Train the shallow-fusion LSTM label LM (models/lm.py) on a Markov tone
grammar, on one CUDA card.

The counterpart of `scripts/train_lm.py`, with its flags and its output:

    python -m nemotron_tpu_torch.train_lm [asr.gguf] [--tones 16]
        [--branch 3] [--grammar-seed 17] [--steps 600] [--batch 64]
        [--seq-len 128] [--input-noise 0.15] [--hidden 48] [--layers 1]
        [--lr 3e-3] [--seed 0] [--save lm.gguf] [--cpu]

The grammar (utils/tones.grammar_transitions) gives each of the tone
labels `branch` legal successors, so its per-token entropy is log(branch)
nats, the LM's floor. The asr.gguf argument (default the tones fixture)
only supplies vocab_size and blank: the LM scores the acoustic model's
label space; it is not trained. Adam (optax.adam's defaults) on the mean
next-label NLL (models/lm.lm_sequence_nll); a held-out NLL at the end.
Runs on the card unless --cpu is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("gguf", nargs="?",
                    default=os.path.join(REPO, "weights", "tones_tiny.gguf"))
    ap.add_argument("--tones", type=int, default=16)
    ap.add_argument("--branch", type=int, default=3)
    ap.add_argument("--grammar-seed", type=int, default=17)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--input-noise", type=float, default=0.15,
                    help="fraction of teacher-forced input labels replaced "
                         "by random ones (targets unchanged): the LM "
                         "conditions on the beam's hypotheses at decode "
                         "time, errors included, and stays calibrated on "
                         "them")
    ap.add_argument("--hidden", type=int, default=48)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from .device import resolve_device
    from .models import lm as lm_mod
    from .params import load_model
    from .utils.tones import grammar_transitions, markov_labels

    dev = resolve_device("cpu" if args.cpu else "cuda")
    _params, cfg, _vocab = load_model(args.gguf, device="cpu",
                                      keep_quantized=False)
    del _params
    blank = cfg.blank_token
    trans = grammar_transitions(args.tones, args.branch, args.grammar_seed)
    print(f"grammar: {args.tones} tones, branch {args.branch} "
          f"(entropy floor {np.log(args.branch):.3f} nats/token); "
          f"LM vocab {cfg.vocab_size}, blank {blank}", file=sys.stderr)

    lm = lm_mod.lm_params_from_arrays(lm_mod.random_lm_arrays(
        cfg.vocab_size, hidden=args.hidden, n_layers=args.layers,
        seed=args.seed, scale=0.08), device=dev)
    leaves = [getattr(lm, f).requires_grad_(True)
              for f in ("embedding", "w_ih", "w_hh", "b_ih", "b_hh",
                        "out_w", "out_b")]
    opt = torch.optim.Adam(leaves, lr=args.lr, betas=(0.9, 0.999), eps=1e-8)

    def batch(rng, input_noise):
        labs = np.stack([markov_labels(rng, args.seq_len, trans)
                         for _ in range(args.batch)]).astype(np.int64)
        lens = np.full(args.batch, args.seq_len, np.int64)
        inputs = np.concatenate(
            [np.full((args.batch, 1), blank, np.int64), labs[:, :-1]],
            axis=1)
        if input_noise > 0:
            flip = rng.random(inputs.shape) < input_noise
            flip[:, 0] = False   # keep <bos>
            inputs = np.where(
                flip, rng.integers(0, args.tones, inputs.shape), inputs)
        return (torch.from_numpy(labs).to(dev), torch.from_numpy(lens).to(dev),
                torch.from_numpy(np.ascontiguousarray(inputs)).to(dev))

    rng = np.random.default_rng(args.seed)
    for step in range(args.steps):
        labels, lengths, inputs = batch(rng, args.input_noise)
        opt.zero_grad(set_to_none=True)
        loss = lm_mod.lm_sequence_nll(lm, labels, lengths, blank, inputs)
        loss.backward()
        opt.step()
        if step % 50 == 0 or step == args.steps - 1:
            print(f"step {step}: nll {float(loss):.4f}", file=sys.stderr)

    # held-out eval: fresh grammar sequences, beside the uniform baseline
    eval_rng = np.random.default_rng(args.seed + 999)
    labels, lengths, _ = batch(eval_rng, 0.0)
    with torch.no_grad():
        nll = float(lm_mod.lm_sequence_nll(lm, labels, lengths, blank))
    uniform = float(np.log(args.tones))
    floor = float(np.log(args.branch))
    print(f"held-out nll {nll:.4f} nats/token "
          f"(uniform {uniform:.3f}, grammar floor ~{floor:.3f})",
          file=sys.stderr)
    if args.save:
        lm_mod.save_lm(args.save, lm_mod.lm_arrays_from_params(lm))
        print(f"saved {args.save}", file=sys.stderr)
    print({"heldout_nll": round(nll, 4), "uniform_nll": round(uniform, 4),
           "floor_nll": round(floor, 4)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
