"""Per-stage conv debugger: diffs every internal stage of the causal
ConvSubsampling and of one conformer conv module between the port's torch
ops and the numpy oracle on the same weights -- the tool for the day a
full-size parity run chases its first off-by-one into the convs. The
counterpart of `scripts/debug_conv_layers.py`:

    python -m nemotron_tpu_torch.scripts.debug_conv_layers <model.gguf>
        [--layer L] [--mel mel.bin] [--cpu]

Each stage is flagged OK below 1e-3; the last line gives the worst stage's
max_abs, and the exit code is 2 when it is 1e-2 or more. Runs on the CUDA
card unless --cpu is given.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ._common import dense_model, device_of, host, positionals


def stat(name, got, want, gate=1e-3):
    got, want = host(got), host(want)
    if got.shape != want.shape:
        print(f"  [SHAPE] {name:34s} torch {got.shape} vs oracle {want.shape}")
        return 1.0
    d = np.abs(got - want)
    flag = "OK " if d.max() < gate else "DIFF"
    print(f"  [{flag}] {name:34s} max_abs {d.max():.3e}  "
          f"mean_abs {d.mean():.3e}  |torch| {np.abs(got).mean():.3e}")
    return float(d.max())


def main(argv: list[str]) -> int:
    args = positionals(argv, ("--layer", "--mel"))
    if not args:
        print(__doc__, file=sys.stderr)
        return 1
    device = device_of("--cpu" in argv)
    layer = 0
    if "--layer" in argv:
        layer = int(argv[argv.index("--layer") + 1])

    from ..ops import conv as tconv
    from ..ops.basic import glu, layer_norm, silu
    from ..oracle import ops as oops
    from ..utils.dump import read_dump

    params, cfg, _vocab, t, _g = dense_model(args[0], device)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if "--mel" in argv:
        mel = read_dump(argv[argv.index("--mel") + 1]).astype(np.float32)
    else:
        mel = (np.random.default_rng(0).standard_normal((48, cfg.n_mels))
               .astype(np.float32) * 2 - 8)
    print(f"model {args[0]}; mel {mel.shape}; conv-module layer {layer}")
    worst = 0.0

    # ---- subsampling, stage by stage ----
    print("conv subsampling stages (causal pad left=k-1, right=stride-1):")
    p = params.subsampling
    ox = mel[:, :, None]
    jx = dev(mel)[None, :, :, None]

    def ostage(x, wname, bname, stride, groups=1):
        return oops.causal_conv2d(x, t[wname], t[bname], stride=stride,
                                  groups=groups)

    C = int(p.conv0_b.shape[0])
    stages = [
        ("conv0 (3x3 s2)", "encoder.pre_encode.conv.0", p.conv0_w, p.conv0_b,
         2, 1, True),
        ("conv2 (3x3 s2 dw)", "encoder.pre_encode.conv.2", p.conv2_w,
         p.conv2_b, 2, C, False),
        ("conv3 (1x1)", "encoder.pre_encode.conv.3", p.conv3_w, p.conv3_b,
         1, 1, True),
        ("conv5 (3x3 s2 dw)", "encoder.pre_encode.conv.5", p.conv5_w,
         p.conv5_b, 2, C, False),
        ("conv6 (1x1)", "encoder.pre_encode.conv.6", p.conv6_w, p.conv6_b,
         1, 1, True),
    ]
    for name, oname, w, b, stride, groups, relu in stages:
        ox = ostage(ox, f"{oname}.weight", f"{oname}.bias", stride, groups)
        jx = tconv.causal_conv2d(jx, w, b, stride=stride, groups=groups)
        if relu:
            ox = oops.relu(ox)
            jx = torch.relu(jx)
        worst = max(worst, stat(name, jx[0], ox))

    Tp, Fp, Cc = ox.shape
    oflat = ox.transpose(0, 2, 1).reshape(Tp, Cc * Fp)
    jflat = jx.transpose(2, 3).reshape(1, Tp, Cc * Fp)
    worst = max(worst, stat("flatten (c*F'+f)", jflat[0], oflat))
    oout = oops.linear(oflat, t["encoder.pre_encode.out.weight"],
                       t["encoder.pre_encode.out.bias"])
    jout = jflat @ p.out_w + p.out_b
    worst = max(worst, stat("out linear", jout[0], oout))

    # ---- conformer conv module internals for one layer ----
    print(f"conformer conv module internals (layer {layer}):")
    pre = f"encoder.layers.{layer}.conv"
    lp = params.layers.layer(layer)
    D = cfg.d_model
    x = (np.random.default_rng(1).standard_normal((12, D)) * 0.5
         ).astype(np.float32)

    pw1 = t[f"{pre}.pointwise_conv1.weight"]
    pw1 = pw1.squeeze(2) if pw1.ndim == 3 else pw1
    o_cur = oops.glu(oops.linear(x, pw1))
    j_cur = glu(dev(x)[None] @ lp.conv_pw1_w)
    worst = max(worst, stat("pw1 + GLU", j_cur[0], o_cur))

    dw = t[f"{pre}.depthwise_conv.weight"]
    w_kd = dw.squeeze(1).T if dw.ndim == 3 else dw
    o_cur = oops.causal_conv1d_depthwise(o_cur, w_kd, None)
    j_cur, _ = tconv.depthwise_conv1d(j_cur, lp.conv_dw_w, None)
    worst = max(worst, stat("causal depthwise conv1d", j_cur[0], o_cur))

    o_cur = oops.layer_norm(o_cur, t[f"{pre}.batch_norm.weight"],
                            t[f"{pre}.batch_norm.bias"])
    j_cur = layer_norm(j_cur, lp.conv_ln_w, lp.conv_ln_b)
    worst = max(worst, stat("layer norm", j_cur[0], o_cur))

    o_cur = oops.silu(o_cur)
    j_cur = silu(j_cur)
    worst = max(worst, stat("SiLU", j_cur[0], o_cur))

    pw2 = t[f"{pre}.pointwise_conv2.weight"]
    pw2 = pw2.squeeze(2) if pw2.ndim == 3 else pw2
    o_cur = oops.linear(o_cur, pw2)
    j_cur = j_cur @ lp.conv_pw2_w
    worst = max(worst, stat("pw2", j_cur[0], o_cur))

    print(f"worst stage max_abs: {worst:.3e}")
    return 0 if worst < 1e-2 else 2


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
