"""The yardstick's arithmetic against values counted by hand for one layer
at R = 13 and R = 0 (published widths)."""

from __future__ import annotations

import pytest

from benchmark import roofline as rl

M1 = dict(n_mels=128, d_model=1024, n_heads=8, d_head=128, d_ff=4096,
          n_layers=1, kernel_size=9, vocab_size=1025, decoder_dim=640,
          decoder_layers=2, joint_dim=640, subsampling_channels=256,
          subsampling_factor=8)


@pytest.mark.parametrize("R,want", [
    # subsampling 2 * (9*256*61*65 + 9*256*31*33 + 256^2*31*33
    #   + 9*256*16*17 + 256^2*16*17 + 16*4352*1024) = 336,582,656;
    # one layer over 14 frames: 14 * (2 * (4*1024*4096 + 7*1024^2)
    #   + 6*8*128*84 + 2*9*1024) = 682,766,336
    (13, 336_582_656 + 682_766_336),
    # subsampling 2 * (9*256*9*65 + 9*256*5*33 + 256^2*5*33 + 9*256*3*17
    #   + 256^2*3*17 + 3*4352*1024) = 58,741,248; one frame:
    #   48,234,496 + 6*8*128*71 + 2*9*1024 = 48,689,152
    (0, 58_741_248 + 48_689_152),
])
def test_encoder_flops_one_layer(R, want):
    assert rl.encoder_flops_per_chunk(M1, 1, R) == want


def test_attention_bound_r13_bf16():
    # q_u, k_new, v_new 3*1024*8*14*128*2 = 88,080,384; rings
    # 2*1024*8*84*128*2 = 352,321,536; bias 1024*8*14*98*2 = 22,478,848;
    # scale columns 2*1024*8*84*4 = 5,505,024; out 29,360,128
    nbytes = 88_080_384 + 352_321_536 + 22_478_848 + 5_505_024 + 29_360_128
    got = rl.attention_bound_s(1024, 8, 14, 84, 128, "bfloat16", "bfloat16")
    assert got == pytest.approx(nbytes / 3.35e12, rel=1e-12)


def test_attention_bound_r0_bf16():
    # 12,582,912 + 595,591,168 + 2,359,296 + 9,306,112 + 4,194,304
    nbytes = 624_033_792
    got = rl.attention_bound_s(2048, 8, 1, 71, 128, "bfloat16", "bfloat16")
    assert got == pytest.approx(nbytes / 3.35e12, rel=1e-12)


def test_attention_bound_int8_rings_halve_the_ring_bytes():
    dense = rl.attention_bound_s(2048, 8, 1, 71, 128, "bfloat16", "bfloat16")
    int8 = rl.attention_bound_s(2048, 8, 1, 71, 128, "bfloat16", "int8")
    assert (dense - int8) * 3.35e12 == pytest.approx(595_591_168 / 2)


@pytest.mark.parametrize("M,w,want", [
    # 2*14336*1024*4096 operations at 989 T (bf16) and 1979 T (int8)
    (14336, "bfloat16", 120_259_084_288 / 989e12),
    (14336, "int8", 120_259_084_288 / 1979e12),
    (2048, "bfloat16", 17_179_869_184 / 989e12),
])
def test_matmul_bound_is_compute_bound_at_these_rows(M, w, want):
    assert rl.matmul_bound_s(M, 1024, 4096, "bfloat16", w) == \
        pytest.approx(want, rel=1e-12)


def test_matmul_bound_small_m_is_bytes_bound():
    # M = 8: 8*1024*2 + 1024*4096*2 + 8*4096*2 bytes
    want = (16_384 + 8_388_608 + 65_536) / 3.35e12
    assert rl.matmul_bound_s(8, 1024, 4096, "bfloat16", "bfloat16") == \
        pytest.approx(want, rel=1e-12)


def test_decoder_flops():
    # 14 frames, 4 labels: 14*2*1024*640 + 4*(2*2*2*640*2560 + 2*640*640)
    # + 18*2*640*1025
    want = 18_350_080 + 4 * (13_107_200 + 819_200) + 23_616_000
    assert rl.decoder_flops(M1, 14, 4) == want
