"""The benchmark's operation and byte counts against counts by hand."""

import pytest

from portbench.harness import core, flops, peaks

MANIFEST = core.load_manifest()


def _cfg(name):
    cfg = core.load_config(MANIFEST, name)
    return cfg, core.load_arch(cfg["arch"])


def test_cnn_ae_flops_by_hand():
    cfg, arch = _cfg("cnn_ae_224")
    # conv 7x7x3->64 to 112x112, 3x3x64->64 to 28x28 and to 7x7, Dense
    # 4x4x64 -> 200
    enc = 112 * 112 * 3 * 64 * 49 + 28 * 28 * 64 * 64 * 9 \
        + 7 * 7 * 64 * 64 * 9 + 1024 * 200
    # Dense 200 -> 7x7x64, then deconvs from 7, 14, 28, 56 and 112 px
    dec = 200 * 3136 + 16 * (7 * 7 * 64 * 64 + 14 * 14 * 64 * 64
                             + 28 * 28 * 64 * 32 + 56 * 56 * 32 * 16
                             + 112 * 112 * 16 * 3)
    assert flops.encode_flops(arch, cfg) == 2 * enc == 297_852_928
    assert flops.sample_flops(arch, cfg, False) == 2 * (enc + dec)
    # forward, weight gradient, input gradient but for the first conv
    first = 112 * 112 * 3 * 64 * 49
    assert flops.sample_flops(arch, cfg, True) == \
        2 * (3 * (enc + dec) - first)


def test_resnet18_flops_by_hand():
    cfg, arch = _cfg("resnet18_triplet_224x2")
    stem = 112 * 112 * 3 * 64 * 49
    blocks = 4 * 56 * 56 * 64 * 64 * 9
    for w, hw in ((128, 28), (256, 14), (512, 7)):
        blocks += hw * hw * (w // 2) * w * 9 + 3 * hw * hw * w * w * 9 \
            + hw * hw * (w // 2) * w
    one = stem + blocks + 512 * 200
    # ResNet-18 at 224 px: the well-known 1.81 G multiply-adds
    assert 1.80e9 < one < 1.83e9
    assert flops.encode_flops(arch, cfg) == 2 * one
    assert flops.sample_flops(arch, cfg, False) == 3 * 2 * one
    assert flops.sample_flops(arch, cfg, True) == 3 * 2 * (3 * one - stem)


def test_pool_and_gather_bytes_by_hand():
    x = 32 * 112 * 112 * 64
    y = 32 * 56 * 56 * 64
    assert flops.k1f_bytes(32, 112, 112, 64, plane=True) == 4 * x + 5 * y
    assert flops.k1f_bytes(32, 112, 112, 64, plane=False) == 4 * x + 4 * y
    assert flops.k1b_bytes(32, 112, 112, 64) == 5 * y + 4 * x
    assert flops.k1f_bytes(1, 7, 7, 64, plane=False) == 4 * 49 * 64 + \
        4 * 16 * 64
    assert flops.k2_bytes(16, 224 * 224 * 3) == 16 * 150528 * 5 + 16 * 8
    assert flops.bound_s(3.35e12) == pytest.approx(1.0)
    assert flops.bound_s(0, 67e12) == pytest.approx(1.0)
    assert peaks.flops_peak("float32") == 67e12


def test_pool_launches_of_a_pass():
    cfg, arch = _cfg("cnn_ae_224")
    assert arch.pool_inputs(cfg) == [(112, 112, 64), (28, 28, 64),
                                     (7, 7, 64)]
    assert len(flops.pool_launch_bounds(arch, cfg, 32, 3, True)) == 9
    cfg, arch = _cfg("resnet18_triplet_224x2")
    assert arch.pool_inputs(cfg) == [(112, 112, 64)]


def test_roofline_share():
    assert flops.roofline_share([], [1.0]) is None
    assert flops.roofline_share([2.0, 2.0], [1.0, 1.0]) == 50.0
    # a launch the profiler dropped: per launch, mean over mean
    assert flops.roofline_share([2.0], [1.0, 1.0]) == 50.0


def test_epoch_steps():
    # config 1: 20,000 frames in 80 episodes, 19,920 transitions, 3,984
    # validation rows (padded) and 15,936 training rows
    assert flops.step_counts(15936, 3984, 32) == {"train": 498, "eval": 125}
    assert flops.step_counts(10, 0, 32) == {"train": 1, "eval": 0}
