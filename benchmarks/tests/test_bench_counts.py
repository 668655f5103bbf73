"""The work counts against hand-worked values."""

from benchmarks.counts import gpg, peaks, pointnet


def test_trunk_flops_per_point():
    # 2 x (3*64 + 64*128 + 128*1024)
    assert pointnet.trunk_flops_per_point() == 278_912
    assert 2 * pointnet.trunk_flops_per_point() == 557_824


def test_head_flops():
    # 2 x (1024*512 + 512*256 + 256*k)
    assert pointnet.head_flops(3) == 1_312_256
    assert pointnet.head_flops(9) == 1_315_328


def test_forward_flops():
    n = 750
    want = 557_824 * n + 2 * 3 * 3 * n + 1_315_328 + 1_312_256
    assert pointnet.forward_flops(n, 3) == want
    assert pointnet.train_flops(n, 3) == 3 * want
    # the scoring scene: 512 crops of 750 points
    assert 512 * pointnet.forward_flops(750, 3) == 512 * want


def test_gpg_frame_bytes():
    # 1,000 points, 10 frames, 21 + 25 + 1 shifts
    per_scan = 1000 * 12 + 10 * 13 * 4
    assert gpg.frame_bytes(1000, 10, 21, 25) == 3 * per_scan + 10 * 47 * 20


def test_peaks_are_the_data_sheet_figures():
    assert peaks.TF32_FLOPS == 495e12
    assert peaks.FP32_FLOPS == 67e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12
