"""The plain references against small hand-checked cases, and against
torch.nn where that is the independent witness."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks.reference import crop, frame, gpg, pointnet, scoring
from benchmarks.reference import train as ref_train

GRIPPER = {"hand_height": 0.03, "finger_width": 0.0255, "hand_depth": 0.125,
           "hand_outer_diameter": 0.218}


def test_fma_rounds_once():
    a = torch.tensor(1.0 + 2.0 ** -12)
    prod = a * a                         # 1 + 2**-11, the 2**-24 lost
    assert float(prod) == 1.0 + 2.0 ** -11
    assert float(crop.fma(a, a, -prod)) == 2.0 ** -24


def test_to_tf32_keeps_ten_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 3.0])
    got = pointnet.to_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0, 3.0]


def test_crop_window_and_replacement():
    # grasp at the origin, identity axes; box x in (0, 1), |y| < 1, |z| < 1
    pts = torch.tensor([[0.5, 0, 0], [2.0, 0, 0], [0.1, 0.2, 0],
                        [0.9, -0.5, 0.5], [0.3, 0, 0]])
    frames = torch.eye(3)[None]
    lo = torch.tensor([[0.0, -1, -1]])
    hi = torch.tensor([[1.0, 1, 1]])
    # four points inside (rows 0, 2, 3, 4); take 2 by the window from rank
    # index 3: ranks 4 and 1 -> rows 4 and 0
    pts_out, count, valid = crop.crop(
        pts, torch.zeros(1, 3), frames, lo, hi,
        lambda c: (torch.zeros(1, 2, dtype=torch.long),
                   torch.tensor([[3]])), 2, 1)
    assert count.tolist() == [4] and valid.tolist() == [True]
    assert pts_out[0].tolist() == [pts[4].tolist(), pts[0].tolist()]
    # fewer inside than asked: ranks drawn with replacement
    pts_out, count, _ = crop.crop(
        pts, torch.zeros(1, 3), frames, lo, hi,
        lambda c: (torch.tensor([[2, 2, 0, 1, 3, 0]]),
                   torch.zeros(1, 1, dtype=torch.long)), 6, 1)
    rows = [3, 3, 0, 2, 4, 0]
    assert pts_out[0].tolist() == [pts[r].tolist() for r in rows]
    # too few points: invalid and zero
    _, _, valid = crop.crop(pts, torch.zeros(1, 3), frames, lo, hi,
                            lambda c: (torch.zeros(1, 2, dtype=torch.long),
                                       torch.zeros(1, 1, dtype=torch.long)),
                            2, 5)
    assert valid.tolist() == [False]


def test_voxel_downsample_keeps_first_point_of_each_cell():
    pts = torch.tensor([[0.0, 0, 0], [0.9, 0.9, 0.9], [0.1, 0.1, 0.1],
                        [0.95, 0.95, 0.95]])
    got = frame.voxel_downsample(pts, 2)
    step = np.float32(0.95) * np.float32(0.5)
    lo_c = np.float32(0.5) * step
    hi_c = np.float32(1.5) * step
    assert got.tolist() == [[float(lo_c)] * 3, [float(hi_c)] * 3]


def test_panel_boxes_of_robotiq():
    boxes = frame.panel_boxes(GRIPPER)
    lo, hi = boxes["open"]
    ow = 0.218 - 2 * 0.0255
    assert np.allclose(lo, [0.0, -ow / 2, -0.015])
    assert np.allclose(hi, [0.125, ow / 2, 0.015])
    lo, hi = boxes["left"]
    assert np.allclose([lo[1], hi[1]], [-ow / 2 - 0.0255, -ow / 2])


def test_rule_violations():
    # approach straight down from 0.2 m above the origin
    bc = [0.0, 0.0, 0.2]
    cand = torch.tensor([[bc, [0, 0, -1.0], [0, 1.0, 0], [1.0, 0, 0], bc]])
    inside = torch.tensor([[0.0, 0.005 * i - 0.025, 0.15] for i in range(11)])
    assert frame.rule_violations(inside, cand, GRIPPER,
                                 min_open_points=10) == 0
    assert frame.rule_violations(inside[:10], cand, GRIPPER,
                                 min_open_points=10) == 1
    ow = 0.218 - 2 * 0.0255
    finger = torch.tensor([[0.0, -ow / 2 - 0.01, 0.15]])
    assert frame.rule_violations(torch.cat([inside, finger]), cand, GRIPPER,
                                 min_open_points=10) == 1
    up = cand.clone()
    up[0, 1] = torch.tensor([0, 0, 1.0])
    assert frame.rule_violations(inside, up, GRIPPER,
                                 min_open_points=10) == 1


def _nn_model(params, k):
    """The same network from torch.nn layers (the independent witness)."""
    from torch import nn

    def conv(name, cin, cout):
        m = nn.Conv1d(cin, cout, 1)
        m.weight.data = params[f"{name}.weight"].clone()
        m.bias.data = params[f"{name}.bias"].clone()
        return m

    def lin(name, cin, cout):
        m = nn.Linear(cin, cout)
        m.weight.data = params[f"{name}.weight"].clone()
        m.bias.data = params[f"{name}.bias"].clone()
        return m

    def bn(name, n):
        m = nn.BatchNorm1d(n)
        for key in ("weight", "bias", "running_mean", "running_var"):
            getattr(m, key).data = params[f"{name}.{key}"].clone()
        return m

    def trunk(pre):
        return nn.Sequential(conv(f"{pre}.conv1", 3, 64), bn(f"{pre}.bn1", 64),
                             nn.ReLU(), conv(f"{pre}.conv2", 64, 128),
                             bn(f"{pre}.bn2", 128), nn.ReLU(),
                             conv(f"{pre}.conv3", 128, 1024),
                             bn(f"{pre}.bn3", 1024))

    stn, feat = trunk("feat.stn"), trunk("feat")
    stn_fc = nn.Sequential(lin("feat.stn.fc1", 1024, 512),
                           bn("feat.stn.bn4", 512), nn.ReLU(),
                           lin("feat.stn.fc2", 512, 256),
                           bn("feat.stn.bn5", 256), nn.ReLU(),
                           lin("feat.stn.fc3", 256, 9))
    head = nn.Sequential(lin("fc1", 1024, 512), bn("bn1", 512), nn.ReLU(),
                         lin("fc2", 512, 256), bn("bn2", 256), nn.ReLU(),
                         lin("fc3", 256, k))

    def forward(x):                         # x (B, N, 3)
        xt = x.transpose(1, 2)
        s = torch.relu(stn(xt).amax(dim=2))
        trans = stn_fc(s).reshape(-1, 3, 3) + torch.eye(3)
        g = feat(torch.bmm(x, trans).transpose(1, 2)).amax(dim=2)
        return torch.log_softmax(head(g), dim=-1)

    return forward, [stn, feat, stn_fc, head]


@pytest.mark.parametrize("train", [False, True])
def test_pointnet_matches_torch_nn(train):
    from benchmarks import weights

    cfg = {"k": 3, "input_chann": 3, "trunk_widths": [64, 128, 1024],
           "fc_widths": [512, 256]}
    params = weights.make(cfg, 5, "cpu")
    fwd, mods = _nn_model(params, 3)
    for m in mods:
        m.train(train)
    x = torch.rand((4, 40, 3), generator=torch.Generator().manual_seed(1))
    got = pointnet.forward(params, x, train=train)
    want = fwd(x)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(3)
    p0 = torch.randn(5, generator=g)
    grads = [torch.randn(5, generator=g) for _ in range(3)]
    mine = {"w": p0.clone()}
    m, v = {"w": torch.zeros(5)}, {"w": torch.zeros(5)}
    theirs = p0.clone().requires_grad_(True)
    topt = torch.optim.Adam([theirs], lr=0.005)
    for t, gr in enumerate(grads):
        if t == 2:
            # resumed from torch's own state, as the step after the window
            st = topt.state[theirs]
            mine = {"w": theirs.detach().clone()}
            m, v = {"w": st["exp_avg"].clone()}, {"w": st["exp_avg_sq"]
                                                  .clone()}
        ref_train.adam_step(mine, {"w": gr}, m, v, t + 1, 0.005)
        theirs.grad = gr.clone()
        topt.step()
    assert torch.allclose(mine["w"], theirs.detach(), atol=1e-7)


# reference probabilities of four valid candidates: 0 and 2 vote the best
# class, 1 does not, 3 is a near tie between classes 1 and 2
_PROB = torch.tensor([[0.1, 0.2, 0.7], [0.6, 0.3, 0.1], [0.0, 0.1, 0.9],
                      [0.3, 0.35 + 1e-7, 0.35 - 1e-7]], dtype=torch.float64)


@pytest.mark.parametrize("listed, want", [
    ([2, 0], 0.0),                  # the reference's own ranking
    ([2, 0, 3], 2e-7),              # the near tie voted best: its margin
    ([0, 2], 0.2),                  # out of order by 0.9 - 0.7
    ([2], 0.5),                     # candidate 0 left off: 0.7 - 0.2
    ([2, 0, 1], 0.5),               # candidate 1 listed: 0.6 - 0.1
    ([2, 2, 0], 1.0),               # listed twice
    ([2, 0, 7], 1.0),               # no such candidate
    ([], 0.8),                      # nothing listed: 0.9 - 0.1
], ids=["same", "near_tie", "order", "left_off", "wrong_vote", "twice",
        "unknown", "empty"])
def test_rank_gap(listed, want):
    valid = torch.ones(4, dtype=torch.bool)
    assert scoring.rank_gap(listed, _PROB, valid) == pytest.approx(
        want, abs=1e-12)


def test_rank_gap_holds_an_invalid_crop_out():
    valid = torch.tensor([True, True, False, True])
    assert scoring.rank_gap([0], _PROB, valid) == 0.0
    assert scoring.rank_gap([2, 0], _PROB, valid) == 1.0


def test_rank_orders_good_candidates_by_best_class():
    prob = torch.tensor([[0.1, 0.2, 0.7], [0.6, 0.3, 0.1], [0.0, 0.1, 0.9]])
    pred = prob.argmax(dim=1)
    good, order = scoring.rank(pred, prob, torch.ones(3, dtype=torch.bool))
    assert good.tolist() == [True, False, True]
    assert order[:2].tolist() == [2, 0]


def test_reference_imports_nothing_of_the_program():
    allowed = {"torch", "numpy", "__future__"}
    for path in (Path(crop.__file__).parent).glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:               # within the reference
                    continue
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, (path.name, name)


def test_morton_codes_interleave_x_y_z():
    lo, hi = torch.zeros(3), torch.ones(3)
    pts = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0],
                        [-5.0, -5.0, -5.0]])
    x_bits = sum(1 << (3 * b) for b in range(10))
    assert gpg.morton_codes(pts, lo, hi).tolist() == [
        x_bits, x_bits << 1, x_bits << 2, 0]


def _l_shape(n=21, step=0.005):
    """Points of a top face (z = 0, y >= 0) and a front face (y = 0,
    z <= 0) meeting along the x axis: a box's edge seen from (0, -1, 1)."""
    a = (torch.arange(n) - n // 2).float() * step
    b = torch.arange(n // 2 + 1).float() * step
    top = torch.stack(torch.meshgrid(a, b, torch.zeros(1), indexing="ij"),
                      -1).reshape(-1, 3)
    front = torch.stack(torch.meshgrid(a, torch.zeros(1), -b[1:],
                                       indexing="ij"), -1).reshape(-1, 3)
    return torch.cat([top, front])


def test_seed_frames_on_an_edge_and_a_flat_patch():
    pts = _l_shape()
    edge = int(torch.nonzero((pts.abs() < 1e-9).all(1))[0])
    flat = int(torch.argmin(((pts - torch.tensor([0.0, 0.025, 0.0])) ** 2)
                            .sum(1)))
    u = torch.zeros(pts.shape[0])
    u[edge], u[flat] = 1.0, 0.5
    seed_ok, seeds, normal, major, minor, ok, firm, _ = gpg.seed_frames(
        pts, pts.shape[0], u, [0.0, -1.0, 1.0], num_seeds=2, above_z=-1.0,
        max_neighbors=40, normal_k=9, window=2048, r_ball=0.2)
    assert seed_ok.all() and ok.all() and firm.all()
    assert seeds[0].tolist() == [0.0, 0.0, 0.0]
    # on the edge the minor axis runs along it, the normal between the faces
    assert abs(float(minor[0, 0])) == pytest.approx(1.0, abs=1e-3)
    assert float(normal[0, 1]) < 0 and float(normal[0, 2]) > 0
    # on the flat top the normal is +z and the minor axis z x e_x = +-y
    assert normal[1].tolist() == pytest.approx([0.0, 0.0, 1.0])
    assert abs(float(minor[1, 1])) == pytest.approx(1.0)
    assert torch.allclose(major, torch.linalg.cross(minor, normal),
                          atol=1e-12)


def test_count_gap_allows_the_first_num_grasps_valid_frames():
    assert gpg.count_gap(40, (45, 47), 40) == 0
    assert gpg.count_gap(22, (20, 23), 40) == 0
    assert gpg.count_gap(11, (20, 23), 40) == 9
    assert gpg.count_gap(30, (20, 23), 40) == 7
    assert gpg.count_gap(20, (45, 47), 40) == 20
