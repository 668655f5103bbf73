"""The labeling cell on the CPU at small sizes: a run traced and untraced
reports every metric of the cell and is ``correct`` under the committed
limits; each planted fault fails the number it is meant to fail, the
bfloat16 control fails a limit and the float32 witness none; a program
whose ladder is altered, or whose approach angle is not the first free one,
is caught; the reference finds a sphere's contacts where geometry puts
them."""

import math

import pytest
import torch

from benchmarks import calibrate, run
from benchmarks.counts import label as counts
from benchmarks.kinds import label as kind
from benchmarks.reference import label as ref

BENCH = run.read_json(run.ROOT / "BENCHMARK.json")
NAME = "pointnetgpd-1v-2class.label-torus"
TINY = dict(sdf_dim=24, num_attempts=32, objects=2, check_units=2,
            trace_units=2)
# enough labeled grasps a unit (about 100) that dropping half of them shows
SMALL = dict(sdf_dim=40, num_attempts=256, objects=2, check_units=2)
LIMITS = run.read_json(run.HERE / "limits" / f"{NAME}.json")
FAULT_NUMBER = {"rung_down": "label_gap", "half_dropped": "yield_gap",
                "flipped_normals": "rule_violations"}


@pytest.mark.parametrize("trace", [False, True])
def test_label_cell_on_the_cpu(trace):
    out = run.run_cell(BENCH, NAME, 2 ** 32 + 5, 0.3, trace, device="cpu",
                       overrides=TINY)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(LIMITS)
    want = {"label.yield", "mfu.label", "device_idle.label"} if trace \
        else {"labeled_grasps_per_s", "setup_s"}
    assert set(out["metrics"]) == want
    if trace:
        assert 0 < out["metrics"]["label.yield"]["value"] <= 1


def _readings(mode, seed=2 ** 31 + 43):
    return calibrate.readings(NAME, seed, mode, 0.5, "cpu",
                              SMALL)["numbers"]


def _fails(got):
    return [k for k, v in got.items() if v > LIMITS[k]]


@pytest.mark.parametrize("fault", sorted(FAULT_NUMBER))
def test_each_planted_fault_fails_its_own_number(fault):
    got = _readings(f"fault:{fault}")
    assert FAULT_NUMBER[fault] in _fails(got), got


def test_the_bfloat16_control_fails_a_limit():
    got = _readings("control")
    assert _fails(got), got


def test_the_float32_witness_meets_every_limit():
    """The reference in the program's own precision rounds otherwise than
    the program and is right: no limit may fail it."""
    assert not _fails(_readings("fault:float32"))


def test_an_unknown_fault_is_refused():
    with pytest.raises(ValueError, match="unknown fault"):
        calibrate.readings(NAME, 1, "fault:nothing", 0.0, "cpu", TINY)


def test_a_program_whose_ladder_slips_a_rung_is_caught(monkeypatch):
    from pointnetgpd_tpu_torch.grasping import evaluation

    labels = evaluation.friction_boundary_labels

    def slipped(*a, **kw):
        fc, idx, ok = labels(*a, **kw)
        return fc, torch.where(ok, (idx + 1).clamp(max=2), idx), ok
    monkeypatch.setattr(evaluation, "friction_boundary_labels", slipped)
    out = run.run_cell(BENCH, NAME, 2 ** 31 + 47, 0.5, False, device="cpu",
                       overrides=SMALL)
    assert not out["correct"]
    assert out["checks"]["label_gap"]["value"] > LIMITS["label_gap"]


def test_a_program_whose_approach_angle_is_not_the_first_free_is_caught(
        monkeypatch):
    from pointnetgpd_tpu_torch.grasping import samplers

    sample = samplers.antipodal_sample_grasps

    def turned(*a, **kw):
        s = sample(*a, **kw)
        cfg = s.configs.clone()
        cfg[:, 7] = torch.where(cfg[:, 7] == 90.0, -90.0, cfg[:, 7] + 30.0)
        return s._replace(configs=cfg)
    monkeypatch.setattr(samplers, "antipodal_sample_grasps", turned)
    out = run.run_cell(BENCH, NAME, 2 ** 31 + 53, 0.3, False, device="cpu",
                       overrides=TINY)
    assert not out["correct"]
    assert out["checks"]["rule_violations"]["value"] > 0


def _sphere(radius=0.03, dim=40, half=0.045):
    res = 2 * half / (dim - 1)
    axis = -half + res * torch.arange(dim, dtype=torch.float64)
    pts = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1)
    data = (pts.norm(dim=-1) - radius).float()
    return ref.Grid(data, [-half] * 3, res), res


def test_the_reference_finds_analytic_contacts_on_a_sphere():
    g, res = _sphere()
    gen = torch.Generator().manual_seed(3)
    n = 64
    axes = torch.randn(n, 3, generator=gen, dtype=torch.float64)
    axes = axes / axes.norm(dim=1, keepdim=True)
    centers = (torch.rand(n, 3, generator=gen, dtype=torch.float64) - 0.5) \
        * 0.01
    configs = torch.cat([centers, axes,
                         torch.full((n, 1), 0.10, dtype=torch.float64),
                         torch.zeros((n, 3), dtype=torch.float64)], 1)
    found, contacts, normals, tie = ref.close_fingers(g, configs, 48)
    assert bool(found.all()) and not bool(tie.any())
    r = contacts.norm(dim=-1)
    assert float((r - 0.03).abs().max()) < res / 2
    # the plane fit over the 27 sphere points sees a 13-cell sphere through
    # the few that fall within the surface band: radial within 0.25 rad
    cos = (normals * contacts / r[..., None]).sum(-1)
    assert float(cos.min()) > math.cos(0.25)
    assert float(cos.mean()) > 0.99
    # both fingers close towards the centre: the line between the contacts
    # runs along the grasp's axis
    line = contacts[:, 1] - contacts[:, 0]
    assert float(((line * axes).sum(-1) / line.norm(dim=-1)).min()) > 0.999


def test_label_draws_are_keyed_by_seed_unit_and_name():
    a = kind.LabelDraws(2 ** 40 + 1, 3, "cpu")
    b = kind.LabelDraws(2 ** 40 + 1, 3, "cpu")
    assert torch.equal(a.antipodal_flip(16), b.antipodal_flip(16))
    assert torch.equal(a.surface_index(1000, 16), b.surface_index(1000, 16))
    # a second call of one name, another unit, the next round: other draws
    assert not torch.equal(a.antipodal_flip(16), b.antipodal_cone(16)[0])
    c = kind.LabelDraws(2 ** 40 + 1, 4, "cpu")
    assert not torch.equal(c.approach_perm(16, 7),
                           kind.LabelDraws(2 ** 40 + 1, 3, "cpu")
                           .approach_perm(16, 7))
    nxt = a.next_round()
    assert not torch.equal(nxt.antipodal_perturb(8),
                           kind.LabelDraws(2 ** 40 + 1, 3, "cpu")
                           .antipodal_perturb(8))


def test_tori_lie_inside_their_grids_and_off_the_threshold():
    t = dict(objects=3, sdf_dim=24, major_radius_m=[0.020, 0.035],
             minor_radius_m=[0.008, 0.015], margin_m=0.01)
    for data, origin, res in kind.torus_grids(t, 7, "cpu"):
        faces = torch.cat([data[0].flatten(), data[-1].flatten(),
                           data[:, 0].flatten(), data[:, -1].flatten(),
                           data[:, :, 0].flatten(), data[:, :, -1].flatten()])
        assert float(faces.min()) > 0.009
        assert float(data.min()) < 0
        thresh = res * math.sqrt(2) / 2
        gap = (data.double().abs() - thresh).abs()
        assert float(gap.min()) >= 1e-5 * thresh


def test_label_counts_follow_the_mix():
    t = run.read_json(run.HERE / "traffic" / "label-torus.json")
    assert "ladder_samples" not in t     # one count, as the pipeline passes
    per = (29 * 37 + 84 + 81 + 324 + 100) + 4 * 128 * 37 + 3 * 40
    assert counts.unit_flops(t, 3) == 256 * per
