"""The port's CPU square roots give the same bits in every process
(ROADMAP Queue C item 24).

Torch's CPU ``sqrt`` calls MKL, whose first vector-math call in a process
can run a low-accuracy kernel on the share of the threads that enter it
together (11 correct bits for a float32 root): the voxelizer's CPU SDF moved
by up to 1.1e-5 m between runs. Only a process's first call can show it, so
these tests start fresh interpreters (``tools/cpu_roots_probe.py``'s
children), six of each kind at 8 torch threads, all at once. OpenMP waits
passively in them, so that their threads do not spin against the other
test workers; the parent commit's SDF still moved in 5 of 20 such runs.

- the port's ``mesh_to_sdf(device="cpu")`` of the 20-object workflow's
  ellipsoid at sdf_dim 32 hashes the same in every child, and the SDF holds
  against the JAX package's with ``test_torch_voxelizer``'s tolerance;
- right after a large elementwise pass, the first call of every ``ops/fp.py``
  root helper equals its reference bit for bit: numpy's float32 root for
  ``sqrt``, the correctly rounded reciprocal root for ``rsqrt``. JAX's jitted
  CPU ``rsqrt`` (XLA's hardware estimate refined by two Newton steps) is
  within one ulp of it.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

from pointnetgpd_tpu.geometry.mesh import Mesh3D as JMesh3D
from pointnetgpd_tpu_torch.examples.integrated_workflow import synth_meshes
from pointnetgpd_tpu_torch.pipelines.prepare_objects import read_ply_mesh
from test_torch_voxelizer import ATOL, RTOL

jm = importlib.import_module("pointnetgpd_tpu.ops.mesh_to_sdf")

ROOT = Path(__file__).resolve().parents[1]
PROBE = ROOT / "tools" / "cpu_roots_probe.py"
sys.path.insert(0, str(PROBE.parent))
import cpu_roots_probe  # noqa: E402

CHILDREN = 6


def _children(mode, args=lambda i: ()):
    """Run CHILDREN fresh ``--child mode`` processes at once; their tagged
    output lines."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_WAIT_POLICY="passive")
    procs = [subprocess.Popen(
        [sys.executable, str(PROBE), "--child", mode, *args(i)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(CHILDREN)]
    tag, out = mode.upper() + " ", []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        out += [ln[len(tag):] for ln in stdout.splitlines()
                if ln.startswith(tag)]
    assert len(out) == CHILDREN
    return out


def test_cpu_sdf_is_the_same_in_every_process(tmp_path):
    hashes = _children("sdf", lambda i: (str(tmp_path / f"sdf_{i}.npy"),))
    assert len(set(hashes)) == 1, hashes
    got = np.load(tmp_path / "sdf_0.npy")
    name = synth_meshes(str(tmp_path), 1)[0]
    v, f = read_ply_mesh(str(tmp_path / "PointNetGPD/data/ycb-tools/models/"
                             f"ycb/{name}/google_512k/nontextured.ply"))
    want = np.asarray(jm.mesh_to_sdf(
        JMesh3D(v, f).remove_bad_tris().remove_unreferenced_vertices(),
        dim=32).data)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    print(f"largest gap to JAX's SDF {np.abs(got - want).max():.4g} m")


def test_first_roots_of_a_process_are_correctly_rounded():
    assert _children("roots") == ["0 0"] * CHILDREN


def test_rsqrt_is_within_an_ulp_of_jax():
    import torch

    from pointnetgpd_tpu_torch.ops import fp

    x = cpu_roots_probe.root_inputs()[8:]
    got = fp.rsqrt(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.lax.rsqrt)(x))
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    # torch's float32 1 / sqrt(x) is further from JAX than the correctly
    # rounded value
    two = torch.rsqrt(torch.from_numpy(x)).numpy()
    assert np.sum(got != want) < np.sum(two != want)
