"""Fresh-process checks of the port's CPU square roots (ROADMAP Queue C
item 24).

Torch's CPU ``sqrt``, ``exp``, ``sin`` and the other vector-math functions
call MKL, which detects the CPU on its first call in a process. Threads
that enter that first call together can read the detector's unmapped CPU
code and run the wrong kernel on their share of the tensor. The fault can
show only in a process's first such call, so each check below starts fresh
interpreters, one after another, at 8 torch threads.

    python tools/cpu_roots_probe.py sdf [--runs N] [--tree DIR] [--save DIR]
        the port's mesh_to_sdf(device="cpu") of the 20-object workflow's
        ellipsoid (``synth_meshes``' first object, read back as the prepare
        stage reads it) at sdf_dim 32 in each process; prints a SHA-256 of
        each SDF and how many runs differ from the first. ``--tree``: the
        checkout to import the port from (another commit's, to compare);
        ``--save``: write each SDF there as ``sdf_<run>.npy``.
    python tools/cpu_roots_probe.py roots [--runs N]
        a large elementwise pass, then the first call of ``ops/fp.py``'s
        ``sqrt`` and ``rsqrt`` on 65,536 float32 values (8 threads' shares of
        8,192); prints, per run, how many values differ from numpy's float32
        square root and from the correctly rounded reciprocal root.
    python tools/cpu_roots_probe.py exhaustive
        every positive finite float32 through the CPU routes of ``fp.sqrt``
        (against numpy's float32 root) and ``fp.rsqrt`` (against the exact
        midpoint test; about 2 minutes on 8 cores).
    python tools/cpu_roots_probe.py dispatch
        sets MKL's detected CPU type (a static of libtorch_cpu, found with
        ``nm``) to the raw code a racing thread can read, and prints which
        torch CPU ops then change their result: the ones that call MKL.

Exits 1 when a check finds a difference.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import tempfile
from fractions import Fraction
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
THREADS = 8


def child_sdf(save):
    import torch

    from pointnetgpd_tpu_torch.examples.integrated_workflow import (
        synth_meshes)
    from pointnetgpd_tpu_torch.geometry.mesh import Mesh3D
    from pointnetgpd_tpu_torch.ops import mesh_to_sdf
    from pointnetgpd_tpu_torch.pipelines.prepare_objects import (
        read_ply_mesh)

    torch.set_num_threads(THREADS)
    with tempfile.TemporaryDirectory() as tmp:
        name = synth_meshes(tmp, 1)[0]
        v, f = read_ply_mesh(os.path.join(
            tmp, "PointNetGPD/data/ycb-tools/models/ycb", name,
            "google_512k", "nontextured.ply"))
    mesh = Mesh3D(v, f).remove_bad_tris().remove_unreferenced_vertices()
    data = mesh_to_sdf(mesh, dim=32, device="cpu").data.numpy()
    if save:
        np.save(save, data)
    print("SDF", hashlib.sha256(data.tobytes()).hexdigest(), flush=True)


def root_inputs():
    """65,536 float32 values over 40 binades, and the special ones."""
    rng = np.random.default_rng(0)
    x = np.exp2(rng.uniform(-20, 20, 1 << 16)).astype(np.float32)
    x[:8] = [0.0, -0.0, np.inf, -1.0, np.nan, 1e-45, 1.0, 4.0]
    return x


def reference_roots(x):
    """numpy's float32 root; the correctly rounded reciprocal root (float64
    1 / sqrt, rounded: exact for every float32, ``exhaustive``)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return (np.sqrt(x),
                (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32))


def differ(a, b):
    return int(np.sum((a != b) & ~(np.isnan(a) & np.isnan(b))))


def child_roots():
    import torch

    from pointnetgpd_tpu_torch.ops import fp

    torch.set_num_threads(THREADS)
    a = torch.rand(1 << 15, 2048)
    for _ in range(3):
        a = (a * a + 0.5).amin(dim=1, keepdim=True) + a   # all threads busy
    x = root_inputs()
    s = fp.sqrt(torch.from_numpy(x)).numpy()
    r = fp.rsqrt(torch.from_numpy(x)).numpy()
    want_s, want_r = reference_roots(x)
    print("ROOTS", differ(s, want_s), differ(r, want_r), flush=True)


def run_children(mode, runs, tree, extra=()):
    env = dict(os.environ, PYTHONPATH=str(tree))
    out = []
    for i in range(runs):
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", mode,
             *[a.format(i=i) for a in extra]],
            env=env, cwd=str(tree), capture_output=True, text=True,
            timeout=600)
        tag = mode.upper() + " "
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith(tag)]
        if res.returncode != 0 or not lines:
            sys.exit(f"run {i} failed:\n{res.stdout}\n{res.stderr}")
        out.append(lines[0][len(tag):])
        print(f"run {i}: {out[-1]}", flush=True)
    return out


def exhaustive():
    import torch

    from pointnetgpd_tpu_torch.ops import fp

    torch.set_num_threads(THREADS)
    bad_s = bad_r = border = 0
    step = 1 << 24
    for lo in range(1, 0x7F800000, step):
        x = np.arange(lo, min(lo + step, 0x7F800000),
                      dtype=np.uint32).view(np.float32)
        x64 = x.astype(np.float64)
        bad_s += differ(fp.sqrt(torch.from_numpy(x)).numpy(), np.sqrt(x))
        c = fp.rsqrt(torch.from_numpy(x)).numpy()
        # c is correct iff the midpoints m- < c < m+ to its neighbours
        # bracket x^-1/2: m-^2 x < 1 < m+^2 x (m^2 exact in float64, the
        # product rounded once; products within 2^-50 of 1 exactly)
        c64 = c.astype(np.float64)
        up = (c64 + np.nextafter(c, np.float32(np.inf)).astype(np.float64)) / 2
        dn = (c64 + np.nextafter(c, np.float32(0)).astype(np.float64)) / 2
        ph, pl = up * up * x64, dn * dn * x64
        eps = 2.0 ** -50
        for i in np.nonzero(~((ph > 1 + eps) & (pl < 1 - eps)))[0]:
            border += 1
            xf = Fraction(float(x64[i]))
            if not (Fraction(float(dn[i])) ** 2 * xf < 1
                    < Fraction(float(up[i])) ** 2 * xf):
                bad_r += 1
    n = 0x7F800000 - 1
    print(f"every positive finite float32 ({n:,}): fp.sqrt differs from "
          f"numpy's float32 sqrt on {bad_s}; fp.rsqrt is not the correctly "
          f"rounded value on {bad_r} ({border} products near 1 decided "
          f"exactly); torch {torch.__version__}, "
          f"{torch.backends.cpu.get_cpu_capability()}")
    return bad_s + bad_r == 0


def dispatch():
    import ctypes

    import torch

    torch.set_num_threads(THREADS)
    lib_path = Path(torch.__file__).parent / "lib" / "libtorch_cpu.so"
    lib = ctypes.CDLL(str(lib_path))
    syms = {}
    for line in subprocess.run(["nm", str(lib_path)], capture_output=True,
                               text=True, check=True).stdout.splitlines():
        p = line.split()
        if len(p) == 3:
            syms[p[2]] = int(p[0], 16)
    base = (ctypes.cast(lib.mkl_vml_serv_cpu_detect, ctypes.c_void_p).value
            - syms["mkl_vml_serv_cpu_detect"])
    cell = ctypes.c_int32.from_address(
        base + syms["mkl_vml_serv_cpu_detect.vml_cpu_type"])
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(1e-6, 4e-3, 1 << 15).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1 << 15, 3)).astype(np.float32))
    ops = {
        "torch.sqrt float32": lambda: torch.sqrt(x),
        "Tensor.sqrt float32": lambda: x.sqrt(),
        "Tensor.pow(0.5) float32": lambda: x.pow(0.5),
        "torch.sqrt float64": lambda: torch.sqrt(x.double()),
        "torch.rsqrt float32": lambda: torch.rsqrt(x),
        "torch.rsqrt float64": lambda: torch.rsqrt(x.double()),
        "torch.linalg.norm float32": lambda: torch.linalg.norm(v, dim=-1),
        "Tensor.norm float32": lambda: v.norm(dim=-1),
        "torch.exp float32": lambda: torch.exp(x * 100),
        "torch.sin float64": lambda: torch.sin(x.double() * 100),
        "division float32": lambda: 1 / x,
    }
    # the float64 root rounded to float32: fp.sqrt's CPU route
    ops["float64 root, rounded"] = lambda: torch.sqrt(x.double()).float()
    normal = {k: f().numpy() for k, f in ops.items()}
    detected, raw = cell.value, lib.mkl_serv_vml_cpu_detect()
    cell.value = raw
    try:
        racy = {k: f().numpy() for k, f in ops.items()}
    finally:
        cell.value = detected
    print(f"MKL's detected CPU type {detected}, raw code {raw}; with the "
          f"raw code (torch {torch.__version__}, "
          f"{torch.backends.cpu.get_cpu_capability()}):")
    for k in ops:
        a, b = normal[k].astype(np.float64), racy[k]
        rel = float(np.max(np.abs(a - b) / np.abs(a)))
        print(f"  {k:26s} {int(np.sum(a != b)):6d} of {a.size} values "
              f"change, largest relative change {rel:.3g}")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["sdf", "roots", "exhaustive",
                                     "dispatch"])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)
    if args.mode == "sdf":
        extra = ()
        if args.save:
            os.makedirs(args.save, exist_ok=True)
            extra = (os.path.join(os.path.abspath(args.save),
                                  "sdf_{i}.npy"),)
        hashes = run_children("sdf", args.runs, args.tree, extra)
        n = sum(h != hashes[0] for h in hashes)
        print(f"{n} of {args.runs} runs differ from the first; "
              f"{len(set(hashes))} distinct SDFs")
        return n == 0
    if args.mode == "roots":
        counts = [tuple(map(int, r.split())) for r in
                  run_children("roots", args.runs, args.tree)]
        bad = sum(c != (0, 0) for c in counts)
        print(f"{bad} of {args.runs} runs had a root differ from its "
              f"reference")
        return bad == 0
    sys.path.insert(0, args.tree)
    return exhaustive() if args.mode == "exhaustive" else dispatch()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.path.insert(0, os.getcwd())
        if sys.argv[2] == "sdf":
            child_sdf(sys.argv[3] if len(sys.argv) > 3 else None)
        else:
            child_roots()
    else:
        sys.exit(0 if main() else 1)
