"""Interactive database CLI: the dexnet_cli equivalent.

Port of ``pointnetgpd_tpu/cli/dexnet_cli.py``: the same commands, menu and
printed lines, over the port's ``DexNet`` on ``--device`` (the card by
default).

(reference: dex-net/apps/dexnet_cli.py:44-466 — a readline menu over the
DexNet API: open/create database and dataset, add objects from mesh files,
compute grasps + metrics, list/export/display objects, delete, quit.)

Usage: python -m pointnetgpd_tpu_torch.cli.dexnet_cli [--device cpu]
"""

from __future__ import annotations

import sys

from ..api import DexNet


class DexNetCli:
    def __init__(self, device="cuda"):
        self.api = DexNet(device=device)
        self.commands = [
            ("open_database", "Open (or create) a database", self.open_database),
            ("open_dataset", "Open (or create) a dataset", self.open_dataset),
            ("add_object", "Add an object from a mesh file", self.add_object),
            ("list_objects", "List objects in the dataset", self.list_objects),
            ("sample_grasps", "Sample antipodal grasps for an object",
             self.sample_grasps),
            ("compute_grasps",
             "Sample + label grasps (friction ladder + Ferrari-Canny)",
             self.compute_grasps),
            ("show_grasps", "Print stored grasps + metrics", self.show_grasps),
            ("display_object", "Save a 3-D rendering of an object",
             self.display_object),
            ("export_objects", "Export all meshes as OBJ", self.export_objects),
            ("delete_object", "Delete an object", self.delete_object),
            ("quit", "Exit", None),
        ]

    # ------------------------------------------------------------------
    def open_database(self, args):
        path = args[0] if args else input("database path (.hdf5): ").strip()
        self.api.open_database(path)
        print(f"opened {path}: datasets {self.api.database.dataset_names}")

    def open_dataset(self, args):
        name = args[0] if args else input("dataset name: ").strip()
        self.api.open_dataset(name)
        print(f"opened dataset {name} ({self.api.dataset.num_objects} objects)")

    def add_object(self, args):
        path = args[0] if args else input("mesh file (.obj/.off): ").strip()
        key = self.api.add_object(path)
        print(f"added {key}")

    def list_objects(self, args):
        for k in self.api.list_objects():
            print(" ", k)

    def sample_grasps(self, args):
        key = args[0] if args else input("object key: ").strip()
        configs = self.api.sample_grasps(key)
        print(f"sampled {len(configs)} grasps")

    def compute_grasps(self, args):
        key = args[0] if args else input("object key: ").strip()
        rows, counts = self.api.compute_simulation_data(key)
        print(f"stored {len(rows)} labeled grasps; per-class {counts.tolist()}")

    def show_grasps(self, args):
        key = args[0] if args else input("object key: ").strip()
        configs, metrics = self.api.get_grasps(key)
        print(f"{len(configs)} grasps; metrics: {sorted(metrics)}")
        for i, c in enumerate(configs[:10]):
            scores = {m: round(float(v[i]), 4) for m, v in metrics.items()}
            print(f"  [{i}] center={c[:3].round(3).tolist()} {scores}")

    def display_object(self, args):
        key = args[0] if args else input("object key: ").strip()
        out = (args[1] if len(args) > 1 else f"{key}.png")
        fig = self.api.display_object(key)
        fig.savefig(out)
        print(f"wrote {out}")

    def export_objects(self, args):
        out_dir = args[0] if args else input("output dir: ").strip()
        paths = self.api.export_objects(out_dir)
        print(f"exported {len(paths)} meshes")

    def delete_object(self, args):
        key = args[0] if args else input("object key: ").strip()
        self.api.delete_object(key)
        print(f"deleted {key}")

    # ------------------------------------------------------------------
    def run(self, script=None):
        """Interactive loop; ``script`` (list of command lines) for testing."""
        lines = iter(script) if script is not None else None
        while True:
            self._menu()
            try:
                line = next(lines) if lines else input("dexnet> ")
            except (StopIteration, EOFError):
                break
            parts = line.strip().split()
            if not parts:
                continue
            name, args = parts[0], parts[1:]
            if name in ("quit", "q", "exit"):
                break
            handler = {c[0]: c[2] for c in self.commands}.get(name)
            if handler is None:
                print(f"unknown command: {name}")
                continue
            try:
                handler(args)
            except Exception as e:  # interactive tool: report, don't die
                print(f"error: {e}")
        self.api.close_database()

    def _menu(self):
        print("\ncommands:")
        for name, desc, _ in self.commands:
            print(f"  {name:16s} {desc}")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="interactive DexNet database CLI")
    p.add_argument("--device", default="cuda",
                   help="torch device of the compute paths (default: cuda)")
    args = p.parse_args(argv)
    DexNetCli(device=args.device).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
