"""Print the shard shapes of the reference's products in one dry-run cell's
compiled program: each ``dot`` of rank 0's partitioned HLO, its operands' and
result's per-device shapes, grouped by the source line that made it.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/ref_hlo_shards.py \\
        xlstm_1p3b train_4k single [--files chunked.py,xlstm.py] [--layers 8] \\
        [--ops] [--tables]

``--ops`` prints every op's result shape by source line instead of the
dots (a norm's or a conv's width a rank); ``--tables`` prints the
partition tables of the program (its ``s32[devices]`` constants: an offset
a device, the device's slice of a dim, e.g. which model ranks share a head
group), from a dump of the compiled module with its large constants.

The cell is lowered and compiled as ``repro.launch.dryrun.run_cell`` does
(the production mesh on 512 forced host devices, the cell's
``in_shardings``); ``--layers`` cuts the depth (the widths, the mesh and the
layout stay).  What a rank computes of a product is read from its shard
shapes: a head dim whole on every rank of ``model`` where the port's
dry-run finds a site at 16 x its share, or cut 16 ways.  A helper for the
records (``PERF.md``, ``ROADMAP.md``), not a test: it imports the reference
and JAX, and takes minutes for a full-depth cell.
"""

import argparse
import collections
import dataclasses
import os
import pathlib
import re
import sys
import tempfile

if "--tables" in sys.argv:  # the compiled module dumped with its large constants
    _DUMP = tempfile.mkdtemp(prefix="ref_hlo_")
    os.environ["REPRO_EXTRA_XLA_FLAGS"] = (
        f"--xla_dump_to={_DUMP} --xla_dump_large_constants=true "
        + os.environ.get("REPRO_EXTRA_XLA_FLAGS", ""))

from repro.launch import dryrun as D   # forces 512 host devices before jax starts

import jax

from repro import configs as C
from repro.configs.base import SHAPES
from repro.launch.mesh import make_production_mesh, mesh_axes
from repro.parallel import sharding as sh
from repro.runtime import steps

_INSTR = re.compile(r"^\s*(?:ROOT )?(%[\w.\-]+) = (\w+\[[\d,]*\])\S* (\w[\w\-]*)\((.*)$")
_TABLE = re.compile(r"^(\d+) (.*)$")
_FRAME_ID = re.compile(r"stack_frame_id=(\d+)")


def _tables(text: str) -> dict:
    """The module's FileNames, FunctionNames, FileLocations and StackFrames
    tables, each id -> its line."""
    tables, cur = {}, None
    for line in text.splitlines():
        if line in ("FileNames", "FunctionNames", "FileLocations", "StackFrames"):
            cur = tables.setdefault(line, {})
        elif cur is not None and (m := _TABLE.match(line)):
            cur[int(m.group(1))] = m.group(2)
        elif not line.strip() or line.startswith(("HloModule", "%", "ENTRY")):
            cur = None
    return tables


def _stack(tables: dict, frame: int) -> list[tuple[str, str, int]]:
    """(file, function, line) from the innermost frame out."""
    out, seen = [], set()
    while frame and frame not in seen:
        seen.add(frame)
        f = dict(kv.split("=") for kv in tables["StackFrames"][frame].strip("{}").split())
        loc = dict(kv.split("=") for kv in tables["FileLocations"][int(f["file_location_id"])]
                   .strip("{}").split())
        out.append((tables["FileNames"][int(loc["file_name_id"])].strip('"'),
                    tables["FunctionNames"][int(loc["function_name_id"])].strip('"'),
                    int(loc["line"])))
        parent = int(f["parent_frame_id"])
        frame = parent if parent != frame else 0
    return out


def compiled_text(arch: str, shape_name: str, multi_pod: bool, layers: int | None) -> str:
    cfg = D.production_cfg(C.get_config(arch))
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    sh.set_active_mesh(mesh, mesh_axes(mesh))
    specs = D.input_specs(cfg, shape)
    shards = D.shardings_for(cfg, shape, mesh, specs)
    if shape.kind != "train":
        raise SystemExit("train cells only")
    jitted = jax.jit(steps.make_train_step(cfg, steps.TrainConfig()),
                     in_shardings=(shards["params"], shards["opt_state"], shards["batch"]),
                     out_shardings=(shards["params"], shards["opt_state"], None),
                     donate_argnums=(0, 1))
    return jitted.lower(specs["params"], specs["opt_state"], specs["batch"]).compile().as_text()


def dots(text: str, files: tuple[str, ...]) -> dict:
    """(source file, function, line) -> Counter of 'result <- operands'
    shard shapes of the dots whose innermost frame in ``files`` (any file
    where empty) is that line."""
    shapes, lines = {}, []
    for line in text.splitlines():
        m = _INSTR.match(line)
        if m:
            shapes[m.group(1)] = m.group(2)
            if m.group(3) == "dot":
                lines.append(m)
    tables = _tables(text)
    out: dict = collections.defaultdict(collections.Counter)
    for m in lines:
        operands = re.findall(r"%[\w.\-]+", m.group(4).split(")")[0])
        fid = _FRAME_ID.search(m.group(4))
        where = ("?", "?", 0)
        for file, fn, ln in (_stack(tables, int(fid.group(1))) if fid else []):
            name = file.rsplit("/", 1)[-1]
            if not files or name in files:
                where = (name, fn, ln)
                break
        if files and where[0] == "?":
            continue
        ops = " x ".join(shapes.get(o, "?") for o in operands)
        out[where][f"{m.group(2)} <- {ops}"] += 1
    return out


def ops(text: str, files: tuple[str, ...]) -> dict:
    """(source file, function, line) -> Counter of 'op result-shape' of every
    instruction whose innermost frame in ``files`` is that line."""
    tables = _tables(text)
    out: dict = collections.defaultdict(collections.Counter)
    for line in text.splitlines():
        m = _INSTR.match(line)
        fid = _FRAME_ID.search(m.group(4)) if m else None
        if not fid:
            continue
        for file, fn, ln in _stack(tables, int(fid.group(1))):
            name = file.rsplit("/", 1)[-1]
            if not files or name in files:
                out[(name, fn, ln)][f"{m.group(3)} {m.group(2)}"] += 1
                break
    return out


def partition_tables(dump: str, n_devices: int) -> list[str]:
    """The distinct ``s32[n_devices]`` constants of the dumped train step's
    optimised module, each as its values (the first 32)."""
    files = sorted(pathlib.Path(dump).glob("*jit_train_step*after_optimizations.txt"))
    found = []
    pat = re.compile(rf"s32\[{n_devices}\]\{{0\}} constant\(\{{([0-9, ]*)\}}\)")
    for f in files:
        for m in pat.finditer(f.read_text()):
            vals = m.group(1)
            if vals not in found:
                found.append(vals)
    return found


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("mesh", choices=("single", "multi"))
    ap.add_argument("--files", default="", help="comma-separated source file names")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--ops", action="store_true", help="every op's shape, not the dots")
    ap.add_argument("--tables", action="store_true", help="the partition tables")
    args = ap.parse_args()
    text = compiled_text(args.arch, args.shape, args.mesh == "multi", args.layers)
    files = tuple(f for f in args.files.split(",") if f)
    if args.tables:
        for vals in partition_tables(_DUMP, 512 if args.mesh == "multi" else 256):
            print("  ", ", ".join(vals.split(", ")[:32]), "..")
        return
    if args.ops:
        for (src, fn, line), shapes in sorted(ops(text, files).items()):
            print(f"{src}:{line} {fn}")
            for s, n in shapes.most_common(12):
                print(f"    {n:4d} x {s}")
        return
    for (src, fn, line), shapes in sorted(dots(text, files).items()):
        print(f"{src}:{line} {fn}")
        for s, n in shapes.most_common():
            print(f"    {n:4d} x {s}")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
