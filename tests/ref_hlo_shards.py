"""Print the shard shapes of the reference's products in one dry-run cell's
compiled program: each ``dot`` of rank 0's partitioned HLO, its operands' and
result's per-device shapes, grouped by the source line that made it.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/ref_hlo_shards.py \\
        xlstm_1p3b train_4k single [--files chunked.py,xlstm.py] [--layers 8] \\
        [--ops] [--tables] [--collectives]

``--ops`` prints every op's result shape by source line instead of the
dots (a norm's or a conv's width a rank); ``--tables`` prints the
partition tables of the program (its ``s32[devices]`` constants: an offset
a device, the device's slice of a dim, e.g. which model ranks share a head
group), from a dump of the compiled module with its large constants.
``--collectives`` prints rank 0's collectives counted whole
(:func:`whole_collectives`): each ``while`` body times its known trip
count, nested loops multiplied, every ``conditional`` branch and every
called computation (a fusion's ``calls``) counted where it is called, each
op weighted by the reference's own ``_TRAFFIC_W`` and ``_DTYPE_BYTES``;
then the ops by result shape and by source line.  The reference's record
(``repro.launch.dryrun.collective_bytes``) scans the text, so it counts a
loop body once, and its regex skips the tuple-shaped (combined)
all-reduces; both are printed beside the whole count.

The cell (a train, prefill or decode shape) is lowered and compiled as
``repro.launch.dryrun.run_cell`` does (the production mesh on 512 forced
host devices, the cell's ``in_shardings``, and a decode step's cache
``out_shardings``); ``--layers`` cuts the depth (the widths, the mesh and the
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

_COMPUTATION = re.compile(r"^(?:ENTRY )?(%[\w.\-]+) .*\{$")
_COLLECTIVE = re.compile(
    r"^\s*(?:ROOT )?%[\w.\-]+ = (\([^()]*\)|\w+\[[\d,]*\])\S*\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)(-start)?\(")
_SHAPE = re.compile(r"(\w+)\[([\d,]*)\]")
_CALLEE = re.compile(r"\b(condition|body|calls|to_apply|true_computation|false_computation)"
                     r"=(%[\w.\-]+)")
_CALLEES = re.compile(r"\b(?:branch_computations|called_computations)=\{([^}]*)\}")
_TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
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
    if shape.kind == "train":
        jitted = jax.jit(steps.make_train_step(cfg, steps.TrainConfig()),
                         in_shardings=(shards["params"], shards["opt_state"], shards["batch"]),
                         out_shardings=(shards["params"], shards["opt_state"], None),
                         donate_argnums=(0, 1))
        args = (specs["params"], specs["opt_state"], specs["batch"])
    elif shape.kind == "prefill":
        jitted = jax.jit(steps.make_prefill_step(cfg),
                         in_shardings=(shards["params"], shards["batch"]))
        args = (specs["params"], specs["batch"])
    else:
        jitted = jax.jit(steps.make_decode_step(cfg),
                         in_shardings=(shards["params"], shards["tokens"], shards["cache"],
                                       shards["pos"]),
                         out_shardings=(None, shards["cache"]), donate_argnums=(2,))
        args = (specs["params"], specs["tokens"], specs["cache"], specs["pos"])
    return jitted.lower(*args).compile().as_text()


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


def _computations(text: str) -> tuple[dict, str]:
    """The module's computations, name -> its instruction lines, and the
    entry's name."""
    comps, cur, entry = {}, None, None
    for line in text.splitlines():
        m = _COMPUTATION.match(line)
        if m:
            cur = comps.setdefault(m.group(1), [])
            if line.startswith("ENTRY"):
                entry = m.group(1)
        elif line.startswith("}"):
            cur = None
        elif cur is not None:
            cur.append(line)
    if entry is None:
        raise ValueError("no ENTRY computation in the module")
    return comps, entry


def _result_bytes(shape: str) -> int:
    """Bytes of an HLO result shape (a tuple's elements summed), each
    element by the reference's ``_DTYPE_BYTES``."""
    total = 0
    for dtype, dims in _SHAPE.findall(shape):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * D._DTYPE_BYTES.get(dtype, 4)
    return total


def _callees(line: str) -> list[tuple[str, int]]:
    """(computation, times it runs each time ``line`` runs) of every
    computation the instruction calls: a ``while`` body its known trip
    count, the condition once more; anything else once (each ``conditional``
    branch among them).  A ``while`` with no known trip count raises."""
    out = []
    trip = None
    if re.search(r"\swhile\(", line):
        m = _TRIP.search(line)
        if m is None:
            raise ValueError(f"a while loop with no known trip count: {line.strip()[:200]}")
        trip = int(m.group(1))
    for kind, name in _CALLEE.findall(line):
        times = 1
        if trip is not None and kind == "body":
            times = trip
        elif trip is not None and kind == "condition":
            times = trip + 1
        out.append((name, times))
    for names in _CALLEES.findall(line):
        out.extend((n.strip(), 1) for n in names.split(",") if n.strip())
    return out


def whole_collectives(text: str) -> dict:
    """Rank 0's collectives in a compiled module, counted whole: each
    collective instruction times the number of times its computation runs
    (the product of the trip counts of the loops around it).  Returns
    ``{op: result bytes}`` for the reference's five ops,
    ``weighted_link_traffic`` (by ``_TRAFFIC_W``), ``count`` (instructions
    run), ``once`` (the same weighted bytes with each instruction counted
    once, tuple results included), ``regex`` (the reference's own
    ``collective_bytes`` of the text), ``tuples`` (the weighted bytes of
    the tuple-shaped results, counted whole: what the regex misses beside
    the loops) and ``items``: one
    ``(op, result shape, bytes, times run, stack frame id or 0)`` a
    collective instruction."""
    comps, entry = _computations(text)
    items: list = []

    def visit(name: str, times: int, path: tuple) -> None:
        if name in path:
            raise ValueError(f"computation {name} calls itself")
        for line in comps.get(name, ()):
            m = _COLLECTIVE.match(line)
            if m:
                shape, op, start = m.groups()
                if start and shape.startswith("("):
                    raise ValueError(f"an async collective with a tuple result: {line[:200]}")
                fid = _FRAME_ID.search(line)
                items.append((op, shape, _result_bytes(shape), times,
                              int(fid.group(1)) if fid else 0))
            for callee, k in _callees(line):
                visit(callee, times * k, path + (name,))

    visit(entry, 1, ())
    out = {op: 0 for op in D._TRAFFIC_W}
    once = 0.0
    for op, _, b, times, _ in items:
        out[op] += b * times
        once += D._TRAFFIC_W[op] * b
    out["weighted_link_traffic"] = float(sum(D._TRAFFIC_W[op] * out[op] for op in D._TRAFFIC_W))
    out["count"] = sum(t for *_, t, _ in items)
    out["once"] = once
    out["regex"] = D.collective_bytes(text)["weighted_link_traffic"]
    out["tuples"] = float(sum(D._TRAFFIC_W[op] * b * t for op, shape, b, t, _ in items
                              if shape.startswith("(")))
    out["items"] = items
    return out


def print_collectives(text: str, files: tuple[str, ...]) -> None:
    """:func:`whole_collectives`' totals, then the ops by result shape and
    by the innermost source line in ``files`` (any file where empty), each
    with its weighted bytes, largest first."""
    res = whole_collectives(text)
    w = D._TRAFFIC_W
    print(f"whole: {res['weighted_link_traffic']:.4e} weighted link B, {res['count']} "
          f"collectives run; each instruction once: {res['once']:.4e} "
          f"({len(res['items'])} instructions); the reference's regex: {res['regex']:.4e}")
    for op in w:
        print(f"  {op}: {res[op]:.4e} B")
    by_shape: dict = collections.Counter()
    by_line: dict = collections.Counter()
    n_line: dict = collections.Counter()
    tables = _tables(text)
    for op, shape, b, times, fid in res["items"]:
        by_shape[(op, shape)] += w[op] * b * times
        where = "?"
        for file, fn, ln in (_stack(tables, fid) if fid else []):
            name = file.rsplit("/", 1)[-1]
            if not files or name in files:
                where = f"{name}:{ln} {fn}"
                break
        by_line[(op, where)] += w[op] * b * times
        n_line[(op, where)] += times
    print("by result shape:")
    for (op, shape), b in by_shape.most_common(30):
        print(f"  {b:.4e}  {op} {shape}")
    print("by source line:")
    for (op, where), b in by_line.most_common(30):
        print(f"  {b:.4e}  {n_line[(op, where)]:5d} x {op}  {where}")


def summary(arch: str, shape: str, mesh: str, layers: int | None) -> None:
    """One line a supported cell (``all`` for every arch or shape, ``both``
    meshes): the whole count's weighted bytes and collectives run, its
    tuple-shaped share, each instruction once, and the reference's regex."""
    archs = C.ARCH_IDS if arch == "all" else (arch,)
    shapes = tuple(SHAPES) if shape == "all" else (shape,)
    meshes = ("single", "multi") if mesh == "both" else (mesh,)
    print("cell | whole weighted B | collectives run | tuple-shaped | once | regex")
    for a in archs:
        cfg = D.production_cfg(C.get_config(a))
        for s in shapes:
            if not D.cell_supported(cfg, SHAPES[s])[0]:
                continue
            for m in meshes:
                r = whole_collectives(compiled_text(a, s, m == "multi", layers))
                print(f"{a} {s} {m} | {r['weighted_link_traffic']:.4e} | {r['count']} | "
                      f"{r['tuples']:.4e} | {r['once']:.4e} | {r['regex']:.4e}", flush=True)


def partition_tables(dump: str, n_devices: int) -> list[str]:
    """The distinct ``s32[n_devices]`` constants of the dumped step's
    optimised module, each as its values (the first 32)."""
    files = sorted(pathlib.Path(dump).glob("*jit_*_step*after_optimizations.txt"))
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
    ap.add_argument("arch", help="an arch id, or 'all' (with --collectives)")
    ap.add_argument("shape", help="a shape name, or 'all' (with --collectives)")
    ap.add_argument("mesh", choices=("single", "multi", "both"))
    ap.add_argument("--files", default="", help="comma-separated source file names")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--ops", action="store_true", help="every op's shape, not the dots")
    ap.add_argument("--tables", action="store_true", help="the partition tables")
    ap.add_argument("--collectives", action="store_true",
                    help="the collectives counted whole, by op, shape and source line")
    args = ap.parse_args()
    if args.collectives and "all" in (args.arch, args.shape) or args.mesh == "both":
        if not args.collectives:
            ap.error("'all' and 'both' go with --collectives")
        summary(args.arch, args.shape, args.mesh, args.layers)
        return
    text = compiled_text(args.arch, args.shape, args.mesh == "multi", args.layers)
    files = tuple(f for f in args.files.split(",") if f)
    if args.tables:
        for vals in partition_tables(_DUMP, 512 if args.mesh == "multi" else 256):
            print("  ", ", ".join(vals.split(", ")[:32]), "..")
        return
    if args.collectives:
        print_collectives(text, files)
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
