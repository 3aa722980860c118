"""The port's dry run on a mesh (``repro_torch.launch.dryrun`` with a
``LocalMesh`` over ``meta`` devices) against the reference's own
``dryrun.run_cell`` on small meshes of forced host devices.

One subprocess runs the reference on nine smoke cells at (4, 2) and
(1, 1), granite-8b ``train_4k`` also at (2, 4) and at (4, 2) under the
variants ``wgather=1``, ``seqshard=1`` and ``seqshard=1,seqgather=1``.
It compiles one cell at a time on one compute thread (the suite runs
workers side by side), patched inside its own script only:
``jax.make_mesh`` to automatic axes (as ``tests/test_torch_mesh_train.py``
does), ``make_production_mesh`` to the small mesh, ``configs.get_config``
to the smoke configs.  It also lowers three micro-programs and reads
their collectives with ``hlo_analysis.analyze_hlo``.  The port counts
the same cells meanwhile.

* FLOPs: the port's per-device FLOPs on the mesh over its one-card
  (``--mesh card``) FLOPs lie within 10 % of the reference's mesh over
  (1, 1) FLOPs (the two count apart on one device, so ratios are held,
  not counts).
* Collectives: the port's total wire bytes lie within 0.5x-2x of the
  reference's; both are printed by kind.
* Micro-programs, one per kind the plan emits: a weight stored cut over
  ``data`` gathered for a matmul, a row-parallel matmul, a gradient
  reduced over ``data``: the plan's counts and bytes are XLA's exactly.
* Knobs: ``seqshard`` raises both sides' collective bytes, the port's
  in the band of the reference's; ``wgather`` leaves the reference's
  bytes as they are and ``seqgather`` their sum within 1 %, and the port
  takes both as no-ops.

whisper-tiny's smoke position table is made as long as ``train_4k``'s
sequence on both sides (the port raises past it where the reference
clamps, ROADMAP C.18).
"""

import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [
    ("granite-8b", "train_4k", (4, 2)),
    ("granite-8b", "train_4k", (2, 4)),
    ("granite-8b", "prefill_32k", (4, 2)),
    ("granite-8b", "decode_32k", (4, 2)),
    ("mamba2-370m", "train_4k", (4, 2)),
    ("zamba2-2.7b", "train_4k", (4, 2)),
    ("arctic-480b", "train_4k", (4, 2)),
    ("deepseek-v2-lite-16b", "train_4k", (4, 2)),
    ("whisper-tiny", "train_4k", (4, 2)),
    ("internvl2-2b", "train_4k", (4, 2)),
]
IDS = [f"{a}-{s}-{m[0]}x{m[1]}" for a, s, m in CELLS]
RATIO_RTOL = 0.10  # port (mesh / card) against reference (mesh / (1, 1))
WIRE_BAND = (0.5, 2.0)  # port / reference total collective wire bytes
MICRO = ("fsdp_gather", "row_parallel", "grad_reduce")
# the mesh knobs' variants, on granite-8b train_4k at (4, 2)
KNOB_CELL = ("granite-8b", "train_4k", (4, 2))
KNOB_VARIANTS = ("wgather=1", "seqshard=1", "seqshard=1,seqgather=1")
KNOB_RTOL = 0.01  # seqgather: the reference's total against seqshard alone
# the micro-programs' shapes, on a (data=4, model=2) mesh, float32
D, F, B = 64, 32, 8

REFERENCE_SCRIPT = r"""
import json, os, sys
# eight host devices on one compute thread, fixed before the dry run's
# import asks for its own: the suite runs workers side by side
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
jax.devices()
# the reference's meshes were written for automatic axes (see tests/test_torch_mesh_train.py)
if hasattr(jax.sharding, "AxisType"):
    _make_mesh = jax.make_mesh
    jax.make_mesh = lambda shape, axes, **kw: _make_mesh(
        shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes), **kw)
from repro import configs
from repro.launch import dryrun, hlo_analysis
from repro.launch import mesh as mesh_lib

shape = None
mesh_lib.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    shape, ("data", "model"), devices=jax.devices()[:shape[0] * shape[1]])
configs.get_config = lambda a: configs.get_smoke_config(a, **({"max_target": 4097} if a == "whisper-tiny" else {}))
_analyze, _memo = hlo_analysis.analyze_hlo, {}


def analyze_once(hlo):  # run_cell analyses each compiled program twice
    if hlo not in _memo:
        _memo[hlo] = _analyze(hlo)
    return _memo[hlo]


hlo_analysis.analyze_hlo = analyze_once
cells, out_dir, D, F, B = json.loads(sys.argv[1]), sys.argv[2], *map(int, sys.argv[3:6])


out = {"cells": []}
for i, (arch, cell_shape, m, variant) in enumerate(cells):  # one compile at a time
    shape = tuple(m)
    rl = dryrun.run_cell(arch, cell_shape, False, variant, out_dir=os.path.join(out_dir, str(i)))["roofline"]
    out["cells"].append({"cell": [arch, cell_shape, m, variant], "flops": rl["flops"],
                         "bytes": rl["collective_bytes_by_kind"]})

mesh = jax.make_mesh((4, 2), ("data", "model"), devices=jax.devices()[:8])
sh = lambda *spec: NamedSharding(mesh, P(*spec))
f32 = jnp.float32
programs = {
    "fsdp_gather": (lambda x, w: x @ jax.lax.with_sharding_constraint(w, sh(None, "model")),
                    (sh(None, None), sh("data", "model")), None, ((B, D), (D, F))),
    "row_parallel": (lambda z, w: jax.lax.with_sharding_constraint(z @ w, sh("data", None)),
                     (sh("data", "model"), sh("model", None)), None, ((B, F), (F, D))),
    "grad_reduce": (jax.grad(lambda w, x: jnp.sum(jnp.square(x @ w))),
                    (sh("data", None), sh("data", None)), sh("data", None), ((D, F), (B, D))),
}
out["micro"] = {}
for name, (fn, ins, outs, shapes) in programs.items():
    args = [jax.ShapeDtypeStruct(s, f32) for s in shapes]
    hlo = jax.jit(fn, in_shardings=ins, out_shardings=outs).lower(*args).compile().as_text()
    a = _analyze(hlo)
    out["micro"][name] = {"counts": {k: int(v) for k, v in a.collective_counts.items()},
                          "bytes": {k: int(v) for k, v in a.collective_bytes.items()}}
print(json.dumps(out))
"""


def _smoke(arch, **kw):
    return configs.get_smoke_config(arch, **({"max_target": 4097} if arch == "whisper-tiny" else {}), **kw)


@pytest.fixture(scope="module")
def reference_proc(tmp_path_factory):
    """The reference's subprocess, started and not waited for."""
    cells = [[a, s, list(m), "baseline"] for a, s, m in CELLS]
    cells += [[a, s, [1, 1], "baseline"] for a, s in dict.fromkeys((a, s) for a, s, _ in CELLS)]
    cells += [[*KNOB_CELL[:2], list(KNOB_CELL[2]), v] for v in KNOB_VARIANTS]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_SCRIPT, json.dumps(cells),
         str(tmp_path_factory.mktemp("ref_dryrun")), str(D), str(F), str(B)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def port(reference_proc, tmp_path_factory):
    """The port's records of every cell on its mesh and on one card,
    counted while the reference's subprocess runs."""
    out_dir = str(tmp_path_factory.mktemp("port_dryrun"))
    mp = pytest.MonkeyPatch()
    mp.setattr(dryrun.configs, "get_config", _smoke)
    try:
        recs = {}
        for arch, shape, m in CELLS:
            mesh = make_local_mesh(*m, devices=("meta",) * (m[0] * m[1]))
            recs[(arch, shape, m)] = dryrun.run_cell(arch, shape, mesh, out_dir=out_dir)
            if (arch, shape, "card") not in recs:
                recs[(arch, shape, "card")] = dryrun.run_cell(arch, shape, "card", out_dir=out_dir)
        mesh = make_local_mesh(*KNOB_CELL[2], devices=("meta",) * math.prod(KNOB_CELL[2]))
        for v in KNOB_VARIANTS:
            recs[KNOB_CELL + (v,)] = dryrun.run_cell(*KNOB_CELL[:2], mesh, variant=v, out_dir=out_dir)
    finally:
        mp.undo()
    return recs


@pytest.fixture(scope="module")
def reference(reference_proc, port):
    out, err = reference_proc.communicate(timeout=600)
    assert reference_proc.returncode == 0, err[-4000:]
    res = json.loads(out.strip().splitlines()[-1])
    res["cells"] = {(c["cell"][0], c["cell"][1], tuple(c["cell"][2]))
                    + (() if c["cell"][3] == "baseline" else (c["cell"][3],)): c for c in res["cells"]}
    return res


def _gb(by_kind: dict) -> dict:
    return {k: round(v / 1e9, 4) for k, v in sorted(by_kind.items())}


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_per_device_flops_track_the_references_ratio(cell, port, reference):
    arch, shape, _ = cell
    rec = port[cell]
    assert rec["status"] == "ok" and rec["n_chips"] == math.prod(cell[2])
    mine = rec["roofline"]["flops"] / port[(arch, shape, "card")]["roofline"]["flops"]
    ref = reference["cells"][cell]["flops"] / reference["cells"][(arch, shape, (1, 1))]["flops"]
    print(f"{cell}: port mesh/card {mine:.4f}, reference mesh/(1, 1) {ref:.4f}")
    assert abs(mine / ref - 1) <= RATIO_RTOL, (mine, ref)


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_collective_wire_bytes_within_the_band(cell, port, reference):
    rl = port[cell]["roofline"]
    ref = reference["cells"][cell]["bytes"]
    mine, theirs = rl["collective_bytes"], sum(ref.values())
    print(f"{cell}: port {mine / 1e9:.4f} GB {_gb(rl['collective_bytes_by_kind'])}, "
          f"reference {theirs / 1e9:.4f} GB {_gb(ref)}")
    assert WIRE_BAND[0] <= mine / theirs <= WIRE_BAND[1], (mine, theirs)
    assert rl["collective_s"] > 0 and set(rl["collective_bytes_by_axis"]) <= {"data", "model"}
    assert sum(rl["collective_bytes_by_axis"].values()) == mine


def _port_micro(name: str) -> roofline.CollectiveStats:
    """The port's plan of the micro-program ``name`` on (data=4, model=2):
    a module holding the one weight, its per-device program traced on
    ``meta``."""
    mesh = make_local_mesh(4, 2, devices=("meta",) * 8)
    rules = shd.make_rules("train")
    shapes = {"fsdp_gather": ((D, F), ("embed", "mlp"), (B, D)),
              "row_parallel": ((F, D), ("mlp", None), (B // 4, F // 2)),
              "grad_reduce": ((D, F), ("embed", None), (B // 4, D))}
    shape, axes, x_shape = shapes[name]
    spec = shd.spec_for(shape, axes, rules, mesh)
    local = tuple(n // 2 if p == "model" else n for n, p in zip(shape, spec))
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.empty(local, device="meta"), requires_grad=name == "grad_reduce")
    x = torch.empty(x_shape, device="meta")
    split = {"w": tuple(i for i, (g, n) in enumerate(zip(shape, local)) if g != n)}
    forward = (lambda: torch.sum(torch.square(x @ module.w))) if name == "grad_reduce" else (lambda: x @ module.w)
    trace = roofline.trace_collectives(forward, module, split, mesh, rules, backward=name == "grad_reduce")
    nbytes = math.prod(local) * 4
    fsdp = "data" in spec
    grads = {"w": nbytes} if name == "grad_reduce" else None
    return roofline.plan_collectives(trace, mesh.shape, weights={"w": (nbytes, fsdp)}, grads=grads)


@pytest.mark.parametrize("name", MICRO)
def test_micro_program_collectives_are_xlas(name, reference):
    xla = reference["micro"][name]
    mine = _port_micro(name)
    print(f"{name}: port {mine.counts} {mine.bytes_by_kind}, XLA {xla['counts']} {xla['bytes']}")
    if name == "grad_reduce" and "reduce-scatter" not in xla["counts"]:
        # XLA on the CPU lowers the gradient's reduce-scatter as an
        # all-reduce of the whole gradient and a slice: its wire bytes are
        # 2 x the result, the reduce-scatter's the operand, D x F x 4
        assert xla["counts"].get("all-reduce") == 1 and xla["bytes"]["all-reduce"] == 2 * D * F * 4
        assert mine.counts["reduce-scatter"] == 1 and mine.bytes_by_kind["reduce-scatter"] == D * F * 4
        xla = {k: {kind: v for kind, v in xla[k].items() if kind != "all-reduce"} for k in xla}
        mine = roofline.CollectiveStats({k: v for k, v in mine.counts.items() if k != "reduce-scatter"},
                                        {k: v for k, v in mine.bytes_by_kind.items() if k != "reduce-scatter"})
    assert mine.counts == xla["counts"] and mine.bytes_by_kind == xla["bytes"]


@pytest.mark.parametrize("variant", KNOB_VARIANTS)
def test_mesh_knobs_against_the_references(variant, port, reference):
    """The knobs on the reference's own (4, 2) count: ``seqshard`` raises
    its collective bytes and the port's total lies in the band of it;
    ``wgather`` moves none of its bytes and ``seqgather`` (with
    ``seqshard``) keeps their total within 1 %, so the port takes both
    as no-ops (``dryrun.NO_OP_KEYS``) and counts the same as without
    them."""
    ref, ref_base = reference["cells"][KNOB_CELL + (variant,)]["bytes"], reference["cells"][KNOB_CELL]["bytes"]
    rl, base = port[KNOB_CELL + (variant,)]["roofline"], port[KNOB_CELL]["roofline"]
    theirs, mine = sum(ref.values()), rl["collective_bytes"]
    print(f"{variant}: port {mine / 1e9:.4f} GB {_gb(rl['collective_bytes_by_kind'])}, "
          f"reference {theirs / 1e9:.4f} GB {_gb(ref)}")
    assert WIRE_BAND[0] <= mine / theirs <= WIRE_BAND[1], (mine, theirs)
    if variant == "wgather=1":
        assert ref == ref_base
        assert rl["collective_bytes_by_kind"] == base["collective_bytes_by_kind"]
    elif variant == "seqshard=1":
        assert theirs > sum(ref_base.values()) and mine > base["collective_bytes"]
    else:
        seq = reference["cells"][KNOB_CELL + ("seqshard=1",)]["bytes"]
        assert abs(theirs / sum(seq.values()) - 1) <= KNOB_RTOL, (theirs, sum(seq.values()))
        assert rl["collective_bytes_by_kind"] == port[KNOB_CELL + ("seqshard=1",)]["roofline"]["collective_bytes_by_kind"]
