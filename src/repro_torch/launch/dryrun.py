"""Dry run of every (arch × shape) cell on one H100, counted on ``meta``
(the port's twin of ``repro.launch.dryrun``).

For each cell this entry point:

  1. builds the model, the optimizer state, the batch and the decode
     cache on the ``meta`` device through ``launch.specs`` (nothing is
     allocated, no card is needed),
  2. runs the cell's step once under ``op_analysis.OpCounter``: the train
     step (``specs.make_train_step`` with the reference's ``GRAD_ACCUM``
     and its bf16 optimizer state for llama3-405b and arctic-480b), the
     prefill, or one decode token; the kernel wrappers take their
     ``meta`` route and count by their own formulas,
  3. records the argument, output and temp bytes (the counter's
     high-water mark of live bytes), whether they fit in the card's
     memory, the per-op profile and ``roofline.analyze``'s three terms,
  4. writes one JSON record under ``experiments/dryrun_torch/``.

The reference lowers each cell onto a 16 × 16 or 2 × 16 × 16 TPU mesh;
here ``--mesh card`` is one card, and ``--mesh single|multi|both`` raise
until sharded training state (ROADMAP A.7b) and the mesh dry run (A.8b)
exist.  ``xla_cost_analysis``, ``compile_s`` and ``hlo_bytes`` have no
twin: nothing is compiled (``trace_s`` is the counted run's wall time).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-370m --shape train_4k \\
      --variant remat=dots,accum=4
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch.launch import op_analysis, roofline, specs
from repro_torch.launch import train as train_lib
from repro_torch.models import model_api
from repro_torch.optim import adamw

OUT_DIR = "experiments/dryrun_torch"
MESHES = ("card", "single", "multi", "both")
BF16_STATE_ARCHS = ("llama3-405b", "arctic-480b")
# variant keys that need a device mesh
_MESH_KEYS = ("gshard", "wgather", "lean", "seqshard", "seqgather")


def _needs_mesh(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs a device mesh: sharded training state (ROADMAP A.7b) and the mesh "
        "dry run with its collective term (ROADMAP A.8b) are not ported yet; use --mesh card"
    )


def _apply_variant(cfg, variant: str):
    """Parse 'key=val,key=val' hillclimb variants into config overrides."""
    extras = {"accum": None, "gdtype": torch.float32}
    if not variant or variant == "baseline":
        return cfg, extras
    overrides = {}
    for kv in variant.split(","):
        k, v = kv.split("=")
        if k in _MESH_KEYS:
            raise _needs_mesh(f"variant key {k!r}")
        if k == "remat":
            overrides["remat_policy"] = v
        elif k == "accum":
            extras["accum"] = int(v)
        elif k == "gdtype":
            extras["gdtype"] = {"bf16": torch.bfloat16, "f32": torch.float32}[v]
        elif k == "block_k":
            overrides["block_k"] = int(v)
        elif k == "chunk":
            overrides["chunk"] = int(v)
        elif k == "group":
            overrides["router_group"] = int(v)
        elif k == "capacity":
            overrides["capacity_factor"] = float(v)
        else:
            raise ValueError(f"unknown variant key {k!r}")
    return dataclasses.replace(cfg, **overrides), extras


def _storage_bytes(tree) -> dict[int, int]:
    """Bytes of each distinct storage among the tensors of ``tree``."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def _step(cfg, arch: str, shape: str, extras: dict, record: dict):
    """The cell's step and its arguments, built on ``meta``."""
    info = specs.SHAPES[shape]
    model = specs.abstract_model(cfg)
    batch = specs.input_specs(cfg, shape)
    if info["mode"] == "train":
        model.requires_grad_(True)
        opt_cfg = adamw.AdamWConfig(
            state_dtype=torch.bfloat16 if arch in BF16_STATE_ARCHS else torch.float32
        )
        # one card is one data-parallel rank: a microbatch of at least one row
        n_micro = min(extras["accum"] or specs.GRAD_ACCUM.get(arch, 1), info["global_batch"])
        record["n_micro"] = n_micro
        step = specs.make_train_step(cfg, opt_cfg, n_micro=n_micro, grad_dtype=extras["gdtype"])
        return step, (model, specs.opt_specs(opt_cfg, train_lib.trainable(model)), batch)
    step = specs.make_serve_step(cfg, shape)
    if info["mode"] == "prefill":
        return step, (model, batch)
    cache = model.init_cache(info["global_batch"], info["seq_len"])
    return step, (model, cache, batch["tokens"])


def run_cell(
    arch: str,
    shape: str,
    mesh: str = "card",
    variant: str = "baseline",
    out_dir: str = OUT_DIR,
) -> dict:
    if mesh != "card":
        raise _needs_mesh(f"--mesh {mesh}")
    t0 = time.perf_counter()
    cfg = configs.get_config(arch)
    cfg, extras = _apply_variant(cfg, variant)
    ok, why = specs.shape_applicable(cfg, shape)
    record = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh,
        "variant": variant,
        "status": "skipped" if not ok else "pending",
    }
    if not ok:
        record["skip_reason"] = why
        _write(record, out_dir)
        return record

    info = specs.SHAPES[shape]
    mode = info["mode"]
    n_tokens = info["global_batch"] * (info["seq_len"] if mode != "decode" else 1)
    model_flops_total = model_api.model_flops_per_token(cfg, train=(mode == "train")) * n_tokens

    step, args = _step(cfg, arch, shape, extras, record)
    # the model as its parameters and buffers, the rest as they are
    arg_tree = (list(args[0].parameters()), list(args[0].buffers()), args[1:])
    arguments = _storage_bytes(arg_tree)
    grad = torch.enable_grad() if mode == "train" else torch.no_grad()
    with grad, op_analysis.OpCounter() as counter:
        out = step(*args)
    trace_s = time.perf_counter() - t0
    a = counter.analysis
    outputs = {k: n for k, n in _storage_bytes(out).items() if k not in arguments}
    arg_bytes, temp = sum(arguments.values()), a.peak_live_bytes
    record["memory_analysis"] = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": sum(outputs.values()),
        "temp_size_in_bytes": temp,
    }
    record["device_memory_bytes"] = roofline.DEVICE_MEMORY_BYTES
    record["fits"] = arg_bytes + temp <= roofline.DEVICE_MEMORY_BYTES
    record["profile_top_flops"] = dict(sorted(a.op_flops.items(), key=lambda kv: -kv[1])[:10])
    record["profile_top_bytes"] = dict(sorted(a.op_bytes.items(), key=lambda kv: -kv[1])[:10])
    rl = roofline.analyze(a, 1, model_flops_total)
    record.update(
        status="ok",
        n_chips=1,
        seq_len=info["seq_len"],
        global_batch=info["global_batch"],
        mode=mode,
        params=int(cfg.num_params()),
        active_params=int(
            cfg.active_params() if hasattr(cfg, "active_params") else cfg.num_params()
        ),
        trace_s=round(trace_s, 2),
        roofline=rl.to_json(),
    )
    record["roofline"]["bottleneck_s"] = max(rl.compute_s, rl.memory_s, rl.collective_s)
    _write(record, out_dir)
    return record


def _path(out_dir: str, arch: str, shape: str, mesh: str, variant: str) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}__{variant}.json")


def _write(record: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = _path(out_dir, record["arch"], record["shape"], record["mesh"], record["variant"])
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def _cell_text(rec: dict) -> str:
    if rec["status"] != "ok":
        return "skipped (full attention)" if "full-attention" in rec.get("skip_reason", "") else rec["status"]
    rl, mem = rec["roofline"], rec["memory_analysis"]
    return (
        f"{rl['bottleneck']} {rl['bottleneck_s']:.4g} s (c {rl['compute_s']:.4g} / m "
        f"{rl['memory_s']:.4g}), u {rl['useful_flops_ratio']:.3f}, "
        f"{mem['argument_size_in_bytes'] / 1e9:.4g} + {mem['temp_size_in_bytes'] / 1e9:.4g} GB, "
        + ("fits" if rec["fits"] else "no")
    )


def table(out_dir: str = OUT_DIR, variant: str = "baseline") -> str:
    """A markdown table of the records in ``out_dir``: one row per arch,
    one column per shape; each cell the bottleneck term and seconds, the
    compute (c) / memory (m) seconds, the useful-FLOPs ratio (u),
    argument + temp GB and whether they fit in the card's memory."""
    shapes = list(specs.SHAPES)
    lines = ["| arch | " + " | ".join(shapes) + " |", "| --- " * (len(shapes) + 1) + "|"]
    for arch in configs.arch_names():
        cells = []
        for shape in shapes:
            path = _path(out_dir, arch, shape, "card", variant)
            if os.path.exists(path):
                with open(path) as fh:
                    cells.append(_cell_text(json.load(fh)))
            else:
                cells.append("not run")
        lines.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=MESHES, default="card")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--table", action="store_true", help="print the records in --out as a markdown table")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out, args.variant))
        return
    if args.mesh != "card":
        raise _needs_mesh(f"--mesh {args.mesh}")

    archs = configs.arch_names() if args.all or not args.arch else [args.arch]
    shapes = list(specs.SHAPES) if args.all or not args.shape else [args.shape]
    failures = 0
    for arch in archs:
        for shape in shapes:
            tag = f"{arch} × {shape} × card"
            path = _path(args.out, arch, shape, "card", args.variant)
            if args.skip_existing and os.path.exists(path):
                with contextlib.suppress(OSError, ValueError), open(path) as fh:
                    if json.load(fh).get("status") in ("ok", "skipped"):
                        print(f"[cached] {tag}", flush=True)
                        continue
            try:
                rec = run_cell(arch, shape, "card", args.variant, args.out)
            except Exception:
                failures += 1
                print(f"[FAIL] {tag}\n{traceback.format_exc()}", flush=True)
                continue
            if rec["status"] == "ok":
                rl, mem = rec["roofline"], rec["memory_analysis"]
                print(
                    f"[ok] {tag}: bottleneck={rl['bottleneck']} ({rl['bottleneck_s']:.4f}s), "
                    f"arguments {mem['argument_size_in_bytes'] / 1e9:.2f} GB, temp "
                    f"{mem['temp_size_in_bytes'] / 1e9:.2f} GB, fits={rec['fits']}, "
                    f"trace={rec['trace_s']}s",
                    flush=True,
                )
            else:
                print(f"[skip] {tag}: {rec['skip_reason']}", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
