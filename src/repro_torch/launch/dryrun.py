"""Dry run of every (arch × shape) cell on one H100 or on the reference's
16 × 16 and 2 × 16 × 16 meshes of H100s, counted on ``meta`` (the
port's twin of ``repro.launch.dryrun``).

For each cell on one card (``--mesh card``) this entry point:

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

**On a mesh** (``--mesh single``: (data=16, model=16), 256 cards;
``--mesh multi``: (pod=2, data=16, model=16), 512; ``both``) the
parameters, optimizer state, batch and decode cache take the
reference's logical-axis shardings (``sharding.make_rules``), and the
program of mesh position (0, 0) is counted once, never the 256 or 512
of them:

  * its batch is its shard of the global batch (``global_batch /
    (data · pod)`` rows wherever ``spec_for`` keeps the axis), and a
    train step's ``n_micro`` follows the reference's rule (at most the
    per-device rows);
  * tensor parallelism is counted from the specs: the model is built
    from :func:`local_config`, the config with every dim the rules put
    on ``model`` at ``1 / model`` of its width (heads, kv heads, the
    MLP, the vocab, experts, the SSM heads and with them ``d_inner``)
    where ``model`` divides it, whole where it does not (as ``spec_for``
    decides for the dim itself); a Mamba-2's in_proj columns are cut
    whole, its B and C gathered for the conv and the SSD;
  * a train step's optimizer updates the position's parameter tiles,
    the gradients reduce-scattered onto them (``gshard``: each
    microbatch's, summed on the tiles);
  * argument bytes are the shards position (0, 0) stores
    (``tree_shardings`` and ``NamedSharding.shard_shape``), temp bytes
    the counter's high-water mark, and ``fits`` compares their sum with
    the card's 80 GB;
  * the collective term is ``roofline.plan_collectives``'s, from one
    traced microbatch (``roofline.trace_collectives``).

Nothing runs on a card; records are named as the reference's,
``{arch}__{shape}__pod16x16__{variant}.json`` and ``…pod2x16x16…``.
``xla_cost_analysis``, ``compile_s`` and ``hlo_bytes`` have no twin:
nothing is compiled (``trace_s`` is the counted run's wall time).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-370m --shape train_4k \\
      --variant remat=dots,accum=4
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import op_analysis, roofline, specs
from repro_torch.launch import train as train_lib
from repro_torch.launch.mesh import LocalMesh, make_production_mesh
from repro_torch.models import common, mamba2, model_api, moe, zamba
from repro_torch.optim import adamw

OUT_DIR = "experiments/dryrun_torch"
MESHES = ("card", "single", "multi", "both")
MESH_NAMES = {"single": "pod16x16", "multi": "pod2x16x16"}
BF16_STATE_ARCHS = ("llama3-405b", "arctic-480b")
# the variant keys of the reference's knobs fsdp_gather_weights,
# lean_softmax and seq_gather_entry: lean_softmax is read by no model code
# there, and the other two only place constraints that leave the
# reference's own collective bytes unchanged (wgather) or their sum within
# 1 % (seqgather, beside seqshard; tests/test_torch_dryrun_mesh.py), so no
# count here reads them
NO_OP_KEYS = ("wgather", "lean", "seqgather")


def _apply_variant(cfg, variant: str):
    """Parse 'key=val,key=val' hillclimb variants into config overrides.
    The keys of ``NO_OP_KEYS`` parse and change nothing (the record's
    variant name keeps them)."""
    extras = {"accum": None, "gshard": False, "gdtype": torch.float32}
    if not variant or variant == "baseline":
        return cfg, extras
    overrides = {}
    for kv in variant.split(","):
        k, v = kv.split("=")
        if k == "remat":
            overrides["remat_policy"] = v
        elif k == "accum":
            extras["accum"] = int(v)
        elif k == "gshard":
            extras["gshard"] = bool(int(v))
        elif k == "gdtype":
            extras["gdtype"] = {"bf16": torch.bfloat16, "f32": torch.float32}[v]
        elif k == "seqshard":
            overrides["seq_shard"] = bool(int(v))
        elif k in NO_OP_KEYS:
            int(v)  # parsed as the reference parses it, read by nothing
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


# ---------------------------------------------------------------------------
# one mesh position's program
# ---------------------------------------------------------------------------


def _pinned(cfg, values: dict, props: dict):
    """``cfg`` with the fields in ``values`` replaced and the derived
    properties in ``props`` held at the given values (a subclass of the
    config's class, so the family's model takes it as its own)."""
    cls = type(cfg)
    if props:
        cls = type(cls.__name__, (cls,), {k: property(lambda self, v=v: v) for k, v in props.items()})
    return cls(**{**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}, **values})


def _kv_heads(heads: int, kv: int, local_heads: int, local_kv: int) -> int:
    """The kv heads one card computes: cut with the query heads where
    ``model`` divides them, else those its query heads read."""
    if local_kv < kv or local_heads == heads:
        return local_kv
    g = max(1, kv * local_heads // heads)
    while local_heads % g:
        g -= 1
    return g


def local_config(cfg, mesh, rules: shd.Rules):
    """The config one mesh position computes with under tensor
    parallelism: each dim the rules put on ``model`` at ``1 / model`` of
    its width where ``model`` divides it (``spec_for`` on the dim), whole
    where it does not.  The head dim is held before the heads are cut;
    a Mamba-2's ``d_inner`` (and with it its heads, conv and in_proj
    widths) follows its SSM heads; a MoE keeps every expert's capacity
    with its experts cut (``top_k`` at most the local experts)."""
    m = mesh.shape["model"]

    def cut(n: int, axis: str) -> int:
        return n // m if shd.spec_for((n,), (axis,), rules, mesh) == ("model",) else n

    vals = {"head_dim": cfg.hd, "n_heads": cut(cfg.n_heads, "heads"), "d_ff": cut(cfg.d_ff, "mlp"),
            "vocab": cut(cfg.vocab, "vocab")}
    vals["n_kv_heads"] = _kv_heads(cfg.n_heads, cfg.n_kv_heads, vals["n_heads"],
                                   cut(cfg.n_kv_heads, "kv_heads"))
    props = {}
    if isinstance(cfg, mamba2.Mamba2Config):
        heads = cut(cfg.ssm_heads, "ssm_heads")
        props["d_inner"] = heads * cfg.ssm_head_dim
        if heads < cfg.ssm_heads and cut(cfg.in_proj_dim, "conv_dim") < cfg.in_proj_dim:
            # [z | x | B | C | dt] cut whole: B and C too (_CutMamba2Block)
            props["in_proj_dim"] = cfg.in_proj_dim // m
    if isinstance(cfg, zamba.ZambaConfig):
        props["attn_head_dim"] = cfg.attn_head_dim
        vals.update(attn_heads=cut(cfg.attn_heads, "heads"), attn_d_ff=cut(cfg.attn_d_ff, "mlp"))
        vals["attn_kv_heads"] = _kv_heads(cfg.attn_heads, cfg.attn_kv_heads, vals["attn_heads"],
                                          cut(cfg.attn_kv_heads, "kv_heads"))
    if isinstance(cfg, moe.MoEConfig):
        E, k = cfg.n_experts, cfg.top_k
        e, kl = cut(E, "expert"), min(k, cut(E, "expert"))
        # capacity = capacity_factor · group · top_k / experts, kept per expert
        vals.update(n_experts=e, top_k=kl, capacity_factor=cfg.capacity_factor * k * e / (kl * E))
    return _pinned(cfg, vals, props)


class _CutMamba2Block(mamba2.Mamba2Block):
    """A Mamba-2 block as one mesh position runs it when ``model`` cuts
    in_proj's concatenated [z | x | B | C | dt] columns whole: its slice
    of B and C is computed with its z, x and dt heads, and B and C are
    gathered whole for the conv and the SSD (``roofline.gather_model``)."""

    def _mix(self, x):
        cfg = self.cfg
        h = common.rms_norm(x, self.ln, cfg.norm_eps)
        out = h @ self.in_proj.to(cfg.compute_dtype)
        d, bc = cfg.d_inner, 2 * cfg.n_groups * cfg.d_state
        part = out.shape[-1] - 2 * d - cfg.ssm_heads  # this card's B and C columns
        xbc = torch.cat([out[..., d:2 * d], roofline.gather_model(out[..., 2 * d:2 * d + part], bc // part)], -1)
        return out[..., :d], xbc, out[..., 2 * d + part:]


def _local_model(lcfg) -> torch.nn.Module:
    """The per-device model of ``local_config``'s config on ``meta``."""
    model = specs.abstract_model(lcfg)
    if isinstance(lcfg, mamba2.Mamba2Config) and lcfg.in_proj_dim < 2 * lcfg.d_inner + \
            2 * lcfg.n_groups * lcfg.d_state + lcfg.ssm_heads:
        for blk in model.modules():
            if type(blk) is mamba2.Mamba2Block:
                blk.__class__ = _CutMamba2Block
    return model


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _shard_bytes(sharding: shd.NamedSharding, t) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    return math.prod(sharding.shard_shape(t.shape)) * t.element_size()


def _tile(g: torch.Tensor, shape) -> torch.Tensor:
    """Position (0, 0)'s tile of a gradient: what the reduce-scatter
    leaves it (a view, so the count reads only the tile)."""
    return g[tuple(slice(0, n) for n in shape)]


def _micro_grads(cfg, model, batch: dict, n_micro: int, acc_dtype, tiles: dict) -> dict:
    """``gshard``: each microbatch's gradients reduce-scattered onto the
    position's tiles and summed there, in ``acc_dtype``."""
    mod = model_api.get_model(cfg)
    params = train_lib.trainable(model)
    acc = {n: torch.zeros(tiles[n], dtype=acc_dtype, device="meta") for n in params}
    for i in range(n_micro):
        loss = mod.loss_fn(cfg, model, train_lib._microbatch(batch, n_micro, i))
        for name, g in zip(params, torch.autograd.grad(loss, list(params.values()))):
            acc[name].add_(_tile(g, tiles[name]).to(acc_dtype))
    return {n: a / n_micro for n, a in acc.items()}


def _mesh_cell(cfg, arch: str, shape: str, mesh: LocalMesh, extras: dict, record: dict):
    """Count mesh position (0, 0)'s step once; its analysis (collectives
    filled in) and argument bytes."""
    info = specs.SHAPES[shape]
    mode, B, S = info["mode"], info["global_batch"], info["seq_len"]
    multi_pod = "pod" in mesh.shape
    rules = shd.make_rules(mode, multi_pod=multi_pod)
    gmodel = specs.abstract_model(cfg)
    gparams = dict(gmodel.named_parameters())
    p_sh = shd.tree_shardings(gparams, specs.params_logical_axes(cfg), rules, mesh)
    lcfg = local_config(cfg, mesh, rules)
    model = _local_model(lcfg)
    lparams = dict(model.named_parameters())
    split = {n: tuple(i for i, (g, l) in enumerate(zip(gparams[n].shape, p.shape)) if g != l)
             for n, p in lparams.items()}
    record["local_config"] = {k: getattr(lcfg, k) for k in
                              ("n_heads", "n_kv_heads", "d_ff", "vocab", "n_experts", "top_k",
                               "d_inner", "attn_heads", "attn_d_ff")
                              if hasattr(cfg, k) and getattr(lcfg, k) != getattr(cfg, k)}
    args = sum(_shard_bytes(p_sh[n], p) for n, p in gparams.items())
    args += sum(b.numel() * b.element_size() for b in gmodel.buffers())

    gbatch = specs.input_specs(cfg, shape)
    b_axes = specs.batch_logical_axes(cfg, shape)
    batch = {}
    for k, t in gbatch.items():
        sh = shd.NamedSharding(mesh, shd.spec_for(t.shape, b_axes[k], rules, mesh))
        batch[k] = _meta(sh.shard_shape(t.shape), t.dtype)
        args += _shard_bytes(sh, t)
    rows = batch["tokens"].shape[0]
    record["per_device_batch"] = rows
    weights = {n: (p.numel() * p.element_size(),
                   any(a in ("data", "pod") for part in p_sh[n].spec if part is not None
                       for a in ((part,) if isinstance(part, str) else part)))
               for n, p in lparams.items()}
    plan = dict(weights=weights)

    if mode == "train":
        model.requires_grad_(True)
        opt_cfg = adamw.AdamWConfig(
            state_dtype=torch.bfloat16 if arch in BF16_STATE_ARCHS else torch.float32
        )
        dp = mesh.data_ranks
        n_micro = min(extras["accum"] or specs.GRAD_ACCUM.get(arch, 1), max(B // dp, 1))
        record["n_micro"] = n_micro
        tiles = {n: p_sh[n].shard_shape(p.shape) for n, p in gparams.items()}
        held = {n: _meta(tiles[n], p.dtype) for n, p in gparams.items()}
        opt = adamw.adamw_init(opt_cfg, held)
        # m and v take the parameters' shardings (specs.opt_logical_axes)
        args += sum(2 * math.prod(t) * opt_cfg.state_dtype.itemsize for t in tiles.values())
        args += opt["step"].element_size()
        gdtype = extras["gdtype"]

        def step():
            if extras["gshard"]:
                grads = _micro_grads(lcfg, model, batch, n_micro, gdtype, tiles)
            else:
                _, local = train_lib.loss_and_grads(lcfg, model, batch, n_micro, gdtype)
                grads = {n: _tile(g, tiles[n]) for n, g in local.items()}
            return adamw.adamw_update(opt_cfg, held, grads, opt)

        micro = train_lib._microbatch(batch, n_micro, 0)
        trace = roofline.trace_collectives(
            lambda: model_api.get_model(lcfg).loss_fn(lcfg, model, micro), model, split, mesh,
            rules, backward=True)
        plan.update(grads={n: p.numel() * gdtype.itemsize for n, p in lparams.items()},
                    n_micro=n_micro, grads_per_micro=extras["gshard"])
        grad = torch.enable_grad()
    else:
        serve = specs.make_serve_step(cfg, shape)
        if mode == "prefill":
            def step():
                return serve(model, batch)
        else:
            g_cache = specs.decode_cache_specs(cfg, shape)
            c_sh = shd.tree_shardings(g_cache, specs.decode_cache_logical_axes(cfg, shape), rules, mesh)
            args += sum(_shard_bytes(c_sh[k], t) for k, t in g_cache.items())
            # the cache a card reads: its query heads' kv heads over the whole
            # sequence where the heads are cut, else its slice of the sequence
            heads_cut = lcfg.n_heads < cfg.n_heads or getattr(lcfg, "attn_heads", 0) < getattr(cfg, "attn_heads", 0)
            m = mesh.shape["model"]
            M = S if heads_cut or S % m else S // m
            caches = [model.init_cache(rows, M) for _ in range(2)]  # the trace's, the count's

            def step():
                return serve(model, caches.pop(), batch["tokens"])
        trace = roofline.trace_collectives(step, model, split, mesh, rules, backward=False)
        grad = torch.no_grad()
    experts_cut = getattr(lcfg, "n_experts", 0) < getattr(cfg, "n_experts", 0)
    stats = roofline.plan_collectives(trace, mesh.shape, experts_cut=experts_cut, **plan)
    with grad, op_analysis.OpCounter() as counter:
        out = step()
    stats.fill(counter.analysis)
    return counter.analysis, args, out


def _mesh_of(mesh) -> tuple[str, LocalMesh | None]:
    """A record's mesh name and its mesh (None: one card)."""
    if isinstance(mesh, LocalMesh):
        return "pod" + "x".join(map(str, mesh.shape.values())), mesh
    if mesh == "card":
        return "card", None
    if mesh not in MESH_NAMES:
        raise ValueError(f"mesh must be one of {tuple(MESH_NAMES) + ('card',)} or a LocalMesh, got {mesh!r}")
    multi = mesh == "multi"
    return MESH_NAMES[mesh], make_production_mesh(multi_pod=multi, devices=("meta",) * (512 if multi else 256))


def run_cell(
    arch: str,
    shape: str,
    mesh: str | LocalMesh = "card",
    variant: str = "baseline",
    out_dir: str = OUT_DIR,
) -> dict:
    """Count one cell and write its record: ``mesh`` is ``"card"``,
    ``"single"``, ``"multi"`` or a ``LocalMesh`` (over ``meta`` devices)."""
    mesh_name, mesh_obj = _mesh_of(mesh)
    t0 = time.perf_counter()
    cfg = configs.get_config(arch)
    cfg, extras = _apply_variant(cfg, variant)
    ok, why = specs.shape_applicable(cfg, shape)
    record = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name,
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

    if mesh_obj is None:
        step, args = _step(cfg, arch, shape, extras, record)
        # the model as its parameters and buffers, the rest as they are
        arg_tree = (list(args[0].parameters()), list(args[0].buffers()), args[1:])
        arguments = _storage_bytes(arg_tree)
        grad = torch.enable_grad() if mode == "train" else torch.no_grad()
        with grad, op_analysis.OpCounter() as counter:
            out = step(*args)
        a = counter.analysis
        arg_bytes, n_chips, mesh_shape = sum(arguments.values()), 1, None
    else:
        a, arg_bytes, out = _mesh_cell(cfg, arch, shape, mesh_obj, extras, record)
        arguments, n_chips, mesh_shape = {}, mesh_obj.size, dict(mesh_obj.shape)
    trace_s = time.perf_counter() - t0
    outputs = {k: n for k, n in _storage_bytes(out).items() if k not in arguments}
    temp = a.peak_live_bytes
    record["memory_analysis"] = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": sum(outputs.values()),
        "temp_size_in_bytes": temp,
    }
    record["device_memory_bytes"] = roofline.DEVICE_MEMORY_BYTES
    record["fits"] = arg_bytes + temp <= roofline.DEVICE_MEMORY_BYTES
    record["profile_top_flops"] = dict(sorted(a.op_flops.items(), key=lambda kv: -kv[1])[:10])
    record["profile_top_bytes"] = dict(sorted(a.op_bytes.items(), key=lambda kv: -kv[1])[:10])
    rl = roofline.analyze(a, n_chips, model_flops_total, mesh_shape)
    record.update(
        status="ok",
        n_chips=n_chips,
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
    if mesh_shape is not None:
        record["mesh_shape"] = mesh_shape
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
    terms = f"c {rl['compute_s']:.4g} / m {rl['memory_s']:.4g}"
    if rec["mesh"] != "card":
        terms += f" / x {rl['collective_s']:.4g}"
    return (
        f"{rl['bottleneck']} {rl['bottleneck_s']:.4g} s ({terms}), u {rl['useful_flops_ratio']:.3f}, "
        f"{mem['argument_size_in_bytes'] / 1e9:.4g} + {mem['temp_size_in_bytes'] / 1e9:.4g} GB, "
        + ("fits" if rec["fits"] else "no")
    )


def table(out_dir: str = OUT_DIR, variant: str = "baseline", mesh: str = "card") -> str:
    """A markdown table of one mesh's records in ``out_dir``: one row per
    arch, one column per shape; each cell the bottleneck term and
    seconds, the compute (c) / memory (m) seconds and, on a mesh, the
    collective (x) seconds, the useful-FLOPs ratio (u), argument + temp
    GB per card and whether they fit in the card's memory."""
    name = MESH_NAMES.get(mesh, mesh)
    shapes = list(specs.SHAPES)
    lines = ["| arch | " + " | ".join(shapes) + " |", "| --- " * (len(shapes) + 1) + "|"]
    for arch in configs.arch_names():
        cells = []
        for shape in shapes:
            path = _path(out_dir, arch, shape, name, variant)
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
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.table:
        print("\n\n".join(table(args.out, args.variant, m) for m in meshes))
        return

    archs = configs.arch_names() if args.all or not args.arch else [args.arch]
    shapes = list(specs.SHAPES) if args.all or not args.shape else [args.shape]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                name = MESH_NAMES.get(mesh, mesh)
                tag = f"{arch} × {shape} × {name}"
                path = _path(args.out, arch, shape, name, args.variant)
                if args.skip_existing and os.path.exists(path):
                    with contextlib.suppress(OSError, ValueError), open(path) as fh:
                        if json.load(fh).get("status") in ("ok", "skipped"):
                            print(f"[cached] {tag}", flush=True)
                            continue
                try:
                    rec = run_cell(arch, shape, mesh, args.variant, args.out)
                except Exception:
                    failures += 1
                    print(f"[FAIL] {tag}\n{traceback.format_exc()}", flush=True)
                    continue
                if rec["status"] == "ok":
                    rl, mem = rec["roofline"], rec["memory_analysis"]
                    print(
                        f"[ok] {tag}: bottleneck={rl['bottleneck']} ({rl['bottleneck_s']:.4f}s), "
                        f"collective={rl['collective_s']:.4f}s, "
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
