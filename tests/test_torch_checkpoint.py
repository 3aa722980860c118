"""The port's checkpoint substrate (``repro_torch.checkpoint``): atomicity,
roundtrip, keep-K GC, the async writer, and the on-disk format it shares
with the reference.

Mirrors the 12 tests of ``tests/test_checkpoint.py`` on trees of torch
tensors.  Parity: a checkpoint written by the reference (float32, int32
and bfloat16 leaves in nested dicts and lists) restores bitwise through
the port, and one written by the port restores bitwise through the
reference; both packages key a tree's leaves by the same paths.  Inside
the port: bfloat16 tensors roundtrip bitwise, the manager's snapshot is a
copy taken before ``save`` returns.  The elastic restore
(``restore_resharded``, the twin of ``tests/test_fault.py::
test_elastic_reshard_subprocess``): granite-8b's smoke params and AdamW
state saved from one device land bitwise on (2, 2) and (1, 4) logical
meshes, and a reference checkpoint lands bitwise through the port; a
leaf without a mesh's sharding raises.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.checkpoint import checkpoint as r_ckpt  # noqa: E402
from repro.models import model_api as r_model_api  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    latest_step,
    read_manifest,
    restore,
    restore_resharded,
    save,
)
from repro_torch.checkpoint import checkpoint as t_ckpt  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.fault import ChaosInjector, ChaosRule, InjectedFault  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import model_api  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "layers": {"w": torch.from_numpy(rng.randn(4, 8).astype(np.float32))},
        "bias": torch.from_numpy(rng.randn(8).astype(np.float32)),
        "step_scalar": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(tree):
    return [leaf for _, leaf in t_ckpt._leaves_with_paths(tree)]


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as unsigned words (bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = t_ckpt._to_numpy(x)
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.dtype(f"u{x.dtype.itemsize}")) if x.dtype.itemsize in (1, 2, 4, 8) else x


# -- mirrors of tests/test_checkpoint.py ---------------------------------------


def test_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 5, {"params": t})
    assert latest_step(str(tmp_path)) == 5
    out = restore(str(tmp_path), 5, {"params": t})
    for a, b in zip(_leaves(out["params"]), _leaves(t)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert torch.equal(a, b)


def test_shape_mismatch_rejected(tmp_path):
    save(str(tmp_path), 1, {"params": _tree()})
    bad = _tree()
    bad["bias"] = torch.zeros(9)
    with pytest.raises(ValueError):
        restore(str(tmp_path), 1, {"params": bad})


def test_no_partial_checkpoint_visible(tmp_path):
    """tmp dirs must never be discovered as valid checkpoints."""
    os.makedirs(tmp_path / "tmp.3.123")
    os.makedirs(tmp_path / "step_x")
    assert latest_step(str(tmp_path)) is None
    save(str(tmp_path), 3, {"params": _tree()})
    assert latest_step(str(tmp_path)) == 3


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": _tree(s)})
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(tmp_path) if n.startswith("step_")
    )
    assert steps == [3, 4]


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    t = _tree(9)
    mgr.save(11, {"params": t})
    mgr.wait()
    got = mgr.restore_latest({"params": _tree(0)})
    assert got is not None
    step, trees = got
    assert step == 11
    assert torch.equal(trees["params"]["bias"], t["bias"])


def test_async_overlapping_saves_serialize(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5, async_save=True)
    for s in range(5):
        mgr.save(s, {"params": _tree(s)})  # each save waits for the previous
    mgr.wait()
    assert latest_step(str(tmp_path)) == 4


def test_manifest_extra_roundtrip(tmp_path):
    extra = {"tenants": {"t0": {"hash": "abc"}}, "schema": 1}
    save(str(tmp_path), 3, {"params": _tree()}, extra=extra)
    m = read_manifest(str(tmp_path), 3)
    assert m["step"] == 3 and m["extra"] == extra
    out = restore(str(tmp_path), 3, {"params": _tree()})
    assert torch.equal(out["params"]["bias"], _tree()["bias"])


def test_crash_during_write_never_corrupts_latest(tmp_path):
    """A crash while writing payload files leaves the previous step as
    the latest complete checkpoint."""
    save(str(tmp_path), 1, {"params": _tree(0)})
    chaos = ChaosInjector([ChaosRule(seam="ckpt_write", kind="raise", at=(1,))])
    with pytest.raises(InjectedFault):
        save(str(tmp_path), 2, {"params": _tree(1)}, chaos=chaos)
    assert latest_step(str(tmp_path)) == 1
    out = restore(str(tmp_path), 1, {"params": _tree()})
    assert torch.equal(out["params"]["bias"], _tree(0)["bias"])


def test_crash_before_rename_never_corrupts_latest(tmp_path):
    """A crash at the atomicity boundary (everything written and
    fsynced, rename not done) still leaves only the previous step."""
    save(str(tmp_path), 1, {"params": _tree(0)})
    chaos = ChaosInjector([ChaosRule(seam="ckpt_rename", kind="raise", at=(1,))])
    with pytest.raises(InjectedFault):
        save(str(tmp_path), 2, {"params": _tree(1)}, chaos=chaos)
    assert latest_step(str(tmp_path)) == 1


def test_crash_mid_overwrite_keeps_a_complete_step(tmp_path):
    """Overwriting a step parks the old directory before the rename; a
    crash in the overwrite leaves a complete step_N (old or new)."""
    save(str(tmp_path), 1, {"params": _tree(0)})
    chaos = ChaosInjector([ChaosRule(seam="ckpt_rename", kind="raise", at=(1,))])
    with pytest.raises(InjectedFault):
        save(str(tmp_path), 1, {"params": _tree(1)}, chaos=chaos)
    assert latest_step(str(tmp_path)) == 1
    out = restore(str(tmp_path), 1, {"params": _tree()})
    assert torch.equal(out["params"]["bias"], _tree(0)["bias"])  # the old payload
    save(str(tmp_path), 1, {"params": _tree(2)})
    out = restore(str(tmp_path), 1, {"params": _tree()})
    assert torch.equal(out["params"]["bias"], _tree(2)["bias"])


def test_manager_gc_reaps_stale_tmp_dirs(tmp_path):
    """Crash debris (tmp dirs of other pids) is reaped by the next GC
    pass; the live pid's own tmp is left alone."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    stale = os.path.join(str(tmp_path), "tmp.9.99999")
    os.makedirs(stale)
    mgr.save(1, {"params": _tree()})
    assert not os.path.exists(stale)
    assert latest_step(str(tmp_path)) == 1


def test_manager_chaos_passthrough_surfaces_on_wait(tmp_path):
    """An async save crashed by the injector surfaces its error on the
    next wait(), never silently dropped."""
    chaos = ChaosInjector([ChaosRule(seam="ckpt_write", kind="raise", at=(1,))])
    mgr = CheckpointManager(str(tmp_path), async_save=True, chaos=chaos)
    mgr.save(1, {"params": _tree()})
    with pytest.raises(InjectedFault):
        mgr.wait()
    assert latest_step(str(tmp_path)) is None


# -- the port: bf16, snapshots, missing leaves, the mesh restore ---------------


def _mixed_np(seed=0):
    """Nested dicts and lists of float32, int32 and bfloat16 leaves, as
    numpy arrays (bfloat16 as raw words): the cross-package tree."""
    rng = np.random.RandomState(seed)
    bf = torch.from_numpy(rng.randn(3, 5).astype(np.float32)).to(torch.bfloat16)
    return {
        "w": rng.randn(4, 6).astype(np.float32),
        "l": [
            rng.randint(-9, 9, size=(7,)).astype(np.int32),
            {"b": bf.view(torch.int16).numpy(), "s": np.float32(2.5)},
        ],
        "emb": {"table": rng.randn(2, 3, 4).astype(np.float32)},
    }


def _as_torch(tree):
    """The cross-package tree as torch tensors (bfloat16 where bf16)."""
    return {
        "w": torch.from_numpy(tree["w"]),
        "l": [
            torch.from_numpy(tree["l"][0]),
            {"b": torch.from_numpy(tree["l"][1]["b"]).view(torch.bfloat16),
             "s": torch.tensor(tree["l"][1]["s"])},
        ],
        "emb": {"table": torch.from_numpy(tree["emb"]["table"])},
    }


def _as_jax(tree):
    return {
        "w": jnp.asarray(tree["w"]),
        "l": [
            jnp.asarray(tree["l"][0]),
            {"b": jnp.asarray(tree["l"][1]["b"]).view(jnp.bfloat16),
             "s": jnp.asarray(tree["l"][1]["s"])},
        ],
        "emb": {"table": jnp.asarray(tree["emb"]["table"])},
    }


def test_bf16_tensors_roundtrip_bitwise(tmp_path):
    t = _as_torch(_mixed_np())
    save(str(tmp_path), 1, {"params": t})
    with np.load(os.path.join(tmp_path, "step_1", "params.npz")) as z:
        assert z["l/1/b"].dtype == np.dtype("V2")  # raw words, as the reference writes
    out = restore(str(tmp_path), 1, {"params": t})["params"]
    assert out["l"][1]["b"].dtype == torch.bfloat16
    for a, b in zip(_leaves(out), _leaves(t)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a float32 template cannot take bfloat16 words
    bad = _as_torch(_mixed_np())
    bad["l"][1]["b"] = torch.zeros(3, 5)
    with pytest.raises(ValueError, match="dtype mismatch"):
        restore(str(tmp_path), 1, {"params": bad})


def test_missing_leaf_raises_key_error_and_numpy_templates_stay_numpy(tmp_path):
    save(str(tmp_path), 1, {"params": {"a": np.arange(3, dtype=np.int64)}})
    out = restore(str(tmp_path), 1, {"params": {"a": np.zeros(3, np.int64)}})["params"]
    assert isinstance(out["a"], np.ndarray) and out["a"].tolist() == [0, 1, 2]
    with pytest.raises(KeyError, match="'b'"):
        restore(str(tmp_path), 1, {"params": {"a": np.zeros(3), "b": np.zeros(1)}})


def test_manager_snapshot_is_a_copy_taken_before_save_returns(tmp_path):
    """An in-place update right after an async ``save`` returns must not
    reach the file: the manager snapshots every leaf to a host copy."""
    t = _tree(3)
    want = t["layers"]["w"].clone()
    chaos = ChaosInjector([ChaosRule(seam="ckpt_write", kind="latency", rate=1.0, delay_s=0.2)])
    mgr = CheckpointManager(str(tmp_path), async_save=True, chaos=chaos)
    mgr.save(1, {"params": t})
    t["layers"]["w"].add_(1.0)  # the next training step, in place
    mgr.wait()
    out = restore(str(tmp_path), 1, {"params": _tree()})["params"]
    assert torch.equal(out["layers"]["w"], want)


def test_restore_resharded_needs_the_mesh(tmp_path):
    save(str(tmp_path), 1, {"params": _tree()})
    with pytest.raises(ValueError, match="mesh"):
        restore_resharded(str(tmp_path), 1, {"params": _tree()}, {"params": None})


def _granite_state(seed=0):
    """granite-8b's smoke params on the CPU and an AdamW state of the same
    tree, its moments drawn from a seed (so no leaf is all zeros)."""
    cfg = t_configs.get_smoke_config("granite-8b")
    model = model_api.get_model(cfg).init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    params = {n: p.detach() for n, p in model.named_parameters()}
    opt = adamw_init(AdamWConfig(), params)
    g = torch.Generator().manual_seed(seed + 1)
    for n, p in params.items():
        opt["m"][n].copy_(torch.randn(p.shape, generator=g))
        opt["v"][n].copy_(torch.rand(p.shape, generator=g))
    opt["step"].fill_(3)
    return cfg, params, opt


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_elastic_restore_onto_a_mesh_bitwise(tmp_path, mesh_shape):
    """Saved from one device, restored onto a logical mesh of four CPU
    positions: every leaf a ShardedTensor under its sharding whose
    ``full()`` is the saved tensor bitwise; ``layers.0.w_up`` holds four
    distinct shards of its spec's shape."""
    cfg, params, opt = _granite_state()
    save(str(tmp_path), 1, {"params": params, "opt": opt})
    mesh = make_local_mesh(*mesh_shape, devices=("cpu",) * 4)
    rules = shd.make_rules("train")
    axes = t_specs.params_logical_axes(cfg)
    shardings = {
        "params": shd.tree_shardings(params, axes, rules, mesh),
        "opt": shd.tree_shardings(opt, t_specs.opt_logical_axes(axes), rules, mesh),
    }
    saved = {"params": params, "opt": opt}
    out = restore_resharded(str(tmp_path), 1, saved, shardings)
    n = 0
    for name in saved:
        want = dict(t_ckpt._leaves_with_paths(saved[name]))
        lay = dict(t_ckpt._leaves_with_paths(shardings[name]))
        for path, held in t_ckpt._leaves_with_paths(out[name]):
            assert isinstance(held, shd.ShardedTensor) and held.sharding == lay[path], path
            assert held.dtype == want[path].dtype
            np.testing.assert_array_equal(_bits(held.full("cpu")), _bits(want[path]))
            n += 1
    assert n == 3 * len(params) + 1
    w_up = out["params"]["layers.0.w_up"]
    D, F = w_up.shape
    assert w_up.sharding.spec == ("data", "model")
    positions = w_up.sharding.positions()
    shards = [w_up.shard(*p) for p in positions]
    assert len({s.data_ptr() for s in shards}) == 4
    assert len({tuple((s.start, s.stop) for s in w_up.index(*p)) for p in positions}) == 4
    assert all(tuple(s.shape) == (D // mesh_shape[0], F // mesh_shape[1]) for s in shards)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_reference_checkpoint_restores_resharded_through_port(tmp_path, mesh_shape):
    """A checkpoint the reference writes of its stacked bf16 params
    (granite-8b smoke) restores onto the port's mesh bitwise, sharded by
    the reference-layout axes tree of the port's family module."""
    rcfg = dataclasses.replace(r_configs.get_smoke_config("granite-8b"), param_dtype=jnp.bfloat16)
    r_params, _ = r_model_api.get_model(rcfg).init_params(rcfg, jax.random.PRNGKey(0))
    r_ckpt.save(str(tmp_path), 2, {"params": r_params})
    tcfg = t_configs.get_smoke_config("granite-8b", param_dtype=torch.bfloat16)
    templates = jax.tree.map(lambda x: torch.empty(x.shape, dtype=torch.bfloat16, device="meta"), r_params)
    mesh = make_local_mesh(*mesh_shape, devices=("cpu",) * 4)
    sh = shd.tree_shardings(templates, model_api.get_model(tcfg).logical_axes(tcfg),
                            shd.make_rules("train"), mesh)
    out = restore_resharded(str(tmp_path), 2, {"params": templates}, {"params": sh})["params"]
    want = dict(t_ckpt._leaves_with_paths(jax.tree.map(np.asarray, r_params)))
    got = list(t_ckpt._leaves_with_paths(out))
    assert [p for p, _ in got] == list(want)
    for path, held in got:
        assert held.dtype == torch.bfloat16 and held.shape == want[path].shape
        np.testing.assert_array_equal(_bits(held.full("cpu")), want[path].view(np.uint16))
    w_up = out["layers"]["w_up"]
    assert w_up.sharding.spec == (None, "data", "model")  # the stacked layers dim stays whole


# -- parity with the reference -------------------------------------------------


def test_leaf_paths_match_reference():
    tree = _mixed_np()
    assert list(t_ckpt._flatten_with_paths(tree)) == list(r_ckpt._flatten_with_paths(tree))
    assert sorted(t_ckpt._flatten_with_paths(tree)) == ["emb/table", "l/0", "l/1/b", "l/1/s", "w"]


def test_reference_checkpoint_restores_bitwise_through_port(tmp_path):
    src = _mixed_np(1)
    r_ckpt.save(str(tmp_path), 4, {"params": _as_jax(src)}, extra={"who": "reference"})
    assert latest_step(str(tmp_path)) == 4
    assert read_manifest(str(tmp_path), 4)["extra"] == {"who": "reference"}
    out = restore(str(tmp_path), 4, {"params": _as_torch(_mixed_np(0))})["params"]
    want = _as_torch(src)
    assert out["l"][1]["b"].dtype == torch.bfloat16
    for a, b in zip(_leaves(out), _leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_port_checkpoint_restores_bitwise_through_reference(tmp_path):
    src = _mixed_np(2)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(6, {"params": _as_torch(src)}, extra={"who": "port"})
    mgr.wait()
    assert r_ckpt.latest_step(str(tmp_path)) == 6
    assert r_ckpt.read_manifest(str(tmp_path), 6)["extra"] == {"who": "port"}
    out = r_ckpt.restore(str(tmp_path), 6, {"params": _as_jax(_mixed_np(0))})["params"]
    got = [out["w"], out["l"][0], out["l"][1]["b"], out["l"][1]["s"], out["emb"]["table"]]
    want = [src["w"], src["l"][0], src["l"][1]["b"], src["l"][1]["s"], src["emb"]["table"]]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
