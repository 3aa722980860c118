"""The port's logical-axis sharding rules (``repro_torch.distributed.
sharding``) against the reference's: the four spec cases and the
divisibility property of ``tests/test_sharding.py``, each resolved by
both packages through one duck-typed mesh (the reference's ``spec_for``
reads only ``mesh.shape``), plus the serving rules and a tree of specs.

Sharded training state: every family's logical axes
(``launch.specs.params_logical_axes`` / ``decode_cache_logical_axes``)
give the reference's specs on four meshes; a :class:`ShardedTensor`
tiles and reassembles any tensor and never pads; and, in one subprocess
with four forced host devices, its shards equal the reference's
``addressable_shards`` position by position.
"""

import functools
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
from _hypo import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.distributed import sharding as r_shd  # noqa: E402
from repro.launch import specs as r_specs  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import model_api  # noqa: E402


def _mesh(**axes):
    return types.SimpleNamespace(shape=dict(axes))


def _both(shape, axes, mesh, mode="train", multi_pod=False):
    """The port's spec and the reference's, for one shape."""
    got = shd.spec_for(shape, axes, shd.make_rules(mode, multi_pod), mesh)
    want = r_shd.spec_for(shape, axes, r_shd.make_rules(mode, multi_pod), mesh)
    assert got == tuple(want)
    return got


def test_spec_resolution_basic():
    assert _both((4096, 14336), ("embed", "mlp"), _mesh(data=16, model=16)) == ("data", "model")


def test_spec_drops_non_divisible():
    # 12 heads don't divide 16 → dropped; 8960 d_ff divides → kept
    spec = _both((12, 8960), ("kv_heads", "mlp"), _mesh(data=16, model=16))
    assert spec == (None, "model")


def test_spec_no_duplicate_mesh_axis():
    spec = _both((64, 32), ("embed", "embed"), _mesh(data=16, model=16))
    assert spec == ("data", None)  # second use dropped


def test_multi_pod_batch_axes():
    spec = _both((256, 4096), ("batch", None), _mesh(pod=2, data=16, model=16), multi_pod=True)
    assert spec[0] == ("pod", "data")


@settings(max_examples=20, deadline=None)
@given(
    dim=st.integers(1, 4096),
    axis=st.sampled_from(["embed", "mlp", "heads", "vocab", None]),
)
def test_spec_always_divides(dim, axis):
    """Whatever the dim, the resolved sharding divides it exactly, and
    equals the reference's."""
    mesh = _mesh(data=16, model=16)
    part = _both((dim,), (axis,), mesh)[0]
    if part is None:
        return
    size = 1
    for a in (part if isinstance(part, tuple) else (part,)):
        size *= mesh.shape[a]
    assert dim % size == 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_serving_rules_match_reference(multi_pod):
    """The serving rules, and the arena / stream-batch specs they give on
    a port LocalMesh (the engine tiles its arena by the first)."""
    assert shd.make_serving_rules(multi_pod) == r_shd.make_serving_rules(multi_pod)
    assert shd.make_rules("decode", multi_pod) == r_shd.make_rules("decode", multi_pod)
    mesh = make_local_mesh(2, 4, devices=("cpu",) * 8)
    rules = shd.make_serving_rules()
    assert shd.spec_for((36, 1, 90, 119, 36), ("grating",) + (None,) * 4, rules, mesh) == (
        "model", None, None, None, None,
    )
    assert shd.spec_for((6, 1, 60), ("stream_batch", None, None), rules, mesh) == ("data", None, None)
    assert shd.spec_for((5, 1, 60), ("stream_batch", None, None), rules, mesh) == (None, None, None)
    assert shd._axis_size(mesh, ("data", "model")) == 8 and shd._axis_size(mesh, None) == 1


def test_tree_specs_match_reference():
    mesh = _mesh(data=4, model=2)
    params = {"w": np.zeros((8, 6)), "blocks": [torch.zeros(4, 3), np.zeros(5)]}
    axes = {"w": ("embed", "mlp"), "blocks": [("embed", "heads"), ("vocab",)]}
    got = shd.tree_specs(params, axes, shd.make_rules(), mesh)
    want = r_shd.tree_specs(
        {"w": params["w"], "blocks": [np.zeros((4, 3)), params["blocks"][1]]},
        axes, r_shd.make_rules(), mesh,
    )
    assert got["w"] == tuple(want["w"]) == ("data", "model")
    assert [tuple(s) for s in got["blocks"]] == [tuple(s) for s in want["blocks"]]
    assert shd.is_axes_leaf(("embed", None)) and not shd.is_axes_leaf(["embed"])


# -- sharded training state ------------------------------------------------------

LM_ARCHS = [a for a in t_configs.PORTED if a not in t_configs.VIDEO]
# (mesh axes, multi-pod rules)
MESHES = {
    "2x2": (dict(data=2, model=2), False),
    "1x4": (dict(data=1, model=4), False),
    "4x2": (dict(data=4, model=2), False),
    "multi_pod": (dict(pod=2, data=2, model=2), True),
}
STACKS = ("layers", "dense_layers", "enc_layers", "dec_layers")


def _flat(tree, axes_tree) -> list:
    """(path, shape, axes) of each leaf of a reference tree of
    ShapeDtypeStructs and its parallel axes tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    axes = jax.tree_util.tree_flatten_with_path(axes_tree, is_leaf=r_shd.is_axes_leaf)[0]
    assert [p for p, _ in leaves] == [p for p, _ in axes]
    return [(tuple(k.key for k in path), tuple(x.shape), a) for (path, x), (_, a) in zip(leaves, axes)]


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's smoke-config parameter and decode-cache leaves and
    its parameter axes tree."""
    rcfg = r_configs.get_smoke_config(arch)
    params, axes = r_specs.params_specs(rcfg)
    cache, cache_axes = r_specs.decode_cache_specs(rcfg, "decode_32k")
    return _flat(params, axes), _flat(cache, cache_axes), axes


def _stacked(path, axes) -> int:
    """How many leading stacked dims a reference leaf has: 0 outside a
    layer stack, 2 for Zamba-2's (n_segments, shared_every), else 1."""
    if path[0] not in STACKS:
        return 0
    return 2 if axes[:2] == ("segments", "layers") else 1


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_logical_axes_give_the_reference_specs(arch, mesh_name):
    """Every port parameter and decode-cache tensor of a smoke config
    resolves to the reference's spec for its leaf, the stacked leaf's
    ``layers`` entry dropped; the names are ``named_parameters()``'s."""
    mesh_axes, multi_pod = MESHES[mesh_name]
    mesh = _mesh(**mesh_axes)
    r_rules, t_rules = r_shd.make_rules("train", multi_pod), shd.make_rules("train", multi_pod)
    cfg = t_configs.get_smoke_config(arch)
    params, cache, r_axes = _reference(arch)
    assert model_api.get_model(cfg).logical_axes(cfg) == r_axes
    got = t_specs.params_logical_axes(cfg)
    shapes = t_specs.params_specs(cfg)
    assert list(got) == list(shapes)
    names = set()
    for path, shape, axes in params:
        n = _stacked(path, axes)
        want = tuple(r_shd.spec_for(shape, axes, r_rules, mesh))
        assert want[:n] == (None,) * n
        for i in range(math.prod(shape[:n])):
            name = ".".join((path[0], str(i)) + path[1:]) if n else ".".join(path)
            names.add(name)
            assert got[name] == axes[n:], name
            assert tuple(shapes[name].shape) == shape[n:], name
            assert shd.spec_for(shape[n:], got[name], t_rules, mesh) == want[n:], name
    assert names == set(got)
    cache_axes = t_specs.decode_cache_logical_axes(cfg, "decode_32k")
    got_cache = t_specs.decode_cache_specs(cfg, "decode_32k")
    assert set(cache_axes) == set(got_cache) == {path[0] for path, _, _ in cache}
    for (key,), shape, axes in cache:
        assert cache_axes[key] == axes, key
        if key != "length":  # the port's length is an int
            assert tuple(got_cache[key].shape) == shape, key
            assert shd.spec_for(shape, axes, t_rules, mesh) == tuple(
                r_shd.spec_for(shape, axes, r_rules, mesh)), key


PARTS = (None, "data", "model", ("data", "model"), ("model", "data"))


@settings(max_examples=20, deadline=None)
@given(
    mesh_shape=st.sampled_from([(1, 1), (1, 2), (2, 1), (2, 2), (1, 4), (4, 1), (2, 3), (4, 2)]),
    seed=st.integers(0, 10**6),
)
def test_sharded_tensor_tiles_and_reassembles(mesh_shape, seed):
    """Any shape and spec: ``full`` of ``from_full`` is the tensor bitwise,
    each shard is the contiguous slice its index names, and the distinct
    indices tile the tensor exactly once, each held by one replica group
    of mesh.size / (number of tiles) positions."""
    rng = np.random.RandomState(seed)
    mesh = make_local_mesh(*mesh_shape, devices=("cpu",) * math.prod(mesh_shape))
    spec, shape, used = [], [], set()
    for _ in range(rng.randint(0, 4)):
        part = PARTS[rng.randint(len(PARTS))]
        names = () if part is None else (part,) if isinstance(part, str) else part
        if used & set(names):
            part, names = None, ()
        used |= set(names)
        spec.append(part)
        shape.append(math.prod(mesh.shape[a] for a in names) * rng.randint(1, 4))
    x = torch.from_numpy(np.asarray(rng.randn(*shape), dtype=np.float32))
    sharding = shd.NamedSharding(mesh, shd.PartitionSpec(*spec))
    held = shd.ShardedTensor.from_full(x, sharding)
    assert held.shape == x.shape and held.dtype == x.dtype
    assert torch.equal(held.full("cpu"), x)
    groups = {}
    for pos in sharding.positions():
        idx = held.index(*pos)
        shard = held.shard(*pos)
        assert shard.is_contiguous() and tuple(shard.shape) == sharding.shard_shape(shape)
        assert torch.equal(shard, x[idx])
        groups.setdefault(tuple((s.start, s.stop) for s in idx), []).append(pos)
    cover = torch.zeros(shape, dtype=torch.int32)
    for poss in groups.values():
        cover[held.index(*poss[0])] += 1
    assert bool((cover == 1).all())
    assert len(groups) == math.prod(mesh.shape[a] for a in used)
    assert {len(p) for p in groups.values()} == {mesh.size // len(groups)}
    assert held.nbytes == mesh.size * math.prod(sharding.shard_shape(shape)) * 4


def test_sharded_tensor_never_pads():
    """A dim that a mesh axis does not divide: ``spec_for`` drops the axis
    and the dim is replicated; a sharding that names it anyway raises, as
    does one naming an axis the mesh lacks or naming an axis twice."""
    mesh = make_local_mesh(4, 2, devices=("cpu",) * 8)
    x = torch.arange(30, dtype=torch.float32).reshape(6, 5)
    spec = shd.spec_for((6, 5), ("embed", "mlp"), shd.make_rules(), mesh)
    assert spec == (None, None)
    held = shd.ShardedTensor.from_full(x, shd.NamedSharding(mesh, spec))
    assert all(torch.equal(held.shard(*p), x) for p in held.sharding.positions())
    with pytest.raises(ValueError, match="divide"):
        shd.ShardedTensor.from_full(x, shd.NamedSharding(mesh, shd.PartitionSpec("data", None)))
    for bad in (shd.PartitionSpec("pod", None), shd.PartitionSpec("data", "data")):
        with pytest.raises(ValueError, match="at most once"):
            shd.NamedSharding(mesh, bad)


SHARDS_SCRIPT = r"""
import json, os
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.distributed import sharding as shd
from repro.launch import mesh as mesh_lib
from repro.models import model_api

out = os.environ["OUT_DIR"]
cfg = configs.get_smoke_config("granite-8b")
params, axes = model_api.get_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
flat = {"/".join(k.key for k in path): np.asarray(x)
        for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}
np.savez(os.path.join(out, "params.npz"), **flat)
index, data = {}, {}


def dump(tag, arr, sharding, position):
    for s in jax.device_put(arr, sharding).addressable_shards:
        key = f"{tag}|{position[s.device.id]}"
        index[key] = [[sl.start, sl.stop] for sl in s.index]
        data[key] = np.asarray(s.data)


for d, m in ((2, 2), (1, 4)):
    mesh = mesh_lib.make_local_mesh(d, m)
    position = {mesh.devices[di, mi].id: f"{di},{mi}" for di in range(d) for mi in range(m)}
    sh = shd.tree_shardings(params, axes, shd.make_rules("train"), mesh)
    for path, s in jax.tree_util.tree_flatten_with_path(sh, is_leaf=lambda x: isinstance(x, NamedSharding))[0]:
        name = "/".join(k.key for k in path)
        dump(f"{d}x{m}|{name}", flat[name], s, position)
    x = np.arange(96, dtype=np.float32).reshape(8, 12)
    for spec in (P(("data", "model"), None), P(("model", "data"), None), P(None, "model")):
        dump(f"{d}x{m}|x|{json.dumps(list(spec))}", x, NamedSharding(mesh, spec), position)
# the multi-pod batch cut (pod, data) on a (pod 2, data 2, model 1) mesh
pod = Mesh(np.array(jax.devices()[:4]).reshape(2, 2, 1), ("pod", "data", "model"))
spec = shd.spec_for((8, 12), ("batch", None), shd.make_rules("train", multi_pod=True), pod)
assert tuple(spec) == (("pod", "data"), None), spec
position = {pod.devices[p, d, 0].id: f"{2 * p + d},0" for p in range(2) for d in range(2)}
dump("pod|x", np.arange(96, dtype=np.float32).reshape(8, 12), NamedSharding(pod, spec), position)
np.savez(os.path.join(out, "shards.npz"), **data)
with open(os.path.join(out, "index.json"), "w") as f:
    json.dump(index, f)
print("SHARDS_OK")
"""


def test_shards_equal_the_references_addressable_shards(tmp_path):
    """The reference places granite-8b's smoke params on (2, 2) and (1, 4)
    meshes of four forced host devices (and an (8, 12) array under tuple
    specs, and the multi-pod batch cut on a (pod, data, model) mesh);
    at every mesh position the port's ``index(di, mi)`` and shard equal
    its ``addressable_shards`` entry for the same leaf.  A stacked leaf's
    shards are the port's per-layer shards stacked; the multi-pod cut is
    the port's ``data`` cut of a mesh with the pods folded into data."""
    env = dict(os.environ, OUT_DIR=str(tmp_path), PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", SHARDS_SCRIPT], capture_output=True, text=True,
                          env=env, cwd=os.getcwd(), timeout=300)
    assert "SHARDS_OK" in proc.stdout, proc.stderr[-2000:]
    with open(tmp_path / "index.json") as f:
        index = json.load(f)
    with np.load(tmp_path / "params.npz") as z:
        ref = {k: z[k] for k in z.files}
    with np.load(tmp_path / "shards.npz") as z:
        data = {k: z[k] for k in z.files}

    def check(tag, tensor, sharding, layer=None):
        held = shd.ShardedTensor.from_full(tensor, sharding)
        for di, mi in sharding.positions():
            key = f"{tag}|{di},{mi}"
            want_index, want = index[key], data[key]
            if layer is not None:  # the stacked dim is whole on every position
                assert want_index[0] == [None, None], key
                want_index, want = want_index[1:], want[layer]
            assert [[s.start, s.stop] for s in held.index(di, mi)] == want_index, key
            assert np.array_equal(held.shard(di, mi).numpy(), want), key

    cfg = t_configs.get_smoke_config("granite-8b")
    axes = t_specs.params_logical_axes(cfg)
    x = torch.arange(96, dtype=torch.float32).reshape(8, 12)
    n_checked = 0
    for d, m in ((2, 2), (1, 4)):
        mesh = make_local_mesh(d, m, devices=("cpu",) * 4)
        for name, ax in axes.items():
            head, *rest = name.split(".")
            layer = int(rest[0]) if head == "layers" else None
            path = "/".join([head, *rest[1:]]) if layer is not None else name
            arr = ref[path] if layer is None else ref[path][layer]
            tensor = torch.from_numpy(np.ascontiguousarray(arr))
            spec = shd.spec_for(tensor.shape, ax, shd.make_rules("train"), mesh)
            check(f"{d}x{m}|{path}", tensor, shd.NamedSharding(mesh, spec), layer)
            n_checked += 1
        for spec in ((("data", "model"), None), (("model", "data"), None), (None, "model")):
            check(f"{d}x{m}|x|{json.dumps(list(spec))}", x,
                  shd.NamedSharding(mesh, shd.PartitionSpec(*spec)))
    folded = make_local_mesh(4, 1, devices=("cpu",) * 4)  # make_production_mesh's fold
    spec = shd.spec_for((8, 12), ("batch", None), shd.make_rules("train", multi_pod=True), folded)
    assert spec == ("data", None)
    check("pod|x", x, shd.NamedSharding(folded, spec))
    assert n_checked == 2 * len(axes)
