"""The port's dry run (``repro_torch.launch.dryrun``) on the ``meta``
device: ``run_cell`` on the smoke config of each LM family over the
four shapes (``specs.SHAPES`` patched small), its record's keys, the
skip reasons against the reference's ``shape_applicable``, the
parameter and model-FLOP counts, the mesh options' records and the
mesh variant keys (``tests/test_torch_dryrun_mesh.py`` holds the mesh
counts to the reference's)."""

import json
import os

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)

from repro import configs as r_configs  # noqa: E402
from repro.launch import specs as r_specs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import model_api  # noqa: E402

# one arch of each family
FAMILIES = ("qwen2-1.5b", "mamba2-370m", "zamba2-2.7b", "arctic-480b", "deepseek-v2-lite-16b",
            "whisper-tiny", "internvl2-2b")
SMALL_SHAPES = {
    "train_4k": dict(seq_len=32, global_batch=4, mode="train"),
    "prefill_32k": dict(seq_len=64, global_batch=2, mode="prefill"),
    "decode_32k": dict(seq_len=64, global_batch=4, mode="decode"),
    "long_500k": dict(seq_len=128, global_batch=1, mode="decode"),
}
# the reference's record keys that mean the same here, and the port's own
OK_KEYS = {"arch", "shape", "mesh", "variant", "status", "memory_analysis", "profile_top_flops",
           "profile_top_bytes", "n_chips", "seq_len", "global_batch", "mode", "params",
           "active_params", "roofline", "trace_s", "device_memory_bytes", "fits"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes"}


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(specs, "SHAPES", SMALL_SHAPES)
    monkeypatch.setattr(dryrun.configs, "get_config", configs.get_smoke_config)


def test_arch_names_are_the_references():
    assert configs.arch_names() == r_configs.arch_names()


@pytest.mark.parametrize("shape", list(SMALL_SHAPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_records_every_cell(arch, shape, small, tmp_path):
    rec = dryrun.run_cell(arch, shape, out_dir=str(tmp_path))
    with open(tmp_path / f"{arch}__{shape}__card__baseline.json") as fh:
        assert json.load(fh) == json.loads(json.dumps(rec))
    cfg = configs.get_smoke_config(arch)
    ok, why = r_specs.shape_applicable(r_configs.get_smoke_config(arch), shape)
    assert specs.shape_applicable(cfg, shape) == (ok, why)
    if not ok:
        assert rec["status"] == "skipped" and rec["skip_reason"] == why
        return
    info = SMALL_SHAPES[shape]
    train = info["mode"] == "train"
    assert rec["status"] == "ok" and set(rec) == OK_KEYS | ({"n_micro"} if train else set())
    assert set(rec["memory_analysis"]) == MEMORY_KEYS
    assert rec["params"] == cfg.num_params() and rec["n_chips"] == 1 and rec["mode"] == info["mode"]
    n_tokens = info["global_batch"] * (1 if info["mode"] == "decode" else info["seq_len"])
    rl = rec["roofline"]
    assert rl["model_flops"] == model_api.model_flops_per_token(cfg, train=train) * n_tokens
    assert rl["bottleneck_s"] == max(rl["compute_s"], rl["memory_s"], rl["collective_s"]) > 0
    assert rl["collective_s"] == 0 and rl["flops"] == sum(rl["flops_by_class"].values())
    mem = rec["memory_analysis"]
    weights = sum(p.numel() * p.element_size() for p in specs.abstract_model(cfg).parameters())
    assert mem["argument_size_in_bytes"] >= weights and mem["temp_size_in_bytes"] > 0
    assert rec["fits"] and len(rec["profile_top_flops"]) <= 10
    if train:
        assert rec["n_micro"] == min(specs.GRAD_ACCUM.get(arch, 1), info["global_batch"])


def test_cell_counts_its_kernels(small, tmp_path):
    """The dense model's prefill runs B6 once a layer (on ``meta``), the
    train step twice a layer (full remat) plus its plain backward."""
    cfg = configs.get_smoke_config("qwen2-1.5b")
    pre = dryrun.run_cell("qwen2-1.5b", "prefill_32k", out_dir=str(tmp_path))
    assert pre["roofline"]["flops"] > 0 and "flash_fwd" in pre["profile_top_flops"]
    train = dryrun.run_cell("qwen2-1.5b", "train_4k", variant="remat=full,accum=2", out_dir=str(tmp_path))
    assert train["n_micro"] == 2 and "flash_bwd(plain)" in train["profile_top_flops"]
    assert cfg.n_layers >= 1


MESH_KEYS = OK_KEYS | {"n_micro", "mesh_shape", "local_config", "per_device_batch"}


@pytest.mark.parametrize("mesh", ["single", "multi", "both"])
def test_mesh_options_write_the_references_records(mesh, small, tmp_path, capsys):
    """``--mesh single|multi|both`` count on the 16 × 16 and 2 × 16 × 16
    meshes (of ``meta`` devices) and write the reference's record names;
    ``--table`` prints each mesh's table with its collective term."""
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k", "--mesh", mesh, "--out", str(tmp_path)])
    names = {"single": ["pod16x16"], "multi": ["pod2x16x16"], "both": ["pod16x16", "pod2x16x16"]}[mesh]
    assert sorted(os.listdir(tmp_path)) == sorted(f"qwen2-1.5b__train_4k__{n}__baseline.json" for n in names)
    for name in names:
        with open(tmp_path / f"qwen2-1.5b__train_4k__{name}__baseline.json") as fh:
            rec = json.load(fh)
        multi = name == "pod2x16x16"
        assert rec["status"] == "ok" and set(rec) == MESH_KEYS and rec["mesh"] == name
        assert rec["n_chips"] == (512 if multi else 256)
        assert rec["mesh_shape"] == ({"pod": 2} if multi else {}) | {"data": 16, "model": 16}
        rl = rec["roofline"]
        assert rl["bottleneck_s"] == max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        assert rl["collective_s"] > 0 and rl["compute_s"] > 0 and rl["memory_s"] > 0
        assert set(rl["collective_bytes_by_axis"]) == {"data", "model"} | ({"pod"} if multi else set())
        # 4 rows: (pod, data) keeps only what divides them
        assert rec["per_device_batch"] == (2 if multi else 4) and rec["n_micro"] == 1
        # qwen2-smoke's 4 heads stay whole on 16; its MLP and vocab are cut
        assert rec["local_config"] == {"d_ff": 16, "vocab": 32} and rec["fits"]
    dryrun.main(["--table", "--mesh", mesh, "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("| qwen2-1.5b | ") == len(names) and out.count(" / x ") == len(names)


def _variant_cell(small_dir, variant):
    mesh = make_local_mesh(2, 2, devices=("meta",) * 4)
    return dryrun.run_cell("granite-8b", "train_4k", mesh, variant="accum=2," + variant, out_dir=small_dir)


# each mesh variant key: its config override or extra (None: it parses and
# changes nothing), and what it does to the counts against the baseline on
# a (2, 2) mesh
VARIANTS = {
    "gshard": ("gshard", True),
    "wgather": None,
    "lean": None,
    "seqshard": ("seq_shard", True),
    "seqgather": None,
}


COUNTS = ("flops", "hbm_bytes", "collective_bytes_by_kind")


@pytest.mark.parametrize("key", list(VARIANTS))
def test_mesh_variant_keys(key, small, tmp_path):
    """Each mesh variant key parses as the reference's does and counts:
    ``gshard`` reduces the gradients once a microbatch and sums them on
    the tiles, ``seqshard`` adds a reduce-scatter and an all-gather over
    ``model`` a layer boundary; ``wgather``, ``lean`` and ``seqgather``
    (with ``seqshard``) change no count (``dryrun.NO_OP_KEYS``)."""
    smoke = configs.get_smoke_config("granite-8b")
    cfg, extras = dryrun._apply_variant(smoke, f"{key}=1")
    if VARIANTS[key] is None:
        assert key in dryrun.NO_OP_KEYS and cfg == smoke
        assert extras == dryrun._apply_variant(smoke, "baseline")[1]
    else:
        field, value = VARIANTS[key]
        assert (extras[field] if field in extras else getattr(cfg, field)) == value
    base = _variant_cell(str(tmp_path), "remat=full")
    variant = f"{key}=1" if key != "seqgather" else "seqshard=1,seqgather=1"
    rec = _variant_cell(str(tmp_path), variant)
    b, r = base["roofline"], rec["roofline"]
    assert rec["n_micro"] == base["n_micro"] == 2
    kinds_b, kinds_r = b["collective_counts"], r["collective_counts"]
    if key == "gshard":
        # the microbatches' gradients add up on the tiles, not whole
        assert r["flops"] < b["flops"] and r["collective_bytes"] > b["collective_bytes"]
        assert kinds_r["reduce-scatter"] == 2 * kinds_b["reduce-scatter"]
        assert rec["memory_analysis"]["temp_size_in_bytes"] <= base["memory_analysis"]["temp_size_in_bytes"]
    elif key in ("seqshard", "seqgather"):
        assert r["flops"] == b["flops"] and r["collective_bytes"] > b["collective_bytes"]
        layers = configs.get_smoke_config("granite-8b").n_layers
        # a layer boundary a forward, again in its recompute and its backward
        assert kinds_r["reduce-scatter"] - kinds_b.get("reduce-scatter", 0) == 2 * 3 * layers
        if key == "seqgather":
            seq = _variant_cell(str(tmp_path), "seqshard=1")["roofline"]
            assert {k: r[k] for k in COUNTS} == {k: seq[k] for k in COUNTS}
    else:
        assert {k: r[k] for k in COUNTS} == {k: b[k] for k in COUNTS}


def test_variants_and_cli(small, tmp_path, capsys):
    cfg, extras = dryrun._apply_variant(configs.get_smoke_config("arctic-480b"), "block_k=64,capacity=2,group=16,gdtype=bf16")
    assert (cfg.block_k, cfg.capacity_factor, cfg.router_group) == (64, 2.0, 16)
    assert extras == {"accum": None, "gshard": False, "gdtype": torch.bfloat16}
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun._apply_variant(cfg, "nope=1")
    dryrun.main(["--arch", "mamba2-370m", "--out", str(tmp_path)])
    dryrun.main(["--arch", "mamba2-370m", "--out", str(tmp_path), "--skip-existing"])
    out = capsys.readouterr().out
    assert out.count("[ok] mamba2-370m") == 4 and out.count("[cached] mamba2-370m") == 4
