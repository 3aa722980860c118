"""The port's dry run (``repro_torch.launch.dryrun``) on the ``meta``
device: ``run_cell`` on the smoke config of each LM family over the
four shapes (``specs.SHAPES`` patched small), its record's keys, the
skip reasons against the reference's ``shape_applicable``, the
parameter and model-FLOP counts, and the mesh options raising."""

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


@pytest.mark.parametrize("mesh", ["single", "multi", "both"])
def test_mesh_options_raise(mesh, small, tmp_path):
    with pytest.raises(NotImplementedError, match="A.7b"):
        dryrun.run_cell("qwen2-1.5b", "train_4k", mesh=mesh, out_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="A.8b"):
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k", "--mesh", mesh, "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("key", ["gshard", "wgather", "lean", "seqshard", "seqgather"])
def test_mesh_variants_raise(key, small, tmp_path):
    with pytest.raises(NotImplementedError, match="A.7b"):
        dryrun.run_cell("qwen2-1.5b", "train_4k", variant=f"{key}=1", out_dir=str(tmp_path))


def test_variants_and_cli(small, tmp_path, capsys):
    cfg, extras = dryrun._apply_variant(configs.get_smoke_config("arctic-480b"), "block_k=64,capacity=2,group=16,gdtype=bf16")
    assert (cfg.block_k, cfg.capacity_factor, cfg.router_group) == (64, 2.0, 16)
    assert extras == {"accum": None, "gdtype": torch.bfloat16}
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun._apply_variant(cfg, "nope=1")
    dryrun.main(["--arch", "mamba2-370m", "--out", str(tmp_path)])
    dryrun.main(["--arch", "mamba2-370m", "--out", str(tmp_path), "--skip-existing"])
    out = capsys.readouterr().out
    assert out.count("[ok] mamba2-370m") == 4 and out.count("[cached] mamba2-370m") == 4
