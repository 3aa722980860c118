"""The port's step specs (``repro_torch.launch.specs``) against the JAX
reference's ``repro.launch.specs``: the input specs, logical axes and
applicability of every LM config × shape, the parameter, optimizer and
decode-cache specs on the ``meta`` device (nothing allocated), and the
train and serve steps on the smoke configs on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.launch import specs as r_specs  # noqa: E402
from repro.optim import AdamWConfig as RAdamWConfig  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import model_api  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

LM_ARCHS = [a for a in t_configs.PORTED if a not in t_configs.VIDEO]
DTYPES = {jnp.dtype("int32"): torch.int32, jnp.dtype("float32"): torch.float32,
          jnp.dtype("bfloat16"): torch.bfloat16}
N_MICRO_ATOL = 1e-5


def _pair(arch):
    return r_configs.get_config(arch), t_configs.get_config(arch)


def test_tables_equal_the_reference():
    assert t_specs.SHAPES == r_specs.SHAPES
    assert t_specs.GRAD_ACCUM == r_specs.GRAD_ACCUM
    axes = {"w": ("embed", "mlp")}
    assert t_specs.opt_logical_axes(axes) == r_specs.opt_logical_axes(axes)


@pytest.mark.parametrize("shape", list(r_specs.SHAPES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_input_specs_axes_and_applicability_equal_the_reference(arch, shape):
    rcfg, tcfg = _pair(arch)
    assert t_specs.shape_applicable(tcfg, shape) == r_specs.shape_applicable(rcfg, shape)
    want = r_specs.input_specs(rcfg, shape)
    got = t_specs.input_specs(tcfg, shape)
    assert list(got) == list(want)
    for k, sds in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(sds.shape), k
        assert got[k].dtype == DTYPES[jnp.dtype(sds.dtype)], k
    assert t_specs.batch_logical_axes(tcfg, shape) == r_specs.batch_logical_axes(rcfg, shape)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_params_and_opt_specs_allocate_nothing(arch):
    """Every parameter on ``meta``, as many elements as the reference's
    ``params_specs`` traces, each dtype the reference's; the AdamW state
    on ``meta`` too."""
    rcfg, tcfg = _pair(arch)
    want, _ = r_specs.params_specs(rcfg)
    got = t_specs.params_specs(tcfg)
    assert all(p.device.type == "meta" for p in got.values())
    n_want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))
    assert sum(p.numel() for p in got.values()) == n_want
    want_dtypes = sorted(str(jnp.dtype(x.dtype)) for x in jax.tree.leaves(want))
    got_dtypes = sorted(str(p.dtype).removeprefix("torch.") for p in got.values())
    assert set(got_dtypes) == set(want_dtypes)
    opt = t_specs.opt_specs(AdamWConfig(), got)
    r_opt = r_specs.opt_specs(RAdamWConfig(), want)
    assert opt["step"].device.type == "meta" and opt["step"].dtype == torch.int32
    assert sum(m.numel() for m in opt["m"].values()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(r_opt["m"]))
    assert all(v.device.type == "meta" and v.dtype == torch.float32 for v in opt["v"].values())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m", "zamba2-2.7b", "whisper-tiny"])
def test_decode_cache_specs_match_the_reference(arch):
    """The decode cache on ``meta``: every tensor the reference's
    ``decode_cache_specs`` traces, at its shape."""
    rcfg, tcfg = _pair(arch)
    want, _ = r_specs.decode_cache_specs(rcfg, "decode_32k")
    got = t_specs.decode_cache_specs(tcfg, "decode_32k")
    for k, sds in want.items():
        if k == "length":
            continue
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(sds.shape), k


def _smoke_batch(cfg, B=4, S=16, seed=2):
    rng = np.random.RandomState(seed)
    batch = {
        "tokens": torch.from_numpy(rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)),
        "labels": torch.from_numpy(rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)),
    }
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.randn(B, cfg.n_frames, cfg.d_model).astype(np.float32))
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.randn(B, cfg.n_patches, cfg.d_model).astype(np.float32))
    return batch


def _trained(cfg, n_micro, batch):
    model = model_api.get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    model.requires_grad_(True)
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = adamw_init(opt_cfg, t_train.trainable(model))
    step = t_specs.make_train_step(cfg, opt_cfg, n_micro=n_micro)
    model, opt, metrics = step(model, opt, batch)
    return model, opt, metrics


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m", "whisper-tiny", "internvl2-2b"])
def test_make_train_step_microbatched_equals_whole(arch):
    """``n_micro=2`` gives ``n_micro=1``'s loss and parameters within 1e-5."""
    cfg = t_configs.get_smoke_config(arch)
    batch = _smoke_batch(cfg)
    m1, o1, met1 = _trained(cfg, 1, batch)
    m2, o2, met2 = _trained(cfg, 2, batch)
    assert abs(float(met1["loss"]) - float(met2["loss"])) <= N_MICRO_ATOL
    assert int(o1["step"]) == int(o2["step"]) == 1
    p2 = dict(m2.named_parameters())
    for n, p in m1.named_parameters():
        err = float(torch.max(torch.abs(p.detach() - p2[n].detach())))
        assert err <= N_MICRO_ATOL, (n, err)


def test_make_train_step_refuses_grad_shardings():
    """``grad_shardings`` that lacks a trainable parameter's name raises a
    ``ValueError`` naming it."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh

    cfg = t_configs.get_smoke_config("qwen2-1.5b")
    mesh = make_local_mesh(1, 2, devices=("cpu",) * 2)
    specs = t_specs.params_specs(cfg)
    gs = {n: shd.NamedSharding(mesh, shd.PartitionSpec(*(None,) * p.dim())) for n, p in specs.items()}
    missing = "layers.1.wk"
    del gs[missing]
    with pytest.raises(ValueError, match=r"layers\.1\.wk"):
        t_specs.make_train_step(cfg, AdamWConfig(), n_micro=2, grad_shardings=gs)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m", "whisper-tiny", "internvl2-2b"])
def test_make_serve_step_prefill_then_decode(arch, monkeypatch):
    """The serve steps are the model's prefill (a batch dict for the audio
    and VLM families) and decode: at a small shape they give the model's
    own prefill logits, and one decode step's logits are finite."""
    cfg = t_configs.get_smoke_config(arch)
    monkeypatch.setitem(t_specs.SHAPES, "prefill_tiny", dict(seq_len=24, global_batch=2, mode="prefill"))
    monkeypatch.setitem(t_specs.SHAPES, "decode_tiny", dict(seq_len=24, global_batch=2, mode="decode"))
    model = model_api.get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _smoke_batch(cfg, B=2, S=12)
    del batch["labels"]
    prefill = t_specs.make_serve_step(cfg, "prefill_tiny")
    decode = t_specs.make_serve_step(cfg, "decode_tiny")
    with torch.no_grad():
        logits, cache = prefill(model, batch)
        prompt = batch if cfg.family in ("audio", "vlm") else batch["tokens"]
        want = model.prefill(prompt, max_len=24)[0]
        nxt, _ = decode(model, cache, logits.argmax(-1)[:, None])
    assert torch.equal(logits, want)
    assert nxt.shape == (2, cfg.vocab) and bool(torch.isfinite(nxt).all())
