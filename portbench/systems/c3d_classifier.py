"""System adapter: C3D (Tran et al., ICCV 2015) at its published widths,
served by ``C3DClassifierServer`` (``repro_torch.launch.serve``).

The program under test is ``classify``: one call classifies a batch of
clips through the eight convolutions on kernel B4 and fc6–fc8.  The
adapter makes the weights itself from the seed, on the card, in one
``randn``, loads them into a ``C3D`` and hands the same tensors to the
reference; each call's clips are one ``rand`` from ``(seed, call
index)``.  It keeps the logits each call's head produced (the server's
``_head``, wrapped) beside the predictions it returned, and compares a
seeded four clips of each sampled call, two from each half of its batch,
with ``reference.c3d`` in float64.  ``counters()`` reads B4's launch
counters by route, where the program has them.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import Future

import numpy as np
import torch

from pbench import c3d_cost, stats, traffic
from reference import c3d as ref

WARM_STREAM = 2**32  # data sub-stream of the warm-up clips, never a call index
REF_CLIPS = 4  # clips of a sampled call the float64 reference recomputes


def param_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    """The network's parameters and their shapes, in the order drawn:
    each convolution's (O, C, kT, kH, kW) weight and bias, then each fully
    connected layer's (in, out) weight and bias."""
    k = m["kernel"]
    out: dict[str, tuple[int, ...]] = {}
    for name, c, o, *_ in c3d_cost.convs(m):
        out[f"{name}_w"] = (o, c, k, k, k)
        out[f"{name}_b"] = (o,)
    for i, (a, b) in enumerate(c3d_cost.fcs(m)):
        out[f"fc{6 + i}_w"] = (a, b)
        out[f"fc{6 + i}_b"] = (b,)
    return out


class System:
    def __init__(self, config: dict, mix: dict, seed: int, device: str, tracer, control: bool = False):
        self.config, self.mix, self.seed, self.device = config, mix, int(seed), device
        self.tracer = tracer
        self.control = control  # the reference with TF32 on in the program's place
        self.calls: list[dict] = []
        self._logits = None

    def _weights(self) -> dict[str, torch.Tensor]:
        """He-scaled normal weights and small normal biases, one draw."""
        shapes = param_shapes(self.config["model"])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(traffic.request_seed(self.seed, traffic.STREAM_WEIGHTS))
        sizes = [math.prod(s) for s in shapes.values()]
        flat = torch.randn(sum(sizes), generator=gen, device=self.device)
        out, at = {}, 0
        for (name, shape), n in zip(shapes.items(), sizes):
            t = flat[at: at + n].reshape(shape)
            at += n
            fan = shape[0] if len(shape) == 2 else math.prod(shape[1:])
            out[name] = t * (math.sqrt(2.0 / fan) if name.endswith("_w") else self.config["bias_std"])
        return out

    def _clips(self, gen: torch.Generator, idx: int, n: int) -> torch.Tensor:
        m = self.config["model"]
        gen.manual_seed(traffic.request_seed(self.seed, traffic.STREAM_DATA, idx))
        return torch.rand((n, m["in_channels"], m["height"], m["width"], m["frames"]), generator=gen,
                          device=self.device)

    def setup(self) -> None:
        from repro_torch.configs.c3d_sports1m import C3DConfig
        from repro_torch.launch.serve import C3DClassifierServer
        from repro_torch.models import c3d

        m = self.config["model"]
        cfg = C3DConfig(
            height=m["height"], width=m["width"], frames=m["frames"], in_channels=m["in_channels"],
            stages=tuple(tuple(s) for s in m["stages"]), pools=tuple(tuple(p) for p in m["pools"]),
            fc=tuple(m["fc"]), num_classes=m["num_classes"],
        )
        self.w = self._weights()
        if c3d.param_shapes(cfg) != {k: tuple(t.shape) for k, t in self.w.items()}:
            raise ValueError("the program's C3D parameters are not the configuration's")
        params = c3d.C3D(cfg, self.device)
        with torch.no_grad():
            for name, t in self.w.items():
                getattr(params, name).copy_(t)
        self.server = C3DClassifierServer(params, device=self.device)
        head = self.server._head

        def kept(features):
            self._logits = head(features)
            return self._logits

        self.server._head = kept
        self._gen = torch.Generator(device=self.device)
        self.server.classify(self._clips(self._gen, WARM_STREAM, self.mix["request"]["clips"]))
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def issue(self, rec: traffic.Rec) -> Future:
        p = rec.params
        if p["op"] != "classify" or p["frames"] != self.config["model"]["frames"]:
            raise ValueError(f"C3D classifies {self.config['model']['frames']}-frame clips: {p}")
        with self.tracer.span("generate"):
            x = self._clips(self._gen, rec.idx, p["clips"])
        t0 = time.perf_counter()
        with self.tracer.span("classify"):
            preds = self.server.classify(x)
        self.calls.append({"t0": t0, "t1": time.perf_counter(), "op": "classify", "clips": p["clips"],
                           "frames": p["frames"]})
        fut: Future = Future()
        fut.set_result({"preds": preds, "logits": self._logits})
        return fut

    def is_rejection(self, exc: BaseException) -> bool:
        return False

    def counters(self) -> dict:
        from repro_torch.kernels.conv3d import kernel

        routes = getattr(kernel.conv3d_cuda, "route_launches", {})
        return {f"b4_launches.{r}": int(n) for r, n in routes.items()}

    def release(self) -> None:
        del self.server

    # -- work --------------------------------------------------------------

    def frames(self, rec: traffic.Rec) -> int:
        return int(rec.params["clips"]) * int(rec.params["frames"])

    def model_flops(self, rec: traffic.Rec) -> float:
        """The convolutions and fc6–fc8 for every clip classified."""
        return float(rec.params["clips"] * c3d_cost.model_flops_per_clip(self.config["model"]))

    # -- correctness -------------------------------------------------------

    def _picked(self, idx: int, n: int) -> list[int]:
        """REF_CLIPS clips of a call of n, half from each half of the batch."""
        rng = traffic.rng(self.seed, traffic.STREAM_SAMPLE, idx)
        half, k = n // 2, REF_CLIPS // 2
        lo = rng.choice(half, size=min(k, half), replace=False)
        hi = half + rng.choice(n - half, size=min(REF_CLIPS - k, n - half), replace=False)
        return sorted(int(i) for i in np.concatenate([lo, hi]))

    @torch.no_grad()
    def check(self, sample: list[traffic.Rec], run) -> dict:
        """``answer_err``: over the picked clips of the sampled calls, the
        larger of how far a served logit lies from the reference's and how
        far the reference's logit of the served class lies below its best,
        as a share of the median over the picked clips of the reference's
        largest logit magnitude."""
        m = self.config["model"]
        gen = torch.Generator(device=self.device)
        worst = 0.0
        for rec in sample:
            n = rec.params["clips"]
            pick = self._picked(rec.idx, n)
            x = self._clips(gen, rec.idx, n)[pick]
            want = ref.logits(x, self.w, m, "float64")
            if self.control:
                got = ref.logits(x, self.w, m, "tf32").to(torch.float64)
                preds = got.argmax(-1)
            else:
                logits = rec.result["logits"]
                served = np.asarray(rec.result["preds"])
                if logits is None or logits.shape[0] != n or served.shape != (n,):
                    return {"answer_err": math.inf}
                got = logits[pick].to(torch.float64)
                preds = torch.as_tensor(served[pick], dtype=torch.long, device=want.device)
            if got.shape != want.shape or bool(((preds < 0) | (preds >= want.shape[-1])).any()):
                return {"answer_err": math.inf}
            scale = want.abs().amax(-1).median()
            gap = want.amax(-1) - want.gather(-1, preds[:, None])[:, 0]
            worst = stats.worst(worst, (got - want).abs().max() / scale)
            worst = stats.worst(worst, gap.max() / scale)
        return {"answer_err": worst}
