"""System adapter: the paper's hybrid 3-D CNN served by
``HybridClassifierServer`` (``repro_torch.launch.serve``).

The program under test is ``classify`` (one-shot clips) or
``classify_stream`` (long streams, every training-length segment
classified).  The adapter makes the weights itself from the seed, on the
card, in one ``randn``, loads them into a ``HybridCNN`` and hands the same
tensors to the reference; each call's clips are one ``rand`` from
``(seed, call index)``.  It keeps the logits each call's digital head
produced (the server's ``_head``, wrapped), beside the predictions it
returned, and compares both with ``reference.sthc``.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import Future

import numpy as np
import torch

from pbench import stats, traffic, yardstick
from pbench.fidelity import pipeline
from reference import sthc as ref

WARM_STREAM = 2**32  # data sub-stream of the warm-up clips, never a call index
REF_BLOCK_CLIPS = 32  # clips the float64 reference correlates at once


def param_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    """The network's parameters and their shapes (paper section 4)."""
    oh, ow, ot = m["height"] - m["k_h"] + 1, m["width"] - m["k_w"] + 1, m["frames"] - m["k_t"] + 1
    ph, pw, pt = m["pool_window"]
    features = (oh // ph) * (ow // pw) * (ot // pt) * m["num_kernels"]
    return {
        "conv_w": (m["num_kernels"], m["in_channels"], m["k_h"], m["k_w"], m["k_t"]),
        "conv_b": (m["num_kernels"],),
        "fc1_w": (features, m["hidden"]),
        "fc1_b": (m["hidden"],),
        "fc2_w": (m["hidden"], m["num_classes"]),
        "fc2_b": (m["num_classes"],),
    }


class System:
    def __init__(self, config: dict, mix: dict, seed: int, device: str, tracer, control: bool = False):
        self.config, self.mix, self.seed, self.device = config, mix, int(seed), device
        self.tracer = tracer
        self.control = control  # the reference in bfloat16 in the program's place
        self.calls: list[dict] = []
        self._logits = None

    def _check_device_model(self, sthc_config) -> None:
        """The server takes the correlator's default SLM and atoms: they
        have to be the configuration's."""
        ph = self.config["physics"]
        got = (sthc_config.slm.bits, sthc_config.atoms.t2_s, sthc_config.atoms.frame_time_s,
               sthc_config.atoms.ihb_profile, sthc_config.atoms.coverage, sthc_config.storage_interval_s)
        want = (ph["slm_bits"], ph["t2_s"], ph["frame_time_s"], ph["ihb_profile"], ph["ihb_coverage"],
                ph["storage_interval_s"])
        if got != want:
            raise ValueError(f"the server's device model {got} is not the configuration's {want}")

    def _weights(self) -> dict[str, torch.Tensor]:
        """He-scaled normal weights and small normal biases, one draw."""
        m = self.config["model"]
        shapes = param_shapes(m)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(traffic.request_seed(self.seed, traffic.STREAM_WEIGHTS))
        sizes = [math.prod(s) for s in shapes.values()]
        flat = torch.randn(sum(sizes), generator=gen, device=self.device)
        fan_in = {"conv_w": m["in_channels"] * m["k_h"] * m["k_w"] * m["k_t"],
                  "fc1_w": shapes["fc1_w"][0], "fc2_w": m["hidden"]}
        out, at = {}, 0
        for (name, shape), n in zip(shapes.items(), sizes):
            t = flat[at: at + n].reshape(shape)
            at += n
            scale = math.sqrt(2.0 / fan_in[name]) if name in fan_in else self.config["bias_std"]
            out[name] = t * scale
        return out

    def _clips(self, gen: torch.Generator, idx: int, n: int, frames: int) -> torch.Tensor:
        m = self.config["model"]
        gen.manual_seed(traffic.request_seed(self.seed, traffic.STREAM_DATA, idx))
        return torch.rand((n, m["in_channels"], m["height"], m["width"], frames), generator=gen,
                          device=self.device)

    def setup(self) -> None:
        from repro_torch.core import hybrid
        from repro_torch.launch.serve import HybridClassifierServer

        m = self.config["model"]
        cfg = hybrid.HybridConfig(
            height=m["height"], width=m["width"], frames=m["frames"], in_channels=m["in_channels"],
            num_kernels=m["num_kernels"], k_h=m["k_h"], k_w=m["k_w"], k_t=m["k_t"],
            pool_window=tuple(m["pool_window"]), hidden=m["hidden"], num_classes=m["num_classes"],
        )
        self.w = self._weights()
        params = hybrid.HybridCNN(cfg, self.device)
        with torch.no_grad():
            for name, t in self.w.items():
                getattr(params, name).copy_(t)
        self.server = HybridClassifierServer(params, cfg, fidelity=pipeline(self.config["fidelity"], self.config["physics"]), device=self.device)
        self._check_device_model(self.server.sthc.config)
        head = self.server._head

        def kept(conv_out):
            self._logits = head(conv_out)
            return self._logits

        self.server._head = kept
        self._gen = torch.Generator(device=self.device)
        fields = self.mix["request"]
        warm = self._clips(self._gen, WARM_STREAM, fields["clips"], fields["frames"])
        self._call(fields["op"], warm)
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def _call(self, op: str, x: torch.Tensor) -> np.ndarray:
        if op == "classify":
            return self.server.classify(x)
        if op == "classify_stream":
            return self.server.classify_stream(x)
        raise ValueError(f"unknown op {op!r}")

    def issue(self, rec: traffic.Rec) -> Future:
        p = rec.params
        with self.tracer.span("generate"):
            x = self._clips(self._gen, rec.idx, p["clips"], p["frames"])
        t0 = time.perf_counter()
        with self.tracer.span(p["op"]):
            preds = self._call(p["op"], x)
        self.calls.append({"t0": t0, "t1": time.perf_counter(), "op": p["op"], "clips": p["clips"],
                           "frames": p["frames"]})
        fut: Future = Future()
        fut.set_result({"preds": preds, "logits": self._logits})
        return fut

    def is_rejection(self, exc: BaseException) -> bool:
        return False

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        del self.server

    # -- work --------------------------------------------------------------

    def frames(self, rec: traffic.Rec) -> int:
        return int(rec.params["clips"]) * int(rec.params["frames"])

    def _head_flops(self) -> float:
        m = self.config["model"]
        features = param_shapes(m)["fc1_w"][0]
        return 2.0 * (features * m["hidden"] + m["hidden"] * m["num_classes"])

    def model_flops(self, rec: traffic.Rec) -> float:
        """The spectral correlation at the paper's clip geometry (one clip;
        each coherence window of a stream's overlap-save plan) plus the
        head's two GEMMs for every clip or segment classified."""
        m = self.config["model"]
        p = rec.params
        per_window = yardstick.fft_flops(m["height"], m["width"], m["frames"], m["in_channels"],
                                         m["num_kernels"], m["k_h"], m["k_w"], m["k_t"])
        if p["op"] == "classify":
            return float(p["clips"] * (per_window + self._head_flops()))
        plan = yardstick.stream_plan(p["frames"], m["k_t"], m["frames"])
        n_seg = plan.n_valid // (m["frames"] - m["k_t"] + 1)
        return float(p["clips"] * (plan.n_blocks * per_window + n_seg * self._head_flops()))

    # -- correctness -------------------------------------------------------

    def _reference(self, x: torch.Tensor, op: str, k_eff: torch.Tensor, dtype: str) -> torch.Tensor:
        """Logits in the program's row order: (clips, classes) one-shot,
        (n_seg * streams, classes) segment-major for streams."""
        m, fid, ph = self.config["model"], self.config["fidelity"], self.config["physics"]
        pool = tuple(m["pool_window"])
        if op == "classify":
            return torch.cat([
                ref.hybrid_logits(x[i: i + REF_BLOCK_CLIPS], self.w, k_eff, fid, ph, pool,
                                  m["frames"], stream=False, dtype=dtype)
                for i in range(0, x.shape[0], REF_BLOCK_CLIPS)
            ])
        per = [ref.hybrid_logits(x[b: b + 1], self.w, k_eff, fid, ph, pool, m["frames"],
                                 stream=True, dtype=dtype) for b in range(x.shape[0])]
        return torch.stack(per, dim=1).reshape(-1, per[0].shape[-1])

    @torch.no_grad()
    def check(self, sample: list[traffic.Rec], run) -> dict:
        """``answer_err``: over the sampled calls' clips (segments), the
        larger of how far a served logit lies from the reference's and how
        far the reference's logit of the served class lies below its best,
        as a share of the median over the call of the reference's largest
        logit magnitude.  One number for both: the lower-precision control
        moves the logits on every seed but flips a class only on some."""
        k_eff = ref.effective_kernels(self.w["conv_w"], self.config["fidelity"], self.config["physics"])
        gen = torch.Generator(device=self.device)
        worst = 0.0
        for rec in sample:
            p = rec.params
            x = self._clips(gen, rec.idx, p["clips"], p["frames"])
            want = self._reference(x, p["op"], k_eff, "float64")
            if self.control:
                got = self._reference(x, p["op"], k_eff, "bf16").to(torch.float64)
                preds = got.argmax(-1)
            else:
                got = rec.result["logits"].to(torch.float64)
                served = np.asarray(rec.result["preds"])
                if served.ndim == 2:  # (streams, n_seg) -> segment-major rows
                    served = served.T
                preds = torch.as_tensor(served.reshape(-1), dtype=torch.long, device=want.device)
            if got.shape != want.shape or preds.shape[0] != want.shape[0]:
                return {"answer_err": math.inf}
            if bool(((preds < 0) | (preds >= want.shape[-1])).any()):
                return {"answer_err": math.inf}
            scale = want.abs().amax(-1).median()
            gap = want.amax(-1) - want.gather(-1, preds[:, None])[:, 0]
            worst = stats.worst(worst, (got - want).abs().max() / scale)
            worst = stats.worst(worst, gap.max() / scale)
        return {"answer_err": worst}
