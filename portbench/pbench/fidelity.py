"""The program's fidelity pipeline for a configuration's named stage set,
with the stage parameters the configuration's ``physics`` states (the
reference models the same names in ``reference/sthc.py``)."""

from __future__ import annotations


def pipeline(name: str, physics: dict):
    from repro_torch.core import fidelity as fid

    if name == "ideal":
        return fid.ideal()
    if name == "slm_quantize":
        return fid.pipeline(fid.SLMQuantize())
    if name == "physical":
        return fid.FidelityPipeline(
            (fid.PseudoNegative(), fid.SLMQuantize(), fid.IHBEnvelope(), fid.T2Apodize(),
             fid.EchoGain(),
             fid.PulseCompensate(compensate=physics["pulse_compensate"],
                                 duration_frames=physics["pulse_duration_frames"],
                                 floor=physics["pulse_floor"])),
            name="physical",
        )
    raise ValueError(f"unknown fidelity {name!r}")
