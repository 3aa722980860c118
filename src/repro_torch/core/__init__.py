# The STHC spectral correlation engine, ported to PyTorch (reference:
# repro.core).
from repro_torch.core import atomic, engine, fidelity, hybrid, optics, pseudo_negative, spectral_conv, throughput
from repro_torch.core.engine import FusedGrating, GratingCache, QueryEngine, default_cache
from repro_torch.core.fidelity import FidelityPipeline
from repro_torch.core.sthc import STHC, Grating, STHCConfig

__all__ = [
    "STHC",
    "STHCConfig",
    "Grating",
    "FidelityPipeline",
    "FusedGrating",
    "GratingCache",
    "QueryEngine",
    "default_cache",
    "atomic",
    "engine",
    "fidelity",
    "hybrid",
    "optics",
    "pseudo_negative",
    "spectral_conv",
    "throughput",
]
