"""The base of the model configs (the ``TransformerConfig`` dataclass of
``repro.models.transformer``), which the other families' configs extend.

Only the fields a ported model reads are here, with the reference's
names and defaults; the dtype fields are torch dtypes.  The attention,
MLP and training fields come with the transformer slice, together with
the code that reads them.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "transformer"
    family: str = "dense"
    n_layers: int = 4
    d_model: int = 256
    vocab: int = 1024
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
