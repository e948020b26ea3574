"""Complex-ratio-mask (cRM) math (the port of `dl4ss_tpu/ops/crm.py`).

TDAA's phase-aware path: real/imag packed as a trailing dim-2 channel
(TDAA_beta/predata_fromList_cRM_123.py:37-42), the tanh-compressed mask
K*tanh(energy) with K=10, C=0.1 (main_run_sstune_cRM_EvalVer.py:28-29,269),
the uncompression -1/C*log((K-M)/(K+M)) (:512), and the complex multiply
(Mr*Xr - Mi*Xi, Mr*Xi + Mi*Xr) (:552-553).
"""

from __future__ import annotations

import torch


def pack_ri(spec: torch.Tensor) -> torch.Tensor:
    """complex (..., T, F) -> real (..., T, F, 2) with [real, imag] channels."""
    return torch.stack([spec.real, spec.imag], dim=-1)


def unpack_ri(ri: torch.Tensor) -> torch.Tensor:
    """real (..., T, F, 2) -> complex (..., T, F)."""
    return torch.complex(ri[..., 0], ri[..., 1])


def crm_compress(mask_ri: torch.Tensor, k: float = 10.0, c: float = 0.1
                 ) -> torch.Tensor:
    """M_compressed = K * tanh(C/2 * M): the exact inverse of
    `crm_uncompress`."""
    return k * torch.tanh(0.5 * c * mask_ri)


def crm_uncompress(mask_ri: torch.Tensor, k: float = 10.0, c: float = 0.1,
                   eps: float = 1e-6) -> torch.Tensor:
    """M = -1/C * log((K - M_c) / (K + M_c)), inputs clipped inside (-K, K)
    to keep the log finite (main_run_sstune_cRM_EvalVer.py:512)."""
    m = torch.clamp(mask_ri, -k + eps, k - eps)
    return -(1.0 / c) * torch.log((k - m) / (k + m))


def complex_mask_apply(mask_ri: torch.Tensor, spec_ri: torch.Tensor
                       ) -> torch.Tensor:
    """(Mr + iMi) * (Xr + iXi), both packed as trailing dim-2 channels."""
    mr, mi = mask_ri[..., 0], mask_ri[..., 1]
    xr, xi = spec_ri[..., 0], spec_ri[..., 1]
    return torch.stack([mr * xr - mi * xi, mr * xi + mi * xr], dim=-1)
