"""Plain PyTorch versions of the hand-written kernels.

Each repeats its kernel's arithmetic in fp32 and casts back at the end.
The kernel wrappers (``kernels.tt_contract``) run these for CPU tensors;
``chip_smoke.py`` holds every kernel against its plain version on the card.
"""
from __future__ import annotations

import torch


def tt_fused2_ref(x: torch.Tensor, p2: torch.Tensor, p1: torch.Tensor,
                  dims: tuple[int, int, int, int, int],
                  scales: torch.Tensor | None = None) -> torch.Tensor:
    """Whole d=2 TT layer on packed cores, ``x [B, n1·n2] → y [B, m1·m2]``
    (the body of ``repro.kernels.tt_contract._fused2_body``).

    ``p2 [n2, m2·r1]``, ``p1 [n1·r1, m1]``; with ``scales`` ([2] fp32 in
    execution order ``[s2, s1]``) the cores are int8 codes and each
    matmul's output is multiplied by its core's scale.  The intermediate
    stays fp32 for every activation dtype.
    """
    n1, n2, m1, m2, r1 = dims
    B = x.shape[0]
    f32 = torch.float32
    a = x.reshape(B * n1, n2).to(f32) @ p2.to(f32)             # stage 1
    if scales is not None:
        a = a * scales[0]
    a = a.reshape(B, n1, m2, r1).permute(0, 2, 1, 3)           # relayout
    y = a.reshape(B * m2, n1 * r1) @ p1.to(f32)                # stage 2
    if scales is not None:
        y = y * scales[1]
    y = y.reshape(B, m2, m1).permute(0, 2, 1)                  # m-major
    return y.reshape(B, m1 * m2).to(x.dtype)
