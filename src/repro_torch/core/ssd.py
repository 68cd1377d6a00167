"""SSD (Mamba-2) reference math: the exact sequential recurrence.

Port of ``repro.core.ssd.ssd_reference``: the slow, obviously-correct
oracle that the fused prefill (``kernels/prefill_chunk.py``) is held to.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *,
                  initial_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(L) sequential recurrence, fp32 throughout.

    ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``;  ``y_t = C_t . h_t``.
    x: (b, l, h, p); dt: (b, l, h); A: (h,); B, C: (b, l, g, n).
    Returns (y (b, l, h, p) in x's dtype, final state (b, h, p, n) fp32).
    """
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf = B.float().repeat_interleave(hpg, dim=2)              # (b, l, h, n)
    Cf = C.float().repeat_interleave(hpg, dim=2)
    state = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(l):
        dtt = dtf[:, t]                                       # (b, h)
        decay = torch.exp(dtt * Af[None, :])
        dBx = dtt[..., None, None] * Bf[:, t, :, None, :] * \
            xf[:, t, ..., None]
        state = state * decay[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state
