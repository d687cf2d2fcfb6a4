"""Feed-forward complex AGC (port of sdrtrunk_tpu/dsp/agc.py:19-39).

Normalizes by the max envelope over a trailing window; the reference's
``reduce_window`` max becomes ``max_pool1d`` over the carried history and
the block, batched over channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["feed_forward_agc", "feed_forward_agc_init"]

OBJECTIVE_ENVELOPE = 1.0
MINIMUM_ENVELOPE = 0.0001


def feed_forward_agc_init(window: int = 32, device="cuda") -> torch.Tensor:
    """Initial envelope history (zeros, window - 1 values)."""
    return torch.zeros((window - 1,), dtype=torch.float32, device=device)


def feed_forward_agc(x: torch.Tensor, state: torch.Tensor | None = None,
                     window: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """y[c, n] = x[c, n] / max(env(x[c, n-window+1 .. n]), MINIMUM_ENVELOPE)
    over (C, T) complex x from the envelope history ``state`` (C, window -
    1), zeros for None. Returns (normalized x, new envelope history)."""
    if state is None:
        state = torch.zeros((x.shape[0], window - 1), dtype=torch.float32,
                            device=x.device)
    env = torch.abs(x)
    padded = torch.cat([state, env], dim=1)               # (C, W-1+T)
    max_env = F.max_pool1d(padded[:, None, :], window, stride=1)[:, 0]
    gain = OBJECTIVE_ENVELOPE / torch.clamp_min(max_env, MINIMUM_ENVELOPE)
    y = torch.view_as_complex(torch.view_as_real(x) * gain[..., None])
    return y, padded[:, padded.shape[1] - (window - 1):]
