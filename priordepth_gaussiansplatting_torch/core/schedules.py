"""Learning-rate schedules (counterpart of the JAX package's
``core/schedules.py``).

The exponential (log-linear) decay with an optional sine warm-up delay that
the reference applies to Gaussian positions and exposures. The step is a
host integer, so the schedule costs the card nothing; the arithmetic is done
in f32, as the JAX package does it.
"""

from __future__ import annotations

import numpy as np


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000) -> float:
    """Log-linear interpolation lr_init -> lr_final over max_steps.

    Returns 0 for negative steps or when both endpoints are 0 (the
    reference's "disabled parameter" convention)."""
    f32 = np.float32
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    step = f32(step)
    if step < 0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1.0 - lr_delay_mult) * np.sin(
            f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0.0),
                                       f32(1.0)))
    else:
        delay_rate = f32(1.0)
    t = np.clip(step / f32(max_steps), f32(0.0), f32(1.0))
    log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1.0) - t)
                      + np.log(f32(lr_final)) * t)
    return float(f32(delay_rate * log_lerp))
