"""What one densify round does to a trained scene's PSNR, part by part.

    python -m priordepth_gaussiansplatting_torch.densify_probe \\
        <model>/chkpnt<it>.pkl <the train CLI's flags of that run>

Loads a training checkpoint (parameters and densify statistics), and
reports held-out and training PSNR (the trainer's ``report``) before the
round that iteration ``it + 1`` would run, and after each of these rounds,
all applied to the same loaded state:

- ``full``: the trainer's round (clone, split and prune);
- ``prune_only``: its prune alone (no Gaussian passes the gradient test);
- ``clone_only``/``split_only``: every Gaussian over the gradient threshold
  cloned, or split, and the same prune;
- ``prune_opacity_only``: the prune by opacity alone, without the size
  test against the scene extent.

It also prints the round's inputs: the extent, the Gaussians over the
gradient threshold, those pruned by opacity and by size, and quantiles of
the statistics. Each line of output is one JSON object. The split draws of
every round come from one generator seeded with ``--seed``.
"""

from __future__ import annotations

import json
import math
import sys

import numpy as np
import torch

from .models import densify as densify_ops
from .train.__main__ import build_trainer, parser

QUANTILES = (0.0, 0.25, 0.5, 0.75, 0.99, 1.0)


def quantiles(x: torch.Tensor) -> list:
    x = x.detach().float().cpu().numpy()
    return [float(v) for v in np.quantile(x, QUANTILES)] if x.size else []


def round_inputs(state, opt_cfg, use_size: bool) -> dict:
    active = state.active
    extent = float(state.spatial_lr_scale)
    max_scale = torch.max(state.get_scaling(), dim=-1).values
    grads = torch.where(state.denom > 0, state.xyz_gradient_accum
                        / torch.clamp_min(state.denom, 1.0),
                        torch.zeros_like(state.denom))
    high = (grads >= opt_cfg.densify_grad_threshold) & active
    low_opacity = (state.get_opacity() < 0.005) & active
    big = active & (max_scale > 0.1 * extent) if use_size \
        else torch.zeros_like(active)
    return {
        "n_active": int(active.sum()), "extent": extent,
        "use_size_threshold": use_size,
        "n_high_grad": int(high.sum()),
        "n_high_grad_split": int((high & (max_scale > opt_cfg.percent_dense
                                          * extent)).sum()),
        "n_prune_opacity": int(low_opacity.sum()),
        "n_prune_size": int(big.sum()),
        "n_prune_size_and_opacity": int((big & low_opacity).sum()),
        "quantiles": list(QUANTILES),
        "max_scale_q": quantiles(max_scale[active]),
        "max_scale_pruned_by_size_q": quantiles(max_scale[big]),
        "opacity_pruned_by_size_q": quantiles(state.get_opacity()[big]),
        "max_radii2d_pruned_by_size_q": quantiles(state.max_radii2d[big]),
        "max_radii2d_q": quantiles(state.max_radii2d[active]),
        "grad_q": quantiles(grads[active]),
        "denom_q": quantiles(state.denom[active]),
    }


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    checkpoint, args = argv[0], parser().parse_args(argv[1:])
    args.model_path = ""  # the probe writes no model files
    args.quiet = True
    tr = build_trainer(args)
    tr.restore(checkpoint)
    opt = tr.opt_cfg
    it = tr.iteration
    use_size = it + 1 > opt.opacity_reset_interval
    state, opt_state = tr.state, tr.opt_state
    out = [{"iteration": it, "round_inputs": round_inputs(state, opt,
                                                          use_size)},
           {"variant": "before", "psnr": tr.report(it)}]
    thr, pd = opt.densify_grad_threshold, opt.percent_dense
    variants = {"full": (thr, pd, use_size),
                "prune_only": (math.inf, pd, use_size),
                "clone_only": (thr, math.inf, use_size),
                "split_only": (thr, 0.0, use_size),
                "prune_opacity_only": (math.inf, pd, False)}
    for name, (max_grad, percent_dense, size) in variants.items():
        gen = torch.Generator(tr.device).manual_seed(args.seed)
        tr.state, _, info = densify_ops.densify_and_prune(
            state, opt_state, max_grad, 0.005, state.spatial_lr_scale,
            20.0 if size else 0.0, percent_dense=percent_dense,
            generator=gen)
        out.append({"variant": name,
                    "counts": {k: int(v) for k, v in info.items()},
                    "psnr": tr.report(it)})
    tr.state = state
    for row in out:
        print(json.dumps(row), flush=True)
    return out


if __name__ == "__main__":
    main()
