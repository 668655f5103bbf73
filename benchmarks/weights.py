"""Weights of a configuration, made on the device from the seed in a few
large draws and handed to the program and the reference alike."""

from __future__ import annotations

import math

import torch

from .draws import generator
from .reference import pointnet


def make(config: dict, seed: int, device) -> dict:
    """name -> float32 tensor for every parameter and BatchNorm statistic
    (reference names). Linear and conv weights and biases are uniform in
    +-1/sqrt(fan_in), as torch initializes them; BatchNorm scales and
    running variances in [0.5, 1.5), shifts and running means in [-0.1,
    0.1): folding them into the trunks is part of what is checked."""
    shapes = pointnet.param_shapes(config["k"], config["input_chann"],
                                   tuple(config["trunk_widths"]),
                                   tuple(config["fc_widths"]))
    total = sum(math.prod(s) for _, s in shapes)
    u = torch.rand(total, generator=generator(device, seed, "weights"),
                   device=device)
    out, off = {}, 0
    fan_in = 1
    for name, shape in shapes:
        n = math.prod(shape)
        x = u[off:off + n].reshape(shape)
        off += n
        kind = name.rsplit(".", 1)[1]
        if ".bn" in name or name.startswith("bn"):
            v = 0.5 + x if kind in ("weight", "running_var") \
                else (x - 0.5) * 0.2
        else:
            if kind == "weight":
                fan_in = math.prod(shape[1:])
            v = (x * 2.0 - 1.0) / math.sqrt(fan_in)
        out[name] = v.contiguous()
    return out


def calibrate(params: dict, clouds, valid) -> None:
    """Fit the random network to the benchmark's own crops (G, N, 3), in
    place: every BatchNorm's running statistics become those of the crops
    (as training would leave them; each variance raised by the layer's
    median variance), then the last layer's bias moves so that
    each class's median log-probability over the crops is the same. Random
    running statistics leave the classes' probabilities all but equal for
    every input, and a ranking of good candidates with nothing to rank.
    Computed by the plain reference before the program gets the weights."""
    if not bool(valid.any()):
        return
    x = clouds[valid]
    stats = {}
    pointnet.forward(dict(params, _stats=stats), x, train=True)
    for name, (mean, var) in stats.items():
        # a channel all but constant over the crops would blow rounding up
        # by 1/sqrt(var + eps): floor it at the layer's median variance
        params[f"{name}.running_mean"] = mean
        params[f"{name}.running_var"] = var + var.median()
    logp = pointnet.forward_blocks(params, x)
    params["fc3.bias"] = params["fc3.bias"] - logp.median(dim=0).values
