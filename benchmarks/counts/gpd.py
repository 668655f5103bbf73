"""GPDClassifier operations, counted from its layer widths (2 per
multiply-add; bias, max-pool, ReLU and log-softmax are not counted). At 12
channels on 60 x 60 images a sample's forward is 73,634,000: conv1
37,632,000, conv2 28,800,000, the two linear layers 7,202,000."""

from __future__ import annotations


def forward_flops(config: dict) -> int:
    """One sample's forward: each valid convolution, each 2 x 2 max-pool
    halving the side, then the linear layers."""
    side, cin, total = config["image_size"], config["input_chann"], 0
    for cout, kern in config["conv"]:
        side -= kern - 1
        total += 2 * side * side * cout * cin * kern * kern
        cin, side = cout, side // 2
    dims = (cin * side * side,) + tuple(config["fc"]) + (config["k"],)
    return total + 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def train_flops(config: dict) -> int:
    """A training sample: its forward and a backward of twice the
    forward."""
    return 3 * forward_flops(config)
