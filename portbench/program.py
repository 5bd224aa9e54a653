"""The program under test, built from a configuration file, and the
benchmark's own weights.

The weights are drawn by the benchmark from the seed, on the device in one
call, in the shapes and with the bounds the configuration lists (uniform in
±bound, torch.nn.Linear's default), and copied into the program's
parameters by the names the configuration gives. The same tensors, by their
roles, go to the reference.
"""

from __future__ import annotations

import torch

from portbench.traffic import device_generator


def draw_weights(config: dict, seed: int, device) -> dict:
    """{role: tensor} for every weight the configuration lists."""
    specs = config["weights"]
    sizes = [int(torch.Size(s["shape"]).numel()) for s in specs]
    flat = torch.rand(sum(sizes), generator=device_generator(seed, device),
                      device=device) * 2 - 1
    return {s["role"]: (part * s["bound"]).view(s["shape"])
            for s, part in zip(specs, flat.split(sizes))}


def build(config: dict, weights: dict, device):
    """The program's model for `config`, holding `weights`."""
    import gcm_tpu_torch

    model = getattr(gcm_tpu_torch, config["preset"])(
        device=device, **config["preset_kwargs"])
    params = dict(model.named_parameters())
    names = {s["param"] for s in config["weights"]}
    if names != set(params):
        raise RuntimeError(
            f"{config['name']}: the program's parameters "
            f"{sorted(params)} are not the configuration's {sorted(names)}")
    with torch.no_grad():
        for s in config["weights"]:
            params[s["param"]].copy_(weights[s["role"]])
    return model


def roles(config: dict) -> dict:
    """{program parameter name: role}."""
    return {s["param"]: s["role"] for s in config["weights"]}
