"""create_from_config — the JSON entry point (port of ``tcnn_tpu.config``;
reference: config.h:46-63). The same JSON document that drives the JAX
package builds the PyTorch model, its loss and optimizer and the trainer
here, on the card unless the caller names another device."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict

import torch

from .losses import Loss
from .network_with_input_encoding import NetworkWithInputEncoding
from .optimizers import Optimizer
from .trainer import Trainer


@dataclass
class TrainableModel:
    """The JAX package's ``TrainableModel`` (tcnn_tpu/config.py:27-31):
    the model, its trainer, and the trainer's loss and optimizer."""

    model: NetworkWithInputEncoding
    trainer: Trainer
    loss: Loss
    optimizer: Optimizer

    def training_step(self, inputs, targets, data_pdf=None):
        return self.trainer.training_step(inputs, targets, data_pdf)

    def inference(self, inputs) -> torch.Tensor:
        return self.trainer.inference(inputs)

    @property
    def params(self) -> torch.Tensor:
        return self.trainer.params


def strip_json_comments(text: str) -> str:
    """Remove ``//``/``#`` line comments and ``/* */`` block comments from a
    JSON document, string-literal aware (the reference's apps parse configs
    with nlohmann's ``skip_comments=true``). Comment bytes become spaces
    (newlines kept) so error positions still line up with the source."""
    out = list(text)
    i, n = 0, len(text)
    in_string = False
    while i < n:
        c = text[i]
        if in_string:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_string = False
            i += 1
        elif c == '"':
            in_string = True
            i += 1
        elif (c == "/" and i + 1 < n and text[i + 1] == "/") or c == "#":
            while i < n and text[i] != "\n":
                out[i] = " "
                i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            out[i] = out[i + 1] = " "
            i += 2
            while i < n and not (text[i] == "*" and i + 1 < n and text[i + 1] == "/"):
                if text[i] != "\n":
                    out[i] = " "
                i += 1
            if i >= n:
                raise ValueError("unterminated /* */ comment in JSON config")
            out[i] = out[i + 1] = " "
            i += 2
        else:
            i += 1
    return "".join(out)


def loads_config(text: str) -> Dict:
    """``json.loads`` with comments tolerated (see strip_json_comments)."""
    return json.loads(strip_json_comments(text))


def load_config(path) -> Dict:
    """Read a (possibly commented) JSON config file."""
    with open(path, "r") as f:
        return loads_config(f.read())


def create_from_config(
    n_input_dims: int,
    n_output_dims: int,
    config: Dict,
    seed: int = 1337,
    precision=None,
    split_grid_state: bool = False,
    device=None,
) -> TrainableModel:
    """The model, loss, optimizer and trainer of ``config`` on ``device``
    (default: the CUDA card, ``common.default_device``; ``"cpu"`` runs the
    kernels' plain versions on the CPU). The parameters before ``device``
    are the JAX package's, in its order; ``split_grid_state=True`` raises,
    as ``Trainer`` does."""
    model = NetworkWithInputEncoding(
        n_input_dims,
        n_output_dims,
        encoding_config=config.get("encoding", {}),
        network_config=config.get("network", {}),
        precision=precision,
        device=device,
    )
    trainer = Trainer(model, config.get("optimizer", {}), config.get("loss", {}), seed=seed,
                      split_grid_state=split_grid_state)
    return TrainableModel(model=model, trainer=trainer, loss=trainer.loss, optimizer=trainer.optimizer)
