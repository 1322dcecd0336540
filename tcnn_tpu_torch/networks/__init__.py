"""Network factory (port of ``tcnn_tpu.networks``; reference:
src/network.cu:51-143 — FullyFusedMLP where the width allows, else the
plain MLP)."""

from __future__ import annotations

from typing import Dict, Optional

from ..common import json_value, string_to_activation
from ..utils.log import log_warning
from .base import Network
from .fully_fused import FFMLP_WIDTHS, FullyFusedMLP
from .mlp import MLP


def create_network(n_input_dims: int, n_output_dims: int, network: Optional[Dict] = None) -> Network:
    network = network or {}
    otype = json_value(network, "otype", "MLP")
    n_neurons = json_value(network, "n_neurons", 128)
    n_hidden_layers = json_value(network, "n_hidden_layers", 5)
    activation = string_to_activation(json_value(network, "activation", "ReLU"))
    output_activation = string_to_activation(json_value(network, "output_activation", "None"))

    kind = otype.lower()
    if kind not in ("mlp", "fullyfusedmlp", "megakernelmlp", "cutlassmlp"):
        raise ValueError(f"Invalid network type: {otype}")
    wants_fused = kind in ("mlp", "fullyfusedmlp", "megakernelmlp")
    if wants_fused and n_neurons not in FFMLP_WIDTHS:
        if kind == "fullyfusedmlp":
            log_warning(
                f"FullyFusedMLP supports widths {sorted(FFMLP_WIDTHS)}; got "
                f"{n_neurons}. Falling back to CutlassMLP (cf. network.cu:57-68)."
            )
        wants_fused = False

    kw = {}
    if wants_fused:
        # "layout" is validated and ignored by the constructor; "use_pallas"
        # is the JAX package's spelling of the same routing key.
        if json_value(network, "layout", None) is not None:
            kw["layout"] = json_value(network, "layout", None)
        use_kernel = json_value(network, "use_kernel", json_value(network, "use_pallas", None))
        if use_kernel is not None:
            kw["use_kernel"] = bool(use_kernel)
    cls = FullyFusedMLP if wants_fused else MLP
    return cls(
        input_width=n_input_dims,
        output_width=n_output_dims,
        n_neurons=n_neurons,
        n_hidden_layers=n_hidden_layers,
        activation=activation,
        output_activation=output_activation,
        **kw,
    )


def minimum_alignment(network: Optional[Dict] = None) -> int:
    """Input alignment required by a network config (reference:
    src/network.cu:79-98)."""
    return 16


__all__ = ["MLP", "FullyFusedMLP", "FFMLP_WIDTHS", "Network", "create_network", "minimum_alignment"]
