"""tcnn_tpu_torch — the PyTorch + CUDA port of tcnn_tpu for NVIDIA Hopper.

Same JSON ``create_from_config`` surface, same flat fp32 parameter layout,
same numerics as the JAX package, which stays the reference. Hot paths run
hand-written CUDA kernels (``csrc/``) on the card and their plain torch
versions on the CPU. This package never imports jax or tcnn_tpu.

Ported so far: the serving path (grid encoding + fully fused MLP, the
trainer's inference half, ``FrozenServer``) and the training path
(RelativeL2/L2 losses, Adam + EMA, ``Trainer.training_step`` with the MLP
backward, grid backward and fused Adam kernels).
"""

__version__ = "0.1.0"

from . import encodings, losses, networks, ops, optimizers, utils
from .common import Activation, GridType, HashType, InterpolationType
from .config import TrainableModel, create_from_config, load_config, loads_config, strip_json_comments
from .encodings import builtin_encodings, create_encoding, register_encoding
from .interchange import params_from_numpy
from .losses import create_loss
from .network_with_input_encoding import NetworkWithInputEncoding
from .networks import create_network
from .optimizers import create_optimizer
from .serving import FrozenServer
from .trainer import Trainer

__all__ = [
    "Activation",
    "FrozenServer",
    "GridType",
    "HashType",
    "InterpolationType",
    "NetworkWithInputEncoding",
    "TrainableModel",
    "Trainer",
    "builtin_encodings",
    "create_encoding",
    "create_from_config",
    "create_loss",
    "create_network",
    "create_optimizer",
    "load_config",
    "loads_config",
    "params_from_numpy",
    "register_encoding",
    "strip_json_comments",
    "__version__",
]
