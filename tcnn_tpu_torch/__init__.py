"""tcnn_tpu_torch — the PyTorch + CUDA port of tcnn_tpu for NVIDIA Hopper.

Same JSON ``create_from_config`` surface, same flat fp32 parameter layout,
same numerics as the JAX package, which stays the reference. Hot paths run
hand-written CUDA kernels (``csrc/``) on the card and their plain torch
versions on the CPU. This package never imports jax or tcnn_tpu.

Ported so far: the serving path (grid encoding + fully fused MLP, the
trainer's inference half, ``FrozenServer``), the training path (every loss
the JAX package registers; Adam, SGD, Novograd, Composite and the EMA,
Average, Batched, Lookahead and ExponentialDecay wrappers;
``Trainer.training_step`` with the MLP backward, grid backward and fused
Adam kernels, and ``Trainer.training_steps``, one step captured as a CUDA
graph and replayed), checkpoints (``interchange``: the reference's snapshot
layout, byte for byte the JAX package's; ``utils.checkpoint``: npz) and
``update_hyperparams`` / ``hyperparams``, and the module API
(``modules.Encoding``, ``Network``, ``NetworkWithInputEncoding`` as
``torch.nn`` modules, differentiable twice with respect to params and inputs
through the grid's input-gradient and double-backward kernels; the
packed-I/O ``FullyFusedMLP.apply_packed``), and every encoding the JAX
package registers (the spherical harmonics through their own kernel), with
the radiance-field sample ``samples.nerf_synthetic``, and the multi-GPU
layer ``parallel`` over ``torch.distributed`` (``DataParallelTrainer``,
``TableParallelGrid`` and ``TableParallelTrainer`` with the windowed grid
kernels of a row-sharded table, ``make_mesh``; ``FrozenServer(mesh=)``).
Entry points run on the CUDA card unless the caller names another device.
"""

__version__ = "0.1.0"

from . import encodings, interchange, losses, modules, networks, ops, optimizers, parallel, utils
from .common import Activation, GridType, HashType, InterpolationType, ReductionType, default_device, default_loss_scale
from .config import TrainableModel, create_from_config, load_config, loads_config, strip_json_comments
from .encodings import builtin_encodings, create_encoding, register_encoding
from .interchange import params_from_numpy
from .losses import builtin_losses, create_loss, register_loss
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
    "ReductionType",
    "TrainableModel",
    "Trainer",
    "builtin_encodings",
    "builtin_losses",
    "create_encoding",
    "create_from_config",
    "create_loss",
    "create_network",
    "create_optimizer",
    "default_device",
    "default_loss_scale",
    "load_config",
    "loads_config",
    "modules",
    "params_from_numpy",
    "register_encoding",
    "register_loss",
    "strip_json_comments",
    "__version__",
]
