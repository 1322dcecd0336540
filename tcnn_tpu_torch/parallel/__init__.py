"""Multi-GPU scaling over ``torch.distributed`` (port of
``tcnn_tpu.parallel``).

- :class:`DataParallelTrainer`: batch-sharded data parallelism over a
  ``DeviceMesh`` (params replicated; one ``all_reduce`` of the gradient
  and the loss a step);
- :class:`TableParallelGrid` / :class:`TableParallelTrainer`: model
  parallelism for hash grids whose tables outgrow one card (every level
  row-sharded over a mesh dimension; one feature ``all_reduce`` a lookup,
  table gradients rank-local, through the windowed kernels of
  ``csrc/grid_sharded.cu``).

Both compose on orthogonal dimensions of one mesh; ``FrozenServer(mesh=)``
serves over one. ``collectives.ALL_REDUCES`` counts the layer's
``all_reduce`` calls; ``launch.run_ranks`` runs a function on spawned ranks
of one host.
"""

from . import collectives, launch
from .data_parallel import DataParallelTrainer, make_mesh
from .table_parallel import TableParallelGrid, TableParallelTrainer

__all__ = [
    "DataParallelTrainer",
    "TableParallelGrid",
    "TableParallelTrainer",
    "collectives",
    "launch",
    "make_mesh",
]
