"""Cell assembly of the port: meshes over ``torch.distributed``, the steps
of every cell with their placements, the ranks of a process group on one
host, and the dry run (``python -m repro_torch.launch.dryrun``)."""
from .mesh import (Mesh, Sharding, make_host_mesh, make_production_mesh,
                   use_mesh)
from .steps import StepBundle, build_step, gather_outputs, local_args

__all__ = ["Mesh", "Sharding", "make_host_mesh", "make_production_mesh",
           "use_mesh", "StepBundle", "build_step", "gather_outputs",
           "local_args"]
