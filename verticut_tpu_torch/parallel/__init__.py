"""Multi-device execution on ``torch.distributed`` (port of
``verticut_tpu/parallel``): the process world, the mesh and its
collectives."""

from verticut_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, mesh_axes, single_device_mesh)
from verticut_tpu_torch.parallel import collectives  # noqa: F401
