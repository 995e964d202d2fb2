"""Multi-process runs of the port: the ('data', 'model') layout and the
tensor-parallel rules (``mesh``), the collectives they need (``tensor``)
and a local launcher (``launch``)."""
from cosa_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    gather_state_dict,
    init_distributed,
    make_mesh,
    param_spec,
    shard_module_,
)
