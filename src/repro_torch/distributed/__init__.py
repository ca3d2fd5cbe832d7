"""Port of ``repro/distributed``: the mesh contexts
(:mod:`repro_torch.distributed.meshctx`: the training mesh's
``MeshContext`` and the serving mesh), the sharding rules and the
execution plan (:mod:`repro_torch.distributed.sharding`), int8 gradient
compression (:mod:`repro_torch.distributed.gradient_compression`), and the
counted collectives that the model's mesh path and the trainer run
(:mod:`repro_torch.distributed.collectives`, no reference counterpart: GSPMD
inserts the reference's). ``compat.py`` has no counterpart: it bridges two
JAX versions."""
from .collectives import collective_counts, reset_collective_counts
from .gradient_compression import compressed_psum, init_error_state
from .meshctx import (MeshContext, ServingMesh, get_mesh_context,
                      get_serving_mesh, make_serving_mesh, mesh_context,
                      set_mesh_context, set_serving_mesh)
from .sharding import (ExecutionPlan, batch_specs, opt_state_spec_for,
                       param_specs, to_shardings)

__all__ = ["collective_counts", "reset_collective_counts",
           "compressed_psum", "init_error_state", "MeshContext",
           "get_mesh_context", "mesh_context", "set_mesh_context",
           "ServingMesh", "make_serving_mesh", "get_serving_mesh",
           "set_serving_mesh", "ExecutionPlan", "batch_specs",
           "opt_state_spec_for", "param_specs", "to_shardings"]
