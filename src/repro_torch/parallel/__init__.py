"""The parallel layer (port of ``repro.parallel``): sharding rules on a
``DeviceMesh`` and the GPipe executor over a ``stage`` mesh axis."""

from .pipeline import pipeline_forward, pipeline_forward_stages
from .sharding import (MeshAxes, NamedSharding, Spec, active_mesh, batch_spec, cache_pspec,
                       constrain, named_shardings, param_pspecs, placements, set_active_mesh,
                       shard_params, with_dp_constraint)

__all__ = ["MeshAxes", "NamedSharding", "Spec", "active_mesh", "batch_spec", "cache_pspec",
           "constrain", "named_shardings", "param_pspecs", "pipeline_forward",
           "pipeline_forward_stages", "placements", "set_active_mesh", "shard_params",
           "with_dp_constraint"]
