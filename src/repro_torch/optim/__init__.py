from . import compression
from .adamw import (AdamWConfig, global_norm, init, schedule, tree_leaves, tree_map,
                    tree_unflatten, update)

__all__ = ["AdamWConfig", "compression", "global_norm", "init", "schedule", "tree_leaves",
           "tree_map", "tree_unflatten", "update"]
