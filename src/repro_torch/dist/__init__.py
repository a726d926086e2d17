"""Multi-device code of the port: the sharding rule table, its use
points' queries and the shard placement (``sharding``), and the mesh as
torch.distributed process groups (``groups``)."""
from repro_torch.dist.groups import (DPGroups, RankFailed,  # noqa: F401
                                     backend_for, close_dp, init_dp,
                                     mesh_axes, rank_device, spawn,
                                     world_one)
from repro_torch.dist.sharding import (DP_AXES, TP_AXIS,  # noqa: F401
                                       NamedSharding, current_mesh,
                                       current_rules, make_rules,
                                       param_specs, quant_spec_for,
                                       set_mesh, shard_params, use_rules)
