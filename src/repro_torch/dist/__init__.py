"""Distributed training of the port: the sharding rule table
(``sharding``) and the data-parallel mesh as torch.distributed process
groups (``groups``)."""
from repro_torch.dist.groups import (DPGroups, RankFailed,  # noqa: F401
                                     backend_for, close_dp, init_dp,
                                     mesh_axes, rank_device, spawn)
from repro_torch.dist.sharding import (DP_AXES, current_rules,  # noqa: F401
                                       make_rules, quant_spec_for,
                                       use_rules)
