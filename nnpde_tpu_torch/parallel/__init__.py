from .mesh import (
    Mesh,
    Sharding,
    data_sharding,
    dp_dcn_step,
    fused_rayleigh_step,
    fused_residual_step,
    fused_wan_u_step,
    fused_wan_v_step,
    make_mesh,
    make_mesh_2d,
    make_mesh_dcn,
    psum_mean_step,
    replicate,
    replicated_sharding,
    shard_batch,
    tp_mlp_apply,
    tp_shard_mlp,
)

__all__ = ["Mesh", "Sharding", "data_sharding", "dp_dcn_step", "fused_rayleigh_step",
           "fused_residual_step", "fused_wan_u_step", "fused_wan_v_step", "make_mesh",
           "make_mesh_2d", "make_mesh_dcn", "psum_mean_step", "replicate",
           "replicated_sharding", "shard_batch", "tp_mlp_apply", "tp_shard_mlp"]
