from xnode_wan_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    make_mesh_2d,
    make_mesh_ensemble,
    round_up,
    shard_batch,
)
