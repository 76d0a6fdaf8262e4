from repro_torch.common.params import (  # noqa: F401
    Param,
    from_jax_params,
    init_params,
    is_param,
    map_tree,
    tree_bytes,
    tree_leaves,
)
