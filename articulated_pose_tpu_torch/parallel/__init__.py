"""Device-mesh parallelism: counterpart of `articulated_pose_tpu/parallel/`.

`mesh` holds JAX's names (`make_mesh`, `batch_sharding`,
`state_shardings`, `shard_train_setup`);
`collectives` the autograd collectives the layers use under a sharded
train step; `launch` runs a world of ranks.  Nothing is imported here:
`models.layers` imports `collectives`, and `mesh` imports the layers.
"""
