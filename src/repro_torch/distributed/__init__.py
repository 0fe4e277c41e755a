"""`repro_torch.distributed` — the sharded compression fabric and its mesh.

The port of the JAX package's `distributed` modules that the LZ4 system
uses:

    sharding  Mesh / make_mesh / use_mesh: a named grid of torch devices
              held by one process (a device may repeat), PartitionSpec and
              NamedSharding for `checkpoint.restore(shardings=)`.
    fabric    the block stack split across a mesh: frame v4 writing
              (`LZ4Engine(shards=)` / `LZ4Engine(mesh=)`), sharded decode
              (`LZ4DecodeEngine(mesh=)`), `shard_subframe`.
    fault     StepMonitor, RestartPolicy, SimulatedFailure.
    pipeline  pipeline_apply: GPipe stages on the devices of a "pod" axis.

Nothing here starts a process group: one process launches every shard.
"""
