"""Data and tensor parallelism: ``mesh`` (devices of one process, shard
helpers, ``ShardDraws``), ``dist`` (process groups: global-batch statistics,
collectives, ``spawn``), ``tp`` (the (dp, mp) layout of PointNetCls) and
``ranks`` (the data-parallel train step on spawned ranks, as a check).
Port of ``pointnetgpd_tpu/parallel``. Nothing is imported here, so that the
model modules can import ``parallel.dist`` without a cycle."""
