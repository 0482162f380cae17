"""The shard map's read side: the port's part of
parameter_server_distributed_tpu/replication/ that static PS sharding
needs.

- :mod:`.messages`: ``STALE_SHARD_MAP`` and the coordinator's shard-map
  messages (``GetShardMap``, ``ReportShardFailure``), byte for byte the
  JAX package's;
- :mod:`.failover`: ``ShardMapClient``, the worker's view of the
  coordinator's epoch-numbered map.

Not ported: the replicator, promotion with backups, live resharding and
the sharded update (ROADMAP.md Queue 1, item 13).
"""
