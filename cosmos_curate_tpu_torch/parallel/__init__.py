"""Multi-node runs (port of ``cosmos_curate_tpu/parallel``, its host-level
part): the node partition and the distributed bootstrap
(``distributed.py``) and shared-ledger work stealing
(``work_stealing.py``). The mesh and sharding modules wait for the port's
tensor and sequence parallelism (ROADMAP queue A item 7)."""
