"""Mesh partitioning: logical-axis rules (:mod:`.partition`), the
activation annotations (:mod:`.context`) and GPipe pipelining
(:mod:`.pipeline`), as ``repro.sharding``.

The reference also keeps a version-portable ``shard_map`` shim here. It has
no counterpart in PyTorch: the port runs one process per rank, and a
function "mapped over shards" is simply what each rank runs on its local
tensors (``DTensor.to_local``), with ``torch.distributed`` collectives
where the reference names a mesh axis.
"""
