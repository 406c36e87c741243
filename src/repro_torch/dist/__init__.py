"""Distribution substrate: logical-axis sharding, sharding strategies,
fault tolerance, gradient compression, and pipeline parallelism
(counterpart of repro/dist).

Models never name mesh axes directly — they annotate tensors with logical
axis names (repro_torch.models.common) and this package resolves those
names to mesh axes through per-cell rule tables (sharding.py), optionally
overridden by a named strategy (strategies.py).

On one card every position of a mesh lives on one device: a sharding
records what each position would hold, and a "sharded" tensor stays
whole. The reference's two shard_map collectives, the compressed psum
(compression.py) and the GPipe ring (pipeline_parallel.py), run over a
leading axis of virtual positions, one batched op per reduction or tick.
A shard per card over torch.distributed is ROADMAP.md's item 5b.
"""
