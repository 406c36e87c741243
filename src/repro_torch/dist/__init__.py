"""Distribution substrate: logical-axis sharding, sharding strategies,
fault tolerance, gradient compression, and pipeline parallelism
(counterpart of repro/dist).

Models never name mesh axes directly — they annotate tensors with logical
axis names (repro_torch.models.common) and this package resolves those
names to mesh axes through per-cell rule tables (sharding.py), optionally
overridden by a named strategy (strategies.py).

On a mesh of virtual positions every position lives on one device: a
sharding records what each position would hold, and a "sharded" tensor
stays whole. The reference's two shard_map collectives, the compressed
psum (compression.py) and the GPipe ring (pipeline_parallel.py), run
there over a leading axis of positions, one batched op per reduction or
tick. A mesh over the ranks of a process group (world.py,
launch.mesh.make_mesh(..., group=)) runs the compressed psum as
collectives over its "pod" subgroups, the sharded tables of
repro_torch.query and repro_torch.store a shard a rank, and splits train
state: a rank holds its block of every split leaf (sharding.local_block,
gather), the train step gathers the parameters and reduces gradients
over the batch's axes, and GPipe's ring is a send/recv a tick between
the stage ranks (world.exchange). The serve step on ranks, with split
caches and tensor-parallel compute, is ROADMAP.md's item 5d.
"""
