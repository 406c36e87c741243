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
gather), and GPipe's ring is a send/recv a tick between the stage ranks
(world.exchange). The train and serve steps on ranks compute on the
blocks, tensor- and expert-parallel over "model" (sharding.at_use,
reduce_over, gather_over, enter_over, mean_over, each with its adjoint
under autograd); the train step reduces the gradients over the batch's
axes. A world is supervised whole (world.supervise,
launch.train.run_world): a failure on any rank ends every rank, and a
fresh world restores the latest checkpoint, up to the restart budget; no
rank restarts alone, since its peers wait in the same collectives.
Sequences split over ranks too: a decode cache's ring over its slots
(split-K decode; each rank's softmax partial combined by all-reduce,
sharding.combine_over) and q's rows over the cp strategy's axes
(context parallelism, the rows' outputs gathered).
"""
