"""Parity of the port's data pipeline (repro_torch.data) with the
reference's (repro.data), on the CPU; stands in for
tests/test_data_db.py::TestPipeline.

SyntheticLM's rows are pure numpy in both packages, so every batch is
compared bit for bit over a grid of seeds, steps and process splits,
embeddings mode included."""
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro_torch.data import (DataConfig, Prefetcher, SyntheticLM,
                              make_global_batch)
from repro_torch.launch.mesh import make_mesh

SEEDS = (0, 7, 1234)
STEPS = (0, 1, 10, 99_999)
SPLITS = ((0, 1), (0, 2), (1, 2), (0, 4), (3, 4))


def pair(**kw):
    return SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))


def assert_batch_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("step", STEPS)
def test_batch_equals_reference(seed, step):
    ds, ref = pair(seed=seed, global_batch=8, seq_len=24, vocab_size=500)
    assert_batch_equal(ds.batch(step), ref.batch(step))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pi, pc", SPLITS)
def test_local_batch_equals_reference(seed, pi, pc):
    ds, ref = pair(seed=seed, global_batch=8, seq_len=16)
    for step in STEPS:
        assert_batch_equal(ds.local_batch(step, pi, pc),
                           ref.local_batch(step, process_index=pi,
                                           process_count=pc))


@pytest.mark.parametrize("seed", SEEDS)
def test_embeddings_mode_equals_reference(seed):
    ds, ref = pair(seed=seed, global_batch=4, seq_len=8, embed_dim=16)
    for step in STEPS:
        got = ds.batch(step)
        assert got["inputs"].shape == (4, 8, 16)
        assert got["inputs"].dtype == np.float32
        assert got["labels"].shape == (4, 8)
        assert_batch_equal(got, ref.batch(step))
        assert_batch_equal(ds.local_batch(step, 1, 2),
                           ref.local_batch(step, process_index=1,
                                           process_count=2))


def test_local_batch_defaults_to_one_process():
    ds = SyntheticLM(DataConfig(global_batch=4, seq_len=8))
    assert_batch_equal(ds.local_batch(3), ds.batch(3))


def test_host_sharding_partitions_batch():
    ds = SyntheticLM(DataConfig(global_batch=8, seq_len=8))
    parts = [ds.local_batch(3, i, 4) for i in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([p["inputs"] for p in parts]), ds.batch(3)["inputs"])


def test_restart_bitwise_reproducible():
    ds = SyntheticLM(DataConfig(seed=7, global_batch=4, seq_len=32))
    a, b = ds.batch(10), ds.batch(10)
    assert_batch_equal(a, b)
    assert not np.array_equal(ds.batch(11)["inputs"], a["inputs"])


def test_labels_are_shifted_inputs():
    ds = SyntheticLM(DataConfig(global_batch=2, seq_len=16))
    b = ds.batch(0)
    np.testing.assert_array_equal(b["inputs"][:, 1:], b["labels"][:, :-1])


def test_vocab_bound():
    ds = SyntheticLM(DataConfig(global_batch=4, seq_len=64, vocab_size=100))
    for s in range(3):
        b = ds.batch(s)
        assert b["inputs"].max() < 100 and b["labels"].max() < 100
        assert b["inputs"].min() >= 0


@pytest.mark.parametrize("start", [0, 5])
def test_prefetcher_yields_steps_in_order_and_joins(start):
    ds = SyntheticLM(DataConfig(global_batch=2, seq_len=8))
    pf = Prefetcher(ds, start_step=start, depth=2)
    try:
        got = [pf.next() for _ in range(4)]
    finally:
        pf.close()
    assert not pf.t.is_alive()
    assert [s for s, _ in got] == list(range(start, start + 4))
    for s, b in got:
        assert_batch_equal(b, ds.local_batch(s))


def test_prefetcher_close_without_reading():
    pf = Prefetcher(SyntheticLM(DataConfig(global_batch=2, seq_len=8)))
    pf.close()
    assert not pf.t.is_alive()


def test_make_global_batch_on_a_cpu_mesh():
    mesh = make_mesh((1,), ("data",), device="cpu")
    ds = SyntheticLM(DataConfig(global_batch=2, seq_len=8, vocab_size=50))
    host = ds.batch(1)
    spec = {"inputs": ("data",), "labels": ("data", None)}
    out = make_global_batch(host, mesh, spec)
    for k in host:
        assert out[k].device == torch.device("cpu")
        assert out[k].dtype == torch.int32
        np.testing.assert_array_equal(out[k].numpy(), host[k])
    emb = SyntheticLM(DataConfig(global_batch=2, seq_len=8, embed_dim=4))
    out = make_global_batch(emb.batch(0), mesh, spec)
    assert out["inputs"].dtype == torch.float32
    np.testing.assert_array_equal(out["inputs"].numpy(),
                                  emb.batch(0)["inputs"])


@pytest.mark.parametrize("spec", [("model",), (("data", "pod"),),
                                  ("data", None, None)])
def test_make_global_batch_rejects_bad_specs(spec):
    mesh = make_mesh((1,), ("data",), device="cpu")
    host = SyntheticLM(DataConfig(global_batch=2, seq_len=8)).batch(0)
    with pytest.raises(ValueError):
        make_global_batch(host, mesh, {"inputs": spec, "labels": ("data",)})
