"""The port's activation rematerialisation (repro_torch.models.remat,
`cfg.remat` in lm._stack_apply) against the reference's jax.checkpoint of
each block (repro/models/lm.py::_block_fn), on the CPU.

For every family of tests/test_torch_train.py (dense, fused_ce, flash with
the reference's Pallas kernel in interpret mode, SSM, hybrid, MoE in both
routing modes) and every remat mode: the loss and every gradient leaf
within TOL of the reference's value_and_grad under the same remat, and
the port's three modes bit-identical to one another (the recompute runs
the same ops on the same inputs). Weights are the reference's, carried
across by repro_torch.models.convert; configs are reduced and float32.
What a checkpointed block keeps, and what the recompute counts, is
tests/test_torch_remat_memory.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import step as jstep
from repro_torch.models import convert
from repro_torch.train import step

from test_torch_train import (FAMILIES, batch_np, cfgs, close, close_leaf,
                              np_tree, reference_params, to_torch,
                              trainable)

MODES = ("none", "block", "dots")


@pytest.fixture(scope="module")
def runs():
    """(family, mode) -> (reference (loss, parts, grads), port (loss,
    parts, grads)); the weights and the batch are drawn once a family."""
    drawn, cache = {}, {}

    def get(family, mode):
        if family not in drawn:
            jcfg, cfg = cfgs(family)
            drawn[family] = (reference_params(jcfg), batch_np(cfg))
        if (family, mode) not in cache:
            params, batch = drawn[family]
            jcfg, cfg = cfgs(family, remat=mode)
            fn = jax.jit(lambda p, b: jax.value_and_grad(
                jstep.loss_fn, has_aux=True)(p, jcfg, b))
            (jloss, jparts), jgrads = fn(jax.tree.map(jnp.asarray, params),
                                         batch)
            model = trainable(params, cfg)
            got = step.value_and_grad(model, cfg, to_torch(batch))
            want = convert.from_reference(np_tree(jgrads),
                                          convert.leaf_map(model),
                                          device="cpu")
            cache[family, mode] = ((jloss, jparts, want), got)
        return cache[family, mode]
    return get


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_every_gradient_leaf_match_reference_under_remat(
        runs, family, mode):
    (jloss, jparts, want), (loss, parts, grads) = runs(family, mode)
    close(loss, jloss)
    for k in ("ce", "aux"):
        close(parts[k], jparts[k])
    for n, g in grads.items():
        if g is None:           # an aux-free router's selection bias
            assert n.endswith("router_bias") and not want[n].any()
            continue
        assert g.dtype == want[n].dtype, n
        close_leaf(g, want[n], n)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_the_three_modes_are_bit_identical(runs, family):
    _, (loss0, parts0, grads0) = runs(family, "none")
    for mode in MODES[1:]:
        _, (loss, parts, grads) = runs(family, mode)
        assert torch.equal(loss, loss0), mode
        for k in parts0:
            assert torch.equal(parts[k], parts0[k]), (mode, k)
        assert grads.keys() == grads0.keys()
        for n, g in grads.items():
            if g is None:
                assert grads0[n] is None, (mode, n)
            else:
                assert torch.equal(g, grads0[n]), (mode, n)


def test_remat_is_a_config_field_the_reduced_configs_keep():
    """The reduced configs keep the reference's default ("block"), so the
    train tests run the checkpointed step; `cfgs(remat=)` overrides it in
    both packages."""
    jcfg, cfg = cfgs("dense")
    assert jcfg.remat == cfg.remat == "block"
    for mode in MODES:
        jcfg, cfg = cfgs("ssm", remat=mode)
        assert jcfg.remat == cfg.remat == mode
        assert dataclasses.replace(cfg, remat="none").remat == "none"
