"""The port's counterpart of tests/test_models_smoke.py, over every
architecture in ARCH_IDS, each reduced to a tiny same-family config in
float32, on the CPU: the forward's logits and two train steps' losses
against the reference's (weights drawn by the reference and carried
across with repro_torch.models.convert, inputs from numpy seeds), and the
port's own decode against its full forward. Embedding-input models
(internvl2-76b, musicgen-large) take (B, S, D) inputs.

Tolerances: TOL (tests/test_torch_models.py's 2e-4) for the logits and
the first loss, MAMBA_TOL (2e-3) for the loss after an optimizer step;
decode against the forward is tests/test_models_smoke.py's 2e-4 for the
prefilled half and 2e-3 for each decoded position.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import convert, lm
from repro_torch.train import optim, step

TOL = dict(rtol=2e-4, atol=2e-4)
MAMBA_TOL = dict(rtol=2e-3, atol=2e-3)
OPT = dict(lr=5e-3, warmup_steps=1, decay_steps=100)
B, S = 2, 64


def inputs_np(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)


@pytest.fixture(scope="module")
def setups():
    """arch -> (jcfg, cfg, reference params as numpy, inputs, labels)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jget_config(arch).reduced(dtype="float32")
            cfg = get_config(arch).reduced(dtype="float32")
            params = jax.jit(lambda k: jlm.init(k, jcfg)[0])(
                jax.random.PRNGKey(0))
            labels = np.random.default_rng(1).integers(
                0, cfg.vocab_size, (B, S)).astype(np.int32)
            cache[arch] = (jcfg, cfg, jax.tree.map(np.asarray, params),
                           inputs_np(cfg), labels)
        return cache[arch]
    return get


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_logits_match_reference(setups, arch):
    jcfg, cfg, params, inputs, _ = setups(arch)
    want, _, jaux = jax.jit(lambda p, x: jlm.prefill(p, jcfg, x, None))(
        params, inputs)
    model = convert.params_from_reference(params, cfg, device="cpu")
    with torch.no_grad():
        got, caches, aux = lm.prefill(model, cfg, torch.from_numpy(inputs),
                                      None)
    assert caches is None
    assert got.shape == (B, S, cfg.vocab_size)
    assert torch.isfinite(got).all()
    close(got, want, **TOL)
    close(aux, jaux, **TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_steps_match_reference(setups, arch):
    """Two steps on one batch from the same state: the first loss within
    TOL, the second (after an AdamW step) within MAMBA_TOL and lower."""
    jcfg, cfg, params, inputs, labels = setups(arch)
    batch = {"inputs": inputs, "labels": labels}
    jopt, topt = joptim.AdamWConfig(**OPT), optim.AdamWConfig(**OPT)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = {"params": jparams, "opt": joptim.init(jparams, jopt),
              "step": jnp.zeros((), jnp.int32)}
    state = convert.state_from_reference(
        jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt))
    fn = step.make_train_step(cfg, topt)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, want = [], []
    for _ in range(2):
        jstate, jm = jfn(jstate, batch)
        state, m = fn(state, tb)
        assert torch.isfinite(m["loss"])
        want.append(float(jm["loss"]))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **MAMBA_TOL)
    assert got[1] < got[0], got
    assert int(state["step"]) == 2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_forward(setups, arch):
    """Prefill half the sequence into caches, then decode the rest one
    position at a time: the logits equal the all-at-once forward's."""
    _, cfg, params, inputs, _ = setups(arch)
    model = convert.params_from_reference(params, cfg, device="cpu")
    x = torch.from_numpy(inputs)
    split = S // 2
    with torch.no_grad():
        full, _, _ = lm.prefill(model, cfg, x, None)
        caches = lm.init_caches(cfg, B, S, device="cpu")
        pre, caches, _ = lm.prefill(model, cfg, x[:, :split], caches)
        close(pre, full[:, :split], **TOL)
        for t in range(split, S):
            lens = torch.full((B,), t, dtype=torch.int32)
            logits, caches, _ = lm.decode_step(model, cfg, x[:, t:t + 1],
                                               lens, caches)
            close(logits[:, 0], full[:, t], rtol=2e-3, atol=2e-3,
                  err_msg=f"{arch} pos {t}")
