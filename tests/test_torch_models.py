"""Parity of the port's model stack (repro_torch.models) with the
reference's (repro.models), on the CPU.

Weights are drawn by the reference (jax.random) and carried across with
repro_torch.models.convert.params_from_reference; inputs come from numpy
seeds. The model tolerance is tests/test_kernel_model_parity.py's, 2e-4,
on internlm2-1.8b reduced to two layers of head_dim 64 in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.models import ssm as jssm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import (attention, blocks, common, convert, lm, mlp,
                                ssm)

TOL = dict(rtol=2e-4, atol=2e-4)
IMPLS = ("naive", "blockwise", "flash")


def reduced(get, **over):
    return get("internlm2-1.8b").reduced(
        **{"dtype": "float32", "num_layers": 2, "head_dim": 64, **over})


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, its params, port cfg, the converted module)."""
    jcfg, cfg = reduced(jget_config), reduced(get_config)
    params = reference_init(0, jcfg)
    model = convert.params_from_reference(
        jax.tree.map(np.asarray, params), cfg, device="cpu")
    return jcfg, params, cfg, model


def reference_init(key, jcfg):
    """The reference's params, jitted: the same numbers as eager
    jlm.init, compiled once instead of op by op."""
    return jax.jit(lambda k: jlm.init(k, jcfg)[0])(jax.random.PRNGKey(key))


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def hidden(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d), dtype=np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               **(tol or TOL))


# --------------------------------------------------------------------------
# configs and common
# --------------------------------------------------------------------------

def test_configs_are_the_reference_configs():
    from repro.configs import ARCH_IDS as JARCH_IDS
    assert ARCH_IDS == JARCH_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
        assert get_config(arch).param_count() == \
            jget_config(arch).param_count()


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    w = rng.standard_normal(64, dtype=np.float32) * 0.1
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
          want, rtol=1e-6, atol=1e-6)
    # bf16 activations, fp32 weight: one bf16 rounding of the output
    got = common.rms_norm(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(w), 1e-5)
    want = jcommon.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                            1e-5)
    assert got.dtype == torch.bfloat16
    close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_rotates_halves_as_the_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta)
    close(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(common.rope_frequencies(16, theta),
                                  jcommon.rope_frequencies(16, theta))


def test_dense_init_is_seeded_truncated_and_scaled():
    g = torch.Generator().manual_seed(0)
    w = common.dense_init((256, 64), torch.bfloat16, g)
    assert w.dtype == torch.bfloat16 and not w.requires_grad
    std = 1 / 16
    assert float(w.float().abs().max()) <= 2 * std * 1.01
    assert abs(float(w.float().std()) - 0.88 * std) < 0.05 * std
    again = common.dense_init((256, 64), torch.bfloat16,
                              torch.Generator().manual_seed(0))
    assert torch.equal(w, again)


# --------------------------------------------------------------------------
# attention, MLP, block
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_attend_prefill_matches_reference(pair, impl):
    """Sliding-window prefill (the causal mask and the window both bite;
    the LM tests below cover window 0)."""
    window = 24
    jcfg, params, cfg, model = pair
    jp = jax.tree.map(lambda a: a[0], params["groups"][0])["mixer"]
    x = hidden(2, 64, cfg.d_model)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64)).copy()
    want, (jk, jv) = jattention.attend(jp, jnp.asarray(x), jnp.asarray(pos),
                                       jcfg, window=window, impl=impl)
    got, (k, v) = attention.attend(model.blocks[0].mixer, torch.from_numpy(x),
                                   torch.from_numpy(pos), cfg, window=window,
                                   impl=impl)
    close(got, want)
    close(k, jk)
    close(v, jv)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("window,size", [(0, 64), (16, 16)])
def test_attend_decode_on_a_ring_matches_reference(pair, impl, window, size):
    """Prefill 40 positions into a ring (of 64, or a 16-slot sliding-window
    ring that wraps), then two one-token decode steps."""
    jcfg, params, cfg, model = pair
    jp = jax.tree.map(lambda a: a[0], params["groups"][0])["mixer"]
    mixer = model.blocks[0].mixer
    x = hidden(2, 42, cfg.d_model, seed=2)
    pos = np.broadcast_to(np.arange(42, dtype=np.int32), (2, 42)).copy()
    jc = jattention.init_cache(jcfg, 2, size, jnp.float32)
    tc = attention.init_cache(cfg, 2, size, torch.float32, "cpu")
    _, jc = jattention.attend(jp, jnp.asarray(x[:, :40]),
                              jnp.asarray(pos[:, :40]), jcfg, window=window,
                              impl=impl, kv_cache=jc)
    _, tc = attention.attend(mixer, torch.from_numpy(x[:, :40]),
                             torch.from_numpy(pos[:, :40]), cfg,
                             window=window, impl=impl, kv_cache=tc)
    for t in range(40, 42):
        want, jc = jattention.attend(jp, jnp.asarray(x[:, t:t + 1]),
                                     jnp.asarray(pos[:, t:t + 1]), jcfg,
                                     window=window, impl=impl, kv_cache=jc)
        got, tc = attention.attend(mixer, torch.from_numpy(x[:, t:t + 1]),
                                   torch.from_numpy(pos[:, t:t + 1]), cfg,
                                   window=window, impl=impl, kv_cache=tc)
        close(got, want)
    for name in ("k", "v"):
        close(tc[name], jc[name])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_fill_cache_writes_the_ring_in_place_as_the_reference():
    cfg = reduced(get_config)
    jcfg = reduced(jget_config)
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, 20, 2, 64), dtype=np.float32)
    v = rng.standard_normal((2, 20, 2, 64), dtype=np.float32)
    pos = np.stack([np.arange(20), np.arange(7, 27)]).astype(np.int32)
    want = jattention.fill_cache(jattention.init_cache(jcfg, 2, 8,
                                                       jnp.float32),
                                 jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos))
    cache = attention.init_cache(cfg, 2, 8, torch.float32, "cpu")
    ring_k = cache["k"]
    got = attention.fill_cache(cache, torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(pos))
    assert got is cache and got["k"] is ring_k       # in place
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


def test_mlp_matches_reference(pair):
    jcfg, params, cfg, model = pair
    jp = jax.tree.map(lambda a: a[1], params["groups"][0])["ffn"]
    x = hidden(2, 9, cfg.d_model, seed=4)
    close(mlp.apply(model.blocks[1].ffn, torch.from_numpy(x)),
          jmlp.apply(jp, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["attn", "swa"])
def test_block_matches_reference(pair, kind):
    jcfg, params, cfg, model = pair
    jcfg, cfg = (dataclasses.replace(c, window=16) for c in (jcfg, cfg))
    jp = jax.tree.map(lambda a: a[0], params["groups"][0])
    x = hidden(1, 48, cfg.d_model, seed=5)
    pos = np.arange(48, dtype=np.int32)[None]
    want, _, jaux = jblocks.block_apply(jp, jnp.asarray(x), jnp.asarray(pos),
                                        jcfg, kind)
    got, _, aux = blocks.block_apply(model.blocks[0], torch.from_numpy(x),
                                     torch.from_numpy(pos), cfg, kind)
    close(got, want)
    assert float(aux) == float(jaux) == 0.0


def test_every_block_kind_inits_and_unknown_kinds_raise():
    """The "rglru" kind and MoE feed-forwards build (their parity is
    tests/test_torch_rglru_moe.py's); a kind outside the four raises
    ValueError, as in the reference."""
    for arch in ("recurrentgemma-2b", "mixtral-8x22b",
                 "moonshot-v1-16b-a3b"):
        cfg = get_config(arch).reduced()
        model = lm.init(cfg, device="cpu")
        assert [blk.kind for blk in model.blocks] == [
            cfg.pattern_at(i) for i in range(cfg.num_layers)]
        assert all(hasattr(blk, "moe") == bool(cfg.num_experts)
                   for blk in model.blocks)
    cfg = get_config("recurrentgemma-2b").reduced()
    assert sorted(blocks.block_cache_init(cfg, "rglru", 1, 8, torch.float32,
                                          "cpu")) == ["conv", "h"]
    with pytest.raises(ValueError, match="mlstm"):
        blocks.block_init(cfg, "mlstm", torch.float32, torch.Generator())
    with pytest.raises(ValueError, match="mlstm"):
        blocks.block_apply(None, None, None, cfg, "mlstm")


# --------------------------------------------------------------------------
# the LM
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_then_decode_matches_reference(pair, impl):
    """lm.prefill into caches, then lm.decode_step twice (the reference's
    tests/test_kernel_model_parity.py flow), per attn_impl."""
    jcfg, params, cfg, model = pair
    jcfg, cfg = (dataclasses.replace(c, attn_impl=impl) for c in (jcfg, cfg))
    b, s = 2, 64
    inputs = tokens(cfg, b, s)
    jc, _ = jlm.init_caches(jcfg, b, s, jnp.float32)
    tc = lm.init_caches(cfg, b, s, device="cpu")
    want, jc, _ = jlm.prefill(params, jcfg, jnp.asarray(inputs[:, :s // 2]),
                              jc)
    got, tc, _ = lm.prefill(model, cfg, torch.from_numpy(inputs[:, :s // 2]),
                            tc)
    close(got, want)
    for t in range(s // 2, s // 2 + 2):
        lens = np.full((b,), t, np.int32)
        want, jc, _ = jlm.decode_step(params, jcfg,
                                      jnp.asarray(inputs[:, t:t + 1]),
                                      jnp.asarray(lens), jc)
        got, tc, _ = lm.decode_step(model, cfg,
                                    torch.from_numpy(inputs[:, t:t + 1]),
                                    torch.from_numpy(lens), tc)
        close(got, want)


def test_apply_without_caches_and_hidden_output_match_reference(pair):
    jcfg, params, cfg, model = pair
    inputs = tokens(cfg, 1, 128, seed=6)
    pos = np.arange(128, dtype=np.int32)[None]
    want, jcaches, _ = jlm.apply(params, jcfg, jnp.asarray(inputs),
                                 jnp.asarray(pos), return_hidden=True)
    got, caches, _ = lm.apply(model, cfg, torch.from_numpy(inputs),
                              torch.from_numpy(pos), return_hidden=True)
    assert jcaches is None and caches is None
    close(got, want)
    close(lm.head_logits(model, cfg, got), jlm.head_logits(params, jcfg,
                                                           want))
    close(lm.head_weight(model, cfg), jlm.head_weight(params, jcfg))


def test_converted_layers_keep_the_reference_order():
    """A pattern of two kinds over three layers: the reference stacks pattern
    slot i of group g at params["groups"][i][g] and keeps a one-block tail;
    the port's blocks run in execution order (group 0's pattern, then the
    tail), each with its own weights."""
    over = dict(block_pattern=("attn", "swa"), num_layers=3, window=16)
    jcfg = jget_config("internlm2-1.8b").reduced(dtype="float32", **over)
    cfg = get_config("internlm2-1.8b").reduced(dtype="float32", **over)
    params = reference_init(1, jcfg)
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    assert [blk.kind for blk in model.blocks] == ["attn", "swa", "attn"]
    want = [params["groups"][0]["mixer"]["wq"][0],
            params["groups"][1]["mixer"]["wq"][0],
            params["tail"][0]["mixer"]["wq"]]
    for blk, w in zip(model.blocks, want):
        np.testing.assert_array_equal(blk.mixer.wq.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        model.blocks[1].ffn.w_down.numpy(),
        np.asarray(params["groups"][1]["ffn"]["w_down"][0]))


def test_bf16_reference_weights_convert_exactly():
    jcfg = jget_config("internlm2-1.8b").reduced(num_layers=1)
    cfg = get_config("internlm2-1.8b").reduced(num_layers=1)
    params = reference_init(2, jcfg)
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert model.final_norm.dtype == torch.float32
    np.testing.assert_array_equal(
        model.blocks[0].ffn.w_up.float().numpy(),
        np.asarray(params["groups"][0]["ffn"]["w_up"][0], np.float32))


def test_init_counts_parameters_and_caches_like_the_config():
    cfg = reduced(get_config)
    model = lm.init(cfg, seed=3, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert all(not p.requires_grad for p in model.parameters())
    again = lm.init(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    caches = lm.init_caches(cfg, 3, 32, device="cpu")
    assert len(caches) == cfg.num_layers
    assert caches[0]["k"].shape == (3, cfg.num_kv_heads, 32, 64)
    assert bool((caches[0]["pos"] == attention.INF_POS).all())


# --------------------------------------------------------------------------
# Mamba-2 (the SSD block) on reduced mamba2-1.3b
# --------------------------------------------------------------------------
# The reference's tests/test_models_smoke.py holds its prefill + decode to
# its full pass at 2e-3; here port and reference run the same float32 math
# in another order (the scan's products, the softplus), so the model
# tolerance above, 2e-4, holds for a block, and 2e-3 for the whole
# two-layer model over its tied vocabulary head.
MAMBA_TOL = dict(rtol=2e-3, atol=2e-3)


def mamba_cfgs(**over):
    return (jget_config("mamba2-1.3b").reduced(dtype="float32", **over),
            get_config("mamba2-1.3b").reduced(dtype="float32", **over))


@pytest.fixture(scope="module")
def mamba_pair():
    jcfg, cfg = mamba_cfgs()
    params = reference_init(0, jcfg)
    model = convert.params_from_reference(
        jax.tree.map(np.asarray, params), cfg, device="cpu")
    return jcfg, params, cfg, model


def test_mamba_converts_every_leaf_and_ties_the_head(mamba_pair):
    jcfg, params, cfg, model = mamba_pair
    assert [blk.kind for blk in model.blocks] == ["ssd", "ssd"]
    assert not hasattr(model, "lm_head") and "lm_head" not in params
    assert all(not hasattr(blk, "ffn") for blk in model.blocks)
    for i, blk in enumerate(model.blocks):
        jp = jax.tree.map(lambda a: a[i], params["groups"][0])["mixer"]
        assert sorted(jp) == sorted(ssm.LEAVES)
        for name in ssm.LEAVES:
            np.testing.assert_array_equal(blk.mixer[name].numpy(),
                                          np.asarray(jp[name]))
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    close(lm.head_weight(model, cfg), jlm.head_weight(params, jcfg))
    x = hidden(1, 3, cfg.d_model, seed=11)
    close(lm.head_logits(model, cfg, torch.from_numpy(x)),
          jlm.head_logits(params, jcfg, jnp.asarray(x)))


def test_ssm_apply_then_decode_match_reference(mamba_pair):
    """One SSD mixer: a 64-step prefill from zero state, then two one-step
    decodes from its state; the output and both state leaves."""
    jcfg, params, cfg, model = mamba_pair
    jp = jax.tree.map(lambda a: a[0], params["groups"][0])["mixer"]
    mixer = model.blocks[0].mixer
    x = hidden(2, 66, cfg.d_model, seed=12)
    want, jstate = jssm.apply(jp, jnp.asarray(x[:, :64]), jcfg)
    got, state = ssm.apply(mixer, torch.from_numpy(x[:, :64]), cfg)
    close(got, want)
    for name in ("ssm", "conv"):
        close(state[name], jstate[name])
    for t in range(64, 66):
        want, jstate = jssm.decode_step(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                        jstate)
        got, state = ssm.decode_step(mixer, torch.from_numpy(x[:, t:t + 1]),
                                     cfg, state)
        close(got, want)
        for name in ("ssm", "conv"):
            close(state[name], jstate[name])


def test_ssm_apply_continues_a_segment_as_the_reference(mamba_pair):
    """A second 32-step segment from the first one's state (init_state and
    the conv tail carried into the chunked scan)."""
    jcfg, params, cfg, model = mamba_pair
    jp = jax.tree.map(lambda a: a[1], params["groups"][0])["mixer"]
    mixer = model.blocks[1].mixer
    x = hidden(1, 64, cfg.d_model, seed=13)
    _, jstate = jssm.apply(jp, jnp.asarray(x[:, :32]), jcfg)
    _, state = ssm.apply(mixer, torch.from_numpy(x[:, :32]), cfg)
    want, jstate = jssm.apply(jp, jnp.asarray(x[:, 32:]), jcfg, jstate)
    got, state = ssm.apply(mixer, torch.from_numpy(x[:, 32:]), cfg, state)
    close(got, want)
    for name in ("ssm", "conv"):
        close(state[name], jstate[name])


def test_ssd_block_matches_reference(mamba_pair):
    jcfg, params, cfg, model = mamba_pair
    jp = jax.tree.map(lambda a: a[0], params["groups"][0])
    x = hidden(1, 32, cfg.d_model, seed=14)
    pos = np.arange(32, dtype=np.int32)[None]
    want, _, jaux = jblocks.block_apply(jp, jnp.asarray(x), jnp.asarray(pos),
                                        jcfg, "ssd")
    got, _, aux = blocks.block_apply(model.blocks[0], torch.from_numpy(x),
                                     torch.from_numpy(pos), cfg, "ssd")
    close(got, want)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("prompt", [20, 64])
def test_mamba_prefill_then_decode_matches_reference(mamba_pair, prompt):
    """lm.prefill into the SSD states (a prompt shorter than a chunk, and
    two chunks), then lm.decode_step twice; caches hold every layer's
    state."""
    jcfg, params, cfg, model = mamba_pair
    b = 2
    inputs = tokens(cfg, b, prompt + 2, seed=15)
    jc, _ = jlm.init_caches(jcfg, b, 128, jnp.float32)
    tc = lm.init_caches(cfg, b, 128, device="cpu")
    assert [sorted(c) for c in tc] == [["conv", "ssm"]] * cfg.num_layers
    want, jc, _ = jlm.prefill(params, jcfg, jnp.asarray(inputs[:, :prompt]),
                              jc)
    got, tc, _ = lm.prefill(model, cfg, torch.from_numpy(
        inputs[:, :prompt]), tc)
    close(got, want, **MAMBA_TOL)
    for t in range(prompt, prompt + 2):
        lens = np.full((b,), t, np.int32)
        want, jc, _ = jlm.decode_step(params, jcfg,
                                      jnp.asarray(inputs[:, t:t + 1]),
                                      jnp.asarray(lens), jc)
        got, tc, _ = lm.decode_step(model, cfg,
                                    torch.from_numpy(inputs[:, t:t + 1]),
                                    torch.from_numpy(lens), tc)
        close(got, want, **MAMBA_TOL)
    for i, c in enumerate(tc):
        for name in ("ssm", "conv"):
            close(c[name], jc["groups"][0][name][i], **MAMBA_TOL)


def test_mamba_init_is_seeded_and_counts_like_the_config():
    cfg = get_config("mamba2-1.3b").reduced()
    model = lm.init(cfg, seed=4, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert model.embed.dtype == torch.bfloat16
    mixer = model.blocks[0].mixer
    assert mixer.conv_w.shape == (cfg.ssm_conv, cfg.d_inner
                                  + 2 * cfg.ssm_state)
    np.testing.assert_allclose(
        mixer.A_log.numpy(), np.log(np.linspace(1.0, 16.0, cfg.ssm_heads)),
        rtol=1e-6)
    again = lm.init(cfg, seed=4, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    caches = lm.init_caches(cfg, 3, 32, device="cpu")
    assert caches[0]["ssm"].shape == (3, cfg.ssm_heads, cfg.ssm_state,
                                      cfg.ssm_head_dim)
    assert caches[0]["ssm"].dtype == torch.float32
    assert caches[0]["conv"].shape == (3, cfg.ssm_conv - 1,
                                       cfg.d_inner + 2 * cfg.ssm_state)
