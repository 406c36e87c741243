"""Parity of the port's Griffin RG-LRU block (repro_torch.models.rglru) and
routed mixture-of-experts block (repro_torch.models.moe) with the
reference's, on the CPU: each function, the blocks, whole reduced models
(recurrentgemma-2b, mixtral-8x22b, moonshot-v1-16b-a3b) through prefill
and decode, and the serving engine's greedy tokens.

Weights are drawn by the reference (jax.random) and carried across with
repro_torch.models.convert.params_from_reference; inputs come from numpy
seeds; everything is float32. Tolerances are tests/test_torch_models.py's:
TOL (2e-4) for a function or a block, MAMBA_TOL (2e-3) for a whole model
over its vocabulary head. Expert ids, capacities and dispatch indices are
compared exactly, drops included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.models import blocks, convert, lm, moe, rglru
from repro_torch.serve.engine import Request, ServeEngine

TOL = dict(rtol=2e-4, atol=2e-4)
MAMBA_TOL = dict(rtol=2e-3, atol=2e-3)
DROP_FACTOR = 0.5          # a capacity factor under which choices drop


def cfgs(arch, **over):
    return (jget_config(arch).reduced(dtype="float32", **over),
            get_config(arch).reduced(dtype="float32", **over))


def reference_init(key, jcfg):
    """The reference's params, jitted: the same numbers as eager
    jlm.init, compiled once instead of op by op."""
    return jax.jit(lambda k: jlm.init(k, jcfg)[0])(jax.random.PRNGKey(key))


def jitted(fn, jcfg, **static):
    """fn(*arrays, jcfg, **static) of the reference, jitted with the
    config closed over: one compile instead of one per eager op."""
    return jax.jit(lambda *a: fn(*a, jcfg, **static))


def convert_np(params, cfg):
    return convert.params_from_reference(jax.tree.map(np.asarray, params),
                                         cfg, device="cpu")


def with_bias(params, jcfg, seed=7, steps=3, rate=0.02):
    """The reference params with each MoE block's router_bias moved by a
    few bias_updates from the loads of random inputs, so that selection
    (scores + bias) and the weights (scores) differ."""
    rng = np.random.default_rng(seed)
    groups = list(params["groups"])
    g = dict(groups[0])
    m = dict(g["moe"])
    bias = m["router_bias"]
    n = bias.shape[0]
    for _ in range(steps):
        loads = []
        for i in range(n):
            p = jax.tree.map(lambda a: a[i], m)
            x = rng.standard_normal((2, 16, jcfg.d_model), dtype=np.float32)
            _, aux = jmoe.apply(p, jnp.asarray(x), jcfg)
            loads.append(aux["load"])
        bias = jnp.stack([jmoe.bias_update(bias[i], loads[i], rate)
                          for i in range(n)])
        m["router_bias"] = bias
    g["moe"] = m
    groups[0] = g
    return {**params, "groups": tuple(groups)}


@pytest.fixture(scope="module")
def rg_pair():
    """recurrentgemma-2b reduced: 6 layers, two (R, R, A) groups."""
    jcfg, cfg = cfgs("recurrentgemma-2b")
    params = reference_init(0, jcfg)
    return jcfg, params, cfg, convert_np(params, cfg)


@pytest.fixture(scope="module")
def mix_pair():
    jcfg, cfg = cfgs("mixtral-8x22b")
    params = reference_init(1, jcfg)
    return jcfg, params, cfg, convert_np(params, cfg)


@pytest.fixture(scope="module")
def moon_pair():
    """moonshot-v1-16b-a3b reduced, its router_bias nonzero."""
    jcfg, cfg = cfgs("moonshot-v1-16b-a3b")
    params = with_bias(reference_init(2, jcfg), jcfg)
    return jcfg, params, cfg, convert_np(params, cfg)


def hidden(b, s, d, seed=1, scale=1.0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d), dtype=np.float32) * scale


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def t(a):
    return torch.from_numpy(np.array(a))       # a writable copy


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               **(tol or TOL))


def ref_block(params, i, g):
    """Pattern slot i of group g of the reference's stacked params."""
    return jax.tree.map(lambda a: a[g], params["groups"][i])


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(rg_pair, with_tail):
    jcfg, params, cfg, model = rg_pair
    w = np.asarray(ref_block(params, 0, 0)["mixer"]["conv_w"])
    x = hidden(2, 9, w.shape[1], seed=2)
    tail = hidden(2, w.shape[0] - 1, w.shape[1], seed=3) if with_tail \
        else None
    want, jtail = jrglru._causal_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if tail is None else jnp.asarray(tail))
    got, new_tail = rglru._causal_conv(t(x), t(w),
                                       None if tail is None else t(tail))
    close(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(new_tail.numpy(), np.asarray(jtail))


def test_gates_match_reference(rg_pair):
    jcfg, params, cfg, model = rg_pair
    jp = ref_block(params, 0, 1)["mixer"]
    x = hidden(2, 7, cfg.resolved_lru_width, seed=4)
    jla, jb = jrglru._gates(jp, jnp.asarray(x))
    la, b = rglru._gates(model.blocks[3].mixer, t(x))
    assert la.dtype == b.dtype == torch.float32
    close(la, jla, rtol=1e-5, atol=1e-6)
    close(b, jb, rtol=1e-5, atol=1e-6)
    assert float(la.max()) <= 0.0


def scan_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    la = -rng.uniform(0.0, 0.5, (b, s, w)).astype(np.float32)
    bb = rng.standard_normal((b, s, w), dtype=np.float32)
    h0 = rng.standard_normal((b, w), dtype=np.float32)
    return la, bb, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 2, 3, 17, 64])
def test_scan_matches_reference_and_sequential(s, with_h0):
    """The doubling scan against the reference's associative_scan and
    against the plain sequential recurrence, at lengths that are and are
    not powers of two."""
    la, bb, h0 = scan_inputs(2, s, 8, seed=s)
    h0 = h0 if with_h0 else None
    want = jrglru._scan(jnp.asarray(la), jnp.asarray(bb),
                        None if h0 is None else jnp.asarray(h0))
    got = rglru._scan(t(la), t(bb), None if h0 is None else t(h0))
    plain = rglru._scan_ref(t(la), t(bb), None if h0 is None else t(h0))
    close(got, want, rtol=1e-5, atol=1e-5)
    close(plain, want, rtol=1e-5, atol=1e-5)


def test_rglru_apply_then_decode_match_reference(rg_pair):
    """One mixer: a 24-step prefill from zero state, then three one-step
    decodes from its state; the output and both state leaves."""
    jcfg, params, cfg, model = rg_pair
    jp = ref_block(params, 1, 0)["mixer"]
    mixer = model.blocks[1].mixer
    x = hidden(2, 27, cfg.d_model, seed=5)
    want, jstate = jitted(jrglru.apply, jcfg)(jp, jnp.asarray(x[:, :24]))
    got, state = rglru.apply(mixer, t(x[:, :24]), cfg)
    close(got, want)
    for name in ("h", "conv"):
        close(state[name], jstate[name])
    for s in range(24, 27):
        want, jstate = jitted(lambda p, x, c, cfg: jrglru.decode_step(
            p, x, cfg, c), jcfg)(jp, jnp.asarray(x[:, s:s + 1]), jstate)
        got, state = rglru.decode_step(mixer, t(x[:, s:s + 1]), cfg, state)
        close(got, want)
        for name in ("h", "conv"):
            close(state[name], jstate[name])


def test_rglru_apply_continues_a_segment_as_the_reference(rg_pair):
    """A second segment from the first one's state (h0 folded into the
    scan, the conv tail carried)."""
    jcfg, params, cfg, model = rg_pair
    jp = ref_block(params, 0, 1)["mixer"]
    mixer = model.blocks[3].mixer
    x = hidden(1, 40, cfg.d_model, seed=6)
    japply = jitted(lambda p, x, c, cfg: jrglru.apply(p, x, cfg, c), jcfg)
    _, jstate = jitted(jrglru.apply, jcfg)(jp, jnp.asarray(x[:, :19]))
    _, state = rglru.apply(mixer, t(x[:, :19]), cfg)
    want, jstate = japply(jp, jnp.asarray(x[:, 19:]), jstate)
    got, state = rglru.apply(mixer, t(x[:, 19:]), cfg, state)
    close(got, want)
    for name in ("h", "conv"):
        close(state[name], jstate[name])


def test_rglru_block_matches_reference(rg_pair):
    jcfg, params, cfg, model = rg_pair
    x = hidden(1, 20, cfg.d_model, seed=7)
    pos = np.arange(20, dtype=np.int32)[None]
    want, jc, jaux = jitted(jblocks.block_apply, jcfg, kind="rglru")(
        ref_block(params, 0, 0), jnp.asarray(x), jnp.asarray(pos))
    got, c, aux = blocks.block_apply(model.blocks[0], t(x), t(pos), cfg,
                                     "rglru")
    close(got, want)
    for name in ("h", "conv"):
        close(c[name], jc[name])
    assert float(aux) == float(jaux) == 0.0


def test_rglru_init_state_and_leaves(rg_pair):
    jcfg, params, cfg, model = rg_pair
    state = rglru.init_state(cfg, 3, torch.bfloat16, "cpu")
    jstate = jrglru.init_state(jcfg, 3, jnp.bfloat16)
    for name in ("h", "conv"):
        assert tuple(state[name].shape) == jstate[name].shape
        assert str(state[name].dtype).split(".")[-1] == \
            jstate[name].dtype.name
        assert not state[name].any()
    jp = ref_block(params, 0, 0)["mixer"]
    assert sorted(jp) == sorted(rglru.LEAVES)
    for name in rglru.LEAVES:
        np.testing.assert_array_equal(model.blocks[0].mixer[name].numpy(),
                                      np.asarray(jp[name]))


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def test_capacity_matches_reference():
    base = get_config("mixtral-8x22b")
    jbase = jget_config("mixtral-8x22b")
    for s in (1, 2, 7, 64, 4096):
        for e, k in ((4, 1), (8, 2), (64, 6)):
            for f in (0.25, 0.5, 1.0, 1.25, e / k):
                over = dict(num_experts=e, experts_per_token=k,
                            moe_capacity_factor=f)
                c = dataclasses.replace(base, **over)
                jc = dataclasses.replace(jbase, **over)
                assert moe.capacity(c, s) == jmoe.capacity(jc, s), \
                    (s, e, k, f)


def test_top_k_ties_take_the_lower_index_first():
    v = torch.tensor([[0.1, 0.4, 0.4, 0.2, 0.4], [0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, idx = moe._top_k(v, 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(v.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def moe_params(pair, g=0):
    jcfg, params, cfg, model = pair
    return ref_block(params, 0, g)["moe"], model.blocks[g].moe


@pytest.mark.parametrize("arch", ["mixtral", "moonshot"])
def test_route_matches_reference(mix_pair, moon_pair, arch):
    """Softmax top-k (mixtral) and sigmoid scores with the selection bias
    (moonshot, the bias nonzero): expert ids equal, weights and probs
    within TOL."""
    pair = mix_pair if arch == "mixtral" else moon_pair
    jcfg, _, cfg, _ = pair
    jp, mp = moe_params(pair, 1)
    x = hidden(3, 40, cfg.d_model, seed=8)
    idx, w, probs = moe._route(mp, t(x), cfg)
    for b in range(3):
        jidx, jw, jprobs = jmoe._route(jp, jnp.asarray(x[b]), jcfg)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(jidx))
        close(w[b], jw)
        close(probs[b], jprobs)
    if arch == "moonshot":
        # the bias moved selection: some token's ids differ from the
        # scores' own top-k
        scores = torch.sigmoid(t(x).float() @ mp.router)
        assert (moe._top_k(scores, cfg.experts_per_token)[1] != idx).any()


@pytest.mark.parametrize("factor", [DROP_FACTOR, None])
def test_dispatch_indices_match_reference(mix_pair, factor):
    """Exactly equal token and weight planes, at a capacity that drops
    choices (and at the reduced config's no-drop capacity); the batched
    form equals the row-by-row one."""
    jcfg, _, cfg, _ = mix_pair
    if factor is not None:
        jcfg, cfg = (dataclasses.replace(c, moe_capacity_factor=factor)
                     for c in (jcfg, cfg))
    jp, mp = moe_params(mix_pair)
    x = hidden(2, 48, cfg.d_model, seed=9)
    cap = moe.capacity(cfg, 48)
    idx, w, _ = moe._route(mp, t(x), cfg)
    token_for, weight_for = moe._dispatch_indices(idx, w, cfg.num_experts,
                                                  cap)
    assert token_for.dtype == torch.int32
    dropped = 0
    for b in range(2):
        jidx, jw, _ = jmoe._route(jp, jnp.asarray(x[b]), jcfg)
        jt, jwf = jmoe._dispatch_indices(jidx, jw, jcfg.num_experts, cap)
        np.testing.assert_array_equal(token_for[b].numpy(), np.asarray(jt))
        np.testing.assert_array_equal(
            weight_for[b].numpy(),
            np.asarray(jmoe._dispatch_indices(
                jnp.asarray(idx[b].numpy()), jnp.asarray(w[b].numpy()),
                jcfg.num_experts, cap)[1]))
        close(weight_for[b], jwf)
        row_t, row_w = moe._dispatch_indices(idx[b], w[b], cfg.num_experts,
                                             cap)
        assert torch.equal(row_t, token_for[b])
        assert torch.equal(row_w, weight_for[b])
        dropped += 48 * cfg.experts_per_token - int((row_w > 0).sum())
    assert (dropped > 0) == (factor is not None)


@pytest.mark.parametrize("factor", [DROP_FACTOR, None])
@pytest.mark.parametrize("arch", ["mixtral", "moonshot"])
def test_moe_apply_matches_reference(mix_pair, moon_pair, arch, factor):
    """The whole block feed-forward over a (3, 40) batch, its output and
    aux (load, importance, aux_loss), at a capacity that drops and at
    the reduced config's."""
    pair = mix_pair if arch == "mixtral" else moon_pair
    jcfg, _, cfg, _ = pair
    if factor is not None:
        jcfg, cfg = (dataclasses.replace(c, moe_capacity_factor=factor)
                     for c in (jcfg, cfg))
    jp, mp = moe_params(pair)
    x = hidden(3, 40, cfg.d_model, seed=10)
    want, jaux = jitted(jmoe.apply, jcfg)(jp, jnp.asarray(x))
    got, aux = moe.apply(mp, t(x), cfg)
    close(got, want)
    for name in ("load", "importance", "aux_loss"):
        close(aux[name], jaux[name])
    out, (load, imp) = moe._apply_row(mp, t(x[1]), cfg,
                                      moe.capacity(cfg, 40))
    jout, (jload, jimp) = jitted(jmoe._apply_row, jcfg,
                                 cap=jmoe.capacity(jcfg, 40))(
        jp, jnp.asarray(x[1]))
    close(out, jout)
    close(load, jload)
    close(imp, jimp)


def test_bias_update_matches_reference():
    rng = np.random.default_rng(11)
    bias = rng.standard_normal(8).astype(np.float32) * 0.01
    load = rng.dirichlet(np.ones(8)).astype(np.float32)
    load[3] = load.mean()            # a balanced expert keeps its bias
    for rate in (1e-3, 0.05):
        want = jmoe.bias_update(jnp.asarray(bias), jnp.asarray(load), rate)
        got = moe.bias_update(t(bias), t(load), rate)
        close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["mixtral", "moonshot"])
def test_moe_block_matches_reference(mix_pair, moon_pair, arch):
    """A whole "swa" (mixtral) / "attn" (moonshot) block with its MoE
    feed-forward; aux_loss as block_apply returns it."""
    pair = mix_pair if arch == "mixtral" else moon_pair
    jcfg, params, cfg, model = pair
    kind = cfg.block_pattern[0]
    x = hidden(2, 24, cfg.d_model, seed=12)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    want, _, jaux = jitted(jblocks.block_apply, jcfg, kind=kind)(
        ref_block(params, 0, 1), jnp.asarray(x), jnp.asarray(pos))
    got, _, aux = blocks.block_apply(model.blocks[1], t(x), t(pos), cfg,
                                     kind)
    close(got, want)
    close(aux, jaux)
    assert float(aux) > 0.0


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

def prefill_decode(jcfg, params, cfg, model, b, prompt, steps, max_len,
                   seed=13):
    """lm.prefill into caches, then `steps` lm.decode_steps, in both
    packages; the logits and aux losses compared at MAMBA_TOL."""
    inputs = tokens(cfg, b, prompt + steps, seed=seed)
    jc, _ = jlm.init_caches(jcfg, b, max_len, jnp.float32)
    tc = lm.init_caches(cfg, b, max_len, device="cpu")
    jprefill = jax.jit(lambda p, x, c: jlm.prefill(p, jcfg, x, c))
    jdecode = jax.jit(lambda p, x, n, c: jlm.decode_step(p, jcfg, x, n, c))
    want, jc, jaux = jprefill(params, jnp.asarray(inputs[:, :prompt]), jc)
    got, tc, aux = lm.prefill(model, cfg, t(inputs[:, :prompt]), tc)
    close(got, want, **MAMBA_TOL)
    close(aux, jaux, **MAMBA_TOL)
    for s in range(prompt, prompt + steps):
        lens = np.full((b,), s, np.int32)
        want, jc, _ = jdecode(params, jnp.asarray(inputs[:, s:s + 1]),
                              jnp.asarray(lens), jc)
        got, tc, _ = lm.decode_step(model, cfg, t(inputs[:, s:s + 1]),
                                    t(lens), tc)
        close(got, want, **MAMBA_TOL)
    return tc, jc


def test_recurrentgemma_prefill_then_decode_matches_reference(rg_pair):
    """Six layers (two (R, R, A) groups); the prompt (40) longer than the
    window (32), so the "swa" ring wraps; states of every layer after."""
    jcfg, params, cfg, model = rg_pair
    tc, jc = prefill_decode(jcfg, params, cfg, model, 2, 40, 3, 64)
    for i, c in enumerate(tc):
        slot, g = i % 3, i // 3
        want = jax.tree.map(lambda a: a[g], jc["groups"][slot])
        for name in ("h", "conv") if slot < 2 else ("k", "v", "pos"):
            close(c[name], want[name], **MAMBA_TOL)


def test_recurrentgemma_with_a_tail_matches_reference():
    """Four layers: one (R, R, A) group and a tail of one "rglru" block,
    which convert takes from params["tail"]."""
    jcfg, cfg = cfgs("recurrentgemma-2b", num_layers=4)
    params = reference_init(3, jcfg)
    model = convert_np(params, cfg)
    assert [b.kind for b in model.blocks] == ["rglru", "rglru", "swa",
                                              "rglru"]
    assert len(params["tail"]) == 1
    np.testing.assert_array_equal(model.blocks[3].mixer.w_r.numpy(),
                                  np.asarray(params["tail"][0]["mixer"]
                                             ["w_r"]))
    tc, jc = prefill_decode(jcfg, params, cfg, model, 1, 12, 2, 32)
    close(tc[3]["h"], jc["tail"][0]["h"], **MAMBA_TOL)


@pytest.mark.parametrize("arch", ["mixtral", "moonshot"])
def test_moe_prefill_then_decode_matches_reference(mix_pair, moon_pair,
                                                   arch):
    """Two layers; mixtral's window (32) wraps its ring in the prefill;
    moonshot routes with its nonzero bias."""
    pair = mix_pair if arch == "mixtral" else moon_pair
    prefill_decode(*pair, 2, 40, 3, 64)


def test_moe_prefill_with_drops_matches_reference(mix_pair):
    """lm.apply over a whole sequence at a capacity that drops."""
    jcfg, params, cfg, model = mix_pair
    jcfg, cfg = (dataclasses.replace(c, moe_capacity_factor=DROP_FACTOR)
                 for c in (jcfg, cfg))
    inputs = tokens(cfg, 2, 32, seed=14)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32)).copy()
    want, _, jaux = jax.jit(lambda p, x, q: jlm.apply(p, jcfg, x, q))(
        params, jnp.asarray(inputs), jnp.asarray(pos))
    got, _, aux = lm.apply(model, cfg, t(inputs), t(pos))
    close(got, want, **MAMBA_TOL)
    close(aux, jaux, **MAMBA_TOL)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mixtral-8x22b",
                                  "moonshot-v1-16b-a3b"])
def test_init_counts_parameters_like_the_config(arch):
    """lm.init of the reduced config: seeded, every parameter counted by
    cfg.param_count(), the reference's leaves in every block."""
    cfg = get_config(arch).reduced()
    model = lm.init(cfg, seed=5, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    again = lm.init(cfg, seed=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    jparams = reference_init(0, jget_config(arch).reduced())
    for i, blk in enumerate(model.blocks):
        kind = cfg.pattern_at(i)
        jp = ref_block(jparams, i % len(cfg.block_pattern), 0)
        assert blk.kind == kind
        assert sorted(n for n, _ in blk.named_parameters()) == sorted(
            f"{k}.{n}" if isinstance(v, dict) else k
            for k, v in jp.items() for n in (v if isinstance(v, dict)
                                             else [None]))
        for name, p in blk.named_parameters():
            want = jp
            for part in name.split("."):
                want = want[part]
            assert tuple(p.shape) == want.shape, name
            assert str(p.dtype).split(".")[-1] == want.dtype.name, name
    if cfg.num_experts:
        assert model.blocks[0].moe.router.dtype == torch.float32
    else:
        # Lambda = log(u^2 / (1 - u^2)) / 2, u ~ U[0.9, 0.999]
        u = torch.sigmoid(2 * model.blocks[0].mixer.lam).sqrt()
        assert 0.9 - 1e-6 <= float(u.min()) and float(u.max()) <= 0.999


def test_every_kind_has_a_cache_and_unknown_kinds_raise():
    cfg = get_config("recurrentgemma-2b").reduced()
    caches = lm.init_caches(cfg, 3, 32, device="cpu")
    assert [sorted(c) for c in caches] == [["conv", "h"], ["conv", "h"],
                                           ["k", "pos", "v"]] * 2
    assert caches[0]["h"].dtype == torch.float32
    assert caches[0]["conv"].shape == (3, cfg.ssm_conv - 1,
                                       cfg.resolved_lru_width)
    assert caches[2]["k"].shape[2] == cfg.window
    with pytest.raises(ValueError, match="mlstm"):
        blocks.block_cache_init(cfg, "mlstm", 1, 8, torch.float32, "cpu")


# --------------------------------------------------------------------------
# the serving engine
# --------------------------------------------------------------------------

def engines_agree(pair, requests, slots, max_len):
    jcfg, params, cfg, model = pair
    port = ServeEngine(cfg, model, batch_slots=slots, max_len=max_len,
                       device="cpu").run(requests(Request))
    ref = JServeEngine(jcfg, params, batch_slots=slots,
                       max_len=max_len).run(requests(JRequest))
    ref = {r.rid: r.generated for r in ref}
    assert sorted(r.rid for r in port) == sorted(ref)
    for r in port:
        assert r.generated == ref[r.rid], r.rid
    return port


@pytest.mark.parametrize("arch", ["recurrentgemma", "moonshot"])
def test_serve_engine_greedy_tokens_equal_the_reference(rg_pair, moon_pair,
                                                        arch):
    """Three requests through two slots, so one slot is refilled: the
    port's greedy tokens equal the reference engine's. recurrentgemma
    prefills raw prompts (RG-LRU states and a wrapped "swa" ring copied
    into the refilled row); moonshot buckets them (pad tokens routed
    after the prompt's, the capacity the padded length's)."""
    pair = rg_pair if arch == "recurrentgemma" else moon_pair
    cfg = pair[2]

    def requests(R):
        rng = np.random.default_rng(15)
        return [R(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                  .astype(np.int32), max_new_tokens=m)
                for i, (n, m) in enumerate(((37, 3), (5, 5), (12, 3)))]

    done = engines_agree(pair, requests, 2, 64)
    assert [len(r.generated) for r in sorted(done, key=lambda r: r.rid)] \
        == [3, 5, 3]
