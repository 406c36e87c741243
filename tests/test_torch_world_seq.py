"""Sequence splits on the ranks of a torch.distributed world, on the CPU:
split-K decode over a ring split over its slots ("kv_seq") and context
parallelism over q's rows ("cp_seq"), against the reference's 8-device
steps.

This file runs itself as a child (`python tests/test_torch_world_seq.py
child OUT`) under XLA_FLAGS=--xla_force_host_platform_device_count=8,
which runs the reference's jitted build_prefill + build_serve (a prefill
of a prompt longer than the reduced window, so the ring wraps, then NEW
greedy decode steps) for reduced fp32 recurrentgemma and mixtral under
the cp and 2d_splitcache strategies and long_500k's rules on (2, 4)
(and mixtral with 4 kv heads under 2d_splitcache, whose pos splits its
slots where k and v split their kv heads), and
STEPS steps of its build_train under cp, and pickles the weights, logits,
tokens, losses and states. One module-scoped 8-rank gloo world runs the
same steps on rank meshes with the weights carried across (convert).
Logits and train state within TOL, tokens equal; every rank holds
exactly position_bytes and gathers no K/V ring leaf. World-free tests
hold kernel 10's plain partials, cut into ring blocks and combined, to
decode_ref on the whole ring, and the op's reading of a kv-head range in
place.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

B, S, NEW, MAX_LEN = 4, 40, 4, 64    # rows, prompt, decode steps, ring
SEED = 3
AXES = ("data", "model")
MESH = (2, 4)
ARCHS = ("recurrentgemma-2b", "mixtral-8x22b")
LAYOUTS = ("cp", "2d_splitcache", "long_500k")
# mixtral with 4 kv heads: "model" splits them on k and v, so their slots
# stay whole while pos, which has no kv-head dim, splits its slots over
# "model" (a rank gathers the pos entries of the slots its k holds)
KV4 = "mixtral-8x22b:kv4"
SERVE_CASES = tuple((a, lay) for a in ARCHS for lay in LAYOUTS) + (
    (KV4, "2d_splitcache"),)
TRAIN_B, TRAIN_S, STEPS = 4, 32, 2
DEADLINE_S = 240


def _config(arch, package="repro_torch"):
    import importlib
    get = importlib.import_module(package + ".configs").get_config
    name, _, kv = arch.partition(":kv")
    over = {"num_kv_heads": int(kv)} if kv else {}
    return get(name).reduced(dtype="float32", **over)


def _rows(layout) -> int:
    return 1 if layout == "long_500k" else B


def _shapes(layout, package="repro_torch"):
    """(prefill, decode) ShapeSpecs of a layout: long_500k's rules come
    from its shape's name, the strategies' from rules_extra."""
    import importlib
    shape = importlib.import_module(package + ".configs.base").ShapeSpec
    name = layout if layout == "long_500k" else "d"
    return (shape(name, "prefill", MAX_LEN, _rows(layout)),
            shape(name, "decode", MAX_LEN, _rows(layout)))


def _extra(layout, package="repro_torch"):
    import importlib
    if layout == "long_500k":
        return None
    strategies = importlib.import_module(package + ".dist.strategies")
    return strategies.strategy_for(None, None, layout)[0]


def _prompt(vocab: int, rows: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, (rows, S)).astype(
        np.int32)


def _child(out_path: str) -> None:
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs.base import ShapeSpec
    from repro.data import DataConfig, SyntheticLM, make_global_batch
    from repro.dist.sharding import sharding_tree
    from repro.launch import specs
    from repro.launch.mesh import make_mesh
    from repro.models import lm as jlm
    from repro.train import optim, step as step_lib
    assert len(jax.devices()) == 8, jax.devices()
    np_tree = lambda t: jax.tree.map(np.asarray, t)      # noqa: E731
    mesh = make_mesh(MESH, AXES)
    out = {"params": {}, "runs": {}, "train": {}}
    for arch, layout in SERVE_CASES:
        cfg = _config(arch, "repro")
        if arch not in out["params"]:
            out["params"][arch] = np_tree(jax.jit(
                lambda k: jlm.init(k, cfg)[0])(jax.random.PRNGKey(SEED)))
        params = out["params"][arch]
        pre, dec = _shapes(layout, "repro")
        extra = _extra(layout, "repro")
        prefill, _ = specs.build_prefill(cfg, pre, mesh, rules_extra=extra)
        serve, _ = specs.build_serve(cfg, dec, mesh, rules_extra=extra)
        rows = _rows(layout)
        caches = np_tree(jlm.init_caches(cfg, rows, MAX_LEN)[0])
        logits, caches = prefill(params, _prompt(cfg.vocab_size, rows),
                                 caches)
        got = [np.asarray(logits)]
        nxt = np.argmax(got[0], axis=-1).astype(np.int32)
        cache_len = np.full((rows,), S, np.int32)
        key = jax.random.PRNGKey(0)
        for _ in range(NEW):
            nxt, logits, caches = serve(params, nxt[:, None], cache_len,
                                        caches, key)
            nxt = np.asarray(nxt)
            got += [np.asarray(logits), nxt]
            cache_len = cache_len + 1
        out["runs"][(arch, layout)] = got
    shape = ShapeSpec("t", "train", TRAIN_S, TRAIN_B)
    opt_cfg = optim.AdamWConfig()
    extra = _extra("cp", "repro")
    for arch in ARCHS:
        cfg = _config(arch, "repro")
        jitted, _ = specs.build_train(cfg, shape, mesh, opt_cfg=opt_cfg,
                                      rules_extra=extra)
        state, axes = step_lib.init_state(jax.random.PRNGKey(SEED), cfg,
                                          opt_cfg)
        sh = sharding_tree(state, axes, mesh,
                           specs.rules_for(cfg, shape, extra))
        init = np_tree(state)
        state = jax.tree.map(jax.device_put, state, sh)
        ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_S, global_batch=TRAIN_B))
        losses = []
        for s in range(STEPS):
            state, metrics = jitted(state, make_global_batch(
                ds.batch(s), mesh, {"inputs": P("data"),
                                    "labels": P("data")}))
            losses.append(float(metrics["loss"]))
        out["train"][arch] = {"init": init, "losses": losses,
                              "final": np_tree(state)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    _child(sys.argv[2])
    sys.exit(0)


import torch  # noqa: E402
from test_torch_specs import CHILD_TIMEOUT_S, TOL, assert_state  # noqa: E402
from test_torch_world_train import (_blocks, _gather_state,  # noqa: E402
                                    _place_state, _port_state, _same_tree)

from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.dist import world  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402,E501
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dec_ref  # noqa: E402

INF_POS = 1 << 30


# --------------------------------------------------------------------------
# what the ranks run (module level, so a spawned rank can unpickle it)
# --------------------------------------------------------------------------

class _Gathers:
    """While open, the storage address and shape of every tensor gathered
    over ranks: world.all_gather's input (a view of a ring leaf shares
    its storage) and all_gather_into_tensor's."""

    def __enter__(self):
        import torch.distributed as dist
        self.real = (world.all_gather, dist.all_gather_into_tensor)
        self.calls = []

        def seen(t):
            self.calls.append((t.untyped_storage().data_ptr(),
                               tuple(t.shape)))

        def gather(t, group):
            seen(t)
            return self.real[0](t, group)

        def into(out, inp, *a, **kw):
            seen(inp)
            return self.real[1](out, inp, *a, **kw)
        world.all_gather, dist.all_gather_into_tensor = gather, into
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        world.all_gather, dist.all_gather_into_tensor = self.real


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in
               torch.utils._pytree.tree_leaves(tree))


def _serve_case(ref, arch, layout) -> dict:
    """This rank's run of one serve case from the reference's weights: the
    global outputs, the bytes it holds against position_bytes, and the
    gathers it made beside its ring leaves' storages and shapes."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import position_bytes
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert, lm
    from repro_torch.train import step as step_lib
    cfg = _config(arch)
    mesh = make_mesh(MESH, AXES, group=dist.group.WORLD)
    pre, dec = _shapes(layout)
    extra = _extra(layout)
    prefill, _ = specs.build_prefill(cfg, pre, mesh, rules_extra=extra)
    serve, _ = specs.build_serve(cfg, dec, mesh, rules_extra=extra)
    params = step_lib.place_blocks(convert.params_from_reference(
        ref["params"][arch], cfg, device="cpu"), prefill.in_shardings[0])
    rows = _rows(layout)
    caches = lm.init_caches(cfg, rows, MAX_LEN, mesh=mesh,
                            rules=specs.rules_for(cfg, dec, extra))
    axes = prefill.in_shardings[1].dim_axes(0)
    n = int(np.prod([mesh.shape[a] for a in axes]))
    start = mesh.block_index(axes) * (rows // n)
    mine = slice(start, start + rows // n)
    rings = [t for c in caches if "pos" in c for t in c.values()]
    rec = {"held": _tree_bytes(caches),
           "position_bytes": position_bytes(caches, prefill.in_shardings[2]),
           "kv_storages": [c[k].untyped_storage().data_ptr()
                           for c in caches if "pos" in c for k in "kv"],
           "pos_storages": [c["pos"].untyped_storage().data_ptr()
                            for c in caches if "pos" in c],
           "ring_shapes": [tuple(t.shape) for t in rings],
           "ring_specs": [tuple(sh[k].spec) for sh in
                          prefill.in_shardings[2] for k in sh if "pos" in sh]}
    tokens = torch.from_numpy(_prompt(cfg.vocab_size, rows))[mine]
    key = torch.zeros(2, dtype=torch.uint32)
    with _Gathers() as g, torch.no_grad():
        logits, caches = prefill(params, tokens, caches)
        out = [logits.numpy()]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        cache_len = torch.full((tokens.shape[0],), S, dtype=torch.int32)
        for _ in range(NEW):
            nxt, logits, caches = serve(params, nxt[mine, None], cache_len,
                                        caches, key)
            out += [logits.numpy(), nxt.numpy()]
            cache_len = cache_len + 1
    rec["out"], rec["gathers"] = out, g.calls
    return rec


def _train_case(ref, arch) -> dict:
    import torch.distributed as dist

    from repro_torch.data import (DataConfig, SyntheticLM,
                                  make_global_batch)
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert
    from repro_torch.train import optim
    cfg = _config(arch)
    mesh = make_mesh(MESH, AXES, group=dist.group.WORLD)
    shape = ShapeSpec("t", "train", TRAIN_S, TRAIN_B)
    fn, _ = specs.build_train(cfg, shape, mesh, opt_cfg=optim.AdamWConfig(),
                              rules_extra=_extra("cp"))
    sh, batch_sh = fn.in_shardings
    state = _place_state(convert.state_from_reference(
        ref["train"][arch]["init"], cfg, device="cpu"), sh)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                global_batch=TRAIN_B))
    specs_ = {k: s.spec for k, s in batch_sh.items()}
    losses, norms = [], []
    for s in range(STEPS):
        _, m = fn(state, make_global_batch(ds.batch(s), mesh, specs_))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    rank = _blocks(state, sh, mesh)
    return {"losses": losses, "norms": norms,
            "final": _gather_state(state, sh, cfg),
            "held": (rank["held"], rank["position_bytes"])}


def _members_case():
    """make_mesh over the world's first four ranks, which every rank
    calls: the members all-reduce their rank over "model"."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), AXES, members=range(4))
    if mesh is None:
        return None
    t = torch.tensor([float(dist.get_rank())])
    dist.all_reduce(t, group=mesh.axis_group("model"))
    return {"rank": mesh.rank, "coords": mesh.coords, "model_sum": float(t)}


def _eight(ref) -> list:
    import torch.distributed as dist
    out = {"members": _members_case(),
           "serve": {case: _serve_case(ref, *case) for case in SERVE_CASES},
           "train": {arch: _train_case(ref, arch) for arch in ARCHS}}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("world_seq") / "reference.pkl"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, __file__, "child", str(out)],
                         env=env, capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT_S)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def eight(ref):
    return world.spawn(_eight, 8, backend="gloo", args=(ref,),
                       deadline_s=DEADLINE_S)


# --------------------------------------------------------------------------
# tests on the world
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layout", SERVE_CASES, ids=str)
def test_sequence_splits_on_ranks_match_the_8_device_reference(
        eight, ref, arch, layout):
    """A prefill longer than the window (the ring wraps) and NEW greedy
    steps under cp (q's rows split), 2d_splitcache (the ring split over
    "model") and long_500k (over both axes) on (2, 4) ranks: logits
    within TOL of the reference's jitted steps, tokens equal, the same
    on every rank."""
    want = ref["runs"][(arch, layout)]
    got = eight[0]["serve"][(arch, layout)]["out"]
    assert len(got) == len(want) == 1 + 2 * NEW
    for r in eight:
        for a, b in zip(r["serve"][(arch, layout)]["out"], got):
            np.testing.assert_array_equal(a, b)
    for i, (a, b) in enumerate(zip(got, want)):
        if i and i % 2 == 0:
            np.testing.assert_array_equal(a, b, err_msg=f"tokens {i}")
        else:
            np.testing.assert_allclose(a, b, err_msg=f"logits {i}", **TOL)


@pytest.mark.parametrize("arch,layout", SERVE_CASES, ids=str)
def test_each_rank_holds_position_bytes_of_its_caches(eight, arch, layout):
    """Every rank's caches are exactly position_bytes of the caches'
    shardings, and under the split-K layouts the rings are split over
    their slots (a rank holds a quarter or an eighth of each; under KV4
    only pos's slots are split)."""
    ring = min(_config(arch).window, MAX_LEN)
    n = {"cp": 1, "2d_splitcache": 4, "long_500k": 8}[layout]
    for r in eight:
        rec = r["serve"][(arch, layout)]
        assert rec["held"] == rec["position_bytes"], rec["held"]
        kv = {sh[2] for sh in rec["ring_shapes"] if len(sh) == 4}
        pos = {sh[1] for sh in rec["ring_shapes"] if len(sh) == 2}
        # KV4: "model" splits k and v's kv heads, so only pos's slots
        assert kv == {ring if arch == KV4 else ring // n}, rec["ring_specs"]
        assert pos == {ring // n}, rec["ring_specs"]


@pytest.mark.parametrize("arch,layout", SERVE_CASES, ids=str)
def test_no_rank_gathers_a_ring_leaf(eight, arch, layout):
    """No gather of any rank reads a K/V ring leaf's storage (a view of
    one included): the steps gather q (one token), the rows of cp's
    output, the logits and the vocabulary's blocks, and combine the
    partial softmaxes by all-reduce. The int32 pos plane is gathered only
    where k's slots are whole and pos's split (KV4), there on every
    rank."""
    for r in eight:
        rec = r["serve"][(arch, layout)]
        kv_ptrs, pos_ptrs = set(rec["kv_storages"]), set(rec["pos_storages"])
        assert rec["gathers"]
        for ptr, shape in rec["gathers"]:
            assert ptr not in kv_ptrs, shape
        pos_gathers = [g for g in rec["gathers"] if g[0] in pos_ptrs]
        assert bool(pos_gathers) == (arch == KV4), pos_gathers


@pytest.mark.parametrize("arch", ARCHS)
def test_cp_train_step_on_ranks_matches_the_8_device_reference(eight, ref,
                                                               arch):
    """STEPS steps of build_train under cp on (2, 4) ranks (each "model"
    rank attends a quarter of q's rows; wq, wk, wv and x sum their
    gradients over them): losses and every leaf of the state within TOL
    of the reference's, the same on every rank, which holds exactly
    position_bytes."""
    cfg = _config(arch)
    got = eight[0]["train"][arch]
    for r in eight:
        rec = r["train"][arch]
        assert rec["losses"] == got["losses"]
        assert rec["norms"] == got["norms"]
        assert rec["held"][0] == rec["held"][1]
        _same_tree(rec["final"], got["final"])
    want = ref["train"][arch]
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    assert_state(_port_state(got["final"], cfg), want["final"], cfg, TOL,
                 "leaf")


def test_a_mesh_over_some_ranks_is_none_on_the_others(eight):
    got = [r["members"] for r in eight]
    assert got[4:] == [None] * 4
    assert [g["rank"] for g in got[:4]] == [0, 1, 2, 3]
    assert [g["coords"] for g in got[:4]] == [
        {"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    assert [g["model_sum"] for g in got[:4]] == [1.0, 1.0, 5.0, 5.0]


# --------------------------------------------------------------------------
# world-free: kernel 10's partials and its reading of a kv-head range
# --------------------------------------------------------------------------

def _ring_case(case: str, rng):
    """(q, k, v, q_pos, kv_pos, window) of a decode over a ring of 64
    slots with the valid slots that `case` names."""
    b, kvh, g, s, d = 3, 2, 2, 64, 16
    q = torch.from_numpy(rng.standard_normal((b, kvh, g, d),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((b, kvh, s, d),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((b, kvh, s, d),
                                             dtype=np.float32))
    kv_pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    q_pos = np.full(b, s - 1, np.int32)
    window = 0
    if case == "masked_block":       # the last 16 slots never written
        kv_pos[:, 48:] = INF_POS
        q_pos[:] = 47
    elif case == "masked_row":       # row 1: every slot in its future
        q_pos[1] = -1
    elif case == "all_masked":
        kv_pos[:] = INF_POS
    elif case == "window":           # a wrapped ring under a window of 20
        kv_pos = (np.arange(s, dtype=np.int32) + 100)[None].repeat(b, 0)
        kv_pos[:, :30] += s          # slots 0-29 hold the newest positions
        q_pos[:] = 100 + s + 29
        window = 20
    return (q, k, v, torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
            window)


RING_CASES = ("full", "masked_block", "masked_row", "all_masked", "window")


@pytest.mark.parametrize("blocks", [2, 4, 8])
@pytest.mark.parametrize("case", RING_CASES)
def test_plain_partials_of_ring_blocks_combine_to_decode_ref(case, blocks):
    """The ring cut into `blocks` blocks of slots: each block's plain
    partial (decode_partial_ref), combined (combine_ref), is decode_ref
    on the whole ring within 1e-6, with a block masked whole beside
    valid ones (it weighs nothing), a row masked in every block (the
    uniform average over the whole ring) and a sliding window."""
    q, k, v, q_pos, kv_pos, window = _ring_case(
        case, np.random.default_rng(blocks))
    want = dec_ref.decode_ref(q, k, v, q_pos, kv_pos, window=window)
    n = k.shape[2] // blocks
    parts = [dec_ref.decode_partial_ref(
        q, k[:, :, i * n:(i + 1) * n], v[:, :, i * n:(i + 1) * n], q_pos,
        kv_pos[:, i * n:(i + 1) * n], window=window) for i in range(blocks)]
    got = dec_ref.combine_ref(*(torch.stack(t) for t in zip(*parts)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    if case in ("masked_row", "all_masked"):
        rows = [1] if case == "masked_row" else [0, 1, 2]
        np.testing.assert_allclose(
            got[rows].numpy(),
            v[rows].mean(dim=2, keepdim=True).expand(-1, -1, 2, -1).numpy(),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", RING_CASES)
def test_a_blocks_partial_is_its_normalised_softmax(case):
    """decode_partial_ref of the whole ring: its output is decode_ref's,
    m the largest masked score (-1e30 where every slot is masked) and l
    the masked softmax's denominator (the slot count there)."""
    q, k, v, q_pos, kv_pos, window = _ring_case(case,
                                                np.random.default_rng(7))
    out, m, l_ = dec_ref.decode_partial_ref(q, k, v, q_pos, kv_pos,
                                            window=window)
    np.testing.assert_allclose(out.numpy(), dec_ref.decode_ref(
        q, k, v, q_pos, kv_pos, window=window).numpy(), rtol=1e-6,
        atol=1e-6)
    dp = q_pos[:, None] - kv_pos
    ok = (dp >= 0) & ((dp < window) if window else True)
    none = ~ok.any(dim=1)
    assert bool((m[none] == -1e30).all())
    assert bool((l_[none] == k.shape[2]).all())
    assert bool((l_[~none] >= 1).all())


def test_the_op_reads_a_kv_head_range_in_place():
    """A kv-head narrow of a contiguous ring (its batch rows farther apart
    than KVH * S * D) goes to the kernel as it is (ring_strides gives its
    batch stride), the whole ring too; a transposed ring is copied
    contiguous; the plain version gives the same values on either."""
    ring = torch.randn(8, 4, 32, 16)
    part = ring.narrow(1, 1, 2)
    assert dec_kernel.ring_strides(ring) == 4 * 32 * 16
    assert dec_kernel.ring_strides(part) == 4 * 32 * 16
    assert dec_kernel.ring_strides(ring[:1].narrow(1, 3, 1)) == 32 * 16
    assert dec_kernel.ring_strides(ring.transpose(2, 3)) is None
    assert dec_kernel.ring_strides(ring[:, :, ::2]) is None
    q = torch.randn(8, 2, 2, 16)
    q_pos = torch.full((8,), 31, dtype=torch.int32)
    kv_pos = torch.arange(32, dtype=torch.int32).expand(8, 32)
    ops_args = dec_ops._operands(q, part, part, q_pos, kv_pos)
    assert ops_args[1] is part and ops_args[2] is part
    copied = dec_ops._operands(q, ring.transpose(2, 3), ring.transpose(2, 3),
                               q_pos, kv_pos.narrow(1, 0, 16))
    assert copied[1].is_contiguous()
    np.testing.assert_array_equal(
        dec_ops.decode_attention(q, part, part, q_pos, kv_pos).numpy(),
        dec_ops.decode_attention(q, part.contiguous(), part.contiguous(),
                                 q_pos, kv_pos).numpy())


def test_the_partial_entry_refuses_cpu_tensors_before_launching():
    """decode_attention_partial under mode "cuda" on CPU tensors raises,
    and the kernel's partial entry refuses them without a launch."""
    q, k, v, q_pos, kv_pos, _ = _ring_case("full", np.random.default_rng(1))
    before = dec_kernel.LAUNCHES
    with pytest.raises(ValueError, match="lies on the CPU"):
        dec_ops.decode_attention_partial(q, k, v, q_pos, kv_pos,
                                         mode="cuda")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        dec_kernel.decode_attention_fwd(q, k, v, q_pos, kv_pos,
                                        partial=True)
    assert dec_kernel.LAUNCHES == before
