"""repro_torch.core.hlo against repro.core.hlo: the reference's HLO
fixture, a real partitioned program's HLO and edge cases go through both
packages' parse_collectives and collective_summary, field for field.

The real HLO comes from a child with 8 host devices (the device count
locks at JAX's first import, so it cannot run in the pytest process):
`python tests/test_torch_hlo.py child OUT` writes the compiled text of a
shard_map program with an all-gather, an all-reduce and a
reduce-scatter to OUT.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# tests/test_core_engines.py::TestHloParser.HLO, the reference's fixture
FIXTURE = """
  %ag = f32[2048,5784]{1,0} all-gather(%x), channel_id=5, replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}
  %ar = bf16[64,512]{1,0} all-reduce(%dot), channel_id=1, replica_groups=[2,4]<=[8], to_apply=%add
  %rs = f32[8,128]{1,0} reduce-scatter(%g), channel_id=2, replica_groups={{0,1,2,3}}, dimensions={0}
  %aa = f32[16,16]{1,0} all-to-all(%y), channel_id=3, replica_groups=[4,2]<=[8]
  %cp = f32[4,4]{1,0} collective-permute(%z), channel_id=4, source_target_pairs={{0,1}}
  %not_a_collective = f32[2,2]{1,0} add(%a, %b)
"""

# async starts carry (operand, result): the parser halves their bytes;
# explicit groups count their members; a tuple result sums its parts
EDGES = """
  %ags = (f32[16,8]{1,0}, f32[64,8]{1,0}) all-gather-start(%p), channel_id=7, replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %ard = bf16[128]{0} all-reduce-done(%ars)
  %ars = (bf16[128]{0}, bf16[128]{0}) all-reduce-start(%q), channel_id=8, replica_groups={{0,4},{1,5},{2,6},{3,7}}, to_apply=%add
  %cps = (s32[4,4]{1,0}, s32[4,4]{1,0}, u32[], u32[]) collective-permute-start(%r), channel_id=9, source_target_pairs={{0,1},{1,0}}
  %art = (f32[], f32[8,2]{1,0}, pred[3]{0}) all-reduce(%s, %t, %u), channel_id=10, replica_groups=[64,4]<=[256], to_apply=%add
  %rsx = u8[3,5]{1,0} reduce-scatter(%v), channel_id=11, replica_groups={{0, 1}}, dimensions={1}
  %a2a = (f16[2,2]{1,0}, f16[2,2]{1,0}) all-to-all(%w, %x), channel_id=12, replica_groups={{0,1},{2,3}}
"""

CHILD = r'''
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.launch.mesh import make_mesh

mesh = make_mesh((2, 4), ("data", "model"))


def body(x, y):
    g = jax.lax.all_gather(x, "model", axis=0, tiled=True)
    s = jax.lax.psum(y, "data")
    r = jax.lax.psum_scatter(y, "model", scatter_dimension=1, tiled=True)
    return g, s, r


f = jax.shard_map(body, mesh=mesh, in_specs=(P("model"), P()),
                  out_specs=(P(), P(), P(None, "model")), check_vma=False)
text = jax.jit(f).lower(jax.ShapeDtypeStruct((64, 32), jnp.float32),
                        jax.ShapeDtypeStruct((16, 32), jnp.bfloat16)
                        ).compile().as_text()
'''


def _child(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, str(ROOT / "src"))
    scope: dict = {}
    exec(CHILD, scope)
    Path(out).write_text(json.dumps({"text": scope["text"]}))


@pytest.fixture(scope="module")
def real_hlo(tmp_path_factory) -> str:
    out = tmp_path_factory.mktemp("hlo") / "hlo.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    subprocess.run([sys.executable, __file__, "child", str(out)], env=env,
                   check=True, timeout=300, cwd=ROOT)
    return json.loads(out.read_text())["text"]


def _both():
    from repro.core import hlo as ref
    from repro_torch.core import hlo as port
    return ref, port


def _fields(ops) -> list:
    return [(o.kind, o.result_bytes, o.group_size, o.line, o.ring_bytes)
            for o in ops]


@pytest.mark.parametrize("name", ["fixture", "edges"])
def test_parse_and_summary_equal(name):
    ref, port = _both()
    text = FIXTURE if name == "fixture" else EDGES
    assert _fields(port.parse_collectives(text)) == \
        _fields(ref.parse_collectives(text))
    assert port.collective_summary(text) == ref.collective_summary(text)


def test_fixture_values():
    """The reference test's own assertions, on the port's parser."""
    _, port = _both()
    ops = port.parse_collectives(FIXTURE)
    assert [o.kind for o in ops] == ["all-gather", "all-reduce",
                                     "reduce-scatter", "all-to-all",
                                     "collective-permute"]
    ag, ar, rs, aa, cp = ops
    assert ag.result_bytes == 2048 * 5784 * 4 and ag.group_size == 16
    assert ar.result_bytes == 64 * 512 * 2 and ar.group_size == 4
    assert rs.group_size == 4
    assert ar.ring_bytes == 2 * ar.result_bytes * 3 / 4
    assert ag.ring_bytes == ag.result_bytes * 15 / 16
    assert rs.ring_bytes == rs.result_bytes * 3
    assert cp.ring_bytes == cp.result_bytes
    assert aa.ring_bytes == aa.result_bytes * 1 / 2


def test_start_halving_and_explicit_groups():
    _, port = _both()
    ops = {o.line.split()[0]: o for o in port.parse_collectives(EDGES)}
    assert set(ops) == {"%ags", "%ars", "%cps", "%art", "%rsx", "%a2a"}
    # (16*8 + 64*8) * 4 bytes, halved; 4 members a group
    assert ops["%ags"].result_bytes == (16 * 8 + 64 * 8) * 4 // 2
    assert ops["%ags"].group_size == 4
    assert ops["%ars"].result_bytes == 128 * 2 and \
        ops["%ars"].group_size == 2
    # the two u32[] context words halve in with the operands
    assert ops["%cps"].result_bytes == (2 * 16 * 4 + 2 * 4) // 2
    assert ops["%cps"].ring_bytes == ops["%cps"].result_bytes
    assert ops["%art"].result_bytes == 4 + 8 * 2 * 4 + 3 and \
        ops["%art"].group_size == 4
    assert ops["%rsx"].group_size == 2 and ops["%rsx"].result_bytes == 15
    assert ops["%a2a"].result_bytes == 16 and ops["%a2a"].group_size == 2


@pytest.mark.parametrize("name", ["fixture", "edges", "real"])
def test_summarize_is_summary_of_parse(name, request):
    _, port = _both()
    text = {"fixture": FIXTURE, "edges": EDGES}.get(name) or \
        request.getfixturevalue("real_hlo")
    assert port.summarize(port.parse_collectives(text)) == \
        port.collective_summary(text)


def test_real_partitioned_hlo(real_hlo):
    ref, port = _both()
    got = port.parse_collectives(real_hlo)
    assert _fields(got) == _fields(ref.parse_collectives(real_hlo))
    assert port.collective_summary(real_hlo) == \
        ref.collective_summary(real_hlo)
    kinds = {o.kind: o for o in got}
    assert set(kinds) >= {"all-gather", "all-reduce", "reduce-scatter"}
    # the program's shapes: gathered (64, 32) f32 over 4; psum (16, 32)
    # bf16 over 2; scattered (16, 8) over 4 (the CPU backend may promote
    # the bf16 reduction to f32)
    assert kinds["all-gather"].result_bytes == 64 * 32 * 4
    assert kinds["all-gather"].group_size == 4
    assert kinds["all-reduce"].group_size == 2
    assert kinds["all-reduce"].result_bytes in (16 * 32 * 2, 16 * 32 * 4)
    assert kinds["reduce-scatter"].group_size == 4
    assert kinds["reduce-scatter"].result_bytes in (16 * 8 * 2, 16 * 8 * 4)


if __name__ == "__main__" and sys.argv[1:2] == ["child"]:
    _child(sys.argv[2])
