"""The port's sharding rules and logical trees against the JAX package's,
in one process (no ranks): ``parallel/sharding.logical_to_spec`` on every
case of ``tests/test_sharding.py``, and on every arch x mesh of
``tests/test_launch_specs.py`` (16x16 and 2x16x16, duck-typed meshes)
for the params, the batch and the decode cache, with and without the
context-parallel overrides; ``abstract_params``, ``init_cache_logical``
and the input stand-ins against JAX's tree structure and shapes; the
specs' DTensor placements. Specs compare exactly."""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs, shape_applicable
from repro.launch import inputs as JI
from repro.models.model import init_cache_logical as jax_init_cache_logical
from repro.models.params import abstract_params as jax_abstract_params
from repro.parallel import sharding as JS
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import inputs as TI
from repro_torch.models import model as TM
from repro_torch.models.params import abstract_params, init_params
from repro_torch.parallel import sharding as TS


class FakeMesh:
    """Duck-typed mesh with arbitrary axis sizes (``tests/test_sharding.py``)."""
    def __init__(self, shape):
        self.shape = shape


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
ARCHS = list_archs()
JDTYPE = {jnp.float32: torch.float32, jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


def _same_spec(logical, shape, dim_sizes=None, overrides=None):
    m = FakeMesh(shape)
    port = TS.logical_to_spec(logical, m, dim_sizes=dim_sizes, overrides=overrides)
    ref = tuple(JS.logical_to_spec(logical, m, dim_sizes=dim_sizes, overrides=overrides))
    assert port == ref, (logical, shape, dim_sizes, port, ref)
    return port


# tests/test_sharding.py's cases: (logical, mesh shape, dim sizes, overrides)
RULE_CASES = [
    (("fsdp", "heads", None), {"data": 16, "model": 16}, None, None),
    (("vocab", "fsdp"), {"data": 16, "model": 16}, None, None),
    (("fsdp", "kv_heads", None), {"data": 16, "model": 16}, (4096, 2, 128), None),
    (("fsdp", "kv_heads", None), {"data": 16, "model": 16}, (4096, 16, 128), None),
    (("fsdp", "heads", None), {"data": 8}, None, None),
    (("batch", None), {"pod": 2, "data": 16, "model": 16}, (256, 128), None),
    (("batch", None), {"pod": 2, "data": 16, "model": 16}, (1, 128), None),
    (("kv_seq",), {"pod": 2, "data": 16, "model": 16}, (524288,), {"kv_seq": "data"}),
    (("flat_shard",), {"data": 4, "model": 2}, (64,), None),
    (("flat_shard",), {"data": 4, "model": 2}, (12,), None),
    (("experts", "fsdp", None, None), {"data": 2, "model": 2}, (32, 1024, 2, 512), None),
    (("batch", "kv_seq", "kv_heads", None), {"pod": 2, "data": 16, "model": 16},
     (2, 4096, 8, 128), JS.CONTEXT_PARALLEL_OVERRIDES),
]


@pytest.mark.parametrize("case", RULE_CASES, ids=lambda c: f"{c[0]}-{sorted(c[1].items())}")
def test_logical_to_spec_rule_cases(case):
    _same_spec(*case)


def test_rule_case_values():
    """The JAX test's expectations, restated on the port."""
    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert TS.logical_to_spec(("batch", None), m, dim_sizes=(256, 128)) == (("pod", "data"), None)
    assert TS.logical_to_spec(("batch", None), m, dim_sizes=(1, 128)) == (None, None)
    assert TS.mesh_axis_size(FakeMesh({"pod": 2, "data": 16}), ("pod", "data")) == 32
    assert TS.mesh_axis_size(m, "absent") == 1 and TS.mesh_axis_size(m, None) == 1
    assert TS.RULES == JS.RULES
    assert TS.CONTEXT_PARALLEL_OVERRIDES == JS.CONTEXT_PARALLEL_OVERRIDES


def test_rule_overrides_nest_and_restore():
    m = FakeMesh({"pod": 2, "data": 4})
    with TS.rule_overrides({"batch": "data"}), JS.rule_overrides({"batch": "data"}):
        assert _same_spec(("batch",), m.shape, (8,)) == ("data",)
    assert _same_spec(("batch",), m.shape, (8,)) == (("pod", "data"),)


@pytest.fixture(scope="module")
def jax_params():
    """JAX's abstract params per arch, built once per module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = jax_abstract_params(jax_get_config(arch))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_jax(jax_params, arch):
    """Tree structure, shapes and dtypes of the meta-device params, and
    the logical tree, equal JAX's; at a reduced size the tree is
    ``init_params``'s."""
    jshapes, jlogical = jax_params(arch)
    shapes, logical = abstract_params(get_config(arch))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(jshapes)
    assert jax.tree.leaves(logical, is_leaf=TS.is_logical) == \
        jax.tree.leaves(jlogical, is_leaf=TS.is_logical)
    for t, j in zip(jax.tree.leaves(shapes), jax.tree.leaves(jshapes)):
        assert tuple(t.shape) == j.shape and t.dtype == JDTYPE[j.dtype.type]
        assert t.device.type == "meta"
    small, _ = abstract_params(get_config(arch).reduced())
    real = init_params(get_config(arch).reduced(), torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_structure(small) == jax.tree_util.tree_structure(real)
    assert [t.shape for t in jax.tree.leaves(small)] == [t.shape for t in jax.tree.leaves(real)]


def _specs(shardings):
    return [s.spec for s in jax.tree.leaves(
        shardings, is_leaf=lambda x: isinstance(x, TS.NamedSharding))]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(jax_params, arch, mesh_name):
    """Every param leaf's spec on the mesh (``tree_shardings``) equals
    JAX's ``logical_to_spec``, and its sharded dims divide."""
    shapes, logical = abstract_params(get_config(arch))
    mesh = FakeMesh(MESHES[mesh_name])
    jshapes, jlogical = jax_params(arch)
    ref = [tuple(JS.logical_to_spec(lg, mesh, dim_sizes=js.shape)) for lg, js in
           zip(jax.tree.leaves(jlogical, is_leaf=TS.is_logical), jax.tree.leaves(jshapes))]
    assert _specs(TS.tree_shardings(logical, shapes, mesh)) == ref
    for spec, js in zip(ref, jax.tree.leaves(jshapes)):
        for dim, part in enumerate(spec):
            if part is not None:
                assert js.shape[dim] % TS.mesh_axis_size(mesh, part) == 0


CELLS = [(arch, shape, mesh) for arch in ARCHS for shape in JSHAPES for mesh in MESHES
         if shape_applicable(jax_get_config(arch), JSHAPES[shape])[0]]


@pytest.mark.parametrize("arch,shape_name,mesh_name", CELLS)
def test_batch_and_cache_specs_match_jax(arch, shape_name, mesh_name):
    """``batch_specs`` / ``batch_shardings`` and, for decode shapes,
    ``decode_specs`` / ``decode_shardings`` (with and without the
    context-parallel overrides) against JAX's: shapes, dtypes and specs."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
    mesh = FakeMesh(MESHES[mesh_name])
    amesh = AbstractMesh(tuple(MESHES[mesh_name].values()), tuple(MESHES[mesh_name]))
    bs, jbs = TI.batch_specs(cfg, shape), JI.batch_specs(jcfg, jshape)
    assert list(bs) == list(jbs)
    for k in bs:
        assert tuple(bs[k].shape) == jbs[k].shape and bs[k].dtype == JDTYPE[jbs[k].dtype.type]
    port = TI.batch_shardings(cfg, shape, mesh)
    ref = JI.batch_shardings(jcfg, jshape, amesh)
    assert {k: v.spec for k, v in port.items()} == {k: tuple(v.spec) for k, v in ref.items()}
    if shape.kind != "decode":
        return
    tok, cache, pos = TI.decode_specs(cfg, shape)
    jtok, jcache, jpos = JI.decode_specs(jcfg, jshape)
    assert [tuple(t.shape) for t in jax.tree.leaves(cache)] == \
        [j.shape for j in jax.tree.leaves(jcache)]
    assert TM.init_cache_logical(cfg) == jax_init_cache_logical(jcfg)
    assert tuple(tok["tokens"].shape) == jtok["tokens"].shape and tuple(pos.shape) == ()
    for cp in (False, True):
        ptok, pcache = TI.decode_shardings(cfg, shape, mesh, context_parallel=cp)
        rtok, rcache = JI.decode_shardings(jcfg, jshape, amesh, context_parallel=cp)
        assert ptok["tokens"].spec == tuple(rtok["tokens"].spec)
        assert _specs(pcache) == [tuple(s.spec) for s in jax.tree.leaves(rcache)]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_matches_jax(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    cache, logical = TM.abstract_cache(cfg, 2, 64)
    jcache, jlogical = JI.M.abstract_cache(jcfg, 2, 64)
    assert logical == jlogical
    for t, j in zip(jax.tree.leaves(cache), jax.tree.leaves(jcache)):
        assert tuple(t.shape) == j.shape and t.dtype == JDTYPE[j.dtype.type]
        assert t.device.type == "meta"


def test_placements_follow_the_mesh_order():
    """A dim split over (pod, data) is Shard(dim) on both, which DTensor
    applies pod outermost, as ``P(("pod", "data"))``; a spec naming them
    in the other order raises instead of permuting rows."""
    mesh = FakeMesh({"pod": 2, "data": 2, "model": 2})
    assert TS.placements_for((("pod", "data"), None), mesh) == (Shard(0), Shard(0), Replicate())
    assert TS.placements_for((None, "model", "data"), mesh) == (Replicate(), Shard(2), Shard(1))
    assert TS.placements_for((("data", "model"),), mesh) == (Replicate(), Shard(0), Shard(0))
    with pytest.raises(ValueError):
        TS.placements_for((("data", "pod"),), mesh)
    for entry in TS.RULES.values():            # every rule names its axes in mesh order
        if isinstance(entry, tuple):
            TS.placements_for((entry,), mesh)


def test_local_shard_is_the_partition_spec_block():
    """``local_shard`` cuts the block that ``PartitionSpec`` gives a mesh
    position: a dim over (pod, data) is split pod-major."""
    class Pos(FakeMesh):
        def __init__(self, shape, coord):
            super().__init__(shape)
            self.coord = coord

        def index(self, axis):
            return self.coord[axis]
    x = torch.arange(16 * 6).reshape(16, 6)
    shape = {"pod": 2, "data": 4, "model": 2}
    for p in range(2):
        for d in range(4):
            for m in range(2):
                blk = TS.local_shard(x, Pos(shape, {"pod": p, "data": d, "model": m}),
                                     (("pod", "data"), "model"))
                i = p * 4 + d
                assert torch.equal(blk, x[i * 2:(i + 1) * 2, m * 3:(m + 1) * 3])


def test_constrain_is_the_identity_without_a_mesh_or_on_a_plain_tensor():
    x = torch.ones(4, 2)
    assert TS.constrain(x, "batch", None) is x
    with TS.use_mesh(FakeMesh({"data": 2})):
        assert TS.current_mesh() is not None
        assert TS.constrain(x, "batch", None) is x
    assert TS.current_mesh() is None


def test_decode_stand_ins_allocate_nothing():
    """Full-width decode stand-ins live on the meta device."""
    tok, cache, pos = TI.decode_specs(get_config("internlm2-1.8b"), SHAPES["decode_32k"])
    assert all(t.device.type == "meta" for t in jax.tree.leaves(cache) + [pos, tok["tokens"]])
