"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``) at both production meshes, for all
ten configs: every parameter, optimizer, batch and cache spec, the vocab
divisibility guard, ``abstract_params``' shapes and dtypes, and the
per-rank argument bytes of the distributed parameters.

The reference's functions run with a stand-in mesh (``FakeMesh``: its
``shape`` mapping and axis names, the idiom of ``tests/test_launch.py``)
and its ``NamedSharding`` replaced by the bare spec, so no JAX device is
needed.  The port's tree keeps one dict a layer: a stacked leaf's spec
here is the reference's without the leading Nones of its layer axes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import REGISTRY as JREGISTRY               # noqa: E402
from repro.launch import sharding as jshd                     # noqa: E402
from repro.launch import steps as jsteps                      # noqa: E402
from repro.models import model as jmodel                      # noqa: E402
from repro.optim import adamw_init as jadamw_init             # noqa: E402
from repro_torch.configs import REGISTRY                      # noqa: E402
from repro_torch.launch import sharding as shd                # noqa: E402
from repro_torch.launch import steps                          # noqa: E402
from repro_torch.models import model                          # noqa: E402
from repro_torch.optim.adamw import adamw_init                # noqa: E402
from repro_torch.pytree import leaves, paths                  # noqa: E402

MESHES = {"pod1": {"data": 16, "model": 16},
          "pod2": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.fixture
def jax_specs(monkeypatch):
    """The reference's sharding functions, returning bare specs."""
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)
    return jshd


def _jax_leaves(tree):
    """{keystr path: tuple spec} of a JAX tree of specs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _port_leaves(spec_tree):
    """{keystr path: tuple spec} of a port tree of specs."""
    out = {}

    def put(path, spec):
        out["".join(f"['{e}']" if isinstance(e, str) else f"[{e}]"
                    for e in path)] = tuple(spec)
    shd.map_with_path(put, spec_tree)
    return out


def _stacked_specs(spec_tree):
    """The port's per-layer spec tree in the reference's stacked layout:
    each list of layers one spec a name, with a None a layer axis (every
    layer's spec checked equal; a replicated leaf's empty spec stays
    empty, as the reference's ``P()``)."""
    out = {}
    for name, t in spec_tree.items():
        if name in ("blocks", "enc_blocks", "dec_blocks", "mamba"):
            layers = ([l for g in t for l in g] if name == "mamba" else t)
            lead = (None, None) if name == "mamba" else (None,)
            for leaf in layers[0]:
                specs = {tuple(layer[leaf]) for layer in layers}
                assert len(specs) == 1, (name, leaf, specs)
                spec = specs.pop()
                # a leaf without a rule is P() stacked or not
                out[f"['{name}']['{leaf}']"] = lead + spec if spec else ()
        elif isinstance(t, dict):
            out.update({f"['{name}']['{k}']": tuple(v) for k, v in t.items()})
        else:
            out[f"['{name}']"] = tuple(t)
    return out


def _port_tree(name):
    return model.param_tree(model.abstract_params(REGISTRY[name]))


@pytest.mark.parametrize("pod", sorted(MESHES))
def test_param_specs_equal_the_reference(jax_specs, pod):
    mesh = FakeMesh(MESHES[pod])
    for name in sorted(REGISTRY):
        want = _jax_leaves(jax_specs.param_shardings(
            mesh, jmodel.abstract_params(JREGISTRY[name])))
        got = _stacked_specs(shd.param_shardings(mesh, _port_tree(name)))
        assert got == want, name


def test_opt_shardings_mirror_the_params(jax_specs):
    mesh = FakeMesh(MESHES["pod2"])
    for name in sorted(REGISTRY):
        jp = jmodel.abstract_params(JREGISTRY[name])
        jo = jax_specs.opt_shardings(mesh, jax.eval_shape(jadamw_init, jp), jp)
        tree = _port_tree(name)
        po = shd.opt_shardings(mesh, adamw_init(tree), tree)
        assert tuple(po.step) == tuple(jo.step) == ()
        want_m = _jax_leaves(jo.m)
        assert _stacked_specs(po.m) == want_m == _jax_leaves(jo.v), name
        assert _stacked_specs(po.v) == want_m, name


@pytest.mark.parametrize("pod", sorted(MESHES))
def test_batch_spec_every_shape(jax_specs, pod):
    mesh = FakeMesh(MESHES[pod])
    for name in ("granite-8b", "qwen2-vl-2b", "seamless-m4t-large-v2",
                 "mamba2-1.3b"):
        for shape, (S, B) in steps.SHAPES.items():
            for labels in (True, False):
                jb = jsteps.batch_abstract(JREGISTRY[name], B, S, labels)
                pb = steps.batch_abstract(REGISTRY[name], B, S, labels)
                got = {k: tuple(v) for k, v in
                       shd.batch_spec(mesh, pb, B).items()}
                want = {k: tuple(v) for k, v in
                        jax_specs.batch_spec(mesh, jb, B).items()}
                assert got == want, (name, shape)
    # long_500k's B = 1 does not divide the batch axes: the sequence does
    tok = steps.batch_abstract(REGISTRY["mamba2-1.3b"], 1, 524288)
    baxes = ("pod", "data") if pod == "pod2" else "data"
    assert tuple(shd.batch_spec(mesh, tok, 1)["tokens"]) == (None, baxes)


def test_cache_shardings_prefill_and_decode_every_family(jax_specs):
    for pod, sizes in MESHES.items():
        mesh = FakeMesh(sizes)
        for name in sorted(REGISTRY):
            pcfg, jcfg = REGISTRY[name], JREGISTRY[name]
            for shape in ("prefill_32k", "decode_32k", "long_500k"):
                if not steps.shape_applicable(pcfg, shape)[0]:
                    continue
                S, B = steps.SHAPES[shape]
                enc = S // jcfg.enc_seq_divisor if jcfg.is_encdec else 0
                jc = jax.eval_shape(lambda: jmodel.init_cache(
                    jcfg, B, S, enc_len=enc))
                pc = model.init_cache(pcfg, B, S, enc_len=enc, device="meta")
                for decode in (False, True):
                    want = _jax_leaves(jax_specs.cache_shardings(
                        mesh, jc, jcfg, B, decode=decode))
                    got = _port_leaves(shd.cache_shardings(
                        mesh, pc, pcfg, B, decode))
                    assert got == want, (pod, name, shape, decode)


def test_vocab_guard_drops_the_axis_that_does_not_divide(jax_specs):
    mesh = FakeMesh(MESHES["pod1"])
    leaf = jax.ShapeDtypeStruct((50280, 2048), jax.numpy.bfloat16)
    want = tuple(jax_specs.param_spec(
        (jax.tree_util.DictKey("embed"),), leaf, mesh))
    got = shd.param_spec(("embed",), torch.empty((50280, 2048),
                                                 device="meta"), mesh)
    assert got == want == (None, "data")
    got = shd.param_spec(("head",), torch.empty((2048, 50280),
                                                device="meta"), mesh)
    assert got == ("data", None)


def test_abstract_params_equal_jax_eval_shape():
    for name in sorted(REGISTRY):
        want = jax.tree_util.tree_flatten_with_path(
            jmodel.abstract_params(JREGISTRY[name]))[0]
        got = model.stacked(_port_tree(name))
        got = dict(zip(paths(got), leaves(got)))
        assert len(got) == len(want), name
        for path, leaf in want:
            t = got[jax.tree_util.keystr(path)]
            assert t.is_meta, name
            assert tuple(t.shape) == leaf.shape, (name, path)
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype), (name,
                                                                   path)


@pytest.fixture(scope="module")
def fake_world_512():
    import torch.distributed as dist
    from repro_torch.launch.mesh import fake_world
    fake_world(512)
    yield
    dist.destroy_process_group()


def test_argument_bytes_are_the_local_shards_of_the_reference_specs(
        jax_specs, fake_world_512):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_production_mesh
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        fmesh = FakeMesh(sizes)
        for name in ("granite-8b", "olmoe-1b-7b", "qwen2-vl-2b",
                     "mamba2-1.3b", "zamba2-2.7b", "seamless-m4t-large-v2"):
            want = 0
            for leaf, spec in zip(
                    jax.tree.leaves(jmodel.abstract_params(JREGISTRY[name])),
                    jax.tree.leaves(jax_specs.param_shardings(
                        fmesh, jmodel.abstract_params(JREGISTRY[name])),
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))):
                local = list(leaf.shape)
                for d, entry in enumerate(spec):
                    for ax in ((entry,) if isinstance(entry, str)
                               else entry or ()):
                        assert local[d] % sizes[ax] == 0
                        local[d] //= sizes[ax]
                want += int(np.prod(local)) * leaf.dtype.itemsize
            with FakeTensorMode():
                params = shd.distribute_params(
                    model.abstract_params(REGISTRY[name]), mesh)
                got = sum(p.to_local().numel() * p.element_size()
                          for p in params.parameters())
            assert got == want, (name, multi_pod)
