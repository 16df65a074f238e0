"""The moe layer on a mesh (``models.moe``'s expert-parallel path) held to
the plain layer and to the reference: reduced olmoe-1b-7b and arctic-480b
(f32 weights from JAX's ``init_params``, carried over by
``params_from_numpy``; capacity factor 1 and the router's first column
scaled up, so that expert 0 overflows and assignments drop; arctic at a
vocabulary of 255, which the head keeps whole on the mesh) run
``forward_loss`` and its backward on a gloo world of 4 ranks, a 2 x 2
("data", "model") mesh, with ``sharding.distribute_params`` and the batch
placed by the reference's rules; the same steps run plain in this
process, and JAX's ``forward_loss`` (jitted) on the same weights.  The
cases (``CASES``): each arch at d_ff 32, under the capacity, where the
expert weights are gathered as in a train step at full width; olmoe at a
batch of 1, which "data" does not divide (the sequence is split there),
and at 3 experts, which "model" does not divide (the experts replicated
there): in both a mesh dimension splits the capacity but not the tokens;
arctic at the reduced config's own d_ff, 96, over the capacity, where
the products are left to DTensor on the FSDP weights, as in a decode
step.

Tolerances, ``test_torch_sharded_step.py``'s: the sharded loss within 1e-6
of the plain one, each gradient within 1e-5 of its leaf's max |g|; the
plain loss within 1e-4 of JAX's.  The dropped assignments (every
``dispatch`` of the step, the backward's recompute included) are the plain
step's.  Each rank holds a quarter of each expert buffer (what
``_experts`` takes, its three products and what it returns): the buffer
and the output split over the experts on "model" and over the capacity on
"data" (with 3 experts, over the capacity on both); where d_ff passes the
capacity, DTensor's products keep the FSDP weights' split of d_model and
gather the capacity instead.  And the reduced olmoe-1b-7b
``train_4k`` cell (256 x 4096 tokens) on the fake 16 x 16 world traces
``ok`` with its peak below one layer's whole (E, cap, D) buffer; it runs
the full config's attention blocks (512, 1024), as the reduced ones (16,
32) would make 8,192 blocks a layer at S = 4096 to trace.
"""
import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing import run_world                     # noqa: E402

ARCHS = ("olmoe-1b-7b", "arctic-480b")
# arctic at a vocabulary the "model" axis does not divide (seamless-m4t's
# 256,206 over 16): the head keeps it whole, and the loss is each rank's
# own positions' (``model._ce_sums_on_shards``)
EDITS = {"olmoe-1b-7b": {}, "arctic-480b": {"vocab": 255}}
# each arch's cases, (name, config edits, batch); the capacity is 48 at a
# batch of 4 and 12 at 1
CASES = {"olmoe-1b-7b": (("d_ff=32", {"d_ff": 32}, 4),
                         ("batch=1", {"d_ff": 8}, 1),
                         ("experts=3", {"d_ff": 32, "moe_experts": 3}, 4)),
         "arctic-480b": (("d_ff=32", {"d_ff": 32}, 4),
                         ("d_ff=96", {"d_ff": 96}, 4))}
S = 24
TIME_LIMIT_S = 240
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(arch, edits, get_config=None):
    if get_config is None:
        from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32", moe_capacity_factor=1.0,
                               **EDITS[arch], **edits)


def _batch(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


def _record(moe):
    """Wrap ``moe.dispatch`` and ``moe._experts``: the keep mask of every
    dispatch (assignment order) and the local shapes of the experts'
    buffer, their three products and their output."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    keeps, shapes = [], []
    dispatch, experts = moe.dispatch, moe._experts

    def local(t):
        return tuple((t.to_local() if hasattr(t, "to_local") else t).shape)

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented     # its local ops come back here
            out = func(*args, **(kwargs or {}))
            # (DTensor's sharding propagation runs fake ops of the global
            # shapes: not a rank's tensors)
            if func is torch.ops.aten.bmm.default \
                    and not isinstance(out, FakeTensor):
                shapes.append(tuple(out.shape))
            return out

    def rec_dispatch(top_i, cap, E):
        d = dispatch(top_i, cap, E)
        keeps.append(torch.empty_like(d.keep).scatter_(0, d.order,
                                                       d.keep).numpy())
        return d

    def rec_experts(p, buf):
        shapes.append(local(buf))
        with Shapes():
            out = experts(p, buf)
        shapes.append(local(out))
        return out

    moe.dispatch, moe._experts = rec_dispatch, rec_experts
    return keeps, shapes


def _loss_grads(params, cfg, batch, mesh):
    """(loss, {path: gradient}, keep masks, expert shapes) of
    ``forward_loss`` and its backward, plain (``mesh`` None) or on
    ``mesh``; tensors whole, on the host."""
    from repro_torch.dtensor import is_dtensor
    from repro_torch.launch import sharding as shd, steps
    from repro_torch.models import model, moe
    from repro_torch.pytree import leaves, paths

    def whole(t):
        return (t.full_tensor() if is_dtensor(t) else t).detach()

    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mesh is not None:
        batch = steps.distribute_inputs((batch,), (shd.placements_tree(
            mesh, shd.batch_spec(mesh, batch, len(batch["tokens"]))),),
            mesh)[0]
    saved = moe.dispatch, moe._experts
    keeps, shapes = _record(moe)
    tree = model.param_tree(params)
    params.requires_grad_(True)
    try:
        with steps.on_mesh(mesh):
            loss, _ = model.forward_loss(params, batch, cfg)
            loss.backward()
            grads = {p: whole(steps.placed_grad(t)) for p, t in
                     zip(paths(tree), leaves(tree))}
    finally:
        moe.dispatch, moe._experts = saved
    return whole(loss).item(), grads, keeps, shapes


def rank_main(rank, world, store, weights, out):
    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import mesh_cfg
    from repro_torch.models import model
    torch.set_num_threads(1)          # four ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        with open(weights, "rb") as f:
            trees = pickle.load(f)
        res = {}
        for arch in ARCHS:
            for case, edits, B in CASES[arch]:
                cfg = mesh_cfg(_cfg(arch, edits), mesh, B)
                params = model.params_from_numpy(cfg, trees[arch, case],
                                                 device="cpu")
                shd.distribute_params(params, mesh)
                res[arch, case] = _loss_grads(params, cfg, _batch(cfg, B),
                                              mesh)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _skewed(tree):
    """The router's first column x 4: expert 0 takes more than its share."""
    router = np.array(tree["blocks"]["router"])
    router[..., 0] *= 4.0
    return dict(tree, blocks=dict(tree["blocks"], router=router))


_CELL = """
import dataclasses, sys
import torch
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.launch import dryrun
arch = "olmoe-1b-7b"
cfg = configs.REGISTRY[arch]
configs.REGISTRY[arch] = dryrun.REGISTRY[arch] = dataclasses.replace(
    cfg.reduced(), attn_q_block=cfg.attn_q_block,
    attn_kv_block=cfg.attn_kv_block)
rec = dryrun.run_cell(arch, "train_4k", False, sys.argv[1], force=True,
                      device="cpu", verbose=False)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget
    from repro.models import model as jmodel
    from repro_torch.models import model
    d = tmp_path_factory.mktemp("moe_sharded")
    # the fake 16 x 16 cell traces in its own process meanwhile
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cell = subprocess.Popen([sys.executable, "-c", _CELL, str(d)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        trees, jlosses = {}, {}
        for arch in ARCHS:
            for case, edits, B in CASES[arch]:
                jcfg = _cfg(arch, edits, jget)
                trees[arch, case] = _skewed(jax.tree.map(
                    np.asarray,
                    jmodel.init_params(jcfg, jax.random.PRNGKey(0))))
                jlosses[arch, case] = float(jax.jit(
                    lambda p, b, c=jcfg: jmodel.forward_loss(p, b, c)[0])(
                        trees[arch, case], _batch(jcfg, B)))
        weights, out = str(d / "weights.pkl"), str(d / "rank0.pkl")
        with open(weights, "wb") as f:
            pickle.dump(trees, f)
        run_world(rank_main, 4, (str(d / "store"), weights, out),
                  time.monotonic() + TIME_LIMIT_S)
        with open(out, "rb") as f:
            sharded = pickle.load(f)
        plain = {}
        for arch in ARCHS:
            for case, edits, B in CASES[arch]:
                cfg = _cfg(arch, edits)
                plain[arch, case] = _loss_grads(model.params_from_numpy(
                    cfg, trees[arch, case], device="cpu"), cfg,
                    _batch(cfg, B), None)
        log, _ = cell.communicate(timeout=TIME_LIMIT_S)
    finally:
        if cell.poll() is None:
            cell.kill()
            cell.wait()
    path = d / "olmoe-1b-7b__train_4k__pod1.json"
    record = json.load(open(path)) if path.exists() else {"log": log}
    return plain, sharded, jlosses, record


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_plain_step(results, arch):
    for case, _, _ in CASES[arch]:
        (loss, grads, _, _), (s_loss, s_grads, _, _) = (
            results[0][arch, case], results[1][arch, case])
        assert abs(s_loss - loss) <= 1e-6, case
        assert set(s_grads) == set(grads)
        for path, g in grads.items():
            scale = max(float(g.abs().max()), 1e-30)
            assert float((s_grads[path] - g).abs().max()) <= 1e-5 * scale, (
                case, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_same_assignments_drop(results, arch):
    for case, edits, _ in CASES[arch]:
        keeps, s_keeps = results[0][arch, case][2], results[1][arch, case][2]
        # the forward's layers, then the backward's recompute of each
        assert len(keeps) == len(s_keeps) == 2 * _cfg(arch, edits).n_layers
        for keep, s_keep in zip(keeps, s_keeps):
            np.testing.assert_array_equal(s_keep, keep, err_msg=case)
        assert not all(k.all() for k in keeps), case  # some assignments drop


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_a_quarter_of_the_expert_buffers(results, arch):
    from repro_torch.models import moe
    for case, edits, B in CASES[arch]:
        cfg = _cfg(arch, edits)
        E, cap = cfg.moe_experts, moe.capacity(B * S, cfg)
        plain = results[0][arch, case][3]
        sharded = results[1][arch, case][3]
        assert {s[:2] for s in plain} == {(E, cap)}, case
        assert len(sharded) == len(plain), case
        # the buffer: the experts over "model" and the capacity over
        # "data", or with 3 experts (which "model" does not divide) the
        # capacity over both (every case's splits are even)
        split = (E // 2, cap // 2) if E % 2 == 0 else (E, cap // 4)
        assert {s[:2] for s in sharded[::5]} == {split}, (case, sharded)
        # each product and the output a quarter of the plain one (over
        # d_ff, DTensor keeps the FSDP weights' split of d_model in the
        # down product and gathers the capacity)
        for s, p in zip(sharded, plain):
            assert 4 * math.prod(s) == math.prod(p), (case, s, p)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_plain_loss_matches_jax(results, arch):
    for case, _, _ in CASES[arch]:
        loss, jloss = results[0][arch, case][0], results[2][arch, case]
        assert abs(loss - jloss) <= 1e-4 * abs(jloss), case


def test_reduced_train_cell_on_16x16_peaks_below_one_whole_buffer(results):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import SHAPES
    from repro_torch.models import moe
    rec = results[3]
    assert rec.get("status") == "ok", rec.get("error") or rec.get("log")
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    cfg = get_config("olmoe-1b-7b").reduced()
    S_, B_ = SHAPES["train_4k"]
    E, D = cfg.moe_experts, cfg.d_model
    whole = E * moe.capacity(B_ * S_, cfg) * D * 2          # bf16
    peak = rec["memory_analysis"]["temp_bytes"]
    assert 0 < peak < whole, (peak, whole,
                              rec["memory_analysis"]["peak_tensors"])
    # the dispatch's all-gathers bring every token to every rank in each
    # layer's forward: the all-gathers' results (not their operands, a
    # 256th of it) hold at least those rows
    rows = cfg.n_layers * B_ * S_ * D * 2
    gathered = rec["collective_result_breakdown"]["all-gather"]
    assert gathered >= rows, (gathered, rows, rec["collective_breakdown"])
