"""A sharded step held to the plain one: reduced granite-8b (f32 weights
from JAX's ``init_params``, carried over by ``params_from_numpy``) runs
its train step, prefill and one decode step on a gloo world of 4 ranks, a
2 x 2 ("data", "model") mesh, with ``sharding.distribute_params`` and the
batch and cache placed by the reference's rules; the same steps run plain
in this process.  Two batches, in the same world: B = 4, which "data"
divides, and B = 3, which it does not (the batch and the caches then split
their sequence over "data", as the reference's rule does).

Tolerances, ``test_torch_train.py``'s f32 ones: the loss within 1e-6, each
gradient within 1e-5 of its leaf's max |g|, the logits within 1e-5 of
max |logit|.  The sharded step's clip threshold (``quantile_clip=0.999``,
counted on each rank's shards and summed over the mesh) must equal a sort
of its own gradients' |g|, gathered whole."""
import dataclasses
import pickle
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing import run_world                     # noqa: E402

B, S, NEW = 4, 64, 1
B_UNEVEN = 3              # a batch that the "data" axis of 2 does not divide
TIME_LIMIT_S = 240


def _cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("granite-8b").reduced(),
                               param_dtype="float32")


def _batch(cfg, b=B, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, S), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}


def _steps(params, cfg, batch, mesh):
    """(loss, {path: grad}, clip threshold, prefill logits, decode logits)
    of one train step, a prefill and one decode step, plain (``mesh`` None)
    or on ``mesh``; tensors come back whole, on the host."""
    from repro_torch.dtensor import is_dtensor
    from repro_torch.launch import sharding as shd, steps
    from repro_torch.models import layers, model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.pytree import leaves, paths

    def whole(t):
        return (t.full_tensor() if is_dtensor(t) else t).detach()

    B = batch["tokens"].shape[0]
    prompt = {"tokens": batch["tokens"]}
    if mesh is not None:
        batch, prompt = (steps.distribute_inputs(
            (b,), (shd.placements_tree(mesh, shd.batch_spec(mesh, b, B)),),
            mesh)[0] for b in (batch, prompt))
    tree = model.param_tree(params)
    params.requires_grad_(True)
    with steps.on_mesh(mesh):
        loss, _ = model.forward_loss(params, batch, cfg)
        loss.backward()
        grads = {p: whole(steps.placed_grad(t)) for p, t in
                 zip(paths(tree), leaves(tree))}
    for t in leaves(tree):
        t.grad = None
    params.requires_grad_(False)
    # the train step itself: AdamW with the exact-quantile clip
    opt_cfg = AdamWConfig(quantile_clip=0.999)
    opt = adamw_init(tree)
    if mesh is not None:
        opt = steps.distribute_inputs(
            (opt,), (shd.placements_tree(mesh, shd.opt_shardings(mesh, opt,
                                                           tree)),), mesh)[0]
    snapshot = {p: whole(t).clone() for p, t in zip(paths(tree),
                                                    leaves(tree))}
    _, _, metrics = steps.make_train_step(cfg, opt_cfg, mesh)(params, opt,
                                                              batch)
    # back to the weights before the update, for the serving steps
    with torch.no_grad():
        for p, t in zip(paths(tree), leaves(tree)):
            w = snapshot[p]
            if is_dtensor(t):
                from torch.distributed.tensor import distribute_tensor
                w = distribute_tensor(w, t.device_mesh, t.placements)
            t.copy_(w)
    logits, cache = steps.make_prefill_step(cfg, S + NEW, mesh)(params,
                                                               prompt)
    token = torch.argmax(whole(logits), -1).to(torch.int32)[:, None]
    clen = torch.full((B,), S, dtype=torch.int32)
    if mesh is not None:
        place = shd.placements_tree(mesh, shd.cache_shardings(
            mesh, cache, cfg, B, decode=True))
        cache = steps.redistribute_tree(cache, place, mesh)
        b = layers._batch_entry(B, cfg)
        token, clen = steps.distribute_inputs(
            (token, clen), (shd.placements((b, None), mesh),
                            shd.placements((b,), mesh)), mesh)
    dlogits, _ = steps.make_decode_step(cfg, mesh)(params, token, cache,
                                                   clen)
    return (whole(loss).item(), grads, whole(metrics["clip_threshold"]),
            whole(logits), whole(dlogits))


def rank_main(rank, world, store, weights, out):
    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import mesh_cfg
    from repro_torch.models import model
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        cfg = mesh_cfg(_cfg(), mesh, B)
        with open(weights, "rb") as f:
            params = model.params_from_numpy(cfg, pickle.load(f),
                                              device="cpu")
        shd.distribute_params(params, mesh)
        # the steps restore the weights they update: both batches start
        # from the same ones
        res = {b: _steps(params, cfg, _batch(cfg, b), mesh)
               for b in (B, B_UNEVEN)}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget
    from repro.models import model as jmodel
    from repro_torch.models import model
    d = tmp_path_factory.mktemp("sharded_step")
    jcfg = dataclasses.replace(jget("granite-8b").reduced(),
                               param_dtype="float32")
    tree = jax.tree.map(np.asarray,
                        jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    weights, out = str(d / "weights.pkl"), str(d / "rank0.pkl")
    with open(weights, "wb") as f:
        pickle.dump(tree, f)
    run_world(rank_main, 4, (str(d / "store"), weights, out),
              time.monotonic() + TIME_LIMIT_S)
    with open(out, "rb") as f:
        sharded = pickle.load(f)
    cfg = _cfg()
    params = model.params_from_numpy(cfg, tree, device="cpu")
    return {b: (_steps(params, cfg, _batch(cfg, b), None), sharded[b])
            for b in (B, B_UNEVEN)}


def _check_loss_and_gradients(plain, sharded):
    (loss, grads, _, _, _), (s_loss, s_grads, _, _, _) = plain, sharded
    assert abs(s_loss - loss) <= 1e-6
    assert set(s_grads) == set(grads)
    for path, g in grads.items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((s_grads[path] - g).abs().max()) <= 1e-5 * scale, path


def _check_clip_threshold(plain, sharded):
    from repro_torch.core import local_ops
    _, s_grads, s_thr, _, _ = sharded
    g = torch.cat([t.reshape(-1).abs().float() for t in s_grads.values()])
    k = local_ops.target_rank(g.numel(), 0.999)
    assert float(s_thr) == float(torch.sort(g).values[k - 1])
    assert float(plain[2]) == float(torch.sort(torch.cat(
        [t.reshape(-1).abs().float() for t in plain[1].values()])).values[
            k - 1])


def _check_logits(plain, sharded, b):
    for got, want in ((sharded[3], plain[3]), (sharded[4], plain[4])):
        assert got.shape == want.shape == (b, _cfg().vocab)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_loss_and_gradients_match_the_plain_step(results):
    _check_loss_and_gradients(*results[B])


def test_clip_threshold_is_the_sort_of_the_sharded_gradients(results):
    _check_clip_threshold(*results[B])


def test_prefill_and_decode_logits_match_the_plain_steps(results):
    _check_logits(*results[B], B)


def test_uneven_batch_loss_and_gradients_match_the_plain_step(results):
    """B = 3 on "data" = 2: the step splits the sequence there."""
    _check_loss_and_gradients(*results[B_UNEVEN])


def test_uneven_batch_clip_threshold_is_the_sort_of_its_gradients(results):
    _check_clip_threshold(*results[B_UNEVEN])


def test_uneven_batch_prefill_and_decode_logits_match_the_plain_steps(
        results):
    _check_logits(*results[B_UNEVEN], B_UNEVEN)
