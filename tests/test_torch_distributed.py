"""The port's sharded engine against the JAX plans, bit for bit.

One gloo world of P ranks per world size (P = ``REPRO_TEST_DEVICES``,
default 6, and P = 3), each rank a process started by
``torch.multiprocessing`` with a file store (no network), runs every
program of ``PROGRAMS`` on its shard (``port_rank``); one JAX process per
world size, with ``--xla_force_host_platform_device_count=P``, runs the
same programs through the JAX plans on the same numpy inputs
(``jax_main``).  A program is one sharded job, or a few from the same
inputs; its inputs come from a seed and P, so every process makes the
same arrays, and rank r holds the slice ``r * N_LOCAL : (r + 1) *
N_LOCAL`` of each flat one, as ``shard_map`` over a 1-D mesh gives it.

Compared, raw bits, tolerance zero: the tree-reduced and gathered
candidate buffers (signed zeros, sentinels and int32 extremes placed
across ranks), the distributed reservoir pick, the all_reduce'd counts
and reduced bands, ``distributed_quantile`` in every method (for AFS and
Jeffers the answers only: their random streams differ),
``distributed_quantile_multi`` and ``distributed_quantile_grouped`` cold
and warm, fused and not, over f32/bf16/int32/f64, large-magnitude int32
and f64.  The port alone: its collective counts, a NaN on one rank and
unequal shards, each raising on every rank without a hang.

Every spawn and the JAX processes run under a time limit; a world that
does not finish in it is killed and the module fails.  The whole file
takes under a minute alone.
"""
import math
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist                              # noqa: E402

from _grid import (_np_dtype, exact_target_rank, make_case,   # noqa: E402
                   target_rank)
import repro_torch as T                                       # noqa: E402
from repro_torch.core import engine                           # noqa: E402
from repro_torch.core.select import as_device_tensor          # noqa: E402
from repro_torch.testing import run_world                     # noqa: E402

# ---------------------------------------------------------------------------
# the cases, numpy only: both sides make the same inputs from them
# ---------------------------------------------------------------------------

N_LOCAL = 240                   # elements a rank holds
EPS = 0.01
GROUP_EPS = 0.05
GROUP_QS = (0.5, 0.9)
MULTI_QS = (0.05, 0.5, 0.95)
Q_BUF, CAP_BUF = 3, 8           # the tree-reduced candidate buffers

QUANTILE_CASES = (("float32", "uniform", 0.001), ("float32", "ties", 0.5),
                  ("bfloat16", "zipf", 0.999), ("bfloat16", "signed_zeros", 0.3),
                  ("int32", "sorted", 0.5), ("int32", "all_equal", 0.75),
                  ("float64", "uniform", 0.999), ("float64", "ties", 0.001))
METHODS = ("faithful", "speculative", "fused", "all_gather", "approx",
           "full_sort", "afs", "jeffers")
WIDE_QS = (0.25, 0.75)
WIDE_METHODS = ("gk_select", "afs", "jeffers", "full_sort")
GROUP_SIZES = (1, 7, 64)
GROUPED_VARIANTS = ("cold", "cold_fused", "warm", "warm_fused")

# programs: (name, kind, dtype, extra)
PROGRAMS = (
    [(f"collect-{dt}", "collect", dt, None)
     for dt in ("float32", "bfloat16", "int32", "float64")]
    + [(f"quantile-{dt}-{dist}", "quantile", dt, (dist, q))
       for dt, dist, q in QUANTILE_CASES]
    + [(f"wide-{dt}", "wide", dt, None) for dt in ("int32", "float64")]
    + [(f"multi-{dt}", "multi", dt, None)
       for dt in ("float32", "bfloat16", "int32", "float64")]
    + [(f"grouped-G{G}", "grouped", "float32", G) for G in GROUP_SIZES]
    + [(f"grouped-{dt}-G7", "grouped", dt, 7)
       for dt in ("bfloat16", "int32", "float64")])
TORCH_ONLY = ("collective_counts", "nan_raises_on_every_rank",
              "unequal_shards_raise_on_every_rank")


def outputs(kind: str):
    """The names of a program's outputs."""
    return {"collect": ("tree_below", "tree_above", "gather", "counts",
                        "reduced_below", "reduced_above", "pmax"),
            "quantile": METHODS, "wide": WIDE_METHODS,
            "multi": ("cold", "cold_fused", "warm", "warm_fused"),
            "grouped": GROUPED_VARIANTS}[kind]


def _rng(name: str, P: int):
    return np.random.default_rng(zlib.crc32(f"{name}-{P}".encode()))


def _signed_zeros(dtype, n, rng):
    table = np.array([-0.0, 0.0, -1.0, 1.0, 2.0, 0.0, -0.0])
    return table[rng.integers(0, len(table), size=n)].astype(_np_dtype(dtype))


def _edge_table(dtype):
    """Values that test the merge's order: both zeros, ties, the dtype's
    sentinels and extremes."""
    if dtype == "int32":
        i = np.iinfo(np.int32)
        return np.array([i.min, i.max, i.min + 1, i.max - 1, 0, 0, 5, -5],
                        dtype=np.int64)
    return np.array([-0.0, 0.0, -np.inf, np.inf, 1.5, -1.5, 0.0, -0.0])


def _wide(dtype, n, rng):
    """Values of large magnitude: int32 beyond 2^24, float64 integers
    beyond 2^40, of both signs."""
    if dtype == "int32":
        x = rng.integers(2 ** 24, 2 ** 31 - 1, size=n, dtype=np.int64)
        x[: n // 2] = -x[: n // 2]
    else:
        x = rng.integers(2 ** 40, 2 ** 53, size=n,
                         dtype=np.int64).astype(np.float64)
        x[: n // 3] = -x[: n // 3]
    return rng.permutation(x).astype(_np_dtype(dtype))


def inputs(name: str, kind: str, dtype: str, extra, P: int) -> dict:
    """Every input array of a program for world size P (global arrays; a
    rank's part is its slice of each flat one, its row of each stacked)."""
    rng = _rng(name, P)
    n = P * N_LOCAL
    dt = _np_dtype(dtype)
    if kind == "collect":
        table = _edge_table(dtype)
        pick = table[rng.integers(0, len(table), size=(P, Q_BUF, CAP_BUF))]
        base = make_case("zipf", dtype, P * Q_BUF * CAP_BUF, seed=P)
        buf = np.where(rng.random((P, Q_BUF, CAP_BUF)) < 0.5, pick,
                       base.astype(np.float64).reshape(P, Q_BUF, CAP_BUF))
        x = make_case("zipf", dtype, n, seed=P)
        srt = np.sort(x.astype(np.float64))
        pivots = srt[[n // 10, n // 2, n - 2]]
        pri = rng.integers(0, 4, size=P).astype(np.float32)    # ties
        val = (make_case("uniform", dtype, P, seed=P + 1)
               if dtype in ("float32", "bfloat16")
               else _wide(dtype, P, rng))               # beyond 2^24
        return {"buf": buf.astype(dt), "x": x, "pivots": pivots.astype(dt),
                "pri": pri, "val": val}
    if kind == "quantile":
        dist, _ = extra
        x = (_signed_zeros(dtype, n, rng) if dist == "signed_zeros"
             else make_case(dist, dtype, n, seed=P))
        return {"x": x}
    if kind == "wide":
        return {"x": _wide(dtype, n, rng)}
    if kind == "multi":
        x = make_case("uniform", dtype, n, seed=P)
        srt = np.sort(x.astype(np.float64))
        ks = [target_rank(n, q) for q in MULTI_QS]
        warm = [srt[min(n - 1, max(0, k - 1 + d))]
                for k, d in zip(ks, (-3, 2, 5))]
        return {"x": x, "pivots": np.array(warm).astype(dt)}
    if kind == "grouped":
        G = extra
        x = make_case("zipf" if dtype == "int32" else "uniform", dtype, n,
                      seed=P)
        keys = rng.integers(-1, G + 1, size=n).astype(np.int32)
        if G > 1:
            keys[keys == 1] = G                      # group 1 is empty
        ks = np.ones((G, len(GROUP_QS)), np.int32)
        piv = np.zeros((G, len(GROUP_QS)))
        for g in range(G):
            mine = np.sort(x[keys == g].astype(np.float64))
            for j, q in enumerate(GROUP_QS):
                ks[g, j] = exact_target_rank(mine.size, q)
                if mine.size:
                    piv[g, j] = mine[min(mine.size - 1,
                                         max(0, ks[g, j] - 1 + j - 1))]
        return {"x": x, "keys": keys, "pivots": piv.astype(dt), "ks": ks}
    raise ValueError(kind)


# the cap of the warm jobs: wider than the warm pivots' rank error
WARM_CAP = {"multi": 9, "grouped": 12}


def tree_steps(P: int) -> int:
    """ppermutes one ``tree_reduce_candidates`` takes over P ranks."""
    if P <= 1:
        return 0
    p2 = 1 << (P.bit_length() - 1)
    return int(math.log2(p2)) + 2 * (P > p2)


def bits(a: np.ndarray) -> np.ndarray:
    """The raw bits of an array, as unsigned integers of its width."""
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])

# ---------------------------------------------------------------------------
# the port's side: one gloo rank (CPU tensors: every kernel call takes its
# plain version); imports torch and the port, never JAX
# ---------------------------------------------------------------------------


def _t(a):
    return as_device_tensor(np.asarray(a), "cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return bits(t.contiguous().view(view).numpy())


def _mine(a, rank):
    a = np.asarray(a)
    return _t(a[rank * N_LOCAL:(rank + 1) * N_LOCAL])


def port_collect(coll, inp, extra):
    r = coll.rank
    buf = _t(inp["buf"][r])
    tb = engine.tree_reduce_candidates(buf, coll, keep_largest=True)
    ta = engine.tree_reduce_candidates(buf, coll, keep_largest=False)
    g = engine.gather_candidates(buf, coll)
    x = _mine(inp["x"], r)
    counts, below, above = engine.phase_count_extract(
        x, _t(inp["pivots"]), 2 * CAP_BUF, coll=coll)
    rb, ra = engine.phase_reduce(below, above, coll=coll, strategy="tree")
    pm = engine._pmax_pair(_t(inp["pri"][r:r + 1])[0],
                           _t(inp["val"][r:r + 1])[0], coll)
    return tb, ta, g, counts, rb, ra, pm


def port_quantile(coll, inp, extra):
    q = extra[1]
    x = _mine(inp["x"], coll.rank)
    kw = dict(eps=EPS, device="cpu")
    runs = {"faithful": {}, "speculative": {"speculative": True},
            "fused": {"fused": True},
            "all_gather": {"reduce_strategy": "all_gather"},
            "approx": {"method": "approx"},
            "full_sort": {"method": "full_sort"}, "afs": {"method": "afs"},
            "jeffers": {"method": "jeffers"}}
    return [T.distributed_quantile(x, q, **runs[m], **kw) for m in METHODS]


def port_wide(coll, inp, extra):
    x = _mine(inp["x"], coll.rank)
    methods = {"gk_select": "gk_select", "afs": "afs", "jeffers": "jeffers",
               "full_sort": "full_sort"}
    return [torch.stack([T.distributed_quantile(x, q, method=methods[m],
                                                eps=EPS)
                         for q in WIDE_QS]) for m in WIDE_METHODS]


def port_multi(coll, inp, extra):
    x = _mine(inp["x"], coll.rank)
    warm = dict(pivots=inp["pivots"], cap=WARM_CAP["multi"])
    return [T.distributed_quantile_multi(x, MULTI_QS, eps=EPS, **kw)
            for kw in ({}, {"fused": True}, warm, {"fused": True, **warm})]


def port_grouped(coll, inp, G):
    v, k = _mine(inp["x"], coll.rank), _mine(inp["keys"], coll.rank)
    warm = dict(pivots=inp["pivots"], ks=inp["ks"],
                cap=WARM_CAP["grouped"])
    return [T.distributed_quantile_grouped(v, k, GROUP_QS, num_groups=G,
                                           eps=GROUP_EPS, **kw)
            for kw in ({}, {"fused": True}, warm, {"fused": True, **warm})]


def _counts(call) -> dict:
    engine.reset_collectives()
    call()
    return engine.collectives()


def collective_counts(coll):
    """Counters of one job of each plan: calls of each kind, payload bytes
    and host copies (none: the shards are CPU tensors)."""
    x = _mine(make_case("uniform", "float32", coll.size * N_LOCAL, 7),
              coll.rank)
    keys = (torch.arange(N_LOCAL, dtype=torch.int32) % 5)
    jobs = {"faithful": lambda: T.distributed_quantile(x, 0.5),
            "fused": lambda: T.distributed_quantile(x, 0.5, fused=True),
            "multi": lambda: T.distributed_quantile_multi(x, MULTI_QS),
            "grouped": lambda: T.distributed_quantile_grouped(
                x, keys, GROUP_QS, num_groups=5),
            "afs": lambda: T.distributed_quantile(x, 0.5, method="afs"),
            "jeffers": lambda: T.distributed_quantile(x, 0.5,
                                                      method="jeffers")}
    out = {}
    for name, job in jobs.items():
        for field, value in _counts(job).items():
            out[f"{name}/{field}"] = np.asarray(value)
    return out


def _raised(call) -> str:
    try:
        call()
    except ValueError as e:
        return str(e)
    return ""


def nan_raises(coll):
    """A NaN on rank 0 only: every rank raises, then the world still runs
    (a rank that raised alone would have left the others waiting)."""
    x = _mine(make_case("uniform", "float32", coll.size * N_LOCAL, 8),
              coll.rank)
    if coll.rank == 0:
        x[17] = float("nan")
    keys = torch.zeros(N_LOCAL, dtype=torch.int32)
    msgs = [_raised(lambda: T.distributed_quantile(x, 0.5, device="cpu")),
            _raised(lambda: T.distributed_quantile_multi(x, (0.5,))),
            _raised(lambda: T.distributed_quantile_grouped(
                x, keys, (0.5,), num_groups=1))]
    after = T.distributed_quantile(x, 0.5, check_nans=False, method="approx")
    return {"messages": np.array(msgs), "after": _bits(after.reshape(1))}


def unequal_raises(coll):
    """Rank P-1 holds one element fewer, then a rank with values and keys
    of different lengths: every rank raises both times."""
    n = N_LOCAL - (coll.rank == coll.size - 1)
    x = torch.arange(n, dtype=torch.float32)
    keys = torch.zeros(N_LOCAL - (coll.rank == 0), dtype=torch.int32)
    y = torch.arange(N_LOCAL, dtype=torch.float32)
    msgs = [_raised(lambda: T.distributed_quantile(x, 0.5)),
            _raised(lambda: T.distributed_quantile_multi(x, (0.5,))),
            _raised(lambda: T.distributed_quantile_grouped(
                y, keys, (0.5,), num_groups=1))]
    return {"messages": np.array(msgs)}


def port_rank(rank: int, P: int, store: str, out_dir: str) -> None:
    """One gloo rank: every program on its shard, then the port-only
    checks; writes ``out_dir/torch_P_rank.npz``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=P, rank=rank)
    try:
        coll = engine.Collectives()
        saved = {}
        for name, kind, dtype, extra in PROGRAMS:
            inp = inputs(name, kind, dtype, extra, P)
            out = {"collect": port_collect, "quantile": port_quantile,
                   "wide": port_wide, "multi": port_multi,
                   "grouped": port_grouped}[kind](coll, inp, extra)
            for field, value in zip(outputs(kind), out):
                saved[f"{name}/{field}"] = _bits(value)
        for name, check in zip(TORCH_ONLY, (collective_counts, nan_raises,
                                            unequal_raises)):
            for field, value in check(coll).items():
                saved[f"{name}/{field}"] = value
        np.savez(os.path.join(out_dir, f"torch_{P}_{rank}.npz"), **saved)
    finally:
        dist.destroy_process_group()

# ---------------------------------------------------------------------------
# the JAX side, run in a process of its own (JAX is imported there only)
# ---------------------------------------------------------------------------


def jax_main(out_dir: str, P: int) -> None:
    """The JAX side: every program through the JAX plans on a mesh of P
    CPU devices (the caller sets ``--xla_force_host_platform_device_count``),
    jitted under ``shard_map`` (the JAX entry points add only their checks,
    and without ``jit`` each call runs op by op, ~7 s a call here); each
    program's jobs share one compile.  Writes ``out_dir/jax_P.npz``."""
    import functools
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as PS
    from repro.core import engine, grouped
    from repro.kernels.ops import (make_fused_fn, make_fused_multi_fn,
                                   make_segmented_fn)
    AX = "data"

    def _run(mesh, body, args, per_rank: bool):
        """body over the mesh, jitted; outputs stacked by rank or replicated."""
        out = PS(AX) if per_rank else PS()
        fn = jax.jit(engine.shard_map_compat(body, mesh=mesh,
                                             in_specs=(PS(AX),) * len(args),
                                             out_specs=out))
        return jax.tree_util.tree_map(np.asarray, fn(*args))

    def in_turn(args, jobs):
        """Each job on ``args``, one after another: the next job's inputs
        pass an optimization barrier with the last job's outputs, so that
        one job's collectives are done before the next job's start.  (The
        host devices share one pool of worker threads; independent jobs'
        collectives blocking all of them at once would stall XLA until it
        aborts.)"""
        outs = []
        for job in jobs:
            out = job(*args)
            outs.append(out)
            args, _ = jax.lax.optimization_barrier((args, out))
        return outs


    def collect(mesh, P, inp, extra):
        cap = CAP_BUF

        kw = dict(axis=AX, num_shards=P)
        pivots = jnp.asarray(inp["pivots"])

        def tree(buf, largest):
            return engine.tree_reduce_candidates(buf, keep_largest=largest,
                                                 **kw)

        def body(buf, x, pri, val):
            tb, ta, g, (counts, below, above) = in_turn((buf[0], x), (
                lambda b, _: tree(b, True), lambda b, _: tree(b, False),
                lambda b, _: engine.gather_candidates(b, AX),
                lambda _, xs: engine.phase_count_extract(xs, pivots, 2 * cap,
                                                         axis=AX)))
            rb, ra = in_turn((below, above), (lambda b, _: tree(b, True),
                                              lambda _, a: tree(a, False)))
            pm = engine._pmax_pair(pri[0], val[0], AX)
            return tuple(t[None] for t in (tb, ta, g, counts, rb, ra, pm))

        args = (jnp.asarray(inp[name]) for name in ("buf", "x", "pri", "val"))
        return _run(mesh, body, tuple(args), per_rank=True)


    def quantile(mesh, P, inp, extra):
        q = extra[1]
        kw = dict(q=q, axis=AX, num_shards=P)
        plans = {
            "faithful": functools.partial(engine.gk_select_sharded, eps=EPS,
                                          **kw),
            "speculative": functools.partial(engine.gk_select_sharded, eps=EPS,
                                             speculative=True, **kw),
            "fused": functools.partial(engine.gk_select_sharded, eps=EPS,
                                       fused_fn=make_fused_fn(backend="jnp"), **kw),
            "all_gather": functools.partial(engine.gk_select_sharded, eps=EPS,
                                            reduce_strategy="all_gather", **kw),
            "approx": functools.partial(engine.approx_quantile_sharded, eps=EPS,
                                        **kw),
            "full_sort": functools.partial(engine.full_sort_sharded, **kw),
            "afs": functools.partial(engine.count_discard_sharded, **kw),
            "jeffers": functools.partial(engine.count_discard_sharded,
                                         collect_counts=True, **kw)}
        return _run(mesh, lambda x: tuple(in_turn((x,), [plans[m]
                                                         for m in METHODS])),
                    (jnp.asarray(inp["x"]),), per_rank=False)


    def wide(mesh, P, inp, extra):
        def plan(m, q):
            kw = dict(q=q, axis=AX, num_shards=P)
            if m == "gk_select":
                return functools.partial(engine.gk_select_sharded, eps=EPS,
                                         **kw)
            if m == "full_sort":
                return functools.partial(engine.full_sort_sharded, **kw)
            return functools.partial(engine.count_discard_sharded,
                                     collect_counts=m == "jeffers", **kw)

        def body(x):
            outs = in_turn((x,), [plan(m, q) for m in WIDE_METHODS
                                  for q in WIDE_QS])
            n = len(WIDE_QS)
            return tuple(jnp.stack(outs[i:i + n])
                         for i in range(0, len(outs), n))

        return _run(mesh, body, (jnp.asarray(inp["x"]),), per_rank=False)


    def multi(mesh, P, inp, extra):
        fused = make_fused_multi_fn(backend="jnp")
        warm = dict(pivots=jnp.asarray(inp["pivots"]), cap=WARM_CAP["multi"])
        kw = dict(qs=MULTI_QS, eps=EPS, axis=AX, num_shards=P)

        def body(x):
            job = engine.gk_select_multi_sharded
            return tuple(in_turn((x,), (
                lambda y: job(y, **kw), lambda y: job(y, fused_fn=fused, **kw),
                lambda y: job(y, **warm, **kw),
                lambda y: job(y, fused_fn=fused, **warm, **kw))))

        return _run(mesh, body, (jnp.asarray(inp["x"]),), per_rank=False)


    def grouped_(mesh, P, inp, G):
        seg = make_segmented_fn(backend="jnp")
        kw = dict(qs=GROUP_QS, num_groups=G, eps=GROUP_EPS, axis=AX,
                  num_shards=P)
        warm = dict(pivots=jnp.asarray(inp["pivots"]), ks=inp["ks"],
                    cap=WARM_CAP["grouped"])

        def body(v, k):
            job = grouped.gk_select_grouped_sharded
            return tuple(in_turn((v, k), (
                lambda a, b: job(a, b, **kw),
                lambda a, b: job(a, b, segmented_fn=seg, **kw),
                lambda a, b: job(a, b, **warm, **kw),
                lambda a, b: job(a, b, segmented_fn=seg, **warm, **kw))))

        return _run(mesh, body,
                    (jnp.asarray(inp["x"]), jnp.asarray(inp["keys"])),
                    per_rank=False)

    mesh = Mesh(np.array(jax.devices()[:P]), (AX,))
    run = {"collect": collect, "quantile": quantile, "wide": wide,
           "multi": multi, "grouped": grouped_}
    saved = {}
    for name, kind, dtype, extra in PROGRAMS:
        inp = inputs(name, kind, dtype, extra, P)
        with jax.enable_x64(dtype == "float64"):
            out = run[kind](mesh, P, inp, extra)
        for field, value in zip(outputs(kind), out):
            saved[f"{name}/{field}"] = bits(value)
    np.savez(os.path.join(out_dir, f"jax_{P}.npz"), **saved)

# ---------------------------------------------------------------------------
# the worlds, the JAX processes and the comparisons
# ---------------------------------------------------------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLDS = tuple(sorted({int(os.environ.get("REPRO_TEST_DEVICES", "6")), 3},
                      reverse=True))
TIME_LIMIT_S = 300
_JAX_CMD = ("import sys; sys.path.insert(0, {!r}); "
            "import test_torch_distributed as t; "
            "t.jax_main(sys.argv[1], int(sys.argv[2]))").format(HERE)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist"))
    deadline = time.monotonic() + TIME_LIMIT_S
    # one JAX process per world size, running while the gloo worlds do
    jax_procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_CMD, out, str(P)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                 JAX_PLATFORMS="cpu",
                 XLA_FLAGS=f"--xla_force_host_platform_device_count={P}"))
        for P in WORLDS]
    try:
        for P in WORLDS:
            run_world(port_rank, P, (os.path.join(out, f"store_{P}"), out),
                      deadline)
        for proc in jax_procs:
            _, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, err[-3000:]
    finally:
        for proc in jax_procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {P: {"jax": dict(np.load(os.path.join(out, f"jax_{P}.npz"))),
                "torch": [dict(np.load(os.path.join(out,
                                                    f"torch_{P}_{r}.npz")))
                          for r in range(P)]}
            for P in WORLDS}


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    if got.size == 1 == np.size(want):          # a 0-d answer
        return got.reshape(-1)[0] == np.reshape(want, -1)[0]
    return got.shape == np.shape(want) and np.array_equal(got, want)


@pytest.mark.parametrize("program", PROGRAMS, ids=[p[0] for p in PROGRAMS])
@pytest.mark.parametrize("P", WORLDS)
def test_program_matches_jax(results, P, program):
    name, kind, _, _ = program
    want_all, ranks = results[P]["jax"], results[P]["torch"]
    for field in outputs(kind):
        key = f"{name}/{field}"
        for r, got in enumerate(ranks):
            want = want_all[key][r] if kind == "collect" else want_all[key]
            assert _same(got[key], want), (key, r, got[key], want)


@pytest.mark.parametrize("P", WORLDS)
def test_collective_counts(results, P):
    """The gk_select plans take a constant number of collectives: two
    all_gathers (the sketch), the shard check and the counts (all_reduce),
    and one butterfly a side; AFS and Jeffers one count collective a round
    plus three all_reduces a pick.  CPU shards cross no host copy."""
    steps = tree_steps(P)
    want = {"faithful": (2, 2, steps), "fused": (2, 2, 2 * steps),
            "multi": (2, 2, 2 * steps), "grouped": (2, 3, 2 * steps)}
    for out in results[P]["torch"]:
        c = {k.split("/", 1)[1]: int(v) for k, v in out.items()
             if k.startswith("collective_counts/") and not k.endswith("_s")}
        for job, (gathers, reduces, perms) in want.items():
            got = tuple(c[f"{job}/{k}"] for k in ("all_gather", "all_reduce",
                                                  "ppermute"))
            assert got == (gathers, reduces, perms), (job, got)
            assert c[f"{job}/all_to_all"] == 0 and c[f"{job}/bytes"] > 0
            assert sum(got) <= 24
        assert c["afs/all_gather"] == c["afs/ppermute"] == 0
        assert (c["afs/all_reduce"] - 2) % 4 in (0, 1)   # rounds + picks
        assert c["jeffers/all_gather"] >= 1
        for job in (*want, "afs", "jeffers"):
            assert c[f"{job}/host_copies"] == c[f"{job}/host_copy_bytes"] == 0


@pytest.mark.parametrize("P", WORLDS)
def test_nan_raises_on_every_rank(results, P):
    afters = set()
    for out in results[P]["torch"]:
        msgs = out["nan_raises_on_every_rank/messages"]
        assert all("NaN" in m for m in msgs), msgs
        afters.add(out["nan_raises_on_every_rank/after"].tobytes())
    assert len(afters) == 1             # the world ran on, replicated


@pytest.mark.parametrize("P", WORLDS)
def test_unequal_shards_raise_on_every_rank(results, P):
    for r, out in enumerate(results[P]["torch"]):
        lengths, lengths_multi, keys = out[
            "unequal_shards_raise_on_every_rank/messages"]
        assert "shard lengths differ" in lengths, lengths
        assert "shard lengths differ" in lengths_multi, lengths_multi
        assert ("equal-length" if r == 0 else "another rank") in keys, keys
