"""The port's step analyzer (``repro_torch.launch.step_analysis``) and its
collective parsers (``launch.roofline``): exact matmul FLOPs, a loop's
FLOPs counted every iteration, dtype bytes, FLOPs on a DTensor's local
shards, and collective bytes equal to what the reference's HLO parser
(``repro.launch.roofline.parse_collective_bytes``) reads from the same
collectives written as typed HLO text.  Collectives run on a fake world of
16 ranks (``launch.mesh.fake_world``), started for this module and torn
down after it."""
import pytest

torch = pytest.importorskip("torch")

from repro.launch import roofline as jroof                    # noqa: E402
from repro_torch.launch import roofline                       # noqa: E402
from repro_torch.launch.step_analysis import analyze          # noqa: E402


@pytest.fixture(scope="module")
def world16():
    import torch.distributed as dist
    from repro_torch.launch.mesh import fake_world, make_mesh
    fake_world(16)
    yield make_mesh((16,), ("model",), device="cpu")
    dist.destroy_process_group()


def test_matmul_flops_are_exact():
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    r = analyze(lambda: a @ b)
    assert r["flops"] == 2 * 256 ** 3
    assert torch.equal(r["out"], a @ b)
    assert r["collective_total_bytes"] == 0


def test_a_loop_counts_every_iteration():
    # the reference's test_scan_trip_count_multiplication shape: 7 layers
    # of (4, 64) @ (64, 64), which its HLO parser multiplies by the trip
    # count; eager execution runs (and counts) each one
    w = torch.randn(7, 64, 64)

    def step(x):
        for i in range(7):
            x = torch.tanh(x @ w[i])
        return x
    r = analyze(step, torch.randn(4, 64))
    assert r["flops"] == 7 * 2 * 4 * 64 * 64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64, torch.int32])
def test_traffic_counts_dtype_bytes(dtype):
    x = torch.ones(1000, dtype=dtype)
    y = torch.ones(1000, dtype=dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    r = analyze(lambda: x + y)
    assert r["traffic_bytes"] == 3 * 1000 * itemsize   # 2 reads, 1 write
    # a view moves nothing
    assert analyze(lambda: x.view(10, 100).t())["traffic_bytes"] == 0


def test_dtensor_flops_count_the_local_shards(world16):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = world16
    with FakeTensorMode():
        # (4096, 4096) @ (4096, 1024) with the rows split 16 ways: each
        # rank multiplies its (256, 4096) rows
        a = DTensor.from_local(torch.empty(256, 4096), mesh, [Shard(0)],
                               run_check=False)
        b = DTensor.from_local(torch.empty(4096, 1024), mesh, [Replicate()],
                               run_check=False)
        r = analyze(lambda: a @ b)
        assert r["flops"] == 2 * 256 * 4096 * 1024
        # the same product with the contraction split: a partial sum on
        # each rank, no collective until it is read whole
        a = DTensor.from_local(torch.empty(4096, 256), mesh, [Shard(1)],
                               run_check=False)
        b = DTensor.from_local(torch.empty(256, 1024), mesh, [Shard(0)],
                               run_check=False)
        r = analyze(lambda: (a @ b).full_tensor())
        assert r["flops"] == 2 * 4096 * 256 * 1024
        assert r["collective_counts"]["all-reduce"] == 1
        assert r["collective_bytes"]["all-reduce"] == 4096 * 1024 * 4


def _hlo(result: str, op: str, operand: str) -> str:
    return (f"  %x = {result} {op}({operand} %p), "
            f"replica_groups=[1,16]<=[16], dimensions={{0}}")


def test_collective_bytes_equal_the_reference_parser(world16):
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    group = world16.get_group(0)
    with FakeTensorMode():
        x = torch.empty(64, 4096, dtype=torch.bfloat16)
        r = analyze(lambda: [funcol.wait_tensor(t) for t in (
            funcol.all_gather_tensor(x, 0, group),
            funcol.reduce_scatter_tensor(x, "sum", 0, group),
            funcol.all_reduce(x, "sum", group),
            funcol.all_to_all_single(x, None, None, group))])
    got = roofline.parse_collective_bytes(r)
    hlo = "\n".join([
        _hlo("bf16[1024,4096]{1,0}", "all-gather", "bf16[64,4096]{1,0}"),
        _hlo("bf16[4,4096]{1,0}", "reduce-scatter", "bf16[64,4096]{1,0}"),
        _hlo("bf16[64,4096]{1,0}", "all-reduce", "bf16[64,4096]{1,0}"),
        _hlo("bf16[64,4096]{1,0}", "all-to-all", "bf16[64,4096]{1,0}")])
    want = jroof.parse_collective_bytes(hlo)
    assert got == want
    assert got["all-gather"] == 64 * 4096 * 2          # the operand's bytes
    assert got["reduce-scatter"] == 64 * 4096 * 2
    assert got["count"] == {"all-gather": 1, "all-reduce": 1,
                            "reduce-scatter": 1, "all-to-all": 1,
                            "collective-permute": 0}


def test_count_collective_phases(world16):
    import torch.distributed._functional_collectives as funcol
    group = world16.get_group(0)
    x = torch.ones(8)

    def step():
        for _ in range(3):
            funcol.wait_tensor(funcol.all_reduce(x, "sum", group))
        return funcol.wait_tensor(funcol.all_gather_tensor(x, 0, group))
    r = analyze(step)
    assert roofline.count_collective_phases(r) == 4
    hlo = "\n".join([_hlo("f32[8]{0}", "all-reduce", "f32[8]{0}")] * 3
                    + [_hlo("f32[128]{0}", "all-gather", "f32[8]{0}")])
    assert jroof.count_collective_phases(hlo) == 4
    assert roofline.parse_collective_bytes(r) == \
        jroof.parse_collective_bytes(hlo)
