"""Package rules of the PyTorch port.

- ``repro_torch`` imports neither JAX nor the JAX package ``repro``: checked
  in a fresh interpreter and over every import statement in its sources.
- Entry points that build tensors from host data run on the card unless the
  caller asks for the CPU: without CUDA they raise.
- No silent fallback: a kernel wrapper refuses a CPU tensor, a missing nvcc
  raises, and ``chip_smoke.py`` exits non-zero without CUDA or outside a
  checkout.
"""
import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch                                            # noqa: E402
from repro_torch.kernels import cuda_build                    # noqa: E402
from repro_torch.kernels import fused_select as fs            # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.update(extra)
    return env


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.core.select, "
            "repro_torch.core.baselines, repro_torch.core.grouped, "
            "repro_torch.core.engine, repro_torch.core.distributed, "
            "repro_torch.kernels.dispatch, "
            "repro_torch.kernels.ops, repro_torch.kernels.fused_select, "
            "repro_torch.kernels.partition_count, "
            "repro_torch.kernels.band_count, "
            "repro_torch.kernels.segmented_select, repro_torch.testing, "
            "repro_torch.launch.quantile_service, "
            "repro_torch.launch.ingest_pool, repro_torch.launch.serve, "
            "repro_torch.models.config, repro_torch.models.layers, "
            "repro_torch.models.model, repro_torch.configs, "
            "repro_torch.optim.quantile_ops, "
            "repro_torch.checkpoint.checkpoint\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_imports_jax_or_repro():
    found = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                found += [(path, n) for n in names
                          if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not found


def test_layout_mirrors_the_jax_package():
    for rel in ("core/local_ops.py", "core/sketch.py", "core/select.py",
                "core/baselines.py", "core/engine.py", "core/grouped.py",
                "core/distributed.py", "launch/quantile_service.py",
                "launch/ingest_pool.py", "launch/serve.py",
                "models/config.py", "models/layers.py", "models/model.py",
                "configs/__init__.py", "optim/quantile_ops.py",
                "checkpoint/checkpoint.py",
                "kernels/ref.py", "kernels/ops.py", "kernels/dispatch.py",
                "kernels/fused_select.py", "kernels/partition_count.py",
                "kernels/band_count.py", "kernels/segmented_select.py",
                "kernels/csrc/fused_select.cu",
                "kernels/csrc/partition_count.cu",
                "kernels/csrc/band_count.cu", "kernels/csrc/byte_histogram.cu",
                "kernels/csrc/segmented_select.cu"):
        assert os.path.exists(os.path.join(PKG, rel)), rel
    for name in repro_torch.__all__:
        assert hasattr(repro_torch, name), name
    for module in (repro_torch.core, repro_torch.launch,
                   repro_torch.checkpoint, repro_torch.optim,
                   repro_torch.models, repro_torch.configs):
        for name in module.__all__:
            assert hasattr(module, name), name
    # one module a published config, as in the JAX package
    from repro_torch.configs import ARCH_IDS
    for arch in ARCH_IDS:
        rel = os.path.join("configs", arch.replace("-", "_").replace(".", "_")
                           + ".py")
        assert os.path.exists(os.path.join(PKG, rel)), rel
    assert set(repro_torch.optim.__all__) == {
        "pytree_exact_quantile", "pytree_radix_quantile",
        "channelwise_exact_quantile", "quantile_clip_by_value"}
    assert {"IngestPool", "StreamingCalibrator", "calibrate_int8_scale",
            "calibrate_int8_scales", "generate"} <= set(
                repro_torch.launch.__all__)


def test_host_data_goes_to_cuda_unless_cpu_is_asked(monkeypatch):
    x = np.arange(16, dtype=np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = (np.arange(16) % 3).astype(np.int32).reshape(2, 8)
    for call in (lambda **kw: repro_torch.exact_quantile(x, 0.5, **kw),
                 lambda **kw: repro_torch.exact_quantile_rank(x, 3, **kw),
                 lambda **kw: repro_torch.gk_select_grouped(
                     x.reshape(2, 8), keys, (0.5,), num_groups=3, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        assert call(device="cpu").device.type == "cpu"
    assert float(repro_torch.exact_quantile(x, 0.5, device="cpu")) == 7.0
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.QuantileService()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    # "cuda" means the current card, as the tensors there report it
    assert repro_torch.QuantileService().device == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = repro_torch.QuantileService(device="cpu")
    svc.ingest("s", x)
    assert svc.exact("s", 0.5).device.type == "cpu"
    assert float(svc.exact("s", 0.5)) == 7.0


def test_serving_entry_points_go_to_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.core import sketch
    from repro_torch.launch import serve
    from repro_torch.models import model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.abs(np.arange(-8, 16, dtype=np.float32)).reshape(4, 6)
    cfg = get_config("granite-8b").reduced()
    tree = {name: np.zeros(w.shape, np.float32) for name, w in
            model.init_params(cfg, 0, device="cpu").p.items()}
    calls = (
        lambda **kw: serve.calibrate_int8_scale(x, 0.5, **kw),
        lambda **kw: serve.calibrate_int8_scales(x, 0, 0.5, **kw),
        lambda **kw: repro_torch.StreamingCalibrator(**kw),
        lambda **kw: model.init_params(cfg, 0, **kw),
        lambda **kw: model.Transformer(cfg, **kw),
        lambda **kw: model.init_cache(cfg, 1, 4, **kw),
        lambda **kw: model.params_from_numpy(cfg, tree, **kw),
        lambda **kw: sketch.sketch_init(8, **kw),
        lambda **kw: sketch.sketch_init_stack(2, 8, **kw))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert float(calls[0](device="cpu")) == 6.0
    assert calls[1](device="cpu").tolist() == [5.0, 1.0, 6.0, 12.0]
    assert calls[2](device="cpu").service.device.type == "cpu"
    assert calls[3](device="cpu").device.type == "cpu"
    assert calls[5](device="cpu")["k"].device.type == "cpu"
    assert calls[7](device="cpu").values.device.type == "cpu"
    assert calls[8](device="cpu").values.shape == (2, 8)


def test_tensor_entry_points_run_where_the_tensor_lives():
    parts = torch.arange(24, dtype=torch.float32).reshape(3, 8)
    for out in (repro_torch.gk_select(parts, 0.5, block_select=True),
                repro_torch.gk_select_multi(parts, (0.25, 0.75)),
                repro_torch.full_sort_quantile(parts, 0.5),
                repro_torch.approx_quantile(parts, 0.5)):
        assert out.device.type == "cpu" and out.dtype == torch.float32
    assert float(repro_torch.gk_select(parts, 0.5)) == 11.0


def test_kernel_wrappers_take_cuda_tensors_only():
    from repro_torch.kernels import band_count as bc
    from repro_torch.kernels import partition_count as pc
    from repro_torch.kernels import segmented_select as ss
    x = torch.zeros(2, 16)
    keys = torch.zeros(2, 16, dtype=torch.int32)
    for fn, args in ((fs.fused_select, (x, torch.tensor(0.0), 4)),
                     (fs.fused_select_multi, (x, torch.zeros(3), 4)),
                     (fs.byte_histogram, (x, 0, 0, 24)),
                     (fs.radix_walk, (x, 1)),
                     (pc.partition_count, (x, 0.0)), (pc.bisect, (x, 1)),
                     (bc.band_count, (x, 0.0, 1.0)),
                     (ss.segmented_select, (x, keys, torch.zeros(1, 1), 4))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.nvcc()


def test_chip_smoke_refuses_without_cuda(tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(script, alone)
    bare = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    bare["CUDA_VISIBLE_DEVICES"] = ""
    for path, cwd in ((script, REPO), (str(alone), str(tmp_path))):
        proc = subprocess.run([sys.executable, path], env=bare, cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
