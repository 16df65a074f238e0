"""Step functions of the port: one training step (forward_loss -> backward
-> AdamW), one prefill and one decode step, and the dry-run shapes.

Counterpart of ``repro/launch/steps.py``.  The reference's ``mesh_cfg``,
``batch_abstract`` and ``input_specs`` describe GSPMD dry-run cells (XLA
shardings of abstract inputs); they have no single-card counterpart and
are not ported (``ROADMAP.md``).

Shapes (assignment):
  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> serve_prefill
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524,288 global_batch 1     -> serve_step, sub-quadratic
                                                 archs only (DESIGN.md §5)
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..models import model
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, adamw_update
from ..pytree import leaves, tree_map

SHAPES: Dict[str, Tuple[int, int]] = {
    "train_4k": (4096, 256),
    "prefill_32k": (32768, 32),
    "decode_32k": (32768, 128),
    "long_500k": (524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k needs sub-quadratic"
    return True, ""


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients in every parameter, then one
    AdamW update, written into the model's parameters and the state's
    moments.  ``opt_state`` mirrors ``model.param_tree(params)``; the
    metrics are the reference's (``loss``, ``ce``, ``aux``, ``tokens``,
    ``grad_norm`` and, where enabled, ``clip_threshold`` and
    ``compress_scale``), as tensors."""
    def train_step(params: model.Transformer, opt_state, batch):
        tree = model.param_tree(params)
        params.requires_grad_(True)
        loss, metrics = model.forward_loss(params, batch, cfg)
        loss.backward()
        grads = tree_map(lambda p: p.grad, tree)
        for p in leaves(tree):
            p.grad = None
        _, opt_state, opt_metrics = adamw_update(grads, opt_state, tree,
                                                 opt_cfg)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}
        return params, opt_state, out
    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, cfg, cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, token, cache, cache_len):
        return model.decode_step(params, token, cache, cache_len, cfg)
    return serve_step
