"""Training loop of the port: data pipeline -> train step -> checkpoint
and restore, preemption handling, straggler monitoring, exact resume.

Counterpart of ``repro/launch/train.py``, for every model family.  A
checkpoint holds ``(params, AdamWState)`` in the JAX package's layout and
leaf order, so a run of either package resumes from the other's
checkpoint.

Usage:
  python -m repro_torch.launch.train --arch stablelm-1.6b --steps 50 \\
      --ckpt-dir ckpt                                          # the card
  python -m repro_torch.launch.train --arch stablelm-1.6b --reduced \\
      --device cpu --steps 3
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..configs import get_config
from ..core.select import require_device
from ..data import DataConfig, StreamStats, SyntheticPipeline
from ..distributed import PreemptionHandler, StragglerMonitor
from ..models import model
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, AdamWState, adamw_init
from .steps import make_train_step


def _state_tree(tree, opt_state: AdamWState, device):
    """``(params, opt_state)`` with the blocks stacked, as the JAX package
    checkpoints it, on ``device`` (``"meta"`` for a restore template)."""
    return (model.stacked(tree, device),
            AdamWState(opt_state.step.detach().to(device, copy=True),
                       model.stacked(opt_state.m, device),
                       model.stacked(opt_state.v, device)))


def train_loop(cfg: ModelConfig, *, steps: int, global_batch: int,
               seq_len: int, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 50, lr: float = 3e-4,
               quantile_clip: float = 0.999, seed: int = 0,
               preemption: Optional[PreemptionHandler] = None,
               log_every: int = 10, device="cuda") -> dict:
    """Train from ``init_params(cfg, seed)``, or from the newest checkpoint
    under ``ckpt_dir``, up to step ``steps``; checkpoint every
    ``ckpt_every`` steps, at the last step and when ``preemption`` asks to
    stop.  Returns the losses, the model, the optimizer state, the final
    step, the loss median and each step's seconds (``step_s``, ended by
    reading its loss)."""
    device = require_device(device)
    opt_cfg = AdamWConfig(lr=lr, quantile_clip=quantile_clip)
    params = model.init_params(cfg, seed, device=device)
    tree = model.param_tree(params)
    opt_state = adamw_init(tree)
    step_fn = make_train_step(cfg, opt_cfg)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                      global_batch=global_batch, seed=seed,
                      frontend_len=cfg.frontend_len,
                      enc_seq=(seq_len // cfg.enc_seq_divisor
                               if cfg.is_encdec else 0),
                      d_model=cfg.d_model)
    pipe = SyntheticPipeline(dcfg)
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        (p_st, o_st), extra = restore_checkpoint(
            ckpt_dir, _state_tree(tree, opt_state, "meta"), device=device)
        model.load_params(params, p_st)
        opt_state = AdamWState(o_st.step, model.unstacked(o_st.m),
                               model.unstacked(o_st.v))
        del p_st
        start = extra["data_step"]
        pipe.seek(start)
        print(f"resumed from step {start}")

    stats = StreamStats()
    monitor = StragglerMonitor(device=device)
    preemption = preemption or PreemptionHandler()
    losses, step_s = [], []
    step = start - 1
    t_last = time.time()
    for step in range(start, steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in pipe.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.time() - t_last
        t_last = time.time()
        step_s.append(dt)
        monitor.record({"host0": dt})
        stats.update([loss])
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"clip_thr {float(metrics.get('clip_threshold', 0)):.2e} "
                  f"{dt * 1000:.0f} ms")
        should_ckpt = ckpt_dir and (
            (step + 1) % ckpt_every == 0 or preemption.should_stop
            or step + 1 == steps)
        if should_ckpt:
            save_checkpoint(ckpt_dir, step + 1,
                            _state_tree(tree, opt_state, "cpu"),
                            extra={"data_step": step + 1,
                                   "loss_p50": stats.quantile(0.5)})
        if preemption.should_stop:
            print(f"preempted at step {step}; checkpointed")
            break
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "final_step": step + 1, "loss_p50": stats.quantile(0.5),
            "step_s": step_s}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = train_loop(cfg, steps=args.steps, global_batch=args.global_batch,
                     seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                     lr=args.lr, device=args.device)
    print(f"done: {out['final_step']} steps, "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")


if __name__ == "__main__":
    main()
