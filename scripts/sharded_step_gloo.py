#!/usr/bin/env python3
"""Hold the sharded train step, prefill and decode step to the plain ones
on a gloo world of 4 CPU ranks (a 2 x 2 ("data", "model") mesh), at a
batch that "data" divides (4) and at one it does not (3), without JAX.

    python3 scripts/sharded_step_gloo.py

``tests/test_torch_sharded_step.py`` runs the same steps from JAX's
weights; this script takes the port's own (``model.init_params``, seed 0,
f32 reduced granite-8b) so that it runs where JAX is not installed, and
holds them to that test's tolerances: loss 1e-6, each gradient 1e-5 of
its max |g|, logits 1e-5 of max |logit|, the clip threshold a sort of the
sharded step's own |g|.  It prints one JSON line a batch with the gaps and
the torch version, and fails if a step fails or misses a tolerance.
"""
from __future__ import annotations

import json
import os
import pickle
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), os.path.join(HERE, "tests")]

import torch                                                   # noqa: E402

import test_torch_sharded_step as t                            # noqa: E402
from repro_torch.models import model                           # noqa: E402
from repro_torch.testing import run_world                      # noqa: E402


def _gaps(plain, sharded) -> dict:
    (loss, grads, _, logits, dlogits) = plain
    (s_loss, s_grads, _, s_logits, s_dlogits) = sharded
    return {
        "loss_gap": abs(s_loss - loss),
        "grad_gap_share_max": max(
            float((s_grads[p] - g).abs().max())
            / max(float(g.abs().max()), 1e-30) for p, g in grads.items()),
        "prefill_logits_gap_share": float((s_logits - logits).abs().max()
                                          / logits.abs().max()),
        "decode_logits_gap_share": float((s_dlogits - dlogits).abs().max()
                                         / dlogits.abs().max())}


def main() -> int:
    cfg = t._cfg()
    tree = model.params_to_numpy(model.init_params(cfg, 0, device="cpu"))
    with tempfile.TemporaryDirectory() as d:
        weights, out = os.path.join(d, "weights.pkl"), os.path.join(d, "out")
        with open(weights, "wb") as f:
            pickle.dump(tree, f)
        t0 = time.perf_counter()
        run_world(t.rank_main, 4, (os.path.join(d, "store"), weights, out),
                  time.monotonic() + t.TIME_LIMIT_S)
        world_s = time.perf_counter() - t0
        with open(out, "rb") as f:
            sharded = pickle.load(f)
    params = model.params_from_numpy(cfg, tree, device="cpu")
    for b in (t.B, t.B_UNEVEN):
        plain = t._steps(params, cfg, t._batch(cfg, b), None)
        print(json.dumps({"torch": torch.__version__, "batch": b,
                          "world_s": world_s, **_gaps(plain, sharded[b])}),
              flush=True)
        t._check_loss_and_gradients(plain, sharded[b])
        t._check_clip_threshold(plain, sharded[b])
        t._check_logits(plain, sharded[b], b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
