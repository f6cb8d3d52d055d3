#!/usr/bin/env python3
"""Do served episodes give the same logits run to run on the card?

    python3 tools/port_serve_determinism.py

Serves the same 32 flagship episodes (MAML++ Omniglot config, random
weights from a seed, meta-batch 4, binary images) three times on fresh
engines, for the fused-kernel engine and the plain-norm engine, once with
cuDNN's default algorithm choice and once with
``torch.backends.cudnn.deterministic`` (which the serving engine sets; the
first pass turns it off again after the engines are built). Prints, per
setting, the largest logit difference between runs of each engine and
between the two engines. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import FLAGSHIP, make_episodes  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.serve import (  # noqa: E402
    ServeConfig,
    ServingEngine,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (  # noqa: E402
    load_maml_config,
)

RUNS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("port_serve_determinism: no CUDA device", file=sys.stderr)
        return 1
    cfg = load_maml_config(FLAGSHIP, use_pallas_fused_norm=True)
    plain_cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, use_pallas_fused_norm=False)
    )
    learners = {
        "fused": MAMLFewShotLearner(cfg),
        "plain": MAMLFewShotLearner(plain_cfg),
    }
    istate = learners["fused"].init_inference_state(
        torch.Generator().manual_seed(104)
    )
    episodes = make_episodes(np.random.RandomState(0), 32)
    print(f"device: {torch.cuda.get_device_name(0)}")
    for deterministic in (False, True):
        logits = {}
        for name, learner in learners.items():
            runs = []
            for _ in range(RUNS):
                engine = ServingEngine(learner, istate, ServeConfig(meta_batch_size=4))
                torch.backends.cudnn.deterministic = deterministic
                eps = [engine.prepare_episode(*e) for e in episodes]
                runs.append(np.stack(engine.dispatch(eps)))
            logits[name] = runs
            spread = max(float(np.abs(r - runs[0]).max()) for r in runs[1:])
            print(f"cudnn.deterministic={deterministic} {name}: largest logit "
                  f"difference between {RUNS} runs {spread:.4g}")
        gap = np.abs(logits["fused"][0] - logits["plain"][0])
        per_episode = gap.reshape(len(episodes), -1).max(axis=1)
        print(f"cudnn.deterministic={deterministic} fused against plain: "
              f"largest {per_episode.max():.4g}, median episode "
              f"{np.median(per_episode):.4g}, episodes over 1e-4 "
              f"{int((per_episode > 1e-4).sum())}/{len(episodes)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
