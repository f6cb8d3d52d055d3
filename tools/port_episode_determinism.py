#!/usr/bin/env python3
"""Are the training CLI's first episode, initial weights and first loss
the same from call to call on the same synthetic tree?

    python3 tools/port_episode_determinism.py [--tree DIR] [--out FILE]

Writes ``chip_smoke.write_omniglot_tree`` (seeded: 250 classes x 20 binary
PNGs) once, unless ``--tree`` names one, and a second copy of it beside,
then for the flagship JSON (the three fused flags) reports, twice in this
process and once in each of two child processes on the same tree, and once
on the copy:

* ``walk``: sha256 of the per-class image paths in the order the loader
  indexed them (``load_datapaths``: ``os.walk``'s order, unsorted, as in
  the JAX package), and whether each class's list is sorted;
* ``episode``: sha256 of the first train batch's bytes (support and target
  images and labels) from ``MetaLearningSystemDataLoader``;
* ``init``: sha256 of the learner's initial state from seed 104;
* ``first_loss``: the first second-order ``run_train_iter`` loss on that
  batch (on the card; ``--device cpu`` for a CPU rehearsal at 8 filters).

One JSON line per run and a summary line; the filesystem of the tree is
printed from ``/proc/mounts``. Compare the lines of two calls to see
whether, across machines, the order or something after it moved.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _sha(arrays) -> str:
    digest = hashlib.sha256()
    for a in arrays:
        digest.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return digest.hexdigest()[:16]


def _mount_of(path: str) -> str:
    path = os.path.realpath(path)
    best = ("", "?")
    try:
        with open("/proc/mounts") as f:
            for line in f:
                _, point, fstype, *_ = line.split()
                if path.startswith(point) and len(point) > len(best[0]):
                    best = (point, fstype)
    except OSError:
        pass
    return f"{best[0]} ({best[1]})"


def one_run(tree: str, device: str) -> dict:
    """The four fingerprints of one loader and learner on ``tree``."""
    import torch

    from chip_smoke import FLAGSHIP, FUSED_ARGV
    from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader
    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (
        args_to_maml_config,
        get_args,
    )
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    work = tempfile.mkdtemp(prefix="episode_determinism_")
    try:
        with open(FLAGSHIP) as f:
            cfg = json.load(f)
        cfg.update(dataset_name="omniglot_synth", dataset_path=os.path.basename(tree),
                   experiment_name=os.path.join(work, "exp"))
        if device == "cpu":
            cfg["cnn_num_filters"] = 8
        path = os.path.join(work, "cfg.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        os.environ["DATASET_DIR"] = os.path.dirname(tree)
        args, dev = get_args(["--name_of_args_json_file", path, *FUSED_ARGV,
                              "--device", device])
        loader = MetaLearningSystemDataLoader(args=args, current_iter=0)
        try:
            index, _, _ = loader.dataset.load_datapaths()
            paths = {cls: [os.path.relpath(str(p), tree) for p in v]
                     for cls, v in index.items()}
            order = [p for cls in sorted(paths) for p in paths[cls]]
            batch = next(iter(loader.get_train_batches(total_batches=1,
                                                       augment_images=True)))
        finally:
            loader.close()
        learner = MAMLFewShotLearner(args_to_maml_config(args))
        state = learner.init_state(torch.Generator().manual_seed(int(args.seed)), dev)
        init = _sha(a.detach().cpu().numpy() for a in tree_leaves(state))
        _, losses = learner.run_train_iter(state, tuple(batch[:4]), epoch=0)
        loss = float(losses["loss"])
        return {
            "walk": _sha([np.frombuffer("\n".join(order).encode(), np.uint8)]),
            "walk_sorted": all(
                paths[cls] == sorted(paths[cls]) for cls in paths
            ),
            "episode": _sha(batch[:4]), "init": init,
            "first_loss": loss, "first_loss_hex": float(loss).hex(),
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--out", default=None, help="also append the lines here")
    args = parser.parse_args(argv)
    if args.child:
        print(json.dumps(one_run(args.tree, args.device)))
        return 0
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("port_episode_determinism: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import write_omniglot_tree

    root = tempfile.mkdtemp(prefix="episode_tree_")
    try:
        tree = args.tree or os.path.join(root, "a", "omniglot_synth")
        if args.tree is None:
            write_omniglot_tree(tree)
        copy = os.path.join(root, "b", "omniglot_synth")
        shutil.copytree(tree, copy)
        runs = {"in_process_1": one_run(tree, args.device),
                "in_process_2": one_run(tree, args.device)}
        for i in (1, 2):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", "--tree", tree,
                 "--device", args.device],
                capture_output=True, text=True, check=True, timeout=600,
            ).stdout.strip().splitlines()[-1]
            runs[f"process_{i}"] = json.loads(out)
        runs["copy"] = one_run(copy, args.device)
        lines = [json.dumps({"run": name, **r}) for name, r in runs.items()]
        same = {key: len({r[key] for r in runs.values()}) == 1
                for key in ("walk", "episode", "init", "first_loss_hex")}
        device_name = (torch.cuda.get_device_name(0) if args.device != "cpu"
                       else "cpu")
        lines.append(json.dumps({"summary": same, "filesystem": _mount_of(tree),
                                 "device": device_name}))
        for line in lines:
            print(f"[episodes] {line}", flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write("\n".join(lines) + "\n")
        return 0
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
