"""Hard-episode miner: serving telemetry -> training replay manifest
(``tools/episode_miner.py`` of the JAX package).

The feedback half of the train->serve loop. The serving engine stamps each
episode's softmax top1-top2 margin and predictive entropy, and the client's
opaque tag, on every ``serve_dispatch`` event (host values, no extra device
read). A client that drew its episode from the dataset tags it
``"seed:<int>"``: the dataset makes episodes as pure functions of that seed,
so the tag is enough to replay the episode in training. This tool selects
the lowest-margin tagged episodes and writes a replay manifest that the
loader mixes in (``--replay_manifest`` / ``--replay_every``: every Nth
train episode slot draws a mined seed instead of the next fresh one, keyed
to the global slot, so resumes stay bit-exact).

Usage::

    python -m howtotrainyourmamlpytorch_tpu_torch.episode_miner \
        --telemetry <exp>/logs/telemetry.jsonl --out replay_manifest.json \
        [--max-margin 0.5] [--top 64] [--min-count 1] [--json]

Then train with::

    python -m howtotrainyourmamlpytorch_tpu_torch.train_maml_system \
        --name_of_args_json_file cfg.json \
        --replay_manifest replay_manifest.json --replay_every 8

Exit 0 with a manifest written; 3 when no episode cleared the gates (no
manifest is written: the loader refuses an empty one). Host Python only:
this module imports no torch.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from .telemetry.events import read_events

MANIFEST_SCHEMA = 1

#: Tag prefix that makes an episode replayable: the integer after it is
#: the dataset synthesis seed.
SEED_TAG_PREFIX = "seed:"


def family_bucket_stats(events) -> dict[tuple[str, str], dict]:
    """Folds ``serve_dispatch`` events into per-(learner family, bucket)
    traffic stats, for a stream that may mix MAML, ANIL and ProtoNets
    replicas and coarsened geometry traffic::

        {(family, bucket): {"dispatches": n, "episodes": n,
                            "coarsened": n, "min_margin": x}}

    ``bucket`` is the COARSENED ``"WxSxQ"`` string the dispatch actually
    rode (``serve/geometry.py``), ``coarsened`` counts episodes whose real
    geometry differed from it, and ``min_margin`` is the hardest episode
    seen. Events with no ``family`` field fold under ``"maml"``."""
    out: dict[tuple[str, str], dict] = {}
    for event in events:
        if event.get("type") != "serve_dispatch":
            continue
        family = str(event.get("family") or "maml")
        bucket = str(event.get("bucket") or "?")
        row = out.setdefault(
            (family, bucket),
            {"dispatches": 0, "episodes": 0, "coarsened": 0,
             "min_margin": None},
        )
        row["dispatches"] += 1
        row["episodes"] += int(event.get("episodes") or 0)
        row["coarsened"] += int(event.get("coarsened") or 0)
        margins = [
            float(m) for m in (event.get("margins") or [])
            if isinstance(m, (int, float)) and math.isfinite(m)
        ]
        if margins:
            low = min(margins)
            if row["min_margin"] is None or low < row["min_margin"]:
                row["min_margin"] = low
    return out


def mine_events(events) -> dict[int, dict]:
    """Folds ``serve_dispatch`` events into per-seed confidence stats:
    ``{seed: {"margin": min_margin, "entropy": max_entropy, "count": n}}``.
    Episodes without a parseable ``seed:<int>`` tag are skipped (no
    replayable identity); non-finite margins (a NaN-logits episode) are
    treated as margin 0.0 — maximally hard."""
    out: dict[int, dict] = {}
    for event in events:
        if event.get("type") != "serve_dispatch":
            continue
        tags = event.get("tags") or []
        margins = event.get("margins") or []
        entropies = event.get("entropies") or []
        for i, tag in enumerate(tags):
            if not isinstance(tag, str) or not tag.startswith(SEED_TAG_PREFIX):
                continue
            try:
                seed = int(tag[len(SEED_TAG_PREFIX):])
            except ValueError:
                continue
            margin = margins[i] if i < len(margins) else None
            entropy = entropies[i] if i < len(entropies) else None
            margin = (
                float(margin)
                if isinstance(margin, (int, float)) and math.isfinite(margin)
                else 0.0
            )
            entropy = (
                float(entropy)
                if isinstance(entropy, (int, float)) and math.isfinite(entropy)
                else None
            )
            row = out.setdefault(
                seed, {"margin": margin, "entropy": entropy, "count": 0}
            )
            row["count"] += 1
            row["margin"] = min(row["margin"], margin)
            if entropy is not None:
                row["entropy"] = max(row["entropy"] or 0.0, entropy)
    return out


def select_hard_episodes(
    stats: dict[int, dict],
    *,
    max_margin: float = 0.5,
    top: int = 64,
    min_count: int = 1,
) -> list[dict]:
    """Lowest-margin episodes first, filtered to ``margin <= max_margin``
    and at least ``min_count`` sightings, capped at ``top``."""
    rows = [
        {"seed": seed, **row}
        for seed, row in stats.items()
        if row["margin"] <= max_margin and row["count"] >= min_count
    ]
    rows.sort(key=lambda r: (r["margin"], r["seed"]))
    return rows[: max(int(top), 0)]


def write_manifest(
    path: str, episodes: list[dict], source: str, learner: str | None = None
) -> dict:
    """``learner`` (optional, schema-compatible) records which learner
    family's serving traffic mined these seeds — provenance for a human
    triaging a mixed-fleet replay set. The training loader reads only
    ``schema`` and ``episodes[].seed`` and ignores it by construction
    (``data/loader.load_replay_manifest``)."""
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "source": source,
        "episodes": episodes,
    }
    if learner is not None:
        manifest["learner"] = learner
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path)
    return manifest


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--telemetry", required=True,
                        help="telemetry JSONL with serve_dispatch events")
    parser.add_argument("--out", required=True,
                        help="replay manifest JSON to write")
    parser.add_argument("--max-margin", type=float, default=0.5,
                        help="only episodes at or below this softmax "
                        "top1-top2 margin are mined")
    parser.add_argument("--top", type=int, default=64,
                        help="manifest size cap (lowest margins first)")
    parser.add_argument("--min-count", type=int, default=1,
                        help="minimum sightings before an episode is mined")
    parser.add_argument("--json", action="store_true",
                        help="print the manifest summary as one JSON line")
    opts = parser.parse_args(argv)

    events = read_events(opts.telemetry)
    stats = mine_events(events)
    episodes = select_hard_episodes(
        stats, max_margin=opts.max_margin, top=opts.top,
        min_count=opts.min_count,
    )
    by_family = family_bucket_stats(events)
    families = sorted({family for family, _bucket in by_family})
    summary = {
        "tagged_episodes": len(stats),
        "mined": len(episodes),
        "out": opts.out if episodes else None,
        "min_margin": episodes[0]["margin"] if episodes else None,
        "families": {
            f"{family}/{bucket}": row
            for (family, bucket), row in sorted(by_family.items())
        },
    }
    if not episodes:
        # Nothing cleared the gates: write NO manifest and exit non-zero
        # — the loader refuses empty manifests, so a scripted
        # mine-then-train pipeline must branch here, not start a training
        # run that dies at loader construction.
        if opts.json:
            print(json.dumps(summary))
        else:
            print(
                f"no episodes at or below margin {opts.max_margin} "
                f"(of {len(stats)} tagged) — no manifest written",
                file=sys.stderr,
            )
        return 3
    write_manifest(
        opts.out, episodes, source=os.path.abspath(opts.telemetry),
        # Single-family telemetry stamps its provenance; a mixed-fleet
        # stream has no one owner, so the optional field is omitted.
        learner=families[0] if len(families) == 1 else None,
    )
    if opts.json:
        print(json.dumps(summary))
    else:
        print(
            f"mined {summary['mined']} hard episode(s) of "
            f"{summary['tagged_episodes']} tagged -> {opts.out}"
        )
        for (family, bucket), row in sorted(by_family.items()):
            coarse = (
                f", {row['coarsened']} coarsened" if row["coarsened"] else ""
            )
            print(
                f"  {family} @ {bucket}: {row['episodes']} episode(s) over "
                f"{row['dispatches']} dispatch(es){coarse}"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
