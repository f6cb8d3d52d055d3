#!/usr/bin/env python3
"""A torch.profiler trace of one replay of each captured train-step graph,
held against the graph's kernel nodes, over a whole ``chip_smoke.py`` run.

    python3 tools/port_replay_trace.py [--out DIR]

Runs ``chip_smoke.main()`` (every phase, in this process) with each
``check_replay`` also tracing one replay of its graph. For each graph it
prints the kernel nodes the driver holds and the kernel events the trace
holds, in all and per fused-norm kernel; the device streams the replay's
events ran on (a graph runs independent branches concurrently); and each
kernel name the trace holds another number of times than the graph
(node names demangled with ``c++filt`` where it is on the path).
It also counts the fused-norm launches made while a capture was live
since the last graph's line, on the capturing stream or another. ``chip_smoke.py`` counts
the nodes, not the trace; this script shows how far the two agree. Lines
go to standard output and to ``DIR/replay_trace.txt`` (default
``chiprun_out``). Exits with ``chip_smoke.main()``'s code. Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm  # noqa: E402

# The fused-norm kernels as a trace names them (demangled).
TRACED = {"bn_stats": "bn_fwd_kernel<false>", "bn_stats_act": "bn_fwd_kernel<true>",
          "bn_act_bwd": "bn_bwd_kernel", "bn_act_pool_apply": "bn_act_pool_apply_kernel"}


def demangle(names: list) -> list | None:
    """GNU ``c++filt``'s names, the form a trace gives; ``None`` without
    it (``cu++filt`` writes templates and namespaces otherwise)."""
    tool = shutil.which("c++filt")
    if tool is None:
        return None
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return out if len(out) == len(names) else None


def traced_replay(graph) -> list:
    """``(name, stream)`` of every kernel event in a trace of one replay."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)  # the trace is live before the replay
        torch.cuda.synchronize()
        graph.replay()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    return [(e["name"], e["args"].get("stream")) for e in kernels[1:]]  # not the helper


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    report = open(os.path.join(args.out, "replay_trace.txt"), "w")

    def log(line):
        print(line, flush=True)
        print(line, file=report, flush=True)

    capture_launches = collections.Counter()
    launch = fused_norm._launch

    def counting_launch(name, *launch_args):
        if torch.cuda.is_current_stream_capturing():
            stream = launch_args[-1].value
            current = torch.cuda.current_stream().cuda_stream
            capture_launches[(name, "capture stream" if stream == current else
                              "another stream")] += 1
        return launch(name, *launch_args)

    check_replay = chip_smoke.check_replay

    def traced_check(graph, tag):
        names = chip_smoke.graph_kernel_names(graph.graph)
        nodes = {k: sum(s in n for n in names) for k, s in chip_smoke.KERNEL_SYMBOLS.items()}
        traced = traced_replay(graph.graph)
        counts = {k: sum(s in n for n, _ in traced) for k, s in TRACED.items()}
        streams = collections.Counter(s for _, s in traced)
        log(f"[replay_trace] {tag} {graph.key}: kernel nodes {len(names)}, traced "
            f"kernels {len(traced)}; fused-norm nodes {nodes}, traced {counts}; "
            f"{len(streams)} device streams, kernels on each "
            f"{sorted(streams.values(), reverse=True)}; launches under capture "
            f"{ {f'{k[0]} on the {k[1]}': v for k, v in capture_launches.items()} }")
        capture_launches.clear()
        readable = demangle(names)
        if readable is not None:
            held = collections.Counter(readable)
            seen = collections.Counter(n for n, _ in traced)
            differ = {n[:90]: (held[n], seen[n]) for n in held.keys() | seen.keys()
                      if held[n] != seen[n]}
            if differ:
                log(f"[replay_trace]   kernels the trace holds another number of times "
                    f"than the graph (nodes, traced): {json.dumps(differ)}")
        return check_replay(graph, tag)

    fused_norm._launch = counting_launch
    chip_smoke.check_replay = traced_check
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
