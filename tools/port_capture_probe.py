"""Which host-side clean-ups invalidate a CUDA graph capture (card only).

The step graph (``models/step_graph.py``) captures in ``thread_local``
mode, so the stager and watchdog threads may call CUDA freely; the
capturing thread itself must make no unsafe call. Python's cyclic garbage
collector can run a finalizer on that thread at any allocation, which
would make such a call in the middle of a capture. Each case below builds
an object outside a capture, then drops it (or calls the API) inside a
``thread_local`` capture of two small kernels, and reports whether the
capture survived. Each case runs in a process of its own.

    python3 tools/port_capture_probe.py [--case NAME ...]

Prints one line a case and a JSON line of all of them.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CASES = (
    "baseline", "event_destroy", "graph_destroy", "pinned_free",
    "record_stream_free", "mem_get_info", "event_query",
    "graph_gc", "graph_gc_guarded",
)


def _captured_graph(torch, dev):
    """A captured and replayed graph with its static buffer."""
    g0 = torch.cuda.CUDAGraph()
    y = torch.zeros(8, device=dev)
    with torch.cuda.graph(g0, stream=torch.cuda.Stream(dev),
                          capture_error_mode="thread_local"):
        y.add_(1)
    g0.replay()
    torch.cuda.synchronize()
    return g0, y


def run_case(case: str) -> dict:
    import torch

    dev = torch.device("cuda")
    side = torch.cuda.Stream(dev)
    x = torch.zeros(1024, device=dev)
    state = {}
    if case in ("event_destroy", "event_query"):
        with torch.cuda.stream(side):
            torch.empty(1 << 20, device=dev).fill_(1)
            state["obj"] = torch.cuda.Event()
            state["obj"].record(side)
        side.synchronize()
    elif case == "graph_destroy":
        state["obj"], _ = _captured_graph(torch, dev)
    elif case == "pinned_free":
        host = torch.ones(1 << 20, pin_memory=True)
        with torch.cuda.stream(side):
            state["dev"] = host.to(dev, non_blocking=True)
        state["obj"] = host
        del host
        side.synchronize()
    elif case == "record_stream_free":
        with torch.cuda.stream(side):
            t = torch.ones(1 << 20, device=dev)
        t.record_stream(torch.cuda.current_stream(dev))
        state["obj"] = t
        del t
        torch.cuda.synchronize()
    elif case.startswith("graph_gc"):
        # A graph reachable only through a reference cycle, as a finished
        # learner's step graphs can be: garbage that only the cyclic
        # collector frees. Kept young (collector off) until the capture.
        graph = _captured_graph(torch, dev)
        gc.disable()
        holder = {"graph": graph}
        holder["self"] = holder
        del holder, graph
    torch.cuda.synchronize()

    g = torch.cuda.CUDAGraph()
    cap = torch.cuda.Stream(dev)
    from howtotrainyourmamlpytorch_tpu_torch.models.step_graph import (
        collector_paused,
    )

    # What StepGraph does around its capture, or nothing.
    guard = collector_paused() if case == "graph_gc_guarded" else contextlib.nullcontext()
    error = None
    try:
        with guard, torch.cuda.graph(g, stream=cap, capture_error_mode="thread_local"):
            x.add_(1)
            if case == "graph_gc":
                gc.enable()  # the collector on, as it is by default
            if case in ("event_destroy", "graph_destroy", "pinned_free",
                        "record_stream_free"):
                state.pop("obj")
            elif case == "mem_get_info":
                torch.cuda.mem_get_info(dev)
            elif case == "event_query":
                state["obj"].query()
            if case.startswith("graph_gc"):
                churn = [[i] for i in range(10_000)]  # past the threshold
                del churn
            x.mul_(2)
        g.replay()
        torch.cuda.synchronize()
        ok = bool((x == 2).all().item())
    except Exception as exc:  # noqa: BLE001 - the finding
        ok, error = False, f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
    finally:
        gc.enable()
    return {"case": case, "capture_ok": ok, "error": error}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--case", action="append", choices=CASES)
    p.add_argument("--child", choices=CASES, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print(json.dumps(run_case(args.child)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    results = []
    for case in args.case or CASES:
        proc = subprocess.run([sys.executable, __file__, "--child", case],
                              capture_output=True, text=True, timeout=120)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        res = json.loads(lines[-1]) if lines else {
            "case": case, "capture_ok": False,
            "error": f"rc {proc.returncode}: {proc.stderr.strip()[-300:]}"}
        results.append(res)
        print(f"{case}: capture {'survived' if res['capture_ok'] else 'FAILED'}"
              + (f" ({res['error']})" if res["error"] else ""), flush=True)
    print(json.dumps({"torch": torch.__version__, "device": torch.cuda.get_device_name(0),
                      "cases": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
