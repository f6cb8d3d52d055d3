"""Autotune command line: knob tuning with no human choice and judged
receipts (the JAX repo's ``tools/autotune.py``).

One run classifies the card's roofline regime (the probe program's
arithmetic intensity from the program ledger against the ridge of
``resolve_peak_flops`` over ``HBM_BW_BY_KIND``), ranks single-knob moves
from the declared space (``tune/space.py``), measures each under the
contention sentinel's protocol, hands the best to the gate judge
(``tune/judge.py``) and, on ``keep``, appends the winning gate to the
gates file with provenance ``source: autotune:<run_id>`` and writes the
probe's receipts ``AUTOTUNE_<run_id>_r0{1,2}.json``::

    python -m howtotrainyourmamlpytorch_tpu_torch.autotune            # probe, judge, append
    python -m howtotrainyourmamlpytorch_tpu_torch.autotune --dry-run  # probe and judge only
    python -m howtotrainyourmamlpytorch_tpu_torch.autotune --json     # one JSON document
    python -m howtotrainyourmamlpytorch_tpu_torch.autotune --run-id r01 --min-gain 0.05 \\
        [--max-candidates 6] [--out DIR] [--gates FILE] [--device cpu]

It runs on the card unless ``--device`` names another device; without a
card it raises (nothing falls back to the CPU). ``--gates`` defaults to
this package's ``tune/gates.json``, ``--out`` to its git-ignored
``autotune_out/``.

Exit codes: 0 when a winner was judged ``keep`` (and appended unless
``--dry-run``); 2 when no candidate passed its gate or every probe was
contended: nothing was appended.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
DEFAULT_GATES = os.path.join(_PACKAGE_DIR, "tune", "gates.json")
DEFAULT_OUT = os.path.join(_PACKAGE_DIR, "autotune_out")


def _machine_facts(spec, device=None) -> dict:
    """The card's name and count, its float32 peak and the probe
    program's arithmetic intensity (the program ledger's warm-up hook),
    measured on this machine; on the CPU kind ``cpu`` and no peak."""
    import torch

    from .telemetry.device import resolve_peak_flops
    from .tune.autotuner import probe_program
    from .utils.platform import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        count = torch.cuda.device_count()
        peak = resolve_peak_flops(kind, "float32")
    else:
        kind, count, peak = device.type, 1, None
    entry = probe_program(spec, device)
    return {
        "device_kind": kind,
        "device_count": count,
        "peak_flops": peak,
        "flops": entry.flops if entry else None,
        "bytes_accessed": entry.bytes_accessed if entry else None,
        "arithmetic_intensity": entry.arithmetic_intensity if entry else None,
    }


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add = parser.add_argument
    add("--run-id", default=None,
        help="provenance id (default: the next free rNN among the AUTOTUNE_* "
             "files in --out)")
    add("--out", default=DEFAULT_OUT, help="where AUTOTUNE_<run_id>_r0*.json land")
    add("--gates", default=DEFAULT_GATES, help="gates file a kept winner is appended to")
    add("--min-gain", type=float, default=0.05,
        help="the judged bar: the candidate must beat the baseline by this "
             "fraction (the gate expression)")
    add("--max-candidates", type=int, default=6)
    add("--global-batch", type=int, default=8,
        help="meta-batch size the knobs' guards check candidates against")
    add("--window-iters", type=int, default=50,
        help="meta-iterations per probe timing window")
    add("--dry-run", action="store_true",
        help="probe and judge, but touch neither the gates file nor the receipts")
    add("--json", action="store_true")
    add("--device", default=None, help="device of the probes; the card by default")
    return parser


def main(argv=None) -> int:
    opts = get_parser().parse_args(argv)

    from .tune.autotuner import (
        BASELINE_KEY,
        PROBE_KEY,
        ProbeSpec,
        append_gate,
        autotune_run,
        hbm_bandwidth,
    )
    from .tune.space import TuneContext

    spec = ProbeSpec(batch_size=opts.global_batch, window_iters=opts.window_iters)
    machine = _machine_facts(spec, opts.device)
    bandwidth = hbm_bandwidth(machine["device_kind"])
    machine["hbm_bytes_per_s"] = bandwidth
    machine["ridge"] = (machine["peak_flops"] / bandwidth
                        if machine["peak_flops"] and bandwidth else None)
    run_id = opts.run_id or _next_run_id(opts.out)
    sentinel_log: list = []
    result = autotune_run(
        run_id=run_id,
        ctx=TuneContext(n_devices=machine["device_count"], dp=1, mp=1,
                        global_batch=opts.global_batch),
        spec=spec,
        min_gain=opts.min_gain,
        max_candidates=opts.max_candidates,
        device_kind=machine["device_kind"],
        peak_flops=machine["peak_flops"],
        arithmetic_intensity=machine["arithmetic_intensity"],
        device=opts.device,
        sentinel_log=sentinel_log,
    )

    appended = False
    if result.get("winner") and not opts.dry_run:
        os.makedirs(opts.out, exist_ok=True)
        for run in result["emissions"]:
            with open(os.path.join(opts.out, run["name"]), "w") as f:
                json.dump({"n": run["n"], "parsed": run["parsed"]}, f, indent=2)
                f.write("\n")
        append_gate(
            opts.gates, PROBE_KEY, result["winner"]["gate_entry"],
            ungated_extra=(BASELINE_KEY, "autotune_knob", "autotune_value"),
        )
        appended = True
    result["gates_appended"] = appended
    result["machine"] = machine
    result["sentinel_log"] = sentinel_log

    print(json.dumps(result, indent=2) if opts.json else _render(result))
    return 0 if result.get("winner") else 2


def _next_run_id(out_dir: str) -> str:
    taken = set()
    for path in glob.glob(os.path.join(out_dir, "AUTOTUNE_r*_r0*.json")):
        match = re.search(r"AUTOTUNE_(r\d+)_", os.path.basename(path))
        if match:
            taken.add(match.group(1))
    n = 1
    while f"r{n:02d}" in taken:
        n += 1
    return f"r{n:02d}"


def _render(result: dict) -> str:
    lines = [
        f"autotune {result['run_id']} — regime {result['regime']} "
        f"({result['regime_reason']})"
    ]
    base = result.get("baseline")
    lines.append(
        "  baseline: "
        + (f"{base:.2f} meta-iters/s" if base else "DISCARDED (contended)")
    )
    for probe in result.get("probes", []):
        measured = probe["measured"]
        lines.append(
            f"  probe {probe['knob']}={probe['value']}: "
            + (f"{measured:.2f} meta-iters/s"
               if measured is not None else "DISCARDED (contended)")
        )
    judge = result.get("judge")
    if judge:
        lines.append(
            f"  judge: {judge['verdict']} — {judge['reason']} "
            f"(gate {judge['gate']})"
        )
    winner = result.get("winner")
    if winner:
        lines.append(
            f"  WINNER {winner['lever']}: {winner['baseline']:.2f} -> "
            f"{winner['measured']:.2f} meta-iters/s "
            f"(+{winner['gain'] * 100:.0f}%), fingerprint "
            f"{winner['config_fingerprint']}"
            + ("; gate appended" if result.get("gates_appended")
               else "; dry run — gate NOT appended")
        )
    elif "error" in result:
        lines.append(f"  {result['error']}")
    else:
        lines.append("  no candidate beat the gate — nothing appended")
    return "\n".join(lines)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
