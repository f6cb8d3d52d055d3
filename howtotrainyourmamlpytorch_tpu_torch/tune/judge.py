"""The gate judge: keep, revert, regress or pending for each gated key of a
trajectory of emissions (the judging core of the JAX repo's
``tools/bench_judge.py``).

A gates document maps each judged key to its gate: a restricted expression
over one emission's keys (``this`` is the key's own value), the direction
in which the key improves, a regression tolerance and the lever it judges.
:func:`judge` applies every gate to the latest sentinel-clean emission:

* ``keep`` - the gate holds (or the key has no gate and is only
  regression-tracked);
* ``revert`` - the gate is in force and fails: leave the lever unflipped;
* ``regress`` - the value is worse than the last accepted run's beyond
  the tolerance;
* ``pending`` - no measurement yet, a gate in force only from a later run
  (``gate_from_run``), or a gate over a key with no measurement.

An emission labelled ``"contended": true`` is never the accepted run and
never a regression baseline.

The stale-key lists are those of the JAX judge without a bench: this
package has no ``bench.py`` whose ``EMITTED_KEYS`` could be read and no
program registry, so ``stale_gates`` is always empty and ``ungated_keys``
are the latest emission's keys with neither a gate nor an ``ungated_ok``
entry.

Host Python only: this module imports no torch.
"""

from __future__ import annotations

import ast
import json

GATES_SCHEMA = 1

#: Severity order of the verdicts (and of the summary counts).
VERDICT_ORDER = ("regress", "revert", "pending", "keep")

#: AST node classes a gate expression may use: names, numeric constants,
#: arithmetic, comparisons and boolean combinators. Anything else (calls,
#: subscripts, attributes) is a malformed gate and raises.
_ALLOWED_NODES = (
    ast.Expression, ast.Compare, ast.BinOp, ast.UnaryOp, ast.BoolOp,
    ast.Name, ast.Constant, ast.Load,
    ast.Add, ast.Sub, ast.Mult, ast.Div,
    ast.USub, ast.UAdd,
    ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq,
    ast.And, ast.Or,
)


def eval_gate(expr: str, env: dict) -> bool | None:
    """Evaluates a gate expression against one emission's keys (``this``:
    the judged key's value). None when a name it references has no
    measurement (the gate judges as pending, never as a pass); ValueError
    on an expression outside the restricted grammar."""
    tree = ast.parse(expr, mode="eval")
    names = set()
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(
                f"gate expression {expr!r} uses disallowed syntax "
                f"({type(node).__name__})"
            )
        if isinstance(node, ast.Name):
            names.add(node.id)
        if isinstance(node, ast.Constant) and not isinstance(
            node.value, (int, float)
        ):
            raise ValueError(
                f"gate expression {expr!r} uses a non-numeric constant"
            )
    scope = {}
    for name in names:
        value = _numeric(env.get(name))
        if value is None:
            return None
        scope[name] = value
    return bool(
        eval(  # noqa: S307 - AST-whitelisted grammar, empty builtins
            compile(tree, "<bench-gate>", "eval"), {"__builtins__": {}}, scope
        )
    )


def _numeric(value) -> float | None:
    """A value usable in gates and regression arithmetic: numbers and
    bools (True is 1.0). Strings, lists, null and NaN give None."""
    if isinstance(value, bool):
        return float(value)
    if isinstance(value, (int, float)):
        value = float(value)
        return value if value == value else None
    return None


def load_gates(path: str) -> dict:
    """A gates document from ``path``; ValueError for a newer schema or a
    document without a ``gates`` mapping."""
    with open(path) as f:
        doc = json.load(f)
    if int(doc.get("schema", -1)) > GATES_SCHEMA:
        raise ValueError(
            f"{path}: gates schema {doc.get('schema')} is newer than this "
            f"judge reads (up to {GATES_SCHEMA})"
        )
    if not isinstance(doc.get("gates"), dict):
        raise ValueError(f"{path}: no 'gates' mapping")
    return doc


def _regressed(direction: str, value: float, prior: float,
               tolerance: float, abs_slack: float) -> bool:
    slack = max(abs(prior) * tolerance, abs_slack)
    if direction == "lower":
        return value > prior + slack
    return value < prior - slack


def _prior_value(key: str, accepted: list[dict]) -> tuple:
    """The newest earlier accepted run with a numeric ``key``: the run a
    regression is judged against, as ``(value, run name)``."""
    for run in reversed(accepted[:-1]):
        value = _numeric(run["parsed"].get(key))
        if value is not None:
            return value, run["name"]
    return None, None


def judge(gates_doc: dict, runs: list[dict]) -> dict:
    """Applies every gate over ``runs`` (``{"name", "n", "parsed",
    "contended"}`` each, oldest first) and returns the result document:
    the JAX judge's keys and values."""
    accepted = [run for run in runs if not run["contended"]]
    if not accepted:
        raise ValueError(
            "no accepted (sentinel-clean) emission in the trajectory — "
            "every run is contended; nothing can be judged"
        )
    latest = accepted[-1]
    default_tolerance = float(gates_doc.get("default_tolerance", 0.08))
    gates = gates_doc["gates"]
    ungated_ok = set(gates_doc.get("ungated_ok", []))

    verdicts: dict[str, dict] = {}
    for key, spec in gates.items():
        direction = str(spec.get("direction", "higher"))
        tolerance = float(spec.get("tolerance", default_tolerance))
        abs_slack = float(spec.get("abs_slack", 0.0))
        gate_expr = spec.get("gate")
        gate_from_run = spec.get("gate_from_run")
        value = _numeric(latest["parsed"].get(key))
        prior, prior_run = _prior_value(key, accepted)
        entry = {
            "value": value,
            "prior": prior,
            "prior_run": prior_run,
            "gate": gate_expr,
            "lever": spec.get("lever"),
            "source": spec.get("source", "bench.py"),
            "reason": "",
        }
        if (
            value is not None
            and prior is not None
            and _regressed(direction, value, prior, tolerance, abs_slack)
        ):
            entry["verdict"] = "regress"
            entry["reason"] = (
                f"{value:g} is worse than the last accepted run's "
                f"{prior:g} ({prior_run}) beyond tolerance "
                f"{tolerance:g}/{abs_slack:g}"
            )
        elif value is None:
            entry["verdict"] = "pending"
            entry["reason"] = (
                "no measurement in the latest accepted emission "
                f"({latest['name']})"
            )
        elif gate_from_run is not None and latest["n"] < int(gate_from_run):
            entry["verdict"] = "pending"
            entry["reason"] = (
                f"gate in force from run {int(gate_from_run)} (lever "
                f"shipped after run {latest['n']}); awaiting the next "
                "quiet-chip capture"
            )
        elif gate_expr:
            ok = eval_gate(gate_expr, {**latest["parsed"], "this": value})
            if ok is None:
                entry["verdict"] = "pending"
                entry["reason"] = (
                    "gate references key(s) with no measurement yet"
                )
            elif ok:
                entry["verdict"] = "keep"
                entry["reason"] = f"gate holds on {latest['name']}"
            else:
                entry["verdict"] = "revert"
                entry["reason"] = (
                    f"gate fails on {latest['name']}: leave the lever "
                    "unflipped"
                )
        else:
            entry["verdict"] = "keep"
            entry["reason"] = "regression-tracked; no A/B bar"
        verdicts[key] = entry

    counts = {name: 0 for name in VERDICT_ORDER}
    for entry in verdicts.values():
        counts[entry["verdict"]] += 1

    return {
        "schema": GATES_SCHEMA,
        "trajectory": [run["name"] for run in runs],
        "accepted_run": latest["name"],
        "accepted_n": latest["n"],
        "skipped_contended": [
            run["name"] for run in runs if run["contended"]
        ],
        "verdicts": verdicts,
        "counts": counts,
        "regressions": sorted(
            key for key, entry in verdicts.items()
            if entry["verdict"] == "regress"
        ),
        "stale": {
            "missing_from_latest": sorted(
                key for key in gates if key not in latest["parsed"]
            ),
            # No bench declaration and no program registry to hold gates to.
            "stale_gates": [],
            "ungated_keys": sorted(
                set(latest["parsed"]) - (set(gates) | ungated_ok)
            ),
        },
    }
