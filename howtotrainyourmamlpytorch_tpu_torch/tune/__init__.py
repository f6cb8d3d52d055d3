"""The self-driving resource plane (JAX ``tune/``).

``space.py`` declares every performance knob as data: legal values,
guards, the bench keys each knob moves, and the config fingerprint that
the trainer's telemetry carries. ``autotuner.py`` closes the loop: it
reads the program ledger's roofline position, ranks single-knob moves,
drives short A/B probes under the contention sentinel (``sentinel.py``)
and hands the verdict to the gate judge (``judge.py``) mechanically.
``space`` and ``judge`` import no torch; the probe imports it when it
runs.
"""

from .autotuner import (  # noqa: F401
    BASELINE_KEY,
    HBM_BW_BY_KIND,
    PROBE_APPLIERS,
    PROBE_KEY,
    ContentionSentinel,
    ProbeSpec,
    append_gate,
    autotune_run,
    classify_regime,
    default_measure,
    probe_program,
    rank_candidates,
)
from .sentinel import (  # noqa: F401
    SENTINEL_CONTENTION_FACTOR,
    is_trainer_argv,
    live_trainer_pids,
    sentinel_ms,
)
from .space import (  # noqa: F401
    Knob,
    TuneContext,
    SPACE,
    config_fingerprint,
    fingerprint_from_args,
    resolve,
)
