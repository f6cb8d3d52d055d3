"""The knob space (JAX ``tune/``): every performance knob as data, and the
config fingerprint that the trainer's telemetry carries. The JAX
package's autotuner measures through its own bench and is not ported
yet."""

from .space import (  # noqa: F401
    Knob,
    TuneContext,
    SPACE,
    config_fingerprint,
    fingerprint_from_args,
    resolve,
)
