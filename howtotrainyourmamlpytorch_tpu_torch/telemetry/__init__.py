"""Telemetry of the port (``howtotrainyourmamlpytorch_tpu/telemetry/``):
the serving runtime's metric primitives (``registry``) and the structured
JSONL event log (``events``). The trainer's telemetry, the device ledger
and the profiler hooks are ROADMAP A12."""
