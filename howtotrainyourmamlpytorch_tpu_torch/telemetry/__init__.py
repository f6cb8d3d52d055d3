"""Telemetry of the port (``howtotrainyourmamlpytorch_tpu/telemetry/``):
metric primitives (``registry``), the structured JSONL event log
(``events``), and the trainer's observability: ``runtime.TrainTelemetry``
over the heartbeat (``heartbeat``), the anomaly detectors (``anomaly``),
the profiler controller (``profiling``) and the program ledger and OOM
forensics (``device``). The submodules are imported where they are used,
so that importing the event log does not import the learner."""
