"""The serving control plane's chaos loops of the port's harness
(``chaos_train.run_promote_chaos`` and ``run_autoscale_chaos``) on the
CPU, at the tiny width of ``chaos_train.tiny_config`` (2 stages of 4
filters): the real trainer, the two daemons as their own processes, and
in-process ``LocalReplica`` pools behind the HTTP front door.

Promote: the trainer SIGKILLed mid-publish and resumed, the first staged
candidate truncated and rejected, the daemon SIGKILLed after its first
``promoted`` row and resumed with no digest promoted twice, at least 3
clean promotions, the regressing last candidate rolled back to the
last-known-good digest, one terminal row per digest, 0 failed requests.
Autoscale: the autoscaler SIGKILLed with a scale-up journaled and the
fleet untouched, resumed once, the scale-up and a scale-down settled, the
same target again spawning nothing, a replica killed under cache hits,
replicas built = seed + scale-up + deaths, 0 failed requests. The
scale-down threshold has the JAX harness's 60 ms floor on a CPU.
"""

import os

import pytest

from howtotrainyourmamlpytorch_tpu_torch import chaos_train
from howtotrainyourmamlpytorch_tpu_torch.utils import locksan


@pytest.fixture(autouse=True)
def _lock_sanitizer():
    """Every test of this suite runs under the port's lock sanitizer: no
    cycle in the observed acquisition order, and every lock created under
    ``howtotrainyourmamlpytorch_tpu_torch/serve`` held under 2.0 s."""
    with locksan.sanitized() as san:
        yield san


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    chaos_train.make_tiny_dataset(str(tmp_path / "omniglot_mini"))
    monkeypatch.delenv("MAML_FAULTS", raising=False)
    # Each loop takes 20-30 s here; a stuck one fails well inside the
    # suite's time limit.
    monkeypatch.setattr(chaos_train, "PROMOTE_TIMEOUT_S", 240)
    monkeypatch.setattr(chaos_train, "AUTOSCALE_TIMEOUT_S", 240)
    return str(tmp_path)


def test_promote_loop_on_the_cpu(workdir):
    verdict = chaos_train.run_promote_chaos(workdir, device="cpu", verbose=False)
    assert verdict["trainer_completed"] and verdict["trainer_killed_mid_publish"], verdict
    assert verdict["daemon_killed_mid_run"] and verdict["double_promoted"] == [], verdict
    assert verdict["promotions"] >= 3 and verdict["corrupt_rejected"] == 1, verdict
    assert verdict["rollback_seen"] and verdict["rollback_to_lkg"], verdict
    assert verdict["terminal_rows_per_digest"] == [1], verdict
    assert verdict["loadtest_offered"] > 0 and verdict["loadtest_failed"] == 0, verdict
    assert 0 < verdict["regression_detect_s"] <= verdict["regression_to_rolled_back_s"]
    assert len(verdict["publish_to_promoted_s"]) == len(verdict["promoted_digests"])
    assert verdict["ok"], verdict
    # The staged copies live in the daemon's own directory.
    staging = os.path.join(workdir, "chaos_promote", "promotion_staging")
    assert os.listdir(staging)


def test_autoscale_loop_on_the_cpu(workdir):
    verdict = chaos_train.run_autoscale_chaos(workdir, device="cpu", down_floor_ms=60.0,
                                              verbose=False)
    assert verdict["daemon_sigkilled"] and verdict["fleet_untouched_at_kill"], verdict
    assert verdict["scale_ups"] >= 1 and verdict["scale_downs"] >= 1, verdict
    assert verdict["resumed_rows"] == 1 and verdict["double_driven"] == [], verdict
    assert verdict["second_resize_added"] == verdict["second_resize_spawned"] == 0
    assert verdict["replicas_built"] == verdict["replicas_expected"], verdict
    assert verdict["replica_deaths"] >= 1 and verdict["requests_failed"] == 0, verdict
    assert verdict["probes"]["down_p99_ms"] >= 60.0
    assert verdict["ok"], verdict


def test_the_control_plane_loops_run_alone(workdir):
    with pytest.raises(SystemExit):
        chaos_train.main(["--workdir", workdir, "--schedule", "promote,kill"])
