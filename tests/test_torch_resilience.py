"""The port's resilience tier (``apex_tpu_torch.resilience``,
``apex_tpu_torch.utils.autoresume``) against the JAX package's, on the
CPU.

The classes follow ``tests/test_resilience.py``'s of the same names
(TestRetry, TestSigterm, TestAutoResumeValidation, TestStepGuard,
TestPoisonTree, TestWatchdog) over the port's modules and torch trees,
with the watchdog on deadlines of 50-100 ms.  Beside them, the same
scripts run through both packages and their outcomes and telemetry
events are held equal: a guard's escalation ladder with its rollback,
AutoResume's GC and resume, the SIGTERM-mid-save drill, and the
watchdog's heartbeat file and stall event.
"""

import io
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch.resilience import (
    DivergenceError,
    RetryPolicy,
    StepGuard,
    Watchdog,
    faults,
    locate_nonfinite,
    read_heartbeat,
)
from apex_tpu_torch.telemetry import events
from apex_tpu_torch.utils.autoresume import AutoResume

torch.set_num_threads(1)  # the suite's parallel workers share the cores


@pytest.fixture(autouse=True)
def _fast_io_retry(monkeypatch):
    """Keep backoff sleeps microscopic so retry tests run in ms."""
    monkeypatch.setenv("APEX_TPU_IO_RETRIES", "3")
    monkeypatch.setenv("APEX_TPU_IO_BACKOFF_BASE", "0.001")
    monkeypatch.setenv("APEX_TPU_IO_BACKOFF_MAX", "0.01")
    yield
    # drain (and discard) any failed async handles this test created so
    # they don't resurface in a later test's wait_pending_saves()
    try:
        ckpt.wait_pending_saves(timeout=30)
    except Exception:
        pass


def _tree(v=1.0):
    return {
        "params": {"w": torch.full((16, 8), v, dtype=torch.float32),
                   "b": torch.ones((8,), dtype=torch.bfloat16)},
        "step": torch.tensor(int(v), dtype=torch.int32),
    }


def _save_steps(root, steps):
    for s in steps:
        ckpt.save_step(str(root), s, _tree(float(s)))


class TestRetry:
    def test_save_retries_transient_oserror_then_succeeds(self, tmp_path):
        path = str(tmp_path / "c")
        with faults.failing_writes(fail_first=2):
            ckpt.save(path, _tree(3.0))
        assert ckpt.verify(path) == []
        out = ckpt.restore(path)
        np.testing.assert_array_equal(np.asarray(out["params"]["w"]), 3.0)

    def test_save_async_retries_then_succeeds(self, tmp_path):
        path = str(tmp_path / "a")
        with faults.failing_writes(fail_first=1):
            h = ckpt.save_async(path, _tree(4.0))
            h.result(timeout=30)  # drain inside the patch's scope
        assert ckpt.verify(path) == []
        out = ckpt.restore(path)
        np.testing.assert_array_equal(np.asarray(out["params"]["w"]), 4.0)

    def test_save_retry_exhausted_raises(self, tmp_path):
        with faults.failing_writes(forever=True):
            with pytest.raises(faults.InjectedIOError):
                ckpt.save(str(tmp_path / "c"), _tree())
        assert not os.path.exists(str(tmp_path / "c"))

    def test_async_retry_exhausted_surfaces_at_result(self, tmp_path):
        with faults.failing_writes(forever=True):
            h = ckpt.save_async(str(tmp_path / "c"), _tree())
            with pytest.raises(faults.InjectedIOError):
                h.result(timeout=30)

    def test_save_retries_through_failed_rename(self, tmp_path):
        """The rename is the one step where a fault could lose the
        previous checkpoint (it was already rmtree'd): the retry must
        rebuild the tmp dir and land the rename on a later attempt."""
        path = str(tmp_path / "c")
        ckpt.save(path, _tree(1.0))
        with faults.failing_renames(fail_first=2) as count:
            ckpt.save(path, _tree(2.0))
        assert count[0] == 2
        assert ckpt.verify(path) == []
        out = ckpt.restore(path)
        np.testing.assert_array_equal(np.asarray(out["params"]["w"]), 2.0)

    def test_rename_retry_exhausted_raises(self, tmp_path):
        with faults.failing_renames(forever=True):
            with pytest.raises(faults.InjectedIOError):
                ckpt.save(str(tmp_path / "c"), _tree())

    def test_rename_exhausted_preserves_previous_checkpoint(self, tmp_path):
        """Overwrite-mode save parks the old checkpoint aside; if every
        rename attempt fails, the old checkpoint is restored — retry
        exhaustion must never leave a hole where a checkpoint was."""
        path = str(tmp_path / "c")
        ckpt.save(path, _tree(1.0))
        with faults.failing_renames(forever=True):
            with pytest.raises(faults.InjectedIOError):
                ckpt.save(path, _tree(2.0))
        assert ckpt.verify(path) == []
        out = ckpt.restore(path)
        np.testing.assert_array_equal(np.asarray(out["params"]["w"]), 1.0)
        assert not os.path.exists(path + ".old")  # parked copy renamed back

    def test_parked_old_checkpoint_from_crashed_attempt_is_recovered(
            self, tmp_path):
        """A prior attempt (or process) that died between parking the
        old checkpoint at .old and landing the new rename must not have
        its parked copy destroyed by the next attempt — it is the only
        surviving copy and gets renamed back into place."""
        path = str(tmp_path / "c")
        ckpt.save(path, _tree(1.0))
        os.rename(path, path + ".old")  # simulated crash window
        with faults.failing_renames(forever=True):
            with pytest.raises(faults.InjectedIOError):
                ckpt.save(path, _tree(2.0))
        assert ckpt.verify(path) == []
        out = ckpt.restore(path)
        np.testing.assert_array_equal(np.asarray(out["params"]["w"]), 1.0)

    def test_read_paths_heal_crash_between_park_and_rename(self, tmp_path):
        """SIGKILL between parking the old checkpoint at .old and the
        tmp→final rename strands the only complete copy at .old; the
        read paths (verify/restore) must recover it, not wait for the
        next save to the same path."""
        path = str(tmp_path / "c")
        ckpt.save(path, _tree(5.0))
        os.rename(path, path + ".old")  # the crash window, frozen
        assert ckpt.verify(path) == []  # healed on read
        out = ckpt.restore(path)
        np.testing.assert_array_equal(np.asarray(out["params"]["w"]), 5.0)
        assert not os.path.exists(path + ".old")

    def test_retry_only_matching_paths(self, tmp_path):
        """path_substr scopes injection: the other checkpoint's writes
        pass through untouched."""
        with faults.failing_writes(forever=True, path_substr="doomed"):
            ckpt.save(str(tmp_path / "fine"), _tree())
            with pytest.raises(faults.InjectedIOError):
                ckpt.save(str(tmp_path / "doomed"), _tree())
        assert ckpt.verify(str(tmp_path / "fine")) == []

    def test_retry_policy_env_and_bounds(self, monkeypatch):
        monkeypatch.setenv("APEX_TPU_IO_RETRIES", "5")
        monkeypatch.setenv("APEX_TPU_IO_BACKOFF_BASE", "0.25")
        monkeypatch.setenv("APEX_TPU_IO_BACKOFF_MAX", "1.0")
        p = RetryPolicy()
        assert p.retries == 5
        for attempt in range(1, 8):
            d = p.sleep_for(attempt)
            assert 0.0 <= d <= min(1.0, 0.25 * 2 ** (attempt - 1))
        with pytest.raises(ValueError):
            RetryPolicy(retries=-1)

    def test_retry_counts_attempts_and_gives_up(self):
        calls = []

        def flaky():
            calls.append(1)
            raise OSError("transient")

        p = RetryPolicy(retries=2, backoff_base=1e-4, backoff_max=1e-3)
        with pytest.raises(OSError):
            p.call(flaky)
        assert len(calls) == 3  # 1 try + 2 retries

    def test_retry_does_not_catch_programming_errors(self):
        calls = []

        def broken():
            calls.append(1)
            raise TypeError("bug, not weather")

        with pytest.raises(TypeError):
            RetryPolicy(retries=3, backoff_base=1e-4).call(broken)
        assert len(calls) == 1


# ============================================================ SIGTERM faults
class TestSigterm:
    def test_sigterm_mid_save_marks_termination_and_save_lands(
            self, tmp_path):
        prev = signal.getsignal(signal.SIGTERM)
        try:
            ar = AutoResume(str(tmp_path), interval_steps=1000,
                            install_sigterm_handler=True)
            with faults.sigterm_on_write(nth=1):
                assert ar.maybe_save(7, _tree(7.0), force=True)
            assert ar.termination_requested()
            # the interrupted save still completed and verifies
            state, step = AutoResume(str(tmp_path)).resume()
            assert step == 7
        finally:
            signal.signal(signal.SIGTERM, prev)

    def test_sigterm_chains_previously_installed_handler(self, tmp_path):
        prev = signal.getsignal(signal.SIGTERM)
        seen = []
        try:
            signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
            ar = AutoResume(str(tmp_path), install_sigterm_handler=True)
            os.kill(os.getpid(), signal.SIGTERM)
            assert ar.termination_requested()
            assert seen == [signal.SIGTERM]  # prior handler still ran
        finally:
            signal.signal(signal.SIGTERM, prev)

    def test_termination_save_happens_once_not_every_step(self, tmp_path):
        ar = AutoResume(str(tmp_path), interval_steps=1000, keep=2)
        ar.request_termination()
        assert ar.maybe_save(3, _tree(3.0))
        # flag consumed: later steps do NOT re-save / GC-churn …
        assert not ar.maybe_save(4, _tree(4.0))
        assert not ar.maybe_save(5, _tree(5.0))
        # … but the loop still sees the request and exits
        assert ar.termination_requested()
        # a fresh request re-arms exactly one more forced save
        ar.request_termination()
        assert ar.maybe_save(6, _tree(6.0))
        assert not ar.maybe_save(7, _tree(7.0))


# ============================================================== AutoResume
class TestAutoResumeValidation:
    def test_keep_must_be_at_least_one(self, tmp_path):
        with pytest.raises(ValueError, match="keep"):
            AutoResume(str(tmp_path), keep=0)
        with pytest.raises(ValueError, match="interval_steps"):
            AutoResume(str(tmp_path), interval_steps=0)

    def test_keep_one_never_deletes_what_it_just_wrote(self, tmp_path):
        ar = AutoResume(str(tmp_path), interval_steps=1, keep=1)
        for s in (1, 2, 3):
            ar.maybe_save(s, _tree(float(s)))
        assert sorted(os.listdir(str(tmp_path))) == ["step_3"]
        _, step = ar.resume()
        assert step == 3

    def test_gc_keeps_valid_checkpoint_over_corrupt_newer(self, tmp_path):
        """keep=1, step_8 valid, step_9/10 bit-flipped: resume falls
        back to 8, the next save overwrites step_9 — GC must keep that
        just-written valid checkpoint and remove the corrupt step_10,
        NOT the reverse (corrupt dirs never count toward ``keep``)."""
        _save_steps(tmp_path, (8, 9, 10))
        for s in (9, 10):
            faults.flip_bit(str(tmp_path / f"step_{s}" / "data.bin"), 5)
        ar = AutoResume(str(tmp_path), interval_steps=1, keep=1)
        _, step = ar.resume()
        assert step == 8
        assert ar.maybe_save(9, _tree(9.0))
        assert sorted(os.listdir(str(tmp_path))) == ["step_9"]
        assert ckpt.latest_valid_step(str(tmp_path)) == 9
        _, step = AutoResume(str(tmp_path)).resume()
        assert step == 9

    def test_gc_removes_corrupt_dirs_in_keep_window(self, tmp_path):
        """Corrupt dirs inside the newest-``keep`` window are deleted
        and their keep slots go to older valid checkpoints."""
        _save_steps(tmp_path, (8, 9, 10))
        for s in (9, 10):
            faults.truncate_file(str(tmp_path / f"step_{s}" / "data.bin"))
        ar = AutoResume(str(tmp_path), interval_steps=1, keep=2)
        _, step = ar.resume()
        assert step == 8
        assert ar.maybe_save(11, _tree(11.0))
        assert sorted(os.listdir(str(tmp_path))) == ["step_11", "step_8"]

    def test_gc_retains_checkpoint_on_transient_verify_error(
            self, tmp_path, monkeypatch):
        """A storage blip while GC verifies a dir must not condemn it:
        the dir stays on disk (uncounted), only genuinely corrupt or
        beyond-quota dirs are removed."""
        _save_steps(tmp_path, (8, 9))
        ar = AutoResume(str(tmp_path), interval_steps=1, keep=2)
        real_verify = ckpt.verify

        def flaky_verify(path, **kw):
            if path.endswith("step_9"):
                raise OSError("transient read error")
            return real_verify(path, **kw)

        monkeypatch.setattr(ckpt, "verify", flaky_verify)
        assert ar.maybe_save(10, _tree(10.0))
        names = sorted(os.listdir(str(tmp_path)))
        # step_9 is inside the keep window but could not be verified:
        # retained (uncounted), its keep slot going to valid step_8
        assert names == ["step_10", "step_8", "step_9"]


# ============================================================== StepGuard
class TestStepGuard:
    def test_escalation_warn_rollback_raise(self, tmp_path):
        """Acceptance criterion: scripted divergence triggers rollback
        after K consecutive nonfinite steps, then raises."""
        _save_steps(tmp_path, (1, 2))
        ar = AutoResume(str(tmp_path), keep=2)
        g = StepGuard(autoresume=ar, warn_after=2, rollback_after=3,
                      raise_after=5)
        assert g.observe(False).action == "ok"      # 1 bad: below warn
        assert g.observe(False).action == "warn"    # 2
        v = g.observe(False)                        # 3: rollback
        assert v.action == "rollback"
        assert v.restored_step == 2
        np.testing.assert_array_equal(
            np.asarray(v.restored_state["params"]["w"]), 2.0)
        assert g.observe(False).action == "warn"    # 4: already rolled back
        with pytest.raises(DivergenceError, match="5 consecutive"):
            g.observe(False)                        # 5: raise

    def test_finite_step_resets_counter_and_rearms_rollback(self, tmp_path):
        _save_steps(tmp_path, (1,))
        ar = AutoResume(str(tmp_path))
        g = StepGuard(autoresume=ar, warn_after=1, rollback_after=2,
                      raise_after=10)
        g.observe(False)
        assert g.observe(False).action == "rollback"
        assert g.observe(True).action == "ok"
        assert g.consecutive_bad == 0
        g.observe(False)
        assert g.observe(False).action == "rollback"  # new episode

    def test_equal_rollback_and_raise_thresholds_still_roll_back(
            self, tmp_path):
        """rollback_after == raise_after is valid config: the rollback
        gets its chance first, the raise fires on the next bad step."""
        _save_steps(tmp_path, (1,))
        g = StepGuard(autoresume=AutoResume(str(tmp_path)),
                      warn_after=1, rollback_after=3, raise_after=3)
        g.observe(False)
        g.observe(False)
        assert g.observe(False).action == "rollback"
        with pytest.raises(DivergenceError):
            g.observe(False)

    def test_rollback_discards_newer_step_dirs(self, tmp_path):
        """Rollback must be durable: step dirs newer than the restored
        step are removed, so a crash right after rollback resumes from
        the rollback point instead of a stale newer checkpoint."""
        _save_steps(tmp_path, (2, 4))
        faults.flip_bit(str(tmp_path / "step_4" / "data.bin"), 3)
        ar = AutoResume(str(tmp_path), keep=3)
        g = StepGuard(autoresume=ar, warn_after=1, rollback_after=1,
                      raise_after=3)
        v = g.observe(False)
        assert v.action == "rollback" and v.restored_step == 2
        assert not os.path.exists(str(tmp_path / "step_4"))
        _, step = AutoResume(str(tmp_path)).resume()
        assert step == 2

    def test_rollback_skips_checksum_valid_diverged_checkpoint(
            self, tmp_path):
        """A divergence that outlives a save interval leaves
        checksum-valid NaN snapshots on disk; rollback must walk past
        them (and remove them) instead of resuming into the diverged
        state."""
        ckpt.save_step(str(tmp_path), 2, _tree(2.0))
        ckpt.save_step(str(tmp_path), 4, faults.poison_tree(_tree(4.0)))
        assert ckpt.verify(str(tmp_path / "step_4")) == []  # checksums ok
        ar = AutoResume(str(tmp_path), keep=3)
        g = StepGuard(autoresume=ar, warn_after=1, rollback_after=1,
                      raise_after=3)
        v = g.observe(False)
        assert v.action == "rollback"
        assert v.restored_step == 2
        assert np.isfinite(
            np.asarray(v.restored_state["params"]["w"])).all()
        assert not os.path.exists(str(tmp_path / "step_4"))
        _, step = AutoResume(str(tmp_path)).resume()
        assert step == 2

    def test_rollback_quarantines_rather_than_deletes(self, tmp_path):
        """When every checkpoint on disk is checksum-valid-but-NaN,
        rollback must not erase the training history: each is renamed
        to step_<N>.discarded (invisible to resume, preserved for
        forensics) and the verdict carries state=None."""
        for s in (2, 4):
            ckpt.save_step(str(tmp_path), s,
                           faults.poison_tree(_tree(float(s))))
        ar = AutoResume(str(tmp_path), keep=3)
        g = StepGuard(autoresume=ar, warn_after=1, rollback_after=1,
                      raise_after=3)
        v = g.observe(False)
        assert v.action == "rollback" and v.restored_state is None
        assert sorted(os.listdir(str(tmp_path))) == \
            ["step_2.discarded", "step_4.discarded"]
        assert AutoResume(str(tmp_path)).resume() == (None, 0)

    def test_rollback_terminates_when_discard_has_no_effect(self, tmp_path):
        """If discarding a poisoned checkpoint silently fails (e.g. no
        delete permission), resume hands the same step back — the walk
        must bail out with that state instead of looping forever."""
        root = str(tmp_path)
        ckpt.save_step(root, 2, faults.poison_tree(_tree(2.0)))

        class StuckAutoResume:
            def resume(self, target=None):
                return ckpt.restore_latest_valid(root, target=target)

            def discard_step(self, step):
                pass  # broken: the dir never actually goes away

            def discard_steps_after(self, step):
                pass

        g = StepGuard(autoresume=StuckAutoResume(), warn_after=1,
                      rollback_after=1, raise_after=3)
        v = g.observe(False)  # must terminate
        assert v.action == "rollback" and v.restored_step == 2

    def test_rollback_skipped_without_autoresume(self):
        g = StepGuard(warn_after=1, rollback_after=2, raise_after=4)
        assert g.observe(False).action == "warn"
        assert g.observe(False).action == "warn"  # no AR → no rollback
        g.observe(False)
        with pytest.raises(DivergenceError):
            g.observe(False)

    def test_scale_floor_alarm(self):
        from apex_tpu_torch.amp import LossScaler

        scaler = LossScaler(min_loss_scale=128.0, init_scale=128.0)
        state = scaler.init("cpu")
        g = StepGuard(scaler=scaler, warn_after=100, rollback_after=100,
                      raise_after=200)
        v = g.observe(False, scaler_state=state)
        assert v.at_scale_floor
        assert v.action == "warn"  # pinned scale alarms before warn_after

    def test_no_floor_alarm_at_healthy_scale(self):
        from apex_tpu_torch.amp import LossScaler

        scaler = LossScaler()
        state = scaler.init("cpu")  # 2**16, floor 1.0
        g = StepGuard(scaler=scaler, warn_after=100, rollback_after=100,
                      raise_after=200)
        v = g.observe(False, scaler_state=state)
        assert not v.at_scale_floor and v.action == "ok"

    def test_threshold_ordering_validated(self):
        with pytest.raises(ValueError):
            StepGuard(warn_after=5, rollback_after=3, raise_after=10)
        with pytest.raises(ValueError):
            StepGuard(warn_after=0)

    def test_nan_localization_names_the_leaf(self):
        grads = {"layer0": {"w": torch.ones((4, 4)), "b": torch.ones((4,))},
                 "layer1": {"w": torch.ones((2, 2))}}
        bad = faults.poison_tree(grads, leaf_index=2, element=1)
        located = locate_nonfinite(bad)
        assert len(located) == 1
        assert "layer1" in located[0] and "w" in located[0]
        assert "nan x1/4" in located[0]

    def test_localization_sees_bfloat16_leaves(self):
        """bf16 is the common TPU gradient dtype; localization (and the
        poison harness) must treat it as floating even though bare
        numpy does not."""
        grads = {"wq": torch.ones((4,), dtype=torch.bfloat16)}
        bad = faults.poison_tree(grads, element=2)
        (entry,) = locate_nonfinite(bad)
        assert "wq" in entry and "nan x1/4" in entry

    def test_localization_distinguishes_inf(self):
        bad = faults.poison_tree({"g": torch.zeros((8,))},
                                 value=float("inf"), element=3)
        (entry,) = locate_nonfinite(bad)
        assert "inf" in entry and "nan" not in entry

    def test_divergence_error_carries_localization(self, tmp_path):
        g = StepGuard(warn_after=1, rollback_after=1, raise_after=2)
        grads = faults.poison_tree({"wq": torch.ones((3,))})
        g.observe(False, grads=grads)
        with pytest.raises(DivergenceError, match="wq"):
            g.observe(False, grads=grads)


class TestPoisonTree:
    def test_poisons_exactly_one_element(self):
        tree = {"a": torch.zeros((4,)), "n": torch.arange(3)}  # n: int, skipped
        out = faults.poison_tree(tree, leaf_index=0, element=2)
        a = np.asarray(out["a"])
        assert np.isnan(a[2]) and np.isfinite(a[[0, 1, 3]]).all()
        np.testing.assert_array_equal(np.asarray(out["n"]), [0, 1, 2])

    def test_rejects_treeless_or_out_of_range(self):
        with pytest.raises(ValueError, match="no floating"):
            faults.poison_tree({"i": torch.arange(3)})
        with pytest.raises(ValueError, match="out of range"):
            faults.poison_tree({"a": torch.zeros(2)}, leaf_index=5)


# =============================================================== Watchdog
class TestWatchdog:
    def test_stall_dumps_stacks_and_fires_callback(self):
        buf = io.StringIO()
        hits = []
        with Watchdog(deadline_s=0.05, poll_s=0.01, stream=buf,
                      on_stall=lambda e, t: hits.append((e, t))) as wd:
            time.sleep(0.15)  # no beat → stall
        assert wd.stall_count == 1  # one dump per episode, not per poll
        assert hits and hits[0][0] >= 0.05
        dump = buf.getvalue()
        assert "watchdog stack dump" in dump
        assert "apex-tpu-torch-watchdog" in dump  # all threads, incl. itself

    def test_beats_prevent_stall(self):
        buf = io.StringIO()
        with Watchdog(deadline_s=0.1, poll_s=0.01, stream=buf) as wd:
            for _ in range(6):
                time.sleep(0.02)
                wd.beat()
        assert wd.stall_count == 0
        assert buf.getvalue() == ""

    def test_beat_after_stall_rearms(self):
        buf = io.StringIO()
        with Watchdog(deadline_s=0.05, poll_s=0.01, stream=buf) as wd:
            time.sleep(0.15)  # episode 1
            wd.beat()
            time.sleep(0.15)  # episode 2
        assert wd.stall_count == 2

    def test_callback_failure_does_not_kill_watchdog(self):
        buf = io.StringIO()

        def bad_callback(elapsed, text):
            raise RuntimeError("observer bug")

        with Watchdog(deadline_s=0.05, poll_s=0.01, stream=buf,
                      on_stall=bad_callback) as wd:
            time.sleep(0.15)
            wd.beat()
            time.sleep(0.15)
        assert wd.stall_count == 2  # survived the broken callback

    def test_lifecycle_validation(self):
        with pytest.raises(ValueError):
            Watchdog(deadline_s=0.0)
        wd = Watchdog(deadline_s=10.0)
        wd.start()
        with pytest.raises(RuntimeError, match="already running"):
            wd.start()
        wd.stop()
        wd.stop()  # idempotent
        wd.start()  # restartable
        wd.stop()


# ========================================== the same scripts through JAX
class Sink:
    """An event sink on one package's bus (wall times left out)."""

    TIMES = ("duration_s", "elapsed_s")

    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append((kind, {k: v for k, v in fields.items()
                                   if k not in self.TIMES}))


def _jax():
    import jax.numpy as jnp

    from apex_tpu import checkpoint as jckpt
    from apex_tpu.resilience import StepGuard as JStepGuard
    from apex_tpu.resilience import Watchdog as JWatchdog
    from apex_tpu.resilience import faults as jfaults
    from apex_tpu.telemetry import events as jevents
    from apex_tpu.utils.autoresume import AutoResume as JAutoResume

    def tree(v=1.0):
        return {"params": {"w": jnp.full((16, 8), v, jnp.float32),
                           "b": jnp.ones((8,), jnp.bfloat16)},
                "step": jnp.int32(int(v))}

    return dict(ckpt=jckpt, StepGuard=JStepGuard, Watchdog=JWatchdog,
                faults=jfaults, events=jevents, AutoResume=JAutoResume,
                tree=tree)


def _port():
    return dict(ckpt=ckpt, StepGuard=StepGuard, Watchdog=Watchdog,
                faults=faults, events=events, AutoResume=AutoResume,
                tree=_tree)


def _scrub(evs, root):
    """Events with the package's root directory taken out of paths."""
    out = []
    for kind, f in evs:
        f = {k: (v.replace(root, "<root>") if isinstance(v, str) else v)
             for k, v in f.items()}
        out.append((kind, f))
    return out


def _guard_script(p, root):
    """Saves, a corrupt newest step, a poisoned step, then a divergence
    that warns, rolls back (past both) and raises; with a GC on the way."""
    sink = Sink()
    p["events"].add_sink(sink)
    try:
        ar = p["AutoResume"](root, interval_steps=2, keep=3)
        verdicts = []
        for s in (2, 4):
            ar.maybe_save(s, p["tree"](float(s)))
        p["ckpt"].save_step(root, 6, p["faults"].poison_tree(
            p["tree"](6.0)))
        p["ckpt"].save_step(root, 8, p["tree"](8.0))
        p["faults"].flip_bit(os.path.join(root, "step_8", "data.bin"), 9)
        g = p["StepGuard"](autoresume=ar, warn_after=1, rollback_after=2,
                           raise_after=4)
        for step in range(10, 14):
            try:
                v = g.observe(False, step=step)
            except DivergenceError as e:
                verdicts.append(("raise", str(e)))
                break
            except Exception as e:   # JAX's DivergenceError
                verdicts.append(("raise", str(e)))
                break
            verdicts.append((v.action, v.consecutive_bad, v.restored_step))
        return verdicts, sorted(os.listdir(root)), _scrub(sink.events, root)
    finally:
        p["events"].remove_sink(sink)


def test_guard_rollback_script_matches_jax(tmp_path):
    """Warn, rollback past a bit-flipped and a NaN checkpoint to step 4
    (the newer dirs quarantined), raise: verdicts, the directory and every
    event (checkpoint, autoresume, guard) are JAX's."""
    j = _guard_script(_jax(), str(tmp_path / "j"))
    t = _guard_script(_port(), str(tmp_path / "t"))
    assert t[0] == j[0] and t[1] == j[1]
    assert [k for k, _ in t[2]] == [k for k, _ in j[2]]
    assert t[2] == j[2]
    assert ("rollback", 2, 4) in t[0] and t[0][-1][0] == "raise"


def _sigterm_script(p, root):
    prev = signal.getsignal(signal.SIGTERM)
    try:
        ar = p["AutoResume"](root, interval_steps=1000, keep=2,
                             install_sigterm_handler=True)
        with p["faults"].sigterm_on_write(nth=2):
            saved = ar.maybe_save(7, p["tree"](7.0), force=True)
        out = [saved, ar.termination_requested(),
               ar.maybe_save(8, p["tree"](8.0)),
               ar.termination_requested()]
        _, step = p["AutoResume"](root).resume()
        return out + [step, sorted(os.listdir(root))]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_sigterm_mid_save_matches_jax(tmp_path):
    j = _sigterm_script(_jax(), str(tmp_path / "j"))
    t = _sigterm_script(_port(), str(tmp_path / "t"))
    # the notice landed mid-save: that save completes, and the forced
    # save it asks for is the next boundary's
    assert t == j == [True, True, True, True, 8, ["step_7", "step_8"]]


def _watchdog_script(p, root):
    sink = Sink()
    p["events"].add_sink(sink)
    hb = os.path.join(root, "hb.json")
    os.makedirs(root)
    try:
        with p["Watchdog"](deadline_s=0.05, poll_s=0.01, stream=io.StringIO(),
                           heartbeat_file=hb) as wd:
            wd.beat(step=3, extra={"replica": "r0"})
            rec = json.load(open(hb))
            time.sleep(0.15)
        return ({k: rec[k] for k in ("pid", "step", "replica")},
                wd.stall_count, sink.events)
    finally:
        p["events"].remove_sink(sink)


def test_watchdog_heartbeat_and_stall_event_match_jax(tmp_path):
    j = _watchdog_script(_jax(), str(tmp_path / "j"))
    t = _watchdog_script(_port(), str(tmp_path / "t"))
    assert t == j
    assert t[2][0][0] == "watchdog_stall" and t[1] == 1
    assert read_heartbeat(str(tmp_path / "t" / "hb.json"))["step"] == 3
    assert read_heartbeat(str(tmp_path / "none.json")) is None
