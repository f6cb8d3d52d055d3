"""One-file checkpoints of a train state and the experiment state, in the
JAX package's archive format (``howtotrainyourmamlpytorch_tpu/utils/
checkpoint.py``), so that a checkpoint of either package loads in the
other.

Format: a NumPy ``.npz`` archive with the state's leaves as ``leaf_{i}`` in
the JAX train state's flatten order, the experiment state as a JSON
string (``__experiment_state__``) and an integrity manifest
(``__manifest__``: schema version, leaf count, per-leaf CRC32, the CRC32
of the tree's key paths, the CRC32 of the experiment state). The port
gives the leaves in that order as ``(path, leaf)`` lists
(``train_state_paths``); the structure is rebuilt from a template on load
(``train_state_from_leaves``).

The contract:

* writes are atomic (temp file, then rename) and retry a transient
  ``OSError`` with exponential backoff;
* ``load_checkpoint`` verifies the manifest and raises
  ``CheckpointCorruptError`` for an unreadable or corrupt file (the resume
  path may quarantine it and fall back), ``ValueError`` for a file of
  another structure (leaf count, key paths or a leaf's shape), and plain
  ``CheckpointError`` once a transient read error outlasts its retries or
  for a schema newer than this module reads;
* ``latest`` is published as a hardlink-or-copy alias of the epoch file,
  and a ``.ready`` marker with the archive's digest is written last;
* a save splits into ``snapshot_for_save`` (the copy to host memory, on
  the caller's thread, before training moves on) and ``write_snapshot``
  (CRC, serialise, rename), which :class:`AsyncCheckpointWriter` runs on
  one background thread, in order, drained on every exit path;
* the injected faults of ``utils/faultinject.py`` run where the JAX
  package's do: before each write attempt, after a file is published, and
  between an archive and its marker; saves, aliases, markers and loads
  emit ``checkpoint_*`` events to an installed telemetry sink.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import zlib

from typing import NamedTuple

import numpy as np

from ..telemetry import events as telemetry_events
from . import faultinject

_EXPERIMENT_KEY = "__experiment_state__"
_MANIFEST_KEY = "__manifest__"

#: Bump when the archive layout changes incompatibly; newer schemas are
#: refused, never misread.
SCHEMA_VERSION = 1

#: Attempts per write or read, with exponential backoff between them.
WRITE_RETRIES = 3
READ_RETRIES = 3
WRITE_BACKOFF_S = 0.05

#: Suffix of the publish done-marker (``train_model_<e>.ready``).
READY_MARKER_SUFFIX = ".ready"
MARKER_SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# The JAX train states' flatten order and key paths
# ---------------------------------------------------------------------------
#
# Two optimizer layouts, told apart by the state (this module imports no
# model). A state with LSLR rates (MAML's and ANIL's ``TrainState``) was
# made by the optimizer of JAX models/maml.py _make_optimizer:
# ``inject_hyperparams(adam)`` over ``multi_transform({"trainable": adam or
# chain(clip, adam), "frozen": set_to_zero()})``. A state without them
# (``GDState``, ``MatchingNetsState``, ``ProtoNetsState``) by
# ``make_injected_adam`` (JAX models/common.py:106-120) over all of theta,
# with no mask. As optax 0.2.6 lays them out:
# InjectHyperparamsState(count, hyperparams={"learning_rate"},
# inner_state=chain), chain sitting under
# MultiTransformState(inner_states={label: MaskedState(inner_state)}) in
# the masked layout. adam is chain(scale_by_adam, scale_by_learning_rate),
# whose state is the tuple (ScaleByAdamState(count, mu, nu), EmptyState()),
# one level deeper behind clip's EmptyState when clipping. EmptyState,
# set_to_zero's state and the MaskedNode of a frozen leaf hold no leaf.
# The NamedTuples below mirror those types by field name; JAX flattens a
# NamedTuple in field order and a dict in sorted key order, and writes a
# path entry as ``a:<field>``, ``d:<key>`` or ``s:<index>``
# (``tree_crc32``). Both counts are the port's one update count.


class _InjectState(NamedTuple):
    count: object
    hyperparams: object
    inner_state: object


class _MultiTransformState(NamedTuple):
    inner_states: object


class _MaskedState(NamedTuple):
    inner_state: object


class _AdamState(NamedTuple):
    count: object
    mu: object
    nu: object


def _is_train_state(state) -> bool:
    """A train state rather than its inference prefix (read by field)."""
    return hasattr(state, "opt_state")


def _is_masked(state) -> bool:
    """Whether the state's optimizer is the masked MAML layout: the state
    carries LSLR rates."""
    return hasattr(state, "lslr")


def _jax_view(state, clip: bool):
    opt = state.opt_state
    moments = _AdamState(opt.count, opt.mu, opt.nu)
    chain = ((), (moments, ())) if clip else (moments, ())
    if _is_masked(state):
        chain = _MultiTransformState(
            {"frozen": (), "trainable": _MaskedState(chain)}
        )
    optax_state = _InjectState(opt.count, {"learning_rate": opt.learning_rate}, chain)
    return state._replace(opt_state=optax_state)


def _flatten_with_path(node, path=()):
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        for field in node._fields:
            yield from _flatten_with_path(getattr(node, field), path + (f"a:{field}",))
    elif isinstance(node, tuple):
        for i, child in enumerate(node):
            yield from _flatten_with_path(child, path + (f"s:{i}",))
    elif isinstance(node, dict):
        for key in sorted(node):
            yield from _flatten_with_path(node[key], path + (f"d:{key}",))
    elif node is not None:
        yield ";".join(path), node


def train_state_paths(state, clip: bool) -> list:
    """``[(path, leaf), ...]`` of a train state (or of its inference
    prefix) in the order and with the key paths of the JAX state of the
    same learner and config; ``clip`` is whether the config clips
    gradients (``MAMLConfig.clip_grad_value``). A path reads like
    ``a:theta;d:conv0;d:conv;d:weight``."""
    if _is_train_state(state):
        state = _jax_view(state, clip)
    return list(_flatten_with_path(state))


def tree_crc32(paths) -> int:
    """The JAX checkpoint's tree fingerprint over these key paths
    (``howtotrainyourmamlpytorch_tpu/utils/checkpoint.py:_tree_fingerprint``)."""
    return zlib.crc32(";".join(f"{p};|" for p in paths).encode())


def _unflatten(node, leaves):
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_unflatten(getattr(node, f), leaves) for f in node._fields))
    if isinstance(node, tuple):
        return tuple(_unflatten(child, leaves) for child in node)
    if isinstance(node, dict):
        filled = {key: _unflatten(node[key], leaves) for key in sorted(node)}
        return {key: filled[key] for key in node}
    return None if node is None else next(leaves)


def train_state_from_leaves(template, leaves, clip: bool):
    """``template`` (a train state or its inference prefix) with its
    leaves replaced by ``leaves``, given in ``train_state_paths``
    order. Of the two update counts the archive holds, Adam's is kept."""
    if not _is_train_state(template):
        return _unflatten(template, iter(leaves))
    view = _unflatten(_jax_view(template, clip), iter(leaves))
    inject = view.opt_state
    chain = inject.inner_state
    if _is_masked(template):
        chain = chain.inner_states["trainable"].inner_state
    adam = chain[1][0] if clip else chain[0]
    return view._replace(opt_state=type(template.opt_state)(
        count=adam.count, mu=adam.mu, nu=adam.nu,
        learning_rate=inject.hyperparams["learning_rate"],
    ))


class CheckpointError(Exception):
    """Base class of typed checkpoint failures."""


class CheckpointCorruptError(CheckpointError):
    """The file is unreadable or fails its integrity check (truncation,
    bit-rot, a torn write). A structural mismatch is not this error."""


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _retrying(action, retries: int, backoff_s: float, cleanup=None,
              target: str | None = None) -> int:
    """Runs ``action`` up to ``retries`` times while it raises ``OSError``,
    backing off exponentially; re-raises the last error. Each attempt on
    ``target`` first passes the injected write faults
    (``faultinject.checkpoint_write_attempt``). Returns the attempts made."""
    last_error: OSError | None = None
    for attempt in range(max(int(retries), 1)):
        if attempt:
            time.sleep(backoff_s * (2 ** (attempt - 1)))
        try:
            if target is not None:
                faultinject.checkpoint_write_attempt(target)
            action()
            return attempt + 1
        except OSError as exc:
            last_error = exc
            if cleanup is not None:
                cleanup()
    raise last_error


def _remove_quietly(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


class CheckpointSnapshot:
    """A train state copied to host memory: safe to hand to a background
    writer while training goes on."""

    __slots__ = ("arrays", "exp_bytes", "tree_crc32")

    def __init__(self, arrays: dict, exp_bytes: bytes, tree_crc32: int):
        self.arrays = arrays
        self.exp_bytes = exp_bytes
        self.tree_crc32 = tree_crc32


def snapshot_for_save(path_leaves, experiment_state: dict) -> CheckpointSnapshot:
    """The critical-path half of a save: every leaf copied to the host (the
    copy waits for the card) and the experiment state encoded.
    ``path_leaves`` is ``[(path, leaf), ...]`` in archive order."""
    arrays = {
        f"leaf_{i}": _host(leaf) for i, (_, leaf) in enumerate(path_leaves)
    }
    exp_bytes = json.dumps(experiment_state, default=float).encode()
    return CheckpointSnapshot(
        arrays, exp_bytes, tree_crc32(p for p, _ in path_leaves)
    )


def write_snapshot(
    filepath: str,
    snapshot: CheckpointSnapshot,
    *,
    retries: int = WRITE_RETRIES,
    backoff_s: float = WRITE_BACKOFF_S,
) -> str:
    """The background half: manifest, npz, atomic rename, retried; then
    the ``checkpoint_save`` event."""
    t_start = time.perf_counter()
    arrays = dict(snapshot.arrays)
    manifest = {
        "schema": SCHEMA_VERSION,
        "leaf_count": len(arrays),
        "leaf_crc32": [_leaf_crc(a) for a in arrays.values()],
        "tree_crc32": snapshot.tree_crc32,
        "experiment_crc32": zlib.crc32(snapshot.exp_bytes),
    }
    arrays[_EXPERIMENT_KEY] = np.frombuffer(snapshot.exp_bytes, dtype=np.uint8)
    arrays[_MANIFEST_KEY] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    tmp = filepath + ".tmp"

    def write():
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, filepath)

    attempts = _retrying(write, retries, backoff_s,
                         cleanup=lambda: _remove_quietly(tmp), target=filepath)
    faultinject.checkpoint_written(filepath)
    telemetry_events.emit(
        "checkpoint_save", path=os.path.basename(filepath),
        duration_s=time.perf_counter() - t_start,
        bytes=os.path.getsize(filepath), attempts=attempts,
    )
    return filepath


def save_checkpoint(
    filepath: str,
    path_leaves,
    experiment_state: dict,
    *,
    retries: int = WRITE_RETRIES,
    backoff_s: float = WRITE_BACKOFF_S,
) -> str:
    """``snapshot_for_save`` then ``write_snapshot``, on this thread."""
    return write_snapshot(
        filepath, snapshot_for_save(path_leaves, experiment_state),
        retries=retries, backoff_s=backoff_s,
    )


class AsyncCheckpointWriter:
    """One background writer thread with a bounded queue: serialise, CRC
    and rename run off the train loop, which pays only the snapshot.

    * Jobs complete in order on one thread: an epoch file, its ``latest``
      alias and its marker publish in the order submitted.
    * ``submit`` blocks while ``max_pending`` jobs are queued and re-raises
      the first writer error first.
    * ``drain`` blocks until the writer is idle: the fence every exit path
      runs before it reads or writes a checkpoint. A process killed without
      it leaves at most an orphaned ``.tmp``.
    """

    def __init__(self, *, max_pending: int = 2):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = int(max_pending)
        self._cond = threading.Condition()
        self._jobs: list = []
        self._busy = False
        self._error: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="async-checkpoint-writer", daemon=True
        )
        self._thread.start()

    def _raise_pending_error(self) -> None:
        with self._cond:
            error, self._error = self._error, None
        if error is not None:
            raise error

    def submit(
        self,
        filepath: str,
        snapshot: CheckpointSnapshot,
        alias_dst: str | None = None,
        *,
        retries: int = WRITE_RETRIES,
        backoff_s: float = WRITE_BACKOFF_S,
        publish_marker: bool = False,
    ) -> None:
        """Queues one write, then the optional alias and ``.ready`` marker."""
        self._raise_pending_error()
        with self._cond:
            while len(self._jobs) >= self.max_pending and not self._closed:
                self._cond.wait()
            if self._closed:
                raise CheckpointError(
                    f"AsyncCheckpointWriter is closed; cannot submit {filepath}"
                )
            self._jobs.append(
                (filepath, snapshot, alias_dst, retries, backoff_s, publish_marker)
            )
            self._cond.notify_all()

    def drain(self, raise_errors: bool = True, timeout: float | None = None) -> bool:
        """Blocks until every submitted job is done; re-raises the first
        writer error with ``raise_errors``. Returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._jobs or self._busy:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
        if raise_errors:
            self._raise_pending_error()
        return True

    @property
    def pending(self) -> int:
        with self._cond:
            return len(self._jobs) + (1 if self._busy else 0)

    def pending_error(self) -> BaseException | None:
        with self._cond:
            return self._error

    def close(self) -> None:
        """Drains (an error stays readable through ``pending_error``),
        stops and joins the writer thread. Idempotent."""
        self.drain(raise_errors=False)
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._jobs and not self._closed:
                    self._cond.wait()
                if self._closed and not self._jobs:
                    return
                filepath, snapshot, alias_dst, retries, backoff_s, marker = (
                    self._jobs.pop(0)
                )
                self._busy = True
                self._cond.notify_all()
            try:
                write_snapshot(filepath, snapshot, retries=retries, backoff_s=backoff_s)
                if alias_dst is not None:
                    publish_alias(filepath, alias_dst, retries=retries,
                                  backoff_s=backoff_s)
                if marker:
                    publish_done_marker(filepath, retries=retries, backoff_s=backoff_s)
            except BaseException as exc:  # noqa: BLE001 - raised at drain/submit
                with self._cond:
                    if self._error is None:
                        self._error = exc
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()


def publish_alias(
    src: str, dst: str, *, retries: int = WRITE_RETRIES,
    backoff_s: float = WRITE_BACKOFF_S,
) -> str:
    """Publishes ``dst`` as a hardlink (or copy) of the checkpoint ``src``
    and an atomic rename: no second serialisation. Safe because every
    write lands a new inode by rename and never edits a file in place."""
    t_start = time.perf_counter()
    tmp = dst + ".alias.tmp"

    def link():
        _remove_quietly(tmp)
        try:
            os.link(src, tmp)
        except OSError:  # another device, or no hardlinks on this filesystem
            shutil.copyfile(src, tmp)
        os.replace(tmp, dst)

    _retrying(link, retries, backoff_s, cleanup=lambda: _remove_quietly(tmp),
              target=dst)
    faultinject.checkpoint_written(dst)
    telemetry_events.emit("checkpoint_alias", path=os.path.basename(dst),
                          src=os.path.basename(src),
                          duration_s=time.perf_counter() - t_start)
    return dst


def checkpoint_digest(filepath: str) -> str:
    """sha256 of the archive's bytes."""
    digest = hashlib.sha256()
    with open(filepath, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def publish_done_marker(
    filepath: str, *, retries: int = WRITE_RETRIES,
    backoff_s: float = WRITE_BACKOFF_S,
) -> str:
    """Writes ``<filepath>.ready`` (atomic, retried) with the archive's
    digest: the last step of an epoch publish, so a directory watcher sees
    only settled checkpoints. ``kill_trainer_mid_publish`` fires first:
    the archive is on disk, its marker is not."""
    faultinject.trainer_publish_marker(filepath)
    t_start = time.perf_counter()
    payload = json.dumps({
        "schema": MARKER_SCHEMA_VERSION,
        "digest": checkpoint_digest(filepath),
        "bytes": os.path.getsize(filepath),
    })
    marker = filepath + READY_MARKER_SUFFIX
    tmp = marker + ".tmp"

    def write():
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, marker)

    _retrying(write, retries, backoff_s, cleanup=lambda: _remove_quietly(tmp),
              target=marker)
    telemetry_events.emit("checkpoint_ready", path=os.path.basename(filepath),
                          duration_s=time.perf_counter() - t_start)
    return marker


def _read_archive(filepath: str):
    """``(leaves, exp_bytes, manifest or None)``, every member read (so the
    zip layer's own CRC checks run)."""
    with np.load(filepath) as archive:
        files = set(archive.files)
        manifest = None
        if _MANIFEST_KEY in files:
            manifest = json.loads(bytes(archive[_MANIFEST_KEY]).decode())
        exp_bytes = bytes(archive[_EXPERIMENT_KEY])
        leaves = {name: archive[name] for name in files if name.startswith("leaf_")}
    return leaves, exp_bytes, manifest


def _verify_manifest(filepath: str, manifest: dict, leaves: dict, exp_bytes: bytes):
    schema = int(manifest.get("schema", -1))
    if schema > SCHEMA_VERSION:
        raise CheckpointError(
            f"{filepath}: written by checkpoint schema {schema}, this build "
            f"reads up to {SCHEMA_VERSION}; refusing to misread it"
        )
    leaf_count = int(manifest["leaf_count"])
    crcs = manifest["leaf_crc32"]
    if len(leaves) != leaf_count or len(crcs) != leaf_count:
        raise CheckpointCorruptError(
            f"{filepath}: archive holds {len(leaves)} leaves but the manifest "
            f"recorded {leaf_count} (truncated or torn write)"
        )
    if zlib.crc32(exp_bytes) != int(manifest["experiment_crc32"]):
        raise CheckpointCorruptError(
            f"{filepath}: experiment-state CRC mismatch (corrupt archive)"
        )
    for i, expected in enumerate(crcs):
        arr = leaves.get(f"leaf_{i}")
        if arr is None:
            raise CheckpointCorruptError(
                f"{filepath}: leaf {i} missing from the archive (truncated write)"
            )
        if _leaf_crc(arr) != int(expected):
            raise CheckpointCorruptError(
                f"{filepath}: leaf {i} CRC mismatch (bit-rot or torn write)"
            )


def _read_verified(filepath: str, retries: int, backoff_s: float):
    """Reads and verifies an archive: ``(leaves, manifest or None,
    experiment_state)``. An integrity failure is ``CheckpointCorruptError``;
    a transient ``OSError`` is retried, then raised as plain
    ``CheckpointError`` so that a brief I/O outage never quarantines a
    healthy file."""
    last_io_error: OSError | None = None
    for attempt in range(max(int(retries), 1)):
        if attempt:
            time.sleep(backoff_s * (2 ** (attempt - 1)))
        try:
            leaves, exp_bytes, manifest = _read_archive(filepath)
            if manifest is not None:
                _verify_manifest(filepath, manifest, leaves, exp_bytes)
            return leaves, manifest, json.loads(exp_bytes.decode())
        except CheckpointError:
            raise
        except FileNotFoundError as exc:
            raise CheckpointCorruptError(
                f"{filepath}: checkpoint file does not exist"
            ) from exc
        except OSError as exc:
            last_io_error = exc
        except Exception as exc:  # zipfile, EOFError, KeyError, json errors
            raise CheckpointCorruptError(
                f"{filepath}: unreadable checkpoint archive "
                f"({type(exc).__name__}: {exc})"
            ) from exc
    raise CheckpointError(
        f"{filepath}: read failed {max(int(retries), 1)} times "
        f"({type(last_io_error).__name__}: {last_io_error}); transient I/O "
        "failure, not corruption"
    ) from last_io_error


def _restore_prefix(filepath: str, template_leaves, leaves: dict) -> list:
    """Archive leaves ``0..len(template)-1`` as numpy arrays of the
    template leaves' dtypes; ``ValueError`` on a shape mismatch."""
    restored = []
    for i, tmpl in enumerate(template_leaves):
        tmpl = _host(tmpl)
        leaf = leaves[f"leaf_{i}"]
        if tmpl.shape != leaf.shape:
            raise ValueError(
                f"{filepath}: checkpoint leaf {i} shape {leaf.shape} != "
                f"expected {tmpl.shape} (config/architecture mismatch?)"
            )
        restored.append(leaf.astype(tmpl.dtype))
    return restored


def load_checkpoint(
    filepath: str, template_path_leaves, *, retries: int = READ_RETRIES,
    backoff_s: float = WRITE_BACKOFF_S,
) -> tuple[list, dict]:
    """``(leaves, experiment_state)``: the archive's leaves as numpy arrays
    in archive order, checked against the template's ``[(path, leaf),
    ...]``. ``CheckpointCorruptError`` for a corrupt file, ``ValueError``
    for a leaf count, key-path fingerprint or shape that differs."""
    t_start = time.perf_counter()
    leaves, manifest, experiment_state = _read_verified(filepath, retries, backoff_s)
    if len(leaves) != len(template_path_leaves):
        raise ValueError(
            f"{filepath}: checkpoint has {len(leaves)} leaves but the template "
            f"state has {len(template_path_leaves)}: config/architecture "
            "mismatch (refusing to load by truncation)"
        )
    paths = [p for p, _ in template_path_leaves]
    if manifest is not None and int(manifest["tree_crc32"]) != tree_crc32(paths):
        raise ValueError(
            f"{filepath}: tree-structure fingerprint mismatch: the checkpoint "
            "was written for another state structure"
        )
    restored = _restore_prefix(
        filepath, [leaf for _, leaf in template_path_leaves], leaves
    )
    telemetry_events.emit("checkpoint_load", path=os.path.basename(filepath),
                          duration_s=time.perf_counter() - t_start,
                          leaves=len(template_path_leaves))
    return restored, experiment_state


def verify_checkpoint(
    filepath: str, *, retries: int = READ_RETRIES, backoff_s: float = WRITE_BACKOFF_S,
) -> dict:
    """Verifies an archive's integrity against no template: ``leaves``,
    ``bytes``, ``has_manifest`` and ``experiment_state``; the typed errors
    of ``load_checkpoint``."""
    leaves, manifest, experiment_state = _read_verified(filepath, retries, backoff_s)
    return {
        "leaves": len(leaves),
        "bytes": os.path.getsize(filepath),
        "has_manifest": manifest is not None,
        "experiment_state": experiment_state,
    }


def load_for_inference(
    filepath: str, template_path_leaves, *, retries: int = READ_RETRIES,
    backoff_s: float = WRITE_BACKOFF_S,
) -> tuple[list, dict]:
    """The first ``len(template)`` leaves of a full training checkpoint:
    the parameters, LSLR rates and BN statistics of an inference state,
    which lead the train state's flatten order. The whole manifest is
    verified; the key-path fingerprint, which covers the optimizer too, is
    not, and the prefix's count and shapes stand in for it."""
    t_start = time.perf_counter()
    leaves, _, experiment_state = _read_verified(filepath, retries, backoff_s)
    if len(leaves) < len(template_path_leaves):
        raise ValueError(
            f"{filepath}: checkpoint has {len(leaves)} leaves but the "
            f"inference template needs {len(template_path_leaves)}"
        )
    restored = _restore_prefix(
        filepath, [leaf for _, leaf in template_path_leaves], leaves
    )
    telemetry_events.emit("checkpoint_load", path=os.path.basename(filepath),
                          duration_s=time.perf_counter() - t_start,
                          leaves=len(template_path_leaves))
    return restored, experiment_state
