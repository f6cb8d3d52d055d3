"""Disk spill of adapted-episode artifacts, the durable half of the serving
LRU (``howtotrainyourmamlpytorch_tpu/serve/tier/spill.py``).

Each entry is one ``.npz`` file published atomically (``atomic.py``), so a
crash leaves no torn pair of files. The file carries its own integrity
contract:

* ``manifest`` - JSON: schema, the sha256 episode digest the entry is
  keyed by, learner family, ``state_version``, leaf count, each leaf's
  CRC32 and torch dtype, and the tree fingerprint (CRC32 of the key paths);
* ``treedef`` - the pickled tree with each leaf replaced by its index, so
  a read rebuilds the artifact's dicts and tuples exactly;
* ``leaf_00000 ...`` - the leaves as numpy arrays (bfloat16 as its 16-bit
  pattern).

The artifacts are tensors on the card: ``_encode`` copies them to host
bytes and ``get`` returns them on the spill's ``device``. Reads verify
every CRC and the fingerprint before a byte reaches the serving path; a
failed verify quarantines the entry and reads as a miss (the caller
adapts cold). An intact entry whose ``(learner, state_version)`` differs
from the one asked for is skipped and counted, never quarantined: it is a
valid entry of another publish epoch.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import threading
import zlib

import numpy as np
import torch

from ...telemetry import events as telemetry_events
from ...utils import faultinject
from ...utils.trees import tree_leaves, tree_map
from .atomic import TierCorruptError, TierError, atomic_write_bytes, quarantine

SCHEMA = 1
_SUFFIX = ".artifact.npz"


def _key_paths(tree, path: tuple = ()) -> list[str]:
    """One ``d:key`` / ``a:field`` / ``s:index`` path per leaf, in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _key_paths(v, path + (f"d:{k}",))]
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None)
        return [p for i, v in enumerate(tree) for p in _key_paths(
            v, path + (f"a:{names[i]}" if names else f"s:{i}",))]
    return [] if tree is None else ["/".join(path)]


def _tree_fingerprint(tree) -> int:
    return zlib.crc32("|".join(_key_paths(tree)).encode())


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf's host array and its torch dtype name."""
    t = torch.as_tensor(leaf).detach()
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().contiguous().numpy(), dtype


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    elif str(t.dtype).removeprefix("torch.") != dtype:
        raise TierCorruptError(f"leaf stored as {t.dtype}, manifest says {dtype}")
    return t if device is None else t.to(device)


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


class ArtifactSpill:
    """Content-addressed durable store of adapted artifacts. Thread-safe
    for the serving pattern (concurrent gets, write-through puts): a put is
    an atomic rename of a content-addressed file, and ``stats`` is guarded
    by a lock."""

    def __init__(self, root: str, *, max_entries: int = 4096, device=None):
        self.root = str(root)
        self.max_entries = int(max_entries)
        self.device = None if device is None else torch.device(device)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.stats = {
            "writes": 0,
            "hits": 0,
            "misses": 0,
            "corrupt_quarantined": 0,
            "mismatch_skipped": 0,
            "io_errors": 0,
            "pruned": 0,
        }

    def _count(self, key: str) -> None:
        with self._lock:
            self.stats[key] += 1

    def path_for(self, digest: str) -> str:
        # Two-hex-character shard directories bound the fan-out.
        return os.path.join(self.root, digest[:2], digest + _SUFFIX)

    # -- write path ------------------------------------------------------

    def put(self, digest: str, artifact, *, learner: str, state_version: int) -> bool:
        """Publishes ``artifact``; True when a new entry landed. Never
        raises into the serving path: an I/O failure is counted (the RAM
        tier still holds the artifact)."""
        path = self.path_for(digest)
        if os.path.exists(path):
            return False  # content-addressed: same digest, same bytes
        try:
            payload = self._encode(digest, artifact, learner=learner,
                                   state_version=state_version)
            atomic_write_bytes(path, payload)
        except (OSError, TierError):
            self._count("io_errors")
            return False
        self._count("writes")
        self._maybe_prune()
        return True

    def _encode(self, digest: str, artifact, *, learner: str, state_version: int) -> bytes:
        leaves = [_to_numpy(leaf) for leaf in tree_leaves(artifact)]
        counter = iter(range(len(leaves)))
        skeleton = tree_map(lambda _: next(counter), artifact)
        manifest = {
            "schema": SCHEMA,
            "digest": digest,
            "learner": str(learner),
            "state_version": int(state_version),
            "leaf_count": len(leaves),
            "leaf_crc32": [_leaf_crc(a) for a, _ in leaves],
            "leaf_dtype": [d for _, d in leaves],
            "tree_crc32": _tree_fingerprint(artifact),
        }
        arrays = {
            "manifest": np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8),
            "treedef": np.frombuffer(pickle.dumps(skeleton), dtype=np.uint8),
        }
        for i, (arr, _) in enumerate(leaves):
            arrays[f"leaf_{i:05d}"] = arr
        bio = io.BytesIO()
        np.savez(bio, **arrays)
        return bio.getvalue()

    # -- read path -------------------------------------------------------

    def get(self, digest: str, *, learner: str, state_version: int):
        """The verified artifact, or None. Every failure reads as a miss
        (corrupt: quarantined with an event; another identity: skipped;
        I/O: counted), so a spill can make an answer slower, never
        wrong."""
        path = self.path_for(digest)
        if not os.path.exists(path):
            self._count("misses")
            return None
        faultinject.corrupt_cache_entry(path)
        try:
            artifact = self._read_verified(path, digest, learner=learner,
                                           state_version=state_version)
        except TierCorruptError as exc:
            quarantine(path, reason=str(exc), kind="artifact")
            self._count("corrupt_quarantined")
            return None
        except ValueError:
            self._count("mismatch_skipped")
            return None
        except OSError:
            self._count("io_errors")
            return None
        self._count("hits")
        telemetry_events.emit("tier_spill_hit", digest=digest[:16], learner=learner)
        return artifact

    def _read_verified(self, path: str, digest: str, *, learner: str, state_version: int):
        with open(path, "rb") as f:
            raw = f.read()
        try:
            with np.load(io.BytesIO(raw)) as npz:
                arrays = {name: npz[name] for name in npz.files}
        except Exception as exc:  # torn zip, bad magic, truncated member
            raise TierCorruptError(f"unreadable spill entry: {exc}") from exc
        for key in ("manifest", "treedef"):
            if key not in arrays:
                raise TierCorruptError(f"spill entry missing {key!r}")
        try:
            manifest = json.loads(arrays["manifest"].tobytes().decode())
        except Exception as exc:
            raise TierCorruptError(f"undecodable manifest: {exc}") from exc
        if int(manifest.get("schema", -1)) != SCHEMA:
            raise TierCorruptError(f"schema {manifest.get('schema')!r} != {SCHEMA}")
        if manifest.get("digest") != digest:
            raise TierCorruptError("entry digest disagrees with filename")
        if (manifest.get("learner") != str(learner)
                or int(manifest.get("state_version", -1)) != int(state_version)):
            raise ValueError(
                f"spill entry is {manifest.get('learner')}/v"
                f"{manifest.get('state_version')}, wanted {learner}/v{state_version}"
            )
        count = int(manifest["leaf_count"])
        crcs, dtypes = manifest["leaf_crc32"], manifest["leaf_dtype"]
        if len(crcs) != count or len(dtypes) != count:
            raise TierCorruptError("manifest leaf lists disagree with leaf_count")
        leaves = []
        for i in range(count):
            arr = arrays.get(f"leaf_{i:05d}")
            if arr is None:
                raise TierCorruptError(f"spill entry missing leaf {i}")
            if _leaf_crc(arr) != int(crcs[i]):
                raise TierCorruptError(f"leaf {i} CRC mismatch")
            leaves.append(_from_numpy(arr, dtypes[i], self.device))
        try:
            skeleton = pickle.loads(arrays["treedef"].tobytes())
            artifact = tree_map(lambda i: leaves[i], skeleton)
        except Exception as exc:
            raise TierCorruptError(f"treedef unpickle failed: {exc}") from exc
        if _tree_fingerprint(artifact) != int(manifest["tree_crc32"]):
            raise TierCorruptError("tree fingerprint mismatch")
        return artifact

    # -- enumeration and rehydration --------------------------------------

    def entries(self) -> list[str]:
        """Digests on disk (quarantined and temporary files left out)."""
        out = []
        try:
            shards = sorted(os.listdir(self.root))
        except OSError:
            return out
        for shard in shards:
            shard_dir = os.path.join(self.root, shard)
            if not os.path.isdir(shard_dir):
                continue
            try:
                names = sorted(os.listdir(shard_dir))
            except OSError:
                continue
            out += [n[: -len(_SUFFIX)] for n in names if n.endswith(_SUFFIX)]
        return out

    def rehydrate_into(self, cache, *, learner: str, state_version: int, limit: int) -> int:
        """Loads up to ``limit`` verified entries of this identity into the
        RAM of an ``AdaptedParamsCache`` (``put_ram``, entries as
        ``(state_version, artifact)``); returns how many it adopted."""
        adopted = 0
        for digest in self.entries():
            if adopted >= max(0, int(limit)):
                break
            artifact = self.get(digest, learner=learner, state_version=state_version)
            if artifact is None:
                continue
            cache.put_ram(digest, (int(state_version), artifact))
            adopted += 1
        if adopted:
            telemetry_events.emit("tier_rehydrated", entries=adopted, learner=learner,
                                  state_version=int(state_version))
        return adopted

    # -- retention -------------------------------------------------------

    def _maybe_prune(self) -> None:
        """Drops the oldest entries (mtime) past ``max_entries``."""
        if self.max_entries <= 0:
            return
        digests = self.entries()
        excess = len(digests) - self.max_entries
        if excess <= 0:
            return
        paths = [self.path_for(d) for d in digests]
        try:
            paths.sort(key=os.path.getmtime)
        except OSError:
            return
        for path in paths[:excess]:
            try:
                os.remove(path)
            except OSError:
                continue
            self._count("pruned")
