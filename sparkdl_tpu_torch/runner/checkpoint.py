"""Checkpoint and resume for the port's runner.

The counterpart of ``sparkdl_tpu/runner/checkpoint.py``. There orbax saves
the ``TrainState`` pytree; here a step is one ``torch.save`` file,
``<directory>/<step>/state.pt``, holding the model's ``state_dict()``
(parameters and buffers, so the BatchNorm statistics), the optimizer's
``state_dict()`` and the step count. It is read back with
``torch.load(weights_only=True)``.

- **Saving while training goes on.** The port updates weights in place
  (JAX made new arrays). So ``save`` first copies every tensor to the host
  and waits for the copies; only then does a writer thread (``async_save``)
  write the file. The next optimizer step can no longer reach what is
  being written.
- **Commit.** The file is written into ``<step>.tmp-<pid>`` and renamed to
  ``<step>`` once written. A leftover temporary directory is never a step.
- **Manifests.** Once a save has landed, a per-step manifest
  ``manifest_step_<step>.json`` records each file's byte size and CRC32,
  written to a temporary file and moved into place with ``os.replace``:
  its existence certifies a complete save. ``save(..., data_cursor=)``
  keeps the data plane's position in it, CRC'd over its canonical JSON
  (``data_cursor(step)`` verifies it on resume).
- **Recovery.** ``restore`` verifies the newest step against its
  manifest. A corrupt step, or an uncommitted one (a step directory newer
  than the newest manifest), is quarantined to ``<step>.corrupt`` and the
  restore rolls back to the newest verified step. It records a
  ``checkpoint_rollback`` event and ``run_stats.record_rollback``.
  Directories without any manifest (legacy runs) restore unverified, and
  ``SPARKDL_CHECKPOINT_VERIFY=0`` turns manifests and verification off.
- **Topology.** The manifest fingerprints the world size (one device a
  process, so the world size is also the number of devices the run
  trained on; the cards a host happens to show do not bind a restore)
  and each tensor's shape and dtype. A restore into a
  different world size, or into tensors of other names, shapes or dtypes,
  raises :class:`CheckpointTopologyError` naming every mismatch in one
  error. One exception is kept from the reference: a checkpoint saved
  without a model's buffers (BatchNorm statistics) restores into a model
  that has them, and the model keeps its own. Under ``SPARKDL_ELASTIC=1``
  (``failures.elastic_enabled``) a checkpoint whose only mismatch is the
  world size restores as it is — the gang's state is replicated, so
  nothing is re-laid out — and records ``checkpoint_resharded``: an
  elastic gang that shrank finishes from the larger gang's checkpoint.
  Resharding a sharded state across meshes comes with several cards
  (ROADMAP.md, Queue A 8).
- **In a gang** (``group=``, the gang's host-side process group): the
  state is the same on every rank, so rank 0 alone writes a step, and
  waits for it (file, manifest and CRC) whatever ``async_save`` says;
  every rank then waits at a barrier until the manifest is committed, so
  no rank runs ahead of a save that has not landed. A restore is chosen
  by rank 0 (verification, quarantine, rollback) and every rank loads
  that same step.
- :func:`save_portable` / :func:`load_portable`: a single-file export of
  a tree of tensors (``torch.save`` of the flat ``a/b/c`` names, where the
  reference uses safetensors).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import zlib
from typing import Any

import torch
import torch.distributed as dist

from . import chaos, events, failures
from . import metrics as metrics_lib
# Damage the newest step as a torn write would: the chaos kind ``corrupt``
# and the tests call the one implementation, which lives in chaos.
from .chaos import corrupt_latest_checkpoint  # noqa: F401

log = logging.getLogger("sparkdl_tpu_torch.runner")

_MANIFEST_PREFIX = "manifest_step_"
_STATE_FILE = "state.pt"


class CheckpointCorruptionError(RuntimeError):
    """Every checkpoint on disk failed verification, or the step the
    caller named did: there is no verified state to restore."""


class CheckpointTopologyError(RuntimeError):
    """The checkpoint does not fit the state it is restored into: another
    world size, or tensors of other names, shapes or dtypes. Raised before
    any tensor is copied, naming every mismatch."""

    def __init__(self, step: int, mismatches: list[str]):
        super().__init__(
            f"checkpoint step {step} does not fit the state restoring it "
            f"({len(mismatches)} mismatch(es)): " + "; ".join(mismatches)
            + ". SPARKDL_ELASTIC=1 restores the replicated state across a "
            "world-size change alone; resharding a sharded state across "
            "meshes is not ported yet (ROADMAP.md, Queue A 8).")
        self.step = step
        self.mismatches = mismatches


def _verify_enabled() -> bool:
    return os.environ.get("SPARKDL_CHECKPOINT_VERIFY", "1").strip() \
        not in ("0", "false", "no")


def _cursor_crc(cursor: dict) -> int:
    return zlib.crc32(
        json.dumps(cursor, sort_keys=True, default=str).encode())


def _crc32_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _atomic_write_json(path: str, obj) -> None:
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, sort_keys=True, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _to_host(tree):
    """Every tensor of ``tree`` (dicts, lists, tuples) copied to the host
    as a tensor of its own; the copies have finished when this returns."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.to("cpu", copy=True) if t.device.type != "cpu" \
            else t.clone()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _spec(t: torch.Tensor) -> list:
    return [list(t.shape), str(t.dtype).replace("torch.", "")]


def _topology(model_sd: dict, world_size: int) -> dict:
    """The save-time fingerprint the manifest keeps: the world size (one
    device a process, so also the devices the run trained on) and each
    tensor's shape and dtype."""
    return {"world_size": int(world_size),
            "tensors": {k: _spec(v) for k, v in model_sd.items()}}


class CheckpointManager:
    """Saves and restores a :class:`~.train_state.TrainState` (model,
    optimizer, step) under ``directory``, one step a directory, the newest
    ``max_to_keep`` kept.

    ``async_save=True`` writes each step from a writer thread after the
    tensors have been copied to the host; ``wait()`` blocks until it has
    landed and its manifest is committed. ``wait()`` and ``close()`` are
    idempotent and safe before the first save.

    ``group``: the gang's host-side process group (every rank makes a
    manager over the same directory), or None in one process. In a gang
    ``save`` and ``restore`` are collective: every rank calls them."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True, group=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.async_save = bool(async_save)
        self.group = group
        self.world_size = dist.get_world_size(group) if group else 1
        self.rank = dist.get_rank(group) if group else 0
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None
        self._closed = False

    # -- layout ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_MANIFEST_PREFIX}{step}.json")

    def _disk_steps(self) -> list[int]:
        """Committed step directories on disk (``.corrupt`` and temporary
        directories are not steps)."""
        try:
            return sorted(int(d) for d in os.listdir(self.directory)
                          if d.isdigit()
                          and os.path.isdir(os.path.join(self.directory, d)))
        except OSError:
            return []

    def latest_step(self) -> int | None:
        self._join()
        steps = self._disk_steps()
        return steps[-1] if steps else None

    # -- manifests -----------------------------------------------------------
    def _write_manifest(self, step: int, data_cursor: dict | None,
                        topology: dict) -> None:
        """Walk the landed step directory and commit its manifest: each
        file's relative path, byte size and CRC32."""
        step_dir = self._step_dir(step)
        files = []
        for root, _, names in os.walk(step_dir):
            for name in sorted(names):
                p = os.path.join(root, name)
                files.append({"path": os.path.relpath(p, step_dir),
                              "bytes": os.path.getsize(p),
                              "crc32": _crc32_file(p)})
        manifest: dict = {"step": step, "files": files,
                          "topology": topology}
        if data_cursor is not None:
            manifest["data_cursor"] = data_cursor
            manifest["data_cursor_crc32"] = _cursor_crc(data_cursor)
        _atomic_write_json(self._manifest_path(step), manifest)

    def _read_manifest(self, step: int) -> dict | None:
        try:
            with open(self._manifest_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _manifest_mode(self) -> bool:
        """Verification applies once any manifest exists: a directory of a
        run without manifests restores as it was saved."""
        if not _verify_enabled():
            return False
        try:
            return any(fn.startswith(_MANIFEST_PREFIX)
                       for fn in os.listdir(self.directory))
        except OSError:
            return False

    def _prune(self) -> None:
        """Keep the newest ``max_to_keep`` steps; drop every manifest
        whose step is gone, so no stale manifest certifies a deleted
        step."""
        steps = self._disk_steps()
        if self.max_to_keep > 0:
            for s in steps[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
        on_disk = set(self._disk_steps())
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for fn in names:
            if fn.startswith(_MANIFEST_PREFIX) and fn.endswith(".json"):
                stem = fn[len(_MANIFEST_PREFIX):-len(".json")]
                if stem.isdigit() and int(stem) not in on_disk:
                    try:
                        os.unlink(os.path.join(self.directory, fn))
                    except OSError:
                        pass

    def verify_step(self, step: int) -> tuple[bool, str]:
        """Check ``step`` against its manifest: every file present, of the
        recorded size and CRC32. ``(ok, reason)``."""
        self._join()
        manifest = self._read_manifest(step)
        if manifest is None:
            return False, "manifest missing or unreadable (partial save?)"
        step_dir = self._step_dir(step)
        for rec in manifest.get("files", []):
            p = os.path.join(step_dir, rec["path"])
            try:
                size = os.path.getsize(p)
            except OSError:
                return False, f"missing file {rec['path']}"
            if size != rec["bytes"]:
                return False, (f"{rec['path']}: {size} bytes, manifest "
                               f"says {rec['bytes']} (truncated?)")
            try:
                if _crc32_file(p) != rec["crc32"]:
                    return False, f"{rec['path']}: checksum mismatch"
            except OSError:
                return False, f"unreadable file {rec['path']}"
        return True, "ok"

    def quarantine_step(self, step: int, reason: str = "") -> str | None:
        """Move a corrupt step out of the restore path (renamed
        ``<step>.corrupt``, kept for inspection) and drop its manifest."""
        src = self._step_dir(step)
        dst = f"{src}.corrupt"
        if os.path.exists(dst):
            dst = f"{dst}.{os.getpid()}"
        try:
            os.rename(src, dst)
        except OSError:
            log.warning("could not quarantine corrupt checkpoint %s", src,
                        exc_info=True)
            dst = None
        try:
            os.unlink(self._manifest_path(step))
        except OSError:
            pass
        log.error("quarantined corrupt checkpoint step %d (%s) -> %s",
                  step, reason, dst)
        events.event("checkpoint_quarantine", step=step, reason=reason,
                     moved_to=dst)
        return dst

    def data_cursor(self, step: int) -> dict | None:
        """The verified data cursor saved with ``step``, or None (with an
        ``unverified_data_cursor`` event) when the manifest has none, its
        CRC does not match, or there is no manifest: the caller's dataset
        then starts from its own position."""
        manifest = self._read_manifest(step)
        reason = None
        if manifest is None:
            reason, manifest = "no readable manifest for step", {}
        cursor = manifest.get("data_cursor")
        if reason is None and cursor is None:
            reason = "manifest has no data cursor (pre-cursor save)"
        if reason is None and \
                manifest.get("data_cursor_crc32") != _cursor_crc(cursor):
            reason, cursor = "data cursor checksum mismatch", None
        if reason is not None:
            log.warning("resuming step %d without a verified data cursor "
                        "(%s): earlier batches may be re-consumed",
                        step, reason)
            events.event("unverified_data_cursor", step=step, reason=reason)
            return None
        return cursor

    # -- save ----------------------------------------------------------------
    def _write(self, step: int, payload: dict, data_cursor: dict | None,
               topology: dict) -> None:
        """Write ``payload`` as step ``step``: a temporary directory,
        renamed into place, then the manifest, then the pruning."""
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, _STATE_FILE)
        with open(path, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        if _verify_enabled():
            self._write_manifest(step, data_cursor, topology)
        self._prune()

    def _write_in_thread(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:  # re-raised by the next _join
            self._writer_error = e

    def _join(self) -> None:
        """Wait for the writer thread; re-raise what it raised."""
        w, self._writer = self._writer, None
        if w is not None:
            w.join()
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    def save(self, step: int, state: Any, wait: bool = False,
             data_cursor: dict | None = None) -> None:
        """Save ``state`` (model, optimizer, step) as step ``step``. Every
        tensor is on the host when this returns; with ``async_save`` and
        not ``wait`` the file is written by a writer thread. In a gang
        rank 0 writes and waits, and every rank returns once the step's
        manifest is committed."""
        with events.span("checkpoint_save", step=step, wait=wait):
            chaos.fire("checkpoint_save", step=step)
            self._join()
            if self.rank == 0:
                model_sd = state.model.state_dict()
                payload = _to_host({"model": model_sd,
                                    "optimizer": state.optimizer.state_dict(),
                                    "step": int(state.step)})
                topology = _topology(model_sd, self.world_size)
                args = (int(step), payload, data_cursor, topology)
                if self.async_save and not wait and self.group is None:
                    self._writer = threading.Thread(
                        target=self._write_in_thread, args=args,
                        name=f"sparkdl-ckpt-{step}", daemon=True)
                    self._writer.start()
                else:
                    self._write(*args)
            if self.group is not None:
                dist.barrier(group=self.group)

    # -- restore -------------------------------------------------------------
    def _load(self, step: int) -> dict:
        return torch.load(os.path.join(self._step_dir(step), _STATE_FILE),
                          map_location="cpu", weights_only=True)

    def _mismatches(self, step: int, payload: dict, state: Any) -> list:
        """Every way the checkpoint does not fit ``state``'s model: the
        manifest's world size, missing and unexpected tensors, shapes,
        dtypes. Buffers absent from the checkpoint are not a mismatch
        (the legacy path: the model keeps its own)."""
        out = []
        topo = (self._read_manifest(step) or {}).get("topology") or {}
        ws = topo.get("world_size")
        if ws is not None and int(ws) != self.world_size:
            out.append(f"saved at world size {ws}, restoring at "
                       f"{self.world_size}")
        own = state.model.state_dict()
        saved = payload["model"]
        buffers = {k for k, _ in state.model.named_buffers()}
        for k in sorted(set(own) - set(saved) - buffers):
            out.append(f"missing {k}")
        for k in sorted(set(saved) - set(own)):
            out.append(f"unexpected {k}")
        for k in sorted(set(own) & set(saved)):
            a, b = _spec(saved[k]), _spec(own[k])
            if a != b:
                out.append(f"{k}: saved {tuple(a[0])} {a[1]}, model "
                           f"{tuple(b[0])} {b[1]}")
        return out

    def _restore_step(self, step: int, state: Any) -> Any:
        with events.span("checkpoint_restore", step=step):
            payload = self._load(step)
            mism = self._mismatches(step, payload, state)
            # the gang's state is replicated, the same on every rank: a
            # checkpoint from another world size and nothing else fits
            # as it is, and an elastic run takes it
            resized = len(mism) == 1 and mism[0].startswith(
                "saved at world size") and failures.elastic_enabled()
            if mism and not resized:
                raise CheckpointTopologyError(step, mism)
            state.model.load_state_dict(payload["model"], strict=False)
            state.optimizer.load_state_dict(payload["optimizer"])
            state.step = int(payload["step"])
        if resized:
            events.event("checkpoint_resharded", step=step,
                         mismatch=mism[0])
            log.warning("checkpoint step %d restored across a topology "
                        "change (%s); the replicated state loads as it is",
                        step, mism[0])
        return state

    def restore(self, state_template: Any, step: int | None = None) -> Any:
        """Load a step into ``state_template`` (a fresh ``TrainState``: its
        model and optimizer are updated in place) and return it.

        With manifests present the step is verified first. A corrupt or
        uncommitted step is quarantined, and when ``step`` was not named
        the restore falls back to the newest verified step, recording the
        rollback. A named step that fails verification raises
        :class:`CheckpointCorruptionError`. In a gang rank 0 chooses the
        step (and raises what it raises on every rank) and every rank
        loads it. The ``checkpoint_restore`` chaos site fires first (its
        ``corrupt`` kind damages the newest step on disk)."""
        self._join()
        chaos.fire("checkpoint_restore", step=step, path=self.directory)
        if self.group is None:
            return self._restore_step(self._choose(step), state_template)
        chosen: list = [None]
        if self.rank == 0:
            try:
                chosen[0] = self._choose(step)
            except Exception as e:  # every rank raises it, not rank 0 alone
                chosen[0] = e
        dist.broadcast_object_list(chosen, src=0, group=self.group)
        if isinstance(chosen[0], Exception):
            raise chosen[0]
        return self._restore_step(chosen[0], state_template)

    def _choose(self, step: int | None) -> int:
        """The step a restore loads: ``step`` (or the newest), verified
        against its manifest where manifests are on; a corrupt or
        uncommitted newer step is quarantined and, when ``step`` was not
        named, the restore rolls back to the newest verified one
        (recorded)."""
        requested = step
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"No checkpoint in {self.directory}")
        if not self._manifest_mode():
            return step
        first = step
        candidates = [s for s in sorted(self._disk_steps(), reverse=True)
                      if s <= step]
        if step not in candidates:
            candidates.insert(0, step)  # verify (and report) it anyway
        manifested = {s for s in candidates
                      if os.path.exists(self._manifest_path(s))}
        newest_manifested = max(manifested, default=None)
        for s in candidates:
            if s not in manifested:
                if newest_manifested is not None and s > newest_manifested:
                    # newer than the newest certified save: a save that
                    # landed but was never committed
                    self.quarantine_step(
                        s, "no manifest (uncommitted partial save)")
                    if requested is not None:
                        raise CheckpointCorruptionError(
                            f"requested checkpoint step {requested} has no "
                            "manifest (uncommitted partial save); "
                            "quarantined")
                    continue
                # older than a certified save: saved before manifests were
                # on, a valid restore point
                log.warning("restoring pre-manifest checkpoint step %d "
                            "unverified (saved before manifest support)", s)
            else:
                ok, reason = self.verify_step(s)
                if not ok:
                    self.quarantine_step(s, reason)
                    if requested is not None:
                        raise CheckpointCorruptionError(
                            f"requested checkpoint step {requested} failed "
                            f"verification ({reason}); quarantined")
                    continue
            if s != first:
                events.event("checkpoint_rollback", from_step=first,
                              to_step=s)
                metrics_lib.run_stats.record_rollback(
                    first, s, "corrupt checkpoint quarantined")
                log.warning("checkpoint rollback: step %d corrupt, "
                            "restored verified step %d", first, s)
            return s
        raise CheckpointCorruptionError(
            f"no verified checkpoint left in {self.directory} (newest "
            f"was step {first}; all candidates quarantined)")

    def wait(self) -> None:
        """Block until an in-flight save has landed and its manifest is
        committed. Idempotent; a no-op before the first save and after
        ``close()``."""
        if not self._closed:
            self._join()

    def close(self) -> None:
        """Finish an in-flight save. Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            self._join()
        except Exception:
            log.warning("checkpoint finalize during close failed",
                        exc_info=True)


def _flatten(tree, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + "/")
        else:
            yield name, v


def save_portable(params: Any, path: str) -> None:
    """A single-file weight export: a module's ``state_dict()`` or a
    nested dict of tensors (or numpy arrays), flattened to ``a/b/c`` names,
    written with ``torch.save``."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    flat = {k: torch.as_tensor(v).detach().to("cpu", copy=True)
            for k, v in _flatten(params)}
    torch.save(flat, path)


def load_portable(params_template: Any, path: str) -> dict:
    """Load a :func:`save_portable` file into the template's structure (a
    nested dict of tensors or arrays); returns a nested dict of tensors.
    Every missing key, unexpected key and shape mismatch is reported in
    one ``ValueError``."""
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    flat = dict(_flatten(params_template))
    missing = sorted(k for k in flat if k not in loaded)
    extra = sorted(k for k in loaded if k not in flat)
    mismatched = []
    out: dict = {}
    for k, tmpl in flat.items():
        if k not in loaded:
            continue
        t = loaded[k]
        if tuple(t.shape) != tuple(tmpl.shape):
            mismatched.append(f"{k}: file has {tuple(t.shape)}, "
                              f"template needs {tuple(tmpl.shape)}")
            continue
        node = out
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    if missing or extra or mismatched:
        parts = []
        if missing:
            parts.append(f"missing keys ({len(missing)}): "
                         + ", ".join(missing))
        if extra:
            parts.append(f"unexpected keys ({len(extra)}): "
                         + ", ".join(extra))
        if mismatched:
            parts.append(f"shape mismatches ({len(mismatched)}): "
                         + "; ".join(mismatched))
        raise ValueError(f"load_portable({path}): " + " | ".join(parts))
    return out
