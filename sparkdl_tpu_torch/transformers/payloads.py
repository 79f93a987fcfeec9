"""Shared persistence helper: params whose values are callables.

Callable params (jittable fns, image loaders) can't go in metadata.json;
subclasses list them in ``_pickled_params`` and this mixin cloudpickles each
set value into ``<name>.pkl`` beside the stage metadata.
"""

from __future__ import annotations

import os


class PicklesCallableParams:
    _pickled_params: tuple[str, ...] = ()

    def _save_payload(self, path: str):
        import cloudpickle
        for name in self._pickled_params:
            if self.isSet(name):
                with open(os.path.join(path, f"{name}.pkl"), "wb") as f:
                    cloudpickle.dump(self.getOrDefault(name), f)

    def _load_payload(self, path: str, meta: dict):
        import cloudpickle
        for name in self._pickled_params:
            fpath = os.path.join(path, f"{name}.pkl")
            if os.path.exists(fpath):
                with open(fpath, "rb") as f:
                    self._set(**{name: cloudpickle.load(f)})


class BundlesModelFile:
    """Persistence mixin for stages with a ``modelFile`` path param: save()
    copies the model file INTO the stage directory and load() rebinds the
    param to the bundled copy — a fitted transformer whose modelFile points
    at a temp dir (KerasImageFileEstimator._fit) survives process exit,
    host moves, and temp-dir cleanup (SURVEY.md §5.4 durability).

    MRO note: place before PicklesCallableParams so both payload hooks run
    (each calls super())."""

    _MODEL_EXTS = (".keras", ".h5", ".hdf5")

    def _save_payload(self, path: str):
        super()._save_payload(path)
        if self.isDefined("modelFile"):
            import shutil
            src = self.getOrDefault("modelFile")
            ext = os.path.splitext(src)[1]
            # Fail LOUDLY here, not at load time on another host: a save()
            # that silently skips the model file is exactly the
            # non-durability this mixin exists to prevent.
            if not os.path.exists(src):
                raise FileNotFoundError(
                    f"save(): modelFile {src!r} no longer exists — the "
                    f"stage cannot be persisted durably")
            if ext not in self._MODEL_EXTS:
                raise ValueError(
                    f"save(): modelFile extension {ext!r} not one of "
                    f"{self._MODEL_EXTS}; load() would not find the bundle")
            shutil.copyfile(src, os.path.join(path, "model" + ext))

    def _load_payload(self, path: str, meta: dict):
        super()._load_payload(path, meta)
        for ext in self._MODEL_EXTS:
            bundled = os.path.join(path, "model" + ext)
            if os.path.exists(bundled):
                self._set(modelFile=bundled)
                break
