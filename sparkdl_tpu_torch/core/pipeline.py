"""Transformer / Estimator / Pipeline — the Spark-ML-shaped API surface.

Re-creates the ML Pipeline contract the reference library plugs into (its
transformers are ``pyspark.ml.Transformer`` subclasses and its estimator is a
``pyspark.ml.Estimator``; SURVEY.md §2.1/§5.6). pyspark is not available in this
environment, and the execution substrate is PyTorch on a CUDA card, not a
JVM — so this module (the port's copy of ``sparkdl_tpu/core/pipeline.py``)
provides the same *behavioral* API (``fit``,
``transform``, ``fit(df, params=...)`` param-map overrides, ``fitMultiple`` for
hyperparameter parallelism, ``Pipeline``/``PipelineModel`` chaining, and
``save``/``load`` persistence) over the Arrow-native :mod:`sparkdl_tpu_torch.core.frame`
DataFrame.

Persistence format: a directory per stage with ``metadata.json`` holding
{class, uid, paramMap, defaultParamMap} plus an optional binary payload the
subclass writes (weights as ``torch.save`` state dicts). Matches the *shape* of Spark
ML's MLWriter layout (metadata/ + stage subdirs) without the Hadoop paths.
"""

from __future__ import annotations

import abc
import concurrent.futures
import importlib
import json
import os
from abc import abstractmethod
from typing import Any, Iterator

from .params import Param, Params


def _json_default(value):
    # Param values that are tuples (shapes) serialize as lists; callables and
    # models are not JSON-serializable and must be handled by subclass
    # _save_payload/_load_payload hooks.
    if isinstance(value, tuple):
        return list(value)
    raise TypeError(f"Param value {value!r} is not JSON-serializable; "
                    "the owning stage must override _save_payload/_load_payload")


class MLWritable:
    """save()/load() persistence with a class registry keyed by module path."""

    _NON_JSON_SENTINEL = "__sparkdl_tpu_payload__"

    def save(self, path: str, overwrite: bool = False):
        if os.path.exists(path):
            if not overwrite:
                raise FileExistsError(
                    f"{path} already exists; pass overwrite=True to replace it")
        os.makedirs(path, exist_ok=True)
        json_params, payload_params = {}, []
        for name, value in self._param_values_for_save().items():
            if _is_jsonable(value):
                json_params[name] = value
            else:
                payload_params.append(name)
        meta = {
            "class": f"{type(self).__module__}.{type(self).__qualname__}",
            "uid": self.uid,
            "paramMap": json_params,
            "payloadParams": payload_params,
            "defaultParamMap": {
                k: v for k, v in self._default_values_for_save().items()
                if _is_jsonable(v)
            },
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f, indent=2, default=_json_default)
        self._save_payload(path)

    @classmethod
    def load(cls, path: str):
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        module, _, qualname = meta["class"].rpartition(".")
        klass = getattr(importlib.import_module(module), qualname)
        obj = klass.__new__(klass)
        Params.__init__(obj)
        obj.uid = meta["uid"]
        # Params were bound against the freshly-generated uid; re-bind them to
        # the persisted uid so _resolveParam ownership checks hold.
        obj._copy_params_from_class()
        obj._params_cache = None
        for name, value in meta["defaultParamMap"].items():
            if obj.hasParam(name):
                obj._setDefault(**{name: value})
        for name, value in meta["paramMap"].items():
            obj._set(**{name: value})
        obj._load_payload(path, meta)
        missing = [n for n in meta.get("payloadParams", [])
                   if obj.hasParam(n) and not obj.isSet(n)]
        if missing:
            raise ValueError(
                f"{meta['class']} saved non-JSON params {missing} but its "
                "_load_payload did not restore them — the class must override "
                "_save_payload/_load_payload for these values")
        return obj

    def _save_payload(self, path: str):
        """Hook: subclasses persist non-JSON param values / weights here."""

    def _load_payload(self, path: str, meta: dict):
        """Hook: subclasses restore what _save_payload wrote."""


def _is_jsonable(v) -> bool:
    try:
        json.dumps(v, default=_json_default)
        return True
    except TypeError:
        return False


class Transformer(Params, MLWritable, abc.ABC):
    """A stage mapping DataFrame → DataFrame.

    The typical concrete ``_transform`` builds one device step (a
    ``BatchRunner``) and drives it over Arrow record batches (the reference instead
    assembled a TF graph and handed it to TensorFrames per partition —
    SURVEY.md §3.1).
    """

    def transform(self, dataset, params: dict | None = None):
        if params:
            return self.copy(params)._transform(dataset)
        return self._transform(dataset)

    @abstractmethod
    def _transform(self, dataset):
        ...


class Estimator(Params, MLWritable, abc.ABC):
    """A stage that fits a :class:`Model` from a DataFrame."""

    def fit(self, dataset, params: dict | list | None = None):
        if isinstance(params, (list, tuple)):
            out: list = [None] * len(params)
            for i, model in self.fitMultiple(dataset, list(params)):
                out[i] = model
            return out
        if params:
            return self.copy(params)._fit(dataset)
        return self._fit(dataset)

    def fitMultiple(self, dataset, paramMaps: list[dict]) -> Iterator[tuple[int, Any]]:
        """Hyperparameter-parallel fitting (reference: ``fitMultiple`` on
        ``KerasImageFileEstimator``, SURVEY.md §2.1). Default: thread pool — each
        trial is an independent device program, so trials overlap host-side work
        with device execution."""
        if not paramMaps:
            return
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(len(paramMaps), os.cpu_count() or 4))

        def one(i):
            return i, self.copy(paramMaps[i])._fit(dataset)

        futures = [pool.submit(one, i) for i in range(len(paramMaps))]
        try:
            for fut in concurrent.futures.as_completed(futures):
                yield fut.result()
        finally:
            pool.shutdown(wait=False)

    @abstractmethod
    def _fit(self, dataset):
        ...


class Model(Transformer):
    """A fitted Transformer produced by an Estimator."""


class Evaluator(Params, abc.ABC):
    """Scores a transformed DataFrame — used by tuning (CrossValidator)."""

    def evaluate(self, dataset, params: dict | None = None) -> float:
        if params:
            return self.copy(params)._evaluate(dataset)
        return self._evaluate(dataset)

    @abstractmethod
    def _evaluate(self, dataset) -> float:
        ...

    def isLargerBetter(self) -> bool:
        return True


class Pipeline(Estimator):
    """Chain of stages; ``fit`` threads the DataFrame through, fitting each
    Estimator stage on the output of the previous stages' transforms."""

    stages = Param(Params, "stages", "pipeline stages (Transformers/Estimators)")

    def __init__(self, stages: list | None = None):
        super().__init__()
        if stages is not None:
            self.setStages(stages)

    def setStages(self, value: list):
        return self._set(stages=list(value))

    def getStages(self) -> list:
        return self.getOrDefault(self.stages)

    def _fit(self, dataset):
        stages = self.getStages()
        for s in stages:
            if not isinstance(s, (Transformer, Estimator)):
                raise TypeError(f"Pipeline stage {s!r} is neither a Transformer "
                                "nor an Estimator")
        # Everything after the last Estimator need not see training data.
        last_est = max((i for i, s in enumerate(stages)
                        if isinstance(s, Estimator)), default=-1)
        fitted: list[Transformer] = []
        df = dataset
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(df)
                fitted.append(model)
                if i < last_est:
                    df = model.transform(df)
            else:
                fitted.append(stage)
                if i < last_est:
                    df = stage.transform(df)
        return PipelineModel(fitted)

    def copy(self, extra: dict | None = None):
        """Stage-owned params in ``extra`` flow into the matching stage —
        the Spark Pipeline contract behind fit(df, params={stage.p: v})."""
        that = super().copy(extra)
        if self.isDefined(self.stages):
            that._paramMap[that.getParam("stages")] = [
                s.copy(extra) for s in self.getStages()]
        return that

    def _save_payload(self, path: str):
        stages = self.getOrDefault(self.stages) if self.isDefined(self.stages) else []
        _save_stages(path, stages)

    def _load_payload(self, path: str, meta: dict):
        self._set(stages=_load_stages(path))


class PipelineModel(Model):
    """The fitted pipeline: transform = composition of stage transforms."""

    def __init__(self, stages: list[Transformer] | None = None):
        super().__init__()
        self.stages = stages or []

    def _transform(self, dataset):
        df = dataset
        for stage in self.stages:
            df = stage.transform(df)
        return df

    def copy(self, extra: dict | None = None):
        that = super().copy(extra)
        that.stages = [s.copy(extra) for s in self.stages]
        return that

    def _param_values_for_save(self):
        return {}

    def _save_payload(self, path: str):
        _save_stages(path, self.stages)

    def _load_payload(self, path: str, meta: dict):
        self.stages = _load_stages(path)


def _save_stages(path: str, stages: list):
    stage_dir = os.path.join(path, "stages")
    os.makedirs(stage_dir, exist_ok=True)
    manifest = []
    for i, stage in enumerate(stages):
        name = f"{i:03d}_{stage.uid}"
        stage.save(os.path.join(stage_dir, name), overwrite=True)
        manifest.append(name)
    with open(os.path.join(stage_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _load_stages(path: str) -> list:
    stage_dir = os.path.join(path, "stages")
    with open(os.path.join(stage_dir, "manifest.json")) as f:
        manifest = json.load(f)
    return [MLWritable.load(os.path.join(stage_dir, name)) for name in manifest]


def load(path: str):
    """Module-level loader mirroring ``PipelineModel.load`` ergonomics."""
    return MLWritable.load(path)
