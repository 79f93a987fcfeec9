"""Typed ML parameter system — the configuration contract of the framework.

This re-creates, from scratch and in pure Python, the behavioral contract of the
Spark ML ``Params`` system that the reference library builds every transformer and
estimator on (reference: ``python/sparkdl/param/`` — shared param mixins, type
converters, and the ``keyword_only`` constructor pattern; see SURVEY.md §2.1/§5.6.
The reference mount was empty at build time, so citations are to the survey's
expected upstream layout rather than file:line).

The port's copy of ``sparkdl_tpu/core/params.py`` (framework-free there
too).

Design notes:
- A ``Param`` is a *descriptor-like value object* owned by a ``Params`` class; the
  instance-level value lives in ``Params._paramMap`` and defaults in
  ``Params._defaultParamMap`` — exactly the split Spark ML uses, because the
  ``copy()``/``extractParamMap()``/param-map-override semantics of ``fit(df,
  params)`` depend on it.
- ``TypeConverters`` are plain functions raising ``TypeError`` on bad input, so
  ``set()`` fails eagerly at the driver rather than inside a compiled step.
"""

from __future__ import annotations

import copy as _copy
import functools
import inspect
import uuid
from typing import Any, Callable


class Param:
    """A named, documented, typed parameter owned by a :class:`Params` instance.

    Identity semantics matter: two ``Param`` objects are equal iff their parent
    *instance uid* and name match, so param maps keyed by ``Param`` survive
    ``copy()`` correctly.
    """

    def __init__(self, parent: "Params", name: str, doc: str,
                 typeConverter: Callable[[Any], Any] | None = None):
        self.parent = parent.uid if isinstance(parent, Params) else parent
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter or TypeConverters.identity

    def _copy_new_parent(self, parent: "Params") -> "Param":
        p = _copy.copy(self)
        p.parent = parent.uid
        return p

    def __str__(self) -> str:
        return f"{self.parent}__{self.name}"

    def __repr__(self) -> str:
        return f"Param(parent={self.parent!r}, name={self.name!r}, doc={self.doc!r})"

    def __hash__(self) -> int:
        return hash(str(self))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Param) and str(self) == str(other)


class TypeConverters:
    """Eager type validation/coercion for param values.

    Mirrors the role of ``SparkDLTypeConverters`` + Spark's ``TypeConverters``
    (reference: ``python/sparkdl/param/converters.py``): catch config errors at
    ``set()`` time on the driver.
    """

    @staticmethod
    def identity(value):
        return value

    @staticmethod
    def toInt(value):
        if isinstance(value, bool):
            raise TypeError(f"Could not convert {value!r} to int")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        raise TypeError(f"Could not convert {value!r} to int")

    @staticmethod
    def toFloat(value):
        if isinstance(value, bool):
            raise TypeError(f"Could not convert {value!r} to float")
        if isinstance(value, (int, float)):
            return float(value)
        raise TypeError(f"Could not convert {value!r} to float")

    @staticmethod
    def toBoolean(value):
        if isinstance(value, bool):
            return value
        raise TypeError(f"Could not convert {value!r} to bool")

    @staticmethod
    def toString(value):
        if isinstance(value, str):
            return value
        raise TypeError(f"Could not convert {value!r} to str")

    @staticmethod
    def toList(value):
        if isinstance(value, (list, tuple)):
            return list(value)
        raise TypeError(f"Could not convert {value!r} to list")

    @staticmethod
    def toListInt(value):
        return [TypeConverters.toInt(v) for v in TypeConverters.toList(value)]

    @staticmethod
    def toListFloat(value):
        return [TypeConverters.toFloat(v) for v in TypeConverters.toList(value)]

    @staticmethod
    def toListString(value):
        return [TypeConverters.toString(v) for v in TypeConverters.toList(value)]

    @staticmethod
    def toCallable(value):
        if callable(value):
            return value
        raise TypeError(f"Expected a callable, got {value!r}")

    @staticmethod
    def toShape(value):
        """A tuple of positive ints — tensor shapes are config, and each
        distinct shape is one runner signature, so validate hard here."""
        shape = tuple(TypeConverters.toInt(v) for v in TypeConverters.toList(value))
        if any(d <= 0 for d in shape):
            raise TypeError(f"Shape dims must be positive, got {shape}")
        return shape


def _gen_uid(cls_name: str) -> str:
    # Random suffix (not a per-process counter): persisted uids from another
    # process must not collide with freshly constructed instances, or the
    # uid-based param-ownership checks silently cross wires.
    return f"{cls_name}_{uuid.uuid4().hex[:12]}"


def keyword_only(func):
    """Force keyword-only construction and stash kwargs in ``self._input_kwargs``.

    This is the constructor pattern every reference transformer uses
    (``@keyword_only`` on ``__init__`` and ``setParams``); preserved verbatim
    because ``setParams(**kwargs)`` round-tripping depends on it.
    """

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        if args:
            raise TypeError(f"{func.__name__} accepts keyword arguments only")
        self._input_kwargs = kwargs
        return func(self, **kwargs)

    return wrapper


class Params:
    """Base class carrying the param map machinery.

    Contract (matching Spark ML, which the reference's API surface promises):
    ``params``, ``getParam``, ``hasParam``, ``isSet``, ``isDefined``, ``set``,
    ``getOrDefault``, ``extractParamMap``, ``copy(extra)``, ``clear``,
    ``explainParam``/``explainParams``, ``hasDefault``, ``getDefault``.
    """

    def __init__(self):
        self.uid = _gen_uid(type(self).__name__)
        self._paramMap: dict[Param, Any] = {}
        self._defaultParamMap: dict[Param, Any] = {}
        self._params_cache: list[Param] | None = None
        self._copy_params_from_class()

    def _copy_params_from_class(self):
        """Re-bind class-level Param templates to this instance's uid."""
        for name in dir(type(self)):
            if name.startswith("__"):
                continue
            attr = inspect.getattr_static(type(self), name, None)
            if isinstance(attr, Param):
                setattr(self, name, attr._copy_new_parent(self))

    # -- introspection -----------------------------------------------------
    @property
    def params(self) -> list[Param]:
        if self._params_cache is None:
            seen = {}
            for name in dir(self):
                if name.startswith("__") or name in ("params",):
                    continue
                attr = inspect.getattr_static(self, name, None)
                if isinstance(attr, Param):
                    seen[attr.name] = getattr(self, name)
            self._params_cache = sorted(seen.values(), key=lambda p: p.name)
        return self._params_cache

    def hasParam(self, name: str) -> bool:
        return any(p.name == name for p in self.params)

    def getParam(self, name: str) -> Param:
        for p in self.params:
            if p.name == name:
                return p
        raise ValueError(f"{self.uid} has no param {name!r}")

    def _resolveParam(self, param: Param | str) -> Param:
        if isinstance(param, str):
            return self.getParam(param)
        if param.parent != self.uid:
            raise ValueError(
                f"Param {param} does not belong to {self.uid}")
        return param

    # -- state -------------------------------------------------------------
    def isSet(self, param: Param | str) -> bool:
        return self._resolveParam(param) in self._paramMap

    def hasDefault(self, param: Param | str) -> bool:
        return self._resolveParam(param) in self._defaultParamMap

    def isDefined(self, param: Param | str) -> bool:
        return self.isSet(param) or self.hasDefault(param)

    def getDefault(self, param: Param | str):
        return self._defaultParamMap[self._resolveParam(param)]

    def set(self, param: Param | str, value):
        p = self._resolveParam(param)
        self._paramMap[p] = p.typeConverter(value)
        return self

    def _set(self, **kwargs):
        for name, value in kwargs.items():
            if value is None:
                continue
            p = self.getParam(name)
            self._paramMap[p] = p.typeConverter(value)
        return self

    def _setDefault(self, **kwargs):
        for name, value in kwargs.items():
            p = self.getParam(name)
            if value is not None:
                value = p.typeConverter(value)
            self._defaultParamMap[p] = value
        return self

    def clear(self, param: Param | str):
        self._paramMap.pop(self._resolveParam(param), None)
        return self

    def getOrDefault(self, param: Param | str):
        p = self._resolveParam(param)
        if p in self._paramMap:
            return self._paramMap[p]
        if p in self._defaultParamMap:
            return self._defaultParamMap[p]
        raise KeyError(f"Param {p.name!r} is not set and has no default")

    # ``getOrDefault`` is the canonical accessor name; Spark also exposes it as
    # ``transformer.getInputCol()`` etc. via the shared mixins below.

    def extractParamMap(self, extra: dict | None = None) -> dict[Param, Any]:
        m = dict(self._defaultParamMap)
        m.update(self._paramMap)
        if extra:
            for p, v in extra.items():
                m[self._resolveParam(p)] = v
        return m

    def copy(self, extra: dict | None = None):
        """Deep-ish copy: new object, same uid (Spark semantics — a copy is the
        *same stage* with possibly-overridden params, so uid is preserved).

        ``extra`` may contain params owned by *other* stages; they are ignored
        here (Spark semantics) so that one param map can be handed to a whole
        Pipeline and each stage picks out its own entries."""
        that = _copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        that._params_cache = None
        if extra:
            for p, v in extra.items():
                if isinstance(p, str):
                    p = self.getParam(p)
                if isinstance(p, Param) and p.parent == self.uid:
                    that._paramMap[that.getParam(p.name)] = p.typeConverter(v)
        return that

    # -- docs --------------------------------------------------------------
    def explainParam(self, param: Param | str) -> str:
        p = self._resolveParam(param)
        if self.isSet(p):
            state = f"current: {self._paramMap[p]}"
            if self.hasDefault(p):
                state = f"default: {self._defaultParamMap[p]}, " + state
        elif self.hasDefault(p):
            state = f"default: {self._defaultParamMap[p]}"
        else:
            state = "undefined"
        return f"{p.name}: {p.doc} ({state})"

    def explainParams(self) -> str:
        return "\n".join(self.explainParam(p) for p in self.params)

    # -- persistence helpers (used by core.pipeline MLWritable machinery) ---
    def _param_values_for_save(self) -> dict[str, Any]:
        return {p.name: v for p, v in self._paramMap.items()}

    def _default_values_for_save(self) -> dict[str, Any]:
        return {p.name: v for p, v in self._defaultParamMap.items()}


# ---------------------------------------------------------------------------
# Shared param mixins — the vocabulary every transformer/estimator speaks.
# Reference: python/sparkdl/param/shared_params.py (HasInputCol, HasOutputCol,
# keras model/optimizer/loss params, CanLoadImage). [SURVEY §2.1]
# ---------------------------------------------------------------------------

class HasInputCol(Params):
    inputCol = Param(Params, "inputCol", "name of the input column",
                     TypeConverters.toString)

    def setInputCol(self, value):
        return self._set(inputCol=value)

    def getInputCol(self):
        return self.getOrDefault(self.inputCol)


class HasOutputCol(Params):
    outputCol = Param(Params, "outputCol", "name of the output column",
                      TypeConverters.toString)

    def setOutputCol(self, value):
        return self._set(outputCol=value)

    def getOutputCol(self):
        return self.getOrDefault(self.outputCol)


class HasLabelCol(Params):
    labelCol = Param(Params, "labelCol", "name of the label column",
                     TypeConverters.toString)

    def setLabelCol(self, value):
        return self._set(labelCol=value)

    def getLabelCol(self):
        return self.getOrDefault(self.labelCol)


class HasPredictionCol(Params):
    predictionCol = Param(Params, "predictionCol", "name of the prediction column",
                          TypeConverters.toString)

    def setPredictionCol(self, value):
        return self._set(predictionCol=value)

    def getPredictionCol(self):
        return self.getOrDefault(self.predictionCol)


class HasBatchSize(Params):
    """Batch size is a static shape of the device step (every batch is
    padded to it, so a runner sees one signature); it is a param here, not
    a runtime knob, by design."""
    batchSize = Param(Params, "batchSize", "per-device batch size (static)",
                      TypeConverters.toInt)

    def setBatchSize(self, value):
        return self._set(batchSize=value)

    def getBatchSize(self):
        return self.getOrDefault(self.batchSize)


class HasOnError(Params):
    """Scoring failure mode for host-side decode/payload errors:
    ``'raise'`` (default — one corrupt row kills the job, the pre-fault-
    tolerance behavior) or ``'quarantine'`` (bad rows route to a
    dead-letter side output with ``error_class``/``error`` columns —
    Spark-style task isolation; read it back via ``deadLetters()`` after
    materialization, bounded by ``SPARKDL_MAX_QUARANTINE_FRAC``)."""
    onError = Param(Params, "onError", "host-side decode failure mode: "
                    "'raise' or 'quarantine' (dead-letter side output)",
                    TypeConverters.toString)

    def setOnError(self, value):
        if value not in ("raise", "quarantine"):
            raise ValueError(f"onError must be 'raise' or 'quarantine', "
                             f"got {value!r}")
        return self._set(onError=value)

    def getOnError(self):
        return (self.getOrDefault(self.onError)
                if self.isSet(self.onError) or self.hasDefault(self.onError)
                else "raise")

    def deadLetters(self):
        """The dead-letter output of this stage's most recent materialized
        ``transform`` pass that quarantined at least one row: a
        ``pyarrow.Table`` of the quarantined input rows +
        ``error_class``/``error`` columns, with a stable schema even when
        empty (clean passes — including the 1-row schema probe
        ``DataFrame.schema`` runs — never wipe it). None before any
        quarantining transform ran."""
        sink = getattr(self, "_quarantine_sink", None)
        return sink.to_table() if sink is not None else None


class HasSeed(Params):
    seed = Param(Params, "seed", "PRNG seed (seeds the torch.Generator of init)",
                 TypeConverters.toInt)

    def setSeed(self, value):
        return self._set(seed=value)

    def getSeed(self):
        return self.getOrDefault(self.seed)


class HasDevice(Params):
    """The torch device a stage computes on (the port's addition to the
    shared params): unset → the card (``utils.platform.resolve_device``
    turns ``None`` into ``cuda`` and raises when there is none); the CPU
    must be asked for with ``device="cpu"``."""
    device = Param(Params, "device", "torch device the stage computes on: "
                   "unset → cuda (raises without a card); 'cpu' on request",
                   TypeConverters.toString)

    def setDevice(self, value):
        return self._set(device=value)

    def getDevice(self) -> str | None:
        return self.getOrDefault(self.device) \
            if self.isDefined(self.device) else None

    def _torch_device(self):
        from ..utils.platform import resolve_device
        return resolve_device(self.getDevice())
