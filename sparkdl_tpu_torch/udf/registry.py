"""UDF registry — named, reusable column functions over DataFrames.

The counterpart of ``sparkdl_tpu/udf/registry.py``: a process-global
registry of named batch functions applied to a DataFrame column by
``applyUDF(df, name, inputCol, outputCol)``.

- :func:`registerUDF` — a torch callable over a numeric array column,
  through ``transformers.tensor.XlaTransformer``;
- :func:`registerImageUDF` — a torch callable over an image column,
  through ``XlaImageTransformer``; :func:`registerKerasImageUDF` composes
  a named zoo model (random weights, as the reference's) behind it;
- :func:`registerGenerationUDF` — Llama generation over int token-id
  columns (the batch-inference half of BASELINE configuration 5), through
  ``models.llama.generate`` and ``left_pad_prompts``;
- :func:`registerTextGenerationUDF` — the same over text, with the
  caller's tokenizer halves;
- :func:`registerSequenceClassificationUDF` — a BERT-style classifier
  over token-id columns (the serving half of configuration 4), whose
  device step is :func:`classify_rows` (numpy in, numpy out).

The three share :func:`_streamed_token_apply`, the streamed data plane:
pending ops cached once, one pass for the column-wide max length, then
``batchRows`` chunks, a short tail filled with duplicate rows so every
chunk has one shape. The generation UDF calls ``generate()`` once a chunk;
each call captures its own decode graph on the card (ROADMAP.md A 1).

The DataFrame (pyarrow) is imported inside the functions that need it, so
this module, and :func:`classify_rows`, import without pyarrow. Every UDF
runs on the card unless ``device="cpu"`` is asked for (the port's
argument; the reference's signatures have none).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

_UDF_REGISTRY: dict[str, Callable] = {}


def registerUDF(name: str, fn: Callable, batchSize: int = 64,
                inputShape: tuple | None = None, device=None) -> None:
    """Register a torch ``fn(batch)`` over numeric array columns
    (``(N, ...)`` float32 tensors on ``device``)."""
    from ..transformers.tensor import XlaTransformer

    def stage(inputCol: str, outputCol: str):
        return XlaTransformer(inputCol=inputCol, outputCol=outputCol, fn=fn,
                              batchSize=batchSize, device=device,
                              **({"inputShape": inputShape} if inputShape
                                 else {}))

    def apply(df, inputCol: str, outputCol: str):
        return stage(inputCol, outputCol).transform(df)

    apply.stage = stage
    _UDF_REGISTRY[name] = apply


def registerImageUDF(name: str, fn: Callable, inputSize: tuple[int, int],
                     batchSize: int = 32, channelOrder: str = "RGB",
                     device=None) -> None:
    """Register a torch ``fn(nhwc_batch)`` over image-struct columns
    (float32 NHWC in [0, 255], resized to ``inputSize``)."""
    from ..transformers.xla_image import XlaImageTransformer

    def stage(inputCol: str, outputCol: str):
        return XlaImageTransformer(inputCol=inputCol, outputCol=outputCol,
                                   fn=fn, inputSize=inputSize,
                                   batchSize=batchSize,
                                   channelOrder=channelOrder, device=device)

    def apply(df, inputCol: str, outputCol: str):
        return stage(inputCol, outputCol).transform(df)

    apply.stage = stage
    _UDF_REGISTRY[name] = apply


def registerKerasImageUDF(udf_name: str, keras_model_or_file,
                          preprocessor: Callable | None = None,
                          batchSize: int = 32, device=None) -> None:
    """The reference's flagship UDF: image decode ∘ (``preprocessor``) ∘
    model, registered under ``udf_name``.

    ``keras_model_or_file``: a Keras-3 model object (torch backend, its
    variables on ``device``), a saved-model path (loaded on ``device``
    through ``transformers.keras_utils``), or a named zoo model
    (``models.SUPPORTED_MODELS``, e.g. ``"InceptionV3"``: built at random
    weights from seed 0, as the reference's — nothing is downloaded —
    its logits over its own preprocessing at its input size). The input
    size of a Keras model is its input layer's.
    ``preprocessor`` is a torch NHWC → NHWC function run in front of the
    model in the same device step."""
    from ..models.registry import SUPPORTED_MODELS
    from ..transformers.keras_utils import (keras_model_to_fn,
                                            load_keras_model)
    from ..utils.platform import resolve_device

    if isinstance(keras_model_or_file, str) \
            and keras_model_or_file in SUPPORTED_MODELS:
        spec = SUPPORTED_MODELS[keras_model_or_file]
        base_fn = spec.apply_fn(spec.build(seed=0,
                                           device=resolve_device(device)))
        input_hw = spec.input_size
    else:
        model = (load_keras_model(keras_model_or_file, device=device)
                 if isinstance(keras_model_or_file, str)
                 else keras_model_or_file)
        base_fn = keras_model_to_fn(model, device=device)
        shape = model.inputs[0].shape
        input_hw = (int(shape[1]), int(shape[2]))
    fn = (lambda b: base_fn(preprocessor(b))) if preprocessor else base_fn
    registerImageUDF(udf_name, fn, inputSize=input_hw,
                     batchSize=batchSize, device=device)


def _with_weights(model, variables, params_dtype, load):
    """``model`` with the JAX package's parameter tree ``variables`` loaded
    (by ``load``, into the model itself, as ``GenerationEngine.from_model``
    does) and, with ``params_dtype``, a copy of it with its matrices in
    that dtype (the caller's model keeps its weights)."""
    if variables is not None:
        load(model, variables)
    if params_dtype:
        from ..models.pretrained import cast_float_leaves
        model = cast_float_leaves(model, params_dtype)
    return model


def registerGenerationUDF(name: str, model, variables=None,
                          max_new_tokens: int = 32,
                          temperature: float = 0.0, seed: int = 0,
                          batchRows: int = 64, top_k: int = 0,
                          top_p: float = 1.0,
                          eos_id: int | None = None,
                          params_dtype: str | None = None) -> None:
    """Register a text-generation UDF over token-id columns.

    ``model``: the port's ``models.llama.LlamaModel`` (it holds its
    weights; ``variables``, when given, is a JAX-package parameter tree
    loaded into it). The column holds int token-id lists (prompts); the
    whole column is LEFT-padded to one length and runs in ``batchRows``
    chunks, one ``generate()`` call each, a short trailing chunk filled
    with duplicate rows (dropped from the output). Each row comes back as
    its prompt plus the new tokens; with ``eos_id`` the tail after the
    first eos is trimmed. Sampling (``temperature`` > 0) draws from one
    ``torch.Generator`` seeded with ``seed`` per ``applyUDF`` call.

    ``params_dtype="bfloat16"`` serves from a copy of the model with its
    weight matrices in bf16 (``models.pretrained.cast_float_leaves``)."""
    _UDF_REGISTRY[name] = _make_generation_apply(
        model, variables, max_new_tokens=max_new_tokens,
        temperature=temperature, seed=seed, batchRows=batchRows,
        top_k=top_k, top_p=top_p, eos_id=eos_id,
        params_dtype=params_dtype)


def _make_generation_apply(model, variables, *, max_new_tokens: int = 32,
                           temperature: float = 0.0, seed: int = 0,
                           batchRows: int = 64, top_k: int = 0,
                           top_p: float = 1.0,
                           eos_id: int | None = None,
                           params_dtype: str | None = None) -> Callable:
    """Build (and validate) the apply closure behind
    :func:`registerGenerationUDF`, shared with
    :func:`registerTextGenerationUDF`."""
    from ..models import llama as L

    # fail at registration, not on the first applyUDF call
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0 (0 disables), got {top_k}")
    if eos_id is not None and (isinstance(eos_id, bool)
                               or not isinstance(eos_id, (int, np.integer))):
        raise TypeError(f"eos_id must be an int token id or None, "
                        f"got {eos_id!r}")
    model = _with_weights(model, variables, params_dtype,
                          L.load_flax_params)

    def apply(df, inputCol: str, outputCol: str):
        import pyarrow as pa

        # one generator per call: deterministic for a given seed, and no
        # state shared between concurrent applyUDF calls
        gen = torch.Generator(device=model.device).manual_seed(seed)

        def compute(prompts, lmax, n_fill):
            return pa.array(generate_rows(
                model, prompts, lmax, max_new_tokens, n_fill=n_fill,
                temperature=temperature, generator=gen, top_k=top_k,
                top_p=top_p, eos_id=eos_id), type=pa.list_(pa.int64()))

        return _streamed_token_apply(df, inputCol, outputCol, batchRows,
                                     compute, pa.list_(pa.int64()))

    return apply


@torch.no_grad()
def generate_rows(model, prompts, max_len: int, max_new_tokens: int, *,
                  n_fill: int = 0, temperature: float = 0.0,
                  generator=None, top_k: int = 0, top_p: float = 1.0,
                  eos_id: int | None = None) -> list:
    """The generation UDFs' device step, one chunk: token-id lists →
    each row's prompt plus its new tokens (lists of ints). The prompts
    are left-padded to ``max_len`` with ``n_fill`` copies of the first
    row appended (dropped from the output) and run through one
    ``models.llama.generate`` call; with ``eos_id`` the tail after the
    first eos is trimmed."""
    from ..models import llama as L

    ids, pads = L.left_pad_prompts(prompts, pad_to=max_len)
    n = len(ids)
    if n_fill:
        ids = torch.cat([ids, ids[:1].expand(n_fill, -1)])
        pads = torch.cat([pads, pads[:1].expand(n_fill)])
    out_ids = L.generate(
        model, ids, max_new_tokens, temperature=temperature,
        generator=generator, pad_to=max_len + max_new_tokens,
        pad_lens=pads, top_k=top_k, top_p=top_p,
        eos_id=eos_id).cpu().numpy()
    pads = pads.numpy()
    out: list = []
    for row in range(n):
        # strip this row's left pads: real prompt + new tokens
        toks = out_ids[row, pads[row]:].tolist()
        if eos_id is not None:
            # trim the repeated-eos tail, keep one eos
            plen = len(prompts[row])
            gen_part = toks[plen:]
            if eos_id in gen_part:
                gen_part = gen_part[:gen_part.index(eos_id) + 1]
            toks = toks[:plen] + gen_part
        out.append(toks)
    return out


def _streamed_token_apply(df, inputCol: str, outputCol: str,
                          batchRows: int, compute: Callable, out_type):
    """The streamed data plane of the token-column UDFs (one source of
    truth for generation and sequence classification):

    - pending upstream ops are cached once (two passes must not run a
      tokenizer twice);
    - pass 1 walks the column in ``batchRows`` Arrow chunks reading
      lengths only (every row must be non-null and non-empty; an error
      names its global row index) to pin the column-wide max length;
    - pass 2 re-streams the chunks through ``compute(rows, max_len,
      n_fill) -> pa.Array`` (one entry a row); ``n_fill`` duplicate rows
      keep a short chunk of a multi-chunk column at the shape of the
      others (``compute`` appends and drops them). A column that fits in
      one chunk is not filled;
    - an empty column keeps the schema contract; the output restores the
      input's partition count.
    """
    import pyarrow as pa
    import pyarrow.compute as pc

    from ..core.frame import DataFrame, _set_column

    if df._ops:
        df = df.cache()
    max_len = 0
    n_rows = 0
    for batch in df.iterBatches(batchRows):
        col = batch.column(inputCol)
        if col.null_count:
            bad = n_rows + next(i for i, v in enumerate(col.to_pylist())
                                if v is None)
            raise ValueError(
                f"{inputCol!r} row {bad} is null; every row needs at "
                f"least one token id")
        lens = pc.list_value_length(col).to_numpy(zero_copy_only=False)
        if len(lens) and int(lens.min()) == 0:
            bad = n_rows + int(np.argmin(lens))
            raise ValueError(
                f"{inputCol!r} row {bad} is an empty prompt; every row "
                f"needs at least one token id")
        n_rows += len(lens)
        if len(lens):
            max_len = max(max_len, int(lens.max()))

    if n_rows == 0:  # keep the schema contract on an empty column
        tbl = df.toArrow()
        empty = pa.array([], type=out_type)
        if outputCol in tbl.column_names:  # replace, like _set_column
            tbl = tbl.set_column(tbl.column_names.index(outputCol),
                                 outputCol, empty)
        else:
            tbl = tbl.append_column(outputCol, empty)
        return DataFrame.fromArrow(
            tbl, numPartitions=max(1, df.numPartitions))

    out_parts = []
    for batch in df.iterBatches(batchRows):
        rows = batch.column(inputCol).to_pylist()
        n = len(rows)
        # fill a short chunk of a multi-chunk column (iterBatches: only
        # the last can be short) so every chunk has one shape
        n_fill = batchRows - n if (n < batchRows
                                   and n_rows > batchRows) else 0
        out = compute(rows, max_len, n_fill)
        if len(out) != n:
            raise RuntimeError(f"compute returned {len(out)} entries for "
                               f"{n} rows")
        out_parts.append(_set_column(batch, outputCol, out))
    return DataFrame(out_parts).repartition(df.numPartitions)


def registerTextGenerationUDF(name: str, model, variables=None,
                              encode: Callable[[str], list] = None,
                              decode: Callable[[list], str] = None,
                              **gen_kwargs) -> None:
    """String-column twin of :func:`registerGenerationUDF`: the column
    holds text prompts; ``encode`` / ``decode`` are the tokenizer halves.
    Tokenize → the streamed left-padded generation → detokenize (the
    prompt stripped from each completion). Accepts every
    :func:`registerGenerationUDF` keyword."""
    if not callable(encode) or not callable(decode):
        raise TypeError("encode and decode must be callables "
                        f"(got {encode!r}, {decode!r})")
    inner_apply = _make_generation_apply(model, variables, **gen_kwargs)

    def apply(df, inputCol: str, outputCol: str):
        ids_col = f"__{name}_ids"
        out_ids = f"__{name}_out_ids"
        with_ids = df.withColumn(
            ids_col, lambda s: [int(t) for t in encode(s)], [inputCol])
        try:
            gen = inner_apply(with_ids, ids_col, out_ids)
        except ValueError as e:
            # name the caller's column, not the hidden ids column
            raise ValueError(
                str(e).replace(repr(ids_col), repr(inputCol))) from None

        def detok(prompt_ids, completion_ids):
            return decode([int(t) for t in
                           completion_ids[len(prompt_ids):]])
        return gen.withColumn(outputCol, detok, [ids_col, out_ids]) \
                  .drop(ids_col, out_ids)

    _UDF_REGISTRY[name] = apply


def right_pad_rows(rows, max_len: int, n_fill: int = 0, pad_id: int = 0):
    """Token-id lists → ``(ids int64, mask int32)``, both ``[len(rows) +
    n_fill, max_len]``: each row RIGHT-padded with ``pad_id``, its mask 1
    on its tokens; ``n_fill`` copies of the first row appended."""
    n = len(rows)
    ids = np.full((n + n_fill, max_len), pad_id, np.int64)
    mask = np.zeros((n + n_fill, max_len), np.int32)
    for r, toks in enumerate(rows):
        ids[r, :len(toks)] = np.asarray(toks, np.int64)
        mask[r, :len(toks)] = 1
    if n_fill:
        ids[n:] = ids[0]
        mask[n:] = mask[0]
    return ids, mask


@torch.no_grad()
def classify_rows(model, rows, max_len: int, n_fill: int = 0,
                  pad_id: int = 0) -> np.ndarray:
    """The sequence-classification UDF's device step: token-id lists →
    predicted class per row (int64 numpy ``[len(rows)]``).

    The rows are right-padded to ``max_len`` with an attention mask (pad
    positions excluded from attention — the kernels' ``kv_mask``) and
    ``n_fill`` fill rows (:func:`right_pad_rows`), and run through
    ``model`` (a ``models.bert.BertForSequenceClassification``,
    deterministic) on its device; the logits' argmax of the real rows
    comes back."""
    n = len(rows)
    ids, mask = right_pad_rows(rows, max_len, n_fill, pad_id)
    dev = model.device
    logits = model(torch.from_numpy(ids).to(dev),
                   torch.from_numpy(mask).to(dev))
    return logits[:n].float().argmax(-1).cpu().numpy().astype(np.int64)


def registerSequenceClassificationUDF(name: str, model, variables=None,
                                      batchRows: int = 64,
                                      pad_id: int = 0,
                                      params_dtype: str | None = None
                                      ) -> None:
    """Register an encoder-classifier UDF over token-id columns.

    The column holds int token-id lists; rows stream in ``batchRows``
    Arrow chunks, right-padded to the column-wide max length
    (:func:`classify_rows`). Output: the predicted class index per row.
    ``model``: the port's ``models.bert.BertForSequenceClassification``
    (``variables``, when given, a JAX-package tree loaded into it;
    ``params_dtype`` as in :func:`registerGenerationUDF`)."""
    from ..models import bert as B

    model = _with_weights(model, variables, params_dtype,
                          B.load_flax_params)

    def apply(df, inputCol: str, outputCol: str):
        import pyarrow as pa

        def compute(rows, max_len, n_fill):
            return pa.array(classify_rows(model, rows, max_len, n_fill,
                                          pad_id))

        return _streamed_token_apply(df, inputCol, outputCol, batchRows,
                                     compute, pa.int64())

    _UDF_REGISTRY[name] = apply


def applyUDF(df, name: str, inputCol: str, outputCol: str):
    try:
        apply = _UDF_REGISTRY[name]
    except KeyError:
        raise ValueError(f"UDF {name!r} is not registered; available: "
                         f"{sorted(_UDF_REGISTRY)}") from None
    return apply(df, inputCol, outputCol)


def udfStage(name: str, inputCol: str, outputCol: str):
    """The transformer stage a numeric or image UDF applies
    (``registerUDF``, ``registerImageUDF`` and the UDFs made over them),
    whose ``_get_runner()`` is the UDF's device step: ``.run(host
    batches)`` drives it without a DataFrame (the card machine has no
    pyarrow). The token-column UDFs have no stage and raise
    ``ValueError``."""
    try:
        apply = _UDF_REGISTRY[name]
    except KeyError:
        raise ValueError(f"UDF {name!r} is not registered; available: "
                         f"{sorted(_UDF_REGISTRY)}") from None
    stage = getattr(apply, "stage", None)
    if stage is None:
        raise ValueError(f"UDF {name!r} is a token-column UDF; it has no "
                         f"transformer stage")
    return stage(inputCol, outputCol)


def listUDFs() -> list[str]:
    return sorted(_UDF_REGISTRY)


def unregisterUDF(name: str) -> None:
    _UDF_REGISTRY.pop(name, None)
