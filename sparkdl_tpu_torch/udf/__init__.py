"""Named column functions over DataFrames (``registry``): the UDFs of the
JAX package's ``sparkdl_tpu/udf`` (numeric, image and token columns).
Importing this package imports no pyarrow; applying a UDF reads a
DataFrame, which does."""

from .registry import (applyUDF, classify_rows, generate_rows, listUDFs,
                       registerGenerationUDF, registerImageUDF,
                       registerKerasImageUDF,
                       registerSequenceClassificationUDF,
                       registerTextGenerationUDF, registerUDF,
                       right_pad_rows, udfStage, unregisterUDF)

__all__ = ["registerUDF", "registerImageUDF", "registerKerasImageUDF",
           "registerGenerationUDF", "registerTextGenerationUDF",
           "registerSequenceClassificationUDF", "classify_rows",
           "generate_rows", "right_pad_rows",
           "applyUDF", "listUDFs", "udfStage", "unregisterUDF"]
