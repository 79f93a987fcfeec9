"""Core pieces of the port: the serving calls' signature bookkeeping and
the decode-step graph runner (``runtime``), and the Arrow DataFrame
(``frame``, which imports pyarrow and pandas, so it is not imported
here: ``from sparkdl_tpu_torch.core.frame import DataFrame``)."""
