"""Core runtime pieces of the port. Only the serving calls' signature
bookkeeping (``runtime.GLOBAL_COMPILE_CACHE``) so far."""
