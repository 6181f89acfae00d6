"""The TF-style 1-worker profile of a PS job (``tracer``); copied from
``repro.profiling``."""
