from perfbench.readers import prefill_chunk_ms as read  # noqa: F401
