from perfbench.readers import decode_step_ms as read  # noqa: F401
