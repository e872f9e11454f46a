from perfbench.readers import itl_ms as read  # noqa: F401
