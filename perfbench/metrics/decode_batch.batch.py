from perfbench.readers import decode_batch as read  # noqa: F401
