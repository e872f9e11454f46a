from perfbench.readers import setup_s as read  # noqa: F401
