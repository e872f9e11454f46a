from perfbench.readers import mfu_pct as read  # noqa: F401
