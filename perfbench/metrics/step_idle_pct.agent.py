from perfbench.readers import step_idle_pct as read  # noqa: F401
