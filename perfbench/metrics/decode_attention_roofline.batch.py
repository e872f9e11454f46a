from perfbench.readers import decode_attention_roofline_pct as read  # noqa: F401
