from perfbench.readers import out_tok_s as read  # noqa: F401
