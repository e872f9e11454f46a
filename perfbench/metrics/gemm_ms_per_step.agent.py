def read(rec):
    from perfbench.readers import group_ms_per_step
    return group_ms_per_step(rec, "library GEMM")
