"""The byte bound of the traced sub-window's ``mla_decode`` calls (every
decoding slot's latent rows, query and latent output: the model module's
``decode_attention_bytes``) at the HBM peak, over the kernel group's
profiled device time (``perfbench/devtrace.py`` files the kernel and its
combine pass under ``mla_decode`` by their symbols)."""
from perfbench import costs
from perfbench.readers import _model, _prof


def read(rec):
    p = _prof(rec)
    if p is None or not p["groups_ms"].get("mla_decode"):
        return None
    count = _model(rec).decode_attention_bytes
    nbytes = sum(count(rec["model"], s["cache_len"])
                 for s in rec["steps"] if s["profiled"])
    bound_s = nbytes / costs.HBM_BYTES_PER_S
    return 100.0 * bound_s / (p["groups_ms"]["mla_decode"] / 1e3)
