"""The one traffic generator: reads a mix's data file and draws its
requests from ``--seed``.

Prompt lengths, output lengths and (open loop) arrival gaps are draws from
the mix's distributions, each from a stream of its own, in blocks of
``period`` requests: a block holds one draw from each of the ``period``
equal-probability strata of the distribution, the strata in an order the
seed draws and each draw placed in its stratum by the seed.  ``period`` 1
is plain independent draws: exponential gaps are then a Poisson process.
A larger period keeps the mix of sizes in every block the same for every
seed (stratified sampling) while the order and the values still follow
the seed, so every seed runs a trace of its own.

A mix (``perfbench/traffic/<name>.json``):

- ``loop``: ``"backlog"`` (a queue that never empties, ``backlog_depth``
  requests kept waiting) or ``"poisson"`` (open loop at ``rate_per_s``
  requests a second; gaps exponential);
- ``engine``: ``slots``, ``max_seq``, ``chunk``, ``cache_kind``;
- ``prompt`` / ``output``: ``{"dist": "lognormal", "median", "sigma",
  "min", "max"}`` in tokens (outputs are ``max_new``);
- ``period``: requests in a block of stratified draws (1: independent);
- ``warmup``: ``{"kind": "first_wave"}`` (backlog: the first ``slots``
  requests keep ``ceil(u * max_new)`` of their outputs, ``u`` stratified
  draws of (0, 1), as in a server that has been running; the window opens
  once every one of them has its first token) or ``{"kind": "seconds",
  "seconds": s}`` (poisson: the arrivals start with set-up and the window
  opens ``s`` seconds later);
- ``check``: ``{"served_tokens": n, "requests": r}``: the correctness
  sample holds at least ``n`` served tokens and ``r`` requests.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from statistics import NormalDist

import numpy as np

LOOPS = ("backlog", "poisson")


@dataclasses.dataclass
class Spec:
    """One request of the schedule: ``due`` seconds after the schedule
    starts (None in a backlog: due when it is queued), its prompt
    length and ``max_new``."""
    rid: int
    prompt_len: int
    max_new: int
    due: float | None


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    if mix["loop"] not in LOOPS:
        raise ValueError(f"{path}: loop {mix['loop']!r} not in {LOOPS}")
    if mix["loop"] == "poisson" and not mix.get("rate_per_s", 0) > 0:
        raise ValueError(f"{path}: a poisson loop needs rate_per_s > 0")
    return mix


def seed_words(seed: int) -> list[int]:
    """``--seed`` as entropy for numpy: any whole number, negative or
    past 64 bits included."""
    s = int(seed)
    return [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, 1 if s < 0 else 0]


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(seed_words(seed) + list(stream))


def quantiles(dist: dict, q: np.ndarray) -> np.ndarray:
    """The lengths at quantiles ``q`` of a clipped lognormal, whole
    tokens."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"length dist {dist['dist']!r}")
    nd = NormalDist()
    q = np.clip(q, 1e-12, 1 - 1e-12)
    z = np.array([nd.inv_cdf(float(x)) for x in q])
    x = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def levels(seed: int, stream: int, n: int, period: int) -> np.ndarray:
    """``n`` probability levels of stream ``stream``: blocks of
    ``period``, each one draw from every stratum ``[i / period, (i + 1) /
    period)``, the strata in an order drawn from the seed."""
    rng = rng_for(seed, stream)
    blocks = -(-n // period)
    out = [(rng.permutation(period) + rng.random(period)) / period
           for _ in range(blocks)]
    return np.concatenate(out)[:n]


def schedule(mix: dict, seed: int, n: int) -> list[Spec]:
    """The first ``n`` requests of the mix under ``seed``."""
    period = int(mix["period"])
    prompt = quantiles(mix["prompt"], levels(seed, 1, n, period))
    out = quantiles(mix["output"], levels(seed, 2, n, period))
    max_seq = int(mix["engine"]["max_seq"])
    # a request never asks for more than the cache holds
    out = np.minimum(out, max_seq - prompt)
    if mix["loop"] == "poisson":
        gaps = -np.log1p(-levels(seed, 3, n, period)) \
            / float(mix["rate_per_s"])
        due = np.cumsum(gaps)
    else:
        due = [None] * n
    specs = [Spec(i, int(prompt[i]), int(out[i]),
                  None if due[i] is None else float(due[i]))
             for i in range(n)]
    if mix["warmup"]["kind"] == "first_wave":
        slots = int(mix["engine"]["slots"])
        for s, frac in zip(specs[:slots], levels(seed, 4, slots, slots)):
            s.max_new = max(1, math.ceil(frac * s.max_new))
    return specs


def prompt_tokens(seed: int, rid: int, length: int, vocab: int) -> list[int]:
    """Request ``rid``'s prompt: token ids uniform over the vocabulary."""
    return rng_for(seed, 5, rid).integers(0, vocab, size=length).tolist()
