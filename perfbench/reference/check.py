"""What decides ``correct``: the served tokens of a sample of finished
requests, held against the reference's logits.

Once the window has closed (and the program's state is freed), a sample
drawn from the seed of the requests the run finished, the longest among
them first, until it holds ``check.served_tokens`` served tokens and
``check.requests`` requests.  The
reference runs over each prompt with its served tokens; at every served
position the number read is the gap by which the served token's
reference logit lies below the reference's best there.  The cell's file
(``perfbench/cells/<cell>.json``) names which of :func:`readings` it
holds to a limit: the widest gap of the sample, or the share of its
served tokens that are not the reference's best.

The reference is the cell's model module (``Cell.model``: the one its
configuration file names, ``model.py`` by default; this package's
``__init__`` says what such a module defines).  Its ``logits_for`` reads
the program's requests (:func:`sequences`), or its steps where requests
share its batches (:func:`steps_to`).

``control=True`` also judges the control: the same reference in fp8 put
in the program's place, its first token at each of the same positions
held to the same limits, with a ``correct`` of its own, which has to come
out false.
"""
from __future__ import annotations

import math

import torch

from perfbench import observe, traffic


def precise() -> None:
    """Matrix products in true float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def sample(rec: dict, requests: dict, seed: int, served: int,
           n_requests: int = 1) -> list[int]:
    """Finished requests of the window (of the run, where the window
    finished too few), the longest (prompt and served tokens) first, then
    in an order drawn from the seed until ``served`` tokens and
    ``n_requests`` requests are held."""
    ok = [rid for rid, r in rec["requests"].items()
          if r["done"] is not None and "error" not in r
          and r["done"] <= rec["t_close"] and requests[rid].out]
    inside = [rid for rid in ok if rec["requests"][rid]["done"]
              >= rec["t_open"]]
    enough = (sum(len(requests[r].out) for r in inside) >= served
              and len(inside) >= n_requests)
    pool = inside if enough else ok
    if not pool:
        return []
    longest = max(pool, key=lambda r: (len(requests[r].tokens)
                                       + len(requests[r].out), -r))
    rest = [r for r in pool if r != longest]
    order = traffic.rng_for(seed, 6).permutation(len(rest))
    out, n = [longest], len(requests[longest].out)
    for i in order:
        if n >= served and len(out) >= n_requests:
            break
        out.append(rest[i])
        n += len(requests[rest[i]].out)
    return out


def _gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    best = logits.max(dim=-1).values
    return best - logits.gather(1, tokens[:, None])[:, 0]


def sequences(requests: dict, rids: list[int], device):
    """Each request of ``rids`` as one sequence (int64 tokens on the
    device: its prompt and its served tokens but the last), the position
    of its first served token's logits, and the served tokens, in
    order."""
    seqs, first, served = [], [], []
    for rid in rids:
        req = requests[rid]
        seq = list(req.tokens) + list(req.out[:-1])
        seqs.append(torch.tensor(seq, dtype=torch.int64, device=device))
        first.append(len(req.tokens) - 1)
        served += list(req.out)
    return seqs, first, torch.tensor(served, device=device)


def steps_to(log: list, requests: dict, rids: list[int], device):
    """The program's steps (``observe.replay_steps``) from the engine's
    first to the last decode step that emitted a token of ``rids``; the
    (step index, slot row) of each such token, and the tokens, in
    order."""
    steps = observe.replay_steps(log)
    want = set(rids)
    last = max(i for i, st in enumerate(steps) if st["kind"] == "decode"
               and any(rid in want for _s, rid, _j in st["emit"]))
    steps = steps[:last + 1]
    scored, served = [], []
    for i, st in enumerate(steps):
        if st["kind"] != "decode":
            continue
        for slot, rid, j in st["emit"]:
            if rid in want:
                scored.append((i, slot))
                served.append(requests[rid].out[j])
    return steps, scored, torch.tensor(served, device=device)


def logits_for(mod, m: dict, engine: dict, tree: dict, log: list,
               requests: dict, rids: list[int], device, quant=None):
    """Model module ``mod``'s reference logits at every served position
    of ``rids``, the served tokens there, and the reference's drops."""
    ref = mod.Reference(tree, m, quant)
    lg, served = mod.logits_for(ref, engine, log, requests, rids, device)
    return lg, served, ref.drops


def judge(cell, rec: dict, requests: dict, log: list, tree: dict, seed: int,
          device, control: bool = False) -> dict:
    precise()
    m, eng = cell.conf["model"], cell.mix["engine"]
    want = cell.mix["check"]
    rids = sample(rec, requests, seed, int(want["served_tokens"]),
                  int(want.get("requests", 1)))
    limits = cell.limits["limits"]
    if not rids:
        none = held({}, limits)
        return {"checks": none, "sample": {"requests": 0},
                "control": {"checks": none, "correct": False}}
    with torch.no_grad():
        lg, served, drops = logits_for(cell.model, m, eng, tree, log,
                                       requests, rids, device)
        got = readings(_gaps(lg, served))
        out = {"checks": held(got, limits),
               "sample": dict(got, requests=len(rids),
                              served_tokens=int(len(served)),
                              longest=len(requests[rids[0]].tokens)
                              + len(requests[rids[0]].out),
                              reference_drops=drops)}
        if control:
            lg8, _, _ = logits_for(cell.model, m, eng, tree, log, requests,
                                   rids, device, quant="fp8")
            ctl = held(readings(_gaps(lg, lg8.argmax(dim=-1))), limits)
            out["control"] = {"checks": ctl, "correct": passes(ctl)}
        del lg
    return out


def held(got: dict, limits: dict) -> dict:
    """Each number a cell compares beside its limit (infinite where the
    run gave nothing to read)."""
    return {k: {"value": got.get(k, math.inf), "limit": _limit(v)}
            for k, v in limits.items()}


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def readings(gaps: torch.Tensor) -> dict:
    """The numbers a cell may compare: the widest gap of its served
    tokens, and the share of served tokens that are not the reference's
    best (gap above 0)."""
    return {"widest_logit_gap": float(gaps.max()),
            "not_best_share": float((gaps > 0).float().mean()),
            "median_gap": float(gaps.median())}


def _limit(v):
    return math.inf if v is None else float(v)
