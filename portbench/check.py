"""The comparison that decides ``correct``.

What the timed ``next`` calls produced is held to the plain reference
(``reference/gp.py``, float64) once the window has closed.  The
acquisition is compared as its logarithm: at 5000 observations EI spans
orders of magnitude over the candidates, and what ranks them is its
order of magnitude.  On the cells' noise-free objective the competing
candidates' EI lies where float32 holds it; EI's far tail, a candidate
whose mean lies more than about 5.4 posterior deviations above the
incumbent (where float32's normal CDF underflows), is not reached there,
and this comparison does not cover it.

  * ``lp_gap`` (nats): the log marginal the program's sampler computed
    (kernel B1) at each chain's new state against the reference's at the
    same state: the widest absolute gap; ``lp_gap_time`` the same of the
    duration GP, in the cost-aware cell;
  * ``ei_gap`` (nats): the program's sample-averaged EI (EI per second in
    the cost-aware cell), from its posterior caches (B2, B3), against the
    reference's average over the same samples, on the candidates that
    compete: those within ``WINDOW_NATS`` of the reference's best.  The
    widest gap of the logarithms (a value the program lost to underflow
    reads infinite);
  * ``opt_gap`` (nats): the logarithm of the value L-BFGS reported at its
    refined point against the reference's there;
  * ``answer_gap`` (nats): how far the reference's value at what ``next``
    returned (a grid candidate, or the refined point) lies below the
    reference's best candidate (0 when above);
  * ``unmoved_share``: the share of chain states that a window call
    returned bit for bit as it got them (a sampler that does not move);
  * ``persist_misses``: the configuration's guarantees, counted exactly:
    suggestions without their ``suggest`` event, a state file that does
    not hold the last call's chain states, key and burn-in flag, and calls
    that did not start from the state the call before left.

The reference follows the program from the program's own chain states:
it cannot replay the random slice moves.  So the moves are judged by
themselves: their log marginals (``lp_gap``), that they moved
(``unmoved_share``), and that the carried state persisted
(``persist_misses``).  ``SAMPLED`` window calls, drawn from the seed, are
compared for the first four numbers; every call for the last two.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from portbench.reference import gp

SAMPLED = 6
WINDOW_NATS = 5.0
FIELDS = ("mean", "amp2", "noise", "ls")


def host(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), np.float64)


def sample_set(h) -> gp.SampleSet:
    return gp.SampleSet(*(host(getattr(h, f)) for f in FIELDS))


def pick(n_calls: int, seed: int, k: int = SAMPLED) -> list:
    """Window calls to compare, drawn from the seed (all if few)."""
    rng = np.random.default_rng([int(seed), 0xC4EC])
    if n_calls <= k:
        return list(range(n_calls))
    return sorted(rng.choice(n_calls, k, replace=False).tolist())


def families(rec) -> list:
    """(incoming, outgoing, samples) chain states of each GP family."""
    res = rec["res"]
    out = [(rec["h_in"], res.hypers, res.samples)]
    if rec["t_in"] is not None:
        out.append((rec["t_in"], res.time_hypers, res.time_samples))
    return out


def program_acq(rec) -> torch.Tensor:
    res = rec["res"]
    return res.ei_per_s if rec["t_in"] is not None else res.ei


def view(inputs, rec, arith, device) -> dict:
    """``arith``'s account of one call: each sample's log marginals, and
    the sample-averaged acquisition at the candidates, at the refined
    point and at the returned point."""
    x = inputs.grid[inputs.complete]
    y = inputs.values[inputs.complete]
    cands = inputs.grid[inputs.candidates]
    res = rec["res"]
    extra = [host(res.x_opt)]
    ans = rec["answer"]
    if isinstance(ans, tuple):
        extra.append(np.asarray(ans[1], np.float64))
    pts = np.concatenate([cands, np.stack(extra)])
    fams = families(rec)
    kw = {}
    if len(fams) > 1:
        kw = dict(time_y=np.log(np.maximum(
            inputs.durations[inputs.complete], 1e-3)),
            time_samples=sample_set(fams[1][2]))
    judged = gp.acquisition(x, y, pts, sample_set(fams[0][2]), arith,
                            device, **kw)
    avg = gp.sample_mean(judged).cpu()
    c = cands.shape[0]
    if isinstance(ans, tuple):
        at_answer = float(avg[c + 1])
    else:
        pos = np.searchsorted(inputs.candidates, ans)
        ok = pos < c and inputs.candidates[pos] == ans
        at_answer = float(avg[pos]) if ok else -math.inf
    return {"lp": [judged.lp, judged.lp_time], "acq": avg[:c],
            "at_opt": float(avg[c]), "at_answer": at_answer}


def ln(t) -> torch.Tensor:
    return torch.log(torch.as_tensor(t, dtype=torch.float64))


def gaps(ref: dict, lp: list, acq_ln, opt_ln: float,
         answer_ln: float) -> dict:
    """The gaps of one call: ``lp`` [family][sample],
    ``acq_ln`` [C], ``opt_ln`` and ``answer_ln`` from the side judged (ln
    of the acquisition); ``ref`` from ``view``."""
    top = float(ref["acq"].max())
    out = {}
    for key, got, want in zip(("lp_gap", "lp_gap_time"), lp, ref["lp"]):
        gap = max((abs(g - w) for g, w in zip(got, want)), default=0.0)
        out[key] = gap if math.isfinite(gap) else math.inf
    near = ref["acq"] >= top - WINDOW_NATS
    d = (torch.as_tensor(acq_ln, dtype=torch.float64)[near]
         - ref["acq"][near]).abs().max()
    d_opt = abs(opt_ln - ref["at_opt"])
    return {**out,
            "ei_gap": float(d) if math.isfinite(d) else math.inf,
            "opt_gap": d_opt if math.isfinite(d_opt) else math.inf,
            "answer_gap": max(0.0, top - answer_ln)}


def program_side(rec, inputs) -> tuple:
    """(lp [family][sample], ln acq [C], ln at_opt) as the program
    reported them.  The returned answer has no value of the program's (a
    grid index states none): ``answer_gap`` takes the reference's there."""
    res = rec["res"]
    fams = families(rec)
    it = max(1, len(rec["lps"]) // len(fams))
    lp = []
    for i in range(len(fams)):
        sweeps = [host(rec["lps"][i * it + j][1]) for j in range(it)]
        # samples are chains-major: sample c·it + j is chain c's sweep j
        lp.append([float(sweeps[s % it][s // it])
                   for s in range(it * sweeps[0].shape[0])])
    c = inputs.candidates.shape[0]
    return (lp, ln(host(program_acq(rec))[:c]),
            float(ln(float(res.ei_opt))))


def same(a, b) -> torch.Tensor:
    """[chains] bool: every field of two chain-state tuples equal."""
    eq = None
    for f in FIELDS:
        u, v = getattr(a, f), getattr(b, f)
        e = (u == v) if u.ndim == 1 else (u == v).all(-1)
        eq = e if eq is None else eq & e
    return eq


def unmoved_share(records) -> float:
    moved = total = 0
    for rec in records:
        for h_in, h_out, _ in families(rec):
            eq = same(h_in, h_out)
            moved += int((~eq).sum())
            total += eq.numel()
    return 1.0 - moved / max(total, 1)


def persist_misses(records, expt_dir: str, chooser: str, seed: int) -> int:
    """Breaks of the guarantees over all calls, warm-up included."""
    misses = 0
    events = []
    path = os.path.join(expt_dir, "events.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            events = [json.loads(line) for line in f if line.strip()]
    n_suggest = sum(1 for e in events if e.get("kind") == "suggest")
    misses += abs(n_suggest - len(records))
    carried = None
    for rec in records:
        fams = families(rec)
        now = [h for h, _, _ in fams]
        if carried is not None:
            misses += sum(int(not bool(same(a, b).all()))
                          for a, b in zip(carried, now))
        ok = int(rec["res"].n_ok) > 0
        carried = [o if ok else i for i, o, _ in fams]
    state = os.path.join(expt_dir, f"{chooser}_state.npz")
    if not os.path.exists(state) or carried is None:
        return misses + 1
    with np.load(state) as z:
        for prefix, h in zip(("", "time_"), carried):
            for f in FIELDS:
                if not np.array_equal(z[prefix + f], host(getattr(h, f))
                                      .astype(np.float32)):
                    misses += 1
        misses += int(int(z["key_state"]) != int(seed) + len(records))
        misses += int(not bool(z["burned_in"]))
    return misses


def judge(records, window_idx, inputs, expt_dir, chooser, seed,
          device, diag: list | None = None) -> dict:
    """Every compared number of a run (``window_idx``: the records of the
    window's calls, the warm-up's excluded).  ``diag`` collects, per
    compared call, the reference's best ln EI, how many candidates
    compete and how many of those the program lost to underflow."""
    worst = {}
    for i in pick(len(window_idx), seed):
        rec = records[window_idx[i]]
        ref = view(inputs, rec, gp.REFERENCE, device)
        lp, acq_ln, opt_ln = program_side(rec, inputs)
        got = gaps(ref, lp, acq_ln, opt_ln, ref["at_answer"])
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
        if diag is not None:
            top = float(ref["acq"].max())
            near = ref["acq"] >= top - WINDOW_NATS
            diag.append({"call": i, "ref_top_ln": top,
                         "competing": int(near.sum()),
                         "lost": int(torch.isinf(acq_ln[near]).sum()),
                         **got})
    worst["unmoved_share"] = unmoved_share([records[i] for i in window_idx])
    worst["persist_misses"] = float(
        persist_misses(records, expt_dir, chooser, seed))
    return worst


def control(records, window_idx, inputs, seed, device) -> dict:
    """The control's readings: the reference in TF32 (``gp.CONTROL``) put
    in the program's place on the same calls, its log marginals, its
    averaged acquisition, its value at the refined point and its own best
    candidate, held to the float64 reference as the program is."""
    worst = {}
    for i in pick(len(window_idx), seed):
        rec = records[window_idx[i]]
        ref = view(inputs, rec, gp.REFERENCE, device)
        ctl = view(inputs, rec, gp.CONTROL, device)
        best = int(torch.argmax(torch.nan_to_num(ctl["acq"],
                                                 nan=-math.inf)))
        got = gaps(ref, [lp for lp in ctl["lp"] if lp], ctl["acq"],
                   ctl["at_opt"], float(ref["acq"][best]))
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the cell's limits name is present, finite and within
    its limit."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= limits[k] for k in limits)
