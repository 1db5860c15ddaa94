"""The numbers that decide `correct`, each compared with its limit."""

from __future__ import annotations

import dataclasses
import math
import statistics

# leaves whose step-1 gradient in the reference is under this share of
# the median leaf's move by round-off alone, and are left out of the
# parameters' change
STILL_LEAF = 1e-3


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Per leaf: |prog norm - ref norm| over the larger of the leaf's ref
    norm and the median leaf's."""
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def worst_leaf_gap(prog: dict, ref: dict, names) -> float:
    return max(leaf_gaps(prog, ref, names).values())


def leaf_detail(prog: dict, ref: dict, names, k: int = 3) -> dict:
    """The k worst leaves and the median leaf's gap: what a reading looks at."""
    gaps = leaf_gaps(prog, ref, names)
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:k]
    return {"worst": [[n, g] for n, g in worst], "median": statistics.median(gaps.values())}


def train_checks(limits, prog_losses, ref_losses, prog_grad1, ref_grad1, prog_change,
                 ref_change):
    """The training cell's numbers: the largest gap of a step's loss (nats),
    the worst leaf's gap of step 1's gradient norm, and the worst leaf's
    gap of the parameters' change over the checked steps (leaves that the
    reference's gradient leaves still are left out)."""
    names = sorted(ref_grad1)
    med = statistics.median(ref_grad1[n] for n in names)
    moving = [n for n in names if ref_grad1[n] >= STILL_LEAF * med]
    loss_gap = max(abs(a - b) for a, b in zip(prog_losses, ref_losses))
    if len(prog_losses) != len(ref_losses):
        loss_gap = math.inf
    return [Check("loss_gap", loss_gap, limits["loss_gap"]),
            Check("grad1_gap", worst_leaf_gap(prog_grad1, ref_grad1, names),
                  limits["grad1_gap"]),
            Check("update_gap", worst_leaf_gap(prog_change, ref_change, moving),
                  limits["update_gap"])]


def route_checks(limits, routing, replayed: bool = True):
    """A routed configuration's number: the widest gap by which an expert
    that the program chose, and the reference's own router would not have,
    lies below the reference's k-th logit at that layer and token (f32
    logit units; 0 where every choice agrees). Where the program's choices
    could not be replayed (they cover other rows than the reference's), it
    is infinite. Its reading: the share of the assignments that differ."""
    margin = routing.margin if replayed else math.inf
    share = routing.flips / routing.assignments if routing.assignments else math.nan
    return [Check("route_margin", margin, limits["route_margin"])], {"route_flip_share": share}


def logit_gap(ref_logits, served) -> list[float]:
    """Per request: how far the served token's reference logit lies below
    the reference's best."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, served[:, None])[:, 0]
    return (best - got).tolist()


BF16_STEPS = 2  # the lattice a bf16 logit moves on; chip_smoke.py phase 14e allows as many


def bf16_step(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    import torch

    e = torch.floor(torch.log2(x.abs().clamp(min=2.0**-126)))
    return torch.exp2(e - 7)


def logprob_gap(ref_logits, served, logprobs) -> list[float]:
    """Per request: how far the log-probability the program answered for
    its served token lies from the reference's log-softmax at that token,
    beyond BF16_STEPS steps of bf16 at the token's reference logit (the
    program's logits are bf16 values, so one step of their lattice is no
    error of the network)."""
    import torch

    logit = ref_logits.gather(1, served[:, None])[:, 0]
    ref = torch.log_softmax(ref_logits, dim=-1).gather(1, served[:, None])[:, 0]
    got = torch.as_tensor(logprobs, dtype=ref.dtype, device=ref.device)
    return torch.clamp((ref - got).abs() - BF16_STEPS * bf16_step(logit), min=0.0).tolist()
