"""The comparison that decides ``correct``: served tokens against the plain
float32 reference, the module that the configuration names under
``"reference"`` (``forward`` and ``logits``).

Once the window has closed, a sample of the requests it finished is drawn
from the seed, the one with the most served tokens always in it.  For each,
the reference runs once over the sequence the engine processed (the
prompt left-padded with token 0 into its prefill bucket, then the served
tokens but the last) and, at each position where the engine took a token
(the prefill's last position, then each decode step), reads the gap by which
the served token's logit lies below the reference's best.  The numbers of
``numbers`` that ``bench/checks/<workload>.json`` names are compared, each
against its limit there.

``control`` reads the same numbers for the reference itself put in the
program's place and computed in float8: every product with a weight takes
both operands rounded to e4m3 (the weight per output column, the input per
row) and sums in float32.  At each position the token it ranks first is
judged by the float32 reference.

``gap_mean_over_bf16`` is a mean gap over that of a baseline: the reference
with every weight product's operands and result rounded to bfloat16 (summed
in float32), as a bfloat16 model computes them, judged like the control.
The drawn weights set how often a rounding flips a choice (on the MoE, a
router near a tie), and they move the program's, the baseline's and the
control's gaps together; the ratio keeps what the precision adds.  It is
worked out only for a cell whose limits name it."""

from __future__ import annotations

import numpy as np
import torch


def sample(requests: list, rule: dict, seed: int) -> list:
    """The requests to check: the longest (most served tokens), then others
    in a seeded order until ``min_requests`` and ``min_tokens`` are met, at
    most ``max_requests``."""
    if not requests:
        return []
    longest = max(requests, key=lambda r: (len(r.tokens), r.rid))
    rest = [r for r in requests if r is not longest]
    order = np.random.default_rng(int(seed) ^ 0x5EED).permutation(len(rest))
    picked = [longest]
    tokens = len(longest.tokens)
    for i in order:
        if len(picked) >= rule["max_requests"] or (
                len(picked) >= rule["min_requests"]
                and tokens >= rule["min_tokens"]):
            break
        picked.append(rest[i])
        tokens += len(rest[i].tokens)
    return picked


def sequences(reqs: list, device) -> tuple[torch.Tensor, list, list]:
    """Right-padded token sequences (pad id 0), each request's positions
    whose logits chose a served token, and each prefill group's length."""
    rows = []
    for r in reqs:
        pad = np.zeros(r.bucket - len(r.prompt), np.int64)
        rows.append(np.concatenate([pad, r.prompt,
                                    np.asarray(r.tokens[:-1], np.int64)]))
    width = max(len(x) for x in rows)
    toks = torch.zeros((len(rows), width), dtype=torch.long)
    for i, x in enumerate(rows):
        toks[i, :len(x)] = torch.from_numpy(x)
    positions = [list(range(r.bucket - 1, r.bucket - 1 + len(r.tokens)))
                 for r in reqs]
    return toks.to(device), positions, [r.bucket for r in reqs]


def e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (each slice's largest magnitude maps to 448), back in float32."""
    x = x.float()
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def bf16(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to bfloat16, back in float32."""
    return x.float().bfloat16().float()


ROUNDINGS = {"e4m3": e4m3, "bf16": bf16}
# formats whose products also hand on their result rounded
ROUNDED_RESULT = {"bf16"}


class Rounded:
    """A weight (in, out) rounded per output column, kept in its own dtype;
    ``x @ w`` rounds x per row first and multiplies in float32 (the result
    rounded too, for a format of ``ROUNDED_RESULT``).  Indexing takes one
    expert's slice."""

    def __init__(self, w: torch.Tensor, fmt: str, rounded: bool = False
                 ) -> None:
        self.fmt = fmt
        self.w = w if rounded else ROUNDINGS[fmt](w, -2).to(w.dtype)

    def float(self) -> "Rounded":
        return self

    def __getitem__(self, i) -> "Rounded":
        return Rounded(self.w[i], self.fmt, rounded=True)

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        y = ROUNDINGS[self.fmt](x, -1) @ self.w.float()
        return ROUNDINGS[self.fmt](y, -1) if self.fmt in ROUNDED_RESULT \
            else y


def rounded_weights(params: dict, fmt: str) -> dict:
    """Every weight of two or more axes but the embedding table as
    ``Rounded`` (its products take rounded operands)."""
    return {name: Rounded(w, fmt) if w.dim() >= 2 and name != "embed"
            else w for name, w in params.items()}


def gaps(run: dict, ref, params: dict, reqs: list,
         rounding: str | None = None, batch: int = 4) -> list[np.ndarray]:
    """The gap of each checked token, one array per request (logit units),
    by the reference module ``ref``: served tokens, or with ``rounding``
    ("e4m3": the control; "bf16": the baseline) the rounded reference's
    first choices."""
    dev = params["embed"].device
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    low = rounded_weights(params, rounding) if rounding else None
    out = []
    try:
        with torch.no_grad():
            for i in range(0, len(reqs), batch):
                part = reqs[i:i + batch]
                toks, pos, groups = sequences(part, dev)
                x = ref.forward(run, params, toks, prefill=groups)
                xl = ref.forward(run, low, toks, prefill=groups) \
                    if rounding else None
                for j, r in enumerate(part):
                    p = torch.tensor(pos[j], device=dev)
                    lg = ref.logits(run, params, x[j, p])
                    best = lg.max(-1).values
                    if rounding:
                        pick = ref.logits(run, low, xl[j, p]).argmax(-1)
                    else:
                        pick = torch.tensor(r.tokens, device=dev)
                    out.append((best - lg.gather(-1, pick[:, None])[:, 0])
                               .cpu().numpy())
                del x, xl
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    return out


def numbers(per_request: list[np.ndarray],
            baseline: list[np.ndarray] | None = None) -> dict:
    """The numbers a check can compare: the widest gap and the mean gap
    over every sampled token, the median over the sampled requests of each
    one's mean gap, and with ``baseline`` the mean gap over the
    baseline's."""
    nan = float("nan")
    if not per_request:
        return {"gap_max": nan, "gap_mean": nan, "gap_request_median": nan,
                "gap_mean_over_bf16": nan, "tokens": 0}
    g = np.concatenate(per_request)
    out = {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
           "gap_request_median": float(np.median(
               [x.mean() for x in per_request])),
           "tokens": int(g.size)}
    if baseline is not None:
        b = float(np.concatenate(baseline).mean())
        out["gap_mean_over_bf16"] = out["gap_mean"] / b if b > 0 else \
            float("inf")
        out["baseline_gap_mean"] = b
        out["baseline_flips"] = int(sum((x > 0).sum() for x in baseline))
    return out


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every compared number is within its limit, and the
    ``{name: {"value", "limit"}}`` lines to print."""
    lines = {k: {"value": nums[k], "limit": v} for k, v in limits.items()}
    ok = nums["tokens"] > 0 and all(
        np.isfinite(nums[k]) and nums[k] <= v for k, v in limits.items())
    return ok, lines
