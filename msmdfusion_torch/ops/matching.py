"""Linear assignment by the auction algorithm, on the device.

Counterpart of the JAX package's ``ops/matching.py`` (which replaces the
reference's per-sample ``scipy.optimize.linear_sum_assignment`` in
HungarianAssigner3D, mmdet3d/core/bbox/assigners/hungarian_assigner.py):
one stage of Bertsekas' auction from zero prices with Jacobi bidding, the
same bids, tie-breaks (first maximal row per column, lowest column per
row) and iteration cap, so equal costs give equal assignments. The JAX
package's ``lax.while_loop`` is a Python loop here whose condition reads
one flag from the device per iteration.
"""
from __future__ import annotations

import torch

NEG = -1e18


def auction_assign(cost, col_valid, eps_rel: float = 0.002,
                   max_iters: int = 2000):
    """Give each valid column of ``cost`` [R, C] (R >= valid columns) a
    distinct row, minimising the total cost to within ``eps_rel`` of its
    scale. Returns row_for_col [C] int32, -1 for invalid columns (and for
    any column left unassigned at ``max_iters``)."""
    r, c = cost.shape
    dev = cost.device
    benefit = torch.where(col_valid[:, None], -cost.T,
                          torch.full_like(cost.T, NEG))       # [C, R]
    scale = torch.clamp(torch.where(col_valid[:, None], benefit.abs(),
                                    torch.zeros_like(benefit)).max(), min=1.0)
    eps = eps_rel * scale / c
    prices = torch.zeros((r,), dtype=cost.dtype, device=dev)
    row_for_col = torch.full((c,), -1, dtype=torch.int64, device=dev)
    cols = torch.arange(c, device=dev)
    neg = torch.tensor(NEG, dtype=cost.dtype, device=dev)
    for _ in range(max_iters):
        unassigned = (row_for_col < 0) & col_valid
        if not bool(unassigned.any()):
            break
        values = benefit - prices[None, :]
        w1, best = values.max(dim=1)
        masked = values.clone()
        masked[cols, best] = neg
        w2 = masked.max(dim=1).values
        bid = prices[best] + (w1 - w2) + eps
        bid = torch.where(unassigned, bid, neg)
        # the highest bid for each row wins (Jacobi bidding)
        tgt = torch.where(unassigned, best, r)
        row_best_bid = torch.full((r + 1,), float('-inf'), dtype=cost.dtype,
                                  device=dev).scatter_reduce(
            0, tgt, bid, 'amax', include_self=True)[:r]
        won = unassigned & (bid >= row_best_bid[best]) & (bid > neg)
        # ties: the lowest column wins
        winner = torch.full((r + 1,), c, dtype=torch.int64,
                            device=dev).scatter_reduce(
            0, tgt, torch.where(won, cols, c), 'amin', include_self=True)[:r]
        won = won & (winner[best] == cols)
        prices = torch.where((winner < c) & (row_best_bid > neg),
                             torch.maximum(prices, row_best_bid), prices)
        # rows taken over: their previous owners become unassigned
        taken = torch.zeros((r + 1,), dtype=torch.bool, device=dev)
        taken[torch.where(won, best, r)] = True
        owns_taken = (row_for_col >= 0) & taken[:r][torch.clamp(row_for_col,
                                                                min=0)]
        row_for_col = torch.where(owns_taken, -1, row_for_col)
        row_for_col = torch.where(won, best, row_for_col)
    return torch.where(col_valid, row_for_col, -1).to(torch.int32)


def assign_proposals(cost, col_valid):
    """The inverse view for detector heads: rows are proposals, columns
    ground truths; returns the ground truth of each row [R] int32, -1 for
    a background row."""
    r, c = cost.shape
    row_for_col = auction_assign(cost, col_valid).to(torch.int64)
    ok = row_for_col >= 0
    assigned = torch.full((r + 1,), -1, dtype=torch.int32, device=cost.device)
    assigned[torch.where(ok, row_for_col, r)] = torch.where(
        ok, torch.arange(c, device=cost.device), -1).to(torch.int32)
    return assigned[:r]
