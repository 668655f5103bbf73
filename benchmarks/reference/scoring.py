"""Plain candidate scoring: resample, classify, vote, rank.

Each crop is resampled to ``num_points`` points by drawn indices (with
replacement, kinect2grasp.py:472-478), classified by the plain PointNetCls,
and given softmax(log_softmax) probabilities (main_test.py:65-66). With one
repetition the vote is the argmax. A candidate is good when its vote is the
best class and its crop is valid; the ranking lists good candidates by the
best class's probability, highest first, ties in candidate order.
"""

from __future__ import annotations

import torch

from . import pointnet


def score(params, clouds, valid, resample_idx, *, tf32: bool = False):
    """clouds (G, N0, 3), valid (G,), resample_idx (G, N) -> (pred (G,),
    prob (G, k)); invalid candidates read class 0 with probability 0.
    ``tf32``: the products in TF32 (the control)."""
    g = clouds.shape[0]
    batch = clouds[torch.arange(g, device=clouds.device)[:, None],
                   resample_idx.long()]
    prob = torch.softmax(pointnet.forward_blocks(params, batch, tf32=tf32),
                         dim=-1)
    pred = torch.where(valid, prob.argmax(dim=-1), 0)
    prob = torch.where(valid[:, None], prob, 0.0)
    return pred, prob


def rank(pred, prob, valid):
    """-> (good (G,), order (G,)) as described above."""
    best = prob.shape[1] - 1
    good = (pred == best) & valid
    order = torch.argsort(torch.where(good, -prob[:, best], torch.inf),
                          stable=True)
    return good, order


def rank_gap(listed, prob_ref, valid_ref):
    """How far a program's ranking lies from what the reference's class
    probabilities allow, in probability. ``listed``: the candidates the
    program ranks good, best first; ``prob_ref`` (G, k), ``valid_ref`` (G,):
    the reference's. The largest of:
    - for a listed candidate, how far its best-class probability lies below
      its top class (1 where its crop is invalid or it is listed twice);
    - for a valid candidate left off the list, how far its top class other
      than the best lies below the best class;
    - down the list, how far a candidate's best-class probability lies
      above an earlier one's.
    A vote or an order turned by rounding at a near tie reads as small as
    the tie is close; a wrong vote or a wrong order reads what it is off."""
    p = torch.as_tensor(prob_ref).double().cpu()
    valid = torch.as_tensor(valid_ref).bool().cpu()
    listed = torch.as_tensor(listed, dtype=torch.long).cpu().reshape(-1)
    on = torch.zeros(p.shape[0], dtype=torch.bool)
    if listed.numel():
        if int(listed.min()) < 0 or int(listed.max()) >= p.shape[0]:
            return 1.0
        on[listed] = True
        if int(on.sum()) != listed.numel() or not bool(valid[listed].all()):
            return 1.0
    best = p[:, -1]
    margin = best - p[:, :-1].max(dim=1).values
    gaps = [0.0]
    if listed.numel():
        gaps.append(float((-margin[listed]).clamp(min=0).max()))
        r = best[listed]
        later = torch.flip(torch.cummax(torch.flip(r, [0]), 0).values, [0])
        if r.numel() > 1:
            gaps.append(float((later[1:] - r[:-1]).clamp(min=0).max()))
    off = valid & ~on
    if bool(off.any()):
        gaps.append(float(margin[off].clamp(min=0).max()))
    return max(gaps)
