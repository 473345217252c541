"""Row-sharded caption-bank retrieval: a ring kNN over the data mesh
(counterpart of leclip_tpu/parallel/retrieval.py).

The replicated retrieval (models/dense_clip.py ``retrieval_augment``) keeps
the whole [N, E] caption bank on every card (~450 MB at fp32 / 1024-d for
the 220k-caption competition bank). Here each rank holds N / world rows and
scores its own query rows against one bank shard at a time while the shards
travel round the ring: ``world − 1`` steps of ``dist.batch_isend_irecv``,
each sending the shard in hand to rank ``(r + 1) % world`` and receiving the
next from ``(r − 1) % world`` into a second buffer, so the next shard's
transfer overlaps this shard's search. A running top-k of (score, feature)
is kept; the chosen k are rescored exactly in fp32 and sorted, the
replicated path's contract. Per step one shard moves; the queries never do.

The search is exact fp32 at every shard size, as the port's replicated
retrieval is: the JAX package's bf16 ``approx_max_k`` above 4,096 rows a
shard is a TPU workaround and is not ported (ROADMAP "Departures").

Ref anchor: generate_caption_text_features.py:77-97 (the bank artifact) and
Caption_distill_double.py:444-448 (top-10 retrieval merge)."""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import DataMesh

PAD_SCORE = -1e9  # a pad row's similarity: never among the top k


def retrieval_augment_sharded(global_feat: torch.Tensor, bank_shard: torch.Tensor, topk: int,
                              mesh: DataMesh, n_valid: Optional[int] = None,
                              bank_rows: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sharded-bank ``retrieval_augment``: this rank's L2-normalised
    query rows ``global_feat`` [b, E] against the whole bank, of which it
    holds ``bank_shard``, rows r·N/world to (r+1)·N/world. Returns
    (augmented [b, E], top-k scores [b, topk] fp32 descending).

    ``n_valid``: the number of REAL bank rows where the bank was padded to
    divide the world (``mesh.pad_to_multiple(..., mode="zero")``). Pad rows
    are excluded by GLOBAL ROW INDEX, each chunk's owner being tracked round
    the ring, which is exact for any bank content (a norm test would drop
    small real rows of an unnormalised bank). ``bank_rows``: the padded
    bank's row count, checked against the world and the shard."""
    d, r = mesh.world, mesh.rank
    shard_rows = bank_shard.shape[0]
    total = shard_rows * d if bank_rows is None else bank_rows
    if total % d:
        raise ValueError(f"bank rows ({total}) must divide the world ({d}); pad with "
                         "parallel.mesh.pad_to_multiple first")
    if total // d != shard_rows:
        raise ValueError(f"bank shard of {shard_rows} rows, expected {total} / {d}")
    if shard_rows < topk:
        raise ValueError(f"bank shard ({shard_rows} rows) smaller than topk ({topk})")
    n_valid = total if n_valid is None else n_valid
    rows = torch.arange(shard_rows, device=bank_shard.device)
    gf32 = global_feat.float()

    def search(chunk, owner):
        sims = gf32 @ chunk.float().T
        valid = owner * shard_rows + rows < n_valid
        sims = torch.where(valid[None, :], sims, torch.full_like(sims, PAD_SCORE))
        s, i = torch.topk(sims, topk, dim=-1)
        return s, chunk[i]

    cur = bank_shard.contiguous()
    nxt = torch.empty_like(cur) if d > 1 else None
    best_s = best_f = None
    owner = r
    for step in range(d):
        reqs = []
        if step < d - 1:
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, (r + 1) % d, group=mesh.group),
                dist.P2POp(dist.irecv, nxt, (r - 1) % d, group=mesh.group)])
        s, f = search(cur, owner)
        if best_s is None:
            best_s, best_f = s, f
        else:
            cat_s = torch.cat([best_s, s], dim=-1)
            cat_f = torch.cat([best_f, f], dim=1)
            best_s, i = torch.topk(cat_s, topk, dim=-1)
            best_f = torch.gather(cat_f, 1, i[..., None].expand(-1, -1, cat_f.shape[-1]))
        for q in reqs:
            q.wait()
        if reqs:
            # the shard received is the one owned by the rank before in the ring
            cur, nxt = nxt, cur
            owner = (owner - 1) % d
    # exact fp32 rescore of the chosen k, sorted descending
    scores = torch.einsum("be,bke->bk", gf32, best_f.float())
    scores = torch.sort(scores, dim=-1, descending=True).values
    merged = (global_feat + best_f.mean(dim=1).to(global_feat.dtype)) / 2.0
    return merged, scores


def make_sharded_retriever(topk: int, mesh: DataMesh, n_valid: Optional[int] = None,
                           bank_rows: Optional[int] = None):
    """(global_feat, bank shard) → (augmented, scores) with the replicated
    path's call signature, for the TTA engine. ``n_valid``: the real
    (pre-padding) bank row count."""
    return functools.partial(retrieval_augment_sharded, topk=topk, mesh=mesh, n_valid=n_valid,
                             bank_rows=bank_rows)
